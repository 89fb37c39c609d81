#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the repository root, one card

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
sm_90a (first use), then runs fourteen phases; any failure exits non-zero:

1. kernel vs plain, at the main path's shapes: on a table of the paper's
   config B (2^27 slots, dim 32, float32 values, dual bucket, LRU) filled
   to λ 0.5 and then 1.0, and on a single-bucket config-B table at λ 1.0
   (gather_rows, digest_scan, sweep_match), each kernel's wrapper and its
   plain PyTorch version run on the same inputs and must agree bit for
   bit (tolerance: exact equality, as the kernels are integer maths and
   float copies).  digest_scan is held in its single-row form on each
   candidate row and, on the dual tables, in its dual form (one launch
   over both rows, merged), and both forms are timed.  Both are timed there with CUDA events, beside one
   PyTorch library call where one computes the same function, and beside
   the kernel's bound (the larger of its bytes over the HBM rate and its
   operations over the int32 rate, both counted from this run's inputs).
   upsert_probe is held and timed in each mode: its whole function
   ("both", against the bound of every key and score of both rows), the
   match mode on find's queries (against the digest lines and candidate
   keys it needs), and the target mode with no query, on every lane and on
   a lane gate one tenth on (against the keys of the rows it works on and
   the scores of the rows of both-full queries).
2. kernel path vs plain path: a reduced table (2^20 slots, 65,536-key
   batches) is driven past λ = 1.0 through the public insert_or_assign and
   find on both backends (dual bucket, lru and lfu); then every op of the
   public HKVTable is replayed on both backends, in both bucket modes
   under lru and custom scores.  Statuses, eviction streams,
   find_or_insert values, Locates, sweep counts and the full state must be
   equal after every op; assign_add and accum_or_assign get unique keys,
   and one last batch with duplicates is held at a float32 tolerance
   (their sums run as atomics on the card, in no fixed order).
3. the main path at config B's full size, with the launch counts set to 0
   just before and read just after: insert_or_assign in 1,048,576-key
   batches to λ 0.5, 1.0, and past it (the last batches must report EVICTED
   and REJECTED); find on resident keys and on a mix with misses, checked
   against the keys the script knows are resident; throughput of both ops,
   median of timed runs, at λ 0.5 and 1.0.  The breakdown of an
   insert_or_assign of fresh keys times upsert_probe's match pass (locate)
   and target pass (select_target, with its gate's lane count) apart.  The
   λ 1.0 breakdown's upsert records the buckets and ranks its victim stage
   gets (its miss lanes), and claim_scan is then timed on them against the
   plain version, after the launch counts are read.
4. the rest of the op surface at config B's full size, with the counts
   set to 0 just before and read just after: a single-bucket table (the
   HKVConfig default) takes insert_or_assign to λ 0.5, 1.0 and past it
   (EVICTED and REJECTED), then find, find_ptr and contains against known
   residents; a dual-bucket table past λ 1.0 takes insert_and_evict (each
   EVICTED lane's stream carries a displaced key, no longer found),
   find_or_insert on a mix of hits and misses, erase_if(key_in_range) (a
   find then misses exactly the erased keys) and evict_if(always) (a
   coldest-first stream of the right count).  Each op is timed (median of
   timed runs) and its launches checked against the routing table in
   ``repro_torch/core/ops.py``: an upserting op launches claim_scan once
   if its batch has a miss lane (a status inserted, evicted or rejected)
   and not at all otherwise; a dual-bucket one launches upsert_probe twice
   (the match pass, and the target pass gated to the miss lanes, which
   launches without a miss too and then works on no lane).
5. the training path at config B's full size, with the counts set to 0
   just before and read just after each entry point: an HKVEmbedding of
   config B (2^27 slots, dim 32, rowwise_adagrad so V = 33, dual bucket,
   LRU) prefilled to λ 1.0 takes 5 DLRM steps of 32,768 samples x 26
   Zipfian fields (lookup_train, the forward and backward pass, the dense
   update, apply_grads, whose launches must be one update_scan); each
   step's victim stage and the lane gate of its target pass must hold
   exactly the batch's distinct keys that contains() did not find before
   the step, and lookup_train launches claim_scan once if there are any;
   then the fused gradient step is timed against the composed one
   (one digest_scan, gather_rows, the optimizer, scatter_rows) on
   the last step's gradients, and scatter_rows and find_scan are held
   against their plain versions and timed at V = 33 on the phase's value
   plane; and a 2^20-slot twin takes the same steps on 'auto' and
   'plain', equal in keys, digests, scores and statuses, and within 1e-5
   in values and loss (the gradient sums of repeated tokens are float32
   atomics on the card).
6. the host-memory value tier, the paper's config D (2^27 slots, dim 64,
   rowwise_adagrad so V = 65, dual bucket, LRU, value_tier 'hmem'): its
   value plane (34.9 GB) in pinned host memory, the other planes on the
   card.  The host link's rate is measured first (a pinned-to-card copy
   of 1 GiB).  The table is prefilled to λ 1.0; find, find_ptr, contains,
   insert_or_assign and find_or_insert run in 2^20-key batches, each timed
   and its launches checked against HMEM_ROUTES (find: one digest_scan
   over both rows and one gather_rows over the host link, no find_scan);
   a find must take far less than the plane's bytes over the link (only
   touched rows cross); gather_rows and scatter_rows (set and add) on the
   host plane are held against their plain versions and timed beside the
   bound of their bytes over the measured link rate; then 5 DLRM steps of
   32,768 samples x 26 Zipfian fields as in phase 5 (apply_grads: the
   composed step, one digest_scan, gather_rows and scatter_rows).  A
   2^20-slot 'hmem' twin takes every op on 'auto' and is held bit for bit
   against an 'hbm' table on 'auto' (duplicated keys' sums within 1e-5).
7. the tier hierarchy: HKVEmbedding(capacity=2^27, dim=64,
   hot_capacity=2^24, rowwise_adagrad, dual): a hot tier in HBM at an
   eighth of the cold tier, whose value plane is config D's in pinned host
   memory.  It is prefilled past the hot tier's capacity, takes 5 DLRM
   steps (launches checked against TIERED_ROUTES) and a lookup_serve; the
   promoted, demoted and dropped counters are printed, and conservation
   is checked after every op: the hierarchy's distinct keys grow by the
   batch's new keys less at most the pairs reported dropped (exactly, when
   none is).  A small twin takes the same steps on 'auto' and 'plain',
   equal as in phase 5.
8. the online serving path: a TieredHKVTable of hot 2^24 slots in HBM
   (phase 7's eighth) over cold 2^27 slots in pinned host memory, dim 32,
   dual bucket, LRU hot and 'custom' cold scores, no optimizer columns
   (config B's row width with config D's value placement; dim 32, not 64,
   so that the trainer's second copy of the 17.2 GB pinned plane fits in
   host RAM beside the first), prefilled past its hot tier.  Requests of
   2,520 DLRM samples x 26 fields (65,520 Zipfian keys, α 1.05 over twice
   the cold tier's slots) go in waves of 2^16 lanes through an
   OnlineEmbeddingEngine behind a TablePublisher: run 1 admits misses, with
   an OnlineTrainer at an update:read ratio of 0.25 publishing twice and a
   MaintenanceScheduler (watermarks 0.6 / 0.85, a sweep budget of one wave)
   every wave; run 2 is the same stream from the same prefilled state with
   the scheduler off; run 3 serves readonly with promotion, continuous
   admission and burst arrivals.  Each wave's, maintenance step's and
   trainer step's launches are checked against SERVE_ROUTES and the
   hierarchy's distinct keys against conservation after each (run 3 as a
   whole); per wave and as p50/p99 over the second half it prints latency,
   keys/s, hit and hot-hit rates, reactive demotions, the maintenance
   step's time and moves, each publish's time and the publisher's
   counters, and run 3's queue-wait / service / total percentiles with the
   waves in flight at each dispatch.  A 2^20-slot hierarchy (hot an
   eighth) takes a stream through 'auto' and 'plain': equal per-request
   values and found flags, wave and scheduler reports, publisher counters
   and drained states (values within 1e-5), then the export_delta ->
   ingest_delta round trip of its table.  At most two copies of a
   hierarchy are alive at once.
9. telemetry, the dictionary baselines and the multi-table find at config
   B.  (a) A config B table (dual bucket, LRU) filled to λ 0.25, 0.5, 0.75
   and 1.0 takes at each a find of 2^20 resident keys with a
   TelemetrySink: its launches must be ROUTES' (a sink adds none), its
   lanes and hits the op's own count of keys and found, and
   probes_per_query must vary by under 5% across λ (the paper's
   stability claim, read from the counters); the find is timed without
   and with the sink, and the observer alone.  Past λ 1.0, a
   snapshot() twin and the table take insert_or_assign and then
   find_or_insert of 2^20 keys (a burst at the coldest bucket, an eighth
   resident), the table with a sink: results and every plane must be
   equal, the sink's status histogram the statuses' own count with both
   evicted and rejected above 0; then assign_kernel (set and add) on
   unique resident keys is held bit for bit against its plain
   composition and timed.  (b) OpenAddressingTable and BucketedP2CTable
   at dim 32 and 2^27 slots, filled by offered load in 2^20-key batches
   to λ 0.5 and 0.9 (open addressing) or 0.5 and 1.0 (P2C): find of 2^20
   resident keys (B-KV/s), mean probes, the insert failure rate, and
   every key placed by λ 0.5 found.  (c) find_many_kernel over 26 tables
   (the DLRM's fields) of 2^22 slots at dim 32 filled to λ 1.0, with 2^20
   keys spread over them: one find_scan_many launch, bit-identical to 26
   find_fused_kernel calls and to its plain version, timed against 26
   find_scan launches.
10. the sharded table (``repro_torch.distributed.ShardedHKVTable``), its
   shards sharing the one card.  (a) A ("data", "model") (2, 4) mesh of 8
   shards, 2^20 slots in all, dim 32, rowwise_adagrad, runs every op of the
   surface and the training lookup and apply_grads on backend 'auto' and
   on 'plain': statuses, found flags, overflow, streams, export lanes and
   every shard's keys, digests and scores equal, values too but for the
   gradient sums (within 1e-5); then the same over tiered shards (each
   shard's hot tier a quarter of it).  (b) Config B's embedding (2^27
   slots, dim 32, rowwise_adagrad so V = 33, dual, LRU) on a ("data",
   "model") (8, 1) mesh: 8 shards of 2^24 slots, nothing cut.
   insert_or_assign in 2^20-key batches to λ 0.5, 1.0 and past it (a burst
   at one local bucket: EVICTED and REJECTED), overflow 0 throughout; find
   on residents and on a mix, checked against the keys the script knows;
   find_or_insert, contains, erase_if(key_in_range), evict_if(always, a
   budget a shard), stats() and one export_batch range; 5 DLRM steps of
   phase 5's stream; 10 OnlineEmbeddingEngine waves of 2^16 lanes admitting
   and 10 readonly.  Every op's launches are checked against
   SHARDED_ROUTES (each owner op on each of the 8 shards), and each op is
   timed (median of 5) beside the same op on phases 3, 4 and 5's unsharded
   config B tables in the same run, with the ratio.
11. the LM training path with the HKV embedding: qwen2-0.5b at its
   published widths (24 layers, d_model 896, 14 heads with 2 KV heads,
   d_ff 4864, vocab 151,936, bfloat16) through the port's launcher,
   ``repro_torch.launch.train.main`` with ``--backend hkv --optimizer
   adamw``, batch 8 x seq 4096 (train_4k's length; cut: its global batch
   of 256 to 8 for one card), the table one shard of 303,872 slots at V =
   897 on a (1, 1) mesh.  Run A: 8 steps, a checkpoint every 4; each
   step's split (lookup, forward+backward, clip+adamw, apply_grads), its
   distinct tokens and its launches, checked against TRAIN_LM_ROUTES; the
   checkpoints' bytes, host-copy and write times; tokens/s over the wall
   time of steps 1-6 (the step-4 checkpoint inside) and of steps 1-7 to the
   run's end; the last checkpoint restored onto the run's final state, bit
   for bit; gather_rows and scatter_rows held against their plain versions
   at the lanes each of the run's launches got, on the run's V = 897 plane.
   Run A2: run A again, uninterrupted: what two runs differ by.  Run B:
   the same with a failure injected at step 6, restored from step 4 and
   replayed: its final table's keys, digests, scores and occupancy equal
   run A's, its losses, parameters and table values within LM_NOISE_TIMES
   of A2's differences.  Then SDPA (what the blocks run on the card)
   against the port's plain blocked attention, forward and gradient, at
   qwen2's head shapes and at h2o-danube-1.8b's window (4096 at seq 8192,
   batch 1), both timed; 3 steps of ``--backend dense`` at the same shape;
   and one HKV step under ``torch.profiler`` (device time by operator, and
   its share of the profiled window's wall time).  The free disk space is
   checked before the first checkpoint.
12. the rest of the model zoo.  (a) zamba2-1.2b at its published widths (38
   mamba2 layers: a prelude of 2, then 6 x 6, at d_model 2048, d_state 64,
   64 SSM heads, expand 2, conv 4; one shared attention block, 32 heads,
   MHA, d_ff 8192, gelu, ungated, invoked 6 times; vocab 32,000; bfloat16;
   1.088 B parameters) through the launcher with ``--backend hkv
   --optimizer adamw``, batch 8 x seq 4096 (cut: train_4k's global batch of
   256 to 8 for one card), the table one shard of 64,000 slots at V = 2049
   on a (1, 1) mesh: 6 steps with a checkpoint every 4, each step's split,
   launches (TRAIN_LM_ROUTES) and the run's peak memory; the step-4
   checkpoint (prelude, repeat and shared leaves) restored onto the live
   state before step 4, bit for bit; gather_rows and scatter_rows at every
   launch's lanes on the run's V = 2049 plane, and update_scan
   (rowwise_adagrad at dim 2048) on a copy of the plane taken before the
   first apply_grads, bit for bit their plain versions and timed beside
   their bounds; 2 steps of ``--backend dense`` (the tied head); one HKV
   step under ``torch.profiler``, its device time split into the chunked
   GLA's operators, ``aten::mm``, SDPA and the rest; and the chunked GLA
   alone at the mamba2 block's shapes.  (b) xlstm-1.3b (42 mLSTM and 6
   sLSTM blocks), musicgen-medium and qwen2-vl-2b at full depth, and
   moonshot-v1-16b-a3b cut from 48 layers to 2 (its stacked expert wi
   alone is 71 GB in float32), each at its published widths: a warm-up and
   a timed step of ``StepBuilder.train_step_hkv`` with adamw at batch 8 x
   seq 4096 (qwen2-vl's batch with 256 patch embeddings and arange M-RoPE
   positions on all three axes), the loss finite and under 3 ln(vocab),
   the split, peak memory and launches (TRAIN_LM_ROUTES), and update_scan
   held against its plain version at the arch's V (2049 or 1537).
   llama4-maverick-400b-a17b gets no card run: one MoE layer's experts are
   64.4 GB in float32.
13. LM serving, in bfloat16 at published widths.  (a) qwen2-0.5b at the
   shape grid's prefill_32k (32 lanes, halved until the prefill fits) and
   decode_32k's context: ``CompositeLM.prefill`` of 32,640 tokens a lane,
   then 128 greedy ``decode_step``s that fill the 32,768-position state
   (cut: decode_32k's 128 lanes to the prefill's batch), with the counts
   set to 0 before and read after (the dense path launches no kernel):
   prefill ms and tokens/s beside its products' bound at the bfloat16 peak,
   each step's ms (CUDA events; median), tokens/s, the state's bytes, the
   step's bound (the state and the weights as held, over the HBM rate) and
   peak memory.  On that state: decode attention at the first layer (the
   port's grouped form, the library call for the same function and the
   reference's upcast form), timed; a profile of 3 steps; one step under
   ``torch.cuda.set_sync_debug_mode("error")``; and a step whose
   embeds come from ``HKVEmbedding.lookup_serve`` of the lanes' tokens on a
   table holding the model's own rows (find_scan, the counts set to 0
   before the lookup and read after the step, which must show it), its
   logits bit for bit the dense step's on a copy of the state.  (b) the
   ServingEngine over two waves of 4 lanes (the second padded with copies
   of its lane 0): each lane's tokens equal a greedy loop over the same
   padded batch.  (c) For qwen2-0.5b and SERVE_LM_OTHERS (zamba2-1.2b:
   mamba2 and the shared block's 6 caches; h2o-danube-1.8b past its
   window; xlstm-1.3b: mLSTM and sLSTM; musicgen-medium: sinusoidal
   positions; qwen2-vl-2b: patch embeddings and M-RoPE; moonshot cut to 2
   layers: the MoE at decode): prefill(t[:n-1]) then decode_step(t[n-1])
   against prefill(t), in float32 within SERVE_F32_RTOL (and the same
   decode from the state one position behind outside it, where the arch
   reads the position) and in bfloat16 within SERVE_BF16_TIMES the
   bfloat16 prefill's distance from the float32 one; then a greedy
   generation, timed.  llama4-maverick has no
   card run.
14. the rest of the train stack, at qwen2-0.5b's published widths, each
   number beside the card's name and power limit.  (a) The int8
   error-feedback exchange (``distributed.compression``) over 4 data
   positions on the one card, each position's gradient tree from its own
   forward and backward over 1 x 4096 tokens (float32, 494M elements):
   ``ef_compress_grads`` for two steps carrying the error, and
   ``compressed_psum``, each within 0.05 of the exact mean or sum relative
   to its largest magnitude (the reference's bound), the carried error not
   zero, and the embedding table's and the first layer's wq synced leaves
   and errors bit for bit the same function run on the CPU on the same
   inputs; timed against the exact mean (a stack and a mean), with the
   bytes each would put on a wire.  (b) The GPipe schedule
   (``distributed.pipeline``): the 24 decoder layers as 4 stages of 6, 8
   microbatches of 1 x 4096 embeddings, forward, over a ("pod",) mesh of 4
   positions on the card: bit for bit the layers applied microbatch by
   microbatch in sequence, and within PIPE_BATCHED_TOL of the whole 8 x
   4096 batch through the layers at once; each timed (on one card the
   stages take turns: this measures the schedule's work, not several
   cards).  (c) ``make_sharded_train_step`` on a (data=2, model=4) mesh
   with the launcher's HKV table, 8 x 4096 tokens, one step, with the
   counts set to 0 before and read after: its launches 8 times
   TRAIN_LM_ROUTES' (one owner op a shard, claim_scan on each shard's miss
   lanes), and its loss, gradient norm, parameters and table keys, digests
   and scores bit for bit ``StepBuilder.train_step_hkv``'s on the same
   inputs.  Both run the blocked attention: SDPA's backward on the card sums
   in no fixed order (its atomics), and the check is of the step, not of
   that rounding.  (d) The dry run (``launch.dryrun``): its argument bytes
   for a (1, 1) mesh and a dense train step of 8 x 4096 tokens equal the
   bytes the card holds for that step's parameters, adamw state and batch
   built there, and ``python -m repro_torch.launch.dryrun --arch qwen2-0.5b
   --shape train_4k --mesh single`` runs, its record and seconds printed.

Phase 1 also holds update_scan (all four optimizers, both bucket modes; V
= 32, 33 and 64 at dim 32, the planes other than config B's own value
plane made for the check; and on a 2^20-slot table past λ 1.0, at dims
257, 512 and 896 and on bfloat16 planes at dim 32) and bucket_stats; a
bfloat16 value plane of config B's size on the λ 1.0 table's key planes
takes find_scan, gather_rows (whole rows and 16 columns) and scatter_rows
(set and add); phase 5 holds gather_rows on its V = 33 plane whole and cut
to its 32 embedding columns (lookup_train's readback).  Phase 2 also
replays update_rows (fused, composed, through an OpSession) on both
backends.

The last lines are the card's name and power limit, a JSON object with
one entry per kernel, and the JSON result line.  Without a card (or
without the repository around it) the script exits non-zero and prints no
result.  ``--rehearse`` runs the same fourteen phases at a tiny size on the
CPU through the plain versions (phases 6 to 8 with their planes as plain
CPU tensors, and without the launch and host-link checks, which need the
card), to check the script itself; it never prints a result and exits
non-zero.  ``--phases 1,8`` runs only the phases named (on the card or in
the rehearsal) and prints no result either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM published HBM3 rate
FP32_FLOPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM bfloat16 tensor cores, dense
# 32-bit integer operations a second outside the tensor cores: the data
# sheet's 67 TFLOP/s float32 counts 128 lanes x 2 (an FMA) a clock on each
# SM; the CUDA programming guide gives compute capability 9.0 64 results a
# clock an SM for 32-bit integer add, compare, min and max: a quarter.
INT32_OPS_PER_S = 67e12 / 4
# int32 operations of one unsigned 64-bit compare or equality test, and of
# one compare under the victim order (occupied, score, key, slot): six
# 32-bit words in one carry chain
OPS_U64_CMP = 2
OPS_VICTIM_CMP = 6
# sweep_match, by predicate kind: whether it reads the score plane (the
# kernel loads it only then), and its int32 operations a slot: the
# liveness test, the kind's unsigned 64-bit compares (epoch_lt compares
# one 32-bit half), and a conjunction for each
SWEEP_KINDS = {"always": (False, OPS_U64_CMP),
               "score_lt": (True, 2 * OPS_U64_CMP + 1),
               "score_ge": (True, 2 * OPS_U64_CMP + 1),
               "epoch_lt": (True, OPS_U64_CMP + 1 + 1),
               "key_range": (False, 3 * OPS_U64_CMP + 2)}
# a float32 sum of a few N(0, 1) terms taken in another order moves by a
# few ulps; duplicates' sums in assign_add / accum_or_assign are atomics
DUP_SUM_ATOL = 1e-5
SEED = 20260417
# back-to-back calls in a stream timing (the kernel's device time without
# the host work of one call)
STREAM_CALLS = 10
# update_scan's optimizers, in the order phase 1 runs them (one extra value
# plane per row width: V = 64 for sgdm and adagrad, 33 for rowwise_adagrad),
# and the float operations each does on a row, a column at a time
OPTIMIZERS = ("sgd", "sgdm", "adagrad", "rowwise_adagrad")
FLOPS_PER_COL = {"sgd": 2, "sgdm": 4, "adagrad": 7, "rowwise_adagrad": 4}
# update_scan's dims past the 8 columns a lane held until PR 16's redesign
# (qwen2-0.5b's d_model is 896), held on a 2^20-slot table (phase 1)
WIDE_DIMS = (257, 512, 896)
NUM_SPARSE = 26                    # DLRM fields (phase 5)
DENSE_FEATURES = 13
TRAIN_LR = 0.05                    # the dense update of the DLRM example
STATUS_NAMES = ("invalid", "updated", "inserted", "evicted", "rejected")
# launches of one op on backend 'auto' on the card, by bucket mode: the
# routing table of repro_torch/core/ops.py.  claim_scan runs on the miss
# lanes only: an op whose batch has none launches it 0 times (Smoke.route).
# A dual upsert's two upsert_probe launches are the match pass and the
# target pass; the target pass is gated to the miss lanes (no host read),
# so it launches on every upsert
UPSERT = {1: {"digest_scan": 1, "claim_scan": 1, "scatter_rows": 2},
          2: {"upsert_probe": 2, "claim_scan": 1, "scatter_rows": 2}}
ROUTES = {
    "insert_or_assign": UPSERT,
    "find": {1: {"find_scan": 1}, 2: {"find_scan": 1}},
    "find_ptr": {1: {"digest_scan": 1}, 2: {"digest_scan": 1}},
    "contains": {1: {"digest_scan": 1}, 2: {"digest_scan": 1}},
    "insert_and_evict": {m: {**UPSERT[m], "gather_rows": 1} for m in (1, 2)},
    "find_or_insert": {m: {**UPSERT[m], "scatter_rows": 1, "gather_rows": 1} for m in (1, 2)},
    "erase_if": {1: {"sweep_match": 1}, 2: {"sweep_match": 1}},
    "evict_if": {1: {"sweep_match": 1}, 2: {"sweep_match": 1}},
}
# the training path's entry points (dual bucket): lookup_train is one
# find_or_insert, apply_grads one update_scan
TRAIN_ROUTES = {"lookup_train": ROUTES["find_or_insert"][2],
                "apply_grads": {"update_scan": 1}}
# on the 'hmem' tier (phase 6) the readers and updaters locate with
# digest_scan and move rows over the host link with gather_rows and
# scatter_rows, as the reference routes that tier
HMEM_ROUTES = {**ROUTES, "find": {2: {"digest_scan": 1, "gather_rows": 1}}}
HMEM_TRAIN_ROUTES = {**TRAIN_ROUTES,
                     "apply_grads": {"digest_scan": 1, "gather_rows": 1, "scatter_rows": 1}}
# the tier hierarchy (phase 7).  lookup_train: the hot locate (digest_scan),
# the cold tier's find_rows (digest_scan, gather_rows), the hot upsert at
# that locate (the target pass, the evicted rows' and the readback's
# gather_rows, one scatter_rows), and the demotion's insert_and_evict into
# the cold tier (two upsert_probe passes, gather_rows, two scatter_rows);
# claim_scan once for the hot tier's miss lanes and at most once more for
# the cold tier's (Smoke.tiered_route).  apply_grads trains the hot tier
# (update_scan); lookup_serve reads both tiers without promoting.
TIERED_ROUTES = {"lookup_train": {"digest_scan": 2, "gather_rows": 4, "upsert_probe": 3,
                                  "scatter_rows": 3},
                 "apply_grads": {"update_scan": 1},
                 "lookup_serve": {"find_scan": 1, "digest_scan": 1, "gather_rows": 1}}
CONFIG_D_DIM = 64
# the serving path (phase 8): Zipf α of the key stream (over twice the cold
# tier's slots, the serve launcher's key space), the update:read ratio of
# the trainer, and exp7's watermarks (benchmarks/exp7_maintenance.py:38)
SERVE_ALPHA = 1.05
SERVE_UPDATE_READ = 0.25
SERVE_LOW, SERVE_HIGH = 0.6, 0.85
# launches of one serving op on backend 'auto' on the card (phase 8), with
# claim_scan once for each upsert whose batch has a miss lane, up to
# SERVE_CLAIMS.  An admitting wave is one tiered find_or_insert (the tiered
# lookup_train's route).  A readonly wave that promotes: find_scan on the
# hot tier, the cold tier's locate and rows (digest_scan, gather_rows), the
# promotion's upsert into the hot tier at an all-miss locate (its target
# pass, two scatter_rows, the evicted rows' gather_rows) and the demotion's
# upsert into the cold tier (two upsert_probe, two scatter_rows, one
# gather_rows).  A maintenance step: the rebalance's evict_if (sweep_match)
# and the demotion of its stream into the cold tier.  A trainer step: the
# tiered find_or_insert and the session's locate and row gather (its
# write-back is plain, as the reference's assign).
SERVE_ROUTES = {
    "admit wave": TIERED_ROUTES["lookup_train"],
    "readonly wave": {"find_scan": 1, "digest_scan": 1, "gather_rows": 3, "upsert_probe": 3,
                      "scatter_rows": 4},
    "maintenance step": {"sweep_match": 1, "upsert_probe": 2, "scatter_rows": 2,
                         "gather_rows": 1},
    "trainer step": {"digest_scan": 3, "gather_rows": 5, "upsert_probe": 3, "scatter_rows": 3},
}
SERVE_CLAIMS = {"admit wave": 2, "readonly wave": 2, "maintenance step": 1, "trainer step": 2}
SERVE_KERNELS = ("find_scan", "digest_scan", "gather_rows", "scatter_rows", "upsert_probe",
                 "claim_scan", "sweep_match")
# the sharded table (phase 10): an op runs its owner op on every shard, so
# its launches are SHARDS times the unsharded op's (dual bucket), claim_scan
# once for each shard whose routed batch holds a miss lane (Smoke.sharded_op).
# A sharded contains is the pure-reader find; assign, erase, export_batch,
# size and stats launch nothing, as their unsharded ops
SHARDS = 8
SHARDED_ROUTES = {op: {k: SHARDS * v for k, v in r.items()} for op, r in {
    "insert_or_assign": UPSERT[2], "find": ROUTES["find"][2], "contains": ROUTES["find"][2],
    "find_or_insert": ROUTES["find_or_insert"][2], "erase_if": ROUTES["erase_if"][2],
    "evict_if": ROUTES["evict_if"][2], "lookup_train": TRAIN_ROUTES["lookup_train"],
    "apply_grads": TRAIN_ROUTES["apply_grads"], "lookup_serve": ROUTES["find"][2],
    "admit wave": ROUTES["find_or_insert"][2], "readonly wave": ROUTES["find"][2],
    "assign": {}, "erase": {}, "export_batch": {}, "stats": {}}.items()}
# the LM training path (phase 11): qwen2-0.5b at its published widths through
# the port's launcher (``repro_torch.launch.train``), the token embedding in a
# ShardedHKVTable of one shard on a (1, 1) mesh.  A step is one sharded
# lookup (the owner's dual-bucket find_or_insert: claim_scan only when the
# step's batch holds a token the table has not seen) and one apply_grads
# (update_scan)
LM_ARCH = "qwen2-0.5b"
TRAIN_LM_ROUTES = {"lookup": TRAIN_ROUTES["lookup_train"],
                   "apply_grads": TRAIN_ROUTES["apply_grads"]}
LM_STEPS, LM_CKPT_EVERY, LM_FAIL_AT = 8, 4, 6
LM_LR = 3e-4                       # the launcher's adamw
LM_GLOBAL_BATCH = 256              # the train_4k shape's global batch
# run B (restored at step 4 and replayed) against run A, on the card, is held
# to what two uninterrupted runs of the same code differ by, measured in the
# same call (run A2 against run A).  Two runs of one bfloat16 training differ,
# restore or not: the card sums in orders that change from run to run (float32
# atomics in apply_grads' index_add_ and in the attention's backward),
# bfloat16 rounds each layer's result, and both optimizers turn a noise-level
# gradient into a full step (adamw divides a coordinate by its own scale;
# rowwise_adagrad steps a row by lr along its gradient's direction).  So run B
# is one more sample of the same spread, and each of its differences is held
# to a multiple of A2's.  The bulk statistics hold the replay: the mean
# absolute difference over all 494M parameters and over the trained rows'
# elements, and the median row's difference relative to its largest element,
# average over millions of elements, and on an H100 run B's came within 7% of
# A2's in every run that measured them (the median row in four runs, 1.50% to
# 1.56%; the means in two, parameters 2.72e-6 to 2.79e-6, rows 7.0e-4 to
# 7.59e-4): 1.5 times A2's.  A replay off its data, its optimizer state or its
# table moves them far more.  The largest differences are extremes of a few
# noise-led coordinates: a parameter's saturates near 8 adamw steps (8 x lr
# 3e-4 = 2.4e-3; 2.2e-3 to 2.9e-3 measured), 3 times A2's; a row element's
# ranged 0.052 to 0.175 (ten differences from six runs) and the losses'
# (relative, the largest of 8 steps) 7.7e-5 to 3.0e-4 (nine from five), a
# factor of 3.4 and 3.9 between two samples: 10 times A2's, which catches a
# run gone wrong (the run's losses differ by more than 1e-2 from one batch to
# the next), not a few rows replayed wrong; those hide in the noise, and the
# restore itself is checked bit for bit on run A's last checkpoint. The floors
# stand where A2 came out nearly equal.  Keys, digests, scores and occupancy
# are exact.
LM_NOISE_TIMES = {"loss": 10, "params": 3, "params_mean": 1.5, "values": 10, "values_mean": 1.5,
                  "median_row": 1.5}
LM_NOISE_FLOOR = {"loss": 1e-5, "params": 3e-5, "params_mean": 1e-7, "values": 1e-3,
                  "values_mean": 1e-5, "median_row": 1e-3}
# the rest of the model zoo (phase 12).  (a) zamba2-1.2b through the launcher
# at its published widths: ZOO_STEPS steps, a checkpoint every ZOO_CKPT_EVERY
# (restored onto the live state before step ZOO_CKPT_EVERY), and
# ZOO_DENSE_STEPS on the dense backend.  (b) each of ZOO_OTHERS at its
# published widths, a warm-up and a timed HKV step; the layer count where one
# card cannot hold the arch: moonshot's stacked expert wi alone is
# 48 x 64 x 2048 x 2816 float32 = 71 GB, before wo, gradients and moments
ZOO_ARCH = "zamba2-1.2b"
ZOO_STEPS, ZOO_CKPT_EVERY, ZOO_DENSE_STEPS = 6, 4, 2
ZOO_OTHERS = (("xlstm-1.3b", None), ("musicgen-medium", None), ("qwen2-vl-2b", None),
              ("moonshot-v1-16b-a3b", 2))
ZOO_OTHER_STEPS = 2
GLA_RANGE = "chunked_gla"          # the profiler range phase 12 puts around the chunked GLA
# LM serving (phase 13).  qwen2-0.5b at its published widths, the grid's
# prefill_32k batch (sz.serve_batch lanes, halved until the prefill fits) and
# decode_32k's context: a prompt of sz.serve_prompt tokens a lane, then
# sz.serve_steps greedy steps that fill max_len = sz.serve_max_len (cut:
# decode_32k's 128 lanes to the prefill's batch: at 32,768 positions 128
# lanes' caches alone are 51.5 GB, beside the one-shot prefill's
# activations).  Then the other archs, SERVE_LM_LANES lanes each:
# (arch, layers a segment or None, the card's prompt, the rehearsal's).
# danube's prompt passes its 4096-slot window, so the ring wraps with a
# shift of 300 and decoding goes on past it; moonshot's is 4 tokens a lane,
# so that no expert can receive more assignments (8, one a token at most)
# than the MoE's least capacity of 8, in the prefill or in a step, and a
# prompt and its step agree; xlstm's sLSTM prefill is a 1-token host loop,
# so its prompt is the shortest but moonshot's.
SERVE_LM_ARCH = "qwen2-0.5b"
SERVE_LM_OTHERS = (("zamba2-1.2b", None, 512, 24), ("h2o-danube-1.8b", None, 4096 + 300, 40),
                   ("xlstm-1.3b", None, 128, 24), ("musicgen-medium", None, 512, 24),
                   ("qwen2-vl-2b", None, 512, 24), ("moonshot-v1-16b-a3b", 2, 4, 4))
SERVE_LM_LANES = 2
SERVE_LM_OTHER_STEPS = 16
SERVE_LM_ENGINE = (4, (8, 12, 10, 16, 9, 14))    # the engine's lanes, its requests' max_new
SERVE_LM_FORM_RUNS = 5                           # timed calls of each decode attention form
# the checks of prefill(t[:n-1]) then decode_step(t[n-1]) against
# prefill(t): in float32 the two orders of work agree to within
# SERVE_F32_RTOL of the logits' largest magnitude; in bfloat16 each path
# rounds on its own, so the two are held to SERVE_BF16_TIMES the distance of
# the bfloat16 prefill's logits from the float32 prefill's (the rounding
# error a bfloat16 run carries, measured in the same call).  SERVE_F32_RTOL
# is set from the float32 runs on the H100: 1.2e-6 to 2.5e-5 of the largest
# logit over the seven archs (zamba2's the largest, its chunked GLA summing
# in another order), so 1e-4 leaves 4x.  As a control, the same decode from
# the state with its position one behind (the token written over the slot
# before it and roped one place early: an off-by-one in the write index or
# the length) must miss by more than the bound wherever the arch reads the
# position
SERVE_F32_RTOL = 1e-4
SERVE_BF16_TIMES = 3
# the card's attention (SDPA) against the port's plain blocked attention:
# bfloat16 operands; the plain form keeps float32 scores and products and
# rounds only its outputs, SDPA's kernels round P to bfloat16 before the PV
# product, so the two differ at bfloat16's precision: relative L2 error
# 1e-2 for the output and each gradient
LM_ATTN_RTOL = 1e-2
# the rest of the train stack (phase 14): the data positions of (a), the
# stages and microbatches of (b), and (b)'s bound on the pipelined bfloat16
# output against the whole batch's, relative to the latter's largest
# magnitude: the two run the same layers with matrix products of other
# shapes, so each layer's bfloat16 output may round one unit (2^-8
# relative) apart, and 24 layers add up to a few units
STACK_POSITIONS = 4
PIPE_STAGES, PIPE_MICROBATCHES = 4, 8
PIPE_BATCHED_TOL = 2**-5
COMPRESS_BOUND = 0.05              # tests/test_distributed.py:120,142


@dataclasses.dataclass(frozen=True)
class Sizes:
    capacity: int            # config B slots (phases 1 and 3)
    batch: int               # keys per insert_or_assign / find
    small_capacity: int      # phase 2
    small_batch: int
    hot_keys: int            # keys aimed at one bucket, to force rejections
    timed_runs: int
    replay_steps: int        # phase 2's every-op replay, per mode and policy
    train_batch: int         # DLRM samples a step (phases 5-7; 26 keys each)
    train_steps: int
    hot_capacity: int        # phase 7's and 8's hot tier (the cold tier: `capacity` slots)
    serve_wave: int          # phase 8's lanes a wave
    serve_samples: int       # DLRM samples a request (26 keys each)
    serve_waves: int         # waves of runs 1 and 2 (the twins: half)
    serve_ticks: int         # ticks of run 3 (burst arrivals)
    many_capacity: int       # phase 9's NUM_SPARSE tables of find_many_kernel
    lm_batch: int            # phase 11's sequences a step (the global batch of 256, cut)
    lm_seq: int              # phase 11's sequence length (train_4k's)
    swa_seq: int             # phase 11's danube attention check: sequence and window
    swa_window: int
    serve_batch: int         # phase 13's qwen2 lanes (prefill_32k's global batch)
    serve_prompt: int        # its prompt a lane
    serve_steps: int         # its greedy decode steps
    serve_max_len: int       # its decode state's positions (decode_32k's context)
    serve_engine_prompt: int  # the wave engine's prompts


FULL = Sizes(capacity=2**27, batch=2**20, small_capacity=2**20, small_batch=2**16,
             hot_keys=1024, timed_runs=5, replay_steps=10, train_batch=32768, train_steps=5,
             hot_capacity=2**24, serve_wave=2**16, serve_samples=2520, serve_waves=24,
             serve_ticks=48, many_capacity=2**22, lm_batch=8, lm_seq=4096, swa_seq=8192,
             swa_window=4096, serve_batch=32, serve_prompt=32768 - 128, serve_steps=128,
             serve_max_len=32768, serve_engine_prompt=64)
TINY = Sizes(capacity=2**12, batch=2**9, small_capacity=2**11, small_batch=2**9,
             hot_keys=400, timed_runs=2, replay_steps=4, train_batch=16, train_steps=3,
             hot_capacity=2**9, serve_wave=2**7, serve_samples=4, serve_waves=8, serve_ticks=12,
             many_capacity=2**10, lm_batch=2, lm_seq=32, swa_seq=256, swa_window=64,
             serve_batch=2, serve_prompt=28, serve_steps=4, serve_max_len=32,
             serve_engine_prompt=8)
DIM = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def kernel_name(ptxas_line: str) -> str:
    """The demangled kernel (with its template arguments) that a ptxas
    "Compiling entry function" line names."""
    m = re.search(r"'(_Z\w+)'", ptxas_line)
    if m is None:
        return ptxas_line.strip()
    name = m.group(1)
    if shutil.which("c++filt"):
        name = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip()


def main(argv: list[str]) -> int:
    rehearse = "--rehearse" in argv
    # --phases 2,8: run only those phases (to iterate on them); no result
    only = ({int(x) for x in argv[argv.index("--phases") + 1].split(",")}
            if "--phases" in argv else set())
    import torch

    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the repository root",
              file=sys.stderr)
        return 2
    smoke = Smoke(torch.device("cpu") if rehearse else torch.device("cuda"),
                  TINY if rehearse else FULL, only)
    smoke.run()
    if rehearse or only:
        log(f"chip_smoke: {'rehearsal on the CPU' if rehearse else 'a run of some phases'} "
            "finished; no result is printed")
        return 3
    print(json.dumps({"kernels": smoke.kernel_rows()}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _chain(stage_fn, stage_params: list, x):
    """`stage_fn` of each stage's parameters, in stage order, on x."""
    for p in stage_params:
        x = stage_fn(p, x)
    return x


class Smoke:
    def __init__(self, device, sizes: Sizes, only: set = frozenset()):
        import torch

        from repro_torch.core import find as find_mod
        from repro_torch.core import u64
        from repro_torch.kernels import _build, digest_scan, find_scan, gather, scatter
        from repro_torch.kernels import score_scan, sweep_scan, update_scan, upsert_scan
        from repro_torch import SweepPredicate

        self.torch, self.dev, self.sz, self.only = torch, device, sizes, only
        self.find_mod, self.u64, self._build = find_mod, u64, _build
        self.fs, self.us, self.sc = find_scan, upsert_scan, scatter
        self.ga, self.ds, self.sw = gather, digest_scan, sweep_scan
        self.up, self.ss = update_scan, score_scan
        self.Pred = SweepPredicate
        self.gen = torch.Generator(device=device).manual_seed(SEED)
        self.next_key = 1
        self.stats: dict[str, dict] = {}      # per kernel: errors, timings, bounds
        self.launches: dict[str, int] = {}
        self.launches_train: dict[str, int] = {}
        self.launches_serve: dict[str, int] = {}
        self.launches_sharded: dict[str, int] = {}
        self.launches_lm: dict[str, int] = {}
        self.launches_zoo: dict[str, int] = {}
        self.launches_serve_lm: dict[str, int] = {}
        self.launches_stack: dict[str, int] = {}
        self.train_cmp: dict[str, float] = {}
        # unsharded config B op times of phases 3-5 (ms), for phase 10's ratios
        self.unsharded: dict[str, float] = {}

    # ------------------------------------------------------------------ utils

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def fresh_keys(self, n: int):
        """n keys never issued before, in [0, 2^63): an odd multiplier and
        an offset modulo 2^63 are a bijection, so distinct counters give
        distinct keys.  (A negative int64 id is padding at the API.)"""
        torch = self.torch
        idx = torch.arange(self.next_key, self.next_key + n, device=self.dev)
        self.next_key += n
        return (idx * 0x2545F4914F6CDD1D + 0x1D8E4E27C47D124F) & (2**63 - 1)

    def values(self, n: int, dim: int = DIM):
        return self.torch.randn((n, dim), generator=self.gen, device=self.dev)

    def time_ms(self, fn, runs: int, warmup: int = 1, calls: int = 1) -> float:
        """Median of `runs` timings (CUDA events on the card) of `calls`
        back-to-back calls, over `calls`.  One call between the events
        counts its host work too (a wrapper's checks, allocations and
        launch), which a stream of calls hides behind the kernels."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(runs):
            self.sync()
            if self.dev.type == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(calls):
                    fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / calls)
            else:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                times.append((time.perf_counter() - t0) * 1e3 / calls)
        return statistics.median(times)

    def hot_bucket_keys(self, num_buckets: int, n: int, bucket: int):
        """n fresh keys whose primary bucket is `bucket`, built by inverting
        the fmix32 finalizer: h1 = fmix32(fmix32(hi ^ GOLDEN) ^ lo) is chosen
        with its low bits equal to `bucket`, and lo solved for."""
        torch, u64 = self.torch, self.u64
        m = u64.MASK32

        def unxorshift(h, s):
            x = h
            for _ in range(32 // s + 1):
                x = h ^ (x >> s)
            return x & m

        def fmix32_inv(h):
            h = unxorshift(h, 16)
            h = (h * pow(0xC2B2AE35, -1, 2**32)) & m
            h = unxorshift(h, 13)
            h = (h * pow(0x85EBCA6B, -1, 2**32)) & m
            return unxorshift(h, 16)

        bucket %= num_buckets
        j = torch.arange(n, device=self.dev)
        h1 = (bucket + j * num_buckets) & m
        hi = (0x5EED0000 + j + self.next_key) & 0x7FFFFFFF   # below 2^63: not padding
        self.next_key += n
        a = u64.fmix32(hi ^ 0x9E3779B9)
        keys = u64.join(hi, fmix32_inv(h1) ^ a)
        h1_check, _ = u64.hash_pair(keys)
        require(bool((u64.bucket_from_hash(h1_check, num_buckets) == bucket).all()),
                "hot keys missed their bucket")
        return keys

    def record(self, name: str, **kw):
        self.stats.setdefault(name, {}).update(kw)

    @staticmethod
    def route(want: dict, has_miss: bool) -> dict:
        """An upserting op's expected launches: the victim stage, and with
        it claim_scan, runs only where the batch has a miss lane."""
        return {k: v for k, v in want.items() if has_miss or k != "claim_scan"}

    @staticmethod
    def has_miss(status) -> bool:
        return bool((status >= 2).any())   # a lane inserted, evicted or rejected

    @contextlib.contextmanager
    def stage_lanes(self):
        """Record the lanes each upsert's victim stage (claim_scan on the
        card) gets, and the lane gate of its select stage (upsert_probe's
        target pass): yields {"victim": [lane counts], "target": [gates]}.
        The kernel and plain stage sets are wrapped where the ops look them
        up; the closure is unchanged."""
        from repro_torch.core import merge
        from repro_torch.kernels import ops as kops

        calls = {"victim": [], "target": []}

        def wrap(make):
            def stages(*args):
                st = make(*args)

                def victim_at_rank(state, cfg, buckets, rank):
                    calls["victim"].append(buckets.shape[0])
                    return st.victim_at_rank(state, cfg, buckets, rank)

                def select_target(state, cfg, probe, lanes):
                    calls["target"].append(lanes)
                    return st.select_target(state, cfg, probe, lanes)
                return st._replace(victim_at_rank=victim_at_rank, select_target=select_target)
            return stages

        saved = kops.kernel_stages, merge.plain_stages
        kops.kernel_stages, merge.plain_stages = wrap(saved[0]), wrap(saved[1])
        try:
            yield calls
        finally:
            kops.kernel_stages, merge.plain_stages = saved

    def check_equal(self, name: str, got, want, ctx: str) -> None:
        """Kernel outputs against the plain version's: bit-identical."""
        torch = self.torch
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{name} {ctx}: output {i} is {g.dtype}{tuple(g.shape)}, "
                                     f"plain gives {w.dtype}{tuple(w.shape)}")
            if not torch.equal(g, w):
                ne = g != w
                diff = (g[ne].double() - w[ne].double()).abs().max().item()
                raise AssertionError(f"{name} {ctx}: output {i} differs from the plain "
                                     f"version in {int(ne.sum())} elements (max abs diff {diff})")
        # equal outputs: the largest absolute difference is 0
        self.record(name, max_abs_err=0.0)
        self.stats[name].setdefault("checks", []).append(ctx)

    # ----------------------------------------------------------------- phases

    def run(self):
        torch = self.torch
        log(f"chip_smoke: python {sys.version.split()[0]} torch {torch.__version__} "
            f"cuda {torch.version.cuda} device {self.dev}"
            + (f" ({torch.cuda.get_device_name(0)})" if self.dev.type == "cuda" else ""))
        if self.dev.type == "cuda":
            t0 = time.perf_counter()
            lib = self._build.build()
            self._build.library()
            log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
            for entry in self._build.build_log:
                for line in entry.splitlines():
                    if "Compiling entry function" in line:
                        log("  " + kernel_name(line))
                    elif "registers" in line or line.startswith("[nvcc") or "spill" in line:
                        log("  " + line.strip())
        phases = [("kernel vs plain at config B shapes", self.phase_kernels),
                  ("kernel path vs plain path", self.phase_paths),
                  ("main path at config B", self.phase_main),
                  ("the rest of the op surface at config B", self.phase_rest),
                  ("the training path at config B", self.phase_train),
                  ("config D, the host-memory value tier", self.phase_hmem),
                  ("the tier hierarchy", self.phase_tiered),
                  ("the serving path", self.phase_serve),
                  ("telemetry, baselines and the multi-table find at config B",
                   self.phase_tel_base),
                  ("the sharded table", self.phase_sharded),
                  ("the LM training path with the HKV embedding", self.phase_lm),
                  ("the rest of the model zoo", self.phase_zoo),
                  ("LM serving", self.phase_serve_lm),
                  ("the rest of the train stack", self.phase_train_stack)]
        for i, (what, phase) in enumerate(phases, 1):
            if self.only and i not in self.only:
                continue
            t0 = time.perf_counter()
            phase()
            log(f"phase {i} ({what}) passed in {time.perf_counter() - t0:.1f} s")
        if self.only:
            self.card_line()
            return
        self.report()

    def config_b(self, backend="auto", buckets_per_key=2):
        from repro_torch import HKVTable

        return HKVTable.create(capacity=self.sz.capacity, dim=DIM,
                               buckets_per_key=buckets_per_key,
                               score_policy="lru", device=self.dev, backend=backend)

    def fill(self, table, target: float):
        """insert_or_assign fresh batches until the load factor reaches
        `target`; returns the last batch's keys, values and statuses."""
        keys = vals = status = None
        for _ in range(4 * table.capacity // self.sz.batch + 8):
            if table.load_factor() >= target:
                break
            keys, vals = self.fresh_keys(self.sz.batch), self.values(self.sz.batch, table.dim)
            status = table.insert_or_assign(keys, vals).status
        require(table.load_factor() >= target, f"the table did not reach λ = {target}")
        return keys, vals, status

    # phase 1 --------------------------------------------------------------

    def phase_kernels(self):
        table = self.config_b()
        resident = self.fill(table, 0.5)[0]
        for lam in (0.5, 1.0):
            if lam == 1.0:
                resident = self.fill(table, 1.0)[0]
            log(f"phase 1: λ = {table.load_factor():.6f}")
            self.compare_kernels(table, resident, lam)
            self.compare_new_kernels(table, resident, str(lam))
            self.compare_update_scan(table, resident, lam, main=True)
            self.compare_bucket_stats(table, lam)
        self.compare_bf16(table, resident)
        del table
        self.free()
        table = self.config_b(buckets_per_key=1)
        resident = self.fill(table, 1.0)[0]
        log(f"phase 1: single-bucket table, λ = {table.load_factor():.6f}")
        self.compare_new_kernels(table, resident, "1.0 single")
        del table
        self.free()
        self.compare_update_wide()

    def free(self):
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def queries(self, resident, n):
        """Queries as find sees them: half resident, half fresh, some EMPTY."""
        q = self.torch.cat([resident[: n // 2], self.fresh_keys(n - n // 2)])
        q = q[self.torch.randperm(n, generator=self.gen, device=self.dev)]
        q[:: 97] = self.u64.EMPTY
        return q

    def compare_new_kernels(self, table, resident, tag: str):
        """gather_rows, digest_scan and sweep_match against their plain
        versions on this table; `tag` names the table's λ (and mode)."""
        torch, sz = self.torch, self.sz
        st, cfg = table.state, table.cfg
        n, s, runs = sz.batch, cfg.slots_per_bucket, sz.timed_runs
        q = self.queries(resident, n)
        p = self.find_mod.probe_keys(cfg, q)

        self.compare_gather(st.values, tag)

        # digest_scan: the single-row form on each candidate bucket row (one
        # in single mode), and on a dual table the dual form, which find_ptr,
        # contains and the 'hmem' tier's locate launch once over both rows
        for b in (p.bucket1, p.bucket2) if cfg.buckets_per_key == 2 else (p.bucket1,):
            args = (st.digests, st.keys, b, p.digest, q)
            self.check_equal("digest_scan", self.ds.digest_scan(*args),
                             self.ds.digest_scan_plain(*args), tag)
        args = (st.digests, st.keys, p.bucket1, p.digest, q)
        self.record("digest_scan", **{
            f"ms@{tag}": self.time_ms(lambda: self.ds.digest_scan(*args), runs),
            f"ms_stream@{tag}": self.time_ms(lambda: self.ds.digest_scan(*args), runs,
                                             calls=STREAM_CALLS),
            f"plain_ms@{tag}": self.time_ms(lambda: self.ds.digest_scan_plain(*args), 2),
            **self.digest_work(st, p.bucket1, p.digest, f"@{tag}")})
        if cfg.buckets_per_key == 2:
            dual = (*args, p.bucket2)
            want = self.ds.digest_scan_plain(*dual)
            self.check_equal("digest_scan", self.ds.digest_scan(*dual), want, tag + " dual form")
            self.record("digest_scan", **{
                f"ms_dual@{tag}": self.time_ms(lambda: self.ds.digest_scan(*dual), runs),
                f"ms_dual_stream@{tag}": self.time_ms(lambda: self.ds.digest_scan(*dual), runs,
                                                      calls=STREAM_CALLS),
                f"plain_ms_dual@{tag}": self.time_ms(lambda: self.ds.digest_scan_plain(*dual), 2),
                **self.digest_work(st, p.bucket1, p.digest, f"_dual@{tag}",
                                   bucket2=p.bucket2, hit1=want[1].bool() & (want[2] == 0))})

        # sweep_match: every predicate kind over all slots.  LRU scores
        # carry no epoch (their high half is 0), so epoch_lt runs on the
        # table's keys with a score plane whose high halves are random
        # epochs, half of them >= 2^31, against a threshold that splits them
        sc = torch.sort(self.u64.flip(st.scores[st.keys != self.u64.EMPTY])).values
        mid = self.u64.flip(sc[sc.numel() // 2])
        epochs = torch.randint(0, 2**32, st.scores.shape, generator=self.gen, device=self.dev)
        epoch_scores = self.u64.join(epochs, self.u64.lo32(st.scores))
        preds = {"always": (self.Pred.always(), st.scores),
                 "score_lt": (self.Pred.score_below(mid), st.scores),
                 "score_ge": (self.Pred.score_at_least(mid), st.scores),
                 "epoch_lt": (self.Pred.expire_before(3 * 2**30), epoch_scores),
                 "key_range": (self.Pred.key_in_range(0, 2**61), st.scores)}
        b_tot = cfg.num_buckets
        work = {}
        for kind, (pred, scores) in preds.items():
            got = self.sw.sweep_match(st.keys, scores, pred)
            self.check_equal("sweep_match", got, self.sw.sweep_match_plain(st.keys, scores, pred),
                             f"{tag} {kind}")
            n_match = int(got[1].sum())
            live = int((st.keys != self.u64.EMPTY).sum())
            require(kind == "always" or 0 < n_match < live,
                    f"sweep_match {kind} at {tag}: {n_match} of {live} live slots match; "
                    "the check does not split the table")
            reads_score, ops = SWEEP_KINDS[kind]
            work[kind] = {
                f"ms_{kind}@{tag}": self.time_ms(
                    lambda: self.sw.sweep_match(st.keys, scores, pred), runs),
                f"bytes_{kind}@{tag}": b_tot * s * (8 + 8 * reads_score + 1) + b_tot * 4,
                f"ops_{kind}@{tag}": b_tot * s * ops}
        # the kernels line reports key_range, erase_if's kind on the main path
        pred = preds["key_range"][0]
        kr = work["key_range"]
        self.record("sweep_match", **{k: v for w in work.values() for k, v in w.items()}, **{
            f"ms@{tag}": kr[f"ms_key_range@{tag}"],
            f"plain_ms@{tag}": self.time_ms(
                lambda: self.sw.sweep_match_plain(st.keys, st.scores, pred), 2),
            f"bytes@{tag}": kr[f"bytes_key_range@{tag}"],
            f"ops@{tag}": kr[f"ops_key_range@{tag}"]})
        del epochs, epoch_scores
        self.free()

    def compare_gather(self, values, tag: str, width=None):
        """gather_rows of the first `width` columns (all by default) of
        `values` against its plain version: rows of resident and missing
        keys, half masked, the main path's 2^20 lanes; timed beside
        index_select and the mask, and its bound (the indices, mask and
        the masked rows' `width` columns read, the output written)."""
        torch, n, runs = self.torch, self.sz.batch, self.sz.timed_runs
        r_tot, v = values.shape
        w = v if width is None else width
        rows = torch.randint(0, r_tot, (n,), generator=self.gen, device=self.dev)
        mask = torch.rand(n, generator=self.gen, device=self.dev) < 0.5
        got = self.ga.gather_rows(values, rows, mask, width)
        self.check_equal("gather_rows", (got,),
                         (self.ga.gather_rows_plain(values, rows, mask, width),), tag)
        m, es = int(mask.sum()), values.element_size()
        cols = values[:, :w]
        self.record("gather_rows", **{
            f"ms@{tag}": self.time_ms(lambda: self.ga.gather_rows(values, rows, mask, width), runs),
            f"ms_stream@{tag}": self.time_ms(
                lambda: self.ga.gather_rows(values, rows, mask, width), runs, calls=STREAM_CALLS),
            f"plain_ms@{tag}": self.time_ms(
                lambda: self.ga.gather_rows_plain(values, rows, mask, width), 2),
            f"library_ms@{tag}": self.time_ms(
                lambda: torch.where(mask[:, None], cols.index_select(0, rows), 0), runs),
            f"bytes@{tag}": n * (4 + 1) + m * w * es + n * w * es, f"ops@{tag}": 0})

    def compare_bf16(self, table, resident):
        """A bfloat16 value plane of config B's size (2^27 rows of 32: 8.6
        GB) on this table's key planes (dual, λ 1.0): find_scan, gather_rows
        (whole rows and their first 16 columns) and scatter_rows (set and
        add) against their plain versions; find_scan and gather_rows timed."""
        torch = self.torch
        st, cfg = table.state, table.cfg
        values = torch.empty((st.values.shape[0], DIM), dtype=torch.bfloat16,
                             device=self.dev).normal_(generator=self.gen)
        tag = "1.0 bf16"
        q = self.queries(resident, self.sz.batch)
        p = self.find_mod.probe_keys(cfg, q)
        args = (st.digests, st.keys, st.scores, values, p.bucket1, p.bucket2, p.digest, q)
        want = self.fs.find_scan_plain(*args)
        self.check_equal("find_scan", self.fs.find_scan(*args), want, tag)
        self.record("find_scan", **{
            f"ms@{tag}": self.time_ms(lambda: self.fs.find_scan(*args), self.sz.timed_runs),
            f"plain_ms@{tag}": self.time_ms(lambda: self.fs.find_scan_plain(*args), 2),
            **self.find_work(st, p, q, want, tag, values)})
        self.compare_gather(values, tag)
        self.compare_gather(values, tag + " width 16", width=16)
        self.compare_scatter(values, tag, "_bf16@1.0")
        del values
        self.free()

    def compare_update_wide(self):
        """update_scan at dims 257, 512 and 896 (float32 planes), and at
        dim 32 on bfloat16 planes, on a 2^20-slot dual table past λ 1.0:
        at 2^20 rows adagrad's plane at dim 896 (V = 1792) is 7.5 GB."""
        from repro_torch import HKVTable

        table = HKVTable.create(capacity=self.sz.small_capacity, dim=DIM, buckets_per_key=2,
                                score_policy="lru", device=self.dev)
        resident = self.fill(table, 1.0)[0]
        log(f"phase 1: update_scan table of {table.capacity} slots, λ = "
            f"{table.load_factor():.6f}")
        for dim in WIDE_DIMS:
            self.compare_update_scan(table, resident, f"dim {dim}", dim=dim)
        self.compare_update_scan(table, resident, "bf16", dtype=self.torch.bfloat16)
        del table
        self.free()

    def digest_work(self, st, bucket, qdigest, key, bucket2=None, hit1=None) -> dict:
        """Least bytes and operations of one digest_scan launch: the query
        inputs (4-byte bucket index, digest, key), the digest line of each
        distinct probed row, the keys whose digest matched, and the int32
        outputs; 128 digest bytes a probed row, four to a 32-bit compare,
        and one 64-bit equality a candidate.  The dual form (`bucket2`)
        probes bucket2 only after a miss in bucket1 (`hit1`), where it is
        another row, and writes three outputs."""
        torch = self.torch
        n = bucket.shape[0]
        probed_b, probed_q, outs = bucket, torch.arange(n, device=self.dev), 8
        if bucket2 is not None:
            second = ~hit1 & (bucket2 != bucket)
            probed_b = torch.cat([bucket, bucket2[second]])
            probed_q = torch.cat([probed_q, torch.nonzero(second).flatten()])
            n_in, outs = n * (4 + 4 + 1 + 8), 12
        else:
            n_in = n * (4 + 1 + 8)
        cand = int((st.digests[probed_b] == qdigest[probed_q][:, None]).sum())
        rows = torch.unique(probed_b).numel()
        return {f"bytes{key}": n_in + rows * 128 + cand * 8 + n * outs,
                f"ops{key}": probed_b.numel() * 128 // 4 + cand * OPS_U64_CMP}

    def compare_kernels(self, table, resident, lam: float):
        torch, sz = self.torch, self.sz
        st, cfg = table.state, table.cfg
        n, b, s = sz.batch, cfg.num_buckets, cfg.slots_per_bucket
        runs, tag = sz.timed_runs, f"λ={lam}"
        # queries as find sees them: half resident, half fresh, some EMPTY
        q = torch.cat([resident[: n // 2], self.fresh_keys(n - n // 2)])
        q = q[torch.randperm(n, generator=self.gen, device=self.dev)]
        q[:: 97] = self.u64.EMPTY
        p = self.find_mod.probe_keys(cfg, q)
        planes = (st.digests, st.keys, st.scores)

        # find_scan
        args = (*planes, st.values, p.bucket1, p.bucket2, p.digest, q)
        got, want = self.fs.find_scan(*args), self.fs.find_scan_plain(*args)
        self.check_equal("find_scan", got, want, tag)
        self.record("find_scan", **{f"ms@{lam}": self.time_ms(lambda: self.fs.find_scan(*args), runs),
                                    f"ms_stream@{lam}": self.time_ms(
                                        lambda: self.fs.find_scan(*args), runs, calls=STREAM_CALLS),
                                    f"plain_ms@{lam}": self.time_ms(lambda: self.fs.find_scan_plain(*args), 2),
                                    **self.find_work(st, p, q, want, lam, st.values)})

        # upsert_probe: the TPU kernel's whole function (mode "both", timed
        # against the bound of every key and score of both rows), and the
        # two modes the closure calls: match on the main path's queries,
        # target with no query, on every lane and on a lane gate that is
        # mostly off (the closure's miss lanes)
        args = (*planes, p.bucket1, p.bucket2, p.digest, q)
        self.check_equal("upsert_probe", self.us.upsert_probe(*args),
                         self.us.upsert_probe_plain(*args), tag + " both")
        match = self.us.upsert_probe_plain(*args, mode="match")
        self.check_equal("upsert_probe", self.us.upsert_probe(*args, mode="match")[:3],
                         match[:3], tag + " match")
        targs = (*planes, p.bucket1, p.bucket2)
        gate = torch.rand(n, generator=self.gen, device=self.dev) < 0.1
        for lanes, ctx in ((None, "target"), (gate, "target gated")):
            self.check_equal("upsert_probe",
                             self.us.upsert_probe(*targs, mode="target", lanes=lanes)[3:],
                             self.us.upsert_probe_plain(*targs, mode="target", lanes=lanes)[3:],
                             f"{tag} {ctx}")
        # least work of the whole function: every key and score of both
        # rows (occupancy and the minimum need them all, and the full-key
        # match then needs no digest), read once a distinct row; per slot an
        # occupancy test, a minimum step and a key equality, each one
        # unsigned 64-bit compare
        rows = torch.unique(torch.cat([p.bucket1, p.bucket2])).numel()
        self.record("upsert_probe", **{
            f"ms@{lam}": self.time_ms(lambda: self.us.upsert_probe(*args), runs),
            f"plain_ms@{lam}": self.time_ms(lambda: self.us.upsert_probe_plain(*args), 2),
            f"bytes@{lam}": rows * 16 * s + n * (4 + 4 + 8) + n * 16,
            f"ops@{lam}": 2 * n * s * 3 * OPS_U64_CMP,
            f"ms_match@{lam}": self.time_ms(lambda: self.us.upsert_probe(*args, mode="match"),
                                            runs),
            f"ms_match_stream@{lam}": self.time_ms(
                lambda: self.us.upsert_probe(*args, mode="match"), runs, calls=STREAM_CALLS),
            **self.match_work(st, p, q, match, f"_match@{lam}"),
            f"ms_target@{lam}": self.time_ms(
                lambda: self.us.upsert_probe(*targs, mode="target"), runs),
            **self.target_work(st, p, None, f"_target@{lam}"),
            f"ms_target_gated@{lam}": self.time_ms(
                lambda: self.us.upsert_probe(*targs, mode="target", lanes=gate), runs),
            **self.target_work(st, p, gate, f"_target_gated@{lam}")})

        # claim_scan: target buckets with small canonical ranks, and the full range
        buckets = torch.randint(0, b, (n,), generator=self.gen, device=self.dev)
        rank = torch.randint(0, 3, (n,), generator=self.gen, device=self.dev)
        rank[::8] = torch.randint(0, s, (rank[::8].numel(),), generator=self.gen, device=self.dev)
        args = (st.keys, st.scores, buckets, rank)
        self.check_equal("claim_scan", self.us.claim_scan(*args), self.us.claim_scan_plain(*args), tag)
        # least work: the keys and scores of each distinct row once; and a
        # selection of rank r among s slots makes at least s - 1 compares
        # (the compare graph must connect them), each under the victim
        # order.  The kernel itself makes s * s, 128 times that: its time
        # is checked against its compare loop by rerunning it with every
        # query on one row, whose bytes then come from cache.
        rows = torch.unique(buckets).numel()
        one_row = (st.keys, st.scores, torch.full_like(buckets, int(buckets[0])), rank)
        self.record("claim_scan", **{
            f"ms@{lam}": self.time_ms(lambda: self.us.claim_scan(*args), runs),
            f"ms_one_row@{lam}": self.time_ms(lambda: self.us.claim_scan(*one_row), runs),
            f"plain_ms@{lam}": self.time_ms(lambda: self.us.claim_scan_plain(*args), 2),
            f"bytes@{lam}": rows * 16 * s + n * (4 + 4) + n * 24,
            f"ops@{lam}": n * (s - 1) * OPS_VICTIM_CMP,
            f"loop_ops@{lam}": n * s * s * OPS_VICTIM_CMP})

        self.compare_scatter(st.values, tag, f"@{lam}")

    def compare_scatter(self, values, ctx: str, key: str):
        """scatter_rows, set and add, against the plain version on a copy
        of `values` each (2^20 lanes, nine tenths masked in; masked-out
        lanes aimed at a written row and past the plane, which must not
        write); then timed in place beside index_put_ on the masked lanes,
        and beside index_fill_ of the same rows, which reads no update: the
        cost of the stores alone.  `key` suffixes the recorded numbers."""
        torch, sz = self.torch, self.sz
        n = sz.batch
        r_tot, v = values.shape
        rows_i = torch.randperm(r_tot, generator=self.gen, device=self.dev)[:n]
        mask = torch.rand(n, generator=self.gen, device=self.dev) < 0.9
        rows_i[~mask] = torch.where(torch.arange(n, device=self.dev)[~mask] % 2 == 0,
                                    rows_i[mask][0], r_tot + 5)   # must not write
        upd = torch.randn((n, v), generator=self.gen, device=self.dev).to(values.dtype)
        for add in (False, True):
            vp = values.clone()
            self.sc.scatter_rows(values, rows_i, upd, mask, add)
            self.sc.scatter_rows_plain(vp, rows_i, upd, mask, add)
            self.check_equal("scatter_rows", (values,), (vp,), ctx + (" add" if add else " set"))
            del vp
        rows_m, upd_m = rows_i[mask], upd[mask]
        m = int(mask.sum())
        runs = sz.timed_runs
        self.record("scatter_rows", **{
            f"ms{key}": self.time_ms(
                lambda: self.sc.scatter_rows(values, rows_i, upd, mask, False), runs),
            f"plain_ms{key}": self.time_ms(
                lambda: self.sc.scatter_rows_plain(values, rows_i, upd, mask, False), 2),
            f"library_ms{key}": self.time_ms(lambda: values.index_put_((rows_m,), upd_m), runs),
            f"fill_ms{key}": self.time_ms(lambda: values.index_fill_(0, rows_m, 0.5), runs),
            f"bytes{key}": n * (4 + 1) + m * v * values.element_size() * 2, f"ops{key}": 0})
        self.free()

    def find_work(self, st, p, q, plain_out, lam, values) -> dict:
        """Least bytes and operations of find_scan on these queries.  Bytes:
        the query inputs (4-byte bucket indices); the digest line of every
        probed row (none for an EMPTY key, bucket2 only after a miss in
        bucket1); the keys whose digest matched; the score and value row
        (of `values`' elements) of each hit; and the outputs.  Operations:
        128 digest bytes a probed row, four to a 32-bit compare, and one
        64-bit equality a candidate."""
        torch = self.torch
        found, sel = plain_out[0].bool(), plain_out[1].bool()
        n, row = q.shape[0], values.shape[1] * values.element_size()
        valid = q != self.u64.EMPTY
        second = valid & ~(found & ~sel) & (p.bucket2 != p.bucket1)   # probed after bucket1
        probed_b = torch.cat([p.bucket1[valid], p.bucket2[second]])
        probed_q = torch.cat([torch.nonzero(valid).flatten(), torch.nonzero(second).flatten()])
        cand = int((st.digests[probed_b] == p.digest[probed_q][:, None]).sum())
        rows = torch.unique(probed_b).numel()
        hits = int(found.sum())
        return {f"bytes@{lam}": (n * (4 + 4 + 1 + 8) + rows * 128 + cand * 8 + hits * (8 + row)
                                 + n * (4 + 4 + 4 + 8 + row)),
                f"ops@{lam}": probed_b.numel() * 128 // 4 + cand * OPS_U64_CMP}

    def match_work(self, st, p, q, plain_out, key) -> dict:
        """Least bytes and operations of upsert_probe's match mode: as
        find_work, without the EMPTY rule (an EMPTY key is probed like any
        other), without score and value, and with three int32 outputs."""
        torch = self.torch
        found, hit_sel = plain_out[0].bool(), plain_out[1].bool()
        n = q.shape[0]
        second = ~(found & ~hit_sel) & (p.bucket2 != p.bucket1)   # probed after bucket1
        probed_b = torch.cat([p.bucket1, p.bucket2[second]])
        probed_q = torch.cat([torch.arange(n, device=self.dev), torch.nonzero(second).flatten()])
        cand = int((st.digests[probed_b] == p.digest[probed_q][:, None]).sum())
        rows = torch.unique(probed_b).numel()
        return {f"bytes{key}": n * (4 + 4 + 1 + 8) + rows * 128 + cand * 8 + n * 12,
                f"ops{key}": probed_b.numel() * 128 // 4 + cand * OPS_U64_CMP}

    def target_work(self, st, p, lanes, key) -> dict:
        """Least bytes and operations of upsert_probe's target mode on the
        lanes of the gate `lanes` (every lane without one): the gate, the
        two 4-byte bucket indices of each gated lane, the keys of each
        distinct row of the lanes whose two candidates are two rows,
        the scores of each distinct row of the ones whose rows are both
        full, and the int32 output; per slot an occupancy test, and at full
        rows a minimum step, each one unsigned 64-bit compare."""
        torch, u64 = self.torch, self.u64
        n, s = p.bucket1.shape[0], st.keys.shape[1]
        on = torch.ones_like(p.bucket1, dtype=torch.bool) if lanes is None else lanes
        work = on & (p.bucket1 != p.bucket2)
        b1, b2 = p.bucket1[work], p.bucket2[work]
        occ = (st.keys != u64.EMPTY).sum(dim=1)
        full = (occ[b1] == s) & (occ[b2] == s)
        rows = torch.unique(torch.cat([b1, b2])).numel()
        full_rows = torch.unique(torch.cat([b1[full], b2[full]])).numel()
        m, f = b1.numel(), int(full.sum())
        return {f"bytes{key}": (n if lanes is not None else 0) + int(on.sum()) * 8
                + rows * 8 * s + full_rows * 8 * s + n * 4,
                f"ops{key}": (m + f) * 2 * s * OPS_U64_CMP,
                f"lanes{key}": m}

    def checksum(self, values) -> int:
        """A bit-exact checksum of a value plane: the sum of its 32-bit
        words, in slices so that no int64 copy of the plane is made."""
        torch = self.torch
        flat = values.view(-1).view(torch.int32)
        return sum(int(c.sum(dtype=torch.int64)) for c in flat.split(2**28))

    def compare_update_scan(self, table, resident, tag, dim=DIM, dtype=None, main=False):
        """update_scan against its plain version for every optimizer and
        both bucket modes, on this table's key planes, with the main path's
        query count (a DLRM step's keys): unique keys, half resident, some
        EMPTY and some with the gate off; at `dim`, on value planes of
        `dtype` (the table's own).  The value plane of each row width is
        the table's own (`main`: config B's V = 32) or one made for the
        check and filled with uniform [0, 1) values (adagrad accumulators
        must be >= 0); it is not cloned: the rows a hit may touch are saved,
        the kernel runs, those rows are read and the saved ones put back,
        and a checksum shows the rest of the plane unchanged; then the plain
        version runs the same way.  Every case is timed; rowwise_adagrad in
        dual mode (config B's optimizer) also against its plain version and
        its bound.  `tag` suffixes the recorded numbers."""
        from repro_torch.embedding.sparse_opt import SparseOptimizer

        torch, sz, u64 = self.torch, self.sz, self.u64
        st, cfg = table.state, table.cfg
        dtype = st.values.dtype if dtype is None else dtype
        n = sz.train_batch * NUM_SPARSE
        q = torch.cat([resident[: n // 2], self.fresh_keys(n - n // 2)])
        q = q[torch.randperm(n, generator=self.gen, device=self.dev)]
        q[::97] = u64.EMPTY
        p = self.find_mod.probe_keys(cfg, q)
        valid = p.valid.clone()
        valid[::13] = False
        grads = torch.randn((n, dim), generator=self.gen, device=self.dev).to(dtype)
        # the rows a hit may touch: resident in either candidate bucket
        # (single mode touches a subset: those in bucket1)
        loc = self.find_mod.locate(st, cfg, q)
        rows = loc.row[loc.found & valid]
        hit1 = loc.found & (loc.bucket == p.bucket1)
        own = {st.values.shape[1]: st.values} if main else {}
        planes = dict(own)
        for opt_name in OPTIMIZERS:
            opt = SparseOptimizer(opt_name, lr=0.05)
            v = dim + opt.aux_dim(dim)
            if v not in planes:
                values = None   # one extra plane at a time: drop the last first
                planes = dict(own)
                self.free()
                planes[v] = torch.rand((st.values.shape[0], v), generator=self.gen,
                                       device=self.dev, dtype=dtype)
            values = planes[v]
            for mode in ("dual", "single"):
                b2 = p.bucket2 if mode == "dual" else p.bucket1
                args = (st.digests, st.keys, values, p.bucket1, b2, p.digest, q, valid, grads,
                        opt, dim)
                saved = values[rows].clone()
                before = self.checksum(values)
                fk = self.up.update_scan(*args)
                got = values[rows].clone()
                values[rows] = saved
                require(self.checksum(values) == before,
                        f"update_scan {opt_name} {mode} {tag}: a row outside the hits moved")
                fp = self.up.update_scan_plain(*args)
                want = values[rows].clone()
                values[rows] = saved
                self.check_equal("update_scan", (fk, got), (fp, want),
                                 f"{tag} {opt_name} {mode}")
                require(0 < int(fk.sum()) < n, "update_scan: no hits or no misses")
                t = self.time_ms(lambda: self.up.update_scan(*args), sz.timed_runs)
                values[rows] = saved
                self.record("update_scan", **{f"ms_{opt_name}_{mode}@{tag}": t})
                if opt_name != "rowwise_adagrad" or mode != "dual":
                    continue
                # config B's optimizer in dual mode: the main path's launch
                self.record("update_scan", **{
                    f"ms@{tag}": t,
                    f"ms_stream@{tag}": self.time_ms(lambda: self.up.update_scan(*args),
                                                     sz.timed_runs, calls=STREAM_CALLS),
                    f"plain_ms@{tag}": self.time_ms(lambda: self.up.update_scan_plain(*args), 2),
                    **self.update_work(st, p, q, valid, hit1, fk.bool(), values, dim, opt_name,
                                       tag)})
                values[rows] = saved
        del planes, values
        self.free()

    def update_work(self, st, p, q, valid, hit1, found, values, dim, opt_name, tag) -> dict:
        """Least bytes and operations of update_scan on these queries.
        Bytes: each lane's inputs (4-byte bucket indices, key, digest,
        gate) and found word; the digest line of every probed row (bucket2
        only after a miss in bucket1); the keys whose digest matched; and on
        a hit its gradient row and the value row read and written (in the
        plane's element size).  Operations: the digest compares and key
        equalities in int32, the optimizer's float operations on each hit
        row."""
        torch = self.torch
        n = q.shape[0]
        es, v = values.element_size(), values.shape[1]
        second = valid & ~hit1 & (p.bucket2 != p.bucket1)
        probed_b = torch.cat([p.bucket1[valid], p.bucket2[second]])
        probed_q = torch.cat([torch.nonzero(valid).flatten(), torch.nonzero(second).flatten()])
        cand = int((st.digests[probed_b] == p.digest[probed_q][:, None]).sum())
        rows = torch.unique(probed_b).numel()
        hits = int(found.sum())
        return {f"bytes@{tag}": (n * (4 + 4 + 8 + 1 + 1 + 4) + rows * 128 + cand * 8
                                 + hits * (dim * es + 2 * v * es)),
                f"ops@{tag}": probed_b.numel() * 128 // 4 + cand * OPS_U64_CMP,
                f"flops@{tag}": hits * dim * FLOPS_PER_COL[opt_name]}

    def compare_bucket_stats(self, table, lam):
        """bucket_stats against its plain version over the whole table, and
        one PyTorch yardstick: the masked minimum and the occupancy sum."""
        torch, u64 = self.torch, self.u64
        st = table.state
        b, s = st.keys.shape
        got = self.ss.bucket_stats(st.keys, st.scores)
        self.check_equal("bucket_stats", got, self.ss.bucket_stats_plain(st.keys, st.scores),
                         str(lam))

        def library():
            live = st.keys != u64.EMPTY
            return (torch.min(u64.flip(torch.where(live, st.scores, u64.U64_MAX)), dim=1),
                    live.sum(dim=1))

        runs = self.sz.timed_runs
        self.record("bucket_stats", **{
            f"ms@{lam}": self.time_ms(lambda: self.ss.bucket_stats(st.keys, st.scores), runs),
            f"plain_ms@{lam}": self.time_ms(
                lambda: self.ss.bucket_stats_plain(st.keys, st.scores), 2),
            f"library_ms@{lam}": self.time_ms(library, runs),
            # every key and score once, three words a bucket out; per slot a
            # liveness test and a minimum step, each a 64-bit compare
            f"bytes@{lam}": b * s * 16 + b * (4 + 8 + 4),
            f"ops@{lam}": b * s * 2 * OPS_U64_CMP})

    # phase 2 --------------------------------------------------------------

    def phase_paths(self):
        from repro_torch import HKVTable

        torch, sz = self.torch, self.sz
        for policy in ("lru", "lfu"):
            kw = dict(capacity=sz.small_capacity, dim=DIM, buckets_per_key=2,
                      score_policy=policy, device=self.dev)
            tk = HKVTable.create(backend="auto", **kw)
            tp = HKVTable.create(backend="plain", **kw)
            n = sz.small_batch
            space = self.fresh_keys(2 * sz.small_capacity)
            seen = set()
            for step in range(3 * sz.small_capacity // n // 2 + 8):
                keys = space[torch.randint(0, space.numel(), (n,), generator=self.gen,
                                           device=self.dev)]
                keys[::61] = self.u64.EMPTY
                if step % 4 == 3:   # a burst aimed at one bucket
                    keys[: sz.hot_keys] = self.hot_bucket_keys(tk.cfg.num_buckets, sz.hot_keys, step)
                vals = self.values(n)
                sk = tk.insert_or_assign(keys, vals).status
                sp = tp.insert_or_assign(keys, vals).status
                self.assert_same(sk, sp, f"{policy} step {step} status")
                fk, fp = tk.find(keys), tp.find(keys)
                for name in ("values", "found", "scores"):
                    self.assert_same(getattr(fk, name), getattr(fp, name), f"{policy} step {step} find.{name}")
                for name in ("keys", "digests", "scores", "values"):
                    self.assert_same(getattr(tk.state, name), getattr(tp.state, name),
                                     f"{policy} step {step} state.{name}")
                require((tk.state.clock, tk.state.epoch) == (tp.state.clock, tp.state.epoch),
                        f"{policy} step {step}: clocks differ")
                seen.update(torch.unique(sk).tolist())
            log(f"phase 2 {policy}: {step + 1} ops, λ = {tk.load_factor():.4f}, statuses seen "
                f"{sorted(STATUS_NAMES[i] for i in seen)}")
            require({3, 4} <= seen, "phase 2 did not reach eviction and rejection")
            del tk, tp
        for buckets_per_key in (1, 2):
            for policy in ("lru", "custom"):
                self.replay_every_op(buckets_per_key, policy)
        for opt_name in ("rowwise_adagrad", "sgdm"):
            self.replay_update_rows(opt_name)

    def assert_same(self, a, b, ctx):
        """Equal tensors; an 'hmem' plane (on the host) is compared with its
        twin's plane brought to the host."""
        require(self.torch.equal(a, b.to(a.device)), f"the two paths differ: {ctx}")

    def replay_every_op(self, buckets_per_key: int, policy: str, twin: bool = False,
                        dim: int = DIM, aux: int = 0):
        """Every op of the public HKVTable on 'auto' (the kernels) and
        'plain', on a reduced table; every result and the full state are
        compared after every op.  With `twin`: an 'hmem' table on 'auto'
        against an 'hbm' table on 'auto' (phase 6)."""
        from repro_torch import HKVTable
        from repro_torch.core import ops

        torch, sz, u64 = self.torch, self.sz, self.u64
        kw = dict(capacity=sz.small_capacity, dim=dim, buckets_per_key=buckets_per_key,
                  score_policy=policy, aux_value_dim=aux, device=self.dev)
        backend_p = "auto" if twin else "plain"
        tk = HKVTable.create(backend="auto", value_tier="hmem" if twin else "hbm", **kw)
        tp = HKVTable.create(backend=backend_p, **kw)
        n = sz.small_batch
        space = self.fresh_keys(2 * sz.small_capacity)
        tag = (f"{'dual' if buckets_per_key == 2 else 'single'} {policy}"
               + (" hmem vs hbm" if twin else ""))

        def batch(unique=False):
            if unique:
                keys = space[torch.randperm(space.numel(), generator=self.gen,
                                            device=self.dev)[:n]]
            else:
                keys = space[torch.randint(0, space.numel(), (n,), generator=self.gen,
                                           device=self.dev)]
            keys[::61] = u64.EMPTY
            return keys

        def custom():
            if policy != "custom":
                return None
            return torch.randint(0, 2**40, (n,), generator=self.gen, device=self.dev)

        def same(a, b, ctx):
            if isinstance(a, torch.Tensor):
                self.assert_same(a, b, ctx)
            elif isinstance(a, tuple):   # a result, a stream, a locate
                for i, (x, y) in enumerate(zip(a, b)):
                    same(x, y, f"{ctx}[{i}]")

        def state(ctx):
            for name in ("keys", "digests", "scores", "values"):
                self.assert_same(getattr(tk.state, name), getattr(tp.state, name),
                                 f"{tag} {ctx} state.{name}")
            require((tk.state.clock, tk.state.epoch) == (tp.state.clock, tp.state.epoch),
                    f"{tag} {ctx}: clocks differ")

        def both(name, *args, **kwargs):
            a = getattr(tk, name)(*args, **kwargs)
            b = getattr(tp, name)(*args, **kwargs)
            same(a, b, f"{tag} {name}")
            state(name)
            return a

        seen = set()
        for step in range(sz.replay_steps):
            keys, vals = batch(), self.values(n, dim)
            if step % 3 == 2:   # a burst aimed at one bucket
                keys[: sz.hot_keys] = self.hot_bucket_keys(tk.cfg.num_buckets, sz.hot_keys, step)
            r = both("insert_and_evict", keys, vals, custom())
            seen.update(torch.unique(r.status).tolist())
            both("insert_or_assign", batch(), self.values(n, dim), custom())
            mix = torch.cat([keys[: n // 2], batch()[n // 2:]])
            both("find_or_insert", mix, self.values(n, dim), custom(),
                 return_evicted=step % 2 == 0)
            both("ingest", batch(), self.values(n, dim), custom())
            for name in ("find", "find_rows", "find_ptr", "contains"):
                both(name, mix)
            loc = tp.find_ptr(mix)
            for fn in (ops.find, ops.find_rows):   # at a caller's locate: gather_rows
                same(tuple(fn(tk.state, tk.cfg, mix, loc, backend="auto")),
                     tuple(fn(tp.state, tp.cfg, mix, loc, backend=backend_p)),
                     f"{tag} {fn.__name__}(loc)")
            both("assign", mix, self.values(n, dim), update_scores=policy != "custom")
            u = batch(unique=True)
            both("assign_add", u, self.values(n, dim))
            both("assign_scores", mix, torch.randint(0, 2**40, (n,), generator=self.gen,
                                                     device=self.dev))
            both("accum_or_assign", u, self.values(n, dim), custom())
            both("erase", batch()[: n // 8])
            both("export_batch", 0, tk.num_buckets)
            if step % 4 == 3:
                r = both("erase_if", self.Pred.key_in_range(0, 2**59))
                require(int(r.swept) > 0, f"{tag}: erase_if swept nothing")
                r = both("evict_if", self.Pred.always(), n // 4)
                require(int(r.count) == n // 4, f"{tag}: evict_if count")
        # duplicates' float sums: atomics on the card, held at a tolerance;
        # this is the replay's last op, so the exact checks above stand
        d = batch()
        d[n // 2:] = d[: n // 2]
        vals, cs = self.values(n, dim), custom()
        sk = tk.accum_or_assign(d, vals, cs).status
        sp = tp.accum_or_assign(d, vals, cs).status
        self.assert_same(sk, sp, f"{tag} accum_or_assign with duplicates: status")
        tk.assign_add(d, vals)
        tp.assign_add(d, vals)
        for name in ("keys", "digests", "scores"):
            self.assert_same(getattr(tk.state, name), getattr(tp.state, name), f"{tag} dup {name}")
        err = (tk.state.values - tp.state.values.to(tk.state.values.device)).abs().max().item()
        require(err <= DUP_SUM_ATOL, f"{tag}: duplicate sums differ by {err}")
        log(f"phase {6 if twin else 2} replay {tag}: {sz.replay_steps} steps of every op, λ = "
            f"{tk.load_factor():.4f}, insert_and_evict statuses "
            f"{sorted(STATUS_NAMES[i] for i in seen)}; duplicate sums within {err:.3g}")
        require({3} <= seen, f"{tag}: the replay never evicted")
        del tk, tp

    def replay_update_rows(self, opt_name: str, twin: bool = False, dim: int = DIM):
        """update_rows on 'auto' (update_scan, or gather_rows at a shared
        locate) and 'plain', on a reduced dual-bucket table with aux
        columns: fused through ops.update_rows, composed through
        update_composed_kernel, and through an OpSession (a RowUpdate alone,
        and one sharing a contains' locate).  Found and the full state are
        equal after every update.  With `twin`: an 'hmem' table on 'auto'
        (the composed step) against an 'hbm' one on 'auto' (update_scan)."""
        from repro_torch import HKVTable, RowUpdate
        from repro_torch.core import ops
        from repro_torch.embedding.sparse_opt import SparseOptimizer
        from repro_torch.kernels import ops as kops

        torch, sz, u64 = self.torch, self.sz, self.u64
        opt = SparseOptimizer(opt_name, lr=0.05)
        kw = dict(capacity=sz.small_capacity, dim=dim, buckets_per_key=2,
                  aux_value_dim=opt.aux_dim(dim), device=self.dev)
        backend_p = "auto" if twin else "plain"
        tk = HKVTable.create(backend="auto", value_tier="hmem" if twin else "hbm", **kw)
        tp = HKVTable.create(backend=backend_p, **kw)
        n = sz.small_batch
        space = self.fresh_keys(2 * sz.small_capacity)
        for i in range(0, space.numel(), n):   # past λ 1.0
            keys = space[i:i + n]
            vals = torch.rand((keys.numel(), dim), generator=self.gen, device=self.dev)
            self.assert_same(tk.insert_or_assign(keys, vals).status,
                             tp.insert_or_assign(keys, vals).status, f"{opt_name} fill")

        def state(ctx):
            for name in ("keys", "digests", "scores", "values"):
                self.assert_same(getattr(tk.state, name), getattr(tp.state, name),
                                 f"update_rows {opt_name} {ctx} state.{name}")

        def unique_batch():
            keys = space[torch.randperm(space.numel(), generator=self.gen, device=self.dev)[:n]]
            keys[::61] = u64.EMPTY
            return keys

        trained = 0
        for step in range(sz.replay_steps // 2):
            u, g = unique_batch(), torch.randn((n, dim), generator=self.gen, device=self.dev)
            fk = ops.update_rows(tk.state, tk.cfg, u, g, opt).found
            fp = ops.update_rows(tp.state, tp.cfg, u, g, opt, backend=backend_p).found
            self.assert_same(fk, fp, f"update_rows {opt_name} fused found")
            state(f"step {step} fused")
            trained += int(fk.sum())
            u, g = unique_batch(), torch.randn((n, dim), generator=self.gen, device=self.dev)
            fk = kops.update_composed_kernel(tk.state, tk.cfg, u, g, opt).found
            fp = ops.update_rows(tp.state, tp.cfg, u, g, opt, backend=backend_p).found
            self.assert_same(fk, fp, f"update_rows {opt_name} composed found")
            state(f"step {step} composed")
            for shared in (False, True):
                u, g = unique_batch(), torch.randn((n, dim), generator=self.gen, device=self.dev)
                refs = []
                for t in (tk, tp):
                    sess = t.session()
                    if shared:
                        sess.contains(u)
                    refs.append(sess.update_rows(u, RowUpdate(opt, g)))
                    require(sess.commit() is t, "OpSession.commit returned another handle")
                self.assert_same(refs[0].get().found, refs[1].get().found,
                                 f"update_rows {opt_name} session found")
                state(f"step {step} session{' shared' if shared else ''}")
        require(trained > 0, f"update_rows {opt_name}: nothing trained")
        log(f"phase {6 if twin else 2} update_rows {opt_name}"
            + (" ('hmem' vs 'hbm', both 'auto')" if twin else "")
            + f": {sz.replay_steps // 2} rounds of fused, composed and session updates equal on "
            f"both; {trained} rows trained by the fused path, λ = {tk.load_factor():.4f}")
        del tk, tp

    # phase 3 --------------------------------------------------------------

    def phase_main(self):
        torch, sz = self.torch, self.sz
        self._build.reset_counts()
        table = self.config_b()
        n = sz.batch
        log(f"phase 3: config B table, capacity {table.capacity}, dim {table.dim}, "
            f"dual bucket, lru, on {table.device}")
        self.throughput = {}
        for lam in (0.5, 1.0):
            keys, vals, status = self.fill(table, lam)
            self.check_find(table, keys, vals, status, f"λ={lam}")
            lam0 = table.load_factor()
            t_find = self.time_ms(lambda: table.find(keys), sz.timed_runs)
            ins = [self.timed_insert(table) for _ in range(sz.timed_runs)]
            t_ins = statistics.median(ins)
            self.throughput[lam] = (n / t_find / 1e6, n / t_ins / 1e6)
            self.unsharded.update(find=t_find, insert_or_assign=t_ins)
            log(f"phase 3: λ = {lam0:.6f}: find {t_find:.3f} ms ({n / t_find / 1e6:.4f} B-KV/s); "
                f"insert_or_assign of fresh keys from λ {lam0:.6f} to {table.load_factor():.6f}: "
                f"{t_ins:.3f} ms ({n / t_ins / 1e6:.4f} B-KV/s); median of {sz.timed_runs}, batch {n}")
            self.breakdown(table, keys, lam)
        counts = torch.zeros(5, dtype=torch.int64)
        for i in range(3):   # past λ = 1.0, with a burst at one bucket
            keys = self.fresh_keys(n)
            keys[: sz.hot_keys] = self.hot_bucket_keys(table.cfg.num_buckets, sz.hot_keys, 12345 + i)
            vals = self.values(n)
            status = table.insert_or_assign(keys, vals).status
            counts += torch.bincount(status.long().cpu(), minlength=5)
            self.check_find(table, keys, vals, status, f"past λ=1 batch {i}")
        log("phase 3: past λ = 1.0: " + ", ".join(f"{STATUS_NAMES[i]} {int(c)}"
                                                   for i, c in enumerate(counts)))
        require(counts[3] > 0 and counts[4] > 0, "no EVICTED or no REJECTED past λ = 1.0")
        self.sync()
        self.launches = dict(self._build.launch_counts)
        log(f"phase 3: kernel launches on the main path: {json.dumps(self.launches)}")
        if self.dev.type == "cuda":
            missing = [k for k in ("find_scan", "upsert_probe", "claim_scan", "scatter_rows")
                       if self.launches.get(k, 0) == 0]
            require(not missing, f"main path never launched {missing}")
        self.time_claim_main(table)
        del table

    def time_claim_main(self, table):
        """claim_scan on the buckets and ranks that the λ 1.0 breakdown's
        insert_or_assign of fresh keys gave its victim stage, against the
        plain version and timed, on the table as it is now (the same rows).
        Run after the main path's launch counts are read."""
        torch = self.torch
        st, s = table.state, table.cfg.slots_per_bucket
        buckets, rank = self.claim_main
        m = buckets.numel()
        args = (st.keys, st.scores, buckets, rank)
        self.check_equal("claim_scan", self.us.claim_scan(*args),
                         self.us.claim_scan_plain(*args), "λ=1.0 insert's own ranks")
        rows = torch.unique(buckets).numel()
        hist = torch.bincount(rank.clamp(0, 4), minlength=5).tolist()
        self.record("claim_scan", **{
            "ms_main@1.0": self.time_ms(lambda: self.us.claim_scan(*args), self.sz.timed_runs),
            "bytes_main@1.0": rows * 16 * s + m * (4 + 4) + m * 24,
            "ops_main@1.0": m * (s - 1) * OPS_VICTIM_CMP,
            "lanes_main@1.0": m, "rank_hist_main@1.0": hist})

    def mark(self):
        """A timestamp taken in stream order (a CUDA event on the card)."""
        if self.dev.type == "cuda":
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.dev.type == "cuda" else (b - a) * 1e3

    def breakdown(self, table, find_keys, lam):
        """Where one insert_or_assign of fresh keys spends its time: each
        kernel stage between two stream timestamps, the rest (hashing,
        sorts, metadata scatters, host syncs of boolean indexing) as the
        orchestration.  And the share of find's time in key hashing."""
        from repro_torch.core import merge, ops
        from repro_torch.kernels import ops as kops

        torch = self.torch
        spans, gates = [], []

        def timed(name, fn):
            def run(*args):
                if name == "victim_at_rank" and lam == 1.0:   # (buckets, rank) of the misses
                    self.claim_main = (args[2].clone(), args[3].clone())
                if name == "select_target":   # the target pass's lane gate
                    gates.append(args[3])
                a = self.mark()
                out = fn(*args)
                spans.append((name, a, self.mark()))
                return out
            return run

        base = kops.kernel_stages(table.cfg, table.device)
        stages = merge.UpsertStages(*(timed(f, getattr(base, f)) for f in base._fields))
        n = self.sz.batch
        keys, vals = self.fresh_keys(n), ops._pad_aux(self.values(n), table.state)
        self.sync()
        a = self.mark()
        merge.upsert(table.state, table.cfg, keys, vals, stages=stages)
        b = self.mark()
        self.sync()
        total = self.elapsed_ms(a, b)
        per = {}
        for name, x, y in spans:
            per[name] = per.get(name, 0.0) + self.elapsed_ms(x, y)
        rest = total - sum(per.values())
        label = {"locate": "locate (upsert_probe match pass)",
                 "select_target": f"select_target (upsert_probe target pass on "
                                  f"{int(gates[0].sum())} miss lanes of {n})"}
        log(f"phase 3: λ={lam} insert_or_assign breakdown: total {total:.3f} ms; "
            + "; ".join(f"{label.get(k, k)} {v:.3f} ms" for k, v in per.items())
            + f"; orchestration {rest:.3f} ms")
        # the closure's host read of its miss count: a sum over the batch's
        # lanes and the copy to the host, host clock, on an idle stream
        miss = torch.rand(n, generator=self.gen, device=self.dev) < 0.5
        int(miss.sum())
        self.sync()
        t0 = time.perf_counter()
        for _ in range(20):
            int(miss.sum())
        t_read = (time.perf_counter() - t0) / 20 * 1e3
        log(f"phase 3: λ={lam} host read of the miss count (sum of {n} lanes, copy to the "
            f"host): {t_read:.4f} ms, mean of 20 on an idle stream")
        t_probe = self.time_ms(lambda: self.find_mod.probe_keys(table.cfg, find_keys), 3)
        log(f"phase 3: λ={lam} find: key hashing (probe_keys) {t_probe:.3f} ms of the op")

    def timed_insert(self, table) -> float:
        keys, vals = self.fresh_keys(self.sz.batch), self.values(self.sz.batch)
        return self.time_ms(lambda: table.insert_or_assign(keys, vals), 1, warmup=0)

    def check_find(self, table, keys, vals, status, ctx):
        """The batch just inserted: its admitted keys are found with their
        values; a mix with never-inserted keys finds exactly those."""
        torch = self.torch
        ok = (status >= 1) & (status <= 3)
        require(bool(ok.any()), f"{ctx}: nothing admitted")
        fresh = self.fresh_keys(keys.numel() // 2)
        mix = torch.cat([keys[: keys.numel() // 2], fresh])
        r = table.find(mix)
        half = keys.numel() // 2
        require(r.values.shape == (mix.numel(), table.dim) and bool(torch.isfinite(r.values).all()),
                f"{ctx}: find values of the wrong shape or not finite")
        require(torch.equal(r.found[:half], ok[:half]), f"{ctx}: found disagrees with the statuses")
        require(not bool(r.found[half:].any()), f"{ctx}: a never-inserted key was found")
        require(torch.equal(r.values[:half][ok[:half]], vals[:half][ok[:half]]), f"{ctx}: values")
        require(not bool(r.values[half:].any()), f"{ctx}: a miss returned a nonzero row")

    # phase 4 --------------------------------------------------------------

    def op(self, table, name, *args, routes=ROUTES, **kwargs):
        """One public op on `table`, its launches checked against `routes`."""
        counts = self._build.launch_counts
        before = dict(counts)
        out = getattr(table, name)(*args, **kwargs)
        self.sync()
        got = {k: v - before.get(k, 0) for k, v in counts.items() if v != before.get(k, 0)}
        mode = table.cfg.buckets_per_key
        self.op_launches[f"{name} ({'dual' if mode == 2 else 'single'})"] = got
        want = routes[name][mode]
        if "claim_scan" in want:
            want = self.route(want, self.has_miss(out.status))
        if self.dev.type == "cuda":
            require(got == want, f"{name}: launches {got}, the routing table says {want}")
        return out

    def time_op(self, table, name, inputs, label: str = "") -> float:
        """Median over `inputs` of one timed call each (stream timestamps)."""
        lam = table.load_factor()
        times = []
        for args in inputs:
            self.sync()
            a = self.mark()
            getattr(table, name)(*args)
            b = self.mark()
            self.sync()
            times.append(self.elapsed_ms(a, b))
        t = statistics.median(times)
        mode = ("dual" if table.cfg.buckets_per_key == 2 else "single") + label
        self.op_times.append((name, mode, lam, t))
        if mode == "dual":
            self.unsharded[name] = t
        return t

    def phase_rest(self):
        torch, sz = self.torch, self.sz
        n, runs = sz.batch, sz.timed_runs
        self.free()
        self._build.reset_counts()
        self.op_times, self.op_launches = [], {}

        # single bucket (the HKVConfig default): insert_or_assign, find,
        # find_ptr, contains
        table = self.config_b(buckets_per_key=1)
        log(f"phase 4: config B table, capacity {table.capacity}, dim {table.dim}, "
            f"single bucket, lru, on {table.device}")
        for lam in (0.5, 1.0):
            keys, vals, status = self.fill(table, lam)
            self.check_find(table, keys, vals, status, f"single λ={lam}")
            self.check_pointers(table, keys, status, f"single λ={lam}")
            for name in ("find", "find_ptr", "contains"):
                self.time_op(table, name, [(keys,)] * runs)
            self.op(table, "insert_or_assign", self.fresh_keys(n), self.values(n))
            self.time_op(table, "insert_or_assign",
                         [(self.fresh_keys(n), self.values(n)) for _ in range(runs)])
        counts = torch.zeros(5, dtype=torch.int64)
        for i in range(3):   # past λ = 1.0, with a burst at one bucket
            keys = self.fresh_keys(n)
            keys[: sz.hot_keys] = self.hot_bucket_keys(table.cfg.num_buckets, sz.hot_keys, 777 + i)
            vals = self.values(n)
            status = self.op(table, "insert_or_assign", keys, vals).status
            counts += torch.bincount(status.long().cpu(), minlength=5)
            self.check_find(table, keys, vals, status, f"single past λ=1 batch {i}")
            self.check_pointers(table, keys, status, f"single past λ=1 batch {i}")
        log("phase 4: single bucket past λ = 1.0: " + ", ".join(
            f"{STATUS_NAMES[i]} {int(c)}" for i, c in enumerate(counts)))
        require(counts[3] > 0 and counts[4] > 0, "single bucket: no EVICTED or no REJECTED")
        del table
        self.free()

        # dual bucket past λ 1.0: insert_and_evict, find_or_insert,
        # erase_if, evict_if
        table = self.config_b()
        self.fill(table, 1.0)
        log(f"phase 4: dual-bucket table at λ = {table.load_factor():.6f}")
        keys, vals = self.fresh_keys(n), self.values(n)
        r = self.op(table, "insert_and_evict", keys, vals)
        self.check_stream(table, keys, r)
        self.time_op(table, "insert_and_evict",
                     [(self.fresh_keys(n), self.values(n)) for _ in range(runs)])

        ok = (r.status >= 1) & (r.status <= 3)
        resident = keys[ok][: n // 2]
        mix = torch.cat([resident, self.fresh_keys(n - resident.numel())])
        self.check_pointers(table, keys, r.status, "dual λ=1.0")
        for name in ("find_ptr", "contains"):   # one digest_scan over both rows
            self.op(table, name, mix)
            self.time_op(table, name, [(mix,)] * runs)
        init = self.values(n)
        f = self.op(table, "find_or_insert", mix, init)
        h = resident.numel()
        require(bool(f.found[:h].all()) and not bool(f.found[h:].any()),
                "find_or_insert: found is not the keys resident before the op")
        require(torch.equal(f.values[:h], vals[ok][: n // 2]), "find_or_insert: hit values")
        require(torch.equal(f.values[h:], init[h:]), "find_or_insert: miss values")
        require(bool((f.status[:h] == 1).all()), "find_or_insert: hit statuses")
        self.time_op(table, "find_or_insert", [
            (torch.cat([resident[: n // 4], self.fresh_keys(n - n // 4)]), self.values(n))
            for _ in range(runs)])

        known = resident
        require(bool(table.contains(known).all()), "erase_if: the known keys are not resident")
        size0 = table.size()
        e = self.op(table, "erase_if", self.Pred.key_in_range(0, 2**60))
        gone = known < 2**60
        got = table.find(known).found
        require(torch.equal(got, ~gone), "erase_if: find does not miss exactly the erased keys")
        require(int(e.swept) == size0 - table.size() and int(e.swept) > 0,
                "erase_if: swept count")
        log(f"phase 4: erase_if(key_in_range(0, 2^60)) swept {int(e.swept)} of {size0}")
        self.time_op(table, "erase_if", [(self.Pred.key_in_range(2**60 + i * 2**54,
                                                                 2**60 + (i + 1) * 2**54),)
                                         for i in range(runs)])

        size0 = table.size()
        budget = n
        v = self.op(table, "evict_if", self.Pred.always(), budget)
        self.check_evict_if(table, v, budget, size0)
        self.time_op(table, "evict_if", [(self.Pred.always(), budget)] * runs)

        self.sync()
        self.launches_rest = dict(self._build.launch_counts)
        log(f"phase 4: kernel launches: {json.dumps(self.launches_rest)}")
        log(f"phase 4: launches per op: {json.dumps(self.op_launches)}")
        if self.dev.type == "cuda":
            missing = [k for k in ("gather_rows", "digest_scan", "sweep_match")
                       if self.launches_rest.get(k, 0) == 0]
            require(not missing, f"phase 4 never launched {missing}")
        del table
        self.free()

    def check_pointers(self, table, keys, status, ctx):
        """find_ptr and contains on the batch just inserted and on fresh
        keys: admitted keys are found where the key plane holds them."""
        torch = self.torch
        ok = (status >= 1) & (status <= 3)
        fresh = self.fresh_keys(keys.numel() // 4)
        q = torch.cat([keys, fresh])
        loc = table.find_ptr(q)
        want = torch.cat([ok, torch.zeros_like(fresh, dtype=torch.bool)])
        require(torch.equal(loc.found, want), f"{ctx}: find_ptr.found")
        require(torch.equal(table.state.keys.view(-1)[loc.row[loc.found]], q[loc.found]),
                f"{ctx}: find_ptr rows do not hold their keys")
        require(torch.equal(table.contains(q), want), f"{ctx}: contains")

    def check_stream(self, table, keys, r):
        """insert_and_evict: the EVICTED lanes carry the displaced keys,
        which are gone; the admitted keys are found."""
        torch, u64 = self.torch, self.u64
        ev = r.evicted
        require(torch.equal(ev.mask, r.status == 3), "insert_and_evict: stream mask")
        require(int(ev.count()) > 0, "insert_and_evict: nothing evicted past λ 1.0")
        out = ev.keys[ev.mask]
        require(not bool(table.contains(out).any()), "insert_and_evict: a displaced key is found")
        require(bool((out != u64.EMPTY).all()) and not bool(torch.isin(out, keys).any()),
                "insert_and_evict: a displaced key is not an old resident")
        require(not bool(ev.keys[~ev.mask].any()) and not bool(ev.values[~ev.mask].any()),
                "insert_and_evict: a non-evicting lane is not zeros")
        ok = (r.status >= 1) & (r.status <= 3)
        require(bool(table.contains(keys[ok]).all()), "insert_and_evict: an admitted key is missing")
        log(f"phase 4: insert_and_evict past λ 1.0: {int(ev.count())} evicted of {keys.numel()}")

    def check_evict_if(self, table, v, budget, size0):
        """evict_if(always): `budget` entries, coldest first, gone; every
        entry left is at least as hot as the hottest evicted."""
        torch, u64 = self.torch, self.u64
        ev = v.evicted
        require(int(v.count) == min(budget, size0) and bool(ev.mask.all()), "evict_if: count")
        f = u64.flip(ev.scores)
        require(bool((f[1:] >= f[:-1]).all()), "evict_if: not coldest first")
        require(table.size() == size0 - int(v.count), "evict_if: size")
        require(not bool(table.contains(ev.keys).any()), "evict_if: an evicted key is found")
        live = table.state.keys != u64.EMPTY
        require(bool((u64.flip(table.state.scores[live]).min() >= f[-1])),
                "evict_if: an entry left is colder than an evicted one")
        log(f"phase 4: evict_if(always, budget={budget}) evicted {int(v.count)}, scores "
            f"{int(ev.scores[0])}..{int(ev.scores[-1])}")

    # phase 5 --------------------------------------------------------------

    def train_batch(self, rng, batch: int):
        """One DLRM batch as examples/dlrm_continuous.py makes it: per field
        Zipfian ids (α 0.99 over 10^6 ranks) salted by the field, masked to
        31 bits; dense features N(0, 1); click labels 0/1."""
        import numpy as np

        from repro_torch.data import zipf_keys

        torch = self.torch
        field_keys = np.stack([zipf_keys(rng, batch, 0.99, 10**6) ^ np.uint64(f << 56)
                               for f in range(NUM_SPARSE)], axis=1)
        toks = torch.from_numpy((field_keys & np.uint64(0x7FFFFFFF)).astype(np.int64))
        dense_x = torch.from_numpy(rng.normal(size=(batch, DENSE_FEATURES)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 2, size=batch).astype(np.float32))
        return toks.to(self.dev), dense_x.to(self.dev), labels.to(self.dev)

    def counted(self, name, fn, *args, has_miss: bool = True, routes=TRAIN_ROUTES,
                launches=None, tiered: bool = False):
        """One entry point, its launches counted from 0 and checked against
        `routes` (on the card; claim_scan only where the batch has a miss
        lane, or on a tiered table per `tiered_route`), and its time between
        stream marks; the launches are added to `launches` (phase 5's count
        by default)."""
        self._build.reset_counts()
        self.sync()
        a = self.mark()
        out = fn(*args)
        b = self.mark()
        self.sync()
        got = dict(self._build.launch_counts)
        launches = self.launches_train if launches is None else launches
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if self.dev.type == "cuda":
            want = routes[name]
            if tiered and name == "lookup_train":
                want = self.tiered_route(got, has_miss)
            elif "claim_scan" in want:
                want = self.route(want, has_miss)
            require(got == want, f"{name}: launches {got}, the route is {want}")
        return out, self.elapsed_ms(a, b)

    @staticmethod
    def tiered_route(got, hot_miss: bool) -> dict:
        """The tiered lookup_train's launches: TIERED_ROUTES's, with
        claim_scan once if the hot tier had a miss lane and at most once
        more for the demotion's upsert into the cold tier, whose miss lanes
        only that upsert knows."""
        want = dict(TIERED_ROUTES["lookup_train"])
        claims = got.get("claim_scan", 0)
        require(claims - int(hot_miss) in (0, 1),
                f"tiered lookup_train: claim_scan launched {claims} times, the hot tier had "
                f"{'a' if hot_miss else 'no'} miss lane")
        if claims:
            want["claim_scan"] = claims
        return want

    def dlrm_step(self, emb, table, model, toks, dense_x, labels, misses: int,
                  routes=TRAIN_ROUTES, launches=None, tiered: bool = False):
        """lookup_train, forward and backward with the dense update,
        apply_grads; returns (loss, ms of each part, the embedding grads).
        `misses`: the batch's distinct keys not resident before the step,
        which lookup_train's victim stage must get, and nothing else (on a
        flat table; a tiered one's stages also run for its cold tier)."""
        with self.stage_lanes() as lanes:
            (table, rows), t_lookup = self.counted(
                "lookup_train", emb.lookup_train, table, toks, has_miss=misses > 0,
                routes=routes, launches=launches, tiered=tiered)
        if not tiered:
            require(lanes["victim"] == ([misses] if misses else []),
                    f"lookup_train: the victim stage got {lanes['victim']} lanes, the batch "
                    f"has {misses} misses")
            target = [int(g.sum()) for g in lanes["target"]]
            require(target == [misses], f"lookup_train: the target pass got {target} lanes, "
                    f"the batch has {misses} misses")
        self.sync()
        a = self.mark()
        rows = rows.detach().requires_grad_(True)
        loss = model.loss(rows, dense_x, labels)
        loss.backward()
        model.sgd_(TRAIN_LR)
        b = self.mark()
        self.sync()
        grads = rows.grad
        _, t_apply = self.counted("apply_grads", emb.apply_grads, table, toks, grads,
                                  routes=routes, launches=launches)
        return loss.detach(), {"lookup_train": t_lookup, "forward+backward": self.elapsed_ms(a, b),
                               "apply_grads": t_apply}, grads

    def train_loop(self, emb, table, dim: int, tag: str, routes=TRAIN_ROUTES, launches=None,
                   tiered: bool = False, after_step=None):
        """The DLRM steps of phases 5-7 on `table`: each step's batch, its
        misses (distinct keys not resident before it), dlrm_step, a log line
        and `after_step(step)`; the launches go to `launches` (phase 5's by
        default) and are logged.  Returns (losses, the last step's unique
        keys and summed gradients, and their count)."""
        import numpy as np

        from repro_torch.models.dlrm import DLRM

        torch, sz = self.torch, self.sz
        launches = self.launches_train if launches is None else launches
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        model = DLRM(dim, NUM_SPARSE, DENSE_FEATURES, device=self.dev, generator=gen)
        rng = np.random.default_rng(SEED)
        losses = []
        for step in range(sz.train_steps):
            toks, dense_x, labels = self.train_batch(rng, sz.train_batch)
            keys = emb.keys_of(toks)
            hit = (table.hot if tiered else table).contains(keys)
            found = int(hit.sum())
            misses = torch.unique(keys[~hit & (keys != self.u64.EMPTY)]).numel()
            loss, ms, grads = self.dlrm_step(emb, table, model, toks, dense_x, labels, misses,
                                             routes=routes, launches=launches, tiered=tiered)
            if tag == "phase 5" and step > 0:     # phase 10's unsharded step times
                for k in ("lookup_train", "apply_grads"):
                    self.unsharded.setdefault(f"{k} steps", []).append(ms[k])
            require(bool(torch.isfinite(loss)), f"{tag} step {step}: loss is not finite")
            losses.append(float(loss))
            uniq, g_sum = emb.sum_grads(toks, grads)
            t_sum = self.time_ms(lambda: emb.sum_grads(toks, grads), 1)
            trained = int((table.hot if tiered else table).contains(uniq).sum())
            n_uniq = int((uniq != self.u64.EMPTY).sum())
            require(0 < trained <= n_uniq, f"{tag} step {step}: {trained} rows trained")
            log(f"{tag} step {step}: {toks.numel()} keys ({n_uniq} unique, {found} found "
                f"{'in the hot tier ' if tiered else ''}before the step, {trained} trained; "
                f"{misses} distinct misses"
                + ("" if tiered else ", the lanes the upsert_probe target pass and claim_scan got")
                + f"); lookup_train {ms['lookup_train']:.3f} ms, "
                f"forward+backward {ms['forward+backward']:.3f} ms, apply_grads "
                f"{ms['apply_grads']:.3f} ms (dedupe+segment-sum {t_sum:.3f} ms timed alone, "
                f"the rest {ms['apply_grads'] - t_sum:.3f} ms); loss {float(loss):.6f}"
                + ("" if tiered else f"; λ {table.load_factor():.6f}"))
            if after_step is not None:
                after_step(step)
        log(f"{tag}: kernel launches over {sz.train_steps} steps: {json.dumps(launches)}")
        return losses, uniq, g_sum, n_uniq

    def phase_train(self):
        """The training path at config B, full width (see the module note)."""
        from repro_torch.configs.hkv_dlrm import PAPER_CONFIGS
        from repro_torch.kernels import ops as kops

        sz = self.sz
        self.free()
        self.launches_train = {}
        cfg = PAPER_CONFIGS["B"]
        emb = dataclasses.replace(cfg.embedding(), capacity=sz.capacity)
        table = emb.create(device=self.dev)
        require(table.state.values.shape == (sz.capacity, DIM + 1) and cfg.dim == DIM,
                 "config B's table is not [capacity, 33]")
        resident = self.fill(table, 1.0)[0]
        log(f"phase 5: HKVEmbedding of config B: capacity {table.capacity}, dim {emb.dim}, "
            f"{emb.optimizer.name} (V = {table.state.values.shape[1]}), dual bucket, "
            f"{emb.score_policy}; prefilled to λ = {table.load_factor():.6f}")
        losses, uniq, g_sum, n_uniq = self.train_loop(emb, table, DIM, "phase 5")
        if self.dev.type == "cuda":
            require(self.launches_train.get("update_scan") == sz.train_steps,
                    "phase 5: apply_grads did not run one update_scan a step")
        # exp9's comparison on the last step's gradients: the fused step (one
        # update_scan) against the composed one; both train the same rows
        opt, tcfg = emb.optimizer, table.cfg
        for name, fn, route in (
                ("fused", kops.update_rows_kernel, {"update_scan": 1}),
                ("composed", kops.update_composed_kernel,
                 {"digest_scan": 1, "gather_rows": 1, "scatter_rows": 1})):
            self._build.reset_counts()
            fn(table.state, tcfg, uniq, g_sum, opt)
            self.sync()
            if self.dev.type == "cuda":
                require(dict(self._build.launch_counts) == route, f"{name} update: launches")
            t = self.time_ms(lambda: fn(table.state, tcfg, uniq, g_sum, opt), sz.timed_runs)
            self.train_cmp[name] = t
            log(f"phase 5: {name} gradient step on the last batch's {n_uniq} unique keys: "
                f"{t:.3f} ms, launches {json.dumps(route)}")
        self.compare_scatter(table.state.values, "V=33 phase 5 plane", "_v33@1.0")
        self.compare_find_wide(table, resident)
        # lookup_train's readback: the 32 embedding columns of the V = 33 rows
        self.compare_gather(table.state.values, "1.0 V=33 width 32", width=DIM)
        self.compare_gather(table.state.values, "1.0 V=33")
        del table
        self.free()
        self.train_twin(emb, losses)

    def compare_find_wide(self, table, resident):
        """find_scan at V = 33 on the training plane (4-byte words: a row is
        132 bytes) against its plain version, timed beside its bound, on
        find's queries: half of the prefill's last batch, half fresh."""
        st, cfg = table.state, table.cfg
        q = self.queries(resident, self.sz.batch)
        p = self.find_mod.probe_keys(cfg, q)
        args = (st.digests, st.keys, st.scores, st.values, p.bucket1, p.bucket2, p.digest, q)
        want = self.fs.find_scan_plain(*args)
        self.check_equal("find_scan", self.fs.find_scan(*args), want, "1.0 V=33 phase 5 plane")
        tag = "1.0 V=33"
        self.record("find_scan", **{
            f"ms@{tag}": self.time_ms(lambda: self.fs.find_scan(*args), self.sz.timed_runs),
            f"plain_ms@{tag}": self.time_ms(lambda: self.fs.find_scan_plain(*args), 2),
            **self.find_work(st, p, q, want, tag, st.values)})

    def train_twin(self, emb, losses, tag: str = "phase 5"):
        """The same DLRM steps on a 2^20-slot table (a 2^11-slot one in the
        rehearsal; tiered: a cold tier of that size under a hot tier of an
        eighth) through 'auto' and 'plain' on this device."""
        import copy

        import numpy as np

        from repro_torch.models.dlrm import DLRM

        torch, sz = self.torch, self.sz
        small = dataclasses.replace(emb, capacity=sz.small_capacity)
        if emb.is_tiered:
            small = dataclasses.replace(small, hot_capacity=sz.small_capacity // 8)
        ek, ep = small, dataclasses.replace(small, backend="plain")
        tk, tp = ek.create(device=self.dev), ep.create(device=self.dev)

        def states(t):
            return (t.hot.state, t.cold.state) if emb.is_tiered else (t.state,)

        for i in range(0, 2 * sz.small_capacity, sz.small_batch):   # past λ 1.0
            keys, vals = self.fresh_keys(sz.small_batch), self.values(sz.small_batch, emb.dim)
            self.assert_same(tk.insert_or_assign(keys, vals).status,
                             tp.insert_or_assign(keys, vals).status, f"{tag} twin prefill")
        gen = torch.Generator(device=self.dev).manual_seed(SEED + 1)
        mk = DLRM(emb.dim, NUM_SPARSE, DENSE_FEATURES, device=self.dev, generator=gen)
        mp = copy.deepcopy(mk)
        rng = np.random.default_rng(SEED + 1)
        worst = 0.0
        for step in range(sz.train_steps):
            toks, dense_x, labels = self.train_batch(rng, sz.train_batch // 4)
            keys = ek.keys_of(toks)
            init = ek.default_rows(keys)
            self.assert_same(tk.snapshot().find_or_insert(keys, init).status,
                             tp.snapshot().find_or_insert(keys, init).status,
                             f"{tag} twin step {step} statuses")
            out = []
            for e, t, m in ((ek, tk, mk), (ep, tp, mp)):
                t, rows = e.lookup_train(t, toks)
                rows = rows.detach().requires_grad_(True)
                loss = m.loss(rows, dense_x, labels)
                loss.backward()
                m.sgd_(TRAIN_LR)
                e.apply_grads(t, toks, rows.grad)
                out.append(loss.detach())
            err = abs(float(out[0]) - float(out[1]))
            for a, b in zip(states(tk), states(tp)):
                for name in ("keys", "digests", "scores"):
                    self.assert_same(getattr(a, name), getattr(b, name),
                                     f"{tag} twin step {step} state.{name}")
                err = max(err, (a.values - b.values).abs().max().item())
            worst = max(worst, err)
            require(err <= DUP_SUM_ATOL, f"{tag} twin step {step}: values or loss differ by {err}")
        log(f"{tag} twin: {sz.train_steps} steps on {sz.small_capacity} slots"
            + (f" (hot tier {sz.small_capacity // 8})" if emb.is_tiered else "")
            + f", 'auto' and 'plain' equal in keys, digests, scores and statuses; values and "
            f"loss within {worst:.3g}; losses at full size {', '.join(f'{x:.6f}' for x in losses)}")
        del tk, tp

    # phase 6 --------------------------------------------------------------

    def host_link_rate(self, plane) -> float:
        """Bytes a second of a pinned-to-card copy of 1 GiB from `plane`
        (median of 3): the host link's rate, the bound of rows that cross
        it."""
        torch = self.torch
        n = min(plane.numel(), 2**28)
        src = plane.view(-1)[:n]
        dst = torch.empty(n, dtype=plane.dtype, device=self.dev)
        ms = self.time_ms(lambda: dst.copy_(src, non_blocking=True), 3)
        del dst
        return n * plane.element_size() / (ms * 1e-3)

    def phase_hmem(self):
        """Config D on the card: the 'hmem' value tier (see the module note)."""
        from repro_torch.configs.hkv_dlrm import PAPER_CONFIGS

        torch, sz = self.torch, self.sz
        n, runs = sz.batch, sz.timed_runs
        self.free()
        cfg = PAPER_CONFIGS["D"]
        emb = dataclasses.replace(cfg.embedding(), capacity=sz.capacity)
        t0 = time.perf_counter()
        table = emb.create(device=self.dev)
        st = table.state
        t_alloc = time.perf_counter() - t0
        v = st.values.shape[1]
        require(cfg.value_tier == "hmem" and cfg.dim == CONFIG_D_DIM and v == CONFIG_D_DIM + 1,
                "config D's table is not an 'hmem' table of [capacity, 65]")
        plane_bytes = st.values.numel() * st.values.element_size()
        if self.dev.type == "cuda":
            require(st.host_values and all(t.is_cuda for t in (st.keys, st.digests, st.scores)),
                    "config D: the value plane is not on the host beside key planes on the card")
            require(self._build.device_pointer(st.values) == st.values.data_ptr(),
                    "config D: the value plane is not pinned host memory mapped into the card")
            self.link = self.host_link_rate(st.values)
            ram = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
            log(f"phase 6: host link: pinned-to-card copy of 1 GiB at {self.link / 1e9:.3f} GB/s; "
                f"host native atomics {self._build.device_attribute(self._build.HOST_NATIVE_ATOMICS)}"
                f"; host RAM {ram} bytes")
            # why the plane bypasses PyTorch's caching host allocator: the
            # block it gives a pinned tensor of 0.75 GiB
            stats = getattr(torch.cuda.memory, "host_memory_stats", dict)
            before = stats().get("allocated_bytes.current", 0)
            probe = torch.empty(3 * 2**28, dtype=torch.uint8, pin_memory=True)
            log(f"phase 6: torch's pinned allocator gave a {probe.numel()}-byte tensor "
                f"{stats().get('allocated_bytes.current', 0) - before} bytes; torch's "
                f"is_pinned() on the 'hmem' plane: {st.values.is_pinned()}")
            del probe
        else:
            self.link = 1e9   # the rehearsal's placeholder: its numbers mean nothing
        log(f"phase 6: config D: capacity {table.capacity}, dim {emb.dim}, "
            f"{emb.optimizer.name} (V = {v}), dual bucket, {emb.score_policy}, value plane "
            f"{plane_bytes} bytes on {st.values.device} (allocated, pinned and zeroed in "
            f"{t_alloc:.3f} s), keys, digests and scores on {st.device}")
        t0 = time.perf_counter()
        keys, vals, status = self.fill(table, 1.0)
        self.sync()
        log(f"phase 6: prefilled to λ = {table.load_factor():.6f} in "
            f"{time.perf_counter() - t0:.3f} s")
        self.check_find(table, keys, vals, status, "config D λ=1.0")
        self.check_pointers(table, keys, status, "config D λ=1.0")
        ok = (status >= 1) & (status <= 3)
        resident = keys[ok]
        self._build.reset_counts()
        self.op_launches = {}
        mix = lambda: torch.cat([resident[: n // 2], self.fresh_keys(n - n // 2)])
        d = CONFIG_D_DIM
        for name, make in (("find", lambda: (mix(),)),
                           ("find_ptr", lambda: (mix(),)),
                           ("contains", lambda: (mix(),)),
                           ("insert_or_assign", lambda: (self.fresh_keys(n), self.values(n, d))),
                           ("find_or_insert", lambda: (mix(), self.values(n, d)))):
            self.op(table, name, *make(), routes=HMEM_ROUTES)
            t = self.time_op(table, name, [make() for _ in range(runs)], label=" hmem")
            if name == "find":
                # only touched rows cross: a find of n keys moves n rows, far
                # from the whole plane over the link
                require(self.dev.type != "cuda" or t < 0.1 * plane_bytes / self.link * 1e3,
                        f"config D find: {t:.3f} ms against {plane_bytes / self.link * 1e3:.1f} "
                        "ms for the whole plane over the host link")
                log(f"phase 6: find of {n} keys {t:.3f} ms; the whole plane over the host link "
                    f"would take {plane_bytes / self.link * 1e3:.1f} ms")
        log(f"phase 6: launches per op: {json.dumps(self.op_launches)}")
        self.compare_host_rows(st.values, "1.0 hmem")
        losses = self.train_loop(emb, table, d, "phase 6", routes=HMEM_TRAIN_ROUTES,
                                 launches={})[0]
        del table, st
        gc.collect()
        self.free()
        for policy in ("lru", "custom"):
            self.replay_every_op(2, policy, twin=True, dim=d, aux=1)
        self.replay_update_rows("rowwise_adagrad", twin=True, dim=d)
        log(f"phase 6: config D losses {', '.join(f'{x:.6f}' for x in losses)}")

    def compare_host_rows(self, values, tag: str):
        """gather_rows and scatter_rows (set and add) on a host plane
        against their plain versions on the host, at the main path's 2^20
        lanes on distinct rows, half masked; timed beside the bound of the
        bytes that cross the host link (the masked rows: read for a gather,
        written for a set, read and written for an add) at its measured
        rate.  The gather is also timed on 2^20 neighbouring rows, which
        tells the cost of scattered host addresses from that of the rows'
        bytes."""
        torch, n, runs = self.torch, self.sz.batch, self.sz.timed_runs
        r_tot, v = values.shape
        es = values.element_size()
        rows = torch.randperm(r_tot, generator=self.gen, device=self.dev)[:n]
        mask = torch.rand(n, generator=self.gen, device=self.dev) < 0.5
        m = int(mask.sum())
        rows_h, mask_h = rows.cpu(), mask.cpu()
        for width in (None, CONFIG_D_DIM):
            got = self.ga.gather_rows(values, rows, mask, width)
            self.check_equal("gather_rows", (got.cpu(),),
                             (self.ga.gather_rows_plain(values, rows_h, mask_h, width),),
                             f"{tag} host plane" + (f" width {width}" if width else ""))
        seq = torch.arange(n, device=self.dev) + r_tot // 2   # n neighbouring rows
        self.record("gather_rows", **{
            f"ms_host@{tag}": self.time_ms(lambda: self.ga.gather_rows(values, rows, mask), runs),
            f"ms_host_seq@{tag}": self.time_ms(lambda: self.ga.gather_rows(values, seq, mask),
                                               runs),
            f"ms_host_w{CONFIG_D_DIM}@{tag}": self.time_ms(
                lambda: self.ga.gather_rows(values, rows, mask, CONFIG_D_DIM), runs),
            f"link_bytes@{tag}": m * v * es, f"link_bytes_w{CONFIG_D_DIM}@{tag}":
                m * CONFIG_D_DIM * es})
        upd = torch.randn((n, v), generator=self.gen, device=self.dev)
        for add in (False, True):
            old = self.ga.gather_rows_plain(values, rows_h, torch.ones_like(mask_h))
            self.sc.scatter_rows(values, rows, upd, mask, add)
            self.sync()
            want = old.clone()
            self.sc.scatter_rows_plain(want, torch.arange(n), upd.cpu(), mask_h, add)
            got = self.ga.gather_rows_plain(values, rows_h, torch.ones_like(mask_h))
            self.check_equal("scatter_rows", (got,), (want,),
                             f"{tag} host plane {'add' if add else 'set'}")
        self.record("scatter_rows", **{
            f"ms_host@{tag}": self.time_ms(
                lambda: self.sc.scatter_rows(values, rows, upd, mask, False), runs),
            f"ms_host_add@{tag}": self.time_ms(
                lambda: self.sc.scatter_rows(values, rows, upd, mask, True), runs),
            f"link_bytes@{tag}": m * v * es, f"link_bytes_add@{tag}": 2 * m * v * es})

    # phase 7 --------------------------------------------------------------

    @contextlib.contextmanager
    def tier_counters(self, *names: str):
        """Record every call of the TieredHKVTable ops named (by default
        find_or_insert, the tiered lookup_train's op): yields a list of
        (normalized keys, result).  The results carry what no report
        does: the found flags and the pairs dropped, which conservation
        needs."""
        from repro_torch.core import tiered

        cls, seen = tiered.TieredHKVTable, []
        real = {name: getattr(cls, name) for name in names or ("find_or_insert",)}

        def recording(op):
            def call(table, keys, *args, **kwargs):
                res = op(table, keys, *args, **kwargs)
                seen.append((table.keys(keys), res))
                return res
            return call

        for name, op in real.items():
            setattr(cls, name, recording(op))
        try:
            yield seen
        finally:
            for name, op in real.items():
                setattr(cls, name, op)

    def phase_tiered(self):
        """The tier hierarchy on the card (see the module note)."""
        import numpy as np

        from repro_torch import TieredHKVTable
        from repro_torch.embedding import HKVEmbedding, SparseOptimizer

        torch, sz, u64 = self.torch, self.sz, self.u64
        n, d = sz.batch, CONFIG_D_DIM
        self.free()
        emb = HKVEmbedding(capacity=sz.capacity, dim=d, hot_capacity=sz.hot_capacity,
                           optimizer=SparseOptimizer("rowwise_adagrad", lr=0.01),
                           buckets_per_key=2, score_policy="lru")
        t0 = time.perf_counter()
        table = emb.create(device=self.dev)
        t_alloc = time.perf_counter() - t0
        require(isinstance(table, TieredHKVTable) and table.hot.capacity * 8 == table.cold.capacity,
                "phase 7: not a tiered table with a hot tier of an eighth of the cold one")
        if self.dev.type == "cuda":
            require(table.cold.state.host_values and not table.hot.state.host_values,
                    "phase 7: the cold tier's values are not on the host, or the hot tier's are")
        log(f"phase 7: tiered HKVEmbedding: hot tier {table.hot.capacity} slots (values on "
            f"{table.hot.state.values.device}), cold tier {table.cold.capacity} slots "
            f"({table.cold.cfg.score_policy} scores, values on {table.cold.state.values.device}), "
            f"dim {d}, {emb.optimizer.name}, dual bucket; created in {t_alloc:.3f} s")
        # a batch of the steps' own key distribution first, then fresh keys
        # past the hot tier's capacity: the prefill pushes the early keys
        # down, and the steps' accesses to them promote them back
        warm = emb.keys_of(self.train_batch(np.random.default_rng(SEED + 3),
                                            sz.train_batch)[0])
        warm = torch.unique(warm[warm != u64.EMPTY])
        table.insert_or_assign(warm, emb.default_rows(warm))
        inserted, dropped, demoted = warm.numel(), 0, 0
        t0 = time.perf_counter()
        for _ in range(sz.hot_capacity // n + 4):
            r = table.insert_or_assign(self.fresh_keys(n), self.values(n, d))
            inserted += n
            dropped += int(r.dropped)
            demoted += int(r.demoted)
        size = table.size()
        log(f"phase 7: prefilled with {warm.numel()} keys of the steps' distribution, then "
            f"{inserted - warm.numel()} fresh keys in {time.perf_counter() - t0:.3f} s: "
            f"hot λ {table.hot.load_factor():.6f}, cold λ {table.cold.load_factor():.6f}; demoted "
            f"{demoted}, dropped {dropped}; {size} keys in the hierarchy")
        require(demoted > 0, "phase 7: the prefill demoted nothing")
        self.conserved(inserted, dropped, size, "phase 7 prefill")
        self.launches_tiered = {}
        motion = {"promoted": 0, "demoted": 0, "dropped": 0}
        sizes = [size]
        with self.tier_counters() as seen:
            def conserve(step):
                keys, res = seen[-1]
                for k in motion:
                    motion[k] += int(getattr(res, k))
                new = torch.unique(keys[~res.found & (keys != u64.EMPTY)]).numel()
                sizes.append(table.size())
                self.conserved(sizes[-2] + new, int(res.dropped), sizes[-1], f"phase 7 step {step}")
                log(f"phase 7 step {step}: promoted {int(res.promoted)}, demoted "
                    f"{int(res.demoted)}, dropped {int(res.dropped)}; {new} keys new to the "
                    f"hierarchy; {sizes[-1]} keys in it")

            losses = self.train_loop(emb, table, d, "phase 7", routes=TIERED_ROUTES,
                                     launches=self.launches_tiered, tiered=True,
                                     after_step=conserve)[0]
        log(f"phase 7: over {sz.train_steps} steps promoted {motion['promoted']}, demoted "
            f"{motion['demoted']}, dropped {motion['dropped']}")
        require(motion["promoted"] > 0 and motion["demoted"] > 0,
                "phase 7: the steps promoted or demoted nothing")
        toks = self.train_batch(np.random.default_rng(SEED + 2), sz.train_batch)[0]
        served, t_serve = self.counted("lookup_serve", emb.lookup_serve, table, toks,
                                       routes=TIERED_ROUTES, launches=self.launches_tiered)
        require(served.shape == (*toks.shape, d) and bool(torch.isfinite(served).all()),
                "phase 7: lookup_serve rows of the wrong shape or not finite")
        require(table.size() == sizes[-1], "phase 7: lookup_serve changed the hierarchy")
        log(f"phase 7: lookup_serve of {toks.numel()} keys {t_serve:.3f} ms (a pure reader: "
            f"promoted 0, demoted 0, dropped 0); kernel launches "
            f"{json.dumps(self.launches_tiered)}")
        del table
        gc.collect()
        self.free()
        self.train_twin(emb, losses, "phase 7")

    # phase 8 --------------------------------------------------------------

    def serve_table(self, hot: int, cold: int, backend: str = "auto"):
        """The serving configuration's hierarchy: a hot tier in HBM over a
        cold tier in pinned host memory, dim 32, dual bucket, LRU hot and
        'custom' cold scores, no optimizer columns."""
        from repro_torch import TieredHKVTable

        return TieredHKVTable.create(hot_capacity=hot, cold_capacity=cold, dim=DIM,
                                     buckets_per_key=2, score_policy="lru",
                                     cold_score_policy="custom", backend=backend,
                                     device=self.dev)

    def serve_prefill(self, table, batch: int) -> tuple[int, int]:
        """Fill the hierarchy past its hot tier, the same way every time: the
        distinct keys of a draw from the serving distribution, then fresh
        keys of a fixed sequence, batch by batch, until the hot tier has
        taken its capacity and four batches more.  Returns (distinct keys
        inserted, pairs reported dropped); conservation is checked."""
        import numpy as np

        from repro_torch.data import zipf_keys

        torch = self.torch
        key_space = 2 * table.cold.capacity
        gen = torch.Generator(device=self.dev).manual_seed(SEED + 8)
        warm = np.unique(zipf_keys(np.random.default_rng(SEED + 8), batch, SERVE_ALPHA,
                                   key_space))
        warm = warm[warm != np.uint64(2**64 - 1)]
        dropped = int(table.insert_or_assign(
            warm, torch.randn((warm.size, DIM), generator=gen, device=self.dev)).dropped)
        inserted = warm.size
        for i in range(table.hot.capacity // batch + 4):
            idx = torch.arange(i * batch, (i + 1) * batch, device=self.dev) + 2**40
            keys = (idx * 0x2545F4914F6CDD1D + 0x1D8E4E27C47D124F) & (2**63 - 1)
            r = table.insert_or_assign(keys, torch.randn((batch, DIM), generator=gen,
                                                         device=self.dev))
            inserted += batch
            dropped += int(r.dropped)
        self.conserved(inserted, dropped, table.size(), "phase 8 prefill")
        return inserted, dropped

    @staticmethod
    def serve_reset(table) -> None:
        """Empty the hierarchy as `create` leaves it (clocks and epochs 0)."""
        table.clear()
        for tier in (table.hot, table.cold):
            tier.state.clock, tier.state.epoch = 0, 0

    def serve_route(self, kind: str, got: dict) -> None:
        """One serving op's launches against SERVE_ROUTES; claim_scan up
        to SERVE_CLAIMS times (once for each upsert whose batch has a miss
        lane)."""
        want = dict(SERVE_ROUTES[kind])
        claims = got.get("claim_scan", 0)
        require(claims <= SERVE_CLAIMS[kind],
                f"phase 8 {kind}: claim_scan launched {claims} times, at most "
                f"{SERVE_CLAIMS[kind]}")
        if claims:
            want["claim_scan"] = claims
        require(got == want, f"phase 8 {kind}: launches {got}, the route is {want}")

    def serve_run(self, table, tag: str, *, wave: int, waves: int, req_keys: int,
                  policy: str = "admit", promote=None, admission: str = "wave",
                  arrival: str = "steady", maintain: bool = True, train: bool = True,
                  tally: bool = True, quiet: bool = False) -> dict:
        """Serve one Zipfian request stream (a request a tick) from `table`
        behind a TablePublisher, with an OnlineTrainer at an update:read
        ratio of 0.25 that publishes twice over the run, and a
        MaintenanceScheduler (exp7's watermarks 0.6 / 0.85, a sweep budget of
        one wave) every wave when asked.  Each wave's, maintenance step's
        and trainer step's launches are counted from 0 and checked against
        SERVE_ROUTES (on the card, backend 'auto'); with `tally` they are
        added to the phase's launches.  The hierarchy's distinct keys are
        checked after each of them (wave mode; a continuous run is checked
        as a whole).  Returns the run's record."""
        import numpy as np

        from repro_torch.data import arrival_sizes, zipf_keys
        from repro_torch.maintenance import MaintenancePolicy, MaintenanceScheduler
        from repro_torch.serving import (EmbeddingRequest, OnlineEmbeddingEngine,
                                         OnlineTrainer, TablePublisher)

        torch, build = self.torch, self._build
        counted = self.dev.type == "cuda" and table.backend == "auto"
        per_op = admission == "wave"        # conservation after every op
        key_space = 2 * table.cold.capacity
        rec = {"maint": [], "train": [], "publish_s": [], "counts": {}}
        kind = "admit wave" if policy == "admit" else "readonly wave"

        def count(op):
            got = dict(build.launch_counts)
            build.reset_counts()
            if counted:
                self.serve_route(op, got)
                rec["counts"].setdefault(op, got)
                if tally:
                    for k, v in got.items():
                        self.launches_serve[k] = self.launches_serve.get(k, 0) + v

        def check(t, before, new, dropped, ctx):
            self.conserved(before + new, dropped, t.size(), ctx)

        def new_keys(keys, res):
            return torch.unique(keys[~res.found & (keys != self.u64.EMPTY)]).numel()

        class Windows:
            """The engine's table source.  Its snapshots, taken just before
            a wave's dispatch and a maintenance step and outside their
            timings, bound the launch windows: each closes the window of the
            op before it (a wave when a table op was recorded, else a
            maintenance step when the scheduler reported one) and opens the
            next."""

            def __init__(w):
                w.window = None

            def snapshot(w):
                w.close()
                snap = pub.snapshot()
                t = snap[1]
                w.window = (t, t.size() if per_op else 0, len(seen),
                            len(sched.reports) if sched is not None else 0)
                build.reset_counts()
                return snap

            def offer(w, version, table):
                return pub.offer(version, table)

            def close(w):
                if w.window is None:
                    return
                t, before, n_seen, n_reps = w.window
                w.window = None
                if len(seen) > n_seen:
                    count(kind)
                    if per_op:
                        keys, res = seen[-1]
                        new = new_keys(keys, res) if policy == "admit" else 0
                        check(t, before, new, int(res.dropped), f"{tag} wave")
                elif sched is not None and len(sched.reports) > n_reps:
                    count("maintenance step")
                    rep = sched.reports[-1]
                    rec["maint"].append(rep)
                    if per_op:
                        check(t, before, 0, rep.dropped, f"{tag} maintenance step")
                else:
                    got = dict(build.launch_counts)
                    require(not got, f"{tag}: launches {got} outside every op")

        pub = TablePublisher(table)
        windows = Windows()
        publish_every = max(1, int(waves * SERVE_UPDATE_READ) // 2)
        trainer = OnlineTrainer(publisher=pub, publish_every=publish_every, lr=0.1) if train else None
        sched = MaintenanceScheduler(MaintenancePolicy(
            every_waves=1, sweep_budget=wave, low_watermark=SERVE_LOW,
            high_watermark=SERVE_HIGH)) if maintain else None
        eng = OnlineEmbeddingEngine(windows, wave_size=wave, miss_policy=policy, promote=promote,
                                    admission=admission, scheduler=sched)
        if trainer is not None:
            publish = trainer.publish

            def timed_publish():
                self.sync()
                t0 = time.perf_counter()
                v = publish()
                self.sync()
                rec["publish_s"].append(time.perf_counter() - t0)
                return v

            trainer.publish = timed_publish

        rng = np.random.default_rng(SEED + 9)
        train_rng = np.random.default_rng(SEED + 10)
        if arrival == "steady":
            sizes = np.full(waves, req_keys, np.int64)
        else:
            sizes = arrival_sizes(arrival, np.random.default_rng(SEED + 11), waves, wave)
        size0 = table.size()
        ones = torch.ones((wave, DIM), device=self.dev)
        due = 0.0
        with self.tier_counters("find_or_insert", "find") as seen:
            for i, n in enumerate(sizes):
                eng.submit(EmbeddingRequest(rid=i, keys=zipf_keys(rng, int(n), SERVE_ALPHA,
                                                                  key_space)))
                eng.step()
                due += SERVE_UPDATE_READ
                while trainer is not None and due >= 1.0:
                    windows.close()
                    tkeys = zipf_keys(train_rng, wave, SERVE_ALPHA, key_space)
                    tt = trainer.table
                    before = tt.size()
                    build.reset_counts()
                    self.sync()
                    t0 = time.perf_counter()
                    trainer.train_step(tkeys, ones)
                    self.sync()
                    ms = (time.perf_counter() - t0) * 1e3
                    count("trainer step")
                    keys, res = seen[-1]
                    check(tt, before, new_keys(keys, res), int(res.dropped),
                          f"{tag} trainer step")
                    if trainer.table is not tt:    # published: the copy equals it
                        require(trainer.table.size() == tt.size(),
                                f"{tag}: the trainer's copy differs in size")
                    rec["train"].append(ms)
                    due -= 1.0
            eng.run_until_drained()
            windows.close()
        if not per_op:
            dropped = sum(int(res.dropped) for _k, res in seen)
            self.conserved(size0, dropped, pub.table.size(), f"{tag} (the run as a whole)")
        rec["reports"] = eng.reports
        rec["requests"] = {r.rid: (r.keys, r.values, r.found) for r in eng.completed}
        rec["metrics"] = eng.metrics()
        rec["depth"] = eng.depth_at_dispatch
        rec["sched"] = (sched.reports, sched.totals) if sched is not None else None
        rec["offers"] = (pub.published, pub.offered, pub.rejected_offers, pub.version)
        rec["table"] = pub.table
        rec["trainer_table"] = None if trainer is None else trainer.table
        require(len(eng.completed) == waves and all(r.done for r in eng.completed),
                f"{tag}: not every request completed")
        for rid, (keys, vals, found) in rec["requests"].items():
            require(vals.shape == (len(keys), DIM) and np.isfinite(vals).all(),
                    f"{tag}: request {rid}'s rows are of the wrong shape or not finite")
        if not quiet:
            self.serve_log(tag, rec, admission)
        return rec

    def serve_log(self, tag, rec, admission):
        import numpy as np

        reps, maint = rec["reports"], rec["maint"]
        for i, r in enumerate(reps):
            m = maint[i] if len(maint) == len(reps) else None
            log(f"{tag} wave {i}: {r.size} keys, {r.latency_s * 1e3:.3f} ms "
                f"({r.kv_per_s / 1e6:.3f} M keys/s), hit rate {r.hit_rate:.4f}, hot-hit rate "
                f"{r.hot_hits / max(r.size, 1):.4f}, reactive demotions {r.demotions}"
                + (f"; maintenance step {m.elapsed_s * 1e3:.3f} ms, {m.demoted} moved, "
                   f"{m.dropped} dropped" if m is not None else ""))
        half = reps[len(reps) // 2:]

        def pct(xs):
            return (f"p50 {np.percentile(xs, 50):.3f} / p99 {np.percentile(xs, 99):.3f}"
                    if len(xs) else "none")

        keys = sum(r.size for r in half)
        secs = sum(r.latency_s for r in half)
        log(f"{tag}: second half ({len(half)} waves): wave ms "
            f"{pct([r.latency_s * 1e3 for r in half])}, {keys / max(secs, 1e-12) / 1e6:.3f} M "
            f"keys/s, hit rate {sum(r.hits for r in half) / max(keys, 1):.4f}, hot-hit rate "
            f"{sum(r.hot_hits for r in half) / max(keys, 1):.4f}, reactive demotions a wave "
            f"{sum(r.demotions for r in half) / max(len(half), 1):.1f}")
        if maint:
            mh = maint[len(maint) // 2:]
            log(f"{tag}: maintenance steps (second half) ms {pct([m.elapsed_s * 1e3 for m in mh])}"
                f", moves {pct([m.demoted for m in mh])}; totals {rec['sched'][1]}")
        if rec["train"]:
            log(f"{tag}: trainer steps ms {', '.join(f'{t:.3f}' for t in rec['train'])}; "
                f"publishes s {', '.join(f'{t:.3f}' for t in rec['publish_s'])}")
        pubd, offered, rejected, version = rec["offers"]
        log(f"{tag}: publisher published {pubd}, offered {offered}, rejected_offers {rejected}, "
            f"version {version}")
        if admission == "continuous":
            m = rec["metrics"]
            log(f"{tag}: {m.requests} requests: queue-wait ms p50 {m.p50_queue_wait_s * 1e3:.3f} "
                f"/ p99 {m.p99_queue_wait_s * 1e3:.3f}, service p50 {m.p50_service_s * 1e3:.3f} "
                f"/ p99 {m.p99_service_s * 1e3:.3f}, total p50 {m.p50_total_s * 1e3:.3f} / p99 "
                f"{m.p99_total_s * 1e3:.3f}; waves in flight at each dispatch "
                f"{rec['depth']}")
        for kind, got in rec["counts"].items():
            log(f"{tag}: launches a {kind}: {json.dumps(got)}")

    def phase_serve(self):
        """The serving path on the card (see the module note)."""
        sz = self.sz
        self.free()
        self.launches_serve = {}
        wave, req = sz.serve_wave, sz.serve_samples * NUM_SPARSE
        t0 = time.perf_counter()
        table = self.serve_table(sz.hot_capacity, sz.capacity)
        t_alloc = time.perf_counter() - t0
        if self.dev.type == "cuda":
            require(table.cold.state.host_values and not table.hot.state.host_values,
                    "phase 8: the cold tier's values are not on the host, or the hot tier's are")
        t0 = time.perf_counter()
        inserted, dropped = self.serve_prefill(table, sz.batch)
        log(f"phase 8: TieredHKVTable hot {table.hot.capacity} slots (values on "
            f"{table.hot.state.values.device}), cold {table.cold.capacity} slots (values on "
            f"{table.cold.state.values.device}), dim {DIM}, dual, lru / custom; created in "
            f"{t_alloc:.3f} s, prefilled with {inserted} keys in {time.perf_counter() - t0:.3f} s "
            f"(dropped {dropped}): hot λ {table.hot.load_factor():.6f}, cold λ "
            f"{table.cold.load_factor():.6f}; waves of {wave} lanes, requests of "
            f"{sz.serve_samples} samples x {NUM_SPARSE} fields = {req} keys, Zipf α "
            f"{SERVE_ALPHA} over {2 * table.cold.capacity} ranks")
        on = self.serve_run(table, "phase 8 run 1 (admit, scheduler on)", wave=wave,
                            waves=sz.serve_waves, req_keys=req)
        require(on["offers"][0] >= 2, "phase 8 run 1: fewer than two publishes")
        require(on["sched"][1].demoted > 0, "phase 8 run 1: the scheduler moved nothing")
        # the same stream from the same prefilled state with the scheduler
        # off (exp7's comparison); the run's two copies are dropped first
        table = on["table"]
        del on["table"], on["trainer_table"]
        gc.collect()
        self.free()
        self.serve_reset(table)
        self.serve_prefill(table, sz.batch)
        off = self.serve_run(table, "phase 8 run 2 (admit, scheduler off)", wave=wave,
                             waves=sz.serve_waves, req_keys=req, maintain=False)
        for name, r in (("on", on), ("off", off)):
            half = r["reports"][len(r["reports"]) // 2:]
            keys = sum(x.size for x in half)
            log(f"phase 8: scheduler {name}: second-half hit rate "
                f"{sum(x.hits for x in half) / max(keys, 1):.6f}, reactive demotions a wave "
                f"{sum(x.demotions for x in half) / max(len(half), 1):.1f}")
        table = off["table"]
        del off["table"], off["trainer_table"]
        gc.collect()
        self.free()
        burst = self.serve_run(table, "phase 8 run 3 (readonly, promote, continuous, burst)",
                               wave=wave, waves=sz.serve_ticks, req_keys=req,
                               policy="readonly", promote=True, admission="continuous",
                               arrival="burst", maintain=False, train=False)
        require(any(r.size for r in burst["reports"]), "phase 8 run 3 served nothing")
        del table, burst["table"]
        gc.collect()
        self.free()
        self.serve_twins()
        log(f"phase 8: kernel launches: {json.dumps(self.launches_serve)}")
        missing = [k for k in SERVE_KERNELS if self.dev.type == "cuda"
                   and not self.launches_serve.get(k)]
        require(not missing, f"phase 8 never launched {missing}")

    def serve_twins(self):
        """The serving path on a 2^20-slot hierarchy (its hot tier an
        eighth) through 'auto' and 'plain': equal per-request values and
        found flags, reports, scheduler reports and totals, publisher
        counters and drained states; then the export_delta -> ingest_delta
        round trip of the 'auto' twin's table."""
        import numpy as np

        from repro_torch.serving import export_delta, ingest_delta

        torch, sz = self.torch, self.sz
        cold, wave = sz.small_capacity, sz.serve_wave // 4
        req = wave - wave // 16
        recs = []
        for backend in ("auto", "plain"):
            t = self.serve_table(cold // 8, cold, backend)
            self.serve_prefill(t, sz.small_batch)
            recs.append(self.serve_run(t, f"phase 8 twin ({backend})", wave=wave,
                                       waves=sz.serve_waves // 2, req_keys=req, tally=False,
                                       quiet=True))
        a, p = recs
        worst = 0.0
        for rid, (keys, va, fa) in a["requests"].items():
            _k, vp, fp = p["requests"][rid]
            require(np.array_equal(fa, fp), f"phase 8 twin: request {rid}'s found flags differ")
            worst = max(worst, float(np.abs(va - vp).max()) if va.size else 0.0)
        fields = lambda r: (r.size, r.hits, r.hot_hits, r.demotions, r.table_version)  # noqa: E731
        require([fields(r) for r in a["reports"]] == [fields(r) for r in p["reports"]],
                "phase 8 twin: wave reports differ")
        strip = lambda reps: [r._replace(elapsed_s=0.0) for r in reps]  # noqa: E731
        require(strip(a["sched"][0]) == strip(p["sched"][0])
                and a["sched"][1]._replace(time_s=0.0) == p["sched"][1]._replace(time_s=0.0),
                "phase 8 twin: scheduler reports differ")
        require(a["offers"] == p["offers"], "phase 8 twin: publisher counters differ")
        for which in ("table", "trainer_table"):
            for ta, tp in ((a[which].hot, p[which].hot), (a[which].cold, p[which].cold)):
                for name in ("keys", "digests", "scores"):
                    self.assert_same(getattr(ta.state, name), getattr(tp.state, name),
                                     f"phase 8 twin {which} state.{name}")
                worst = max(worst, (ta.state.values - tp.state.values.to(ta.state.values.device))
                            .abs().max().item())
        require(worst <= DUP_SUM_ATOL, f"phase 8 twin: values differ by {worst}")
        log(f"phase 8 twin: {cold} slots (hot tier {cold // 8}), {len(a['reports'])} waves of "
            f"{wave} lanes, {len(a['train'])} trainer steps, {a['offers'][0]} publishes, "
            f"{a['sched'][1].runs} maintenance steps ({a['sched'][1].demoted} moved): 'auto' "
            f"and 'plain' equal in found flags, reports, scheduler reports, publisher counters, "
            f"keys, digests and scores; values within {worst:.3g}")
        # the delta hand-off of the served table, into a fresh flat table on
        # each backend
        from repro_torch import HKVTable

        t0 = time.perf_counter()
        delta = export_delta(a["table"], chunk_buckets=1024)
        t_exp = time.perf_counter() - t0
        dsts = []
        for backend in ("auto", "plain"):
            d = HKVTable.create(capacity=4 * cold, dim=DIM, buckets_per_key=2,
                                score_policy="custom", device=self.dev, backend=backend)
            t0 = time.perf_counter()
            ingest_delta(d, delta, batch=sz.small_batch, carry_scores=True)
            dsts.append((d, time.perf_counter() - t0))
        (da, t_ing), (dp, _) = dsts
        for name in ("keys", "digests", "scores", "values"):
            self.assert_same(getattr(da.state, name), getattr(dp.state, name),
                             f"phase 8 delta state.{name}")
        f = da.find(delta.keys)
        require(bool(f.found.all()), "phase 8 delta: an exported key is missing after ingest")
        require(torch.equal(f.values.cpu(), torch.from_numpy(delta.values)),
                "phase 8 delta: ingested rows differ from the exported ones")
        back = export_delta(da, chunk_buckets=1024)
        order_a, order_b = np.argsort(delta.keys), np.argsort(back.keys)
        require(np.array_equal(delta.keys[order_a], back.keys[order_b])
                and np.array_equal(delta.scores[order_a], back.scores[order_b]),
                "phase 8 delta: the round trip changed keys or scores")
        log(f"phase 8 delta: export_delta of the 'auto' twin's table ({delta.count} live "
            f"entries) {t_exp:.3f} s, ingest_delta (carry_scores) {t_ing:.3f} s; 'auto' and "
            f"'plain' destinations equal; every key found with its row and score")
        del recs, a, p, dsts, da, dp

    @staticmethod
    def conserved(expected: int, dropped: int, size: int, ctx: str) -> None:
        """No pair leaves the hierarchy uncounted: of `expected` distinct
        keys, at most `dropped` (the reported upper bound) are gone, and
        none when none is reported."""
        lost = expected - size
        require(0 <= lost <= dropped and (dropped > 0 or lost == 0),
                f"{ctx}: {expected} keys expected, {size} in the hierarchy, {dropped} reported "
                "dropped")

    # phase 9 --------------------------------------------------------------

    def phase_tel_base(self):
        """Telemetry on config B, the dictionary baselines at config B's
        capacity, and the two last kernel wrappers."""
        self.free()
        self.tel_results, self.base_results = {}, {}
        self.telemetry_config_b()
        self.free()
        self.baselines()
        self.free()
        self.find_many_tables()
        self.free()

    def resident(self, keys_plane, n: int, unique: bool = False):
        """n keys drawn from the live slots of a key plane (TOMB and EMPTY
        are negative, never live ids), with or without repeats."""
        torch = self.torch
        flat = keys_plane.reshape(-1)
        live = torch.nonzero(flat >= 0)[:, 0]
        if unique:
            pick = live[torch.randperm(live.numel(), generator=self.gen, device=self.dev)[:n]]
        else:
            pick = live[torch.randint(0, live.numel(), (n,), generator=self.gen, device=self.dev)]
        return flat[pick]

    def count_launches(self, fn):
        """fn() with the launch counts set to 0 just before and read just
        after: (its result, the launches)."""
        self.sync()
        self._build.reset_counts()
        out = fn()
        self.sync()
        return out, dict(self._build.launch_counts)

    def telemetry_config_b(self):
        from repro_torch.obs import TelemetrySink
        from repro_torch.obs import telemetry as obs

        torch, sz = self.torch, self.sz
        n, runs = sz.batch, sz.timed_runs
        table = self.config_b()
        cfg = table.cfg
        ppq = {}
        for lam in (0.25, 0.5, 0.75, 1.0):
            self.fill(table, lam)
            q = self.resident(table.state.keys, n)
            sink = TelemetrySink()
            r, got = self.count_launches(lambda: table.find(q, telemetry=sink))
            if self.dev.type == "cuda":
                require(got == ROUTES["find"][2],
                        f"phase 9: find with a sink launched {got}, the route is {ROUTES['find'][2]}")
            d = sink.by_op["find"].to_dict()
            lanes, hits = int((q != self.u64.EMPTY).sum()), int(r.found.sum())
            require(d["lanes"] == lanes and d["hits"] == hits and hits == n,
                    f"phase 9 λ={lam}: telemetry lanes {d['lanes']} hits {d['hits']}, the "
                    f"op's own {lanes} lanes and {hits} found of {n}")
            rates = sink.by_op["find"].rates()
            ppq[lam] = rates["probes_per_query"]
            t_op = self.time_ms(lambda: table.find(q), runs)
            t_sink = self.time_ms(lambda: table.find(q, telemetry=TelemetrySink()), runs)
            t_obs = self.time_ms(lambda: obs.observe_find(table.state, cfg, q, r.found), runs)
            self.tel_results[lam] = dict(lam=table.load_factor(), ppq=ppq[lam], find_ms=t_op,
                                         kvs=n / t_op / 1e6, sink_ms=t_sink, obs_ms=t_obs,
                                         digest_pass_rate=rates["digest_pass_rate"],
                                         second_probe_rate=rates["second_probe_rate"])
            log(f"phase 9: HKV λ = {table.load_factor():.6f}: find of {n} resident keys "
                f"{t_op:.3f} ms ({n / t_op / 1e6:.4f} B-KV/s); with a sink {t_sink:.3f} ms; the "
                f"observer alone {t_obs:.3f} ms; probes_per_query {ppq[lam]:.6f}, digest_pass_rate "
                f"{rates['digest_pass_rate']:.6f}, second_probe_rate "
                f"{rates['second_probe_rate']:.6f}; counters {json.dumps(d)}")
        spread = (max(ppq.values()) - min(ppq.values())) / min(ppq.values())
        log(f"phase 9: probes_per_query over λ 0.25-1.0 varies by {spread:.6%}")
        require(spread < 0.05, f"phase 9: probes_per_query not flat across λ: {ppq}")
        self.tel_results["spread"] = spread

        # past λ 1.0 on two twins, one with a sink and one without
        twin = table.snapshot()
        for op in ("insert_or_assign", "find_or_insert"):
            keys = self.fresh_keys(n)
            # a burst at the bucket with the coldest entry: dual-bucket
            # selection sends most of it there, past its slots
            coldest = int(self.u64.flip(table.state.scores).min(dim=1).values.argmin())
            keys[: sz.hot_keys] = self.hot_bucket_keys(cfg.num_buckets, sz.hot_keys, coldest)
            keys[n - n // 8:] = self.resident(table.state.keys, n // 8, unique=True)
            vals = self.values(n)
            sink = TelemetrySink()
            probe_ms = self.time_ms(lambda: obs.probe_counters(table.state, cfg, keys), 2)
            self.sync()
            a = self.mark()
            ra = getattr(table, op)(keys, vals, telemetry=sink)
            b = self.mark()
            rb, got_b = self.count_launches(lambda: getattr(twin, op)(keys, vals))
            c = self.mark()
            self.sync()
            want = self.route(ROUTES[op][2], self.has_miss(rb.status))
            ra2, got_a = None, None
            if self.dev.type == "cuda":
                require(got_b == want, f"phase 9 {op}: launches {got_b}, the route is {want}")
            require(torch.equal(ra.status, rb.status), f"phase 9 {op}: statuses differ with a sink")
            if op == "find_or_insert":
                require(torch.equal(ra.values, rb.values) and torch.equal(ra.found, rb.found),
                        f"phase 9 {op}: values or found differ with a sink")
            hist = torch.bincount(rb.status.long(), minlength=5).tolist()
            d = sink.by_op[op].to_dict()
            require([d["updated"], d["inserted"], d["evicted"], d["rejected"]] == hist[1:],
                    f"phase 9 {op}: telemetry histogram {d}, statuses {hist}")
            require(d["evicted"] > 0 and d["rejected"] > 0,
                    f"phase 9 {op}: no eviction or no rejection past λ 1.0: {hist}")
            hist_ms = self.time_ms(lambda: obs.observe_upsert(
                {k: d[k] for k in ("lanes", "probed_buckets", "probed_slots", "digest_pass",
                                   "second_probe")}, keys, rb.status, None), 2)
            self.tel_results[op] = dict(op_ms=self.elapsed_ms(b, c),
                                        op_sink_ms=self.elapsed_ms(a, b), probe_ms=probe_ms,
                                        hist_ms=hist_ms, counters=d)
            log(f"phase 9: {op} of {n} keys past λ 1.0: {self.elapsed_ms(b, c):.3f} ms, with a "
                f"sink {self.elapsed_ms(a, b):.3f} ms; the observer's probe part "
                f"{probe_ms:.3f} ms, its status histogram {hist_ms:.3f} ms; launches {got_b}; "
                f"counters {json.dumps(d)}")
        # a sink adds no launch: the same op with one, counted
        q = self.resident(table.state.keys, n)
        _, got = self.count_launches(lambda: table.find(q, telemetry=TelemetrySink()))
        if self.dev.type == "cuda":
            require(got == ROUTES["find"][2], f"phase 9: find with a sink launched {got}")
        for name, x, y in zip(("keys", "digests", "scores", "values"), table.state.planes,
                              twin.state.planes):
            require(torch.equal(x, y), f"phase 9: the twins' {name} planes differ")
        require((table.state.clock, table.state.epoch) == (twin.state.clock, twin.state.epoch),
                "phase 9: the twins' clocks differ")
        log("phase 9: the twins (a sink and none) are equal in every plane")
        del twin
        self.free()
        self.assign_wrapper(table)
        del table

    def assign_wrapper(self, table):
        """assign_kernel (set and add) on a config B table against its
        plain composition, on unique resident keys; the key planes are
        shared, the value plane copied."""
        from repro_torch.core.table import HKVState
        from repro_torch.kernels import ops as kops

        torch, sz = self.torch, self.sz
        n = sz.batch
        st, cfg = table.state, table.cfg
        keys = self.resident(st.keys, n - n // 8, unique=True)
        keys = torch.cat([keys, self.fresh_keys(n // 8)])
        vals = self.values(n)
        plain = HKVState(st.keys, st.digests, st.scores, st.values.clone(), st.clock, st.epoch)
        res = {}
        for add in (False, True):
            tag = "add" if add else "set"
            _, got = self.count_launches(lambda: kops.assign_kernel(st, cfg, keys, vals, add=add))
            kops.assign_plain(plain, cfg, keys, vals, add=add)
            self.sync()
            if self.dev.type == "cuda":
                require(got == {"digest_scan": 1, "scatter_rows": 1},
                        f"phase 9: assign_kernel ({tag}) launched {got}")
            require(torch.equal(st.values, plain.values),
                    f"phase 9: assign_kernel ({tag}) differs from its plain composition")
            res[tag] = (self.time_ms(lambda: kops.assign_kernel(st, cfg, keys, vals, add=add),
                                     sz.timed_runs),
                        self.time_ms(lambda: kops.assign_plain(plain, cfg, keys, vals, add=add),
                                     2))
        self.tel_results["assign"] = res
        log(f"phase 9: assign_kernel on {n} keys (7/8 resident) bit-identical to its plain "
            "composition, set and add: " + ", ".join(
                f"{k} {a:.3f} ms (plain {b:.3f} ms)" for k, (a, b) in res.items()))
        del plain

    def baselines(self):
        """The dictionary baselines at dim 32 and config B's capacity,
        filled by offered load in batches of `batch` fresh keys."""
        from repro_torch.baselines import DictKVTable

        torch, sz = self.torch, self.sz
        n, cap = sz.batch, sz.capacity
        t0 = time.perf_counter()
        for name, make, points in (("open addressing", DictKVTable.open_addressing, (0.5, 0.9)),
                                   ("bucketed P2C", DictKVTable.bucketed_p2c, (0.5, 1.0))):
            table = make(capacity=cap, dim=DIM, device=self.dev)
            offered = failed = 0
            ok_keys = []
            for lam in points:
                t_fill = time.perf_counter()
                last = None
                while offered < int(lam * cap):
                    m = min(n, int(lam * cap) - offered)
                    keys, vals = self.fresh_keys(m), self.values(m)
                    r = table.insert_or_assign(keys, vals)
                    nf = int((~r.ok).sum())
                    offered, failed, last = offered + m, failed + nf, nf / m
                    if lam == points[0]:
                        ok_keys.append(keys[r.ok])
                self.sync()
                t_fill = time.perf_counter() - t_fill
                if lam == points[0]:
                    everyone = torch.cat(ok_keys)
                    for i in range(0, everyone.numel(), n):
                        require(bool(table.contains(everyone[i:i + n]).all()),
                                f"phase 9 {name} λ={lam}: a resident key was not found")
                    log(f"phase 9: {name}: all {everyone.numel()} resident keys found at "
                        f"offered λ {lam}")
                    del everyone, ok_keys
                q = self.resident(table.state.keys, n)
                f = table.find(q)
                require(bool(f.found.all()), f"phase 9 {name}: a sampled resident key missed")
                t = self.time_ms(lambda: table.find(q), sz.timed_runs)
                probes = float(f.probes.double().mean())
                lam_got = table.load_factor()
                hkv = self.tel_results.get(1.0 if lam >= 0.9 else lam, {})
                self.base_results[(name, lam)] = dict(
                    lam=lam_got, find_ms=t, kvs=n / t / 1e6, probes=probes,
                    fail=failed / offered, fail_last=last, fill_s=t_fill)
                log(f"phase 9: {name} offered λ {lam} (held {lam_got:.6f}): find of {n} resident "
                    f"keys {t:.3f} ms ({n / t / 1e6:.4f} B-KV/s), mean probes {probes:.4f}, "
                    f"max {int(f.probes.max())}; inserts failed {failed / offered:.6f} of "
                    f"{offered} offered, {last:.6f} of the last batch; filled in {t_fill:.1f} s"
                    + (f"; HKV (dual) at λ {hkv['lam']:.6f}: {hkv['kvs']:.4f} B-KV/s, "
                       f"probes_per_query {hkv['ppq']:.6f}" if hkv else ""))
            del table
            self.free()
        self.base_results["seconds"] = time.perf_counter() - t0
        log(f"phase 9: baselines took {self.base_results['seconds']:.1f} s")

    def find_many_tables(self):
        """find_many_kernel over NUM_SPARSE tables of `many_capacity` slots
        at dim 32, filled to λ 1.0, with `batch` keys spread over them
        (about half resident), against NUM_SPARSE find_fused_kernel calls
        and its plain version."""
        from repro_torch import HKVTable
        from repro_torch.kernels import ops as kops

        torch, sz = self.torch, self.sz
        n, t_n = sz.batch, NUM_SPARSE
        tables = []
        for _ in range(t_n):
            t = HKVTable.create(capacity=sz.many_capacity, dim=DIM, buckets_per_key=2,
                                score_policy="lru", device=self.dev)
            self.fill(t, 1.0)
            tables.append(t)
        cfg = tables[0].cfg
        counts = [n // t_n + (i < n % t_n) for i in range(t_n)]
        keys = []
        for t, c in zip(tables, counts):
            k = torch.cat([self.resident(t.state.keys, c // 2), self.fresh_keys(c - c // 2)])
            k[::97] = self.u64.EMPTY
            keys.append(k[torch.randperm(c, generator=self.gen, device=self.dev)])
        states = [t.state for t in tables]
        many, got = self.count_launches(lambda: kops.find_many_kernel(states, cfg, keys))
        self.launches_many = got
        if self.dev.type == "cuda":
            require(got == {"find_scan_many": 1}, f"phase 9: find_many_kernel launched {got}")
        solo, got_solo = self.count_launches(
            lambda: [kops.find_fused_kernel(s, cfg, k) for s, k in zip(states, keys)])
        if self.dev.type == "cuda":
            require(got_solo == {"find_scan": t_n}, f"phase 9: {t_n} finds launched {got_solo}")
        for t, (a, b) in enumerate(zip(many, solo)):
            self.check_equal("find_scan_many", a, b, f"table {t} of {t_n} against find_scan")
        probes = [self.find_mod.probe_keys(cfg, k) for k in keys]
        args = ([(s.digests, s.keys, s.scores, s.values) for s in states],
                torch.cat([p.bucket1 for p in probes]), torch.cat([p.bucket2 for p in probes]),
                torch.cat([p.digest for p in probes]), torch.cat(keys), counts)
        out = self.fs.find_scan_many(*args)
        want = self.fs.find_scan_many_plain(*args)
        self.check_equal("find_scan_many", out, want, f"{t_n} tables of {sz.many_capacity} "
                         "slots against the plain version")
        work = {"bytes": 0, "ops": 0}
        start = 0
        for s, p, k, c in zip(states, probes, keys, counts):
            sl = slice(start, start + c)
            w = self.find_work(s, p, k, tuple(x[sl] for x in want), "", s.values)
            work["bytes"] += w["bytes@"]
            work["ops"] += w["ops@"]
            start += c
        t_many = self.time_ms(lambda: self.fs.find_scan_many(*args), sz.timed_runs)
        # the kernel alone in a stream: the entry point launched on
        # buffers made once, without the wrapper's checks of 4 x 26
        # planes and its copy of their addresses
        t_bare = None
        if self.dev.type == "cuda":
            planes, b1, b2, qd, qk, cnt = args
            offs = [0, *torch.tensor(cnt).cumsum(0).tolist()]
            meta = torch.tensor([p[i].data_ptr() for i in range(4) for p in planes] + offs,
                                dtype=torch.int64, device=self.dev)
            outs = [torch.empty_like(x) for x in out]
            row_bytes = planes[0][3].shape[1] * planes[0][3].element_size()
            unit = self._build.copy_unit((row_bytes,), (*(p[3] for p in planes), outs[4]))
            t_bare = self.time_ms(lambda: self._build.launch(
                self.fs.MANY, meta, t_n, meta[4 * t_n:], b1, b2, qd, qk, *outs, n, row_bytes,
                1, unit), sz.timed_runs, calls=STREAM_CALLS)
            bare_out = tuple(outs)
            self.check_equal("find_scan_many", bare_out, want, "the bare entry point")
        t_solo = self.time_ms(lambda: [self.fs.find_scan(*s_, p.bucket1, p.bucket2, p.digest, k)
                                       for s_, p, k in zip(args[0], probes, keys)], sz.timed_runs)
        self.record("find_scan_many", **{
            "ms@1.0": t_many, "plain_ms@1.0": self.time_ms(
                lambda: self.fs.find_scan_many_plain(*args), 2),
            "bytes@1.0": work["bytes"], "ops@1.0": work["ops"],
            "ms_stream@1.0": self.time_ms(lambda: self.fs.find_scan_many(*args), sz.timed_runs,
                                          calls=STREAM_CALLS),
            "ms_solo@1.0": t_solo, "ms_bare_stream@1.0": t_bare,
            "op_ms@1.0": self.time_ms(lambda: kops.find_many_kernel(states, cfg, keys),
                                      sz.timed_runs),
            "op_solo_ms@1.0": self.time_ms(
                lambda: [kops.find_fused_kernel(s, cfg, k) for s, k in zip(states, keys)],
                sz.timed_runs)})
        fm = self.stats["find_scan_many"]
        log(f"phase 9: find_scan_many over {t_n} tables of {sz.many_capacity} slots (λ "
            f"{tables[0].load_factor():.6f}), {n} keys: one launch {t_many:.4f} ms (in a stream "
            f"{fm['ms_stream@1.0']:.4f} ms a call; the bare entry point, no wrapper, "
            f"{fm['ms_bare_stream@1.0'] or 0.0:.4f} ms a call) against "
            f"{t_n} find_scan launches {t_solo:.4f} ms; find_many_kernel {fm['op_ms@1.0']:.3f} "
            f"ms against {t_n} find_fused_kernel calls {fm['op_solo_ms@1.0']:.3f} ms")
        del tables, states, many, solo

    # phase 10 -------------------------------------------------------------

    def phase_sharded(self):
        """The sharded table on the card (see the module note)."""
        self.free()
        self.launches_sharded = {}
        self.sharded_twin(tiered=False)
        self.sharded_twin(tiered=True)
        self.sharded_full()
        log(f"phase 10: kernel launches: {json.dumps(self.launches_sharded)}")

    def sharded_op(self, name, fn, *args, **kwargs):
        """One entry point of the sharded table, its launches checked
        against SHARDED_ROUTES (on the card) and added to phase 10's count.
        claim_scan: once for each shard whose routed batch held a miss lane,
        which the victim stage's calls count."""
        counts = self._build.launch_counts
        before = dict(counts)
        with self.stage_lanes() as lanes:
            out = fn(*args, **kwargs)
        self.sync()
        got = {k: v - before.get(k, 0) for k, v in counts.items() if v != before.get(k, 0)}
        for k, v in got.items():
            self.launches_sharded[k] = self.launches_sharded.get(k, 0) + v
        route = SHARDED_ROUTES[name]
        claims = len(lanes["victim"])
        require(claims <= SHARDS and ("claim_scan" in route or not claims),
                f"phase 10 {name}: {claims} victim stages on {SHARDS} shards")
        want = {k: v for k, v in route.items() if k != "claim_scan"}
        if claims:
            want["claim_scan"] = claims
        if self.dev.type == "cuda":
            require(got == want, f"phase 10 {name}: launches {got}, SHARDED_ROUTES says {want}")
        return out

    def sharded_twin(self, tiered: bool):
        """A (2, 4) mesh of 8 shards, 2^20 slots in all, on 'auto' and
        'plain' (tiered: each shard's hot tier a quarter of it)."""
        from repro_torch import ShardedHKVTable, make_dev_mesh
        from repro_torch.embedding import HKVEmbedding, SparseOptimizer

        torch, sz = self.torch, self.sz
        cap = sz.small_capacity
        kw = dict(capacity=cap, dim=DIM, optimizer=SparseOptimizer("rowwise_adagrad",
                                                                   lr=TRAIN_LR))
        if tiered:
            kw["hot_capacity"] = cap // 4
        mesh = make_dev_mesh(2, 4, device=self.dev)
        tk = ShardedHKVTable.create(mesh, HKVEmbedding(backend="auto", **kw))
        tp = ShardedHKVTable.create(mesh, HKVEmbedding(backend="plain", **kw))
        worst = 0.0
        tag = f"phase 10 twin ({'tiered' if tiered else 'flat'} shards)"

        def same(a, b, ctx, atol=0.0):
            nonlocal worst
            if atol and a.dtype.is_floating_point:
                err = (a - b).abs().max().item() if a.numel() else 0.0
                worst = max(worst, err)
                require(err <= atol, f"{tag} {ctx}: differs by {err}")
            else:
                self.assert_same(a, b, f"{tag} {ctx}")

        def same_states(ctx, atol=0.0):
            for i, (a, b) in enumerate(zip(tk.shards, tp.shards)):
                tiers = ((a.hot, b.hot), (a.cold, b.cold)) if tiered else ((a, b),)
                for x, y in tiers:
                    for f in ("keys", "digests", "scores", "values"):
                        same(getattr(x.state, f).to(self.dev), getattr(y.state, f).to(self.dev),
                             f"{ctx}: shard {i} {f}", atol if f == "values" else 0.0)
                    require((x.state.clock, x.state.epoch) == (y.state.clock, y.state.epoch),
                            f"{tag} {ctx}: shard {i}'s clock")

        n = 4 * sz.small_batch
        hist = torch.zeros(5, dtype=torch.int64)
        for i in range(2 * cap // n + 1):       # past λ 1.0
            keys, vals = self.fresh_keys(n), self.values(n)
            a, b = tk.insert_or_assign(keys, vals), tp.insert_or_assign(keys, vals)
            same(a.status, b.status, f"insert {i}")
            require(int(a.overflow) == int(b.overflow) == 0, f"{tag}: insert {i} overflowed")
            hist += torch.bincount(a.status.long().cpu(), minlength=5)
        require(hist[3] > 0, f"{tag}: nothing evicted past λ 1.0")
        mix = torch.cat([keys[: n // 2], self.fresh_keys(n - n // 2)])
        for name, args in (("find", (mix,)), ("find_or_insert", (mix.flip(0),))):
            a, b = getattr(tk, name)(*args), getattr(tp, name)(*args)
            same(a.values, b.values, f"{name} values")
            same(a.found, b.found, f"{name} found")
        same(tk.contains(mix), tp.contains(mix), "contains")
        same_states("inserts and reads")
        w = self.values(n)
        for t in (tk, tp):
            t.assign(mix, w)
            t.erase(mix[::4])
        pred = self.Pred.key_in_range(0, 2**60)
        require(int(tk.erase_if(pred).swept) == int(tp.erase_if(pred).swept) > 0,
                f"{tag}: erase_if")
        a, b = (t.evict_if(self.Pred.always(), n // 16) for t in (tk, tp))
        for x, y in zip(a.evicted, b.evicted):
            same(x, y, "evict_if stream")
        for x, y in zip(tk.export_batch(0, tk.num_buckets), tp.export_batch(0, tp.num_buckets)):
            same(x, y, "export_batch")
        require(tk.size() == tp.size() > 0, f"{tag}: size")
        sa, sb = tk.stats(), tp.stats()
        same(sa.occupancy_hist, sb.occupancy_hist, "stats")
        same(sa.score_q, sb.score_q, "stats")
        same_states("updaters and sweeps")
        import copy

        import numpy as np

        from repro_torch.models.dlrm import DLRM

        # DLRM steps on phase 5's stream, as its twin: each backend's model
        # takes its own rows' gradients
        rng = np.random.default_rng(SEED + 10)
        gen = torch.Generator(device=self.dev).manual_seed(SEED + 10)
        mk = DLRM(DIM, NUM_SPARSE, DENSE_FEATURES, device=self.dev, generator=gen)
        mp = copy.deepcopy(mk)
        for step in range(3):
            toks, dense_x, labels = self.train_batch(rng, max(sz.train_batch // 4, 2))
            out = []
            for t, m in ((tk, mk), (tp, mp)):
                rows = t.lookup(toks, train=True)[1].detach().requires_grad_(True)
                loss = m.loss(rows, dense_x, labels)
                loss.backward()
                m.sgd_(TRAIN_LR)
                t.apply_grads(toks, rows.grad)
                out.append((rows.detach(), loss.detach()))
            same(out[0][0], out[1][0], f"lookup_train {step}", DUP_SUM_ATOL)
            same(out[0][1], out[1][1], f"loss {step}", DUP_SUM_ATOL)
            same_states(f"train step {step}", DUP_SUM_ATOL)
        same(tk.lookup(toks, train=False)[1], tp.lookup(toks, train=False)[1], "lookup_serve",
             DUP_SUM_ATOL)
        log(f"{tag}: (2, 4) mesh of {tk.n_shards} shards, {tk.capacity} slots"
            + (f" (hot tiers {tk.local.hot_capacity} a shard)" if tiered else "")
            + f", batches of {n}: 'auto' and 'plain' equal in statuses ("
            + ", ".join(f"{STATUS_NAMES[i]} {int(c)}" for i, c in enumerate(hist))
            + "), found flags, overflow, streams, export lanes, sizes, stats and every "
            f"shard's keys, digests and scores; values within {worst:.3g}")
        del tk, tp
        self.free()

    def time_sharded(self, name, fn, inputs) -> float:
        """Median over `inputs` of one call each between stream marks."""
        times = []
        for args in inputs:
            self.sync()
            a = self.mark()
            fn(*args)
            b = self.mark()
            self.sync()
            times.append(self.elapsed_ms(a, b))
        t = statistics.median(times)
        self.sharded_ms[name] = t
        return t

    def sharded_full(self):
        """Config B's embedding on a (8, 1) mesh: 8 shards of 2^24 slots."""
        import numpy as np

        from repro_torch import ShardedHKVTable, make_dev_mesh
        from repro_torch.configs.hkv_dlrm import PAPER_CONFIGS
        from repro_torch.data import zipf_keys
        from repro_torch.models.dlrm import DLRM
        from repro_torch.serving import EmbeddingRequest, OnlineEmbeddingEngine

        torch, sz, u64 = self.torch, self.sz, self.u64
        # at least 512 keys a data shard (the rehearsal's batch is smaller):
        # a routing budget of 128 against a mean of 64 a destination
        n, runs = max(sz.batch, SHARDS * 512), sz.timed_runs
        self.sharded_ms = {}
        emb = dataclasses.replace(PAPER_CONFIGS["B"].embedding(), capacity=sz.capacity)
        t0 = time.perf_counter()
        table = ShardedHKVTable.create(make_dev_mesh(SHARDS, 1, device=self.dev), emb)
        self.sync()
        t_alloc = time.perf_counter() - t0
        local = table.local
        require(table.n_shards == SHARDS and table.capacity == sz.capacity
                and all(s.state.values.shape == (sz.capacity // SHARDS, DIM + 1)
                        for s in table.shards), "phase 10: config B is not 8 x [2^24, 33]")
        log(f"phase 10: config B embedding on a (8, 1) mesh: {SHARDS} shards of "
            f"{local.capacity} slots on {table.device} (V = {DIM + 1}, {emb.optimizer.name}, "
            f"dual, {emb.score_policy}), {sz.capacity} slots in all, allocated in "
            f"{t_alloc:.3f} s")

        def insert(keys, vals):
            r = self.sharded_op("insert_or_assign", table.insert_or_assign, keys, vals)
            require(int(r.overflow) == 0, "phase 10: an insert overflowed its routing budget")
            return r

        def check_find(keys, vals, status, ctx):
            ok = (status >= 1) & (status <= 3)
            half = keys.numel() // 2
            mix = torch.cat([keys[:half], self.fresh_keys(half)])
            r = self.sharded_op("find", table.find, mix)
            require(r.values.shape == (mix.numel(), DIM) and bool(torch.isfinite(r.values).all()),
                    f"phase 10 {ctx}: find values of the wrong shape or not finite")
            require(torch.equal(r.found[:half], ok[:half]) and not bool(r.found[half:].any()),
                    f"phase 10 {ctx}: found is not the admitted keys")
            require(torch.equal(r.values[:half][ok[:half]], vals[:half][ok[:half]])
                    and not bool(r.values[half:].any()), f"phase 10 {ctx}: find values")
            require(int(r.overflow) == 0, f"phase 10 {ctx}: find overflowed")

        t0 = time.perf_counter()
        batches = 0
        for lam in (0.5, 1.0):
            while table.load_factor() < lam:
                keys, vals = self.fresh_keys(n), self.values(n)
                status = insert(keys, vals).status
                batches += 1
            check_find(keys, vals, status, f"λ={lam}")
            log(f"phase 10: λ = {table.load_factor():.6f} after {batches} batches of {n} "
                f"({time.perf_counter() - t0:.3f} s)")
        counts = torch.zeros(5, dtype=torch.int64)
        burst = min(SHARDS * sz.hot_keys, n // 2)
        for i in range(3):   # past λ 1.0, with a burst at one local bucket
            keys = self.fresh_keys(n)
            keys[:burst] = self.hot_bucket_keys(local.config().num_buckets, burst, 4321 + i)
            vals = self.values(n)
            status = insert(keys, vals).status
            counts += torch.bincount(status.long().cpu(), minlength=5)
            check_find(keys, vals, status, f"past λ=1 batch {i}")
        log("phase 10: past λ = 1.0: " + ", ".join(f"{STATUS_NAMES[i]} {int(c)}"
                                                    for i, c in enumerate(counts))
            + "; overflow 0 in every batch")
        require(counts[3] > 0 and counts[4] > 0, "phase 10: no EVICTED or no REJECTED")

        self.time_sharded("find", table.find, [(keys,)] * runs)
        self.time_sharded("insert_or_assign", table.insert_or_assign,
                          [(self.fresh_keys(n), self.values(n)) for _ in range(runs)])
        keys, vals = self.fresh_keys(n), self.values(n)
        status = insert(keys, vals).status
        ok = (status >= 1) & (status <= 3)
        resident = keys[ok][: n // 2]
        h = resident.numel()
        mix = torch.cat([resident, self.fresh_keys(n - h)])
        f = self.sharded_op("find_or_insert", table.find_or_insert, mix)
        require(bool(f.found[:h].all()) and not bool(f.found[h:].any()),
                "phase 10: find_or_insert's found is not the keys resident before it")
        require(torch.equal(f.values[:h], vals[ok][: n // 2]), "phase 10: find_or_insert hits")
        require(torch.equal(f.values[h:], emb.default_rows(mix[h:])),
                "phase 10: find_or_insert's misses are not the init rows")
        self.time_sharded("find_or_insert", table.find_or_insert, [
            (torch.cat([resident[: n // 4], self.fresh_keys(n - n // 4)]),) for _ in range(runs)])
        c = self.sharded_op("contains", table.contains, mix)
        require(torch.equal(c, table.find(mix).found), "phase 10: contains is not find's found")
        self.time_sharded("contains", table.contains, [(mix,)] * runs)

        known = resident[table.contains(resident)]   # those the timed upserts left
        require(known.numel() > 0, "phase 10: no known key is left")
        size0 = table.size()
        e = self.sharded_op("erase_if", table.erase_if, self.Pred.key_in_range(0, 2**60))
        gone = known < 2**60
        require(torch.equal(table.find(known).found, ~gone)
                and int(e.swept) == size0 - table.size() > 0, "phase 10: erase_if")
        self.time_sharded("erase_if", table.erase_if, [
            (self.Pred.key_in_range(2**60 + i * 2**54, 2**60 + (i + 1) * 2**54),)
            for i in range(runs)])
        sizes = [s.size() for s in table.shards]
        budget = min(n // SHARDS, local.capacity // 4)
        v = self.sharded_op("evict_if", table.evict_if, self.Pred.always(), budget)
        want = sum(min(budget, x) for x in sizes)
        require(int(v.count) == want and int(v.evicted.mask.sum()) == want
                and table.size() == sum(sizes) - want, "phase 10: evict_if count")
        fl = u64.flip(v.evicted.scores).reshape(SHARDS, budget)
        live = v.evicted.mask.reshape(SHARDS, budget)
        require(bool((fl[:, 1:] >= fl[:, :-1])[live[:, 1:]].all()),
                "phase 10: a shard's stream is not coldest first")
        require(not bool(table.contains(v.evicted.keys).any()), "phase 10: an evicted key is found")
        self.time_sharded("evict_if", table.evict_if, [(self.Pred.always(), budget)] * runs)
        st = self.sharded_op("stats", table.stats)
        require(int(st.size) == table.size() and st.capacity == sz.capacity
                and int(st.occupancy_hist.sum()) == sz.capacity // 128, "phase 10: stats")
        nb = min(64, table.num_buckets)
        ex = self.sharded_op("export_batch", table.export_batch, 0, nb)
        # the lanes shuffled: shard-major, a data shard's lanes would all go
        # to one owner and overflow its routing budget
        perm = torch.randperm(ex.mask.numel(), generator=self.gen, device=self.dev)
        lanes = torch.where(ex.mask, ex.keys, u64.EMPTY)[perm]
        require(ex.mask.numel() == SHARDS * nb * 128
                and torch.equal(table.contains(lanes), ex.mask[perm]), "phase 10: export_batch")
        log(f"phase 10: find_or_insert {h} hits / {n - h} misses; erase_if swept "
            f"{int(e.swept)}; evict_if {int(v.count)} ({budget} a shard); stats size "
            f"{int(st.size)}, λ {float(st.load_factor):.6f}; export_batch(0, {nb}): "
            f"{int(ex.mask.sum())} live of {ex.mask.numel()} lanes")

        # 5 DLRM steps of phase 5's stream
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        model = DLRM(DIM, NUM_SPARSE, DENSE_FEATURES, device=self.dev, generator=gen)
        rng = np.random.default_rng(SEED)
        steps = {"lookup_train": [], "apply_grads": []}
        for step in range(sz.train_steps):
            toks, dense_x, labels = self.train_batch(rng, sz.train_batch)
            self.sync()
            a = self.mark()
            _t, rows, ovf = self.sharded_op("lookup_train", table.lookup, toks, train=True)
            b = self.mark()
            rows = rows.detach().requires_grad_(True)
            loss = model.loss(rows, dense_x, labels)
            loss.backward()
            model.sgd_(TRAIN_LR)
            c = self.mark()
            self.sharded_op("apply_grads", table.apply_grads, toks, rows.grad)
            d = self.mark()
            self.sync()
            require(bool(torch.isfinite(loss)) and int(ovf) == 0,
                    f"phase 10 step {step}: loss not finite or keys overflowed")
            ms = [self.elapsed_ms(a, b), self.elapsed_ms(b, c), self.elapsed_ms(c, d)]
            if step > 0:
                steps["lookup_train"].append(ms[0])
                steps["apply_grads"].append(ms[2])
            log(f"phase 10 step {step}: {toks.numel()} keys; lookup_train {ms[0]:.3f} ms, "
                f"forward+backward {ms[1]:.3f} ms, apply_grads {ms[2]:.3f} ms; loss "
                f"{float(loss.detach()):.6f}; λ {table.load_factor():.6f}")
        for k, v in steps.items():
            self.sharded_ms[k] = statistics.median(v)

        # 10 admitting and 10 readonly engine waves of 2^16 lanes
        req = sz.serve_samples * NUM_SPARSE
        wrng = np.random.default_rng(SEED + 11)
        for policy in ("admit", "readonly"):
            eng = OnlineEmbeddingEngine(table, wave_size=sz.serve_wave, miss_policy=policy)
            lat, hits = [], []
            for i in range(10):
                keys = zipf_keys(wrng, req, SERVE_ALPHA, 2 * table.capacity)
                eng.submit(EmbeddingRequest(rid=i, keys=keys))
                rep = self.sharded_op(f"{policy} wave", eng.step)
                r = eng.completed[-1]
                require(r.rid == i and r.values.shape == (req, DIM)
                        and bool(np.isfinite(r.values).all()), f"phase 10 {policy} wave {i}")
                lat.append(rep.latency_s * 1e3)
                hits.append(rep.hits / max(rep.size, 1))
            self.sharded_ms[f"{policy} wave"] = statistics.median(lat[1:])
            log(f"phase 10: {policy} waves of {sz.serve_wave} lanes ({req} keys): latency ms "
                + ", ".join(f"{x:.3f}" for x in lat) + "; hit rates "
                + ", ".join(f"{x:.4f}" for x in hits))
        del table, eng
        self.free()
        self.sharded_report()

    def sharded_report(self):
        """Each timed sharded op beside the same op on the unsharded config B
        table of phases 3-5 in this run (when they ran)."""
        un = dict(self.unsharded)
        for k in ("lookup_train", "apply_grads"):
            if f"{k} steps" in un:
                un[k] = statistics.median(un.pop(f"{k} steps"))
        for name, t in self.sharded_ms.items():
            base = un.get(name)
            log(f"phase 10 op {name}: sharded {t:.3f} ms"
                + (f", unsharded {base:.3f} ms, ratio {t / base:.2f}" if base else "")
                + (f" (median of {self.sz.timed_runs})" if "wave" not in name
                   and name not in ("lookup_train", "apply_grads") else
                   f" (median of steps 1-{self.sz.train_steps - 1})" if "wave" not in name
                   else " (median of waves 2-10)"))


    # phase 11 -------------------------------------------------------------

    def lm_argv(self, ckpt_dir, backend: str = "hkv", steps: int = LM_STEPS,
                every: int = LM_CKPT_EVERY, arch: str = LM_ARCH) -> list:
        """The launcher's arguments: the arch's published widths on the
        card (its smoke config in the rehearsal), adamw, seq 4096."""
        sz = self.sz
        return (["--arch", arch, "--backend", backend, "--optimizer", "adamw",
                 "--batch", str(sz.lm_batch), "--seq", str(sz.lm_seq), "--steps", str(steps),
                 "--checkpoint-every", str(every), "--ckpt-dir", str(ckpt_dir),
                 "--seed", str(SEED), "--device", self.dev.type]
                + (["--smoke"] if self.dev.type == "cpu" else []))

    def lm_config(self, arch: str = LM_ARCH, layers=None, *, hkv=True, dtype=None):
        """The arch's LM config (its smoke config in the rehearsal): as the
        launcher's HKV backend runs it, or with `hkv` False as published;
        on the card `layers` cuts each segment's count; `dtype` overrides
        the model's dtype."""
        import dataclasses as dc

        from repro_torch.configs import get_arch

        a = get_arch(arch)
        lm = a.smoke if self.dev.type == "cpu" else a.lm
        if layers is not None and self.dev.type == "cuda":
            lm = dc.replace(lm, segments=tuple(dc.replace(s, count=layers) for s in lm.segments))
        if dtype is not None:
            lm = dc.replace(lm, dtype=dtype)
        return dc.replace(lm, embedding_backend="hkv", tied_head=False) if hkv else lm

    def lm_fresh(self, vocab: int, steps: int):
        """Each step's distinct tokens and whether it holds one no earlier
        step did (the launcher's TokenStream), and all tokens seen."""
        import numpy as np

        from repro_torch.data import TokenStream

        stream = TokenStream(seed=SEED, batch=self.sz.lm_batch, seq=self.sz.lm_seq, vocab=vocab)
        seen: set = set()
        distinct, fresh = [], []
        for step in range(steps):
            toks = np.unique(stream.batch_at(step)[0])
            distinct.append(toks.size)
            fresh.append(bool(len(set(toks.tolist()) - seen)))
            seen.update(toks.tolist())
        return distinct, fresh, seen

    @contextlib.contextmanager
    def lm_capture(self):
        """Wrap gather_rows, scatter_rows and update_scan where kernels/ops.py
        calls them: the lanes each row-kernel launch gets (rows, mask, width
        or mode), and the first update_scan launch's inputs with copies of
        the planes from before it (the warm-up step's, outside the timed
        steps), to hold each against its plain version after the run."""
        from repro_torch.kernels import ops as kops

        calls = {"gather": [], "scatter": [], "update": None}
        saved = kops.gather_rows, kops.scatter_rows, kops.update_scan
        gather_rows, scatter_rows, update_scan = saved

        def gather(values, rows, mask, width=None):
            calls["gather"].append((rows.clone(), mask.clone(), width))
            return gather_rows(values, rows, mask, width)

        def scatter(values, rows, updates, mask, add):
            calls["scatter"].append((rows.clone(), mask.clone(), add))
            return scatter_rows(values, rows, updates, mask, add)

        def update(*args, **kw):
            if calls["update"] is None:
                calls["update"] = ([a.clone() if isinstance(a, self.torch.Tensor) else a
                                    for a in args], dict(kw))
            return update_scan(*args, **kw)

        kops.gather_rows, kops.scatter_rows, kops.update_scan = gather, scatter, update
        try:
            yield calls
        finally:
            kops.gather_rows, kops.scatter_rows, kops.update_scan = saved

    def lm_tally(self, lanes, before=None):
        """A hook called before each step with its batch on the card (the
        TrainDriver's failure injector): the launches and victim stages since
        its last call are the last step's (`hook.per_step`), `hook.walls`
        the wall clock at each call.  `before(step)` runs first; its time
        is kept in `hook.paused` (by the index of the wall span it falls in)
        and left out of `hook.wall_ms()`."""
        counts = self._build.launch_counts
        mark = {}

        def hook(step):
            if before is not None:
                t0 = time.perf_counter()
                before(step)
                hook.paused[len(hook.walls) - 1] = time.perf_counter() - t0
            self.sync()
            hook.walls.append(time.perf_counter())
            now, victims = dict(counts), len(lanes["victim"])
            if mark:
                hook.per_step.append(({k: v - mark["counts"].get(k, 0) for k, v in now.items()
                                       if v != mark["counts"].get(k, 0)},
                                      victims - mark["victims"]))
            mark.update(counts=now, victims=victims)

        hook.per_step, hook.walls, hook.paused = [], [], {}
        hook.wall_ms = lambda: [((b - a) - hook.paused.get(i, 0.0)) * 1e3
                                for i, (a, b) in enumerate(zip(hook.walls, hook.walls[1:]))]
        return hook

    def lm_check_steps(self, tag: str, per_step, metrics, fresh, distinct, vocab: int):
        """Each step's launches against TRAIN_LM_ROUTES (claim_scan only when
        its batch holds a token the table has not seen, the victim stages
        too), its loss finite and under 3 ln(vocab) (an LM near its init
        sits near ln(vocab)) and its overflow 0; one line a step."""
        import numpy as np

        route = {}
        for r in TRAIN_LM_ROUTES.values():
            for k, v in r.items():
                route[k] = route.get(k, 0) + v
        require(len(per_step) == len(metrics), f"{tag}: {len(per_step)} steps counted")
        for step, ((got, claims), m) in enumerate(zip(per_step, metrics)):
            require(claims == int(fresh[step]),
                    f"{tag} step {step}: {claims} victim stages, the batch has "
                    f"{'a' if fresh[step] else 'no'} token the table has not seen")
            want = self.route(route, claims > 0)
            if self.dev.type == "cuda":
                require(got == want, f"{tag} step {step}: launches {got}, TRAIN_LM_ROUTES "
                        f"give {want}")
            require(np.isfinite(m["loss"]) and m["loss"] < 3 * np.log(vocab)
                    and m["emb_overflow"] == 0,
                    f"{tag} step {step}: loss {m['loss']} (bound {3 * np.log(vocab)}), overflow "
                    f"{m['emb_overflow']}")
            log(f"{tag} step {step}: lookup {m['lookup_ms']:.3f} ms, forward+backward "
                f"{m['fwd_bwd_ms']:.3f} ms, clip+adamw {m['opt_ms']:.3f} ms, apply_grads "
                f"{m['apply_ms']:.3f} ms; loss {m['loss']:.6f}, grad norm {m['grad_norm']:.4f}; "
                f"{distinct[step]} distinct tokens; launches {json.dumps(got)}")

    def phase_lm(self):
        """The port's LM training path (see the module note)."""
        import numpy as np

        from repro_torch import tree
        from repro_torch.launch import train
        from repro_torch.models.lm import CompositeLM
        from repro_torch.train import checkpoint as ckpt

        torch, sz = self.torch, self.sz
        self.free()
        lm = self.lm_config()
        n_params = sum(p.numel() for p in tree.leaves(CompositeLM(lm).init(device="meta")))
        cap = train.hkv_capacity(lm.vocab)
        # parameters and adamw's two moments, float32; the table's planes
        ckpt_bytes = 3 * 4 * n_params + cap * ((lm.d_model + 1) * 4 + 17)
        root = ROOT / "runs" / "chip_smoke_lm"
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        free = shutil.disk_usage(root).free
        # two step directories of one run and the third one's .tmp
        require(free >= 3 * ckpt_bytes,
                f"phase 11: {free / 1e9:.1f} GB free under {root}, the checkpoints need "
                f"{3 * ckpt_bytes / 1e9:.1f} GB (3 of {ckpt_bytes / 1e9:.2f} GB)")
        log(f"phase 11: {LM_ARCH} {'smoke config' if self.dev.type == 'cpu' else 'at full width'}"
            f": {lm.num_layers} layers, d_model {lm.d_model}, "
            f"{lm.segments[0].block.heads} heads / {lm.segments[0].block.kv_heads} KV heads, "
            f"d_ff {lm.segments[0].block.d_ff}, vocab {lm.vocab}, {lm.dtype}, "
            f"{n_params} parameters (untied head, no embedding table); HKV table {cap} slots "
            f"at V = {lm.d_model + 1} (rowwise_adagrad), one shard on a (1, 1) mesh; batch "
            f"{sz.lm_batch} x seq {sz.lm_seq} = {sz.lm_batch * sz.lm_seq} tokens a step; cut: "
            f"the train_4k shape's global batch of {LM_GLOBAL_BATCH} to {sz.lm_batch} for one "
            f"card; {free / 1e9:.1f} GB free for checkpoints of ~{ckpt_bytes / 1e9:.2f} GB")
        distinct, fresh, seen = self.lm_fresh(lm.vocab, LM_STEPS)

        # run A: LM_STEPS steps, checkpoints every LM_CKPT_EVERY; the row
        # kernels' lanes are kept to hold them against their plain versions
        counts = self._build.launch_counts
        with self.lm_capture() as row_calls, self.stage_lanes() as lanes:
            hook = self.lm_tally(lanes)
            if self.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            self.sync()
            self._build.reset_counts()
            t0 = time.perf_counter()
            hist_a = train.main(self.lm_argv(root / "a"), failure_injector=hook)
            t_a = time.perf_counter() - t0
            hook(LM_STEPS)
            self.launches_lm = dict(counts)
        peak = torch.cuda.max_memory_allocated() if self.dev.type == "cuda" else 0
        self.lm_check_steps("phase 11 run A", hook.per_step, hist_a["metrics"], fresh, distinct,
                            lm.vocab)
        parts = ("lookup_ms", "fwd_bwd_ms", "opt_ms", "apply_ms")
        med = {k: statistics.median(m[k] for m in hist_a["metrics"][1:]) for k in parts}
        step_ms = statistics.median(sum(m[k] for k in parts) for m in hist_a["metrics"][1:])
        tokens = sz.lm_batch * sz.lm_seq
        # the wall clock at each step's start (its batch on the card), and at
        # the run's end: a step's wall time holds its syncs, the next batch's
        # copy and, after steps 3 and 7, a checkpoint's host copy (the last
        # one's write too, which the run waits for)
        walls = hook.walls
        wall_ms = hook.wall_ms()
        wall_step_ms = statistics.median(wall_ms[1:])
        last = LM_STEPS - 1
        wall_tps = (last - 1) * tokens / (walls[last] - walls[1])
        wall_tps_end = last * tokens / (walls[LM_STEPS] - walls[1])
        log(f"phase 11 run A: medians over steps 1-{last} of the parts' CUDA-event spans: step "
            f"{step_ms:.3f} ms (lookup {med['lookup_ms']:.3f}, forward+backward "
            f"{med['fwd_bwd_ms']:.3f}, clip+adamw {med['opt_ms']:.3f}, apply_grads "
            f"{med['apply_ms']:.3f}); wall time a step {', '.join(f'{x:.3f}' for x in wall_ms)} "
            f"ms (median of steps 1-{last} {wall_step_ms:.3f}); tokens/s over the wall time of "
            f"steps 1-{last - 1} (the step-{LM_CKPT_EVERY} checkpoint inside) {wall_tps:.1f}, of "
            f"steps 1-{last} to the run's end (the last checkpoint written) {wall_tps_end:.1f}; "
            f"distinct tokens a step {statistics.median(distinct[1:])} (of {tokens}), "
            f"{len(seen)} over the run; peak memory {peak / 2**30:.2f} GiB; the run {t_a:.1f} s; "
            f"launches over the run {json.dumps(self.launches_lm)}")
        for p in hist_a["checkpoints"]:
            log(f"phase 11 run A checkpoint at step {p.step}: {p.nbytes} bytes, save_async host "
                f"copy {p.host_copy_s:.3f} s, write {p.write_s:.3f} s "
                f"({p.nbytes / p.write_s / 1e9:.2f} GB/s)")

        # the last checkpoint restored onto run A's final state: bit for bit
        state_a = hist_a["state"]
        self.sync()
        t0 = time.perf_counter()
        restored, extra = ckpt.restore(str(root / "a"), LM_STEPS, state_a)
        self.sync()
        t_restore = time.perf_counter() - t0
        require(extra == {"seed": SEED, "step": LM_STEPS}, f"phase 11: checkpoint extra {extra}")
        self.lm_same(restored, state_a, "phase 11: restore of run A's last checkpoint", exact=True)
        log(f"phase 11: restore of step {LM_STEPS} ({hist_a['checkpoints'][-1].nbytes} bytes) "
            f"{t_restore:.3f} s; every leaf bit for bit the saved state's")
        del restored
        shutil.rmtree(root / "a")
        self.lm_rows(state_a[2].state[0].values, row_calls, "phase 11")
        del row_calls
        self.free()

        # run A2: run A again: what two runs of the same code differ by
        t0 = time.perf_counter()
        hist_a2 = train.main(self.lm_argv(root / "a2"))
        t_a2 = time.perf_counter() - t0
        noise_loss = max(abs(a - b) / abs(a) for a, b in zip(hist_a["loss"], hist_a2["loss"]))
        noise = self.lm_same(hist_a2["state"], state_a, "phase 11 run A2 against run A", exact=False)
        log(f"phase 11 run A2 (run A again, uninterrupted): final table keys, digests, scores "
            f"and occupancy equal run A's; losses within a relative {noise_loss:.3g}, parameters "
            f"within {noise['params']:.3g} (mean {noise['params_mean']:.3g}), table values within "
            f"{noise['values']:.3g} (mean {noise['values_mean']:.3g}), the median row within "
            f"{noise['median_row']:.3g} of its largest element; the run {t_a2:.1f} s")
        del hist_a2
        shutil.rmtree(root / "a2")
        self.free()

        # run B: the same, with a failure at step LM_FAIL_AT (once)
        armed = {"on": True}

        def boom(step):
            if step == LM_FAIL_AT and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected failure")

        t0 = time.perf_counter()
        hist_b = train.main(self.lm_argv(root / "b"), failure_injector=boom)
        t_b = time.perf_counter() - t0
        restores = [s for s, _ in hist_b["restores"]]
        require(hist_b["restarts"] == 1 and restores == [LM_CKPT_EVERY],
                f"phase 11 run B: {hist_b['restarts']} restarts, restored {restores}")
        # steps 0..LM_FAIL_AT-1, then LM_CKPT_EVERY.. replayed
        replay = hist_b["loss"][LM_FAIL_AT:]
        losses_b = hist_b["loss"][:LM_CKPT_EVERY] + replay
        require(len(losses_b) == LM_STEPS, f"phase 11 run B: {len(hist_b['loss'])} losses")
        diffs = self.lm_same(hist_b["state"], state_a, "phase 11 run B against run A", exact=False)
        diffs["loss"] = max(abs(a - b) / abs(a) for a, b in zip(hist_a["loss"], losses_b))
        noise["loss"] = noise_loss
        bounds = {k: max(LM_NOISE_TIMES[k] * noise[k], LM_NOISE_FLOOR[k]) for k in LM_NOISE_TIMES}
        held = "; ".join(f"{k} {diffs[k]:.3g} (A2 {noise[k]:.3g}, bound {bounds[k]:.3g})"
                         for k in LM_NOISE_TIMES)
        require(all(diffs[k] <= bounds[k] for k in LM_NOISE_TIMES),
                f"phase 11 run B against run A, beside run A2's differences: {held}")
        log(f"phase 11 run B: failure at step {LM_FAIL_AT}, restored step {restores[0]} in "
            f"{hist_b['restores'][0][1]:.3f} s, replayed; final table keys, digests, scores "
            f"and occupancy equal run A's; its differences from run A (losses relative, the "
            f"median row relative to its largest element, the rest absolute) beside run A2's: "
            f"{held}; the run {t_b:.1f} s")
        del state_a, hist_a, hist_b
        self.free()

        self.lm_attention()

        # the same shape on the dense backend: what the HKV embedding costs
        t0 = time.perf_counter()
        hist_d = train.main(self.lm_argv(root / "d", "dense", steps=3, every=3))
        t_d = time.perf_counter() - t0
        dense_ms = statistics.median(m["fwd_bwd_ms"] + m["opt_ms"] for m in hist_d["metrics"][1:])
        log(f"phase 11 dense backend (tied {lm.vocab} x {lm.d_model} table in the parameters): "
            f"steps 1-2 median {dense_ms:.3f} ms (forward+backward "
            f"{statistics.median(m['fwd_bwd_ms'] for m in hist_d['metrics'][1:]):.3f}, "
            f"clip+adamw {statistics.median(m['opt_ms'] for m in hist_d['metrics'][1:]):.3f}); "
            f"losses {', '.join(f'{x:.6f}' for x in hist_d['loss'])}; the run {t_d:.1f} s; the "
            f"HKV step over the dense one: {step_ms - dense_ms:+.3f} ms "
            f"({step_ms / dense_ms:.3f}x)")
        del hist_d
        self.free()
        self.lm_profile(root, wall_step_ms)
        shutil.rmtree(root, ignore_errors=True)
        self.free()

    def lm_profile(self, root, wall_step_ms: float, arch: str = LM_ARCH, tag: str = "phase 11",
                   gla: bool = False):
        """One HKV step (after two) under ``torch.profiler`` on the card: the
        device time by operator, and the card's busy share of the profiled
        window's wall time (the step, from its batch on the card to a
        synchronize; the profiler's own cost inflates the window) and of the
        run's median wall step.  With `gla`, the device time split into the
        chunked GLA's (its forward and the remat recompute inside a
        "chunked_gla" range; its backward: the autograd nodes of the
        forward's operators, matched by thread and sequence number),
        `aten::mm`, SDPA and the rest."""
        torch = self.torch
        if self.dev.type != "cuda":
            log(f"{tag} profile: on the card only")
            return
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        from repro_torch.launch import train
        from repro_torch.models import ssm

        driver = train.build(train.parse_args(self.lm_argv(root / "p", steps=3, arch=arch)))
        state = driver.state
        for step in range(2):
            state, _ = driver.step_fn(state, driver.batch_fn(step))
        batch = driver.batch_fn(2)
        chunked_gla = ssm.chunked_gla

        def ranged(*a, **kw):
            with record_function(GLA_RANGE):
                return chunked_gla(*a, **kw)

        self.sync()
        if gla:
            ssm.chunked_gla = ranged
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, _ = driver.step_fn(state, batch)
                self.sync()
                window_ms = (time.perf_counter() - t0) * 1e3
        finally:
            ssm.chunked_gla = chunked_gla
        t0 = time.perf_counter()
        events = prof.key_averages()
        # the device's own events: kernels and copies; the GLA range's span on
        # the device's timeline (a user annotation) is no work of its own
        kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key != GLA_RANGE]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        ops = sorted((e for e in events if e.device_type != DeviceType.CUDA
                      and e.key != GLA_RANGE and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
        log(f"{tag} profile of one HKV step: {device_ms:.3f} ms of device time in a "
            f"{window_ms:.3f} ms window, a busy share of {device_ms / window_ms:.3f} (idle "
            f"{1 - device_ms / window_ms:.3f}); {device_ms / wall_step_ms:.3f} of the run's median "
            f"wall step ({wall_step_ms:.3f} ms); by operator: "
            + ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.3f} ms ({e.count})"
                        for e in ops[:16])
            + f"; the profile's events summed in {time.perf_counter() - t0:.1f} s")
        if gla:
            by = lambda pick: sum(e.self_device_time_total for e in ops if pick(e.key)) / 1e3  # noqa: E731
            mm_ms = by(lambda k: k == "aten::mm")
            # SDPA's forward and backward kernels, whichever backend runs them
            attn = [e for e in kernels
                    if any(w in e.key.lower() for w in ("sdpa", "fmha", "flash", "attn", "attention"))]
            sdpa_ms = sum(e.self_device_time_total for e in attn) / 1e3
            bmm_ms = by(lambda k: k == "aten::bmm")
            fwd_ms, bwd_ms = self.gla_device_ms(prof.events())
            gla_ms = fwd_ms + bwd_ms
            rest = device_ms - gla_ms - mm_ms - sdpa_ms
            log(f"{tag} profile split: the chunked GLA {gla_ms:.3f} ms ({gla_ms / device_ms:.3f}; "
                f"forward and recompute {fwd_ms:.3f}, backward {bwd_ms:.3f}), aten::mm "
                f"{mm_ms:.3f} ms ({mm_ms / device_ms:.3f}), SDPA {sdpa_ms:.3f} ms "
                f"({sdpa_ms / device_ms:.3f}; {len(attn)} kernels, e.g. "
                f"{attn[0].key[:60] if attn else 'none'}), the rest {rest:.3f} ms "
                f"({rest / device_ms:.3f}); aten::bmm (the GLA's einsums) {bmm_ms:.3f} ms")
        del driver, state, batch

    @staticmethod
    def gla_device_ms(events) -> tuple[float, float]:
        """Device ms of the chunked GLA in a profile: the kernels of the
        operators inside the "chunked_gla" ranges (its forward and the remat
        recompute), and those of the backward nodes of the operators the
        forward ranges ran (autograd records each node's forward thread and
        sequence number).  Each operator's own kernels are counted once."""
        def below(roots):
            todo, seen = [c for r in roots for c in r.cpu_children], []
            while todo:
                e = todo.pop()
                seen.append(e)
                todo.extend(e.cpu_children)
            return seen

        from torch.autograd import DeviceType

        ranges = [e for e in events if e.name == GLA_RANGE and e.device_type != DeviceType.CUDA]
        inside = below(ranges)
        seqs = {(e.thread, e.sequence_nr) for e in inside if e.sequence_nr >= 0}
        nodes = [e for e in events if e.name.startswith("autograd::engine::evaluate_function")
                 and (e.fwd_thread, e.sequence_nr) in seqs]
        fwd = sum(e.self_device_time_total for e in inside) / 1e3
        bwd = sum(e.self_device_time_total for e in nodes + below(nodes)) / 1e3
        return fwd, bwd

    def lm_rows(self, values, calls, tag: str):
        """gather_rows and scatter_rows against their plain versions on the
        LM path's own plane (the run's final values, V = d_model + 1) at the
        lanes, mask and width each of the run's launches got, and
        update_scan on the copy of the plane taken before its first launch,
        at that launch's queries and gradients: bit for bit.  scatter_rows
        writes copies of the plane, in the launch's mode, rows drawn once per
        distinct target row (lanes aimed at one row carry the same row, as
        the path's init rows do); the row kernels are timed on the last
        launch's lanes and update_scan on its launch's, each beside its
        bound (bytes over the HBM rate)."""
        torch, runs = self.torch, self.sz.timed_runs
        r_tot, v = values.shape
        if self.dev.type != "cuda":
            log(f"{tag}: the row kernels and update_scan at the path's lanes: on the card only "
                "(the CPU path takes the plain stages)")
            return
        require(calls["gather"] and calls["scatter"] and calls["update"] is not None,
                f"{tag}: the run launched gather_rows {len(calls['gather'])}, scatter_rows "
                f"{len(calls['scatter'])} times and update_scan {'never' if calls['update'] is None else 'once or more'}")
        for i, (rows, mask, width) in enumerate(calls["gather"]):
            self.check_equal("gather_rows", (self.ga.gather_rows(values, rows, mask, width),),
                             (self.ga.gather_rows_plain(values, rows.clamp(0, r_tot - 1), mask,
                                                        width),),
                             f"{tag} LM lookup {i}: {rows.shape[0]} lanes, V={v} width {width or v}")
        for i, (rows, mask, add) in enumerate(calls["scatter"]):
            uniq, inv = torch.unique(rows, return_inverse=True)
            upd = torch.randn((uniq.shape[0], v), generator=self.gen, device=self.dev)[inv]
            got, want = values.clone(), values.clone()
            self.sc.scatter_rows(got, rows, upd.to(values.dtype), mask, add)
            self.sc.scatter_rows_plain(want, rows, upd.to(values.dtype), mask, add)
            self.check_equal("scatter_rows", (got,), (want,),
                             f"{tag} LM lookup {i}: {int(mask.sum())} of {rows.shape[0]} lanes, "
                             f"V={v} {'add' if add else 'set'}")
            del got, want
        es = values.element_size()
        rows, mask, width = calls["gather"][-1]
        n, m, w = rows.shape[0], int(mask.sum()), width or v
        g_bytes = n * (rows.element_size() + 1) + m * w * es + n * w * es
        t_g = self.time_ms(lambda: self.ga.gather_rows(values, rows, mask, width), runs)
        rows_c = rows.clamp(0, r_tot - 1)
        t_gp = self.time_ms(lambda: self.ga.gather_rows_plain(values, rows_c, mask, width), 2)
        rows, mask, add = calls["scatter"][-1]
        n, m = rows.shape[0], int(mask.sum())
        s_bytes = n * (rows.element_size() + 1) + m * v * es * 2
        upd = torch.randn((rows.shape[0], v), generator=self.gen, device=self.dev)
        plane = values.clone()
        t_s = self.time_ms(lambda: self.sc.scatter_rows(plane, rows, upd, mask, add), runs)
        t_sp = self.time_ms(lambda: self.sc.scatter_rows_plain(plane, rows, upd, mask, add), 2)
        # the library call for the same writes: index_put_ of the masked lanes
        rows_m, upd_m = rows[mask], upd[mask].to(plane.dtype)
        t_sl = self.time_ms(lambda: plane.index_put_((rows_m,), upd_m, accumulate=add), runs)
        del plane, upd, rows_m, upd_m
        u = self.lm_update(calls["update"], tag)
        ms = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
        log(f"{tag}: gather_rows ({len(calls['gather'])} launches), scatter_rows "
            f"({len(calls['scatter'])}) and update_scan (the first apply_grads) bit for bit their "
            f"plain versions at the run's lanes on its V = {v} plane; gather_rows at the last "
            f"launch's {n} lanes, width {w}: {t_g:.4f} ms (plain {t_gp:.4f}, bound "
            f"{ms(g_bytes):.4f} by bytes); scatter_rows ({m} of {n} lanes, "
            f"{'add' if add else 'set'}): {t_s:.4f} ms (plain {t_sp:.4f}, library index_put_ "
            f"{t_sl:.4f}, bound {ms(s_bytes):.4f} by bytes); update_scan ({u['lanes']} lanes, {u['found']} found, {u['opt']} at dim "
            f"{u['dim']}): {u['ms']:.4f} ms (plain {u['plain_ms']:.4f}, bound {u['bound']:.4f} by "
            f"{u['by']})")
        self.free()

    def lm_update(self, call, tag: str) -> dict:
        """update_scan against its plain version on two copies of the plane
        taken before the captured launch, at its queries and gradients (bit
        for bit: found flags and the whole plane), then timed on a copy."""
        import types

        args, kw = call
        digests, keys, before, b1, b2, qd, qk, qv, grads, opt, dim = args
        got, want = before.clone(), before.clone()
        f_got = self.up.update_scan(digests, keys, got, b1, b2, qd, qk, qv, grads, opt, dim, **kw)
        f_want = self.up.update_scan_plain(digests, keys, want, b1, b2, qd, qk, qv, grads, opt,
                                           dim, **kw)
        v = before.shape[1]
        self.check_equal("update_scan", (f_got, got), (f_want, want),
                         f"{tag} apply_grads: {qk.shape[0]} lanes, {opt.name} at dim {dim}, V={v}")
        del got, want
        plane = before.clone()
        runs = self.sz.timed_runs
        t = self.time_ms(lambda: self.up.update_scan(digests, keys, plane, b1, b2, qd, qk, qv,
                                                     grads, opt, dim, **kw), runs)
        t_plain = self.time_ms(lambda: self.up.update_scan_plain(digests, keys, plane, b1, b2, qd,
                                                                 qk, qv, grads, opt, dim, **kw), 2)
        del plane
        hit1 = self.find_mod.match_rows(keys, digests, b1, qk, qd, kw.get("use_digest", True))[0]
        work = self.update_work(types.SimpleNamespace(digests=digests, keys=keys),
                                types.SimpleNamespace(bucket1=b1, bucket2=b2, digest=qd), qk, qv,
                                hit1, f_want.bool(), before, dim, opt.name, "lm")
        bound, by = self.bound(work, "lm")
        return {"lanes": qk.shape[0], "found": int(f_want.sum()), "opt": opt.name, "dim": dim,
                "ms": t, "plain_ms": t_plain, "bound": bound, "by": by}

    def lm_same(self, got, want, ctx: str, exact: bool) -> dict:
        """Two train states (params, adamw state, sharded table): the table's
        keys, digests, scores, clock and occupancy must be equal, and with
        `exact` every parameter, moment and value too.  Returns the largest
        and the mean absolute differences of the parameters and of the
        trained rows' values, and the median row's relative to its largest
        element."""
        import numpy as np

        from repro_torch import convert, tree

        torch = self.torch
        (gp, go, gt), (wp, wo, wt) = got, want
        worst = dict.fromkeys(LM_NOISE_TIMES, 0.0)
        total, n_params = 0.0, 0
        for i, (a, b) in enumerate(zip(tree.leaves((gp, go)), tree.leaves((wp, wo)))):
            require(a.dtype == b.dtype and a.shape == b.shape, f"{ctx}: leaf {i}")
            if exact or not a.dtype.is_floating_point:
                require(torch.equal(a, b), f"{ctx}: leaf {i} differs")
            elif i < len(tree.leaves(gp)):
                d = (a.float() - b.float()).abs()
                worst["params"] = max(worst["params"], d.max().item())
                total, n_params = total + d.double().sum().item(), n_params + d.numel()
        worst["params_mean"] = total / max(n_params, 1)
        ga, wa = convert.sharded_state_to_arrays(gt.state), convert.sharded_state_to_arrays(wt.state)
        for f in convert.FIELDS:
            if f == "values" and not exact:
                d = np.abs(ga[f] - wa[f])
                worst["values"] = float(d.max())
                scale = np.abs(wa[f][:, :-1]).max(axis=1)
                live = scale > 0
                worst["values_mean"] = float(d[live, :-1].mean())
                worst["median_row"] = float(np.median(d[live, :-1].max(axis=1) / scale[live]))
            else:
                require(np.array_equal(ga[f], wa[f]), f"{ctx}: table {f} differ")
        require(gt.size() == wt.size(), f"{ctx}: occupancy {gt.size()}, {wt.size()}")
        return worst

    def lm_attention(self):
        """The card's attention (SDPA, what the blocks run there) against the
        port's plain blocked attention, forward and gradient, at qwen2-0.5b's
        head shapes (14 heads, 2 KV heads, dim 64) at the phase's batch and
        sequence, and h2o-danube-1.8b's (32 / 8, dim 80) with its window
        at twice the sequence, batch 1.  Both timed, forward and backward."""
        from repro_torch.models.common import blocked_causal_attention, sdpa_causal_attention

        torch, sz = self.torch, self.sz
        dtype = torch.bfloat16 if self.dev.type == "cuda" else torch.float32
        for name, b, s, hq, hkv, dh, window in (
                ("qwen2-0.5b", sz.lm_batch, sz.lm_seq, 14, 2, 64, None),
                ("h2o-danube-1.8b", 1, sz.swa_seq, 32, 8, 80, sz.swa_window)):
            q, k, v = (torch.randn((b, s, h, dh), generator=self.gen, device=self.dev).to(dtype)
                       for h in (hq, hkv, hkv))
            do = torch.randn((b, s, hq, dh), generator=self.gen, device=self.dev).to(dtype)

            def run(fn):
                qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
                out = fn(qq, kk, vv, window=window)
                return (out.detach(), *torch.autograd.grad(out, (qq, kk, vv), do))

            lib, plain = run(sdpa_causal_attention), run(blocked_causal_attention)
            errs = []
            for what, a, w in zip(("out", "dq", "dk", "dv"), lib, plain):
                rel = ((a.float() - w.float()).norm() / w.float().norm()).item()
                errs.append(f"{what} {rel:.3g} (max abs {(a.float() - w.float()).abs().max().item():.3g})")
                require(rel <= LM_ATTN_RTOL, f"phase 11 attention {name}: {what} differs by a "
                        f"relative {rel} (bound {LM_ATTN_RTOL})")
            t_lib = self.time_ms(lambda: run(sdpa_causal_attention), 3)
            t_plain = self.time_ms(lambda: run(blocked_causal_attention), 3)
            log(f"phase 11 attention {name} (batch {b}, seq {s}, {hq}/{hkv} heads, dim {dh}, "
                f"window {window}, {dtype}): SDPA against the plain blocked form, relative L2 "
                f"error {', '.join(errs)} (bound {LM_ATTN_RTOL}); forward+backward SDPA "
                f"{t_lib:.3f} ms, plain {t_plain:.3f} ms (median of 3)")
            del q, k, v, do, lib, plain
            self.free()


    # phase 12 -------------------------------------------------------------

    def phase_zoo(self):
        """The rest of the model zoo (see the module note): (a) zamba2-1.2b
        through the launcher at its published widths; (b) four more archs a
        warm-up and a timed HKV step each."""
        from repro_torch import tree
        from repro_torch.launch import train
        from repro_torch.models.lm import CompositeLM
        from repro_torch.train import checkpoint as ckpt

        torch, sz = self.torch, self.sz
        self.free()
        lm = self.lm_config(ZOO_ARCH)
        n_params = sum(p.numel() for p in tree.leaves(CompositeLM(lm).init(device="meta")))
        cap = train.hkv_capacity(lm.vocab)
        ckpt_bytes = 3 * 4 * n_params + cap * ((lm.d_model + 1) * 4 + 17)
        root = ROOT / "runs" / "chip_smoke_zoo"
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        free = shutil.disk_usage(root).free
        require(free >= 3 * ckpt_bytes,
                f"phase 12: {free / 1e9:.1f} GB free under {root}, the checkpoints need "
                f"{3 * ckpt_bytes / 1e9:.1f} GB (3 of {ckpt_bytes / 1e9:.2f} GB)")
        mamba, attn = lm.segments[0].block, lm.segments[1].block
        n_mamba = lm.prelude[0].count + lm.segments[0].count * lm.repeats
        log(f"phase 12 (a): {ZOO_ARCH} "
            f"{'smoke config' if self.dev.type == 'cpu' else 'at its published widths'}: "
            f"{n_mamba} mamba2 layers (a prelude of {lm.prelude[0].count}, then {lm.repeats} x "
            f"{lm.segments[0].count}) at d_model {lm.d_model}, d_state {mamba.d_state}, "
            f"{mamba.ssm_heads} SSM heads of {mamba.ssm_headdim}, expand {mamba.expand}, conv "
            f"{mamba.conv_width}; one shared attention block ({attn.heads} heads / "
            f"{attn.kv_heads} KV heads, d_ff {attn.d_ff}, {attn.act}, "
            f"{'gated' if attn.gated else 'ungated'}) invoked {lm.repeats} times; vocab "
            f"{lm.vocab}, {lm.dtype}; {n_params} parameters (untied head, no embedding table); "
            f"HKV table {cap} slots at V = {lm.d_model + 1} (rowwise_adagrad), one shard on a "
            f"(1, 1) mesh; batch {sz.lm_batch} x seq {sz.lm_seq} = {sz.lm_batch * sz.lm_seq} "
            f"tokens a step; cut: the train_4k shape's global batch of {LM_GLOBAL_BATCH} to "
            f"{sz.lm_batch} for one card; {free / 1e9:.1f} GB free for checkpoints of "
            f"~{ckpt_bytes / 1e9:.2f} GB")
        distinct, fresh, seen = self.lm_fresh(lm.vocab, ZOO_STEPS)
        built, restore = {}, {}
        build = train.build

        def capture(args, failure_injector=None):
            built["driver"] = build(args, failure_injector)
            return built["driver"]

        def check_ckpt(step):
            """Before step ZOO_CKPT_EVERY: that step's checkpoint restored
            onto the driver's live state, every leaf bit for bit."""
            if step != ZOO_CKPT_EVERY:
                return
            ckpt.wait_async()
            state = built["driver"].state
            self.sync()
            t0 = time.perf_counter()
            restored, extra = ckpt.restore(str(root / "a"), step, state)
            self.sync()
            restore["s"] = time.perf_counter() - t0
            require(extra == {"seed": SEED, "step": step}, f"phase 12: checkpoint extra {extra}")
            self.lm_same(restored, state, f"phase 12: restore of the step-{step} checkpoint",
                         exact=True)

        counts = self._build.launch_counts
        with self.lm_capture() as calls, self.stage_lanes() as lanes:
            hook = self.lm_tally(lanes, before=check_ckpt)
            if self.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            self.sync()
            self._build.reset_counts()
            train.build = capture
            try:
                t0 = time.perf_counter()
                hist = train.main(self.lm_argv(root / "a", steps=ZOO_STEPS, every=ZOO_CKPT_EVERY,
                                               arch=ZOO_ARCH), failure_injector=hook)
                t_run = time.perf_counter() - t0
                hook(ZOO_STEPS)
            finally:
                train.build = build
            self.launches_zoo = dict(counts)
        del built["driver"]
        peak = torch.cuda.max_memory_allocated() if self.dev.type == "cuda" else 0
        require("s" in restore, f"phase 12: the step-{ZOO_CKPT_EVERY} checkpoint was not restored")
        self.lm_check_steps(f"phase 12 {ZOO_ARCH}", hook.per_step, hist["metrics"], fresh,
                            distinct, lm.vocab)
        parts = ("lookup_ms", "fwd_bwd_ms", "opt_ms", "apply_ms")
        med = {k: statistics.median(m[k] for m in hist["metrics"][1:]) for k in parts}
        step_ms = statistics.median(sum(m[k] for k in parts) for m in hist["metrics"][1:])
        tokens = sz.lm_batch * sz.lm_seq
        wall_ms = hook.wall_ms()
        wall_step_ms = statistics.median(wall_ms[1:ZOO_STEPS - 1])
        log(f"phase 12 {ZOO_ARCH}: medians over steps 1-{ZOO_STEPS - 1} of the parts' CUDA-event "
            f"spans: step {step_ms:.3f} ms (lookup {med['lookup_ms']:.3f}, forward+backward "
            f"{med['fwd_bwd_ms']:.3f}, clip+adamw {med['opt_ms']:.3f}, apply_grads "
            f"{med['apply_ms']:.3f}), {tokens / step_ms * 1e3:.1f} tokens/s of the parts' sum; "
            f"wall time a step {', '.join(f'{x:.3f}' for x in wall_ms)} ms (the checkpoint "
            f"restore before step {ZOO_CKPT_EVERY} left out; median of steps 1-{ZOO_STEPS - 2} "
            f"{wall_step_ms:.3f}); distinct tokens a step {statistics.median(distinct[1:])} (of "
            f"{tokens}), {len(seen)} over the run; peak memory {peak / 2**30:.2f} GiB; the run "
            f"{t_run:.1f} s; launches over the run {json.dumps(self.launches_zoo)}")
        for p in hist["checkpoints"]:
            log(f"phase 12 {ZOO_ARCH} checkpoint at step {p.step}: {p.nbytes} bytes, save_async "
                f"host copy {p.host_copy_s:.3f} s, write {p.write_s:.3f} s "
                f"({p.nbytes / p.write_s / 1e9:.2f} GB/s)")
        log(f"phase 12: restore of the step-{ZOO_CKPT_EVERY} checkpoint (prelude, repeat and "
            f"shared leaves, adamw's moments, the table) onto the live state before step "
            f"{ZOO_CKPT_EVERY}: {restore['s']:.3f} s; every leaf bit for bit")
        self.lm_rows(hist["state"][2].state[0].values, calls, "phase 12")
        del hist, calls
        shutil.rmtree(root / "a")
        self.free()

        t0 = time.perf_counter()
        hist_d = train.main(self.lm_argv(root / "d", "dense", steps=ZOO_DENSE_STEPS,
                                         every=ZOO_DENSE_STEPS, arch=ZOO_ARCH))
        t_d = time.perf_counter() - t0
        dense = hist_d["metrics"][-1]
        dense_ms = dense["fwd_bwd_ms"] + dense["opt_ms"]
        log(f"phase 12 {ZOO_ARCH} dense backend (the tied {lm.vocab} x {lm.d_model} table in "
            f"the parameters): step {ZOO_DENSE_STEPS - 1} {dense_ms:.3f} ms (forward+backward "
            f"{dense['fwd_bwd_ms']:.3f}, clip+adamw {dense['opt_ms']:.3f}); losses "
            f"{', '.join(f'{x:.6f}' for x in hist_d['loss'])}; the run {t_d:.1f} s; the HKV step "
            f"over the dense one: {step_ms - dense_ms:+.3f} ms ({step_ms / dense_ms:.3f}x)")
        require(all(x == x for x in hist_d["loss"]), "phase 12: the dense run's loss is NaN")
        del hist_d
        shutil.rmtree(root / "d")
        self.free()
        t0 = time.perf_counter()
        self.lm_profile(root, wall_step_ms, arch=ZOO_ARCH, tag="phase 12", gla=True)
        log(f"phase 12 profile: {time.perf_counter() - t0:.1f} s with its driver's build and "
            "two steps")
        shutil.rmtree(root, ignore_errors=True)
        self.free()
        self.zoo_gla(lm, med["fwd_bwd_ms"], n_mamba)
        for name, layers in ZOO_OTHERS:
            self.zoo_step(name, layers)

    def zoo_gla(self, lm, fwd_bwd_ms: float, layers: int):
        """The chunked GLA alone at the mamba2 block's shapes (q and k one
        [B, S, N] row broadcast over the heads, v [B, S, H, P] in the model's
        dtype, log a float32), forward and forward+backward timed with CUDA
        events; a layer costs the step its forward, the remat recompute and
        the backward."""
        from repro_torch.models import ssm

        torch, sz, g = self.torch, self.sz, self.gen
        blk = lm.prelude[0].block
        b, s, h, n, p = sz.lm_batch, sz.lm_seq, blk.ssm_heads, blk.d_state, blk.ssm_headdim
        Bm, Cm = (torch.randn((b, s, n), generator=g, device=self.dev).to(lm.dtype)
                  for _ in range(2))
        v, dy = (torch.randn((b, s, h, p), generator=g, device=self.dev).to(lm.dtype)
                 for _ in range(2))
        log_a = -torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=g, device=self.dev) - 2.0)

        def run(Bm, Cm, v, log_a):
            return ssm.chunked_gla(Cm[:, :, None].expand(b, s, h, n),
                                   Bm[:, :, None].expand(b, s, h, n), v, log_a)[0]

        def fwd():
            with torch.no_grad():
                return run(Bm, Cm, v, log_a)

        def fwd_bwd():
            ins = [x.detach().requires_grad_() for x in (Bm, Cm, v, log_a)]
            return torch.autograd.grad(run(*ins), ins, dy)

        t_f, t_fb = self.time_ms(fwd, 3), self.time_ms(fwd_bwd, 3)
        chunk = min(128, s)
        # the four products of a chunk (scores, the intra-chunk and the
        # inter-chunk outputs, the state update), forward, in float32
        flops = 2 * -(-s // chunk) * b * h * (chunk * chunk * (n + p) + 2 * chunk * n * p)
        est = layers * (t_f + t_fb)
        log(f"phase 12 the chunked GLA alone at {ZOO_ARCH}'s shapes (B {b}, S {s}, {h} heads, N "
            f"{n}, P {p}, chunk {chunk}, {lm.dtype} operands, float32 products): forward "
            f"{t_f:.3f} ms ({flops / t_f / 1e9:.2f} TFLOP/s of its products; float32 peak "
            f"{FP32_FLOPS_PER_S / 1e12:.0f}), forward+backward {t_fb:.3f} ms; {layers} layers x "
            f"(forward + the remat recompute + backward) {est:.3f} ms, {est / fwd_bwd_ms:.3f} of "
            f"the run's median forward+backward ({fwd_bwd_ms:.3f} ms)")
        del Bm, Cm, v, dy, log_a
        self.free()

    def zoo_blocks(self, lm, tag: str):
        """Each block kind of `lm` alone at the phase's batch and sequence:
        one forward+backward of ``block_train`` (the block's parameters
        drawn, its input and output gradient random in the model's dtype),
        timed with CUDA events after the model's steps warmed the card."""
        from repro_torch.models.blocks import PosCtx, block_init, block_train

        torch, sz = self.torch, self.sz
        b, s = sz.lm_batch, sz.lm_seq
        pos = PosCtx(positions=torch.arange(s, dtype=torch.int32, device=self.dev).expand(b, s))
        times = []
        for seg in lm.segments:
            params = {k: v.requires_grad_() for k, v in
                      block_init(seg.block, self.gen, self.dev).items()}
            x, dy = (torch.randn((b, s, lm.d_model), generator=self.gen, device=self.dev)
                     .to(lm.dtype) for _ in range(2))

            def run():
                xx = x.detach().requires_grad_()
                y, _ = block_train(seg.block, params, xx, pos)
                return torch.autograd.grad(y, [xx, *params.values()], dy)

            t = self.time_ms(run, 1, warmup=0)
            times.append(f"{seg.block.kind} {t:.1f} ms (x {seg.count * lm.repeats} in the model)")
            del params, x, dy
            self.free()
        log(f"{tag} blocks alone, one forward+backward each at batch {b} x seq {s}: "
            + ", ".join(times))

    def zoo_step(self, name: str, layers):
        """(b): `name` at its published widths (each segment cut to `layers`
        where one card cannot hold it), adamw, the launcher's table; a
        warm-up and a timed step of ``StepBuilder.train_step_hkv`` on the
        launcher's token stream (a vision arch's batch also carries
        vision_tokens patch embeddings and arange M-RoPE positions on all
        three axes).  Each step's launches against TRAIN_LM_ROUTES, the loss
        finite and under 3 ln(vocab), peak memory, and update_scan held
        against its plain version at this arch's V."""
        from repro_torch import ShardedHKVTable, make_dev_mesh, tree
        from repro_torch.configs import get_arch
        from repro_torch.data import TokenStream
        from repro_torch.embedding import HKVEmbedding, SparseOptimizer
        from repro_torch.launch import train
        from repro_torch.models.lm import CompositeLM
        from repro_torch.optim import adamw
        from repro_torch.train.step import StepBuilder

        torch, sz, dev = self.torch, self.sz, self.dev
        self.free()
        t_arch = time.perf_counter()
        arch = get_arch(name)
        lm = self.lm_config(name, layers)
        b, s, d = sz.lm_batch, sz.lm_seq, lm.d_model
        gen = torch.Generator(device=dev).manual_seed(SEED)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        params = CompositeLM(lm).init(gen, device=dev)
        n_params = sum(p.numel() for p in tree.leaves(params))
        opt = adamw()
        opt_state = opt.init(params)
        cap = train.hkv_capacity(lm.vocab)
        table = ShardedHKVTable.create(
            make_dev_mesh(1, 1, device=dev),
            HKVEmbedding(capacity=cap, dim=d, optimizer=SparseOptimizer("rowwise_adagrad", lr=0.05)))
        builder = StepBuilder(CompositeLM(lm), opt)
        stream = TokenStream(seed=SEED, batch=b, seq=s, vocab=lm.vocab)
        distinct, fresh, _ = self.lm_fresh(lm.vocab, ZOO_OTHER_STEPS)
        sv = arch.vision_tokens if dev.type == "cuda" else 8   # the smoke sequence is 32

        def batch_at(step):
            toks, labels = stream.batch_at(step)
            batch = {"tokens": torch.from_numpy(toks).to(dev),
                     "labels": torch.from_numpy(labels).to(dev)}
            if lm.frontend == "vision":
                batch["frontend_embeds"] = torch.randn((b, sv, d), generator=gen, device=dev)
                pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
                batch["mrope_positions"] = pos[None].expand(3, b, s)
            return batch

        metrics = []
        counts = self._build.launch_counts
        with self.lm_capture() as calls, self.stage_lanes() as lanes:
            hook = self.lm_tally(lanes)
            self.sync()
            self._build.reset_counts()
            for step in range(ZOO_OTHER_STEPS):
                batch = batch_at(step)
                hook(step)
                params, opt_state, table, m = builder.train_step_hkv(params, opt_state, table,
                                                                     batch)
                metrics.append({k: float(v) for k, v in m.items()})
            hook(ZOO_OTHER_STEPS)
            for k, v in counts.items():
                self.launches_zoo[k] = self.launches_zoo.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        tag = f"phase 12 {name}"
        self.lm_check_steps(tag, hook.per_step, metrics, fresh, distinct, lm.vocab)
        del params, opt_state, batch
        self.free()
        u = (self.lm_update(calls["update"], tag) if dev.type == "cuda" and calls["update"]
             else None)
        if any(x.block.kind == "slstm" for x in lm.segments):
            self.zoo_blocks(lm, tag)
        m = metrics[-1]
        step_ms = sum(m[k] for k in ("lookup_ms", "fwd_bwd_ms", "opt_ms", "apply_ms"))
        wall = hook.wall_ms()
        cut = (f"; cut: {sum(x.count for x in get_arch(name).lm.segments) * lm.repeats} layers "
               f"to {lm.num_layers} for one card" if layers and dev.type == "cuda" else "")
        seg = lm.segments[0].block
        log(f"{tag} ({arch.family}; {lm.num_layers} layers of "
            + ", ".join(f"{x.count} x {x.block.kind}" for x in lm.segments)
            + f", d_model {d}"
            + (f", {seg.heads}/{seg.kv_heads} heads" if seg.heads else "")
            + (f", MoE {seg.moe.num_experts} experts top-{seg.moe.top_k} d_ff {seg.moe.d_ff}"
               if seg.moe else "")
            + f", vocab {lm.vocab}, {lm.dtype}, {n_params} parameters{cut}; table {cap} slots at "
            f"V = {d + 1}; batch {b} x seq {s}"
            + (f" with frontend_embeds [{b}, {sv}, {d}] and mrope_positions [3, {b}, {s}]"
               if lm.frontend == "vision" else "")
            + f"): warm-up step wall {wall[0]:.1f} ms; timed step {step_ms:.3f} ms of CUDA-event "
            f"spans (lookup {m['lookup_ms']:.3f}, forward+backward {m['fwd_bwd_ms']:.3f}, "
            f"clip+adamw {m['opt_ms']:.3f}, apply_grads {m['apply_ms']:.3f}), wall {wall[1]:.3f} "
            f"ms, {b * s / step_ms * 1e3:.1f} tokens/s of the spans; loss {m['loss']:.6f} (bound "
            f"3 ln(vocab) = {3 * math.log(lm.vocab):.3f}); peak memory {peak / 2**30:.2f} GiB"
            + (f"; update_scan bit for bit its plain version at V = {d + 1} ({u['lanes']} lanes, "
               f"{u['found']} found): {u['ms']:.4f} ms (plain {u['plain_ms']:.4f}, bound "
               f"{u['bound']:.4f} by {u['by']})" if u else "")
            + f"; {time.perf_counter() - t_arch:.1f} s in all")
        del table, calls, builder
        self.free()

    # phase 13 -------------------------------------------------------------

    def step_marks(self):
        """A mark a call: a CUDA event on the card (read after the run), the
        host clock in the rehearsal; `ms(marks)` gives the spans."""
        torch = self.torch

        def mark():
            if self.dev.type == "cuda":
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                return e
            return time.perf_counter()

        def ms(marks):
            self.sync()
            if self.dev.type == "cuda":
                return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        return mark, ms

    def greedy(self, model, params, tokens, max_len: int, steps: int, extras=None):
        """prefill then `steps` greedy decode steps, the argmax staying on
        the device: (prefill ms on the host clock around a sync, the steps'
        ms between CUDA events, the host's ms a step (its enqueue: a step
        waits for nothing), the tokens [B, steps + 1], the state, whether
        every logit was finite)."""
        torch = self.torch
        mark, ms = self.step_marks()
        self.sync()
        t0 = time.perf_counter()
        logits, state = model.prefill(params, tokens, max_len, **(extras or {}))
        self.sync()
        t_pre = (time.perf_counter() - t0) * 1e3
        finite = torch.isfinite(logits).all()
        toks = [logits.argmax(-1).to(torch.int32)]
        marks, host = [mark()], [time.perf_counter()]
        for _ in range(steps):
            logits, state = model.decode_step(params, toks[-1], state)
            finite &= torch.isfinite(logits).all()
            toks.append(logits.argmax(-1).to(torch.int32))
            marks.append(mark())
            host.append(time.perf_counter())
        host_ms = [(b - a) * 1e3 for a, b in zip(host, host[1:])]
        return (t_pre, ms(marks), host_ms, torch.stack(toks, dim=1), state, bool(finite))

    def phase_serve_lm(self):
        """LM serving (see the module note): (a) qwen2-0.5b's prefill_32k
        and decode_32k, the decode attention forms, a sync-free step and a
        step fed by the HKV table's lookup_serve; (b) the wave engine; (c)
        the prefill-then-decode check and a short greedy generation of each
        other arch."""
        import numpy as np

        from repro_torch import tree
        from repro_torch.models.lm import CompositeLM

        torch, sz, dev = self.torch, self.sz, self.dev
        self.free()
        lm = self.lm_config(SERVE_LM_ARCH, hkv=False)
        blk = lm.segments[0].block
        model = CompositeLM(lm)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
        w_bytes = sum(p.numel() * p.element_size() for p in tree.leaves(params))
        n_params = sum(p.numel() for p in tree.leaves(params))
        rng = np.random.default_rng(SEED)
        batch = sz.serve_batch
        while True:
            prompts = torch.from_numpy(rng.integers(0, lm.vocab, size=(batch, sz.serve_prompt))
                                       .astype(np.int32)).to(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            counts = self._build.launch_counts
            self._build.reset_counts()
            try:
                t_pre, steps_ms, host_ms, toks, state, finite = self.greedy(
                    model, params, prompts, sz.serve_max_len, sz.serve_steps)
                break
            except torch.cuda.OutOfMemoryError as e:
                why = str(e).splitlines()[0]
            # out of the handler, so that its frames' tensors are freed
            log(f"phase 13: the prefill of {batch} x {sz.serve_prompt} tokens does not fit "
                f"({why}); halving the batch")
            require(batch > 1, "phase 13: one lane does not fit")
            batch //= 2
            del prompts
            gc.collect()
            self.free()
        dense_counts = {k: v for k, v in counts.items() if v}
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        require(finite, "phase 13: a qwen2 logit is not finite")
        require(toks.shape == (batch, sz.serve_steps + 1), f"phase 13: tokens {toks.shape}")
        require(int(state["pos"]) == sz.serve_max_len, "phase 13: the state's position")
        cache_bytes = sum(x.numel() * x.element_size() for x in tree.leaves(state))
        tokens_pre = batch * sz.serve_prompt
        med = statistics.median(steps_ms)
        ms = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
        bf16_w = n_params * 2
        # the prefill's least time: its products at the bfloat16 peak
        d, hq, hkv, hd, ff = lm.d_model, blk.heads, blk.kv_heads, blk.hd, blk.d_ff
        s = sz.serve_prompt
        per_token = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d + 2 * d * 2 * ff + 2 * ff * d
        attn = 4 * batch * hq * hd * s * (s + 1) / 2
        flops = lm.num_layers * (tokens_pre * per_token + attn) + 2 * batch * d * lm.vocab
        pre_bound = flops / BF16_FLOPS_PER_S * 1e3
        log(f"phase 13 (a): {SERVE_LM_ARCH} "
            f"{'smoke config' if dev.type == 'cpu' else 'at its published widths'} "
            f"({lm.num_layers} layers, d_model {d}, {hq}/{hkv} heads of {hd}, d_ff {ff}, vocab "
            f"{lm.vocab}, {lm.dtype}, {n_params} parameters held in float32, {w_bytes} bytes); "
            f"prefill_32k: {batch} x {sz.serve_prompt} tokens"
            + (f" (cut: the grid's batch of {sz.serve_batch} to {batch}: the larger did not fit)"
               if batch < sz.serve_batch else ""))
        log(f"phase 13 prefill: {t_pre:.3f} ms, {tokens_pre / t_pre * 1e3:.1f} tokens/s; its "
            f"products {flops:.4g} FLOP, bound {pre_bound:.3f} ms by operations at the bfloat16 "
            f"peak ({t_pre / pre_bound:.2f}x)")
        log(f"phase 13 decode_32k: {sz.serve_steps} greedy steps of {batch} lanes to "
            f"{sz.serve_max_len} positions (cut: decode_32k's 128 lanes to the prefill's {batch}): "
            f"median step {med:.3f} ms (min {min(steps_ms):.3f}, max {max(steps_ms):.3f}; first "
            f"{steps_ms[0]:.3f}; the host's median {statistics.median(host_ms):.3f} ms a step), "
            f"{batch / med * 1e3:.1f} tokens/s; decode state {cache_bytes} "
            f"bytes ({cache_bytes / (batch * sz.serve_max_len):.1f} a position a lane); a step's "
            f"least time: state {ms(cache_bytes):.3f} ms + weights as held {ms(w_bytes):.3f} ms "
            f"= {ms(cache_bytes + w_bytes):.3f} ms by bytes ({med / ms(cache_bytes + w_bytes):.2f}x"
            f"; with bfloat16 weights, {bf16_w} bytes: {ms(cache_bytes + bf16_w):.3f} ms); peak "
            f"memory {peak / 2**30:.2f} GiB; kernel launches in the dense run "
            f"{json.dumps(dense_counts)}")
        self.serve_forms(model, params, state, toks[:, -1])
        self.serve_profile(model, params, state, toks[:, -1])
        self.serve_hkv(model, params, state, toks[:, -1])
        del state, toks, prompts
        gc.collect()
        self.free()
        self.serve_engine(model, params)
        self.serve_check(SERVE_LM_ARCH, None, 512 if dev.type == "cuda" else 24, params)
        del params
        gc.collect()
        self.free()
        for name, layers, prompt, tiny in SERVE_LM_OTHERS:
            self.serve_check(name, layers, prompt if dev.type == "cuda" else tiny)
        log("phase 13: llama4-maverick-400b-a17b has no card run (one MoE layer's experts are "
            "64.4 GB in float32; ROADMAP 15b)")

    def serve_forms(self, model, params, state, toks):
        """Decode attention on the qwen2 state's first layer (full context):
        the port's grouped form, the library call for the same function
        (``F.scaled_dot_product_attention`` with a KV head's query heads as
        its queries and the length as a mask: timed for the record, used
        nowhere in the port) and the reference's literal form (both
        operands upcast to float32: a copy of the cache), each timed beside
        the bound of reading the layer's K and V; then one decode step under
        the sync debug mode "error" (a host sync raises)."""
        import torch.nn.functional as F

        from repro_torch.models import common

        torch = self.torch
        kc, vc = state["repeat"][0]["k"][0, 0], state["repeat"][0]["v"][0, 0]
        b, sc, hkv, dh = kc.shape
        hq = model.cfg.segments[0].block.heads
        q = torch.randn((b, 1, hq, dh), generator=self.gen, device=self.dev).to(kc.dtype)
        cur = torch.full((), sc, dtype=torch.int32, device=self.dev)

        def library(q, kc, vc, cur):
            mask = (torch.arange(sc, device=q.device) < cur)[None, None, None]
            out = F.scaled_dot_product_attention(q.reshape(b, hkv, hq // hkv, dh),
                                                 kc.transpose(1, 2), vc.transpose(1, 2),
                                                 attn_mask=mask)
            return out.reshape(b, 1, hq, dh)

        def upcast(q, kc, vc, cur):
            qg = q.reshape(b, 1, hkv, hq // hkv, dh)
            s = common._ein("bqhrd,bkhd->bhrqk", qg, kc) / math.sqrt(dh)
            s = torch.where(torch.arange(sc, device=q.device) < cur, s, common.NEG_INF)
            p = torch.softmax(s, dim=-1).to(vc.dtype)
            return torch.einsum("bhrqk,bkhd->bqhrd", p, vc).reshape(b, 1, hq, dh).to(q.dtype)

        forms = {"grouped": common.decode_attention, "library": library, "upcast": upcast}
        plain = forms["grouped"](q, kc, vc, cur).float()
        errs, times = {}, {}
        for name, fn in forms.items():
            got = fn(q, kc, vc, cur).float()
            errs[name] = ((got - plain).norm() / plain.norm()).item()
            times[name] = self.time_ms(lambda: fn(q, kc, vc, cur), SERVE_LM_FORM_RUNS)
        kv = 2 * kc.numel() * kc.element_size()
        log(f"phase 13 decode attention at the first layer ({b} lanes, {sc} positions, {hq}/{hkv} "
            f"heads of {dh}, {kc.dtype}): " + ", ".join(
                f"{n} {times[n]:.4f} ms (relative L2 from grouped {errs[n]:.3g})" for n in forms)
            + f"; bound {kv / HBM_BYTES_PER_S * 1e3:.4f} ms for its {kv} bytes of K and V")
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits, _ = model.decode_step(params, toks, state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            require(bool(torch.isfinite(logits).all()), "phase 13: the sync-free step's logits")
            log("phase 13: a decode step ran under torch.cuda.set_sync_debug_mode('error'): no "
                "host sync")

    def serve_profile(self, model, params, state, toks, steps: int = 3):
        """`steps` decode steps (after the timed ones) under
        ``torch.profiler``: the device time a step against the window's
        wall time a step (the card's busy share), kernels a step and the
        device time by operator; then the same steps without the profiler,
        the host's enqueue against the wall time to a synchronize."""
        torch = self.torch
        if self.dev.type != "cuda":
            log("phase 13 profile: on the card only")
            return
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                model.decode_step(params, toks, state)
            self.sync()
            window_ms = (time.perf_counter() - t0) * 1e3 / steps
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
        launches = sum(e.count for e in kernels) / steps
        ops = sorted((e for e in events if e.device_type != DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
        self.sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step(params, toks, state)
        t_host = (time.perf_counter() - t0) * 1e3 / steps
        self.sync()
        t_wall = (time.perf_counter() - t0) * 1e3 / steps
        log(f"phase 13 profile of {steps} decode steps at the full context: {device_ms:.3f} ms of "
            f"device time a step in a {window_ms:.3f} ms window, a busy share of "
            f"{device_ms / window_ms:.3f}; {launches:.0f} kernels a step; without the profiler the "
            f"host enqueues a step in {t_host:.3f} ms, {t_wall:.3f} ms a step to a synchronize; by "
            "operator (a step): " + ", ".join(
                f"{e.key} {e.self_device_time_total / 1e3 / steps:.3f} ms ({e.count // steps})"
                for e in ops[:12]))

    def serve_hkv(self, model, params, state, toks):
        """One decode step fed by an HKV table: the model's own embedding
        rows inserted into an HKVEmbedding's table (two slots a token id,
        sgd so V = d_model), the step's embeds from lookup_serve of the
        lanes' tokens (find_scan on the card), on a copy of the state; its
        logits bit for bit the dense step's.  The launch counts are set to 0
        before the lookup and read after the step."""
        from repro_torch import tree
        from repro_torch.embedding import HKVEmbedding, SparseOptimizer
        from repro_torch.launch.train import hkv_capacity

        torch, cfg = self.torch, model.cfg
        emb = HKVEmbedding(capacity=hkv_capacity(cfg.vocab), dim=cfg.d_model,
                           optimizer=SparseOptimizer("sgd"))
        table = emb.create(device=self.dev)
        rows = params["embed"]["table"]
        for ids in torch.arange(cfg.vocab, device=self.dev).split(2**16):
            table.insert_or_assign(emb.keys_of(ids), rows[ids])
        require(int(table.size()) == cfg.vocab, f"phase 13: the table holds {int(table.size())} "
                f"of {cfg.vocab} rows")
        copy = tree.map(torch.clone, state)
        self.sync()
        self._build.reset_counts()
        t0 = time.perf_counter()
        embeds = emb.lookup_serve(table, toks)
        self.sync()
        t_look = (time.perf_counter() - t0) * 1e3
        got, _ = model.decode_step(params, None, copy, embeds=embeds[:, None])
        self.sync()
        self.launches_serve_lm = dict(self._build.launch_counts)
        want, _ = model.decode_step(params, toks, state)
        require(torch.equal(embeds, rows[toks.long()]), "phase 13: lookup_serve's rows")
        require(torch.equal(got, want), "phase 13: the HKV-fed step's logits differ from the "
                "dense step's")
        if self.dev.type == "cuda":
            require(self.launches_serve_lm.get("find_scan", 0) >= 1,
                    f"phase 13: the HKV-fed step launched {self.launches_serve_lm}")
        log(f"phase 13 HKV-fed step: {cfg.vocab} rows in a {emb.capacity}-slot table at V = "
            f"{cfg.d_model}; lookup_serve of {toks.shape[0]} tokens {t_look:.3f} ms; the step's "
            f"logits bit for bit the dense step's; launches {json.dumps(self.launches_serve_lm)}")
        del copy, table

    def serve_engine(self, model, params):
        """ServingEngine over two waves (the second padded with copies of its
        lane 0); each lane's tokens against a standalone greedy loop over
        the same padded batch."""
        import numpy as np

        from repro_torch.serving import Request, ServingEngine

        torch, sz = self.torch, self.sz
        lanes, max_new = SERVE_LM_ENGINE
        rng = np.random.default_rng(SEED + 13)
        prompts = rng.integers(0, model.cfg.vocab, size=(len(max_new), sz.serve_engine_prompt)
                               ).astype(np.int32)
        max_len = sz.serve_engine_prompt + max(max_new)
        eng = ServingEngine(model, params, max_batch=lanes, max_len=max_len)
        for i, m in enumerate(max_new):
            eng.submit(Request(rid=i, prompt=prompts[i], max_new=m))
        self.sync()
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        t_eng = time.perf_counter() - t0
        require(sorted(r.rid for r in done) == list(range(len(max_new))),
                "phase 13: the engine did not complete every request")
        got = {r.rid: r.out for r in done}
        for w in range(0, len(max_new), lanes):
            rids = list(range(w, min(w + lanes, len(max_new))))
            batch = np.stack([prompts[i] for i in rids] + [prompts[rids[0]]] * (lanes - len(rids)))
            toks = self.greedy(model, params, torch.from_numpy(batch).to(self.dev), max_len,
                               max(max_new[i] for i in rids) - 1)[3]
            toks = toks.cpu().numpy()
            for lane, i in enumerate(rids):
                require(got[i] == toks[lane, :max_new[i]].tolist(),
                        f"phase 13: the engine's request {i} differs from the greedy loop")
        log(f"phase 13 ServingEngine: {len(max_new)} requests of {sz.serve_engine_prompt} tokens "
            f"in waves of {lanes} lanes (the second padded), max_new {list(max_new)}: "
            f"{t_eng:.3f} s; every lane's tokens equal a greedy loop over the same padded batch")

    def serve_check(self, name: str, layers, prompt: int, params=None):
        """prefill(t[:n-1]) then decode_step(t[n-1]) against prefill(t) in
        float32 and in bfloat16 (SERVE_F32_RTOL, SERVE_BF16_TIMES), then a
        timed greedy generation of SERVE_LM_OTHER_STEPS steps in the model's
        dtype; a vision arch with its patch embeddings and arange M-RoPE
        positions on all three axes."""
        import numpy as np

        from repro_torch import tree
        from repro_torch.configs import get_arch
        from repro_torch.models.lm import CompositeLM

        torch, dev = self.torch, self.dev
        t_arch = time.perf_counter()
        lm = self.lm_config(name, layers, hkv=False)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if params is None:
            params = CompositeLM(lm).init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
        n_params = sum(p.numel() for p in tree.leaves(params))
        b = SERVE_LM_LANES
        rng = np.random.default_rng(SEED + len(name))
        toks = torch.from_numpy(rng.integers(0, lm.vocab, size=(b, prompt)).astype(np.int32)).to(dev)
        extras, cut = {}, {}
        if lm.frontend == "vision":
            sv = get_arch(name).vision_tokens if dev.type == "cuda" else 8
            pos = torch.arange(prompt, dtype=torch.int32, device=dev).expand(b, prompt)
            extras = {"frontend_embeds": torch.randn((b, sv, lm.d_model), generator=self.gen,
                                                     device=dev),
                      "mrope_positions": pos[None].expand(3, b, prompt)}
            cut = {"frontend_embeds": extras["frontend_embeds"],
                   "mrope_positions": extras["mrope_positions"][..., :-1]}
        logits = {}
        for dtype in (torch.float32, lm.dtype):
            m = CompositeLM(self.lm_config(name, layers, hkv=False, dtype=dtype))
            full, _ = m.prefill(params, toks, prompt, **extras)
            _, st = m.prefill(params, toks[:, :-1], prompt, **cut)
            if dtype == torch.float32:   # the control: the same decode one position behind
                behind = tree.map(torch.clone, st)
                behind["pos"] = behind["pos"] - 1
                planted = m.decode_step(params, toks[:, -1], behind)[0].float()
                del behind
            dec, st = m.decode_step(params, toks[:, -1], st)
            logits[dtype] = (full.float(), dec.float())
            del st
        (f32, d32), (fbf, dbf) = logits[torch.float32], logits[lm.dtype]
        scale = f32.abs().max().item()
        e32 = (d32 - f32).abs().max().item()
        e_planted = (planted - f32).abs().max().item()
        reads_pos = lm.pos_embedding == "sinusoidal" or any(
            s.block.kind == "attn" for s in lm.prelude + lm.segments)
        if reads_pos:
            require(e_planted > SERVE_F32_RTOL * scale, f"phase 13 {name}: a decode one position "
                    f"behind misses the prefill by only {e_planted} (bound "
                    f"{SERVE_F32_RTOL * scale}): the check could not see an off-by-one")
        ebf = (fbf - f32).abs().max().item()
        dbf_err = (dbf - fbf).abs().max().item()
        require(all(bool(torch.isfinite(x).all()) for x in (f32, d32, fbf, dbf)),
                f"phase 13 {name}: a logit is not finite")
        require(e32 <= SERVE_F32_RTOL * scale, f"phase 13 {name}: float32 prefill-then-decode "
                f"differs from the prefill by {e32} (bound {SERVE_F32_RTOL * scale})")
        tol = SERVE_BF16_TIMES * ebf if lm.dtype != torch.float32 else SERVE_F32_RTOL * scale
        require(dbf_err <= tol, f"phase 13 {name}: {lm.dtype} prefill-then-decode differs from "
                f"the prefill by {dbf_err} (bound {tol})")
        del logits, f32, d32, fbf, dbf, planted
        steps = SERVE_LM_OTHER_STEPS if dev.type == "cuda" else 3
        t_pre, steps_ms, host_ms, out, st, finite = self.greedy(
            CompositeLM(lm), params, toks, prompt + steps, steps, extras)
        require(finite, f"phase 13 {name}: a generated logit is not finite")
        state_bytes = sum(x.numel() * x.element_size() for x in tree.leaves(st))
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        med = statistics.median(steps_ms)
        kinds = sorted({s.block.kind for s in lm.prelude + lm.segments})
        win = [s.block.window for s in lm.segments if s.block.window]
        log(f"phase 13 {name} ({lm.num_layers} layers: {', '.join(kinds)}"
            + (f"; cut to {layers} layers a segment" if layers and dev.type == "cuda" else "")
            + (f"; window {win[0]}, ring shift {(prompt - win[0]) % win[0]}" if win and
               prompt >= win[0] else "")
            + f"; {n_params} parameters; {b} lanes x {prompt} tokens): prefill-then-decode against "
            f"the prefill, float32 {e32:.4g} (bound {SERVE_F32_RTOL * scale:.4g}; one position "
            f"behind {e_planted:.4g}{'' if reads_pos else ', no block reads the position'}), "
            f"{lm.dtype} "
            f"{dbf_err:.4g} (bound {tol:.4g}: {SERVE_BF16_TIMES} x its prefill's distance "
            f"{ebf:.4g} from float32); generation: prefill {t_pre:.3f} ms "
            f"({b * prompt / t_pre * 1e3:.1f} tokens/s), {steps} steps median {med:.3f} ms "
            f"({b / med * 1e3:.1f} tokens/s; the host's median {statistics.median(host_ms):.3f} "
            f"ms a step); state {state_bytes} bytes; peak "
            f"{peak / 2**30:.2f} GiB; {time.perf_counter() - t_arch:.1f} s in all")
        del params, st, out
        gc.collect()
        self.free()

    # ----------------------------------------------------------------- report

    # phase 14 -------------------------------------------------------------

    def card_tag(self) -> str:
        """The card's name and power limit, for each number."""
        return f"[{self.card_name()}]" if self.dev.type == "cuda" else "[cpu rehearsal]"

    def events_ms(self, fn) -> tuple:
        """(fn's result, its ms: CUDA events on the card, the host clock in
        the rehearsal)."""
        mark, ms = self.step_marks()
        self.sync()
        a = mark()
        out = fn()
        b = mark()
        return out, ms([a, b])[0]

    def phase_train_stack(self):
        """The rest of the train stack (see the module note)."""
        self.stack_compression()
        self.stack_pipeline()
        self.stack_sharded_step()
        self.stack_dryrun()

    def stack_compression(self):
        """(a) The int8 error-feedback exchange over STACK_POSITIONS data
        positions' full gradient trees."""
        from repro_torch import tree
        from repro_torch.distributed import compression
        from repro_torch.models.lm import CompositeLM
        from repro_torch.train.step import _grad_leaves

        torch, sz, dev = self.torch, self.sz, self.dev
        self.free()
        lm = self.lm_config(LM_ARCH, hkv=False)
        model = CompositeLM(lm)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = model.init(gen, device=dev)
        grads = []
        for _ in range(STACK_POSITIONS):
            toks = torch.randint(0, lm.vocab, (1, sz.lm_seq), generator=gen, device=dev)
            labels = torch.randint(0, lm.vocab, (1, sz.lm_seq), generator=gen, device=dev)
            p, leaves = _grad_leaves(params)
            loss, _ = model.loss(p, toks, labels)
            grads.append(tree.unflatten(params, list(torch.autograd.grad(loss, leaves))))
        del params, p, leaves
        n = sum(g.numel() for g in tree.leaves(grads[0]))
        require(all(g.dtype == torch.float32 for g in tree.leaves(grads[0])),
                "phase 14 (a): the gradients are not float32")
        errs = [compression.init_error_state(g) for g in grads]
        (s1, e1), t_ef = self.events_ms(lambda: compression.ef_compress_grads(grads, errs))
        (s2, e2), t_ef2 = self.events_ms(lambda: compression.ef_compress_grads(grads, e1))
        exact, t_exact = self.events_ms(lambda: tree.map(
            lambda *gs: torch.stack(gs).mean(0), *grads))
        psum, t_psum = self.events_ms(lambda: [compression.compressed_psum(
            [tree.leaves(g)[j] for g in grads]) for j in range(len(tree.leaves(grads[0])))])

        def rel(got, want) -> float:
            """max |got - want| over the tree / max |want| over the tree."""
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            return err / max(float(b.abs().max()) for b in want)

        ex = tree.leaves(exact)
        r1 = rel(tree.leaves(s1[0]), ex)
        ex2 = [torch.stack([g + e for g, e in zip(gs, es)]).mean(0)
               for gs, es in zip(zip(*map(tree.leaves, grads)), zip(*map(tree.leaves, e1)))]
        r2 = rel(tree.leaves(s2[0]), ex2)
        rp = rel([p[0] for p in psum], [x * STACK_POSITIONS for x in ex])
        worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(tree.leaves(s1[0]), ex))
        carried = sum(float(e.abs().sum()) for e in tree.leaves(e2[0]))
        require(max(r1, r2, rp) < COMPRESS_BOUND,
                f"phase 14 (a): compressed results {r1}, {r2}, {rp} from the exact, bound "
                f"{COMPRESS_BOUND}")
        require(carried > 0, "phase 14 (a): the carried error is zero")
        # the same function on the CPU on the same inputs: the embedding table
        # and the first layer's wq (802,816 elements, whole 256-blocks)
        pick = lambda g: {"table": g["embed"]["table"], "wq": g["repeat"][0]["wq"][0, 0]}  # noqa: E731
        cpu_g = [tree.map(lambda x: x.cpu(), pick(g)) for g in grads]
        cs, ce = compression.ef_compress_grads(
            cpu_g, [compression.init_error_state(g) for g in cpu_g])
        for k in ("table", "wq"):
            require(torch.equal(cs[0][k], pick(s1[0])[k].cpu()),
                    f"phase 14 (a): synced {k} differs from the CPU's")
            for i in range(STACK_POSITIONS):
                require(torch.equal(ce[i][k], pick(e1[i])[k].cpu()),
                        f"phase 14 (a): position {i}'s {k} error differs from the CPU's")
        card = self.card_tag()
        log(f"phase 14 (a) compressed exchange {card}: {STACK_POSITIONS} positions' gradient "
            f"trees of {n} float32 elements ({LM_ARCH}, 1 x {sz.lm_seq} tokens each); "
            f"ef_compress_grads step 1 {t_ef:.3f} ms, step 2 (carried error) {t_ef2:.3f} ms, "
            f"compressed_psum {t_psum:.3f} ms, the exact mean (stack and mean) {t_exact:.3f} ms; "
            f"from the exact: step 1 {r1:.6f}, step 2 {r2:.6f}, psum {rp:.6f} (bound "
            f"{COMPRESS_BOUND}; the worst leaf alone {worst:.6f}); carried error |e| sum "
            f"{carried:.6e}; on a wire: int8 all-gather {n * STACK_POSITIONS} B, float32 ring "
            f"{2 * n * 4} B; the table's and the first wq's synced leaves and errors bit for "
            f"bit the CPU's")
        del grads, errs, s1, e1, s2, e2, exact, psum, ex, ex2, cpu_g, cs, ce
        self.free()

    def stack_pipeline(self):
        """(b) The GPipe schedule over the model's decoder layers."""
        from repro_torch import make_mesh, tree
        from repro_torch.distributed import pipeline
        from repro_torch.models.blocks import PosCtx, block_train
        from repro_torch.models.lm import CompositeLM

        torch, sz, dev = self.torch, self.sz, self.dev
        self.free()
        lm = self.lm_config(LM_ARCH, hkv=False)
        seg = lm.segments[0]
        n_layers = seg.count
        k = PIPE_STAGES if n_layers % PIPE_STAGES == 0 else n_layers
        m, s, d = PIPE_MICROBATCHES, sz.lm_seq, lm.d_model
        gen = torch.Generator(device=dev).manual_seed(SEED)
        layers = CompositeLM(lm).init(gen, device=dev)["repeat"][0]   # [1, L, ...] leaves
        stages = tree.map(lambda a: a.reshape((k, n_layers // k) + a.shape[2:]), layers)

        def apply(p, x, count):
            pos = PosCtx(positions=torch.arange(x.shape[1], dtype=torch.int32,
                                                device=dev).expand(x.shape[0], -1))
            for j in range(count):
                x, _ = block_train(seg.block, tree.map(lambda a, j=j: a[j], p), x, pos)
            return x

        def stage_fn(p, x):
            return apply(p, x, n_layers // k)

        xs = torch.randn((m, 1, s, d), generator=gen, device=dev).to(lm.dtype)
        mesh = make_mesh((k,), ("pod",), device=dev)
        flat = tree.map(lambda a: a.reshape((n_layers,) + a.shape[2:]), layers)
        with torch.no_grad():
            # warm-up: the first call of each shape plans its attention and
            # matrix-product kernels (PR 24's first run timed it in the pipeline)
            stage_fn(tree.map(lambda a: a[0], stages), xs[0])
            apply(flat, xs.reshape(m, s, d), 1)
            self.sync()
            got, t_pipe = self.events_ms(lambda: pipeline.pipeline_apply(
                mesh, "pod", stage_fn, stages, xs))
            seq, t_seq = self.events_ms(lambda: torch.stack([
                _chain(stage_fn, [tree.map(lambda a, i=i: a[i], stages) for i in range(k)],
                       xs[i2]) for i2 in range(m)]))
            whole, t_whole = self.events_ms(lambda: apply(flat, xs.reshape(m, s, d), n_layers))
        require(torch.equal(got, seq), "phase 14 (b): the pipeline differs from the layers "
                "applied microbatch by microbatch")
        diff = float((got.reshape(m, s, d).float() - whole.float()).abs().max())
        scale = float(whole.float().abs().max())
        require(torch.isfinite(got).all() and diff <= PIPE_BATCHED_TOL * scale,
                f"phase 14 (b): pipelined against the whole batch {diff} (bound "
                f"{PIPE_BATCHED_TOL} x {scale})")
        log(f"phase 14 (b) pipeline {self.card_tag()}: {n_layers} {seg.block.kind} layers as "
            f"{k} stages of {n_layers // k}, {m} microbatches of 1 x {s} x {d} {lm.dtype}, "
            f"forward: pipeline_apply {t_pipe:.3f} ms ({m + k - 1} ticks of {k} stages), the "
            f"microbatches in sequence {t_seq:.3f} ms (ratio {t_pipe / t_seq:.4f}; the schedule's "
            f"work predicts (M + K - 1) / M = {(m + k - 1) / m:.4f}), the whole batch at once "
            f"{t_whole:.3f} ms; bit for bit the sequence; against the whole batch max |diff| "
            f"{diff:.6g} of max |out| {scale:.6g} (bound {PIPE_BATCHED_TOL}); one card: the "
            f"stages take turns, so this is no measurement of several cards")
        del layers, stages, flat, xs, got, seq, whole
        self.free()

    def stack_sharded_step(self):
        """(c) make_sharded_train_step on a (2, 4) mesh against the
        builder's step."""
        from repro_torch import ShardedHKVTable, make_dev_mesh, tree
        from repro_torch.data import TokenStream
        from repro_torch.embedding import HKVEmbedding, SparseOptimizer
        from repro_torch.launch import train
        from repro_torch.models.lm import CompositeLM
        from repro_torch.optim import adamw
        from repro_torch.train.step import StepBuilder, make_sharded_train_step

        torch, sz, dev = self.torch, self.sz, self.dev
        self.free()
        lm = self.lm_config(LM_ARCH)
        model = CompositeLM(lm, attention="blocked")
        mesh = make_dev_mesh(2, 4, device=dev)
        shards = 8
        cap = train.hkv_capacity(lm.vocab)
        emb = HKVEmbedding(capacity=cap, dim=lm.d_model,
                           optimizer=SparseOptimizer("rowwise_adagrad", lr=0.05))
        toks, labels = TokenStream(seed=SEED, batch=sz.lm_batch, seq=sz.lm_seq,
                                   vocab=lm.vocab).batch_at(0)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        builder = StepBuilder(model, adamw())

        def run(step_fn):
            params = model.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
            opt_state = builder.optimizer.init(params)
            table = ShardedHKVTable.create(mesh, emb)
            params, opt_state, table, m = step_fn(params, opt_state, table, batch)
            return params, m, table

        step = make_sharded_train_step(builder, mesh, model.init(device="meta"), hkv=True)
        with self.stage_lanes() as lanes:
            self.sync()
            self._build.reset_counts()
            (p1, m1, t1), t_step = self.events_ms(lambda: run(step))
            self.sync()
            counts = dict(self._build.launch_counts)
        for key, v in counts.items():
            self.launches_stack[key] = self.launches_stack.get(key, 0) + v
        p2, m2, t2 = run(builder.train_step_hkv)
        route = {}
        for r in TRAIN_LM_ROUTES.values():
            for key, v in r.items():
                route[key] = route.get(key, 0) + shards * v
        claims = len(lanes["victim"])
        require(claims == shards, f"phase 14 (c): {claims} victim stages, a fresh table's "
                f"{shards} shards each have miss lanes")
        if dev.type == "cuda":
            require(counts == route, f"phase 14 (c): launches {counts}, {shards} x "
                    f"TRAIN_LM_ROUTES give {route}")
        same = [torch.equal(m1["loss"], m2["loss"]), torch.equal(m1["grad_norm"], m2["grad_norm"])]
        same += [torch.equal(a, b) for a, b in zip(tree.leaves(p1), tree.leaves(p2))]
        for a, b in zip(t1.state, t2.state):
            same += [torch.equal(a.keys, b.keys), torch.equal(a.digests, b.digests),
                     torch.equal(a.scores, b.scores)]
        require(all(same), f"phase 14 (c): {same.count(False)} of loss, grad norm, "
                "parameters and table planes differ from train_step_hkv's")
        require(bool(torch.isfinite(m1["loss"])) and int(m1["emb_overflow"]) == 0,
                f"phase 14 (c): loss {float(m1['loss'])}, overflow {int(m1['emb_overflow'])}")
        log(f"phase 14 (c) sharded step {self.card_tag()}: make_sharded_train_step on "
            f"{mesh}, {LM_ARCH} ({lm.num_layers} layers, d_model {lm.d_model}, blocked attention), "
            f"table {cap} slots in {shards} shards, batch {sz.lm_batch} x {sz.lm_seq}: loss "
            f"{float(m1['loss']):.6f}, grad norm {float(m1['grad_norm']):.6f}, step (with its "
            f"state's set-up) {t_step:.3f} ms (lookup {m1['lookup_ms']:.3f}, forward+backward "
            f"{m1['fwd_bwd_ms']:.3f}, clip+adamw {m1['opt_ms']:.3f}, apply_grads "
            f"{m1['apply_ms']:.3f}); launches {json.dumps(counts)} = {shards} x TRAIN_LM_ROUTES; "
            f"loss, grad norm, {len(tree.leaves(p1))} parameter leaves and every shard's keys, "
            f"digests and scores bit for bit train_step_hkv's")
        del p1, p2, t1, t2
        self.free()

    def stack_dryrun(self):
        """(d) The dry run's bytes against the card's, and its CLI."""
        import dataclasses as dc

        from repro_torch import make_dev_mesh, tree
        from repro_torch.configs import get_arch
        from repro_torch.configs.common import ShapeCfg
        from repro_torch.launch import dryrun
        from repro_torch.models.lm import CompositeLM
        from repro_torch.optim import adamw

        torch, sz, dev = self.torch, self.sz, self.dev
        self.free()
        arch = get_arch(LM_ARCH)
        if dev.type == "cpu":
            arch = dc.replace(arch, lm=arch.smoke)
        shape = ShapeCfg(f"train_{sz.lm_batch}x{sz.lm_seq}", "train", sz.lm_seq, sz.lm_batch)
        want = dryrun.build_cell(arch, shape, make_dev_mesh(1, 1, device="meta")).argument_bytes()
        before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        params = CompositeLM(arch.lm).init(torch.Generator(device=dev).manual_seed(SEED),
                                           device=dev)
        opt_state = adamw().init(params)
        batch = {k: torch.zeros((sz.lm_batch, sz.lm_seq), dtype=torch.int32, device=dev)
                 for k in ("tokens", "labels")}
        self.sync()
        after = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        storages = {}
        for t in tree.leaves([params, opt_state, batch]):
            require(t.device.type == dev.type, f"phase 14 (d): a leaf on {t.device}")
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        held = sum(storages.values())
        require(held == want, f"phase 14 (d): the card holds {held} bytes, the dry run counts "
                f"{want}")
        out = ROOT / "runs" / "chip_smoke_dryrun"
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                               LM_ARCH, "--shape", "train_4k", "--mesh", "single", "--out",
                               str(out)], cwd=str(ROOT), capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=600)
        t_cli = time.perf_counter() - t0
        require(proc.returncode == 0, f"phase 14 (d): the dry run failed: {proc.stderr[-2000:]}")
        rec = json.loads((out / "single" / f"{LM_ARCH}__train_4k__dense.json").read_text())
        require(rec["memory"]["argument_bytes_per_device"] > 0 and rec["devices"] == 256,
                f"phase 14 (d): record {rec}")
        log(f"phase 14 (d) dry run {self.card_tag()}: {shape.name} on a (1, 1) mesh counts "
            f"{want} argument bytes; the card holds {held} bytes in {len(storages)} tensors "
            f"(parameters, adamw state, batch; the allocator's count rose by {after - before}); "
            f"python -m repro_torch.launch.dryrun --arch {LM_ARCH} --shape train_4k --mesh "
            f"single: {t_cli:.1f} s, record {json.dumps(rec)}")
        del params, opt_state, batch
        self.free()

    def report(self):
        for name, st in sorted(self.stats.items()):
            log(f"parity {name}: bit-identical to the plain version in {len(st['checks'])} "
                f"comparisons ({'; '.join(st['checks'])}), max abs err {st['max_abs_err']}")
        for lam, (f, i) in self.throughput.items():
            log(f"throughput λ={lam}: find {f:.4f} B-KV/s, insert_or_assign {i:.4f} B-KV/s")
        for name, st in sorted(self.stats.items()):
            for lam in (0.5, 1.0, "1.0 single", "1.0 V=33", "1.0 V=33 width 32", "1.0 bf16",
                        "1.0 bf16 width 16", *(f"dim {d}" for d in WIDE_DIMS), "bf16"):
                if f"ms@{lam}" not in st:
                    continue
                bound, by = self.bound(st, lam)
                where = f"λ={lam}" if str(lam)[0].isdigit() else lam
                stream = (f" ({st[f'ms_stream@{lam}']:.4f} ms a call in a stream of "
                          f"{STREAM_CALLS})" if f"ms_stream@{lam}" in st else "")
                log(f"kernel {name} {where}: {st[f'ms@{lam}']:.4f} ms{stream}, plain "
                    f"{st[f'plain_ms@{lam}']:.4f} ms, bound {bound:.4f} ms by {by} (bytes "
                    f"{self.bytes_ms(st, lam):.4f} ms, operations {self.ops_ms(st, lam):.4f} ms)"
                    + (f", library {st[f'library_ms@{lam}']:.4f} ms" if f"library_ms@{lam}" in st else ""))
        ds = self.stats["digest_scan"]
        for tag in (0.5, 1.0):
            bound, by = self.bound({"bytes@": ds[f"bytes_dual@{tag}"],
                                    "ops@": ds[f"ops_dual@{tag}"]}, "")
            log(f"digest_scan λ={tag}: single-row form {ds[f'ms@{tag}']:.4f} ms "
                f"({ds[f'ms_stream@{tag}']:.4f} ms a call in a stream of {STREAM_CALLS}); dual "
                f"form over both rows {ds[f'ms_dual@{tag}']:.4f} ms ({ds[f'ms_dual_stream@{tag}']:.4f} "
                f"ms a call in a stream), plain {ds[f'plain_ms_dual@{tag}']:.4f} ms, bound "
                f"{bound:.4f} ms by {by}")
        if self.dev.type == "cuda":
            rate = self.link
            for name, keys in (("gather_rows", ("", f"_w{CONFIG_D_DIM}")),
                               ("scatter_rows", ("", "_add"))):
                st = self.stats[name]
                log(f"{name} on the host plane (config D, V = {CONFIG_D_DIM + 1}, 2^20 lanes "
                    f"half masked): " + ", ".join(
                        f"{k or 'whole rows' if name == 'gather_rows' else k or 'set'} "
                        f"{st[f'ms_host{k}@1.0 hmem']:.4f} ms against "
                        f"{st[f'link_bytes{k}@1.0 hmem'] / rate * 1e3:.4f} ms for its "
                        f"{st[f'link_bytes{k}@1.0 hmem']} bytes over the host link"
                        for k in keys) + f" ({rate / 1e9:.3f} GB/s measured)"
                    + (f"; whole rows from 2^20 neighbouring rows {st['ms_host_seq@1.0 hmem']:.4f} ms"
                       if name == "gather_rows" else ""))
        up = self.stats["upsert_probe"]
        for lam in (0.5, 1.0):
            by_mode = []
            for mode in ("match", "target", "target_gated"):
                key = f"_{mode}@{lam}"
                bound, by = self.bound({"bytes@": up[f"bytes{key}"], "ops@": up[f"ops{key}"]}, "")
                lanes = f" on {up[f'lanes{key}']} lanes" if f"lanes{key}" in up else ""
                by_mode.append(f"{mode}{lanes} {up[f'ms{key}']:.4f} ms (bound {bound:.4f} ms by "
                               f"{by})")
            log(f"upsert_probe λ={lam} by mode: both {up[f'ms@{lam}']:.4f} ms, "
                + ", ".join(by_mode) + f"; match in a stream of {STREAM_CALLS} calls "
                f"{up[f'ms_match_stream@{lam}']:.4f} ms a call")
            log(f"find_scan λ={lam} in a stream of {STREAM_CALLS} calls: "
                f"{self.stats['find_scan'][f'ms_stream@{lam}']:.4f} ms a call, against "
                f"{self.stats['find_scan'][f'ms@{lam}']:.4f} ms for one call")
        sw = self.stats["sweep_match"]
        for lam in (0.5, 1.0, "1.0 single"):
            by_kind = []
            for k in SWEEP_KINDS:
                bound, by = self.bound({"bytes@": sw[f"bytes_{k}@{lam}"],
                                        "ops@": sw[f"ops_{k}@{lam}"]}, "")
                by_kind.append(f"{k} {sw[f'ms_{k}@{lam}']:.4f} ms (bound {bound:.4f} ms by {by})")
            log(f"sweep_match λ={lam} by kind: " + ", ".join(by_kind))
        for name, mode, lam, t in self.op_times:
            rate = ("a whole-table sweep" if name in ("erase_if", "evict_if") else
                    f"{self.sz.batch / t / 1e6:.4f} B-KV/s at {self.sz.batch} keys")
            log(f"op {name} ({mode}) from λ {lam:.6f}: {t:.3f} ms ({rate}; median of "
                f"{self.sz.timed_runs})")
        up = self.stats["update_scan"]
        for lam in (0.5, 1.0, *(f"dim {d}" for d in WIDE_DIMS), "bf16"):
            where = (f"λ={lam} (config B, dim {DIM})" if isinstance(lam, float) else
                     f"{lam} (2^20-slot table, λ 1.0" + (f", dim {DIM})" if lam == "bf16" else ")"))
            log(f"update_scan {where} by optimizer and mode: " + ", ".join(
                f"{o} {m} {up[f'ms_{o}_{m}@{lam}']:.4f} ms" for o in OPTIMIZERS
                for m in ("dual", "single")))
        if self.train_cmp:
            log(f"gradient step at config B: fused {self.train_cmp['fused']:.3f} ms against "
                f"composed {self.train_cmp['composed']:.3f} ms")
        cs = self.stats["claim_scan"]
        main = {f"{k}@": cs[f"{k}_main@1.0"] for k in ("bytes", "ops")}
        bound, by = self.bound(main, "")
        log(f"claim_scan on the λ=1.0 insert_or_assign's own {cs['lanes_main@1.0']} miss lanes "
            f"(ranks 0, 1, 2, 3, >=4: {cs['rank_hist_main@1.0']}): {cs['ms_main@1.0']:.4f} ms, "
            f"bound {bound:.4f} ms by {by}")
        sr = self.stats["scatter_rows"]
        bound, by = self.bound({"bytes@": sr["bytes_v33@1.0"], "ops@": 0}, "")
        log(f"scatter_rows at V=33 (phase 5 plane): {sr['ms_v33@1.0']:.4f} ms, plain "
            f"{sr['plain_ms_v33@1.0']:.4f} ms, library {sr['library_ms_v33@1.0']:.4f} ms, the "
            f"stores alone (index_fill_) {sr['fill_ms_v33@1.0']:.4f} ms, bound {bound:.4f} ms by "
            f"{by}; at V=32 (phase 1, λ=1.0) {sr['ms@1.0']:.4f} ms, the stores alone "
            f"{sr['fill_ms@1.0']:.4f} ms; on the bfloat16 V=32 plane {sr['ms_bf16@1.0']:.4f} ms, "
            f"library {sr['library_ms_bf16@1.0']:.4f} ms")
        for lam in (0.5, 1.0):
            log(f"claim_scan λ={lam}: every query on one cached row {cs[f'ms_one_row@{lam}']:.4f} ms "
                f"against {cs[f'ms@{lam}']:.4f} ms spread over the table; its own s*s compare loop "
                f"at the int32 rate {cs[f'loop_ops@{lam}'] / INT32_OPS_PER_S * 1e3:.4f} ms")
        self.card_line()

    def card_name(self) -> str:
        """The card's name and power limit, as nvidia-smi gives them."""
        if not hasattr(self, "_card"):
            self._card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        return self._card

    def card_line(self):
        if self.dev.type == "cuda":
            log(self.card_name())

    @staticmethod
    def bytes_ms(st, lam) -> float:
        return st[f"bytes@{lam}"] / HBM_BYTES_PER_S * 1e3

    @staticmethod
    def ops_ms(st, lam) -> float:
        """int32 operations at the int32 rate, plus float32 ones (where a
        kernel counts them) at the float32 rate."""
        return (st[f"ops@{lam}"] / INT32_OPS_PER_S + st.get(f"flops@{lam}", 0) / FP32_FLOPS_PER_S) * 1e3

    def bound(self, st, lam) -> tuple[float, str]:
        """The least time for the work: the larger of the bytes' and the
        operations' time, and which of the two it is."""
        b, o = self.bytes_ms(st, lam), self.ops_ms(st, lam)
        return (b, "bytes") if b >= o else (o, "operations")

    def kernel_rows(self) -> list[dict]:
        """One entry per kernel, from this run's λ = 1.0 dual-bucket
        measurements (update_scan: rowwise_adagrad, config B's optimizer)."""
        meta = {
            "find_scan": ("src/repro_torch/csrc/find_scan.cu", "src/repro/kernels/find_scan.py:350"),
            "upsert_probe": ("src/repro_torch/csrc/upsert_scan.cu", "src/repro/kernels/upsert_scan.py:98"),
            "claim_scan": ("src/repro_torch/csrc/upsert_scan.cu", "src/repro/kernels/upsert_scan.py:189"),
            "scatter_rows": ("src/repro_torch/csrc/scatter.cu", "src/repro/kernels/scatter.py:37"),
            "gather_rows": ("src/repro_torch/csrc/gather.cu", "src/repro/kernels/gather.py:34"),
            "digest_scan": ("src/repro_torch/csrc/digest_scan.cu",
                            "src/repro/kernels/digest_scan.py:159"),
            "sweep_match": ("src/repro_torch/csrc/sweep_scan.cu",
                            "src/repro/kernels/sweep_scan.py:55"),
            "update_scan": ("src/repro_torch/csrc/update_scan.cu",
                            "src/repro/kernels/update_scan.py:282"),
            "bucket_stats": ("src/repro_torch/csrc/score_scan.cu",
                             "src/repro/kernels/score_scan.py:46"),
            # find_scan's multi-table entry: the reference's find_many_kernel
            # (src/repro/kernels/ops.py:249) launches find_scan_pipeline
            "find_scan_many": ("src/repro_torch/csrc/find_scan.cu",
                               "src/repro/kernels/find_scan.py:350"),
        }
        rows = []
        for name, (source, replaces) in meta.items():
            st = self.stats[name]
            bound, by = self.bound(st, 1.0)
            # launches: the main path's phase 3 for its four kernels, the
            # rest of the op surface's phase 4 for the kernels it added, the
            # training path's phase 5 for update_scan, each with the serving
            # path's phase 8; no op calls bucket_stats, so no path launches it;
            # find_scan_many: phase 9's counted find_many_kernel call; and
            # each with the sharded table's phase 10, the LM paths' phases
            # 11 and 12, LM serving's phase 13 (find_scan, the HKV
            # embedding's lookup_serve) and the sharded step of phase 14
            path = (self.launches_many if name == "find_scan_many" else
                    self.launches if name in self.launches else
                    self.launches_train if name == "update_scan" else self.launches_rest)
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": (path.get(name, 0) + self.launches_serve.get(name, 0)
                             + self.launches_sharded.get(name, 0)
                             + self.launches_lm.get(name, 0)
                             + self.launches_zoo.get(name, 0)
                             + self.launches_serve_lm.get(name, 0)
                             + self.launches_stack.get(name, 0)),
                "max_abs_err": st["max_abs_err"],
                "ms": st["ms@1.0"], "plain_ms": st["plain_ms@1.0"],
                "bound_ms": bound, "bound_by": by,
                "library_ms": st.get("library_ms@1.0"),
            })
        return rows


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
