#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py                  # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --phases exact   # build + the named phases only
    python3 chip_smoke.py --package OTHER  # drive another checkout's package

Phases, in order (any failure makes the run exit non-zero):

1. build   — nvcc builds the kernel library from src/repro_torch/kernels/csrc
             into build/repro_torch/, one process per source (seconds printed).
2. exact   — every kernel against its plain version on integer-valued data,
             bit for bit: knn_scan (also on every third row read in place, as
             a pilot reads them, and bounded by that pilot's bound, its
             answer the unbounded one), knn_merge and knn_fused (values in [-8, 8]
             with planted duplicate rows, +inf-norm rows and a ragged N, for
             l2/ip/cos, f32 and bf16, k in {1, 7, 72, 1024}, m in {1, 16}, and
             in two adversarial row orders for l2/ip, f32 and bf16, k in
             {1, 72, 1024}, m in {1, 16}: farthest from query 0 first, so the
             survivor buffer overflows, and all rows equal, so only index
             ties decide); knn_merge alone on queues built to stress its
             threshold (every answer pair in one queue, most queues empty,
             all values equal, integer ties with -0.0/+0.0) at (m, S, k) up
             to (16, 123, 8192), one launch per call; knn_int8_scan (rows
             in [-127, 127] whose int8 scale is 1, so only sqrt and the
             square round, k in {1, 7, 72, 1024}: q_len 8 to
             8192, m in {1, 16}, codes never padded to the n-block; rows in
             random order, farthest from query 0 first so that every lane
             survives the filter and its buffer overflows, and all equal so
             that only index ties decide; at the card's S and at S = 1);
             l2dist (f32 and bf16, m in {1, 16, 37, 300}: both sides of
             the stream/tiled crossover, ragged against the 128-row tiles,
             ragged N; through the entry point and each of its two kernels,
             one launch each); topk (k in
             {1, 72, 1024}, ragged M and N: integer scores with ties and
             -0.0/+0.0, scores descending along N, all equal, +inf lanes).
             Values, indices and skip counts must be bit-identical (d = 960:
             every sum is below 2^24).
3. gist    — GIST shape, FQ-SD: N = 1,000,000, d = 960, m = 16, k = 1024
             through ExactKNN(backend="cuda").fit(x).search(...). A split
             scans 4,096 rows, so knn_fused bounds the scan's filter by a
             pilot (kernel.pilot_rows): the pilot's scan and merge are held
             against their plain versions and timed, the bounded scan
             beside the unbounded one (survivor shares printed, merged
             answers bit-identical), and the pilot swept at 8, 16 and
             32·k_eff rows. Then a 20,000-row engine (m 1 and 16), whose
             pilot the rule bypasses, timed with the pilot forced and
             without. Phase 4's shapes print that the pilot is bypassed;
             phase 5 times the int8 fallback's f32 scan (m 1, 4, 16) the
             same three ways.
4. msmarco — MS-MARCO shape, FD-SQ: N = 8,841,823, d = 769, m = 1, k = 72
             and k = 1024, the dataset generated and padded on the card.
5. int8    — the certified int8 tier, FQ-SD, m = 16, through
             ExactKNN(...).enable_int8().search(SearchRequest(tier="int8")):
             MS-MARCO at k = 72 (q_len 1024) on phase 4's resident dataset,
             then GIST at k = 1024 (q_len 8192). Every returned row must be
             bit-identical to the port's knn_exact_direct (certified rows come
             from the rescore, the others from the fallback, knn_exact_rescored:
             the f32 kernel's 2·k_eff candidates rescored in the direct form,
             one knn_scan + one knn_merge more, timed as a shape of its own);
             the certified share, the scan, merge, rescore and fallback times
             are printed, the fallback beside knn_exact_direct alone.
6. streamed — out-of-core FQ-SD at the GIST shape (phase 3's data, seed 3):
             the rows made on the card, then kept in a pinned host store of
             16 shards of 65,536 rows (1,048,576 padded, 4.29 GB of f32 a
             search ships) with its int8 tier quantised shard by shard on
             the card (1.07 GB of codes + 12.6 MB of channels), searched
             through ExactKNN(backend="cuda").fit_store(store,
             resident=False): fqsd-mmap-streamed (f32) and
             fqsd-int8-streamed, at prefetch_depth 1 and 2. Prints the host
             RAM, the pinned copy rate of one shard (CUDA events, median of
             10; the phase's bound is bytes shipped over it), and per search
             the host-clock median of 10 (each ending in a synchronise),
             transfers, bytes, GB/s and share of the copy rate, the
             copy-only time of the same shards, the compute-only time of
             the per-shard steps on device-resident copies, and the
             launches per search; int8 at the default spec_trigger (0.5)
             and, at depth 2, at 1.0 (no speculation), with the
             scan/gather/rescore split, the speculation counters at 0.0,
             0.5 and 1.0 and the certified share. Checks: (a) the f32 result is
             bit-identical to a resident fdsq-cuda search over the same
             store; (b) the int8 result is bit-identical to
             streamed_direct_scan over the store and to the resident
             fqsd-int8-cuda result wherever both are certified; (c) each
             per-shard kernel step equals its plain step (knn_scan_plain /
             knn_int8_scan_plain + knn_merge_plain) on one shard; (d) the
             results at spec_trigger 0.0, 0.5 and 1.0 are bit-identical;
             (e) the card is the H100 the bounds are stated for.
7. mmap    — phase 6's data written as a store in files under build/
             (DatasetStore.from_array(x, rows_per_shard=65,536,
             directory=...) + its int8 tier quantised on the card, about
             5.4 GB), reopened with DatasetStore.open(verify=True) and
             searched through fit_store(store, resident=False):
             fqsd-mmap-streamed and fqsd-int8-mmap-streamed at
             prefetch_depth 1 and 2, each result (values, indices,
             certificates, transfers, bytes_scanned) bit-identical to the
             same rows in a pinned host-RAM store, then one f32 search with
             verify_on_read. Prints, as measurements: the filesystem, the
             read rate of one shard file after a page-cache drop
             (posix_fadvise) and warm, the mapping -> page-locked staging
             rate (the double buffer's own copy, at 1 thread and at its
             default), the page-locked -> card rate, and per search the
             cold time (after a cache drop) and the warm median beside the
             staging-only bound (bytes shipped over the staging rate); then
             check (c) of phase 6 on two shards read from the mapping. The
             directory is deleted at the end, whatever the outcome.
8. mutate  — the store's write side at the GIST shape (phase 3's data, seed
             3): 16,128 rows upserted in batches of 1, 127 and 16,000 (3 full
             delta shards of 4,096 rows and a partial one of 3,840), then
             10,000 main rows and 100 delta rows deleted, (a) on a resident
             engine whose one shard (1,048,576 rows, room for the live rows
             after the fold) lives on the card: FD-SQ m = 1, k = 72 and FQ-SD
             m = 16, k = 1024 (knn_scan + knn_merge on the main shard, then on
             every delta shard, one queue finished once), then the int8 tier
             at m = 16, k = 1024 (delta rows merged in the direct form); then
             compact() and the same searches; (b) on phase 6's pinned host
             store, streamed at depth 2 (f32 and int8); (c) on phase 7's store
             in files under build/ (journaled, fsync'd): searched, closed,
             reopened (the journal replayed), searched, compacted to
             gen_000001 with its int8 tier quantised again, the old
             generation's files gone, reopened with verify=True, searched.
             Checks: every f32 result bit-identical in values to a fresh
             fdsq-cuda engine fitted on the live rows in external-id order
             and equal in indices once its positions are mapped to ids;
             every int8 result so against the port's knn_exact_direct over
             those rows; the launch counts; f32 streamed transfers = main +
             delta shards; no executable-cache entry added after the first
             search of each tier that met a delta shard (printed before and
             after). Measurements, not gates: upsert ms a batch (card, pinned
             host, journaled in files), delete ms, search ms with 0, 1 and 4
             delta shards, compact() s (card, files), open() + replay s; and
             knn_scan and knn_merge on one delta shard (4,096 x 1024, m = 1
             and 16) beside their plain versions, library calls and bounds.
             The directory is deleted at the end, whatever the outcome.
9. serve   — the serving path at the paper's GIST shape, read from
             repro_torch.configs.knn_paper (gist_fqsd: N = 1,000,000, d = 960,
             k = 1024), nothing cut: the collection built by
             repro_torch.launch.serve's construction path (vector_dataset(n,
             d, seed=0) -> Router.create(backend="cuda") -> enable_int8()),
             the kernels timed at one dispatch of each plan as in phases 3
             and 5 (FD-SQ m = 4, FQ-SD m = 64, int8 m = 64), then
             bursty_requests(query_stream(x, 512, seed=1), burst_size=64,
             trickle=8) replayed twice through AdaptiveScheduler(router=...)
             under each policy: latency, throughput without the int8 hook,
             adaptive with int8_min_depth=64; before the second and third
             policy 16 query rows are upserted and the nearest rows of 16
             other queries deleted through the Router, then
             compact(wait=True). Checks: (a) every served answer, by rid,
             within the tolerance below of the engine's direct search of the
             same rows, no deleted id served, every upserted query finding
             its row; (b) every dispatch launched the kernels of its label
             (knn_scan + one knn_merge; knn_int8_scan + knn_merge, and one
             knn_scan + knn_merge more when a row falls back), read
             from the counters reset before it; (c) the second replay adds
             no executable-cache miss; (d) 512 served a replay, modes
             switched under adaptive. Printed: the serve CLI's report of
             each replay (per plan: count, p50/p99 ms, q/s, executors,
             tier, certified share), upsert/delete/compact times, and per
             plan the scheduler's service time against engine.search + the
             same copy to the host at the same padded batch.
10. listen — the network front end at phase 9's GIST shape, nothing cut:
             the collection and server built by launch/serve.py's one
             construction path (build_server, --listen 127.0.0.1:0 --policy
             adaptive --int8-depth 64: vector_dataset's clustered rows, seed
             0, Router.create(backend="cuda"), enable_int8(), a KnnServer
             not yet listening), started in process on an ephemeral port;
             every dispatch runs on its one worker thread. Step 1: the 512
             rows of query_stream(x, 512, seed=1), each with its rid, over
             the wire: a stretch over 4 persistent connections, then a burst
             of 49 and one of 129 requests, each on its own connection,
             queued while the worker is held so that each burst's rest
             forms one batch (FQ-SD, then the int8 tier). Step 2: 16 query
             rows upserted and the nearest ids of 16 other queries deleted
             over the wire, POST compact {"wait": true}, GET compact, the
             512 again. Step 3: upsert and delete again, the 512 over 64
             connections with POST compact {} (the store's compactor
             thread) sent after the first 64 answers, GET compact polled
             until the new generation stands. Step 4: the ladder: the
             tenant rate lowered to 25 q/s under closed-loop traffic from
             one tenant (429s with Retry-After, no hard error); a second
             KnnServer on the same Router with a 10 ms queue timeout under a
             burst of 128 (503 queue_timeout); then no admission slot held
             and /healthz 200 on both. Step 5: a WebSocket stats probe rides
             along through steps 1-4. Gates: (a) every 200 answer, by rid,
             within the tolerance below of the engine's direct search (run
             on the worker) and its scores, ids and certificate, decoded
             from JSON, bit-identical to the SearchResult the batcher
             resolved for that rid; upserted queries find their rows, no
             deleted id served, each generation standing with error null;
             (b) every dispatch of steps 1 and 2 launched the kernels of its
             label, read from the counters reset before it on the worker;
             (d) all 512 answered in each step, with fdsq, fqsd and
             fqsd-int8 dispatches in steps 1 and 2; the ladder's and the
             stream's checks. Printed, not gated: the port's loadgen --port
             run as a subprocess at 1, 4, 16 and 64 connections, 5 s each
             (its JSON summary), beside the dispatches of each run by plan
             (count, median rows and service ms), the scheduler's per-plan
             p50 from /stats and the medians of the server's parse and
             encode time a request; the launches by plan.
11. tune   — per-device tuning (repro_torch.tuning), against a private cache
             file under build/tune/ installed for this phase alone (every
             other phase plans with an empty in-memory cache installed at
             start-up, so their times stay the default blocks'):
             probe_cuda_capability(); autotune_knn at the GIST shape (N =
             1,000,000, d = 960, k = 1024) for the f32 scan at m = 16 and
             the int8 scan at m = 16 and at m = 64 (the serve phase's int8
             dispatch), and at the MS-MARCO FD-SQ shape (m = 1, k = 72:
             bm = 1, so bn alone varies); autotune_pipeline at phase 6's
             streamed GIST int8 shape with shards of 65,536 and 131,072
             rows. Printed per shape: every candidate's host-clock time, the
             winner, the default blocks' time, and the winner's and the
             default's CUDA-event time of knn_scan / knn_int8_scan alone; at
             m = 64 also both on the serve phase's clustered rows. Gates:
             (a) every candidate and every pipeline combination answers
             bit-identically to the default blocks / knobs (held inside the
             sweeps, which raise otherwise; and the winner against the
             default on the clustered rows); (b) after each sweep the plan
             carries the winner, its search equals the default plan's bit
             for bit, and two more searches add no executable-cache miss;
             (c) the probe returns True and a plan under a persisted false
             verdict raises.
12. kernels — the standalone entry points: l2dist at (16, 1,000,000, 960),
             then topk over that (16, 1,000,000) matrix at k = 1024; then
             l2dist alone at (M, 1,000,000, 960) for M = 1, 16 (f32), 16
             (bf16) and 256 (f32), each one launch with the counters at 0,
             beside torch.cdist's matrix-product form; and both l2dist
             kernels at M = 16 to 128 (the crossover, printed only).

13. mesh   — the mesh (repro_torch.core.sharded) at the GIST shape, nothing
             cut: phase 3's data (seed 3), N = 1,000,000, d = 960, padded to
             1,000,448 x 1,024 (4.10 GB), row-sharded over make_mesh((2, 2),
             ("data", "model"), devices=["cuda:0"] * 4): four logical
             devices on the one card, each block 250,112 x 1,024 (a view of
             the single-device engine's rows, fitted from the same store).
             Searches: fdsq-sharded at m = 1 and m = 16, the ring
             (fqsd-sharded) at m = 16, fdsq-sharded-int8 at m = 16, all at
             k = 1024; fqsd-sharded-int8 over a pinned host store of 16
             shards of 65,536 rows ring-put to the 4 positions; then
             Router.create(devices=["cuda:0"] * 4) (a one-axis mesh) on the
             same store behind AdaptiveScheduler, a bursty replay of 128
             queries (burst 32, trickle 4) under the adaptive policy with
             int8_min_depth 32 and under the throughput policy; then 16
             upserts, 16 deletes and a filter mask on the 2 x 2 engine.
             First a batch probe on block 0: the query norms of 8 queries
             in a batch of 8 and of 16 (torch.sum, printed; the scans'
             fixed order, query_norms_sq: must be bit-identical) and
             knn_scan + knn_merge at bm = 8 and 16 with the norms fixed
             (must be bit-identical), and what each norm costs a call.
             Gates: (a) every f32 mesh answer bit-identical (values,
             indices) to the single-device fdsq-cuda answer on the same
             rows at the same batch, the replay's by rid against one
             search of all 128; (b) every int8 mesh answer bit-identical to
             knn_exact_direct; (c) the launches of knn_scan, knn_int8_scan
             and knn_merge in each search (and each replay dispatch) equal
             the schedule the executor's docstring states; (d)
             stats["bytes_per_device"] of the int8 mesh searches has 4
             entries summing to the scan bytes; (e) after the mutations, with
             and without the mask, every mesh search equals a fresh
             single-device fit on the live rows, and no executable-cache miss
             is added; (f) 8 traced warm ring searches make no new device
             allocation. Printed: each mesh search's host-clock median
             beside the single-device search, one ring step's block copies
             beside its block scans, the traced ring and int8 ring searches
             (device ms by kind, span, cudaMalloc, allocator counts), and
             every kernel at each shape the searches give it (a block's
             aligned scan and its own knn_merge, the tail scan, the
             hierarchical knn_merge; the int8 block and shard scans and
             their merges), launches split by the schedule, beside their
             plain versions, library calls and bounds over d = 960.
14. lm     — LM decode serving (repro_torch.models, serving.DecodeServer) at
             minicpm-2b's full width and depth, nothing cut: 40 layers,
             d_model 2,304, 36 heads (MHA), d_ff 5,760, V_padded 122,880,
             bf16, 3.01 B parameters (6.0 GB) drawn on the card from a
             seed. (a) `python -m repro_torch.launch.serve --mode lm --arch
             minicpm-2b` in a subprocess exits 0 and prints the reference's
             report line; (b) 4 sequences of 32 tokens through decode_step
             one at a time from an empty cache, and after a prefill of 16,
             against apply's logits at each position (within LM_BF16_TOL;
             greedy tokens equal wherever apply's top-2 margin exceeds twice
             it; no pad id), a cache one position off printed beside; (c)
             the same weights cut to 2 layers and cast to f32: a prefill and
             one decode_step on the card against the host's CPU (LM_F32_TOL,
             TF32 off); (d) a prefill of one 4,096-token prompt through
             _flash_blockwise and, with flash_threshold raised, through
             _sdpa_full (each counted in all 40 layers), last-token logits
             within LM_BF16_TOL, both timed; (e) DecodeServer, 8 slots,
             max_len 512, 32 requests of 32 tokens, run twice: every request
             completes with prompt + 32 tokens, no pad id, the second run's
             tokens equal the first's; ms a step, tokens/s and the step's
             bytes bound printed, then 4 steps traced (device busy ms, kernels
             a step, idle share); (f) qwen3-moe-30b-a3b at full width (128
             experts top 8, GQA 32/4, V 151,936) cut to 2 of 48 layers: (b)
             at a capacity factor of E / top_k (neither path drops an
             assignment), and (e) with 16 requests. No kernel of the port
             runs in this phase (every op is a plain PyTorch op).
15. train  — LM training (repro_torch.optim, checkpoint, runtime.fault,
             launch.train) at minicpm-2b's full width. (a) `python -m
             repro_torch.launch.train --arch minicpm-2b --smoke --steps 20
             --ckpt-dir build/train_ckpt --inject-failure 7` in a subprocess
             exits 0 with restarts=1 and a loss trajectory (the directory
             removed before and after); (b) the full width (d_model 2,304,
             36 heads, d_ff 5,760, V_padded 122,880) cut to 2 layers in f32,
             a batch of 2 x 256: loss and every gradient on the card against
             the host's CPU, then one AdamW step from the same (the CPU's)
             gradients, updates and params, each within TRAIN_TOL of its
             leaf's largest value (TF32 off); (d) that model and its f32
             moments saved async under build/train_ckpt_card and restored
             into a fresh template on the card, bit for bit, write and read
             GB/s printed, the files deleted; (c) the whole model, 40 layers,
             bf16 weights, remat, f32 moments (3.01 B parameters), weights
             drawn on the card from a seed, the train cell of
             repro_torch.launch.steps on one fixed batch of 1 x 4,096 tokens
             (train_4k's sequence, its global batch of 256 cut to 1), 6 steps:
             every loss finite and the last below the first; ms a step
             (median of steps 2-6), tokens/s, peak allocated memory, one
             traced step (kernels, device-busy ms, idle share) beside the
             bound (model FLOPs over the bf16 peak plus the optimizer's bytes
             over the memory rate); (e) the smoke model's supervised run of
             12 steps (checkpoints every 5) with failures injected at steps 2
             and 7 against a clean run, under
             torch.use_deterministic_algorithms(True): 2 restarts, the final
             params and moments bit-equal. No kernel of the port runs in this
             phase.
16. recsys — the recommenders (repro_torch.models.recsys) of dlrm-rm2,
             two-tower-retrieval, bst and wide-deep, weights drawn on the
             card from a seed, batches from launch.demo's draws (the
             reference's). (a) each at full width with every table cut to
             65,536 rows, a batch of 256: serve_scores, the loss and every
             gradient on the card against the host's CPU within MODEL_TOL of
             each leaf's largest value (TF32 off); (b) serve_p99 (batch 512)
             at full size, two-tower's 34.4 GB table included: ms a call
             (median of 20) beside the bytes bound of the rows gathered plus
             the dense weights; (c) retrieval_cand (1 x 1,000,000 x 256, k =
             100) through two-tower's retrieve_topk and dlrm-rm2's generic
             retrieval (d = 64) on the fused kernel (one knn_scan + one
             knn_merge, metric ip), each against the plain chunk_step on the
             card (scores within RETRIEVAL_TOL, indices equal where the plain
             scores around them are more than it apart), then knn_scan and
             knn_merge at the shape against their plain versions, beside
             torch.topk(u @ cand.T) and their bounds; (d) train_batch
             (65,536) at full size for dlrm-rm2, bst and wide-deep, f32
             moments, 4 steps on launch.train's per-step batches: finite
             losses, ms a step, examples/s, peak memory, one traced step,
             the bound (model FLOPs over the f32 peak plus 28 B a parameter
             over the memory rate), then one step with every leaf updated
             whole (no row chunks) and its peak; (e)
             examples/torch_dense_retrieval.py (recall@10 >= 0.95) and
             examples/torch_image_retrieval_streaming.py ("streamed result ==
             resident result") as subprocesses, exit 0.
17. gnn    — MeshGraphNet (repro_torch.models.gnn, .sampler) at full width
             and depth (15 layers, d_hidden 128, remat, f32 moments). (a) the
             smoke model on its smoke batch and the full width cut to 2 layers
             on full_graph_sm at full size (2,708 nodes x 1,433, 131,072
             edges): loss and every gradient on the card against the host's
             CPU within MODEL_TOL; (b) 4 train steps on full_graph_sm (its
             10,556 edges valid, the padding to 131,072 masked; the loss of
             materialize's batch, every padded edge valid, printed first),
             molecule (128 graphs of 30 nodes and 64 edges) and minibatch_lg
             (the sampler over a synthetic graph of 232,965 nodes and
             114,615,892 edges with 602 features: 1,024 seeds, fanouts 15 and
             10, padded to 169,984 nodes and 168,960 edges): finite losses,
             ms a step, edges/s, peak memory, one traced step, the host's
             sampling ms a subgraph, the bound (model FLOPs over the f32
             peak); (c) examples/torch_gnn_world_edges.py as a subprocess:
             exit 0, its edge counts and finite=True.
18. model_mesh — the substrate on a mesh of logical positions on the one
             card (repro_torch.runtime.sharding / .elastic, the islands of
             repro_torch.models), each cell through launch.steps'
             build_cell / launch.demo's materialize under use_mesh:
             (a) qwen3-moe-30b-a3b at full width cut to 2 layers (128
             experts top 8, GQA 32/4), its decode_32k cell (batch 128, a
             32,768-position cache drawn at random) on (data=2, model=8) of
             ["cuda:0"] * 16: 16 experts a position and the cache sharded
             on its sequence (4 % 8 != 0), both islands counted each layer;
             the logits within MESH_MOE_TOL of the meshless cell on the
             card, next tokens equal wherever the meshless top two logits
             are more than it apart, the largest gap printed beside it;
             (b) dlrm-rm2 at full size (the 8.64 GB fused table) on (data=1,
             model=8): serve_p99 (batch 512) bit-identical to the meshless
             cell; one train_batch step (65,536) whose loss and parameters
             are within twice the spread of two meshless steps (measured
             first: the table gradient accumulates with atomics); (c)
             knn-search's gist_fqsd and msmarco_fdsq at full size and
             yfcc_ring / yfcc_ring_q with N cut to 1,048,576 rows (the full
             100,000,000 are 1.64 TB) on (data=2, model=2), integer-valued
             data made on the card: values and indices bit-identical to the
             meshless cell, the kernels counted and timed at the block
             shapes; (d) two-tower retrieval_cand (1 x 1,000,000 x 256, k =
             100; the table cut to 65,536 rows, which only the user's row
             reads) on (data=1, model=4): the candidates row-sharded through
             fdsq_sharded(metric="ip"), bit-identical to the meshless
             retrieval; (e) (a)'s parameters placed under its cell's
             in_specs on its (2, 8) mesh, saved under build/, restored with
             shardings= on remesh(8 positions) = (1, 8), saved, restored on
             remesh(16) = (1, 16): every leaf bitwise the original; the
             directory deleted.

Phases 3-10, 12, 13 and 16 (c) are the main path of the kernels (phase 11
measures tuning, and its launches enter no entry; phase 10's launches are
printed on a line of their own; phases 14, 15 and 17 launch none, and phase
16 outside (c) none but its examples' own). A pilot's knn_scan and knn_merge
(kernel.pilot_bound, where kernel.pilot_rows engages: Smoke.pilots) count
with the search's own. The launch counters are set to 0 just before
each search (phases 9 and 10: before each dispatch; phase 12: before l2dist + topk,
and before each l2dist shape; phase 16: before each retrieval call)
and read just after; every
kernel of the path must have launched, knn_merge exactly once (phases 6
and 7: once a shard, beside knn_scan or knn_int8_scan once a shard; phase
8: once for the main shard and once a delta shard). Each result
is held against the plain version on the same padded operands within
TOL_REL·(qn + max xn) per score (f32 sums over d terms taken in another
order), with indices equal wherever the plain scores around them are more
than twice that apart; topk
and the merges move values without arithmetic and must be bit-identical.
Each kernel is timed with CUDA events (median of REPEATS after a warm-up;
l2dist's shapes over runs of 5 calls back to back, per call) beside its
plain version, one PyTorch call computing the same function (a
yardstick the port never calls; none exists for the int8 scan, whose
yardstick is the f32 knn_scan at the same shape, printed as f32_scan_ms),
and its bound on this card. bound_ms is the function's own work: its
unpadded inputs read once, its result written once, and its arithmetic
(2·d + the epilogue per pair for the scans, 2·d per pair for l2dist, one
comparison per element for the selections), whichever takes longer; bytes
count each operand at its element size. knn_merge's inputs are sorted, so
its function reads only the queued pairs below the answer's last one and
one pair past them in each queue (at most S + k a row, of S·k), one
comparison each, and writes the answer. The scans and topk also print
design_bound_ms, the same over the work each design does: the padded
operands (rows once per m-tile), the per-block queues, and the survivor
filter's sorts, rank searches and merges as the kernel counts them
(select.cuh's counters, with the survivors and the share of lanes that
survived printed beside). topk
is also timed with its merges (topk_with_merges_ms) beside torch.topk. The
bounds are stated for the H100 SXM (repro_torch.roofline.hw.H100_SXM: its name,
memory rate and f32 non-tensor peak, NVIDIA's data sheet at the full 700 W);
on any other card the run stops
before it measures.

Output: progress lines, the card's name and power limit as nvidia-smi gives
them, one {"kernels": [...]} line (per kernel: launches, ms, plain_ms,
library_ms and bound_ms summed over the main path's runs, one of each shape,
with the per-shape numbers under "shapes"; phase 6's and 7's shapes give
one shard's launch; phase 9's shapes time one dispatch of their plan and
carry the launches of every dispatch of that plan in the replays), and as
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPEATS = 5
#: Score tolerance, relative to qn + max xn: the rounding of a length-d f32
#: dot product summed in two different orders is about sqrt(d)·2^-24 of
#: |q||x| <= (qn + xn) / 2; at d = 960 that is ~1e-6, so 1e-5 leaves a
#: margin of ten.
TOL_REL = 1e-5
_CSRC = "src/repro_torch/kernels/csrc/"
#: kernel -> (its CUDA source, the TPU kernel it replaces), in line order
KERNELS = {
    "knn_scan": (_CSRC + "knn.cu", "src/repro/kernels/knn/kernel.py:121"),
    "knn_merge": (_CSRC + "knn.cu", "src/repro/kernels/knn/kernel.py:121"),
    "knn_int8_scan": (_CSRC + "knn_int8.cu", "src/repro/kernels/knn/kernel_int8.py:116"),
    "l2dist": (_CSRC + "l2dist.cu", "src/repro/kernels/l2dist/kernel.py:58"),
    "topk": (_CSRC + "topk.cu", "src/repro/kernels/topk/kernel.py:57"),
}
#: Shapes of the phases (paper Table 2 via src/repro/configs/knn_paper.py).
EXACT = dict(n=12_345, d=960, ks=(1, 7, 72, 1024), ms=(1, 16), topk_ks=(1, 72, 1024),
             l2dist_ms=(1, 16, 37, 300))
GIST = dict(n=1_000_000, d=960, m=16, k=1024)
#: phase 3's small resident engine, whose scan the pilot's rule bypasses by
#: n: its kernels timed with a pilot forced and without one, m in "ms"
PILOT_SMALL = dict(n=20_000, d=96, k=50, ms=(1, 16))
#: phase 5's int8 fallback at GIST's rows (knn_exact_rescored's f32 scan of
#: the uncertified rows, queue 2·next_pow2(k)), the same two ways
PILOT_FALLBACK_MS = (1, 4, 16)
MSMARCO = dict(n=8_841_823, d=769, m=1, ks=(72, 1024))
INT8 = dict(m=16, msmarco_k=72, gist_k=1024)
#: phase 12: the main path at (m, n, d), then l2dist alone at each (M, dtype)
#: of "l2dist" and both of its kernels at the batches of "crossover_ms",
#: each timed (beside its plain version and library call) over runs of
#: "calls" calls back to back
STANDALONE = dict(n=1_000_000, d=960, m=16, k=1024,
                  l2dist=((1, "float32"), (16, "float32"), (16, "bfloat16"), (256, "float32")),
                  crossover_ms=(16, 32, 48, 64, 80, 96, 112, 128), calls=5)
#: phase 6: phase 3's GIST data in pinned host shards, streamed
STREAMED = dict(n=1_000_000, d=960, m=16, k=1024, rows_per_shard=65_536, seed=3,
                depths=(1, 2), triggers=(0.0, 0.5, 1.0), repeats=10)
#: phase 7: phase 6's data as a store in files under build/, streamed from
#: its mappings
MMAP = dict(n=1_000_000, d=960, m=16, k=1024, rows_per_shard=65_536, seed=3,
            depths=(1, 2), repeats=5)
#: phase 8: phase 3's GIST data mutated (upsert batches, deletes of main and
#: delta rows), searched at the FD-SQ (m, k) and the FQ-SD (m, k) of the
#: paper's shapes, the int8 tier at the FQ-SD one; the resident store is one
#: shard of resident_rows (room for the live rows after the fold, so the
#: compaction keeps its shape), the streamed and on-disk ones phase 6's and
#: phase 7's shards
MUTATE = dict(n=1_000_000, d=960, seed=3, upserts=(1, 127, 16_000), delete_main=10_000,
              delete_delta=100, fdsq=(1, 72), fqsd=(16, 1024), resident_rows=1 << 20,
              rows_per_shard=65_536, oracle_chunk=1024, repeats=5)
#: phase 9: the serving path at the paper's GIST shape (read from
#: repro_torch.configs.knn_paper): the bursty trace of "queries" requests
#: under each (policy, int8_min_depth), "upserts" rows upserted and
#: "deletes" ids deleted through the Router (then compacted) before each
#: policy after the first; the kernels timed at a dispatch of "fdsq_m" and
#: of "fqsd_m" rows
SERVE = dict(shape="gist_fqsd", queries=512, burst_size=64, trickle=8, int8_min_depth=64,
             policies=(("latency", None), ("throughput", None), ("adaptive", 64)),
             upserts=16, deletes=16, fdsq_m=4, fqsd_m=64)
#: phase 10: the network front end at phase 9's shape: the 512 queries in a
#: stretch over "stretch_connections" and two bursts held until queued (one
#: request taken alone, the rest one FQ-SD batch, then one int8 batch);
#: "upserts" rows upserted and "deletes" ids deleted before steps 2 and 3;
#: step 3 over "compaction_connections" with the compaction started after
#: "compact_after" answers; the ladder's tenant rate and closed-loop run,
#: the second server's queue timeout and burst; loadgen subprocesses at
#: each of "loadgen_connections" for "loadgen_s"; every socket wait bounded
#: by "wait_s", the phase's traffic by "phase_s"
LISTEN = dict(shape="gist_fqsd", queries=512, int8_min_depth=64, stretch_connections=4,
              bursts=(49, 129), upserts=16, deletes=16, compaction_connections=64,
              compact_after=8, ladder_tenant_qps=25.0, ladder_connections=16, ladder_s=2.0,
              queue_timeout_ms=10.0, timeout_burst=128, probe_s=2.0, probe_interval_ms=250.0,
              loadgen_connections=(1, 4, 16, 64), loadgen_s=5.0, wait_s=60.0, phase_s=600.0)
#: phase 11: the shapes the tuners sweep (rows from their own seeded numpy
#: draws): the GIST scans (f32 at m = 16, int8 at m = 16 and at the serve
#: phase's m = 64), the MS-MARCO FD-SQ scan, and the streamed int8 pipeline
#: of phase 6 at two shard sizes. Rescore factor 8 is left out of the
#: pipeline sweep: at k = 1024 its queue (next_pow2(8·1024 + 1) = 16,384)
#: is wider than knn_merge takes (k <= 8192), so the sweep would raise.
TUNE = dict(gist=dict(n=1_000_000, d=960, k=1024, seed=3), f32_ms=(16,), int8_ms=(16, 64),
            msmarco=dict(n=8_841_823, d=769, m=1, k=72, seed=4),
            pipeline=dict(n=1_000_000, d=960, m=16, k=1024, shards=(65_536, 131_072),
                          rescore=(2, 4), seed=3),
            clustered_m=64, repeats=3, searches=5)
#: phase 13: the mesh at the GIST shape (phase 3's data, seed 3), nothing
#: cut: a "shape" mesh over "axes" of logical devices on the one card;
#: fdsq-sharded at each of "fdsq_ms" and the ring (fqsd-sharded) and the int8
#: tier at "m" queries; the int8 ring over a pinned host store of shards of
#: "rows_per_shard"; the Router's replay of "replay"; "upserts" rows upserted
#: and the nearest rows of "deletes" queries deleted; "traced" ring searches
#: and "traced_int8" int8 ring searches each under the profiler
MESH = dict(n=1_000_000, d=960, seed=3, shape=(2, 2), axes=("data", "model"), k=1024,
            m=16, fdsq_ms=(1, 16), rows_per_shard=65_536,
            replay=dict(queries=128, burst_size=32, trickle=4, int8_min_depth=32),
            upserts=16, deletes=16, repeats=5, traced=8, traced_int8=3)
#: phase 14: LM decode serving at LM["arch"]'s full width and depth (read from
#: repro_torch.configs), weights drawn on the card from "seed": (b) "seqs"
#: sequences of "positions" tokens decoded one at a time against apply, and
#: after a prefill of "prefill" tokens; (c) "f32_layers" layers cast to f32, a
#: prefill of "f32_prompt" tokens and one decode step, card against the host's
#: CPU; (d) a prefill of "flash_prompt" tokens, flash against full attention;
#: (e) DecodeServer over "server", run twice, "profile_steps" steps traced;
#: (f) the MoE arch cut to "layers" layers: (b) and its own "server"
LM = dict(arch="minicpm-2b", seed=0, seqs=4, positions=32, prefill=16, f32_layers=2,
          f32_prompt=8, flash_prompt=4096, cli_timeout_s=300, profile_steps=4,
          server=dict(slots=8, max_len=512, requests=32, tokens=32),
          moe=dict(arch="qwen3-moe-30b-a3b", layers=2,
                   server=dict(slots=8, max_len=512, requests=16, tokens=32)))
#: Logit tolerances of phase 14 (the logits are O(1): unit-RMS activations
#: through a head of N(0, 1/d)). bf16: two computations of the same model
#: that differ in GEMM shapes (decode M = 4 rows against apply's 128, flash
#: against full attention) round differently, one bf16 step (2^-8 relative)
#: here and there, and 40 layers carry those steps to the logits. f32 (2
#: layers, card against CPU, TF32 off): sums over d = 2304 and d_ff = 5760 in
#: two orders differ by ~sqrt(d)·2^-24 relative each.
LM_BF16_TOL, LM_F32_TOL = 0.125, 1e-3
#: MoE routing: the largest gap between a token's k-th and (k+1)-th router
#: probability at which two computations of one token may pick different
#: experts. Past the first layer the router's input carries the bf16
#: rounding of the residual stream: a step of 2^-8 moves its O(1) logits by
#: ~4e-3 and a probability p by ~4e-3·p, so two such moves near the k-th
#: probabilities (~0.01-0.05) can swap two experts ~4e-4 apart.
LM_ROUTE_GAP = 1e-3
#: phase 15: LM training at TRAIN["arch"]'s full width: (a) the CLI at
#: --smoke for "cli_steps" with a failure at "cli_failure"; (b) "cut_layers"
#: layers in f32 on a batch of "cut_batch" (rows, tokens), card against CPU,
#: one AdamW step at "lr"; (d) that state through a checkpoint; (c) the whole
#: model for "steps" steps on one batch of "batch"; (e) the smoke model for
#: "recovery_steps" steps, checkpoints every "recovery_interval", failures at
#: "recovery_fail_at"
TRAIN = dict(arch="minicpm-2b", seed=0, cli_steps=20, cli_failure=7, cli_timeout_s=300,
             cut_layers=2, cut_batch=(2, 256), lr=1e-4, batch=(1, 4096), steps=6,
             recovery_steps=12, recovery_interval=5, recovery_fail_at=(2, 7))
#: Phase 15's card-against-CPU gate, relative to each leaf's largest value:
#: f32 sums over d = 2,304, d_ff = 5,760 and 512 tokens taken in other orders
#: differ by ~sqrt(n)·2^-24 relative (~1e-5 expected)
TRAIN_TOL = 1e-3
#: phase 16: the recommenders of RECSYS["archs"] (read from repro_torch.configs),
#: weights drawn on the card from "seed", batches from launch.demo's draws:
#: (a) each at full width with every table cut to "cut_rows" rows, a batch
#: of "cut_batch", card against CPU; (b) serve_p99 at full size, "serve_calls"
#: calls timed; (c) retrieval_cand of "retrieval" on the kernel; (d)
#: train_batch at full size for "train_archs", "train_steps" steps; (e) the
#: "examples" as subprocesses
RECSYS = dict(seed=0, archs=("dlrm-rm2", "two-tower-retrieval", "bst", "wide-deep"),
              cut_rows=1 << 16, cut_batch=256, serve_calls=20,
              retrieval=("two-tower-retrieval", "dlrm-rm2"),
              train_archs=("dlrm-rm2", "bst", "wide-deep"), train_steps=4,
              examples=("torch_dense_retrieval", "torch_image_retrieval_streaming"),
              example_timeout_s=300)
#: phase 17: MeshGraphNet at full width and depth (GNN["arch"]): (a) its
#: smoke model and the full width cut to "cut_layers" layers on "cut_shape",
#: card against CPU; (b) "steps" train steps on each of "shapes"
#: (minibatch_lg through the sampler over a synthetic graph of the shape's
#: nodes and edges); (c) the "example" as a subprocess
GNN = dict(arch="meshgraphnet", seed=0, cut_layers=2, cut_shape="full_graph_sm",
           shapes=("full_graph_sm", "molecule", "minibatch_lg"), steps=4,
           example="torch_gnn_world_edges", example_timeout_s=300)
#: phase 18: the substrate on a mesh of logical positions: (a) the MoE arch
#: cut to "layers" on its "shape" cell over "mesh"; (b) "table" at full
#: size; (c) the kNN cells of "knn" ("cut" rows for the ring shapes); (d)
#: two-tower retrieval with its table cut to "cut_rows"; (e) the elastic
#: round trip of (a)'s parameters between "elastic" positions, under "ckpt"
MODEL_MESH = dict(seed=0, moe=dict(arch="qwen3-moe-30b-a3b", layers=2, shape="decode_32k",
                                   mesh=(2, 8)),
                  table=dict(arch="dlrm-rm2", mesh=(1, 8)),
                  knn=dict(mesh=(2, 2), shapes=("gist_fqsd", "msmarco_fdsq", "yfcc_ring",
                                                "yfcc_ring_q"), cut=1 << 20, seed=5),
                  retrieval=dict(arch="two-tower-retrieval", mesh=(1, 4), cut_rows=1 << 16),
                  elastic=(16, 8), ckpt="build/model_mesh_ckpt")
#: Phase 18 (a)'s logit gate: the mesh's bf16 combine rounds each position's
#: expert sum to bf16 before the sum over positions (the meshless path
#: rounds once), a step of 2^-8 relative in the residual stream, which the
#: next layer's router and head carry to the logits as phase 14's bf16
#: differences do
MESH_MOE_TOL = LM_BF16_TOL
#: Phases 16 and 17's card-against-CPU gate, relative to each leaf's largest
#: value: f32 sums in other orders (the card's scatters use atomics)
MODEL_TOL = 1e-4
#: Phase 16 (c)'s retrieval gate: scores within it, indices equal wherever
#: the plain scores around them are more than it apart (|u| = 1 against
#: N(0, 1) rows of d = 256: scores of O(5), f32 sums of 256 products)
RETRIEVAL_TOL = 1e-5
#: f32 operations per (query, row) pair in the l2 epilogue: double, subtract,
#: add, clamp; in the int8 epilogue: scale, double, subtract, add, clamp,
#: sqrt, subtract, clamp, square
L2_EPILOGUE_OPS, INT8_EPILOGUE_OPS = 4, 9


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, torch, dev, card: str = ""):
        from repro_torch.core.distance import query_norms_sq
        from repro_torch.kernels.knn import kernel as K, ops
        from repro_torch.roofline.hw import H100_SXM

        self.torch, self.K, self.ops, self.dev = torch, K, ops, dev
        self.qnorm = query_norms_sq  # the query norms as the executors compute them
        self.card = card  # nvidia-smi's name and power limit, beside every time
        self.bw, self.flops = H100_SXM.hbm_bw, H100_SXM.peak_flops_f32
        self.shapes: list[dict] = []  # one per main-path search
        self.msmarco_eng = None  # phase 4's engine, quantised by phase 5
        self.serve_rows = None  # phase 9's engine and query rows, for phase 11

    # ------------------------------------------------------------ helpers
    def pilots(self, n: int, d: int, rows: int, k: int, blocks=None) -> int:
        """The pilots (``kernel.pilot_bound``: one knn_scan and one knn_merge
        each) that ``ops.knn`` runs for ``rows`` query rows at k over n rows
        of d columns, at ``blocks`` (the plan's, resolved) or the default
        ones: 1 where the package's rule (``kernel.pilot_rows``) engages at
        the scan's split, else 0 (0 for a package without a pilot)."""
        K, ops = self.K, self.ops
        if not rows or not hasattr(K, "pilot_rows"):
            return 0
        bm, bn, _ = blocks or ops.resolved_blocks(k, d, m=rows)
        n = -(-n // bn) * bn
        tps = K.scan_config(-(-rows // bm), n // bn, bm, self.dev)[1]
        return int(K.pilot_rows(n, 1 << (k - 1).bit_length(), tps * bn, bm) > 0)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def ms(self, fn, repeats: int = REPEATS, calls: int = 1) -> float:
        """Median CUDA-event time of fn over `repeats` runs after a warm-up;
        with `calls` > 1 each run is that many calls back to back, timed
        together and divided by `calls`, so the host's time to launch a
        call hides behind the previous one."""
        torch = self.torch
        fn()
        self.sync()
        times = []
        for _ in range(repeats):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / calls)
        return statistics.median(times)

    def bound(self, nbytes: float, ops: float) -> tuple[float, str]:
        t_b, t_o = nbytes / self.bw * 1e3, ops / self.flops * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    @staticmethod
    def merge_work(sv, si, av, ai) -> tuple[int, int]:
        """The bytes and comparisons that merging the sorted (m, S, k)
        queues (sv, si) into their answer (av, ai) needs on this data: per
        row, every pair of each queue strictly below the answer's last pair
        (all of them reach the answer) and one more pair of each queue not
        read to its end (to see it stop), read once, and the (m, k) answer
        written once; one comparison per pair read. At most (S + k) pairs a
        row are read, of the S·k queued."""
        from repro_torch.core.topk import pair_keys

        last = pair_keys(av[:, -1:], ai[:, -1:])[:, :, None]
        below = (pair_keys(sv, si) < last).sum(-1)
        read = int((below + 1).clamp(max=sv.shape[-1]).sum())
        return read * 8 + av.numel() * 8, read

    @staticmethod
    def select_work(stats, k: int, lanes: int) -> dict:
        """The survivor filter's work from a kernel's counters (select.cuh):
        survivors, passes, comparisons of the survivor sorts and queue pairs
        moved by the merges, summed over the blocks; its operations add a
        log2(k)-probe rank search per survivor. `lanes` is the number
        of (query, row) lanes the filter saw."""
        survivors, passes, comps, moved = (int(v) for v in stats.sum(dim=(0, 1)).tolist())
        return {"survivors": survivors, "survivor_fraction": survivors / lanes,
                "passes": passes, "sort_comparisons": comps, "pairs_moved": moved,
                "ops": comps + moved + survivors * max(1, int(math.log2(k)))}

    # ------------------------------------------------------ phase 2: exact
    def _pow2_rows(self, n, d, g):
        """Integer rows in [-8, 8] whose norms are powers of two, so their
        L2-normalised form (cos) is exact in f32 and bf16."""
        torch = self.torch
        counts = torch.tensor([1, 4, 16, 64], device=self.dev)[
            torch.randint(0, 4, (n,), generator=g, device=self.dev)]
        ranks = torch.rand(n, d, generator=g, device=self.dev).argsort(1).argsort(1)
        signs = torch.randint(0, 2, (n, d), generator=g, device=self.dev) * 2 - 1
        x = ((ranks < counts[:, None]) * signs).to(torch.float32)
        eight = torch.rand(n, generator=g, device=self.dev) < 0.1  # a single ±8
        x[eight] = ((ranks[eight] == 0) * signs[eight] * 8).to(torch.float32)
        return x

    def phase_exact(self) -> bool:
        torch, ops = self.torch, self.ops
        g = torch.Generator(device=self.dev).manual_seed(2)
        n, d = EXACT["n"], EXACT["d"]
        ints = torch.randint(-8, 9, (n, d), generator=g, device=self.dev).to(torch.float32)
        cos_rows = self._pow2_rows(n, d, g)
        for x in (ints, cos_rows):  # planted duplicates: exact ties
            x[n // 2] = x[17]
            x[n - 3] = x[17]
            x[n - 1] = x[3]
        inf_rows = torch.tensor([100, n // 4, n - 2], device=self.dev)
        q_int = torch.randint(-8, 9, (max(EXACT["ms"]), d), generator=g,
                              device=self.dev).to(torch.float32)
        q_int[0] = ints[17]
        q_cos = self._pow2_rows(max(EXACT["ms"]), d, g)
        q_cos[0] = cos_rows[17]
        cases = fails = 0
        for metric in ("l2", "ip", "cos"):
            base, qb = (cos_rows, q_cos) if metric == "cos" else (ints, q_int)
            xn = torch.sum(base * base, dim=-1)
            xn[inf_rows] = torch.inf
            if metric == "cos":  # exact: every norm is a power of two
                base = base / torch.sqrt(torch.sum(base * base, dim=-1, keepdim=True))
            for dtype in (torch.float32, torch.bfloat16):
                for k in EXACT["ks"]:
                    for m in EXACT["ms"]:
                        call = ops.prepare(qb[:m].to(dtype), base.to(dtype), k, metric, xn,
                                           x_prenormalized=metric == "cos")
                        bad = self._exact_case(call)
                        cases += 1
                        if bad:
                            fails += 1
                            log(f"  exact FAIL {metric} {dtype} k={k} m={m}: {bad}")
        log(f"phase exact: knn_scan {cases - fails}/{cases} cases bit-identical "
            f"(values, indices, skip counts)")
        ok = fails == 0
        for name, check in (("knn_scan adversarial", self._exact_scan_orders),
                            ("knn_merge", self._exact_merge),
                            ("knn_int8_scan", self._exact_int8), ("l2dist", self._exact_l2dist),
                            ("topk", self._exact_topk)):
            cases, bad = check(g)
            for b in bad:
                log(f"  exact FAIL {name} {b}")
            log(f"phase exact: {name} {cases - len(bad)}/{cases} cases bit-identical")
            ok &= not bad
        return ok

    def _exact_scan_orders(self, g):
        """The f32/bf16 scan on integer rows in [-8, 8] in two adversarial
        orders: farthest from query 0 first (by its metric), so every lane
        of every tile beats query 0's queue and the survivor buffer
        overflows (the multi-pass path), and every row equal, so only the
        index ties decide; l2 and ip, k in {1, 72, 1024}, m in {1, 16}."""
        torch, ops = self.torch, self.ops
        n, d = EXACT["n"], EXACT["d"]
        x = torch.randint(-8, 9, (n, d), generator=g, device=self.dev).to(torch.float32)
        q = torch.randint(-8, 9, (max(EXACT["ms"]), d), generator=g,
                          device=self.dev).to(torch.float32)
        q[0] = x[17]
        inf_rows = torch.tensor([100, n // 4, n - 2], device=self.dev)
        cases, bad = 0, []
        for metric in ("l2", "ip"):
            key = torch.sum((x - q[0]) ** 2, -1) if metric == "l2" else -(x @ q[0])
            orders = {"farthest_first": x[torch.argsort(key, descending=True, stable=True)],
                      "equal": x[17].expand(n, d).contiguous()}
            for order, rows in orders.items():
                xn = torch.sum(rows * rows, dim=-1)
                xn[inf_rows] = torch.inf
                for dtype in (torch.float32, torch.bfloat16):
                    for k in (1, 72, 1024):
                        for m in EXACT["ms"]:
                            cases += 1
                            call = ops.prepare(q[:m].to(dtype), rows.to(dtype), k, metric, xn)
                            problems = self._exact_case(call)
                            if problems:
                                bad.append(f"{order} {metric} {dtype} k={k} m={m}: {problems}")
        return cases, bad

    def _exact_merge(self, _g):
        """The one-launch merge on queues built to stress its threshold
        (``repro_torch.data.merge_cases``, seeded per case), at the main
        path's widths, one launch per call."""
        torch, K = self.torch, self.K
        from repro_torch.data.merge_cases import KINDS, merge_queues

        cases, bad = 0, []
        for kind in KINDS:
            for m, s, k in ((3, 7, 1), (1, 264, 128), (16, 245, 1024), (16, 123, 8192)):
                cases += 1
                v, i = merge_queues(kind, m, s, k, seed=cases, device=self.dev)
                K.reset_launch_counts()
                mv, mi = K.knn_merge(v, i)
                self.sync()
                pv, pi = K.knn_merge_plain(v, i)
                launches = K.LAUNCHES["knn_merge"]
                if not (torch.equal(mv, pv) and torch.equal(mi, pi)) or launches != 1:
                    bad.append(f"{kind} (m, S, k)=({m}, {s}, {k}) launches={launches}")
        return cases, bad

    def _exact_int8(self, g):
        """The int8 scan on rows whose scale is exactly 1 (integers in
        [-127, 127] with one entry at 127) and integer queries in [-8, 8],
        in three row orders: random; farthest from query 0 first, so every
        lane of every tile beats query 0's queue and the survivor buffer
        overflows (the multi-pass path); and every row equal, so only the
        index ties decide. q_len runs from 8 to 8192 (k = 1024: the
        widest queue)."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch.core.quantized import quantize_dataset

        n, d = EXACT["n"], EXACT["d"]
        x = torch.randint(-127, 128, (n, d), generator=g, device=self.dev).to(torch.float32)
        x[torch.arange(n, device=self.dev),
          torch.randint(0, d, (n,), generator=g, device=self.dev)] = 127.0
        x[n // 2] = x[17]
        x[n - 3] = x[17]
        q = torch.randint(-8, 9, (max(EXACT["ms"]), d), generator=g,
                          device=self.dev).to(torch.float32)
        q[0] = x[17]
        far = torch.argsort(torch.sum((x - q[0]) ** 2, dim=-1), descending=True, stable=True)
        orders = {"random": x, "farthest_first": x[far], "equal": x[17].expand(n, d)}
        cases, bad = 0, []
        for order, rows in orders.items():
            ds = quantize_dataset(rows.contiguous())
            ds.norms_sq[torch.tensor([100, n // 4, n - 2], device=self.dev)] = torch.inf
            for k in EXACT["ks"]:
                for m in EXACT["ms"]:
                    cases += 1
                    call = ops.prepare_int8(q[:m], ds, k)
                    bm, bn, _ = call.blocks
                    args = (call.q, call.x8, call.qn, call.scales, call.err, call.hn,
                            call.q_len, bm, bn)
                    m_tiles, n_tiles = call.q.shape[0] // bm, call.hn.shape[0] // bn
                    problems = []
                    card_s = K.int8_scan_config(m_tiles, n_tiles, bm, self.dev)[0]
                    for splits in (card_s, 1):
                        for prune in (True, False):
                            got = K.knn_int8_scan(*args, prune, splits)
                            want = K.knn_int8_scan_plain(*args, prune, splits)
                            for what, a, b in zip(("bounds", "indices", "skips"), got, want):
                                if not torch.equal(a, b):
                                    problems.append(f"scan S={splits} prune={prune} {what}")
                        mv, mi = K.knn_merge(got[0], got[1])
                        pv, pi = K.knn_merge_plain(got[0], got[1])
                        if not (torch.equal(mv, pv) and torch.equal(mi, pi)):
                            problems.append(f"merge S={splits}")
                    v, i, _ = K.knn_int8_fused(*args)
                    pv, pi, _ = K.knn_int8_scan_plain(*args, True, 1)
                    if not (torch.equal(v, pv[:, 0]) and torch.equal(i, pi[:, 0])):
                        problems.append("fused")
                    self.sync()
                    if problems:
                        bad.append(f"{order} k={k} m={m} q_len={call.q_len}: "
                                   f"{', '.join(problems)}")
        return cases, bad

    def _exact_l2dist(self, g):
        """l2dist through its entry point and through each of its two
        kernels, at batches on both sides of the crossover and ragged
        against the tiles (N too), f32 and bf16."""
        torch = self.torch
        from repro_torch.kernels.l2dist import kernel as L

        n, d = EXACT["n"], EXACT["d"]
        ms = EXACT["l2dist_ms"]
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        x = torch.randint(-8, 9, (n, d), generator=g, device=self.dev).to(torch.float32)
        q = torch.randint(-8, 9, (max(ms), d), generator=g, device=self.dev).to(torch.float32)
        q[0] = x[17]
        cases, bad, paths = 0, [], set()
        for dtype in (torch.float32, torch.bfloat16):
            for m in ms:
                qd, xd = q[:m].to(dtype), x.to(dtype)
                qn, xn = torch.sum(q[:m] ** 2, -1), torch.sum(x * x, -1)
                want = L.l2dist_plain(qd, xd, qn, xn)
                picked = L.l2dist_config(m, n, d, dtype, sms).path
                paths.add(picked)
                for path in (None, "stream", "tiled"):
                    cases += 1
                    self.K.reset_launch_counts()
                    got = (L.l2dist_tiles(qd, xd, qn, xn) if path is None else
                           L.l2dist_launch(qd, xd, qn, xn,
                                           L.l2dist_config(m, n, d, dtype, sms, path)))
                    self.sync()
                    if not torch.equal(got, want) or self.K.LAUNCHES["l2dist"] != 1:
                        bad.append(f"{dtype} m={m} path={path or picked}")
        if paths != {"stream", "tiled"}:
            bad.append(f"the entry point took only {paths} at m in {ms}")
        return cases, bad

    def _exact_topk(self, g):
        """topk on a ragged (M, N): integer scores with ties and a mix of
        -0.0 and +0.0; scores descending along N (every lane of every batch
        beats the queue, so the survivor buffer overflows); all scores
        equal (only the index ties decide); and +inf lanes."""
        torch = self.torch
        from repro_torch.kernels.topk import kernel as T
        from repro_torch.kernels.topk import ops as TO
        from repro_torch.kernels.topk.ref import topk_ref

        n, rows = EXACT["n"], max(EXACT["ms"])
        ints = torch.randint(-300, 301, (rows, n), generator=g,
                             device=self.dev).to(torch.float32)
        zero = ints == 0
        ints[zero] = torch.where(torch.rand(int(zero.sum()), generator=g, device=self.dev)
                                 < 0.5, -0.0, 0.0)
        infs = ints.clone()
        infs[torch.rand(rows, n, generator=g, device=self.dev) < 0.3] = torch.inf
        data = {
            "ints": ints,
            "descending": torch.arange(n, 0, -1, device=self.dev, dtype=torch.float32)
            .expand(rows, n).contiguous(),
            "equal": torch.full((rows, n), 3.0, device=self.dev),
            "inf_lanes": infs,
        }
        cases, bad = 0, []
        for name, s in data.items():
            for k in EXACT["topk_ks"]:
                for m in (5, 16):
                    cases += 1
                    sm = s[:m].contiguous()
                    k_eff = 1 << max(0, (k - 1).bit_length())
                    bn = max(1024, k_eff)
                    problems = []
                    for splits in (None, 1):
                        sv, si = T.topk_scan(sm, k_eff, bn, splits)
                        pv, pi = T.topk_scan_plain(sm, k_eff, bn, sv.shape[1])
                        if not (torch.equal(sv, pv) and torch.equal(si, pi)):
                            problems.append(f"scan S={sv.shape[1]}")
                    v, i = TO.topk(sm, k)
                    rv, ri = topk_ref(sm, k)
                    if not (torch.equal(v, rv) and torch.equal(i, ri)):
                        problems.append("topk vs the full sort")
                    self.sync()
                    if problems:
                        bad.append(f"{name} k={k} m={m}: {', '.join(problems)}")
        return cases, bad

    def _exact_case(self, call) -> str:
        torch, K = self.torch, self.K
        bm, bn, bd = call.blocks
        q, x, xn = call.q, call.x, call.xn
        qn = torch.sum(q.to(torch.float32) ** 2, dim=-1)
        m_tiles, n_tiles = q.shape[0] // bm, x.shape[0] // bn
        problems = []
        for splits in (K.scan_config(m_tiles, n_tiles, bm, self.dev)[0], 1):
            for prune in (True, False):
                got = K.knn_scan(q, x, qn, xn, call.k_eff, call.metric, bm, bn, prune, splits)
                want = K.knn_scan_plain(q, x, qn, xn, call.k_eff, call.metric, bm, bn,
                                        prune, splits)
                for name, a, b in zip(("values", "indices", "skips"), got, want):
                    if not torch.equal(a, b):
                        problems.append(f"scan S={splits} prune={prune} {name}")
            mv, mi = K.knn_merge(got[0], got[1])
            pv, pi = K.knn_merge_plain(got[0], got[1])
            if not (torch.equal(mv, pv) and torch.equal(mi, pi)):
                problems.append(f"merge S={splits}")
        rows = x.shape[0] // 3 // bn * bn
        if rows and hasattr(K, "pilot_bound"):
            # a pilot's read of every third row in place (row pitch 3·d, norm
            # step 3) at an eighth of the bm, and the scan its bound seeds
            pbm = max(1, bm // 8)
            pargs = (q, x[::3][:rows], qn, xn[::3][:rows], call.k_eff, call.metric, pbm, bn,
                     True, K.scan_config(q.shape[0] // pbm, rows // bn, pbm, self.dev)[0])
            for name, a, b in zip(("values", "indices", "skips"), K.knn_scan(*pargs),
                                  K.knn_scan_plain(*pargs)):
                if not torch.equal(a, b):
                    problems.append(f"strided scan {name}")
            bound = dict(zip(("bound_v", "bound_i"), K.pilot_bound(
                q, x, qn, xn, call.k_eff, call.metric, bm, bn, rows)))
            splits = K.scan_config(m_tiles, n_tiles, bm, self.dev)[0]
            got = K.knn_scan(q, x, qn, xn, call.k_eff, call.metric, bm, bn, True, splits,
                             **bound)
            want = K.knn_scan_plain(q, x, qn, xn, call.k_eff, call.metric, bm, bn, True,
                                    splits, **bound)
            for name, a, b in zip(("values", "indices", "skips"), got, want):
                if not torch.equal(a, b):
                    problems.append(f"bounded scan {name}")
            bv, bi = K.knn_merge(got[0], got[1])
            if not (torch.equal(bv, mv) and torch.equal(bi, mi)):
                problems.append("bounded answer")
        v, i, _ = K.knn_fused(q, x, xn, call.k_eff, call.metric, bm, bn, bd)
        pv, pi, _ = K.knn_fused_plain(q, x, xn, call.k_eff, call.metric, bm, bn, bd)
        if not (torch.equal(v, pv) and torch.equal(i, pi)):
            problems.append("fused")
        self.sync()
        return ", ".join(problems)

    # --------------------------------------------------- phases 3 and 4
    def main_path(self, label: str, eng, q, k: int, mode: str) -> bool:
        """One main-path search, held against the plain version, timed."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch import SearchRequest

        req = SearchRequest(queries=q, k=k, mode_hint=mode)
        self.sync()
        K.reset_launch_counts()
        res = eng.search(req)
        self.sync()
        launches = dict(K.LAUNCHES)
        # one knn_scan + knn_merge, and a pilot's pair where the rule engages
        n_pilots = self.pilots(*eng._ds.vectors.shape, q.shape[0], k, res.kernel_stats["blocks"])
        ok = (res.plan.executor == "fdsq-cuda"
              and launches["knn_scan"] == launches["knn_merge"] == 1 + n_pilots)
        log(f"{label}: executor={res.plan.executor} mode={res.plan.mode} "
            f"launches={launches} skip_rate={float(res.kernel_stats['prune_skip_rate']):.6f} "
            f"blocks={res.kernel_stats['blocks']}")
        v, i = res.topk.scores, res.topk.indices
        m = q.shape[0]
        ok &= tuple(v.shape) == (m, k) and bool(torch.isfinite(v).all())
        ok &= bool(((i >= 0) & (i < eng.n)).all())

        e2e = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            eng.search(req)
            self.sync()
            e2e.append((time.perf_counter() - t0) * 1e3)

        # the kernels' operands, exactly as the executor prepares them
        ds = eng._ds
        call = ops.prepare(eng._pad_queries(q), ds.vectors, k, "l2", ds.norms)
        bm, bn, _ = call.blocks
        cq, cx, cxn = call.q, call.x, call.xn
        qn = self.qnorm(cq)
        m_tiles, n_tiles = cq.shape[0] // bm, cx.shape[0] // bn
        splits, tps, _ = K.scan_config(m_tiles, n_tiles, bm, self.dev)
        # the scan as knn_fused runs it: bounded by a pilot where the rule
        # engages (a package without the pilot, driven by --package, runs none)
        pilot = (K.pilot_rows(cx.shape[0], call.k_eff, tps * bn, bm) if hasattr(K, "pilot_rows")
                 else 0)
        bound = (dict(zip(("bound_v", "bound_i"),
                          K.pilot_bound(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn, pilot)))
                 if pilot else {})
        ok &= n_pilots == int(pilot > 0)
        sv, si, sk, st = K.knn_scan(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn, True, splits,
                                    return_stats=True, **bound)
        pv, pi, psk = K.knn_scan_plain(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn, True, splits,
                                       **bound)
        mv, mi = K.knn_merge(sv, si)
        mpv, mpi = K.knn_merge_plain(sv, si)
        ref = ops.finish(call, *K.knn_merge_plain(pv, pi))
        self.sync()

        xmax = float(cxn[torch.isfinite(cxn)].max())
        tol = TOL_REL * (qn[:m, None] + xmax)
        ok_end, err_end, checked = self._close(v, i, ref.scores, ref.indices, tol)
        ok_scan, err_scan, _ = self._close(sv, si, pv, pi,
                                           TOL_REL * (qn[:, None, None] + xmax))
        merge_exact = torch.equal(mv, mpv) and torch.equal(mi, mpi)
        ok &= ok_end and ok_scan and merge_exact
        log(f"{label}: search vs plain max|d|={err_end:.3e} (tol {float(tol.max()):.3e}), "
            f"indices checked {checked}/{v.numel()}; scan max|d|={err_scan:.3e}; "
            f"merge bit-identical={merge_exact}; skips kernel={int(sk.sum())} "
            f"plain={int(psk.sum())} of {m_tiles * n_tiles}; ok={ok}")

        scan_ms = self.ms(lambda: K.knn_scan(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn,
                                             True, splits, **bound))
        merge_ms = self.ms(lambda: K.knn_merge(sv, si))
        good, pilot_ms, pilot_work = self._pilot(label, call, qn, splits, pilot, st, mv, mi,
                                                 scan_ms)
        ok &= good
        plain_scan_ms = self.ms(lambda: K.knn_scan_plain(cq, cx, qn, cxn, call.k_eff, "l2",
                                                         bm, bn, True, splits))
        plain_merge_ms = self.ms(lambda: K.knn_merge_plain(sv, si))
        lib_scan_ms, lib_form = self._library_scan_ms(label, cq[:m], cx[: ds.n_valid], k)
        flat = sv.reshape(sv.shape[0], -1)
        lib_merge_ms = self.ms(lambda: torch.topk(flat, call.k_eff, largest=False))

        # the bound of the function: its data read once (no padding), the
        # (m, k) result written once, 2·d + the epilogue's operations per pair
        n_valid, d = ds.n_valid, q.shape[1]
        scan_bytes = ((n_valid + m) * d * cx.element_size() + (n_valid + m) * 4
                      + m * k * 8)
        scan_ops = m * n_valid * (2 * d + L2_EPILOGUE_OPS)
        # the design's own work: the padded rows and their norms once per
        # m-tile, the padded queries, the S per-block queues and skip counts,
        # the padded rows' FMAs and epilogues, and the survivor filter's
        # sorts, rank searches and merges as the kernel counts them, whose
        # queues live in device memory (each moved pair read and written)
        sel = self.select_work(st, call.k_eff, cq.shape[0] * cx.shape[0])
        design_bytes = (m_tiles * (cx.numel() * cx.element_size() + cxn.numel() * 4)
                        + cq.numel() * cq.element_size() + qn.numel() * 4 + sv.numel() * 8
                        + sk.numel() * 4 + sel["pairs_moved"] * 16 + sel["survivors"] * 8)
        design_ops = (cq.shape[0] * cx.shape[0] * (2 * cx.shape[1] + L2_EPILOGUE_OPS)
                      + sel["ops"])
        design_bytes, design_ops = design_bytes + pilot_work[0], design_ops + pilot_work[1]
        merge_bytes, merge_ops = self.merge_work(sv, si, mv, mi)
        shape = {"shape": label, "splits": splits, "blocks": [bm, bn, call.blocks[2]],
                 "search_ms": statistics.median(e2e), "select": sel, "kernels": {}}
        library = {"knn_scan": f"torch.topk(torch.cdist(q, x, compute_mode={lib_form!r})**2)",
                   "knn_merge": "torch.topk(queues.reshape(m, -1))"}
        # a search's kernels: the pilot's launch of each (where it runs) and
        # the main one, timed apart and summed against the function's bound
        for name, t, tp, tl, (bb, by), err in (
                ("knn_scan", scan_ms, plain_scan_ms, lib_scan_ms,
                 self.bound(scan_bytes, scan_ops), err_scan),
                ("knn_merge", merge_ms, plain_merge_ms, lib_merge_ms,
                 self.bound(merge_bytes, merge_ops), 0.0 if merge_exact else math.inf)):
            shape["kernels"][name] = {
                "launches": launches[name], "max_abs_err": err, "ms": t + pilot_ms[name],
                "pilot_ms": pilot_ms[name], "plain_ms": tp, "bound_ms": bb, "bound_by": by,
                "library_ms": tl, "library": library[name]}
            log(f"{label}: {name} ms={t + pilot_ms[name]:.4f} (pilot {pilot_ms[name]:.4f} + "
                f"main {t:.4f}) plain_ms={tp:.4f} library_ms={tl} bound_ms={bb:.4f} ({by}) "
                f"launches={launches[name]}")
        design_ms, _ = self.bound(design_bytes, design_ops)
        shape["kernels"]["knn_scan"]["design_bound_ms"] = design_ms
        log(f"{label}: knn_scan survivor filter {sel}")
        log(f"{label}: knn_scan bound over the padded operands, queues and survivor work "
            f"design_bound_ms={design_ms:.4f}")
        log(f"{label}: search ms median={statistics.median(e2e):.3f} "
            f"all={[round(t, 3) for t in e2e]} splits={splits} blocks={call.blocks}")
        self.shapes.append(shape)
        return ok

    def _pilot(self, label, call, qn, splits, pilot, st, mv, mi, scan_ms):
        """A main-path search's pilot (``kernel.pilot_bound``) at its own
        shape, or where the rule bypasses it, a line that says so. Where it
        engages: its knn_scan (the strided rows read in place, an eighth of
        the bm, the card's S) held against knn_scan_plain on the same views
        and its knn_merge against knn_merge_plain bit for bit, the bound
        its merged k_eff-th pair; each timed; the scan without the bound
        (its ms and survivor share; its merged answer must equal the bounded
        one bit for bit); the pilot swept at 8, 16 and 32·k_eff rows.
        Returns (ok, the pilot's ms by kernel name, (bytes, operations) of
        the pilot's design work)."""
        torch, K = self.torch, self.K
        bm, bn, _ = call.blocks
        cq, cx, cxn = call.q, call.x, call.xn
        args = (cq, cx, qn, cxn, call.k_eff, "l2", bm, bn, True, splits)
        lanes = cq.shape[0] * cx.shape[0]
        if not pilot:
            has = hasattr(K, "PILOT")
            log(f"{label}: pilot bypassed (a split scans "
                f"{K.tiles_per_split(cx.shape[0] // bn, splits) * bn} rows; "
                f"{K.PILOT if has else '-'}·k_eff = {K.PILOT * call.k_eff if has else '-'}; "
                f"{cx.shape[0]} rows); survivors {int(st[..., 0].sum()) / lanes:.6f} of the lanes")
            return True, {"knn_scan": 0.0, "knn_merge": 0.0}, (0, 0)
        stride, pbm = cx.shape[0] // pilot, max(1, bm // 8)
        px, pxn = cx[::stride][:pilot], cxn[::stride][:pilot]
        psplits = K.scan_config(cq.shape[0] // pbm, pilot // bn, pbm, self.dev)[0]
        pargs = (cq, px, qn, pxn, call.k_eff, "l2", pbm, bn, True, psplits)
        sv, si, ssk, sst = K.knn_scan(*pargs, return_stats=True)
        pv, pi, psk = K.knn_scan_plain(*pargs)
        pmv, pmi = K.knn_merge(sv, si)
        ppv, ppi = K.knn_merge_plain(sv, si)
        bv, bi = K.pilot_bound(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn, pilot)
        self.sync()
        xmax = float(pxn[torch.isfinite(pxn)].max())
        ok_scan, err, checked = self._close(sv, si, pv, pi, TOL_REL * (qn[:, None, None] + xmax))
        merge_exact = torch.equal(pmv, ppv) and torch.equal(pmi, ppi)
        bound_exact = torch.equal(bv, pmv[:, -1]) and torch.equal(
            bi, torch.where(pmi[:, -1] >= 0, pmi[:, -1] * stride, -1))
        ms = {"knn_scan": self.ms(lambda: K.knn_scan(*pargs)),
              "knn_merge": self.ms(lambda: K.knn_merge(sv, si))}
        whole_ms = self.ms(lambda: K.pilot_bound(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn,
                                                 pilot))
        psel = self.select_work(sst, call.k_eff, cq.shape[0] * pilot)
        work = ((cq.shape[0] // pbm) * (px.shape[0] * px.shape[1] * px.element_size()
                                         + pilot * 4) + sv.numel() * 8 + psel["pairs_moved"] * 16
                + psel["survivors"] * 8,
                cq.shape[0] * pilot * (2 * cx.shape[1] + L2_EPILOGUE_OPS) + psel["ops"])
        log(f"{label}: pilot of {pilot} rows (stride {stride}, bm {pbm}, S={psplits}): scan vs "
            f"plain max|d|={err:.3e}, indices checked {checked}/{sv.numel()}, skips kernel="
            f"{int(ssk.sum())} plain={int(psk.sum())}; merge bit-identical={merge_exact}; bound "
            f"= its merged k_eff-th pair={bound_exact}; knn_scan {ms['knn_scan']:.4f} ms, "
            f"knn_merge {ms['knn_merge']:.4f} ms, pilot_bound whole {whole_ms:.4f} ms "
            f"[{self.card}]")
        fv, fi, _, fst = K.knn_scan(*args, return_stats=True)
        free_v, free_i = K.knn_merge(fv, fi)
        same = torch.equal(free_v, mv) and torch.equal(free_i, mi)
        free_ms = self.ms(lambda: K.knn_scan(*args))
        log(f"{label}: knn_scan bounded {scan_ms:.4f} ms, survivors "
            f"{int(st[..., 0].sum()) / lanes:.6f}; unbounded {free_ms:.4f} ms, survivors "
            f"{int(fst[..., 0].sum()) / lanes:.6f}; merged answers bit-identical={same} "
            f"[{self.card}]")
        for factor in (8, K.PILOT, 32):
            rows = factor * call.k_eff
            if rows % bn or cx.shape[0] // rows < 1:
                continue
            pilot_ms = self.ms(lambda: K.pilot_bound(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn,
                                                     rows))
            sbv, sbi = K.pilot_bound(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn, rows)
            *_, bst = K.knn_scan(*args, return_stats=True, bound_v=sbv, bound_i=sbi)
            bounded_ms = self.ms(lambda: K.knn_scan(*args, bound_v=sbv, bound_i=sbi))
            log(f"{label}: pilot sweep {factor}·k_eff = {rows} rows: pilot_ms={pilot_ms:.4f} "
                f"bounded_scan_ms={bounded_ms:.4f} survivors "
                f"{int(bst[..., 0].sum()) / lanes:.6f} sum_ms={pilot_ms + bounded_ms:.4f}")
        return ok_scan and merge_exact and bound_exact and same, ms, work

    def _pilot_cost(self, label, call) -> bool:
        """ops.knn's kernels at a prepared call three ways: knn_fused as the
        package runs it (the pilot where its rule engages), a pilot of
        PILOT·k_eff rows forced before the scan, and no pilot; each with its
        query norms, timed by CUDA events (runs of 10 calls back to back,
        per call) and by the host's clock (a call and a sync). The three
        answers must be bit-identical."""
        torch, K = self.torch, self.K
        bm, bn, bd = call.blocks
        q, x, xn, k_eff = call.q, call.x, call.xn, call.k_eff
        splits, tps, _ = K.scan_config(q.shape[0] // bm, x.shape[0] // bn, bm, self.dev)
        rows, rule = K.PILOT * k_eff, K.pilot_rows(x.shape[0], k_eff, tps * bn, bm)
        if rows % bn or x.shape[0] < rows:
            log(f"{label}: no pilot of {rows} rows fits {x.shape[0]} rows at bn {bn}")
            return True

        def scan(bound_rows):
            qn = self.qnorm(q)
            bound = {}
            if bound_rows:
                bound = dict(zip(("bound_v", "bound_i"), K.pilot_bound(
                    q, x, qn, xn, k_eff, call.metric, bm, bn, bound_rows)))
            sv, si, _ = K.knn_scan(q, x, qn, xn, k_eff, call.metric, bm, bn, True, splits,
                                   **bound)
            return K.knn_merge(sv, si)

        ways = {"fused": lambda: K.knn_fused(q, x, xn, k_eff, call.metric, bm, bn, bd)[:2],
                "pilot": lambda: scan(rows), "none": lambda: scan(0)}
        answers = {name: fn() for name, fn in ways.items()}
        same = all(torch.equal(a[0], answers["none"][0]) and torch.equal(a[1], answers["none"][1])
                   for a in answers.values())
        ev = {name: self.ms(fn, calls=10) for name, fn in ways.items()}
        host = {name: self.host_clock_ms(fn, REPEATS)[0] for name, fn in ways.items()}
        log(f"{label}: {q.shape[0]} x {x.shape[0]} rows, k_eff {k_eff}, bm {bm}, S={splits}, "
            f"a split {tps * bn} rows; rule engages={bool(rule)}; ms by events fused/pilot/none "
            f"{ev['fused']:.4f} / {ev['pilot']:.4f} / {ev['none']:.4f}, by the host's clock "
            f"{host['fused']:.4f} / {host['pilot']:.4f} / {host['none']:.4f}; answers "
            f"bit-identical={same} [{self.card}]")
        return same

    def _library_scan_ms(self, label, q, x, k):
        """torch.topk over torch.cdist(q, x)²: the same kNN from one library
        call each (a yardstick only; the port never calls them). cdist's
        default matrix-product form squares and copies x, three times its
        size, which a 31.7 GB dataset cannot afford; there the direct form
        (one pass over x) is timed instead. Returns (ms, form)."""
        torch = self.torch
        for mode in ("use_mm_for_euclid_dist_if_necessary", "donot_use_mm_for_euclid_dist"):
            try:
                t = self.ms(lambda: torch.topk(torch.cdist(q, x, compute_mode=mode) ** 2,
                                               k, largest=False))
                return t, mode
            except torch.cuda.OutOfMemoryError:
                log(f"{label}: torch.cdist ({mode}) ran out of device memory")
            finally:
                torch.cuda.empty_cache()
        return None, None

    def _close(self, v, i, pv, pi, tol, gap=None):
        """Scores within tol; indices equal where the plain neighbours' gaps
        exceed ``gap`` (2·tol by default). Returns (ok, max |d| over finite
        scores, indices checked)."""
        torch = self.torch
        fin = torch.isfinite(pv)
        if not torch.equal(torch.isfinite(v), fin):
            return False, math.inf, 0
        diff = (v - pv).abs()
        err = float(diff[fin].max()) if bool(fin.any()) else 0.0
        tol = tol.expand_as(pv)
        ok = bool((diff[fin] <= tol[fin]).all())
        gaps = pv.diff(dim=-1)
        gap = 2 * tol if gap is None else gap.expand_as(pv)
        sep = fin.clone()
        sep[..., 1:] &= gaps > gap[..., 1:]
        sep[..., :-1] &= gaps > gap[..., :-1]
        sep[..., -1] = False  # the next score is unknown
        ok &= bool((i[sep] == pi[sep]).all())
        return ok, err, int(sep.sum())

    def _dataset(self, n, d, m, seed):
        """Gaussian rows made on the device from a seed, and m queries near
        random rows of them."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn(n, d, generator=g, device=self.dev)
        pick = torch.randint(0, n, (m,), generator=g, device=self.dev)
        q = x[pick] + 0.3 * torch.randn(m, d, generator=g, device=self.dev)
        return x, q

    def _fit(self, label, x, k):
        from repro_torch import ExactKNN

        t0 = time.perf_counter()
        eng = ExactKNN(k=k, backend="cuda", device=self.dev).fit(x)
        self.sync()
        log(f"{label}: fit {tuple(x.shape)} -> {tuple(eng._ds.vectors.shape)} in "
            f"{time.perf_counter() - t0:.2f} s")
        return eng

    def phase_gist(self) -> bool:
        x, q = self._dataset(GIST["n"], GIST["d"], GIST["m"], seed=3)
        eng = self._fit("gist", x, GIST["k"])
        del x  # the engine holds the padded copy only
        ok = self.main_path(f"gist_fqsd_m{GIST['m']}_k{GIST['k']}", eng, q, GIST["k"], "fqsd")
        del eng
        self.torch.cuda.empty_cache()
        if hasattr(self.K, "pilot_bound"):  # the small engine the pilot's rule bypasses
            cfg = PILOT_SMALL
            x, q = self._dataset(cfg["n"], cfg["d"], max(cfg["ms"]), seed=21)
            eng = self._fit("pilot_small", x, cfg["k"])
            for m in cfg["ms"]:
                call = self.ops.prepare(eng._pad_queries(q[:m]), eng._ds.vectors, cfg["k"],
                                        "l2", eng._ds.norms)
                ok &= self._pilot_cost(f"pilot_small_n{cfg['n']}_m{m}_k{cfg['k']}", call)
            del eng, x
        return ok

    def phase_msmarco(self) -> bool:
        torch = self.torch
        x, q = self._dataset(MSMARCO["n"], MSMARCO["d"], MSMARCO["m"], seed=4)
        eng = self._fit("msmarco", x, MSMARCO["ks"][0])
        del x  # the unpadded source goes before the searches
        torch.cuda.empty_cache()
        ok = True
        for k in MSMARCO["ks"]:
            ok &= self.main_path(f"msmarco_fdsq_m{MSMARCO['m']}_k{k}", eng, q, k, "fdsq")
        log(f"msmarco: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        self.msmarco_eng = eng  # the int8 phase quantises this resident dataset
        return ok

    # ------------------------------------------------------ phase 5: int8
    def phase_int8(self) -> bool:
        torch = self.torch
        ok = True
        eng = self.msmarco_eng
        if eng is None:  # phase 4 did not run: make the same dataset
            x, _ = self._dataset(MSMARCO["n"], MSMARCO["d"], 1, seed=4)
            eng = self._fit("msmarco", x, INT8["msmarco_k"])
            del x
        self.msmarco_eng = None
        g = torch.Generator(device=self.dev).manual_seed(6)
        pick = torch.randint(0, eng.n, (INT8["m"],), generator=g, device=self.dev)
        q = (eng._ds.vectors[pick, : MSMARCO["d"]]
             + 0.3 * torch.randn(INT8["m"], MSMARCO["d"], generator=g, device=self.dev))
        ok &= self.main_path_int8(f"msmarco_fqsd_int8_m{INT8['m']}_k{INT8['msmarco_k']}",
                                  eng, q, INT8["msmarco_k"])
        del eng
        torch.cuda.empty_cache()
        x, q = self._dataset(GIST["n"], GIST["d"], INT8["m"], seed=3)  # phase 3's data
        eng = self._fit("gist", x, INT8["gist_k"])
        del x
        ok &= self.main_path_int8(f"gist_fqsd_int8_m{INT8['m']}_k{INT8['gist_k']}",
                                  eng, q, INT8["gist_k"])
        if hasattr(self.K, "pilot_bound"):  # the fallback's f32 scan at 1, 4 and 16 rows
            from repro_torch.core.partition import next_pow2

            w, ds = 2 * next_pow2(INT8["gist_k"]), eng._ds
            for m in PILOT_FALLBACK_MS:
                call = self.ops.prepare(eng._pad_queries(q[:m]), ds.vectors, w, "l2", ds.norms)
                ok &= self._pilot_cost(f"pilot_int8_fallback_m{m}_w{w}", call)
                del call
        del eng
        torch.cuda.empty_cache()
        return ok

    def main_path_int8(self, label: str, eng, q, k: int) -> bool:
        """One int8-tier search on the main path, held against the port's
        direct-form oracle and the scan's plain version, timed by phase."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch import SearchRequest

        t0 = time.perf_counter()
        eng.enable_int8()
        self.sync()
        quantize_s = time.perf_counter() - t0
        req = SearchRequest(queries=q, k=k, tier="int8")
        self.sync()
        K.reset_launch_counts()
        res = eng.search(req)
        self.sync()
        launches = dict(K.LAUNCHES)
        cert = res.certified
        m = q.shape[0]
        v, i = res.topk.scores, res.topk.indices
        # rows the int8 certificate leaves are recomputed through the f32
        # kernel (knn_exact_rescored: one knn_scan + one knn_merge more, and
        # a pilot's pair where the rule engages at its rows and queue)
        from repro_torch.core.partition import next_pow2

        n_bad = int((~cert).sum())
        refit = int(n_bad > 0) * (1 + self.pilots(*eng._ds.vectors.shape, n_bad,
                                                  2 * next_pow2(k)))
        ok = (res.plan.executor == "fqsd-int8-cuda" and launches["knn_int8_scan"] >= 1
              and launches["knn_merge"] == 1 + refit and launches["knn_scan"] == refit)
        ok &= tuple(v.shape) == (m, k) and bool(torch.isfinite(v).all())
        ok &= bool(((i >= 0) & (i < eng.n)).all())
        share = float(cert.to(torch.float32).mean())
        log(f"{label}: quantised in {quantize_s:.2f} s; executor={res.plan.executor} "
            f"launches={launches} skip_rate={float(res.kernel_stats['prune_skip_rate']):.6f} "
            f"blocks={res.kernel_stats['blocks']} certified {int(cert.sum())}/{m} "
            f"(share {share:.4f})")

        e2e = []
        for _ in range(REPEATS):
            t1 = time.perf_counter()
            eng.search(req)
            self.sync()
            e2e.append((time.perf_counter() - t1) * 1e3)

        # every row against the port's own oracle: certified rows come from
        # the rescore, the others from the fallback, both in the direct form
        ds, qv, chunk = eng._ds, eng._pad_queries(q), res.plan.chunk_rows
        t1 = time.perf_counter()
        oracle = ops.knn_exact_direct(qv, ds.vectors, ds.norms, k, chunk)
        self.sync()
        oracle_s = time.perf_counter() - t1
        cert_exact = (torch.equal(v[cert], oracle.scores[cert])
                      and torch.equal(i[cert], oracle.indices[cert]))
        all_exact = torch.equal(v, oracle.scores) and torch.equal(i, oracle.indices)
        ok &= cert_exact and all_exact

        # the kernels' operands, exactly as the executor prepares them
        call = ops.prepare_int8(qv, eng._int8, k, res.plan.rescore_factor)
        bm, bn, _ = call.blocks
        args = (call.q, call.x8, call.qn, call.scales, call.err, call.hn, call.q_len, bm, bn)
        m_tiles, n_tiles = call.q.shape[0] // bm, call.hn.shape[0] // bn
        splits = K.int8_scan_config(m_tiles, n_tiles, bm, self.dev)[0]
        sv, si, sk, st = K.knn_int8_scan(*args, True, splits, return_stats=True)
        pv, pi, psk = K.knn_int8_scan_plain(*args, True, splits)
        lb, li = K.knn_merge(sv, si)
        mpv, mpi = K.knn_merge_plain(sv, si)
        out, cert2 = ops.rescore_certify(qv, lb[:m], li[:m], ds.vectors, k, call.r)
        self.sync()
        hmax = float(call.hn[torch.isfinite(call.hn)].max())
        ok_scan, err_scan, _ = self._close(sv, si, pv, pi,
                                           TOL_REL * (call.qn[:, None, None] + hmax))
        merge_exact = torch.equal(lb, mpv) and torch.equal(li, mpi)
        rescore_same = torch.equal(cert2, cert) and torch.equal(out.scores[cert], v[cert])
        ok &= ok_scan and merge_exact and rescore_same
        log(f"{label}: all rows bit-identical to knn_exact_direct={all_exact} (certified "
            f"rows {cert_exact}); oracle {oracle_s:.2f} s; scan vs plain max|d|={err_scan:.3e}; "
            f"merge bit-identical={merge_exact}; rescore repeats the search={rescore_same}; "
            f"skips kernel={int(sk.sum())} plain={int(psk.sum())} of {m_tiles * n_tiles}; "
            f"ok={ok}")

        scan_ms = self.ms(lambda: K.knn_int8_scan(*args, True, splits))
        merge_ms = self.ms(lambda: K.knn_merge(sv, si))
        rescore_ms = self.ms(lambda: ops.rescore_certify(qv, lb[:m], li[:m], ds.vectors, k,
                                                         call.r))
        bad = ~cert
        fallback_ms = (self.ms(lambda: ops.knn_exact_rescored(qv[bad], ds.vectors, ds.norms,
                                                              k, chunk))
                       if bool(bad.any()) else 0.0)
        direct_fallback_ms = (self.ms(lambda: ops.knn_exact_direct(
            qv[bad], ds.vectors, ds.norms, k, chunk), repeats=1) if bool(bad.any()) else 0.0)
        plain_scan_ms = self.ms(lambda: K.knn_int8_scan_plain(*args, True, splits))
        plain_merge_ms = self.ms(lambda: K.knn_merge_plain(sv, si))
        flat = sv.reshape(sv.shape[0], -1)
        lib_merge_ms = self.ms(lambda: torch.topk(flat, call.q_len, largest=False))
        # the yardstick of the whole int8 search: the f32 scan at the same shape
        fcall = ops.prepare(qv, ds.vectors, k, "l2", ds.norms)
        fbm, fbn, _ = fcall.blocks
        fqn = self.qnorm(fcall.q)
        f32_scan_ms = self.ms(lambda: K.knn_scan(fcall.q, fcall.x, fqn, fcall.xn, fcall.k_eff,
                                                 "l2", fbm, fbn, True))

        # the bound of the function: codes (1 B), scales, err and hn of the
        # valid rows, the unpadded queries, the (m, q_len) queue written once
        n_valid, d = eng.n, q.shape[1]
        scan_bytes = n_valid * d + 3 * n_valid * 4 + m * (d + 1) * 4 + m * call.q_len * 8
        scan_ops = m * n_valid * (2 * d + INT8_EPILOGUE_OPS)
        # the design's own work: the codes and channels once per m-tile, the
        # padded rows' FMAs and epilogues, the S queues written, and the
        # survivor filter's sorts, rank searches and merges, whose queues
        # live in device memory (each moved pair read and written)
        mp, dp = call.q.shape[0], call.x8.shape[1]
        rows = n_tiles * bn
        sel = self.select_work(st, call.q_len, mp * rows)
        design_bytes = (m_tiles * (call.x8.numel() + 3 * rows * 4) + call.q.numel() * 4
                        + call.qn.numel() * 4 + sv.numel() * 8 + sk.numel() * 4
                        + sel["pairs_moved"] * 16 + sel["survivors"] * 8)
        design_ops = mp * rows * (2 * dp + INT8_EPILOGUE_OPS) + sel["ops"]
        merge_bytes, merge_ops = self.merge_work(sv, si, lb, li)
        shape = {"shape": label, "splits": splits, "blocks": [bm, bn, call.blocks[2]],
                 "q_len": call.q_len, "search_ms": statistics.median(e2e),
                 "certified_share": share, "rescore_ms": rescore_ms,
                 "fallback_ms": fallback_ms, "direct_fallback_ms": direct_fallback_ms,
                 "f32_scan_ms": f32_scan_ms,
                 "quantize_s": quantize_s, "select": sel, "kernels": {}}
        # the fallback's knn() launches one knn_scan and one knn_merge per
        # call; its merges are counted in the fallback's own entry below
        launches["knn_merge"] -= launches["knn_scan"]
        for name, t, tp, tl, lib, (bb, by), err in (
                ("knn_int8_scan", scan_ms, plain_scan_ms, None, None,
                 self.bound(scan_bytes, scan_ops), err_scan),
                ("knn_merge", merge_ms, plain_merge_ms, lib_merge_ms,
                 "torch.topk(queues.reshape(m, -1))", self.bound(merge_bytes, merge_ops),
                 0.0 if merge_exact else math.inf)):
            shape["kernels"][name] = {
                "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": tp,
                "bound_ms": bb, "bound_by": by, "library_ms": tl, "library": lib}
            log(f"{label}: {name} ms={t:.4f} plain_ms={tp:.4f} library_ms={tl} "
                f"bound_ms={bb:.4f} ({by}) launches={launches[name]}")
        bb_bytes, _ = self.bound(scan_bytes, 0)
        bb_ops, _ = self.bound(0, scan_ops)
        design_ms, _ = self.bound(design_bytes, design_ops)
        shape["kernels"]["knn_int8_scan"]["design_bound_ms"] = design_ms
        fallback = None
        if refit:
            fallback = self._fallback_kernels(label, qv[bad], ds, k, d, launches["knn_scan"])
            ok &= fallback.pop("ok")
        log(f"{label}: knn_int8_scan survivor filter {sel}")
        log(f"{label}: knn_int8_scan bound by bytes {bb_bytes:.4f} ms, by operations "
            f"{bb_ops:.4f} ms (padded operands, queues and survivor work: {design_ms:.4f} ms); "
            f"f32 knn_scan at this shape {f32_scan_ms:.4f} ms; rescore "
            f"{rescore_ms:.4f} ms; fallback {fallback_ms:.4f} ms ({int(bad.sum())} rows, "
            f"knn_exact_rescored; knn_exact_direct alone {direct_fallback_ms:.4f} ms)")
        log(f"{label}: search ms median={statistics.median(e2e):.3f} "
            f"all={[round(t, 3) for t in e2e]} splits={splits} blocks={call.blocks}")
        self.shapes.append(shape)
        if fallback is not None:
            self.shapes.append(fallback)
        return ok

    def _fallback_kernels(self, label, qb, ds, k, d, launches) -> dict:
        """knn_scan and knn_merge as knn_exact_rescored runs them on the
        uncertified rows qb (queue 2·k_eff wide, the queries' first d columns
        real; bounded by a pilot where the rule engages, checked as the
        main path's), each against its plain version, timed (a pilot's
        launch added to each) beside its library call and its bound; the
        rows its certificate leaves to knn_exact_direct. Returns the
        fallback's shape entry, with "ok"."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch.core.partition import next_pow2

        w = 2 * next_pow2(k)
        call = ops.prepare(qb, ds.vectors, w, "l2", ds.norms)
        bm, bn, _ = call.blocks
        qn = self.qnorm(call.q)
        splits, tps, _ = K.scan_config(call.q.shape[0] // bm, call.x.shape[0] // bn, bm,
                                       self.dev)
        pilot = (K.pilot_rows(call.x.shape[0], call.k_eff, tps * bn, bm)
                 if hasattr(K, "pilot_rows") else 0)
        bound = (dict(zip(("bound_v", "bound_i"), K.pilot_bound(
            call.q, call.x, qn, call.xn, call.k_eff, "l2", bm, bn, pilot))) if pilot else {})
        args = (call.q, call.x, qn, call.xn, call.k_eff, "l2", bm, bn, True, splits)
        sv, si, _, st = K.knn_scan(*args, return_stats=True, **bound)
        pv, pi, _ = K.knn_scan_plain(*args, **bound)
        mv, mi = K.knn_merge(sv, si)
        mpv, mpi = K.knn_merge_plain(sv, si)
        _, cert = ops.certify_candidates(qb, ds.vectors, ds.norms, k, ops.finish(call, mv, mi))
        self.sync()
        xmax = float(call.xn[torch.isfinite(call.xn)].max())
        ok_scan, err, _ = self._close(sv, si, pv, pi, TOL_REL * (qn[:, None, None] + xmax))
        merge_exact = torch.equal(mv, mpv) and torch.equal(mi, mpi)
        scan_ms = self.ms(lambda: K.knn_scan(*args, **bound))
        ok_pilot, pilot_ms, _ = self._pilot(f"{label}_fallback", call, qn, splits, pilot, st,
                                            mv, mi, scan_ms)
        m, n = qb.shape[0], ds.n_valid
        flat = sv.reshape(sv.shape[0], -1)
        entries = {}
        for name, t, plain, lib, lib_fn, (bb, by), e in (
                ("knn_scan", scan_ms, lambda: K.knn_scan_plain(*args, **bound),
                 "torch.topk(torch.cdist(q, x)**2)",
                 lambda: self._library_scan_ms(label, call.q[:m], call.x[:n], w)[0],
                 self.bound((n + m) * d * 4 + (n + m) * 4 + m * w * 8,
                            m * n * (2 * d + L2_EPILOGUE_OPS)), err if ok_scan else math.inf),
                ("knn_merge", self.ms(lambda: K.knn_merge(sv, si)),
                 lambda: K.knn_merge_plain(sv, si), "torch.topk(queues.reshape(m, -1))",
                 lambda: self.ms(lambda: torch.topk(flat, call.k_eff, largest=False)),
                 self.bound(*self.merge_work(sv, si, mv, mi)),
                 0.0 if merge_exact else math.inf)):
            entries[name] = {"launches": launches, "max_abs_err": e, "ms": t + pilot_ms[name],
                             "pilot_ms": pilot_ms[name], "plain_ms": self.ms(plain),
                             "bound_ms": bb, "bound_by": by, "library_ms": lib_fn(),
                             "library": lib}
            log(f"{label}: fallback {name} ({m} rows, queue {w}, S={splits}) "
                f"ms={entries[name]['ms']:.4f} (pilot {pilot_ms[name]:.4f}) "
                f"plain_ms={entries[name]['plain_ms']:.4f} "
                f"library_ms={entries[name]['library_ms']} bound_ms={bb:.4f} ({by}) "
                f"max|d|={e:.3e} launches={launches} [{self.card}]")
        left = int((~cert).sum())
        log(f"{label}: fallback scan within tolerance={ok_scan}, merge bit-identical="
            f"{merge_exact}; {m - left}/{m} rows certified, {left} left to knn_exact_direct")
        return {"shape": f"{label}_fallback", "fallback_of": label,
                "ok": ok_scan and merge_exact and ok_pilot,
                "per": f"the int8 fallback's f32 scan and merge of {m} rows, queue {w}",
                "rows_left_to_direct": left, "kernels": entries}

    # -------------------------------------------------- phase 6: streamed
    def host_clock_ms(self, fn, repeats: int) -> tuple[float, list[float]]:
        """Median host-clock time of fn (each run ending in a synchronise)
        over `repeats` runs after a warm-up, and every run's time."""
        fn()
        self.sync()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), times

    @staticmethod
    def host_ram() -> str:
        fields = {}
        for line in Path("/proc/meminfo").read_text().splitlines():
            key, _, rest = line.partition(":")
            fields[key] = rest.strip()
        return f"MemTotal {fields.get('MemTotal')} MemAvailable {fields.get('MemAvailable')}"

    def copy_rate(self, shard) -> tuple[float, float]:
        """Pinned host -> device copy of one f32 shard (vectors + norms):
        (median ms of 10 by CUDA events, bytes/s)."""
        torch = self.torch
        dst = [torch.empty_like(t, device=self.dev) for t in (shard.vectors, shard.norms)]
        nbytes = sum(t.numel() * t.element_size() for t in dst)

        def copy():
            for d_, s_ in zip(dst, (shard.vectors, shard.norms)):
                d_.copy_(s_, non_blocking=True)

        t = self.ms(copy, repeats=STREAMED["repeats"])
        return t, nbytes / (t * 1e-3)

    def phase_streamed(self) -> bool:
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch import ExactKNN, SearchRequest
        from repro_torch.core.fqsd import make_partition_step, streamed_direct_scan
        from repro_torch.core.quantized import make_int8_bound_step
        from repro_torch.core.streaming import DoubleBufferedStream, device_put_partition
        from repro_torch.store import DatasetStore

        cfg = STREAMED
        n, d, m, k = cfg["n"], cfg["d"], cfg["m"], cfg["k"]
        log(f"streamed: host RAM {self.host_ram()}")
        x, q = self._dataset(n, d, m, seed=cfg["seed"])
        t0 = time.perf_counter()
        store = DatasetStore.from_array(x, rows_per_shard=cfg["rows_per_shard"], pin_memory=True)
        del x
        self.sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.ensure_tier("int8", device=self.dev)
        self.sync()
        quant_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        shard_rows, dp, n_shards = store.rows_per_shard, store.padded_dim, store.n_shards
        f32_bytes = n_shards * shard_rows * (dp + 1) * 4  # vectors + norms a shard
        int8_bytes = sum(store.read_shard(i, "int8").scan_bytes() for i in range(n_shards))
        log(f"streamed: pinned store of {n_shards} shards x {shard_rows} rows x {dp} "
            f"({store.n_main} valid, {f32_bytes} B f32 + norms shipped a search) built in "
            f"{build_s:.2f} s; int8 tier ({int8_bytes} B a search) quantised on the card in "
            f"{quant_s:.2f} s; pinned={store.is_pinned}")
        copy_ms, rate = self.copy_rate(store.read_shard(0))
        log(f"streamed: pinned copy of one shard {copy_ms:.4f} ms -> {rate / 1e9:.3f} GB/s "
            f"(median of {cfg['repeats']}, CUDA events) [{self.card}]")

        eng = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(store, resident=False)
        eng.enable_int8()
        qv = eng._pad_queries(q)
        ok = True
        results = {}
        # ---- the main path: one search of each tier, counters read around it
        for tier, kernels in (("f32", ("knn_scan", "knn_merge")),
                              ("int8", ("knn_int8_scan", "knn_merge"))):
            req = SearchRequest(queries=q, k=k, tier=tier, prefetch_depth=2)
            self.sync()
            K.reset_launch_counts()
            res = eng.search(req)
            self.sync()
            launches = dict(K.LAUNCHES)
            want_exec = "fqsd-mmap-streamed" if tier == "f32" else "fqsd-int8-streamed"
            good = (res.plan.executor == want_exec and res.stats["transfers"] == n_shards
                    and all(launches[name] == n_shards for name in kernels)
                    and sum(launches.values()) == 2 * n_shards)
            v, i = res.topk.scores, res.topk.indices
            good &= tuple(v.shape) == (m, k) and bool(torch.isfinite(v).all())
            good &= bool(((i >= 0) & (i < store.n_main)).all())
            log(f"streamed {tier}: executor={res.plan.executor} transfers="
                f"{res.stats['transfers']} bytes_scanned={res.stats['bytes_scanned']} "
                f"launches={launches} health={res.stats['health']} ok={good}")
            ok &= good
            results[tier] = (res, launches)

        # ---- (a) f32: bit-identical to a resident fdsq-cuda search of the store
        resident = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(store, resident=True)
        want = resident.search(SearchRequest(queries=q, k=k, mode_hint="fqsd"))
        got = results["f32"][0]
        check_a = (want.plan.executor == "fdsq-cuda"
                   and torch.equal(got.topk.scores, want.topk.scores)
                   and torch.equal(got.topk.indices, want.topk.indices))
        log(f"streamed check (a): f32 streamed bit-identical to resident fdsq-cuda={check_a}")

        # ---- (b) int8: = streamed_direct_scan, = resident int8 where both certified
        got8 = results["int8"][0]
        oracle = streamed_direct_scan(qv, store.shard_source("f32"), k)
        resident.enable_int8()
        res8 = resident.search(SearchRequest(queries=q, k=k, tier="int8"))
        both = got8.certified & res8.certified
        check_b = (torch.equal(got8.topk.scores, oracle.scores)
                   and torch.equal(got8.topk.indices, oracle.indices)
                   and res8.plan.executor == "fqsd-int8-cuda"
                   and torch.equal(got8.topk.scores[both], res8.topk.scores[both])
                   and torch.equal(got8.topk.indices[both], res8.topk.indices[both]))
        share = float(got8.certified.to(torch.float32).mean())
        log(f"streamed check (b): int8 streamed bit-identical to streamed_direct_scan and to "
            f"resident fqsd-int8-cuda on {int(both.sum())}/{m} rows certified by both={check_b}; "
            f"certified share {share:.4f} (resident {float(res8.certified.float().mean()):.4f})")
        del resident, res8, oracle
        torch.cuda.empty_cache()

        # ---- (d) speculation triggers reschedule reads, never results
        spec = {}
        check_d = True
        for trigger in cfg["triggers"]:
            r = eng.search(SearchRequest(queries=q, k=k, tier="int8", spec_trigger=trigger))
            spec[trigger] = r.stats["speculation"]
            check_d &= (torch.equal(r.topk.scores, got8.topk.scores)
                        and torch.equal(r.topk.indices, got8.topk.indices))
        log(f"streamed check (d): results at spec_trigger {cfg['triggers']} bit-identical="
            f"{check_d}; speculation {spec}")

        # ---- timings at depth 1 and 2, beside copy-only and compute-only
        f32_parts = [device_put_partition(p, self.dev) for p in store.shard_source("f32")]
        int8_parts = [device_put_partition(p, self.dev) for p in store.shard_source("int8")]
        r_budget = max(1, min(n_shards * shard_rows, eng.rescore_factor * k))
        step = make_partition_step(k, "l2", "cuda")
        bound_step = make_int8_bound_step(r_budget, "cuda")

        def compute_f32():
            state = step.init(m, self.dev)
            for p in f32_parts:
                state = step(state, qv, p.vectors, p.norms, p.base_index, p.n_valid)
            return step.finish(state)

        def compute_int8():
            lb = torch.full((m, r_budget + 1), torch.inf, device=self.dev)
            li = torch.full((m, r_budget + 1), -1, dtype=torch.int32, device=self.dev)
            for p in int8_parts:
                lb, li = bound_step(lb, li, qv, p.q, p.scales, p.err, p.qnorm, p.base_index)
            return lb, li

        def copy_only(tier, depth):
            for _ in DoubleBufferedStream(store.shard_source(tier), depth=depth,
                                          device=self.dev):
                pass

        timing = {"card": self.card, "copy_ms_one_shard": copy_ms, "copy_GBps": rate / 1e9,
                  "host_ram": self.host_ram()}
        reps = cfg["repeats"]
        for tier, shipped, compute in (("f32", f32_bytes, compute_f32),
                                       ("int8", int8_bytes, compute_int8)):
            compute_ms, _ = self.host_clock_ms(compute, reps)
            bound_ms = shipped / rate * 1e3
            per_tier = {"bytes_shipped": shipped, "bound_ms": bound_ms,
                        "compute_only_ms": compute_ms}
            # int8: the default trigger at both depths, then no speculation
            runs = [(depth, None) for depth in cfg["depths"]]
            if tier == "int8":
                runs.append((cfg["depths"][-1], 1.0))
            for depth, trigger in runs:
                req = SearchRequest(queries=q, k=k, tier=tier, prefetch_depth=depth,
                                    spec_trigger=trigger)
                search_ms, all_ms = self.host_clock_ms(lambda: eng.search(req), reps)
                copy_only_ms, _ = self.host_clock_ms(lambda: copy_only(tier, depth), reps)
                res = eng.search(req)
                self.sync()
                row = {"search_ms": search_ms, "all_ms": [round(t, 3) for t in all_ms],
                       "copy_only_ms": copy_only_ms, "transfers": res.stats["transfers"],
                       "GBps": shipped / (search_ms * 1e-3) / 1e9,
                       "share_of_copy_rate": shipped / (search_ms * 1e-3) / rate,
                       "overlap": search_ms < copy_only_ms + compute_ms}
                if tier == "int8":
                    row.update({key: res.stats[key] for key in ("scan_ms", "gather_ms",
                                                                "rescore_ms")})
                label = f"depth{depth}" + ("" if trigger is None else f"_trigger{trigger}")
                per_tier[label] = row
                log(f"streamed {tier} {label}: search {search_ms:.3f} ms (median of "
                    f"{reps}), copy-only {copy_only_ms:.3f} ms, compute-only {compute_ms:.3f} "
                    f"ms, bound {bound_ms:.3f} ms, {row['GBps']:.3f} GB/s = "
                    f"{row['share_of_copy_rate']:.3f} of the copy rate, transfers "
                    f"{row['transfers']} [{self.card}]")
            if tier == "int8":
                per_tier["speculation"] = spec
                per_tier["certified_share"] = share
            timing[tier] = per_tier
        overlapped = timing["f32"]["depth2"]["overlap"]
        log(f"streamed: f32 depth 2 below copy-only + compute-only={overlapped}")
        log("streamed timings " + json.dumps(timing))

        # ---- (c) each per-shard kernel step against its plain step, and the
        # kernels' per-launch numbers at the shard shape
        check_c = self._streamed_kernels(eng, qv, f32_parts, int8_parts, r_budget, results)
        del f32_parts, int8_parts, eng, store
        torch.cuda.empty_cache()
        return ok and check_a and check_b and check_c and check_d

    def _streamed_kernels(self, eng, qv, f32_parts, int8_parts, r, results,
                          label: str = "streamed") -> bool:
        """One shard's step on the kernels against the plain step (scan plain +
        knn_merge_plain), with the running queue of the shards before it; the
        per-launch times and bounds of the three kernels at the shard shape
        (shard 1 of the parts given, after shard 0)."""
        torch, K, ops = self.torch, self.K, self.ops
        cfg = STREAMED
        m, k, d = cfg["m"], cfg["k"], cfg["d"]
        shard, prev = f32_parts[1], f32_parts[0]
        ok = True
        # f32: the running queue after shard 0, then shard 1
        call0 = ops.prepare(qv, prev.vectors, k, "l2", prev.norms)
        bm, bn, _ = call0.blocks
        v0 = torch.full((m, call0.k_eff), torch.inf, device=self.dev)
        i0 = torch.full((m, call0.k_eff), -1, dtype=torch.int32, device=self.dev)
        v, i = ops.knn_shard(v0, i0, qv, prev.vectors, prev.norms, k, "l2", prev.base_index)
        call = ops.prepare(qv, shard.vectors, k, "l2", shard.norms)
        qn = self.qnorm(call.q)
        m_tiles, n_tiles = call.q.shape[0] // bm, call.x.shape[0] // bn
        splits = K.scan_config(m_tiles, n_tiles, bm, self.dev)[0]
        got = ops.knn_shard(v, i, qv, shard.vectors, shard.norms, k, "l2", shard.base_index)
        pv, pi, _ = K.knn_scan_plain(call.q, call.x, qn, call.xn, call.k_eff, "l2", bm, bn,
                                     True, splits)
        want = ops.merge_shard(v, i, pv[:m], pi[:m], shard.base_index, merge=K.knn_merge_plain)
        f32_ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        sv, si, _ = K.knn_scan(call.q, call.x, qn, call.xn, call.k_eff, "l2", bm, bn, True,
                               splits)
        scan_exact = torch.equal(sv, pv) and torch.equal(si, pi)
        # the queues the step's merge takes: the shard's S, then the running one
        qv_all = torch.cat([sv[:m], v[:, None]], 1)
        qi_all = torch.cat([torch.where(torch.isfinite(sv[:m]), si[:m] + shard.base_index, -1),
                            i[:, None]], 1)
        mv, mi = K.knn_merge(qv_all, qi_all)
        pmv, pmi = K.knn_merge_plain(qv_all, qi_all)
        merge_exact = torch.equal(mv, pmv) and torch.equal(mi, pmi)
        # int8: the running bound queue after shard 0, then shard 1
        p8, prev8 = int8_parts[1], int8_parts[0]
        lb0 = torch.full((m, r + 1), torch.inf, device=self.dev)
        li0 = torch.full((m, r + 1), -1, dtype=torch.int32, device=self.dev)
        lb, li = ops.knn_int8_shard(lb0, li0, qv, prev8.q, prev8.scales, prev8.err, prev8.qnorm,
                                    prev8.base_index, r)
        got8 = ops.knn_int8_shard(lb, li, qv, p8.q, p8.scales, p8.err, p8.qnorm, p8.base_index, r)
        args = ops.int8_shard_operands(qv, p8.q, p8.scales, p8.err, p8.qnorm, r)
        q_len, bm8, bn8 = args[6], args[7], args[8]
        splits8 = K.int8_scan_config(args[0].shape[0] // bm8, args[5].shape[0] // bn8, bm8,
                                     self.dev)[0]
        pv8, pi8, _ = K.knn_int8_scan_plain(*args, True, splits8)
        wv8, wi8 = ops.merge_shard(lb, li, pv8[:m], pi8[:m], p8.base_index,
                                   merge=K.knn_merge_plain)
        int8_ok = torch.equal(got8[0], wv8[:, : r + 1]) and torch.equal(got8[1], wi8[:, : r + 1])
        sv8, si8, _ = K.knn_int8_scan(*args, True, splits8)
        scan8_exact = torch.equal(sv8, pv8) and torch.equal(si8, pi8)
        self.sync()
        ok = f32_ok and int8_ok and scan_exact and scan8_exact and merge_exact
        log(f"{label} check (c): f32 shard step bit-identical to its plain step={f32_ok} "
            f"(scan {scan_exact}, merge {merge_exact}); int8 shard step={int8_ok} "
            f"(scan {scan8_exact}); S={splits} / {splits8}, q_len={q_len}")

        # per-launch numbers at the shard shape (shard 1: all its rows valid)
        rows = shard.n_valid
        lq8 = torch.cat([sv8[:m], lb.new_full((m, 1, q_len), torch.inf)], 1)
        li8 = torch.cat([torch.where(torch.isfinite(sv8[:m]), si8[:m] + p8.base_index, -1),
                         li.new_full((m, 1, q_len), -1)], 1)
        lm8 = K.knn_merge(lq8, li8)
        numbers = {
            "knn_scan": (self.ms(lambda: K.knn_scan(call.q, call.x, qn, call.xn, call.k_eff,
                                                     "l2", bm, bn, True, splits)),
                         self.ms(lambda: K.knn_scan_plain(call.q, call.x, qn, call.xn,
                                                          call.k_eff, "l2", bm, bn, True,
                                                          splits)),
                         self._library_scan_ms("streamed", qv[:, :d], shard.vectors[:rows, :d],
                                               k)[0],
                         "torch.topk(torch.cdist(q, shard)**2)",
                         self.bound((rows + m) * d * 4 + (rows + m) * 4 + m * k * 8,
                                    m * rows * (2 * d + L2_EPILOGUE_OPS)),
                         0.0 if scan_exact else math.inf),
            "knn_merge": (self.ms(lambda: K.knn_merge(qv_all, qi_all)),
                          self.ms(lambda: K.knn_merge_plain(qv_all, qi_all)),
                          self.ms(lambda: torch.topk(qv_all.reshape(m, -1), call.k_eff,
                                                     largest=False)),
                          "torch.topk(queues.reshape(m, -1))",
                          self.bound(*self.merge_work(qv_all, qi_all, mv, mi)),
                          0.0 if merge_exact else math.inf),
            "knn_int8_scan": (self.ms(lambda: K.knn_int8_scan(*args, True, splits8)),
                              self.ms(lambda: K.knn_int8_scan_plain(*args, True, splits8)),
                              None, None,
                              self.bound(rows * d + 3 * rows * 4 + m * (d + 1) * 4
                                         + m * q_len * 8,
                                         m * rows * (2 * d + INT8_EPILOGUE_OPS)),
                              0.0 if scan8_exact else math.inf),
        }
        int8_merge = (self.ms(lambda: K.knn_merge(lq8, li8)),
                      self.ms(lambda: K.knn_merge_plain(lq8, li8)),
                      self.ms(lambda: torch.topk(lq8.reshape(m, -1), q_len, largest=False)),
                      "torch.topk(queues.reshape(m, -1))",
                      self.bound(*self.merge_work(lq8, li8, *lm8)), 0.0)
        for tier, names, merge in (("f32", ("knn_scan", "knn_merge"), numbers["knn_merge"]),
                                   ("int8", ("knn_int8_scan", "knn_merge"), int8_merge)):
            launches = results[tier][1]
            shape = {"shape": f"{label}_gist_{tier}_m{m}_k{k}_one_shard_of_{rows}_rows",
                     "per": "one launch on one shard", "kernels": {}}
            for name in names:
                t, tp, tl, lib, (bb, by), err = merge if name == "knn_merge" else numbers[name]
                shape["kernels"][name] = {
                    "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": tp,
                    "bound_ms": bb, "bound_by": by, "library_ms": tl, "library": lib}
                log(f"{label} {tier}: {name} ms={t:.4f} plain_ms={tp:.4f} library_ms={tl} "
                    f"bound_ms={bb:.6f} ({by}) per shard; launches a search={launches[name]} "
                    f"[{self.card}]")
            self.shapes.append(shape)
        return ok

    # ------------------------------------------------------ phase 7: mmap
    @staticmethod
    def _filesystem(path: Path) -> str:
        """The mount point and type of the filesystem `path` lies on."""
        best = ("?", "?")
        for line in Path("/proc/mounts").read_text().splitlines():
            parts = line.split()
            if len(parts) > 2 and str(path).startswith(parts[1]) and len(parts[1]) >= len(best[0]):
                best = (parts[1], parts[2])
        return f"{best[0]} ({best[1]})"

    @staticmethod
    def _drop_cache(directory: Path) -> str:
        """Ask the kernel to drop the page cache of every file of the store
        (posix_fadvise DONTNEED, advisory), after an fsync; returns the
        host's Cached line after, so the reader can see what it did."""
        import os

        for f in directory.iterdir():
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("Cached:"):
                return line.split(":", 1)[1].strip()
        return "?"

    def mmap_rates(self, directory: Path, store, pinned_shard) -> dict:
        """Measurements, not gates: the read rate of one shard's file from a
        dropped cache and again warm; the mapping -> page-locked staging
        copy of one shard (the double buffer's own routine, median of
        repeats, at 1 thread and at its default); the page-locked -> card
        copy of one shard (CUDA events)."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.core import streaming

        torch, cfg = self.torch, MMAP
        path = directory / "shard_00001.f32.bin"
        nbytes = path.stat().st_size
        buf = bytearray(16 << 20)

        def read_file() -> float:
            t0 = time.perf_counter()
            with open(path, "rb", buffering=0) as f:
                while f.readinto(buf):
                    pass
            return time.perf_counter() - t0

        cached = self._drop_cache(directory)
        cold_s = read_file()
        warm_s = read_file()
        src = store.read_shard(1).vectors
        bank = torch.empty(tuple(src.shape), dtype=torch.float32, pin_memory=True)
        threads = streaming.stage_threads()
        stage_ms = {}
        for n_threads in sorted({1, threads}):
            pool = ThreadPoolExecutor(n_threads) if n_threads > 1 else None
            try:
                times = []
                for _ in range(cfg["repeats"] + 1):
                    t0 = time.perf_counter()
                    streaming.stage(bank, src, pool)
                    times.append((time.perf_counter() - t0) * 1e3)
            finally:
                if pool is not None:
                    pool.shutdown()
            stage_ms[n_threads] = statistics.median(times[1:])
        copy_ms, copy_rate = self.copy_rate(pinned_shard)
        rates = {"shard_file_bytes": nbytes, "cached_after_drop": cached,
                 "disk_read_GBps": nbytes / cold_s / 1e9, "reread_GBps": nbytes / warm_s / 1e9,
                 "stage_threads": threads,
                 "stage_ms": {str(t): v for t, v in stage_ms.items()},
                 "stage_GBps": {str(t): nbytes / (v * 1e-3) / 1e9 for t, v in stage_ms.items()},
                 "pinned_copy_ms": copy_ms, "pinned_copy_GBps": copy_rate / 1e9}
        log(f"mmap rates: read of one shard's file ({nbytes} B) after a cache drop "
            f"{rates['disk_read_GBps']:.3f} GB/s (Cached after the drop {cached}), read again "
            f"{rates['reread_GBps']:.3f} GB/s; mapping -> page-locked staging "
            + ", ".join(f"{rates['stage_GBps'][str(t)]:.3f} GB/s at {t} thread(s)"
                        for t in stage_ms)
            + f" (median of {cfg['repeats']}); page-locked -> card {copy_rate / 1e9:.3f} GB/s "
            f"({copy_ms:.4f} ms, CUDA events) [{self.card}]")
        return rates

    def phase_mmap(self) -> bool:
        """The GIST data of phase 6 written as a store in files, reopened
        with verify=True, and streamed from its mappings at depths 1 and 2;
        every result bit-identical to the same data in a pinned host-RAM
        store. The directory is deleted at the end, whatever the outcome."""
        import shutil

        directory = ROOT / "build" / "mmap_store"
        shutil.rmtree(directory, ignore_errors=True)
        try:
            return self._mmap(directory)
        finally:
            shutil.rmtree(directory, ignore_errors=True)

    def _mmap(self, directory: Path) -> bool:
        import shutil

        torch, K = self.torch, self.K
        from repro_torch import ExactKNN, SearchRequest
        from repro_torch.core.streaming import device_put_partition
        from repro_torch.store import DatasetStore

        cfg = MMAP
        n, d, m, k = cfg["n"], cfg["d"], cfg["m"], cfg["k"]
        x, q = self._dataset(n, d, m, seed=cfg["seed"])
        t0 = time.perf_counter()
        ram = DatasetStore.from_array(x, rows_per_shard=cfg["rows_per_shard"], pin_memory=True)
        ram.ensure_tier("int8", device=self.dev)
        self.sync()
        ram_s = time.perf_counter() - t0
        directory.parent.mkdir(parents=True, exist_ok=True)
        free = shutil.disk_usage(directory.parent).free
        t0 = time.perf_counter()
        written = DatasetStore.from_array(x, rows_per_shard=cfg["rows_per_shard"],
                                          directory=str(directory))
        write_s = time.perf_counter() - t0
        del x
        t0 = time.perf_counter()
        written.ensure_tier("int8", device=self.dev)
        int8_s = time.perf_counter() - t0
        written.close()
        disk_bytes = sum(f.stat().st_size for f in directory.iterdir())
        cached = self._drop_cache(directory)
        t0 = time.perf_counter()
        store = DatasetStore.open(str(directory), verify=True)
        open_s = time.perf_counter() - t0
        n_shards = store.n_shards
        log(f"mmap: store in {directory} on {self._filesystem(directory)}, {free} B free before; "
            f"{n_shards} shards x {store.rows_per_shard} rows x {store.padded_dim} "
            f"({store.n_main} valid), {disk_bytes} B on disk; f32 written in {write_s:.2f} s, "
            f"int8 tier quantised on the card and written in {int8_s:.2f} s; "
            f"open(verify=True) from a dropped cache (Cached {cached}) {open_s:.2f} s "
            f"({disk_bytes / open_s / 1e9:.3f} GB/s CRC32 over every file); the pinned "
            f"host-RAM store of the same rows built in {ram_s:.2f} s; host RAM {self.host_ram()}")
        ok = store.is_mmap and store.tiers == ("f32", "int8") and not store.is_pinned
        rates = self.mmap_rates(directory, store, ram.read_shard(0))

        engines = {}
        for name, st in (("ram", ram), ("mmap", store)):
            engines[name] = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(
                st, resident=False).enable_int8()
        ok &= not store.is_pinned  # fit_store never pins a store in files
        qv = engines["mmap"]._pad_queries(q)
        shipped = {"f32": n_shards * store.rows_per_shard * (store.padded_dim + 1) * 4,
                   "int8": sum(store.read_shard(i, "int8").scan_bytes()
                               for i in range(n_shards))}
        stage_rate = rates["stage_GBps"][str(rates["stage_threads"])] * 1e9
        timing = {"card": self.card, "rates": rates, "write_s": write_s, "int8_write_s": int8_s,
                  "verify_open_s": open_s, "disk_bytes": disk_bytes}
        results = {}
        for tier, kernels, want_exec in (
                ("f32", ("knn_scan", "knn_merge"), "fqsd-mmap-streamed"),
                ("int8", ("knn_int8_scan", "knn_merge"), "fqsd-int8-mmap-streamed")):
            per_tier = {"bytes_shipped": shipped[tier],
                        "staging_bound_ms": shipped[tier] / stage_rate * 1e3,
                        "disk_bound_ms": shipped[tier] / (rates["disk_read_GBps"] * 1e9) * 1e3}
            for depth in cfg["depths"]:
                req = SearchRequest(queries=q, k=k, tier=tier, prefetch_depth=depth)
                want = engines["ram"].search(req)
                # a store opened anew maps nothing of its files yet: its first
                # search is what a process that just opened the store sees
                fresh = DatasetStore.open(str(directory))
                eng = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(
                    fresh, resident=False).enable_int8()
                cached = self._drop_cache(directory)
                self.sync()
                K.reset_launch_counts()  # the path: counters at 0 around one search
                t0 = time.perf_counter()
                got = eng.search(req)
                self.sync()
                first_ms = (time.perf_counter() - t0) * 1e3
                launches = dict(K.LAUNCHES)
                same = (torch.equal(got.topk.scores, want.topk.scores)
                        and torch.equal(got.topk.indices, want.topk.indices)
                        and torch.equal(torch.as_tensor(got.certified),
                                        torch.as_tensor(want.certified))
                        and got.stats["transfers"] == want.stats["transfers"] == n_shards
                        and got.stats["bytes_scanned"] == want.stats["bytes_scanned"])
                good = (same and got.plan.executor == want_exec
                        and all(launches[name] == n_shards for name in kernels)
                        and sum(launches.values()) == 2 * n_shards
                        and bool(torch.isfinite(got.topk.scores).all())
                        and tuple(got.topk.scores.shape) == (m, k)
                        and got.stats["health"]["retries"] == 0)
                warm_ms, all_ms = self.host_clock_ms(lambda: eng.search(req), cfg["repeats"])
                again = eng.search(req)
                self.sync()
                good &= (torch.equal(again.topk.scores, want.topk.scores)
                         and torch.equal(again.topk.indices, want.topk.indices))
                row = {"first_ms": first_ms, "cached_before_first": cached, "warm_ms": warm_ms,
                       "warm_all_ms": [round(t, 3) for t in all_ms],
                       "warm_GBps": shipped[tier] / (warm_ms * 1e-3) / 1e9,
                       "transfers": got.stats["transfers"],
                       "bytes_scanned": got.stats["bytes_scanned"], "launches": launches,
                       "bit_identical_to_ram": same}
                if tier == "int8":
                    row["first_split"] = {key: got.stats[key] for key in ("scan_ms", "gather_ms",
                                                                          "rescore_ms")}
                    row.update({key: again.stats[key] for key in ("scan_ms", "gather_ms",
                                                                  "rescore_ms")})
                per_tier[f"depth{depth}"] = row
                log(f"mmap {tier} depth{depth}: executor={got.plan.executor} first search on "
                    f"fresh mappings {first_ms:.3f} ms (Cached {cached}; bound "
                    f"{per_tier['disk_bound_ms']:.3f} ms at the disk rate), warm {warm_ms:.3f} "
                    f"ms (median of {cfg['repeats']}; {row['warm_GBps']:.3f} GB/s) against the "
                    f"staging-only bound {per_tier['staging_bound_ms']:.3f} ms; transfers "
                    f"{row['transfers']}, bytes_scanned {row['bytes_scanned']}, launches "
                    f"{launches}, health {got.stats['health']}, bit-identical to the host-RAM "
                    f"store={same}, ok={good} [{self.card}]")
                ok &= good
                results[tier] = (got, launches)
                fresh.close()
                del eng
            timing[tier] = per_tier

        # every file's CRC re-checked on every read
        checked = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(
            DatasetStore.open(str(directory), verify_on_read=True), resident=False)
        req = SearchRequest(queries=q, k=k)
        t0 = time.perf_counter()
        got = checked.search(req)
        self.sync()
        verify_ms = (time.perf_counter() - t0) * 1e3
        want = results["f32"][0]
        same = (torch.equal(got.topk.scores, want.topk.scores)
                and torch.equal(got.topk.indices, want.topk.indices)
                and got.stats["health"]["retries"] == 0)
        timing["verify_on_read_f32_ms"] = verify_ms
        log(f"mmap f32 verify_on_read: {verify_ms:.3f} ms, health {got.stats['health']}, "
            f"bit-identical={same} [{self.card}]")
        ok &= same
        log("mmap timings " + json.dumps(timing))

        # (c) the per-shard kernel steps on two shards read from the mapping
        f32_parts = [device_put_partition(store.read_shard(i), self.dev) for i in (0, 1)]
        int8_parts = [device_put_partition(store.read_shard(i, "int8"), self.dev) for i in (0, 1)]
        r_budget = max(1, min(n_shards * store.rows_per_shard, engines["mmap"].rescore_factor * k))
        ok &= self._streamed_kernels(engines["mmap"], qv, f32_parts, int8_parts, r_budget,
                                     results, label="mmap")
        for st in (store, ram):
            st.close()
        del engines, checked, f32_parts, int8_parts
        torch.cuda.empty_cache()
        return bool(ok)

    # ---------------------------------------------------- phase 8: mutate
    def phase_mutate(self) -> bool:
        """The store's write side at the GIST shape: resident on the card,
        streamed from pinned host RAM, and in files under build/ (deleted at
        the end, whatever the outcome)."""
        import shutil

        directory = ROOT / "build" / "mutate_store"
        shutil.rmtree(directory, ignore_errors=True)
        try:
            return self._mutate(directory)
        finally:
            shutil.rmtree(directory, ignore_errors=True)

    def _timed(self, fn) -> tuple[object, float]:
        """fn() and its host-clock ms, synchronised on both sides."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, (time.perf_counter() - t0) * 1e3

    def _mutated(self, eng, u, dead_main, dead_delta) -> dict:
        """The phase's history on an engine: the upsert batches, then the
        two deletes; returns each call's host-clock ms."""
        ms, start = {}, 0
        for b in MUTATE["upserts"]:
            _, ms[f"upsert_{b}"] = self._timed(lambda: eng.upsert(u[start: start + b]))
            start += b
        _, ms["delete_main"] = self._timed(lambda: eng.delete(dead_main))
        _, ms["delete_delta"] = self._timed(lambda: eng.delete(dead_delta))
        return ms

    def _same_as_fresh(self, got, want, live) -> bool:
        """Values bit-identical, indices equal once the fresh engine's
        positions are mapped to external ids."""
        torch = self.torch
        wi = want.indices
        mapped = torch.where(wi >= 0, live[wi.clamp(min=0).to(torch.int64)], -1)
        return (torch.equal(got.scores, want.scores)
                and torch.equal(got.indices.to(torch.int64), mapped))

    def _mutated_search(self, label, eng, req, want, live, kernels, n_shards=None) -> bool:
        """One search of the mutated engine, counters at 0 around it: its
        executor, launches (each kernel of `kernels` that many times) and
        transfers, against the fresh engine's answer. Returns (ok, the
        result, the launch counts read)."""
        K = self.K
        self.sync()
        K.reset_launch_counts()
        res = eng.search(req)
        self.sync()
        launches = dict(K.LAUNCHES)
        ok = all(launches[name] == n for name, n in kernels.items())
        ok &= sum(launches.values()) == sum(kernels.values())
        if n_shards is not None:
            ok &= res.stats.get("transfers") == n_shards
        same = self._same_as_fresh(res.topk, want, live)
        log(f"mutate {label}: executor={res.plan.executor} launches={launches} "
            f"transfers={res.stats.get('transfers')} health={res.stats['health']} "
            f"bit-identical to the fresh fit on the live rows={same} ok={ok and same}")
        return bool(ok and same), res, launches

    def _mutate(self, directory: Path) -> bool:
        import shutil

        torch, ops = self.torch, self.ops
        from repro_torch import ExactKNN, SearchRequest
        from repro_torch.core.executors import cache_info
        from repro_torch.store import DatasetStore, read_current

        cfg = MUTATE
        n, d = cfg["n"], cfg["d"]
        (m1, k1), (m16, k16) = cfg["fdsq"], cfg["fqsd"]
        x, q = self._dataset(n, d, m16, seed=cfg["seed"])
        g = torch.Generator(device=self.dev).manual_seed(31)
        n_up = sum(cfg["upserts"])
        u = torch.randn(n_up, d, generator=g, device=self.dev)
        dead_main = torch.randperm(n, generator=g, device=self.dev)[: cfg["delete_main"]]
        dead_delta = n + torch.randperm(n_up, generator=g, device=self.dev)[: cfg["delete_delta"]]
        keep = torch.ones(n + n_up, dtype=torch.bool, device=self.dev)
        keep[dead_main], keep[dead_delta] = False, False
        live = torch.nonzero(keep).reshape(-1)  # external ids, in order
        dead_main, dead_delta = dead_main.cpu().numpy(), dead_delta.cpu().numpy()
        n_delta = -(-n_up // 4096)

        # the oracle: a fresh fdsq-cuda engine fitted on the live rows
        t0 = time.perf_counter()
        fresh = ExactKNN(k=k16, backend="cuda", device=self.dev).fit(torch.cat([x, u])[live])
        reqs = {"fdsq": SearchRequest(queries=q[:m1], k=k1, mode_hint="fdsq"),
                "fqsd": SearchRequest(queries=q, k=k16, mode_hint="fqsd")}
        want = {mode: fresh.search(r).topk for mode, r in reqs.items()}
        oracle8 = ops.knn_exact_direct(fresh._pad_queries(q), fresh._ds.vectors,
                                       fresh._ds.norms, k16, cfg["oracle_chunk"])
        self.sync()
        log(f"mutate: {n} rows + {n_up} upserted - {len(dead_main)} main - {len(dead_delta)} "
            f"delta deleted = {live.numel()} live; the fresh engine on them and its answers "
            f"(f32 m={m1} k={k1}, m={m16} k={k16}; knn_exact_direct m={m16} k={k16}) in "
            f"{time.perf_counter() - t0:.2f} s")
        del fresh
        torch.cuda.empty_cache()
        req8 = SearchRequest(queries=q, k=k16, tier="int8")
        ok = True
        timing = {"card": self.card}

        # ---- (a) resident: one shard on the card, room for the fold
        store = DatasetStore.from_array(x, row_mult=cfg["resident_rows"])
        del x
        eng = ExactKNN(k=k16, backend="cuda", device=self.dev).fit_store(store)
        reps = cfg["repeats"]
        search_ms = {}

        def time_searches(n_shards_delta):
            for mode, r in reqs.items():
                search_ms[f"{mode}_{n_shards_delta}_delta"] = self.host_clock_ms(
                    lambda: eng.search(r), reps)[0]

        time_searches(0)
        eng.enable_int8()
        eng.search(req8)
        self.sync()
        cache0 = cache_info()
        ms, start = {}, 0
        for b in cfg["upserts"]:
            _, ms[f"upsert_{b}"] = self._timed(lambda: eng.upsert(u[start: start + b]))
            start += b
            if start == 1:
                time_searches(1)
        _, ms["delete_main"] = self._timed(lambda: eng.delete(dead_main))
        _, ms["delete_delta"] = self._timed(lambda: eng.delete(dead_delta))
        timing["resident"] = ms
        ok &= len(store.delta_shards()) == n_delta and store.delta_shards()[0].vectors.is_cuda
        # the main scan, its pilot where the rule engages, and each delta shard
        pilots = {mode: self.pilots(*eng._ds.vectors.shape, *cfg[mode]) for mode in reqs}
        delta_launches = {}  # each mode's launches on its delta shards
        for mode, r in reqs.items():
            kernels = dict.fromkeys(("knn_scan", "knn_merge"), 1 + pilots[mode] + n_delta)
            good, _, launches = self._mutated_search(f"resident f32 {mode}", eng, r,
                                                     want[mode], live, kernels)
            delta_launches[mode] = {name: launches[name] - 1 - pilots[mode] for name in kernels}
            ok &= good
        good, res8, _ = self._mutated_search("resident int8", eng, req8, oracle8, live,
                                          {"knn_int8_scan": 1, "knn_merge": 1})
        ok &= good
        cache1 = cache_info()
        time_searches(n_delta)
        timing["search_ms"] = search_ms
        log(f"mutate resident: upsert/delete ms {ms}; search ms (median of {reps}) with 0, 1 "
            f"and {n_delta} delta shards {search_ms}; certified share "
            f"{float(res8.certified.float().mean()):.4f} [{self.card}]")

        # the delta-shard kernels at their shape, merging into the queue the
        # main scan of that search gives (the resident view, tombstones in)
        qv = eng._pad_queries(q)
        for mode, (m, k) in (("fdsq", cfg["fdsq"]), ("fqsd", cfg["fqsd"])):
            call = ops.prepare(qv[:m], eng._ds.vectors, k, "l2", eng._ds.norms)
            v, i, _ = self.K.knn_fused(call.q, call.x, call.xn, call.k_eff, call.metric,
                                       *call.blocks, True)
            ok &= self._delta_kernels(f"mutate_delta_shard_m{m}_k{k}", qv[:m],
                                      eng._delta_dev[0], (v[:m], i[:m]), k,
                                      delta_launches[mode])

        # fold, swap, and the same answers with no new executable
        stats, compact_ms = self._timed(store.compact)
        timing["compact_card_s"] = compact_ms / 1e3
        for mode, r in reqs.items():
            good, _, _ = self._mutated_search(
                f"resident f32 {mode} after compact()", eng, r, want[mode], live,
                dict.fromkeys(("knn_scan", "knn_merge"), 1 + pilots[mode]))
            ok &= good
        good, _, _ = self._mutated_search("resident int8 after compact()", eng, req8, oracle8,
                                          live, {"knn_int8_scan": 1, "knn_merge": 1})
        ok &= good
        cache2 = cache_info()
        flat = (cache2["misses"], cache2["size"]) == (cache1["misses"], cache1["size"])
        ok &= flat and store.generation == 1 and store.n_shards == 1
        log(f"mutate resident: compact() {compact_ms / 1e3:.3f} s on the card {stats}; "
            f"cache_info before the mutations {cache0}, after the first delta searches "
            f"{cache1}, after compact() and its searches {cache2}: no entry added={flat} "
            f"[{self.card}]")
        del eng, store
        torch.cuda.empty_cache()

        # ---- (b) streamed: phase 6's pinned host store, depth 2
        x, _ = self._dataset(n, d, m16, seed=cfg["seed"])
        host = DatasetStore.from_array(x, rows_per_shard=cfg["rows_per_shard"], pin_memory=True)
        host.ensure_tier("int8", device=self.dev)
        n_main = host.n_shards
        seng = ExactKNN(k=k16, backend="cuda", device=self.dev, prefetch_depth=2).fit_store(
            host, resident=False).enable_int8()
        timing["pinned_host"] = self._mutated(seng, u, dead_main, dead_delta)
        ok &= (len(host.delta_shards()) == n_delta and host.delta_shards()[0].vectors.is_pinned())
        for mode, r in reqs.items():
            good, _, _ = self._mutated_search(
                f"streamed f32 {mode}", seng, r, want[mode], live,
                {"knn_scan": n_main + n_delta, "knn_merge": n_main + n_delta}, n_main + n_delta)
            ok &= good
        # the int8 stream carries the main shards' codes; the delta rows merge
        # in the rescore, through a double buffer of their own
        good, _, _ = self._mutated_search("streamed int8", seng, req8, oracle8, live,
                                          {"knn_int8_scan": n_main, "knn_merge": n_main}, n_main)
        ok &= good
        log(f"mutate streamed: upsert/delete ms {timing['pinned_host']} [{self.card}]")
        del seng, host
        torch.cuda.empty_cache()

        # ---- (c) files: journaled, reopened, compacted to gen_000001
        directory.parent.mkdir(parents=True, exist_ok=True)
        log(f"mutate files: {shutil.disk_usage(directory.parent).free} B free under "
            f"{directory.parent} on {self._filesystem(directory.parent)} before writing")
        written = DatasetStore.from_array(x, rows_per_shard=cfg["rows_per_shard"],
                                          directory=str(directory))
        written.ensure_tier("int8", device=self.dev)
        del x

        def engine(st):
            return ExactKNN(k=k16, backend="cuda", device=self.dev).fit_store(
                st, resident=False).enable_int8()

        def searches(label, eng, n_m=n_main, n_d=n_delta) -> tuple[bool, dict]:
            good, got = True, {}
            for mode, r in reqs.items():
                g_, got[mode], _ = self._mutated_search(
                    f"files f32 {mode} {label}", eng, r, want[mode], live,
                    {"knn_scan": n_m + n_d, "knn_merge": n_m + n_d}, n_m + n_d)
                good &= g_
            g_, got["int8"], _ = self._mutated_search(f"files int8 {label}", eng, req8, oracle8,
                                                      live, {"knn_int8_scan": n_m,
                                                             "knn_merge": n_m}, n_m)
            return good and g_, got

        timing["journaled"] = self._mutated(engine(written), u, dead_main, dead_delta)
        good, before = searches("before close()", engine(written))
        ok &= good
        written.close()
        reopened, open_ms = self._timed(lambda: DatasetStore.open(str(directory)))
        ok &= reopened.n_delta == n_up and reopened.n_live == live.numel()
        feng = engine(reopened)
        good, after = searches("after open() + replay", feng)
        ok &= good and all(torch.equal(before[key].topk.scores, after[key].topk.scores)
                           and torch.equal(before[key].topk.indices, after[key].topk.indices)
                           for key in before)
        stats, compact_ms = self._timed(reopened.compact)
        gone = (read_current(str(directory)) == "gen_000001"
                and not (directory / "manifest.json").exists()
                and not (directory / "shard_00000.f32.bin").exists()
                and (directory / "gen_000001" / "shard_00000.int8.bin").exists()
                and reopened.tiers == ("f32", "int8"))
        ok &= gone
        n_folded = reopened.n_shards
        good, _ = searches("after compact()", feng, n_folded, 0)  # the engine refits on the swap
        ok &= good
        reopened.close()
        verified, verify_ms = self._timed(lambda: DatasetStore.open(str(directory), verify=True))
        good, _ = searches("after a verified reopen", engine(verified), n_folded, 0)
        ok &= good and verified.generation == 1 and verified.n_delta == 0
        verified.close()
        timing.update({"open_replay_s": open_ms / 1e3, "compact_files_s": compact_ms / 1e3,
                       "verify_open_s": verify_ms / 1e3})
        log(f"mutate files: journaled upsert/delete ms {timing['journaled']}; open() + replay "
            f"{open_ms / 1e3:.3f} s; compact() {compact_ms / 1e3:.3f} s {stats}; old generation "
            f"gone, gen_000001 with int8={gone}; open(verify=True) {verify_ms / 1e3:.3f} s "
            f"[{self.card}]")
        log("mutate timings " + json.dumps(timing))
        return bool(ok)

    def _delta_kernels(self, label, q, shard, queue, k, launches) -> bool:
        """knn_scan and knn_merge at one delta shard's shape, as the step of
        a resident search runs them (the main shard's queue running):
        against their plain versions (the scan within TOL_REL, the merge bit
        for bit), timed beside them, the library calls and the bounds.
        `launches` are the delta-shard launches of the resident search at
        this shape, read from the counters."""
        torch, K, ops = self.torch, self.K, self.ops
        m, d = q.shape[0], MUTATE["d"]
        call = ops.prepare(q, shard.vectors, k, "l2", shard.norms)
        bm, bn, _ = call.blocks
        qn = self.qnorm(call.q)
        m_tiles, n_tiles = call.q.shape[0] // bm, call.x.shape[0] // bn
        splits = K.scan_config(m_tiles, n_tiles, bm, self.dev)[0]
        args = (call.q, call.x, qn, call.xn, call.k_eff, "l2", bm, bn, True, splits)
        sv, si, _ = K.knn_scan(*args)
        pv, pi, _ = K.knn_scan_plain(*args)
        xmax = float(call.xn[torch.isfinite(call.xn)].max())
        ok_scan, err_scan, _ = self._close(sv, si, pv, pi, TOL_REL * (qn[:, None, None] + xmax))
        v, i = queue
        qv_all = torch.cat([sv[:m], v[:, None]], 1)
        qi_all = torch.cat([torch.where(torch.isfinite(sv[:m]), si[:m] + shard.base_index, -1),
                            i[:, None]], 1)
        mv, mi = K.knn_merge(qv_all, qi_all)
        pmv, pmi = K.knn_merge_plain(qv_all, qi_all)
        merge_exact = torch.equal(mv, pmv) and torch.equal(mi, pmi)
        self.sync()
        rows = shard.n_valid
        numbers = {
            "knn_scan": (self.ms(lambda: K.knn_scan(*args)), self.ms(lambda: K.knn_scan_plain(*args)),
                         self._library_scan_ms(label, q[:, :d], shard.vectors[:rows, :d], k)[0],
                         "torch.topk(torch.cdist(q, shard)**2)",
                         self.bound((rows + m) * d * 4 + (rows + m) * 4 + m * k * 8,
                                    m * rows * (2 * d + L2_EPILOGUE_OPS)), err_scan),
            "knn_merge": (self.ms(lambda: K.knn_merge(qv_all, qi_all)),
                          self.ms(lambda: K.knn_merge_plain(qv_all, qi_all)),
                          self.ms(lambda: torch.topk(qv_all.reshape(m, -1), call.k_eff,
                                                     largest=False)),
                          "torch.topk(queues.reshape(m, -1))",
                          self.bound(*self.merge_work(qv_all, qi_all, mv, mi)),
                          0.0 if merge_exact else math.inf)}
        shape = {"shape": label, "per": "one launch on one delta shard of "
                 f"{tuple(shard.vectors.shape)}", "splits": splits, "kernels": {}}
        for name, (t, tp, tl, lib, (bb, by), err) in numbers.items():
            shape["kernels"][name] = {
                "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": tp,
                "bound_ms": bb, "bound_by": by, "library_ms": tl, "library": lib}
            log(f"{label}: {name} ms={t:.4f} plain_ms={tp:.4f} library_ms={tl} "
                f"bound_ms={bb:.6f} ({by}) per delta shard; launches a search={launches[name]} "
                f"max|d|={err:.3e} [{self.card}]")
        self.shapes.append(shape)
        return bool(ok_scan and merge_exact)

    # ---------------------------------------------------- phase 9: serve
    def phase_serve(self) -> bool:
        """The serving path at the paper's GIST shape: the collection built
        by launch/serve.py's construction path, the kernels timed at one
        dispatch of each plan, then the bursty trace replayed twice under
        each policy through Router + AdaptiveScheduler, with upserts,
        deletes and a compaction through the Router between the policies."""
        torch, K = self.torch, self.K
        from repro_torch.configs import get_config
        from repro_torch.data import query_stream
        from repro_torch.launch import serve
        from repro_torch.serving import AdaptiveScheduler, bursty_requests

        shape = get_config("knn-search").shape(SERVE["shape"])
        n, d, k = shape["n"], shape["d"], shape["k"]
        args = serve.parser().parse_args(
            ["--mode", "knn", "--n", str(n), "--d", str(d), "--k", str(k),
             "--int8-depth", str(SERVE["int8_min_depth"]), "--collection", SERVE["shape"]])
        t0 = time.perf_counter()
        router, x = serve._build_router(args)
        eng = router.engine(args.collection)
        self.sync()
        log(f"serve: set-up {time.perf_counter() - t0:.2f} s: vector_dataset({n}, {d}, seed=0) "
            f"-> Router.create -> fit -> enable_int8; padded {tuple(eng._ds.vectors.shape)}, "
            f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB [{self.card}]")
        q = query_stream(x, SERVE["queries"], seed=1)
        qt = torch.from_numpy(q).to(self.dev)

        # the kernels at one dispatch of each plan, before any mutation
        # (main_path's plain versions read positions, which are the ids here)
        first = len(self.shapes)
        m4, m64 = SERVE["fdsq_m"], SERVE["fqsd_m"]
        ok = self.main_path(f"serve_fdsq_m{m4}_k{k}", eng, qt[:m4], k, "fdsq")
        ok &= self.main_path(f"serve_fqsd_m{m64}_k{k}", eng, qt[:m64], k, "fqsd")
        ok &= self.main_path_int8(f"serve_fqsd_int8_m{m64}_k{k}", eng, qt[:m64], k)
        plans = ("fdsq", "fqsd", "fqsd-int8", "fqsd-int8-fallback")  # the last if a row refit
        timed = dict(zip(plans, self.shapes[first:]))

        class Counted(AdaptiveScheduler):
            """Reads the launch counters around every dispatch and keeps
            each dispatch's label, padded rows and service time."""

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.log = []

            def _search(self, request):
                K.reset_launch_counts()
                res = super()._search(request)
                label = "fqsd-int8" if request.tier == "int8" else request.mode_hint
                self.log.append([label, int(request.queries.shape[0]), dict(K.LAUNCHES)])
                return res

            def _execute(self, reqs, mode, clock_s, tier="f32"):
                results, dt_s = super()._execute(reqs, mode, clock_s, tier=tier)
                self.log[-1].append(dt_s)
                return results, dt_s

        totals = {label: {"knn_scan": 0, "knn_merge": 0, "knn_int8_scan": 0}
                  for label in plans}
        dispatches = []
        deleted, upserted = set(), {}
        for round_, (policy, int8_depth) in enumerate(SERVE["policies"]):
            if round_:  # mutations through the Router between the policies
                ok &= self._serve_mutate(router, args.collection, q, round_, deleted, upserted)
            ref = self._serve_reference(eng, qt, k)
            for rep in (1, 2):
                misses = router.cache_info()["misses"]
                sched = Counted(policy=policy, fdsq_max_batch=args.fdsq_max_batch,
                                fqsd_min_depth=args.fqsd_min_depth, int8_min_depth=int8_depth,
                                router=router, collection=args.collection)
                trace = bursty_requests(q, SERVE["burst_size"], SERVE["trickle"])
                t1 = time.perf_counter()
                served = {r.rid: r for r in sched.serve(trace)}
                wall = time.perf_counter() - t1
                added = router.cache_info()["misses"] - misses
                st = sched.stats()
                label = f"serve {policy} int8_min_depth={int8_depth} replay {rep}"
                log(f"{label}:")
                serve.report(sched, router, args, wall)
                good = self._serve_gates(label, served, ref, eng, qt, sched, st, deleted,
                                         upserted, policy)
                if rep == 2:
                    good &= added == 0
                    log(f"{label}: executable-cache misses added by the second replay: {added}")
                ok &= good
                for lab, rows, launches, dt_s in sched.log:
                    if lab == "fqsd-int8":  # the fallback's knn() pairs a scan and a merge
                        refits = launches["knn_scan"]
                        totals["fqsd-int8-fallback"]["knn_scan"] += refits
                        totals["fqsd-int8-fallback"]["knn_merge"] += refits
                        launches = launches | {"knn_scan": 0,
                                               "knn_merge": launches["knn_merge"] - refits}
                    for name in totals[lab]:
                        totals[lab][name] += launches[name]
                    dispatches.append((lab, rows, dt_s))
        ok &= self._serve_overhead(eng, qt, dispatches)
        # a refit in the replays whose shape was not timed would lose its launches
        ok &= "fqsd-int8-fallback" in timed or totals["fqsd-int8-fallback"]["knn_scan"] == 0
        # the serve shapes carry the replays' launches: every dispatch of the
        # label, read from the counters (ms and bounds: one dispatch above)
        for label, s in timed.items():
            s["per"] = ("ms and bounds at one dispatch; launches summed over every "
                        f"{label} dispatch of the replays")
            for name, entry in s["kernels"].items():
                entry["launches_one_dispatch"] = entry["launches"]
                entry["launches"] = totals[label][name]
        log(f"serve: launches by plan over the replays {totals} [{self.card}]")
        self.serve_rows = (eng, qt)
        return ok

    def _serve_reference(self, eng, qt, k):
        """The engine's direct search of every query row, in batches of 64,
        at the store's current state: (scores, ids) on the card."""
        from repro_torch import SearchRequest

        out = [eng.search(SearchRequest(queries=qt[i: i + 64], k=k, mode_hint="fqsd"))
               for i in range(0, qt.shape[0], 64)]
        return (self.torch.cat([r.topk.scores for r in out]),
                self.torch.cat([r.topk.indices for r in out]))

    def _dispatch_launches(self, eng, label, rows, k, launches) -> bool:
        """Gate (b) of one dispatch of ``rows`` query rows at k on eng: an
        f32 dispatch launches one knn_merge (two where the pilot's rule
        engages at its shape, Smoke.pilots) and a knn_scan for each and for
        every delta shard; an int8 dispatch its int8 scan and merge, and
        when a row refits the fallback's scan and merge (a pilot's pair
        more where the rule engages at the refit rows, which the dispatch
        does not record)."""
        if label == "fqsd-int8":
            return (launches["knn_int8_scan"] >= 1 and launches["knn_scan"] in (0, 1, 2)
                    and launches["knn_merge"] == 1 + launches["knn_scan"])
        pilot = self.pilots(*eng._ds.vectors.shape, rows, k)
        return (launches["knn_scan"] >= 1 + pilot and launches["knn_merge"] == 1 + pilot
                and launches["knn_int8_scan"] == 0)

    def _serve_gates(self, label, served, ref, eng, qt, sched, st, deleted, upserted,
                     policy) -> bool:
        """(a) every answer by rid within _close of the direct search, no
        deleted id served and every upserted query finding its own row;
        (b) each dispatch launched the kernels of its label; (d) every
        request served, modes switched under adaptive."""
        torch = self.torch
        m = qt.shape[0]
        ok = len(served) == st["served"] == m
        scores = torch.stack([served[rid].topk.scores for rid in range(m)]).to(self.dev)
        ids = torch.stack([served[rid].topk.indices for rid in range(m)]).to(self.dev)
        qn = torch.sum(qt * qt, dim=-1)
        norms = eng._ds.norms
        tol = TOL_REL * (qn[:, None] + float(norms[torch.isfinite(norms)].max()))
        ok_a, err, checked = self._close(scores, ids, ref[0], ref[1], tol)
        gone = sorted(set(ids.flatten().tolist()) & deleted)
        found = all(int(served[row].topk.indices[0]) == new_id
                    for row, new_id in upserted.items() if new_id not in deleted)
        ok_b, bad = True, []
        for lab, rows, launches, _ in sched.log:
            good = self._dispatch_launches(eng, lab, rows, ref[0].shape[1], launches)
            if not good:
                bad.append((lab, rows, launches))
            ok_b &= good
        ok_d = st["served"] == m and (policy != "adaptive" or st["mode_switches"] > 0)
        ok &= ok_a and not gone and found and ok_b and ok_d
        log(f"{label}: (a) served vs direct search max|d|={err:.3e} (tol "
            f"{float(tol.max()):.3e}), indices checked {checked}/{ids.numel()}, deleted ids "
            f"served {gone}, upserted rows found {found} ({len(upserted)}); (b) "
            f"{len(sched.log)} dispatches, kernels of the label launched by all={ok_b} "
            f"{bad[:3]}; (d) served={st['served']} mode_switches={st['mode_switches']}; "
            f"ok={ok}")
        return ok

    def _serve_mutate(self, router, name, q, round_, deleted, upserted) -> bool:
        """Upsert SERVE["upserts"] query rows (each must then be its query's
        nearest row) and delete the ids of SERVE["deletes"] other queries'
        nearest rows, through the Router; then compact(wait=True)."""
        from repro_torch import SearchRequest

        u, dl = SERVE["upserts"], SERVE["deletes"]
        rows = list(range(2 * u * round_, 2 * u * round_ + u))
        doomed = list(range(rows[-1] + 1, rows[-1] + 1 + dl))
        eng = router.engine(name)
        top = eng.search(SearchRequest(queries=q[doomed], mode_hint="fqsd")).topk.indices[:, 0]
        ids = [int(t) for t in top.cpu()]
        t0 = time.perf_counter()
        new = router.upsert(name, q[rows])
        self.sync()
        t1 = time.perf_counter()
        router.delete(name, ids)
        self.sync()
        t2 = time.perf_counter()
        status = router.compact(name, wait=True)
        eng.search(SearchRequest(queries=q[:1]))  # the engine re-fits the new generation
        self.sync()
        t3 = time.perf_counter()
        upserted.update(zip(rows, (int(v) for v in new)))
        deleted.update(ids)
        ok = status["generation"] == round_ and status["error"] is None
        log(f"serve: round {round_}: upsert {u} rows {(t1 - t0) * 1e3:.3f} ms, delete {dl} ids "
            f"{(t2 - t1) * 1e3:.3f} ms, compact(wait=True) + refit {t3 - t2:.3f} s -> "
            f"generation {status['generation']}, n_rows {eng.n}; ok={ok} [{self.card}]")
        return ok

    def _serve_overhead(self, eng, qt, dispatches) -> bool:
        """The scheduler's host overhead per dispatch: for each plan, the
        median service time of its dispatches at their most common padded
        size, against engine.search of a batch of that size with the same
        copy of the answers to the host (host clock, median of 5)."""
        from repro_torch import SearchRequest

        for label in ("fdsq", "fqsd", "fqsd-int8"):
            sizes = [rows for lab, rows, _ in dispatches if lab == label]
            if not sizes:
                continue
            rows = statistics.mode(sizes)
            svc = statistics.median(dt for lab, r, dt in dispatches if lab == label and r == rows)
            req = SearchRequest(queries=qt[:rows], mode_hint="fdsq" if label == "fdsq" else "fqsd",
                                tier="int8" if label == "fqsd-int8" else "f32")

            def direct():
                res = eng.search(req)
                res.topk.scores.cpu(), res.topk.indices.cpu()

            direct_ms, _ = self.host_clock_ms(direct, 5)
            log(f"serve: {label} dispatch of {rows} rows: scheduler service ms={svc * 1e3:.3f} "
                f"(median of {sizes.count(rows)}), engine.search + copy ms={direct_ms:.3f}, "
                f"host overhead ms={svc * 1e3 - direct_ms:.3f} [{self.card}]")
        return True


    # --------------------------------------------------- phase 10: listen
    def phase_listen(self) -> bool:
        """The network front end at phase 9's GIST shape: the collection and
        KnnServer from launch/serve.py's build_server, steps 1-5 and the
        measurements of the module docstring (class Listen)."""
        import asyncio

        from repro_torch.configs import get_config
        from repro_torch.data import query_stream
        from repro_torch.launch import serve

        shape = get_config("knn-search").shape(LISTEN["shape"])
        n, d, k = shape["n"], shape["d"], shape["k"]
        args = serve.parser().parse_args(
            ["--mode", "knn", "--n", str(n), "--d", str(d), "--k", str(k),
             "--listen", "127.0.0.1:0", "--policy", "adaptive",
             "--int8-depth", str(LISTEN["int8_min_depth"]), "--collection", LISTEN["shape"]])
        t0 = time.perf_counter()
        server, x = serve.build_server(args)
        eng = server.router.engine(args.collection)
        self.sync()
        log(f"listen: set-up {time.perf_counter() - t0:.2f} s: build_server -> vector_dataset({n}, "
            f"{d}, seed=0) -> Router.create -> fit -> enable_int8 -> KnnServer(policy=adaptive, "
            f"int8_min_depth={LISTEN['int8_min_depth']}); device memory "
            f"{self.torch.cuda.memory_allocated() / 2**30:.2f} GiB [{self.card}]")
        run = Listen(self, server, eng, query_stream(x, LISTEN["queries"], seed=1), k,
                     args.collection)
        return asyncio.run(asyncio.wait_for(run.phase(), LISTEN["phase_s"]))

    # ----------------------------------------------------- phase 11: tune
    @contextlib.contextmanager
    def _planning_with(self, cache):
        """Plan with `cache` as the default autotune cache inside the block."""
        from repro_torch.tuning import default_cache, set_default_cache

        previous = default_cache()
        set_default_cache(cache)
        try:
            yield cache
        finally:
            set_default_cache(previous)

    def phase_tune(self) -> bool:
        """The tuners at the phases' shapes, against a private cache file;
        gates (a)-(c) of the module docstring."""
        torch = self.torch
        from repro_torch.tuning import AutotuneCache, probe_cuda_capability

        path = ROOT / "build" / "tune" / "autotune.json"
        path.unlink(missing_ok=True)
        self.msmarco_eng = None  # the MS-MARCO sweep needs the card's memory
        gc.collect()
        torch.cuda.empty_cache()
        with self._planning_with(AutotuneCache(str(path))) as cache:
            ok = probe_cuda_capability() is True and cache.get_capability() is True
            log(f"tune (c): probe_cuda_capability() -> {cache.get_capability()} "
                f"persisted in {path} [{self.card}]")
            ok &= self._tune_gist(cache)
            ok &= self._tune_msmarco()
            ok &= self._tune_pipeline()
            log(f"tune: {len(cache)} entries in {path}: {sorted(cache.keys())}")
        return ok

    def _tune_gist(self, cache) -> bool:
        from repro_torch.tuning import AutotuneCache

        cfg = TUNE["gist"]
        x, q = self._dataset(cfg["n"], cfg["d"], max(TUNE["int8_ms"]), seed=cfg["seed"])
        eng = self._fit("tune gist", x, cfg["k"])
        del x
        eng.enable_int8()
        ok, won = True, {}
        for tier, ms in (("f32", TUNE["f32_ms"]), ("int8", TUNE["int8_ms"])):
            for m in ms:
                label = f"tune gist {tier} m={m} k={cfg['k']}"
                p = eng.plan_for("fqsd", m, tier=tier)
                won[tier, m] = self._sweep(label, p.m, p.padded_rows, p.padded_dim, cfg["k"],
                                           tier, eng.rescore_factor, cfg["seed"])
                ok &= self._tune_gate(label, eng, q[:m], tier, cfg["k"], *won[tier, m])
        # (c): a persisted false verdict makes the plan raise, never fall back
        veto = AutotuneCache(path=None)
        veto.put_capability(False)
        with self._planning_with(veto):
            try:
                eng.plan_for("fqsd", 16)
                raised = False
            except RuntimeError as e:
                raised = "capability verdict" in str(e)
        log(f"tune (c): plan under a persisted false verdict raised={raised}")
        del eng
        self.torch.cuda.empty_cache()
        return ok and raised and self._tune_clustered(*won["int8", TUNE["clustered_m"]])

    def _sweep(self, label, m, n, dp, k, tier, rescore, seed) -> tuple[tuple, tuple]:
        """autotune_knn at a planner-visible geometry, every candidate's time
        printed; returns (winner, default blocks)."""
        from repro_torch.tuning import autotune_knn

        r = rescore if tier == "int8" else None
        default = self.ops.resolved_blocks(k, dp, m=m, rescore_factor=r)
        t0 = time.perf_counter()
        best, timings = autotune_knn(m, n, dp, k=k, tier=tier, rescore_factor=rescore,
                                     repeats=TUNE["repeats"], seed=seed)
        name = lambda b: "x".join(map(str, b))  # noqa: E731
        log(f"{label}: (n={n}, d={dp}) swept {len(timings)} candidates in "
            f"{time.perf_counter() - t0:.1f} s, rows drawn included (host clock, median of "
            f"{TUNE['repeats']} after a warm call, bm x bn x bd): "
            + ", ".join(f"{c} {t * 1e3:.4f} ms" for c, t in timings.items())
            + f"; winner {name(best)}, default {name(default)} "
            f"{timings[name(default)] * 1e3:.4f} ms [{self.card}]")
        return tuple(best), tuple(default)

    def _tune_gate(self, label, eng, q, tier, k, best, default) -> bool:
        """Gate (b) at the engine's shape, then the scan alone at the winner
        and at the default blocks."""
        torch = self.torch
        from repro_torch import SearchRequest
        from repro_torch.core import cache_info
        from repro_torch.tuning import AutotuneCache

        req = SearchRequest(queries=q, k=k, tier=tier, mode_hint="fqsd")
        p = eng.plan_for("fqsd", q.shape[0], tier=tier)
        got = eng.search(req)
        first = cache_info()["misses"]
        eng.search(req)
        eng.search(req)
        added = cache_info()["misses"] - first
        with self._planning_with(AutotuneCache(path=None)):
            want = eng.search(req)
        same = (torch.equal(got.topk.scores, want.topk.scores)
                and torch.equal(got.topk.indices, want.topk.indices)
                and (tier == "f32" or torch.equal(got.certified, want.certified)))
        ok = ((p.block_m, p.block_n, p.block_d) == best and got.kernel_stats["blocks"] == best
              and want.kernel_stats["blocks"] == default and added == 0 and same)
        t_best, t_default = (self._scan_ms(eng, q, tier, k, b) for b in (best, default))
        log(f"{label} (b): {p.executor} plan blocks {(p.block_m, p.block_n, p.block_d)}; "
            f"tuned search bit-identical to the default plan's={same}; cache misses added "
            f"by two more searches {added}; "
            f"{'knn_int8_scan' if tier == 'int8' else 'knn_scan'} alone (CUDA events, median "
            f"of {REPEATS}): winner {t_best:.4f} ms, default {t_default:.4f} ms; ok={ok} "
            f"[{self.card}]")
        return ok

    def _scan_ms(self, eng, q, tier, k, blocks) -> float:
        """CUDA-event time of the scan kernel alone at `blocks` on the
        engine's resident operands."""
        torch, K, ops = self.torch, self.K, self.ops
        qv = eng._pad_queries(q)
        if tier == "f32":
            call = ops.prepare(qv, eng._ds.vectors, k, "l2", eng._ds.norms, *blocks)
            bm, bn, _ = call.blocks
            qn = self.qnorm(call.q)
            return self.ms(lambda: K.knn_scan(call.q, call.x, qn, call.xn, call.k_eff,
                                              call.metric, bm, bn))
        call = ops.prepare_int8(qv, eng._int8, k, eng.rescore_factor, *blocks)
        bm, bn, _ = call.blocks
        return self.ms(lambda: K.knn_int8_scan(call.q, call.x8, call.qn, call.scales,
                                               call.err, call.hn, call.q_len, bm, bn))

    def _tune_clustered(self, best, default) -> bool:
        """The m = 64 int8 winner and the default blocks on the serve
        phase's clustered rows (vector_dataset), where the survivor filter
        works otherwise than on Gaussian rows: the whole ops.knn_int8 call
        and the scan alone, and their answers bit for bit."""
        torch, ops = self.torch, self.ops
        m = TUNE["clustered_m"]
        if self.serve_rows is None:  # phase serve did not run: build its collection
            from repro_torch import ExactKNN
            from repro_torch.configs import get_config
            from repro_torch.data import query_stream, vector_dataset

            shape = get_config("knn-search").shape(SERVE["shape"])
            x = vector_dataset(shape["n"], shape["d"], seed=0)
            eng = ExactKNN(k=shape["k"], backend="cuda", device=self.dev).fit(x)
            eng.enable_int8()
            self.serve_rows = (eng, torch.from_numpy(query_stream(x, SERVE["queries"],
                                                                  seed=1)).to(self.dev))
            del x
        eng, qt = self.serve_rows
        self.serve_rows = None
        k, q = eng.k, qt[:m]
        qv = eng._pad_queries(q)
        out, t_call, t_scan = {}, {}, {}
        for label, blocks in (("winner", best), ("default", default)):
            run = lambda b=blocks: ops.knn_int8(qv, eng._int8, eng._ds.vectors, k,  # noqa: E731
                                                 eng.rescore_factor, *b)
            out[label] = run()
            t_call[label] = self.ms(run)
            t_scan[label] = self._scan_ms(eng, q, "int8", k, blocks)
        (a, ca), (b, cb) = out["winner"], out["default"]
        same = (torch.equal(a.scores, b.scores) and torch.equal(a.indices, b.indices)
                and torch.equal(ca, cb))
        log(f"tune clustered int8 m={m}, k={k} (serve rows, vector_dataset): winner "
            f"{'x'.join(map(str, best))}: ops.knn_int8 {t_call['winner']:.4f} ms, "
            f"knn_int8_scan {t_scan['winner']:.4f} ms; default {'x'.join(map(str, default))}: "
            f"ops.knn_int8 {t_call['default']:.4f} ms, knn_int8_scan {t_scan['default']:.4f} "
            f"ms (CUDA events, median of {REPEATS}); answers and certificates bit-identical="
            f"{same}; certified {int(ca.sum())}/{m} [{self.card}]")
        del eng, qt
        torch.cuda.empty_cache()
        return same

    def _tune_msmarco(self) -> bool:
        """The FD-SQ scan at the MS-MARCO shape: the sweep first (over its
        own 31.7 GB of rows), then an engine of the same geometry for gate
        (b); the card holds one of the two at a time."""
        from repro_torch import ExactKNN
        from repro_torch.core.partition import LANE, aligned_shape

        cfg = TUNE["msmarco"]
        label = f"tune msmarco f32 m={cfg['m']} k={cfg['k']}"
        n_parts = ExactKNN(k=cfg["k"], backend="cuda", device=self.dev).n_partitions
        rows, dp = aligned_shape(cfg["n"], cfg["d"], LANE * n_parts)
        won = self._sweep(label, cfg["m"], rows, dp, cfg["k"], "f32", None, cfg["seed"])
        self.torch.cuda.empty_cache()
        x, q = self._dataset(cfg["n"], cfg["d"], cfg["m"], seed=cfg["seed"])
        eng = self._fit("tune msmarco", x, cfg["k"])
        del x
        self.torch.cuda.empty_cache()
        ok = self._tune_gate(label, eng, q, "f32", cfg["k"], *won)
        del eng
        self.torch.cuda.empty_cache()
        return ok

    def _tune_pipeline(self) -> bool:
        """autotune_pipeline at phase 6's streamed GIST int8 shape, then gate
        (b) on a pinned store of phase 6's geometry: the plan carries the
        winning knobs, its search equals the default knobs' bit for bit and
        two more add no cache miss; both timed (host clock)."""
        torch = self.torch
        from repro_torch import ExactKNN, SearchRequest
        from repro_torch.core import cache_info
        from repro_torch.store import DatasetStore
        from repro_torch.tuning import AutotuneCache, autotune_pipeline

        cfg = TUNE["pipeline"]
        n, d, m, k = cfg["n"], cfg["d"], cfg["m"], cfg["k"]
        t0 = time.perf_counter()
        best, timings = autotune_pipeline(m, n, d, k=k, repeats=TUNE["repeats"],
                                          rescore_candidates=cfg["rescore"],
                                          shard_candidates=cfg["shards"], seed=cfg["seed"])
        default = f"shard{cfg['shards'][0]}|pf2|tr0.5|r4"
        log(f"tune pipeline m={m} k={k} (n={n}, d={d}): swept {len(timings)} combinations "
            f"in {time.perf_counter() - t0:.1f} s, stores built included (host clock, median "
            f"of {TUNE['repeats']} whole searches after a warm one; every answer "
            "bit-identical to the default knobs', else the sweep raises): "
            + ", ".join(f"{c} {t * 1e3:.3f} ms" for c, t in timings.items())
            + f"; winner {tuple(best)}, default {default} {timings[default] * 1e3:.3f} ms "
            f"[{self.card}]")
        x, q = self._dataset(n, d, m, seed=cfg["seed"])
        store = DatasetStore.from_array(x, rows_per_shard=cfg["shards"][0], pin_memory=True)
        del x
        store.ensure_tier("int8", device=self.dev)
        eng = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(store, resident=False)
        eng.enable_int8()
        p = eng.plan_for("fqsd-streamed", m, tier="int8")
        req = SearchRequest(queries=q, k=k, tier="int8")
        got = eng.search(req)
        first = cache_info()["misses"]
        eng.search(req)
        eng.search(req)
        added = cache_info()["misses"] - first
        tuned_ms, _ = self.host_clock_ms(lambda: eng.search(req), TUNE["searches"])
        with self._planning_with(AutotuneCache(path=None)):
            want = eng.search(req)
            default_ms, _ = self.host_clock_ms(lambda: eng.search(req), TUNE["searches"])
        same = (torch.equal(got.topk.scores, want.topk.scores)
                and torch.equal(got.topk.indices, want.topk.indices)
                and torch.equal(got.certified, want.certified))
        knobs = (p.prefetch_depth, p.spec_trigger, p.rescore_factor)
        ok = (p.executor == "fqsd-int8-streamed" and added == 0 and same
              and knobs == (best.prefetch_depth, best.spec_trigger, best.rescore_factor))
        log(f"tune pipeline (b): {p.executor} plan knobs (depth, trigger, rescore) {knobs}; "
            f"tuned search bit-identical to the default knobs'={same}; cache misses added by "
            f"two more searches {added}; search with the tuned knobs {tuned_ms:.3f} ms, with "
            f"the default knobs {default_ms:.3f} ms (host clock, median of "
            f"{TUNE['searches']}, shards of {cfg['shards'][0]} rows); ok={ok} [{self.card}]")
        del eng, store
        torch.cuda.empty_cache()
        return ok

    # --------------------------------------------------- phase 12: kernels
    def phase_kernels(self) -> bool:
        """The standalone entry points: l2dist, then topk over its matrix;
        then l2dist alone at each shape of STANDALONE["l2dist"]."""
        torch, K = self.torch, self.K
        from repro_torch.core.distance import row_norms_sq
        from repro_torch.kernels.l2dist import kernel as L
        from repro_torch.kernels.l2dist import ops as LO
        from repro_torch.kernels.topk import kernel as T
        from repro_torch.kernels.topk import ops as TO
        from repro_torch.kernels.topk.ref import topk_ref

        n, d, m, k = (STANDALONE[key] for key in ("n", "d", "m", "k"))
        x, queries = self._dataset(n, d, max(mm for mm, _ in STANDALONE["l2dist"]), seed=5)
        q = queries[:m]
        self.sync()
        K.reset_launch_counts()
        dist = LO.l2dist(q, x)
        v, i = TO.topk(dist, k)
        self.sync()
        launches = dict(K.LAUNCHES)
        ok = launches["l2dist"] >= 1 and launches["topk"] >= 1 and launches["knn_merge"] == 1
        label = f"standalone_m{m}_n{n}_d{d}_k{k}"
        log(f"{label}: launches={launches}")

        qn, xn = row_norms_sq(q), row_norms_sq(x)
        self._row_norms_cost(x, row_norms_sq)
        plain = L.l2dist_plain(q, x, qn, xn)
        tol = TOL_REL * (qn[:, None] + float(xn.max()))
        ok_l2 = bool(((dist - plain).abs() <= tol).all()) and bool(torch.isfinite(dist).all())
        del plain
        rv, ri = topk_ref(dist, k)
        topk_exact = torch.equal(v, rv) and torch.equal(i, ri)
        k_eff, bn = k, max(1024, k)
        n_tiles = -(-n // bn)
        splits = T.topk_splits(m, n_tiles, self.dev)
        sv, si, st = T.topk_scan(dist, k_eff, bn, splits, return_stats=True)
        pv, pi = T.topk_scan_plain(dist, k_eff, bn, splits)
        scan_exact = torch.equal(sv, pv) and torch.equal(si, pi)
        ok &= ok_l2 and topk_exact and scan_exact
        log(f"{label}: l2dist within tol of plain={ok_l2}; topk bit-identical to the full "
            f"sort={topk_exact}; topk scan bit-identical to plain={scan_exact}; ok={ok}")

        tk_ms = self.ms(lambda: T.topk_scan(dist, k_eff, bn, splits))
        tk_fused_ms = self.ms(lambda: T.topk_fused(dist, k_eff, bn))
        tk_plain_ms = self.ms(lambda: T.topk_scan_plain(dist, k_eff, bn, splits))
        tk_lib_ms = self.ms(lambda: torch.topk(dist, k, largest=False))
        merge_ms = self.ms(lambda: K.knn_merge(sv, si))
        merge_plain_ms = self.ms(lambda: K.knn_merge_plain(sv, si))
        flat = sv.reshape(m, -1)
        merge_lib_ms = self.ms(lambda: torch.topk(flat, k_eff, largest=False))

        # topk's function reads the scores once and writes the (m, k) result;
        # the design also writes S queues, and its survivor filter compares
        # every score once and sorts, searches and merges the survivors (the
        # queues are in shared memory: no device bytes)
        tk_bytes = m * n * 4 + m * k * 8
        tk_ops = m * n  # one comparison per score
        sel = self.select_work(st, k_eff, m * n)
        design_ms, _ = self.bound(m * n * 4 + sv.numel() * 8, m * n + sel["ops"])
        merge_bytes, merge_ops = self.merge_work(sv, si, *K.knn_merge_plain(sv, si))
        shape = {"shape": label, "splits": splits, "blocks": [1, bn], "select": sel,
                 "topk_with_merges_ms": tk_fused_ms, "kernels": {}}
        for name, t, tp, tl, lib, (bb, by), err in (
                ("topk", tk_ms, tk_plain_ms, tk_lib_ms, "torch.topk(scores, k, largest=False)",
                 self.bound(tk_bytes, tk_ops), 0.0 if scan_exact else math.inf),
                ("knn_merge", merge_ms, merge_plain_ms, merge_lib_ms,
                 "torch.topk(queues.reshape(m, -1))", self.bound(merge_bytes, merge_ops),
                 0.0 if topk_exact else math.inf)):
            shape["kernels"][name] = {
                "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": tp,
                "bound_ms": bb, "bound_by": by, "library_ms": tl, "library": lib}
            log(f"{label}: {name} ms={t:.4f} plain_ms={tp:.4f} library_ms={tl:.4f} "
                f"bound_ms={bb:.4f} ({by}) launches={launches[name]}")
        shape["kernels"]["topk"]["design_bound_ms"] = design_ms
        log(f"{label}: topk S={splits} survivor filter {sel}")
        log(f"{label}: topk scan + merges ms={tk_fused_ms:.4f} (torch.topk {tk_lib_ms:.4f}); "
            f"bound over its S queues and survivor work design_bound_ms={design_ms:.4f}")
        self.shapes.append(shape)
        del dist, sv, si, pv, pi, flat
        for mm, dtype_name in STANDALONE["l2dist"]:
            ok &= self._l2dist_shape(L, x, queries[:mm], getattr(torch, dtype_name))
        self._l2dist_crossover(L, x, queries)
        return ok

    def _row_norms_cost(self, x, row_norms_sq) -> None:
        """The cost of row_norms_sq's fixed summation order
        (sum_last_fixed, a row's bits independent of its neighbours) at a
        fit's shape, beside the torch.sum order it replaced, chunked alike."""
        torch = self.torch
        from repro_torch.core.distance import _NORM_CHUNK_ROWS as chunk

        def torch_sum_order():
            out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
            for s in range(0, x.shape[0], chunk):
                c = x[s: s + chunk].to(torch.float32)
                out[s: s + chunk] = torch.sum(c * c, dim=-1)
            return out

        fixed_ms = self.ms(lambda: row_norms_sq(x))
        sum_ms = self.ms(torch_sum_order)
        log(f"row_norms_sq {tuple(x.shape)} f32: fixed order ms={fixed_ms:.4f} torch.sum "
            f"order ms={sum_ms:.4f} [{self.card}]")

    def _l2dist_shape(self, L, x, q, dtype) -> bool:
        """l2dist alone on (q, x) in `dtype`: one launch with the counters
        at 0, held to its plain version within TOL_REL·(qn + max xn), then
        timed beside it and beside torch.cdist's matrix-product form (one
        call, the same function up to the square root), all three over runs
        of STANDALONE["calls"] calls back to back (the wrapper's host work,
        tens of microseconds, would otherwise sit inside each window)."""
        torch = self.torch
        from repro_torch.core.distance import row_norms_sq

        q, x = q.to(dtype).contiguous(), x.to(dtype).contiguous()
        (m, d), n = q.shape, x.shape[0]
        qn, xn = row_norms_sq(q), row_norms_sq(x)
        self.sync()
        self.K.reset_launch_counts()
        got = L.l2dist_tiles(q, x, qn, xn)
        self.sync()
        launches = self.K.LAUNCHES["l2dist"]
        plain = L.l2dist_plain(q, x, qn, xn)
        diff = (got - plain).abs()
        err = float(diff.max())
        ok = (launches == 1 and bool((diff <= TOL_REL * (qn[:, None] + float(xn.max()))).all())
              and bool(torch.isfinite(got).all()))
        del got, plain, diff
        elem = x.element_size()
        nbytes = (m + n) * d * elem + (m + n) * 4 + m * n * 4
        bb, by = self.bound(nbytes, 2 * m * n * d)
        calls = STANDALONE["calls"]
        t = self.ms(lambda: L.l2dist_tiles(q, x, qn, xn), calls=calls)
        tp = self.ms(lambda: L.l2dist_plain(q, x, qn, xn), calls=calls)
        lib = "torch.cdist(q, x, compute_mode='use_mm_for_euclid_dist') (not squared)"
        try:
            tl = self.ms(lambda: torch.cdist(q, x, compute_mode="use_mm_for_euclid_dist"),
                         calls=calls)
        except RuntimeError as e:  # a yardstick only: the port never calls it
            log(f"  torch.cdist refused {dtype}: {e}")
            tl = None
        label = f"l2dist_m{m}_n{n}_d{d}_{str(dtype).split('.')[-1]}"
        shape = {"shape": label, "kernels": {"l2dist": {
            "launches": launches, "max_abs_err": err, "ms": t, "plain_ms": tp, "bound_ms": bb,
            "bound_by": by, "library_ms": tl, "library": lib}}}
        if (m, dtype) == (STANDALONE["m"], torch.float32):
            shape["cdist_direct_ms"] = self.ms(lambda: torch.cdist(
                q, x, compute_mode="donot_use_mm_for_euclid_dist"), calls=calls)
            log(f"{label}: cdist direct form ms={shape['cdist_direct_ms']:.4f}")
        if hasattr(L, "l2dist_config"):
            shape["config"] = L.l2dist_config(m, n, d, dtype)._asdict()
        log(f"{label}: l2dist ms={t:.4f} plain_ms={tp:.4f} library_ms={tl} bound_ms={bb:.4f} "
            f"({by}) max|d|={err:.3e} launches={launches} ok={ok} {shape.get('config', '')} "
            f"[{self.card}]")
        self.shapes.append(shape)
        return ok

    def _l2dist_crossover(self, L, x, queries) -> None:
        """Both l2dist kernels timed at the batches around the crossover
        (f32), the measurement STREAM_MAX_M rests on."""
        from repro_torch.core.distance import row_norms_sq

        if not hasattr(L, "l2dist_config"):
            log("l2dist crossover: this package has one l2dist kernel (no l2dist_config)")
            return
        sms = self.torch.cuda.get_device_properties(self.dev).multi_processor_count
        n, d = x.shape
        xn = row_norms_sq(x)
        for m in STANDALONE["crossover_ms"]:
            q = queries[:m].contiguous()
            qn = row_norms_sq(q)
            times = {path: self.ms(lambda: L.l2dist_launch(
                q, x, qn, xn, L.l2dist_config(m, n, d, q.dtype, sms, path)),
                calls=STANDALONE["calls"]) for path in ("stream", "tiled")}
            log(f"l2dist crossover m={m}: stream_ms={times['stream']:.4f} "
                f"tiled_ms={times['tiled']:.4f} (picked: {L.l2dist_config(m, n, d).path})")

    # ------------------------------------------------------ phase 13: mesh
    @property
    def first_device(self) -> str:
        """The device the mesh's logical positions all name."""
        return "cuda:0" if self.dev.type == "cuda" else str(self.dev)

    @staticmethod
    def hier_merges(sizes) -> int:
        """knn_merge launches of a hierarchical merge over axes of `sizes`,
        innermost first, one a group of more than one position
        (core/sharded.py::fdsq_sharded)."""
        total, outer = 0, 1
        for a in sizes:
            if a > 1:
                total += outer
            outer *= a
        return total

    def phase_mesh(self) -> bool:
        """The mesh at the GIST shape, nothing cut: a 2 x 2 mesh of logical
        devices on the one card, each block 250,112 x 1,024."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch import ExactKNN, SearchRequest
        from repro_torch.core.mesh import make_mesh
        from repro_torch.core.planner import largest_divisor_at_most
        from repro_torch.store import DatasetStore

        cfg = MESH
        n, d, k, reps = cfg["n"], cfg["d"], cfg["k"], cfg["repeats"]
        sizes = tuple(cfg["shape"])
        mesh = make_mesh(sizes, cfg["axes"], devices=[self.first_device] * math.prod(sizes))
        n_pos = mesh.size
        x, q = self._dataset(n, d, cfg["m"], seed=cfg["seed"])
        t0 = time.perf_counter()
        hstore = DatasetStore.from_array(x, rows_per_shard=cfg["rows_per_shard"],
                                         pin_memory=self.dev.type == "cuda")
        hstore.ensure_tier("int8", device=self.dev)
        meng = ExactKNN(k=k, backend="cuda", mesh=mesh, mesh_axes=cfg["axes"])
        store = DatasetStore.from_array(x, row_mult=meng._row_mult())
        del x
        meng.fit_store(store)
        single = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(store)
        self.sync()
        ds = meng._ds
        rows, dp = ds.vectors.rows, ds.vectors.shape[1]
        views = all(ds.vectors.local[p].data_ptr() == single._ds.vectors.data_ptr()
                    + p * rows * dp * 4 for p in range(n_pos))
        log(f"mesh: {mesh} over {cfg['axes']}; padded {tuple(ds.vectors.shape)}, "
            f"{n_pos} blocks of {rows} x {dp} (views of the single-device rows={views}); "
            f"pinned host store of {hstore.n_shards} shards x {hstore.rows_per_shard} with its "
            f"int8 tier; set-up {time.perf_counter() - t0:.2f} s; device memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{self.card}]")
        torch.cuda.empty_cache()
        parts = len(ops.shard_parts(rows, k, dp))
        hier = self.hier_merges(sizes)
        n_d, n_t = sizes
        ok = views & self._batch_probe(meng._pad_queries(q), ds, k)

        # ---- f32: (a) bit-identical to fdsq-cuda at the same batch, (c)
        # the schedule's launches
        specs = [(f"mesh_fdsq_m{m}_k{k}", m, "fdsq", "fdsq-sharded", m,
                  {"knn_scan": n_pos * parts, "knn_merge": n_pos + hier})
                 for m in cfg["fdsq_ms"]]
        mq = cfg["m"]
        specs.append((f"mesh_ring_m{mq}_k{k}", mq, "fqsd", "fqsd-sharded", mq // n_d,
                      {"knn_scan": n_d * n_d * n_t * parts,
                       "knn_merge": n_d * n_d * n_t + (n_d if n_t > 1 else 0)}))
        reqs, base = {}, {}
        for label, m, mode, executor, block_m, want_l in specs:
            base[label] = want_l
            req = reqs[label] = SearchRequest(queries=q[:m], k=k, mode_hint=mode)
            want = single.search(req).topk
            got, launches = self._counted(lambda: meng.search(req))
            same = torch.equal(got.topk.scores, want.scores) and torch.equal(got.topk.indices,
                                                                             want.indices)
            good_c = all(launches[name] == want_l.get(name, 0) for name in launches)
            mesh_ms = self.host_clock_ms(lambda: meng.search(req), reps)[0]
            single_ms = self.host_clock_ms(lambda: single.search(req), reps)[0]
            assert single.plans[-1].executor == "fdsq-cuda"
            good = same and good_c and got.plan.executor == executor
            log(f"{label}: executor={got.plan.executor} mode={got.plan.mode} (a) bit-identical "
                f"to fdsq-cuda at the same batch of {m}={same}; (c) launches={launches} "
                f"schedule={want_l} ok={good_c}; search ms median mesh={mesh_ms:.3f} "
                f"single-device fdsq-cuda={single_ms:.3f} [{self.card}]")
            ok &= good
            self.shapes.extend(self._mesh_f32_shapes(label, meng._pad_queries(q[:block_m]), ds,
                                                     k, launches))

        # ---- the ring's copies against its scans (one ring step), and
        # traced ring searches: where a slow one spends its time
        blocks = [(ds.vectors.local[p], ds.norms.local[p]) for p in range(n_pos)]
        qv8 = meng._pad_queries(q[: mq // n_d])
        copy_ms = self.ms(lambda: [(v.clone(), nn.clone()) for v, nn in blocks])
        k_eff = 1 << max(0, (k - 1).bit_length())

        def ring_step():
            for v, nn in blocks:
                ops.knn_shard(torch.full((qv8.shape[0], k_eff), torch.inf, device=self.dev),
                              torch.full((qv8.shape[0], k_eff), -1, dtype=torch.int32,
                                         device=self.dev), qv8, v, nn, k, "l2", 0)

        step_ms = self.ms(ring_step)
        copy_bytes = sum(v.numel() * 4 + nn.numel() * 4 for v, nn in blocks)
        log(f"mesh ring: one step's block copies {copy_ms:.4f} ms ({copy_bytes} B, "
            f"{2 * copy_bytes / copy_ms / 1e6:.1f} GB/s read + written) against its block "
            f"scans {step_ms:.4f} ms (m={qv8.shape[0]} a block, {n_pos} blocks); the ring "
            f"runs {n_d - 1} copy step(s) and {n_d} scan steps a search [{self.card}]")
        traced = self._ring_profile(f"mesh_ring_m{mq}_k{k}", meng,
                                    reqs[f"mesh_ring_m{mq}_k{k}"], cfg["traced"])
        fresh = [row["allocator"]["num_device_alloc"] for row in traced]
        log(f"mesh ring: new device allocations a warm traced search {fresh} (gate: all 0)")
        ok &= not any(fresh)

        # ---- int8 resident: (b) = knn_exact_direct, (c), (d)
        meng.enable_int8()
        req8 = SearchRequest(queries=q, k=k, tier="int8")
        qv = single._pad_queries(q)
        chunk = largest_divisor_at_most(single._ds.vectors.shape[0], 8192)
        oracle = ops.knn_exact_direct(qv, single._ds.vectors, single._ds.norms, k, chunk)
        got8, launches = self._counted(lambda: meng.search(req8))
        want_l = base["int8"] = {"knn_int8_scan": n_pos, "knn_merge": n_pos + hier}
        bpd = got8.stats.get("bytes_per_device", [])
        scan_bytes = n_pos * rows * (dp + 12)
        good = self._mesh_int8_gates(f"mesh_int8_m{mq}_k{k}", got8, oracle, launches, want_l,
                                     "fdsq-sharded-int8", bpd, scan_bytes, n_pos)
        t_mesh = self.host_clock_ms(lambda: meng.search(req8), reps)[0]
        single.enable_int8()  # the store's tier, already quantised: a view
        t_single = self.host_clock_ms(lambda: single.search(req8), reps)[0]
        last = meng.search(req8).stats
        log(f"mesh_int8_m{mq}_k{k}: search ms median {t_mesh:.3f} single-device "
            f"{single.plans[-1].executor} {t_single:.3f}; phases of a warm search "
            f"{ {key: round(last[key], 3) for key in ('scan_ms', 'gather_ms', 'rescore_ms')} } "
            f"[{self.card}]")
        ok &= good
        q8 = meng._int8
        blocks8 = [(q8.q.local[p], q8.scales.local[p], q8.err.local[p],
                    torch.where(torch.isfinite(q8.norms_sq.local[p]), q8.qnorm_sq.local[p],
                                torch.inf), p * q8.q.rows) for p in range(n_pos)]
        self.shapes.extend(self._int8_shapes(f"mesh_int8_m{mq}_k{k}", qv, blocks8, k, launches,
                                             self._budget(got8.plan), n_pos, 2))
        del blocks8

        # ---- int8 ring over the pinned host store: (b), (c), (d)
        reng = ExactKNN(k=k, backend="cuda", mesh=mesh, mesh_axes=cfg["axes"]).fit_store(
            hstore, resident=False).enable_int8()
        sreng = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(
            hstore, resident=False).enable_int8()
        n_sh = hstore.n_shards
        gotr, launches = self._counted(lambda: reng.search(req8))
        want_l = {"knn_int8_scan": n_sh, "knn_merge": n_sh + 1}
        shard_bytes = sum(hstore.read_shard(i, "int8").scan_bytes() for i in range(n_sh))
        good = self._mesh_int8_gates(f"mesh_ring_int8_m{mq}_k{k}", gotr, oracle, launches,
                                     want_l, "fqsd-sharded-int8",
                                     gotr.stats.get("bytes_per_device", []), shard_bytes, n_pos)
        good &= gotr.stats.get("transfers") == n_sh
        t_ring = self.host_clock_ms(lambda: reng.search(req8), reps)[0]
        t_one = self.host_clock_ms(lambda: sreng.search(req8), reps)[0]
        log(f"mesh_ring_int8_m{mq}_k{k}: transfers={gotr.stats.get('transfers')} search ms "
            f"median ring over {n_pos} positions={t_ring:.3f} single-device "
            f"fqsd-int8-streamed={t_one:.3f} [{self.card}]")
        ok &= good
        self._ring_profile(f"mesh_ring_int8_m{mq}_k{k}", reng, req8, cfg["traced_int8"])
        shards = [hstore.read_shard(i, "int8") for i in range(n_sh)]
        blocks_r = [(s8.q.to(self.dev), s8.scales.to(self.dev), s8.err.to(self.dev),
                     s8.qnorm.to(self.dev), s8.base_index) for s8 in shards]
        self.shapes.extend(self._int8_shapes(f"mesh_ring_int8_m{mq}_k{k}", qv, blocks_r, k,
                                             launches, self._budget(gotr.plan), n_pos, n_pos))
        del shards, blocks_r
        del reng, sreng, hstore
        torch.cuda.empty_cache()

        # ---- Router.create(devices=) behind the AdaptiveScheduler
        ok &= self._mesh_replay(store, single, k, chunk, parts)

        # ---- (e) mutations and a filter mask: as a fresh fit, no cache miss
        ok &= self._mesh_mutate(meng, single, q, k, n, d, reqs, req8, base)
        del meng, single, store
        torch.cuda.empty_cache()
        return ok

    def _counted(self, fn):
        """fn() with the launch counters at 0 just before and read just after."""
        self.sync()
        self.K.reset_launch_counts()
        out = fn()
        self.sync()
        return out, dict(self.K.LAUNCHES)

    def _batch_probe(self, qv, ds, k) -> bool:
        """Where a score's bits could depend on the batch, on block 0's
        aligned rows: the query norms of the first 8 queries computed in a
        batch of 8 and in one of 16, by torch.sum and by the fixed order the
        scans use (query_norms_sq); knn_scan (then knn_merge) at bm = 8 and
        bm = 16 with those norms held fixed, and with torch.sum's. Holds
        that the fixed-order norms and the scan at fixed norms do not
        depend on the batch."""
        torch, K, ops = self.torch, self.K, self.ops
        x, xn = ds.vectors.local[0], ds.norms.local[0]
        a, b = ops.shard_parts(x.shape[0], k, x.shape[1])[0]
        c16, c8 = (ops.prepare(qv[:m], x[a:b], k, "l2", xn[a:b]) for m in (16, 8))
        s16, s8 = (torch.sum(c.q * c.q, dim=-1) for c in (c16, c8))
        f16, f8 = self.qnorm(c16.q), self.qnorm(c8.q)

        def scan(c, qn):
            bm, bn, _ = c.blocks
            sv, si, _ = K.knn_scan(c.q, c.x, qn, c.xn, c.k_eff, "l2", bm, bn)
            return K.knn_merge(sv, si)

        (v16, i16), (v8, i8) = scan(c16, f16), scan(c8, f8)
        (w16, j16), (w8, j8) = scan(c16, s16), scan(c8, s8)
        sum_rows = int((s16[:8] != s8).sum())
        fixed_same = torch.equal(f16[:8], f8)
        scan_same = torch.equal(v16[:8], v8) and torch.equal(i16[:8], i8)
        sum_scores = int((w16[:8] != w8).sum())
        # what the fixed order costs a scan call: host time to enqueue
        # (the host clock over 200 calls, then a synchronise) and device time
        cost = {}
        for name, fn in (("torch.sum", lambda: torch.sum(c16.q * c16.q, dim=-1)),
                         ("query_norms_sq", lambda: self.qnorm(c16.q))):
            self.sync()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            self.sync()
            cost[name] = (round(host_us, 1), round(self.ms(fn) * 1e3, 1))
        log(f"mesh batch probe: query norms of {tuple(c16.q.shape)}, (host us to enqueue, "
            f"device us) {cost} [{self.card}]")
        log(f"mesh batch probe (8 queries in a batch of 8 and of 16, block 0's {b - a} rows, "
            f"bm={c8.blocks[0]} / {c16.blocks[0]}): torch.sum's query norms differ in "
            f"{sum_rows} of 8 rows, whose top-{k} scores then differ in {sum_scores} of "
            f"{w8.numel()}; the fixed-order norms (query_norms_sq) bit-identical={fixed_same}; "
            f"knn_scan + knn_merge at fixed norms bit-identical={scan_same}")
        return fixed_same and scan_same

    def _ring_profile(self, label, eng, req, n: int) -> list[dict]:
        """n searches of `req`, each on the host clock and traced: device ms
        by kind (copies, knn_scan, knn_merge, knn_int8_scan, other kernels),
        the span from the first device event to the last, the host ms in
        cudaMalloc / cudaFree, and the caching allocator's new device
        allocations, frees and retries over the search. Returns the rows."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        kinds = ("copy", "knn_scan", "knn_merge", "knn_int8_scan", "other")
        rows = []
        for _ in range(n):
            self.sync()
            before = torch.cuda.memory_stats(self.dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.search(req)
                self.sync()
                wall = (time.perf_counter() - t0) * 1e3
            after = torch.cuda.memory_stats(self.dev)
            dev = dict.fromkeys(kinds, 0.0)
            host = {"cudaMalloc": [0, 0.0], "cudaFree": [0, 0.0]}
            first, last = math.inf, -math.inf
            for e in prof.events():
                us = e.time_range.elapsed_us()
                if e.device_type == DeviceType.CUDA:
                    name = e.name
                    kind = ("copy" if "Memcpy" in name or "Memset" in name else
                            next((kk for kk in kinds[1:4] if kk + "_kernel" in name), "other"))
                    dev[kind] += us / 1e3
                    first, last = min(first, e.time_range.start), max(last, e.time_range.end)
                elif e.name in host:
                    host[e.name][0] += 1
                    host[e.name][1] += us / 1e3
            rows.append({
                "wall_ms": round(wall, 3),
                "device_ms": {kk: round(v, 3) for kk, v in dev.items() if v},
                "span_ms": round((last - first) / 1e3, 3) if last > first else 0.0,
                "cudaMalloc": [host["cudaMalloc"][0], round(host["cudaMalloc"][1], 3)],
                "cudaFree": [host["cudaFree"][0], round(host["cudaFree"][1], 3)],
                "allocator": {key: after.get(key, 0) - before.get(key, 0)
                              for key in ("num_device_alloc", "num_device_free",
                                          "num_alloc_retries")}})
        for i, row in enumerate(rows):
            log(f"{label} traced search {i + 1}/{n}: {json.dumps(row)} [{self.card}]")
        return rows

    def _mesh_int8_gates(self, label, res, oracle, launches, want_l, executor, bpd,
                         scan_bytes, n_pos) -> bool:
        """(b) every row bit-identical to knn_exact_direct; (c) the launches
        of the executor's schedule; (d) one per-device byte count a position,
        summing to the scan bytes."""
        torch = self.torch
        same = (torch.equal(res.topk.scores, oracle.scores)
                and torch.equal(res.topk.indices, oracle.indices))
        good_c = all(launches[name] == want_l.get(name, 0) for name in launches)
        good_d = len(bpd) == n_pos and sum(bpd) == scan_bytes
        share = float(res.certified.to(torch.float32).mean())
        log(f"{label}: executor={res.plan.executor} (b) bit-identical to knn_exact_direct="
            f"{same} (certified share {share:.4f}); (c) launches={launches} schedule={want_l} "
            f"ok={good_c}; (d) bytes_per_device={bpd} sum={sum(bpd)} scan bytes={scan_bytes} "
            f"ok={good_d}")
        return same and good_c and good_d and res.plan.executor == executor

    @staticmethod
    def _budget(plan) -> int:
        """An int8 mesh plan's candidate budget r (executors._rescore_budget)."""
        return max(1, min(int(plan.padded_rows), int(plan.rescore_factor) * plan.k))

    def _kernel_entry(self, launches, fn, plain, lib, lib_name, work, err) -> dict:
        """One kernel at one shape: `launches` from the main path's run, fn's
        and plain's CUDA-event ms, lib's (None: no one-call counterpart),
        and the bound of `work` (bytes, operations)."""
        bb, by = self.bound(*work)
        return {"launches": launches, "max_abs_err": err, "ms": self.ms(fn),
                "plain_ms": self.ms(plain), "bound_ms": bb, "bound_by": by,
                "library_ms": None if lib is None else self.ms(lib), "library": lib_name}

    def _merge_entry(self, launches, hv, hi) -> tuple[dict, bool]:
        """knn_merge of the sorted (m, S, w) queues (hv, hi) against its plain
        version (bit for bit), beside torch.topk of the flattened queues."""
        torch, K = self.torch, self.K
        mv, mi = K.knn_merge(hv, hi)
        mpv, mpi = K.knn_merge_plain(hv, hi)
        exact = torch.equal(mv, mpv) and torch.equal(mi, mpi)
        flat = hv.reshape(hv.shape[0], -1)
        entry = self._kernel_entry(
            launches, lambda: K.knn_merge(hv, hi), lambda: K.knn_merge_plain(hv, hi),
            lambda: torch.topk(flat, hv.shape[-1], largest=False),
            "torch.topk(queues.reshape(m, -1))", self.merge_work(hv, hi, mv, mi),
            0.0 if exact else math.inf)
        return entry, exact

    @staticmethod
    def _captured_merge(run) -> tuple:
        """The (m, S, w) queues that `run(merge)` hands its merge, which
        runs as knn_merge: the exact input of a position's knn_merge."""
        from repro_torch.kernels.knn.kernel import knn_merge

        seen = []

        def merge(v, i):
            seen.append((v, i))
            return knn_merge(v, i)

        run(merge)
        return seen[-1]

    def _log_shapes(self, label, shapes) -> None:
        for s in shapes:
            for name, e in s["kernels"].items():
                lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
                log(f"{s['shape']}: {name} {s['operands']} launches={e['launches']} "
                    f"ms={e['ms']:.4f} plain_ms={e['plain_ms']:.4f} library_ms={lib} "
                    f"bound_ms={e['bound_ms']:.4f} ({e['bound_by']}) "
                    f"max|d| vs plain={e['max_abs_err']:.3e} [{self.card}]")

    def _mesh_f32_shapes(self, label, qv, ds, k, launches, d=None) -> list[dict]:
        """The kernels of one f32 mesh search at the shapes it gives them,
        on blocks 0 and 1: "/block", knn_scan over a block's aligned rows
        and the knn_merge of its scans' queues into the position's queue
        ((m, S + S_tail + 1, k_eff)); "/tail", knn_scan over the block's
        last rows, padded to one row tile; "/hier", the knn_merge of two
        positions' queues ((m, 2, k_eff)), one group of the hierarchical
        merge. Each beside its plain version, one library call and its
        bound over the unpadded width d. `launches` (the search's counts)
        split by the schedule: each position step one scan of each part and
        one block merge, the other merges hierarchical."""
        torch, K, ops = self.torch, self.K, self.ops
        d, m = d or MESH["d"], qv.shape[0]
        x, xn = ds.vectors.local[0], ds.norms.local[0]
        parts = ops.shard_parts(x.shape[0], k, x.shape[1])
        steps = launches["knn_scan"] // len(parts)
        calls = [ops.prepare(qv, x[a:b], k, "l2", xn[a:b]) for a, b in parts]
        qn = self.qnorm(calls[0].q)
        k_eff = calls[0].k_eff
        shapes, ok, svs, sis = [], True, [], []
        for (a, b), call, tag in zip(parts, calls, ("block", "tail")):
            bm, bn, _ = call.blocks
            splits = K.scan_config(call.q.shape[0] // bm, call.x.shape[0] // bn, bm, self.dev)[0]
            args = (call.q, call.x, qn, call.xn, k_eff, "l2", bm, bn, True, splits)
            sv, si, _ = K.knn_scan(*args)
            pv, pi, _ = K.knn_scan_plain(*args)
            xmax = float(call.xn[torch.isfinite(call.xn)].max())
            good, err, _ = self._close(sv, si, pv, pi, TOL_REL * (qn[:, None, None] + xmax))
            ok &= good
            rows = b - a
            xr = call.x[:rows]
            lib_k = min(k, rows)
            entry = self._kernel_entry(
                steps, lambda: K.knn_scan(*args), lambda: K.knn_scan_plain(*args),
                lambda: torch.topk(torch.cdist(call.q[:m], xr) ** 2, lib_k, largest=False),
                f"torch.topk(torch.cdist(q, x)**2, {lib_k}) on the part's rows",
                ((rows + m) * d * 4 + (rows + m) * 4 + m * k * 8,
                 m * rows * (2 * d + L2_EPILOGUE_OPS)), err)
            shapes.append({"shape": f"{label}/{tag}", "splits": splits, "blocks": [bm, bn],
                           "operands": f"({m} x {rows} x {d}, S={splits})",
                           "kernels": {"knn_scan": entry}})
            svs.append(sv[:m])
            sis.append(torch.where(torch.isfinite(sv[:m]), si[:m] + a, si[:m]))
        v0 = torch.full((m, k_eff), torch.inf, device=self.dev)
        i0 = torch.full((m, k_eff), -1, dtype=torch.int32, device=self.dev)
        hv, hi = self._captured_merge(lambda merge: ops.merge_shard(
            v0, i0, torch.cat(svs, 1), torch.cat(sis, 1), 0, merge=merge))
        entry, exact = self._merge_entry(steps, hv, hi)
        ok &= exact
        shapes[0]["kernels"]["knn_merge"] = entry
        shapes[0]["operands"] += f", merge {tuple(hv.shape)}"
        # two positions' finished queues, as merge_queues stacks them
        qa = ops.knn_shard(v0, i0, qv, x, xn, k, "l2", 0)
        qb = ops.knn_shard(v0, i0, qv, ds.vectors.local[1], ds.norms.local[1], k, "l2",
                           ds.vectors.rows)
        hv, hi = torch.stack([qa[0], qb[0]], 1), torch.stack([qa[1], qb[1]], 1)
        entry, exact = self._merge_entry(launches["knn_merge"] - steps, hv, hi)
        ok &= exact
        shapes.append({"shape": f"{label}/hier", "operands": f"{tuple(hv.shape)}",
                       "kernels": {"knn_merge": entry}})
        self._log_shapes(label, shapes)
        if not ok:
            raise AssertionError(f"{label}: a mesh kernel disagrees with its plain version")
        return shapes

    def _int8_shapes(self, label, qv, blocks, k, launches, r, n_pos, group) -> list[dict]:
        """The kernels of one int8 mesh search at the shapes it gives them.
        `blocks`: the (codes, scales, err, qnorm, base) of every block a
        position scans, in the search's order, block i on position i mod
        n_pos. "/block": knn_int8_scan over block 0 and the knn_merge of its
        queues into the position's (m, r + 1) queue ((m, S + 1, q_len));
        "/hier": the knn_merge of the first `group` positions' queues, each
        having scanned its blocks, padded to next_pow2(r + 1) as
        merge_queues pads them ((m, group, w): 2 on the 2 x 2 mesh, whose
        merges go one axis at a time; n_pos for the ring's one merge). Beside
        their plain versions and bounds over the unpadded width d (the int8
        scan has no one-call library counterpart). `launches` split by the
        schedule: one scan and one block merge a block, the other merges
        hierarchical."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch.core.partition import next_pow2

        d, m = MESH["d"], qv.shape[0]
        codes, scales, err, qnorm, base = blocks[0]
        args = ops.int8_shard_operands(qv, codes, scales, err, qnorm, r)
        bm, bn = args[7], args[8]
        splits = K.int8_scan_config(args[0].shape[0] // bm, -(-args[1].shape[0] // bn), bm,
                                    self.dev)[0]
        sv, si, _ = K.knn_int8_scan(*args, True, splits)
        pv, pi, _ = K.knn_int8_scan_plain(*args, True, splits)
        hmax = float(args[5][torch.isfinite(args[5])].max())
        ok, err_scan, _ = self._close(sv[:m], si[:m], pv[:m], pi[:m],
                                      TOL_REL * (args[2][:m, None, None] + hmax))
        rows = int(codes.shape[0])
        steps = launches["knn_int8_scan"]
        scan = self._kernel_entry(
            steps, lambda: K.knn_int8_scan(*args, True, splits),
            lambda: K.knn_int8_scan_plain(*args, True, splits), None, None,
            (rows * d + rows * 12 + m * d * 4 + m * (r + 1) * 8,
             m * rows * (2 * d + INT8_EPILOGUE_OPS)), err_scan)

        def fresh():
            return (torch.full((m, r + 1), torch.inf, device=self.dev),
                    torch.full((m, r + 1), -1, dtype=torch.int32, device=self.dev))

        lb, li = fresh()
        hv, hi = self._captured_merge(lambda merge: ops.merge_shard(
            lb, li, sv[:m], si[:m], base, merge=merge))
        block_merge, exact = self._merge_entry(steps, hv, hi)
        ok &= exact
        shapes = [{"shape": f"{label}/block", "splits": splits, "blocks": [bm, bn],
                   "operands": f"({m} x {rows} x {d}, q_len {args[6]}, S={splits}), merge "
                               f"{tuple(hv.shape)}",
                   "kernels": {"knn_int8_scan": scan, "knn_merge": block_merge}}]
        queues = [fresh() for _ in range(n_pos)]
        for i, (c, s, e, qn, b0) in enumerate(blocks):
            p = i % n_pos
            queues[p] = ops.knn_int8_shard(*queues[p], qv, c, s, e, qn, b0, r)
        w = next_pow2(r + 1)
        hv = torch.stack([torch.cat([v, v.new_full((m, w - r - 1), torch.inf)], 1)
                          for v, _ in queues[:group]], 1)
        hi = torch.stack([torch.cat([i, i.new_full((m, w - r - 1), -1)], 1)
                          for _, i in queues[:group]], 1)
        hier, exact = self._merge_entry(launches["knn_merge"] - steps, hv, hi)
        ok &= exact
        shapes.append({"shape": f"{label}/hier", "operands": f"{tuple(hv.shape)}",
                       "kernels": {"knn_merge": hier}})
        self._log_shapes(label, shapes)
        if not ok:
            raise AssertionError(f"{label}: a mesh kernel disagrees with its plain version")
        return shapes

    def _mesh_replay(self, store, single, k, chunk, parts) -> bool:
        """Router.create(devices=[...] * P) on the phase's store behind the
        AdaptiveScheduler: a bursty replay under the adaptive policy (int8
        hook on) and the throughput policy (off). Every served answer is
        bit-identical, by rid, to the single-device search of all the
        queries at once (f32 dispatches, whatever their batch) or to
        knn_exact_direct (int8 dispatches); every dispatch launched
        its plan's schedule on the one-axis mesh; the three mesh plans were
        reached; the scheduler sums bytes_per_device over P devices."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch import SearchRequest
        from repro_torch.api import Router
        from repro_torch.serving import AdaptiveScheduler, bursty_requests

        cfg = MESH["replay"]
        n_pos = math.prod(MESH["shape"])
        router = Router()
        eng = router.create("mesh", store=store, k=k, backend="cuda",
                            devices=[self.first_device] * n_pos)
        g = torch.Generator(device=self.dev).manual_seed(41)
        pick = torch.randint(0, MESH["n"], (cfg["queries"],), generator=g, device=self.dev)
        qr = (single._ds.vectors[pick, : MESH["d"]]
              + 0.3 * torch.randn(cfg["queries"], MESH["d"], generator=g, device=self.dev))
        want = single.search(SearchRequest(queries=qr, k=k, mode_hint="fqsd")).topk
        want8 = ops.knn_exact_direct(single._pad_queries(qr), single._ds.vectors,
                                     single._ds.norms, k, chunk)
        sched_launch = {
            "fdsq": {"knn_scan": n_pos * parts, "knn_merge": n_pos + 1},
            "fqsd": {"knn_scan": n_pos * n_pos * parts, "knn_merge": n_pos * n_pos},
            "fqsd-int8": {"knn_int8_scan": n_pos, "knn_merge": n_pos + 1}}

        class Counted(AdaptiveScheduler):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.log = []

            def _search(self, request):
                K.reset_launch_counts()
                res = super()._search(request)
                label = "fqsd-int8" if request.tier == "int8" else request.mode_hint
                self.log.append((label, int(request.queries.shape[0]), dict(K.LAUNCHES)))
                return res

        ok, executors = True, set()
        qnp = qr.cpu().numpy()
        for policy, depth in (("adaptive", cfg["int8_min_depth"]), ("throughput", None)):
            sched = Counted(policy=policy, int8_min_depth=depth, router=router,
                            collection="mesh")
            t0 = time.perf_counter()
            served = {r.rid: r for r in sched.serve(bursty_requests(qnp, cfg["burst_size"],
                                                                     cfg["trickle"]))}
            wall = time.perf_counter() - t0
            st = sched.stats()
            bad_a = []
            for rid, r in served.items():
                sv, si = r.topk.scores.to(self.dev), r.topk.indices.to(self.dev)
                ref = want8 if r.tier == "int8" else want
                if not (torch.equal(sv, ref.scores[rid]) and torch.equal(si, ref.indices[rid])):
                    bad_a.append(rid)
            bad_b = [(lab, rows, l) for lab, rows, l in sched.log
                     if any(l[name] != sched_launch[lab].get(name, 0) for name in l)]
            for plan in st["per_plan"].values():
                executors.update(plan["executors"])
            good = (len(served) == cfg["queries"] and not bad_a and not bad_b
                    and len(st.get("bytes_per_device", [0] * n_pos)) == n_pos)
            per_plan = {label: (p["count"], round(p["p50_ms"], 3), p["executors"])
                        for label, p in st["per_plan"].items()}
            log(f"mesh replay {policy} int8_min_depth={depth}: {len(served)} served in "
                f"{wall:.3f} s, {len(sched.log)} dispatches, per plan (count, p50 ms, "
                f"executors) {per_plan}; answers by rid (f32 bit-identical to fdsq-cuda, "
                f"int8 bit-identical to knn_exact_direct): {not bad_a} {bad_a[:4]}; launches of each dispatch "
                f"= its plan's schedule: {not bad_b} {bad_b[:2]}; bytes_per_device "
                f"{st.get('bytes_per_device')}; phase_ms {st.get('phase_ms')} ok={good} "
                f"[{self.card}]")
            ok &= good
        devices = router.stats()["collections"]["mesh"]["devices"]
        reached = {"fdsq-sharded", "fqsd-sharded", "fdsq-sharded-int8"} <= executors
        log(f"mesh replay: executors reached {sorted(executors)} (all three mesh plans="
            f"{reached}); Router devices {devices}")
        del eng, router
        return ok and reached and devices == [self.first_device] * n_pos

    def _mesh_mutate(self, meng, single, q, k, n, d, reqs, req8, base) -> bool:
        """(e) MESH["upserts"] rows upserted, the nearest rows of
        MESH["deletes"] queries deleted, then a filter mask: every mesh
        search equals a fresh single-device fit on the live rows (f32 bit
        for bit to its fdsq-cuda search, int8 to knn_exact_direct),
        with no new executable-cache miss; (c) each f32 search adds one
        knn_scan and one knn_merge a delta shard (the ring: a delta shard
        and query block), the int8 one none (its delta rows merge in the
        direct form)."""
        torch, ops = self.torch, self.ops
        from repro_torch import ExactKNN, SearchRequest
        from repro_torch.core.executors import cache_info
        from repro_torch.core.planner import largest_divisor_at_most

        n_up, n_del = MESH["upserts"], MESH["deletes"]
        g = torch.Generator(device=self.dev).manual_seed(43)
        u = q[:n_up] + 1e-3 * torch.randn(n_up, d, generator=g, device=self.dev)
        first = reqs[f"mesh_fdsq_m{MESH['m']}_k{k}"]
        dead = torch.unique(meng.search(first).topk.indices[-n_del:, 0].to(torch.int64))
        n_ids = meng.n_ids + n_up
        keep = torch.ones(n_ids, dtype=torch.bool, device=self.dev)
        keep[dead] = False
        mask = torch.ones(n_ids, dtype=torch.bool, device=self.dev)
        mask[meng.search(first).topk.indices[:, 1].to(torch.int64)] = False
        masked = {False: torch.nonzero(keep).reshape(-1),
                  True: torch.nonzero(keep & mask).reshape(-1)}
        rows = torch.cat([single._ds.vectors[:n, :d], u])
        want = {}
        for use_mask, live in masked.items():
            fresh = ExactKNN(k=k, backend="cuda", device=self.dev).fit(rows[live])
            for label, req in reqs.items():
                want[label, use_mask] = fresh.search(req).topk
            want["int8", use_mask] = ops.knn_exact_direct(
                fresh._pad_queries(q), fresh._ds.vectors, fresh._ds.norms, k,
                largest_divisor_at_most(fresh._ds.vectors.shape[0], 8192))
            del fresh
            torch.cuda.empty_cache()
        del rows
        misses = cache_info()["misses"]
        ids = meng.upsert(u)
        meng.delete(dead.cpu().numpy())
        n_delta = len(meng._delta_dev)
        ok = bool((torch.as_tensor(ids) == torch.arange(n_ids - n_up, n_ids)).all())
        extra = {label: n_delta * (MESH["shape"][0] if req.mode_hint == "fqsd" else 1)
                 for label, req in reqs.items()}
        extra["int8"] = 0
        for use_mask, live in masked.items():
            fm = mask.cpu().numpy() if use_mask else None
            for label, req in list(reqs.items()) + [("int8", req8)]:
                r = SearchRequest(queries=req.queries, k=k, mode_hint=req.mode_hint,
                                  tier=req.tier, filter_mask=fm)
                got, launches = self._counted(lambda: meng.search(r))
                same = self._same_as_fresh(got.topk, want[label, use_mask], live)
                want_l = {name: c + (extra[label] if name in ("knn_scan", "knn_merge") else 0)
                          for name, c in base[label].items()}
                want_l.setdefault("knn_scan", extra[label])
                good_c = all(launches[name] == want_l.get(name, 0) for name in launches)
                ok &= same and good_c
                log(f"mesh mutate {label} mask={use_mask}: executor={got.plan.executor} "
                    f"(c) launches={launches} schedule={want_l} ok={good_c}; delta shards="
                    f"{n_delta}; (e) bit-identical to the fresh fit on the live rows={same}")
        added = cache_info()["misses"] - misses
        log(f"mesh mutate: {n_up} upserted, {dead.numel()} deleted, mask of "
            f"{int((~mask).sum())} ids; executable-cache misses added {added} (gate: 0); "
            f"ok={ok and added == 0}")
        return ok and added == 0

    # ------------------------------------------------------ phase 14: lm
    def phase_lm(self) -> bool:
        """LM decode serving at minicpm-2b's full width and depth, weights
        drawn on the card from a seed; then the MoE arch cut to 2 layers."""
        torch = self.torch
        import dataclasses

        from repro_torch.configs import get_config

        ok = self._lm_cli()
        cfg = get_config(LM["arch"]).model
        p = self._lm_init(cfg)
        ok &= self._lm_decode_vs_apply(cfg.name, p, cfg)
        ok &= self._lm_card_vs_cpu(p, cfg)
        ok &= self._lm_flash(p, cfg)
        ok &= self._lm_server(cfg.name, p, cfg, LM["server"])
        del p
        gc.collect()
        torch.cuda.empty_cache()
        moe = LM["moe"]
        full = get_config(moe["arch"]).model
        mcfg = dataclasses.replace(full, n_layers=moe["layers"])
        pm = self._lm_init(mcfg, f" (cut to {moe['layers']} of {full.n_layers} layers)")
        # (b) compares decode with the forward where neither drops an
        # assignment: a capacity factor of E / top_k gives every expert room
        # for every token
        no_drop = dataclasses.replace(mcfg, capacity_factor=mcfg.n_experts / mcfg.expert_top_k)
        ok &= self._lm_decode_vs_apply(f"{mcfg.name} (capacity factor {no_drop.capacity_factor})",
                                       pm, no_drop)
        ok &= self._lm_server(f"{mcfg.name} (2 layers)", pm, mcfg, moe["server"])
        del pm
        gc.collect()
        torch.cuda.empty_cache()
        return ok

    def _lm_cli(self) -> bool:
        """(a) python -m repro_torch.launch.serve --mode lm --arch ... on the card."""
        import os

        import repro_torch

        env = dict(os.environ, PYTHONPATH=str(Path(repro_torch.__file__).resolve().parents[1]))
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm", "--arch",
               LM["arch"]]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=LM["cli_timeout_s"])
        out = run.stdout.strip().splitlines()
        line = out[-1] if out else ""
        ok = run.returncode == 0 and bool(re.fullmatch(
            r"LM decode: 100 seqs, 544 tokens in \S+s \(\S+ tok/s, continuous batching over "
            r"4 slots\)", line))
        log(f"lm (a) {' '.join(cmd[1:])}: exit {run.returncode} in "
            f"{time.perf_counter() - t0:.1f} s: {line!r} (the reference's line: 100 seqs, 544 "
            f"tokens) ok={ok} [{self.card}]")
        if not ok:
            log(run.stderr[-4000:])
        return ok

    def _lm_init(self, cfg, cut: str = ""):
        """The LM's random weights, drawn on the card from LM["seed"]."""
        torch = self.torch
        from repro_torch.models import transformer as T

        t0 = time.perf_counter()
        p = T.init(torch.Generator(device=self.dev).manual_seed(LM["seed"]), cfg, self.dev)
        self.sync()
        n = sum(t.numel() for t in p.parameters())
        nbytes = sum(t.numel() * t.element_size() for t in p.parameters())
        log(f"lm: {cfg.name}{cut}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, experts {cfg.n_experts} top "
            f"{cfg.expert_top_k}, V_padded {cfg.vocab_padded}, {cfg.dtype}: {n:,} parameters "
            f"(params_count {cfg.params_count():,}), {nbytes / 1e9:.3f} GB, drawn on the card "
            f"from seed {LM['seed']} in {time.perf_counter() - t0:.1f} s")
        return p

    def _logits_err(self, got, want, keep=None) -> float:
        """Max |got - want| over the finite logits (of the positions `keep`
        marks); inf if the -inf (pad) masks differ."""
        torch = self.torch
        if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
            return math.inf
        fin = torch.isfinite(want)
        if keep is not None:
            fin &= keep[..., None]
        return float((got[fin] - want[fin]).abs().max()) if fin.any() else math.inf

    def _greedy(self, got, want, tol, keep) -> tuple[bool, int, int, int]:
        """Greedy tokens of got against want's at the positions `keep` marks,
        wherever want's top-2 margin exceeds 2·tol (two logits each off by
        at most tol cannot swap there): (all such equal, positions, such
        positions, equal tokens)."""
        top = want.topk(2, dim=-1).values
        sure = ((top[..., 0] - top[..., 1]) > 2 * tol) & keep
        same = (got.argmax(-1) == want.argmax(-1)) & keep
        return (bool((same | ~sure).all()), int(keep.sum()), int(sure.sum()), int(same.sum()))

    @contextlib.contextmanager
    def _routes(self):
        """Record every _moe_dense call's top-k expert set (sorted), the gap
        between its k-th and (k+1)-th router probability and its router
        probabilities, from the same ops on the same operands as the call's
        own routing."""
        torch = self.torch
        from repro_torch.models import layers as L

        calls, orig = [], L._moe_dense

        def traced(params, x, *, n_experts, top_k, capacity_factor):
            probs = torch.softmax(
                x.reshape(-1, x.shape[-1]).to(torch.float32) @ params["router"], dim=-1)
            vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
            calls.append((idx[:, :top_k].sort(-1).values, vals[:, top_k - 1] - vals[:, top_k],
                          probs))
            return orig(params, x, n_experts=n_experts, top_k=top_k,
                        capacity_factor=capacity_factor)

        L._moe_dense = traced
        try:
            yield calls
        finally:
            L._moe_dense = orig

    def _route_flips(self, calls, ref, b, n_layers, prefix=0):
        """Where a run's top-k expert sets differ from apply's (`ref`): the
        flipped (b, position) mask, and at each flip apply's k-th gap and the
        largest change of a router probability between the two runs. `calls`
        are one run's _moe_dense calls: a prefill of `prefix` positions (one
        call a layer), then one call a layer for each decoded position."""
        torch = self.torch
        sets = [[] for _ in range(n_layers)]
        probs = [[] for _ in range(n_layers)]
        if prefix:
            for layer, (idx, _, pr) in enumerate(calls[:n_layers]):
                sets[layer].append(idx.reshape(b, prefix, -1))
                probs[layer].append(pr.reshape(b, prefix, -1))
            calls = calls[n_layers:]
        for i, (idx, _, pr) in enumerate(calls):
            sets[i % n_layers].append(idx.reshape(b, 1, -1))
            probs[i % n_layers].append(pr.reshape(b, 1, -1))
        flips = torch.zeros(ref[0][1].reshape(b, -1).shape, dtype=torch.bool, device=self.dev)
        gaps, moves = [], []
        for layer in range(n_layers):
            got = torch.cat(sets[layer], 1)
            n = got.shape[1]
            here = (got != ref[layer][0].reshape(b, -1, got.shape[-1])[:, :n]).any(-1)
            flips[:, :n] |= here
            gaps.append(ref[layer][1].reshape(b, -1)[:, :n][here])
            want = ref[layer][2].reshape(b, -1, ref[layer][2].shape[-1])
            moves.append((torch.cat(probs[layer], 1) - want[:, :n]).abs().amax(-1)[here])
        return flips, torch.cat(gaps), torch.cat(moves)

    def _lm_decode_vs_apply(self, label, p, cfg) -> bool:
        """(b) seqs x positions tokens decoded one at a time from an empty
        cache, and after a prefill, against apply's logits at each position.

        MoE: a token's top-k experts are a discrete choice. At another batch
        shape the router's input carries other bf16 roundings (and its f32
        product sums in another order), which can order the k-th and
        (k+1)-th probabilities the other way round where they are that
        close. Such a token, and every later position of its sequence
        (which attends to it), is left out of the logit comparison; each
        flip must sit at a gap below LM_ROUTE_GAP, and at least half the
        positions must be compared."""
        torch = self.torch
        from repro_torch.models import transformer as T

        b, s, s0 = LM["seqs"], LM["positions"], LM["prefill"]
        g = torch.Generator(device=self.dev).manual_seed(LM["seed"] + 1)
        tok = torch.randint(0, cfg.vocab, (b, s), generator=g, device=self.dev)
        with self._routes() as ref:
            full, _ = T.apply(p, cfg, tok)
        cache = T.init_cache(cfg, b, s, device=self.dev)
        dec = []
        with self._routes() as dec_routes:
            for pos in range(s):
                logits, cache = T.decode_step(p, cfg, cache, tok[:, pos:pos + 1])
                dec.append(logits)
        dec = torch.stack(dec, 1)
        with self._routes() as pre_routes:
            last, cache = T.prefill(p, cfg, tok[:, :s0], max_len=s)
            pre = [last]
            for pos in range(s0, s - 1):
                logits, cache = T.decode_step(p, cfg, cache, tok[:, pos:pos + 1])
                pre.append(logits)
        pre = torch.stack(pre, 1)  # positions s0-1 .. s-2
        want_pre = full[:, s0 - 1:s - 1]
        keep_dec = torch.ones((b, s), dtype=torch.bool, device=self.dev)
        keep_pre = torch.ones((b, s - s0), dtype=torch.bool, device=self.dev)
        routing = ""
        gaps_ok = True
        if cfg.is_moe:
            fd, gd, md = self._route_flips(dec_routes, ref, b, cfg.n_layers)
            fp, gp, mp = self._route_flips(pre_routes, ref, b, cfg.n_layers, prefix=s0)
            fp = fp[:, :s - 1]
            keep_dec = ~(fd.cumsum(1) > 0)
            keep_pre = ~(fp.cumsum(1) > 0)[:, s0 - 1:]
            gaps, moves = torch.cat([gd, gp]), torch.cat([md, mp])
            gaps_ok = bool((gaps < LM_ROUTE_GAP).all())
            routing = (f"; top-{cfg.expert_top_k} sets differing from apply's: decode "
                       f"{int(fd.sum())}, prefill+decode {int(fp.sum())} of {b * s} (token, "
                       f"any layer) at k-th gaps {[f'{v:.2e}' for v in gaps.tolist()]} "
                       f"(gate < {LM_ROUTE_GAP}), the largest router probability moving by "
                       f"{[f'{v:.2e}' for v in moves.tolist()]} there; positions compared "
                       f"{int(keep_dec.sum())} / {int(keep_pre.sum())}")
        # a cache one position off: a wrong slot must move the logits past the tolerance
        _, off = T.prefill(p, cfg, tok[:, :s0], max_len=s)
        shifted, _ = T.decode_step(p, cfg, dict(off, len=s0 + 1), tok[:, s0:s0 + 1])
        shift_err = self._logits_err(shifted, full[:, s0])
        err_dec = self._logits_err(dec, full, keep_dec)
        err_pre = self._logits_err(pre, want_pre, keep_pre)
        g_dec = self._greedy(dec, full, LM_BF16_TOL, keep_dec)
        g_pre = self._greedy(pre, want_pre, LM_BF16_TOL, keep_pre)
        pads = int((dec.argmax(-1) >= cfg.vocab).sum())
        enough = keep_dec.sum() * 2 >= keep_dec.numel() and keep_pre.sum() * 2 >= keep_pre.numel()
        ok = (err_dec <= LM_BF16_TOL and err_pre <= LM_BF16_TOL and g_dec[0] and g_pre[0]
              and pads == 0 and shift_err > LM_BF16_TOL and gaps_ok and bool(enough))
        log(f"lm (b) {label}: {b} x {s} tokens, decode_step from an empty cache against apply: "
            f"max |dlogit| {err_dec:.6f}; prefill of {s0} then decode_step: {err_pre:.6f} "
            f"(tolerance {LM_BF16_TOL}); greedy tokens (positions, with top-2 margin > 2 tol, "
            f"equal): decode {g_dec[1:]}, prefill+decode {g_pre[1:]}; pad ids {pads}; a cache "
            f"one position off moves the logits by {shift_err:.4f} (gate: > the tolerance)"
            f"{routing}; ok={ok} [{self.card}]")
        return ok

    def _lm_card_vs_cpu(self, p, cfg) -> bool:
        """(c) the same weights cut to f32_layers layers, cast to f32: a
        prefill and one decode_step on the card against the host's CPU."""
        torch = self.torch
        import copy
        import dataclasses

        from repro_torch.models import transformer as T

        n, s0 = LM["f32_layers"], LM["f32_prompt"]
        c32 = dataclasses.replace(cfg, n_layers=n, dtype=torch.float32)

        def cut(device):
            return T.Transformer(c32, p.embed.to(device, torch.float32),
                                 [copy.deepcopy(blk).to(device, torch.float32)
                                  for blk in p.layers[:n]],
                                 copy.deepcopy(p.final_norm).to(device),
                                 p.head.to(device, torch.float32))

        g = torch.Generator(device=self.dev).manual_seed(LM["seed"] + 2)
        tok = torch.randint(0, cfg.vocab, (LM["seqs"], s0 + 1), generator=g, device=self.dev)
        out = []
        for device in (self.dev, torch.device("cpu")):
            m = cut(device)
            t = tok.to(device)
            last, cache = T.prefill(m, c32, t[:, :s0], max_len=s0 + 1)
            step, _ = T.decode_step(m, c32, cache, t[:, s0:])
            out.append((last.cpu(), step.cpu()))
            del m, cache
        errs = [self._logits_err(a, b) for a, b in zip(*out)]
        ok = max(errs) <= LM_F32_TOL and torch.backends.cuda.matmul.allow_tf32 is False
        log(f"lm (c) {n} of {cfg.n_layers} layers in f32, {LM['seqs']} x {s0} tokens: card "
            f"against the host CPU: prefill max |dlogit| {errs[0]:.3e}, decode_step "
            f"{errs[1]:.3e} (tolerance {LM_F32_TOL}; TF32 off) ok={ok} [{self.card}]")
        return ok

    def _lm_flash(self, p, cfg) -> bool:
        """(d) one flash_prompt-token prefill through _flash_blockwise, and
        with flash_threshold raised so _sdpa_full runs: last-token logits."""
        torch = self.torch
        import dataclasses

        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T

        s = LM["flash_prompt"]
        if not (s > cfg.flash_threshold and s % cfg.q_block == 0 and s % cfg.kv_block == 0):
            raise ValueError(f"{s} tokens do not take the flash path of {cfg}")
        full_cfg = dataclasses.replace(cfg, flash_threshold=s)
        g = torch.Generator(device=self.dev).manual_seed(LM["seed"] + 3)
        tok = torch.randint(0, cfg.vocab, (1, s), generator=g, device=self.dev)
        calls = {"_flash_blockwise": 0, "_sdpa_full": 0}
        saved = {name: getattr(L, name) for name in calls}

        def counted(name):
            def fn(*a, **kw):
                calls[name] += 1
                return saved[name](*a, **kw)
            return fn

        res = {}
        try:
            for name in calls:
                setattr(L, name, counted(name))
            for label, c in (("flash", cfg), ("full", full_cfg)):
                before = dict(calls)
                times = []
                for _ in range(2):
                    self.sync()
                    t0 = time.perf_counter()
                    logits, cache = T.prefill(p, c, tok)
                    self.sync()
                    times.append((time.perf_counter() - t0) * 1e3)
                res[label] = (logits, times, {k: (calls[k] - before[k]) // 2 for k in calls})
                del cache
        finally:
            for name, fn in saved.items():
                setattr(L, name, fn)
        err = self._logits_err(res["flash"][0], res["full"][0])
        paths = (res["flash"][2] == {"_flash_blockwise": cfg.n_layers, "_sdpa_full": 0}
                 and res["full"][2] == {"_flash_blockwise": 0, "_sdpa_full": cfg.n_layers})
        same_top = bool((res["flash"][0].argmax(-1) == res["full"][0].argmax(-1)).all())
        ok = err <= LM_BF16_TOL and paths
        log(f"lm (d) prefill of {s} tokens, {cfg.n_layers} layers: blockwise flash (q_block "
            f"{cfg.q_block}, kv_block {cfg.kv_block}) {res['flash'][1][1]:.1f} ms against "
            f"_sdpa_full {res['full'][1][1]:.1f} ms (host clock, synchronised, second call; "
            f"first {res['flash'][1][0]:.1f} / {res['full'][1][0]:.1f}); calls a prefill "
            f"{res['flash'][2]} / {res['full'][2]}; last-token max |dlogit| {err:.6f} "
            f"(tolerance {LM_BF16_TOL}), same argmax {same_top}; ok={ok} [{self.card}]")
        return ok

    def _lm_server(self, label, p, cfg, sv) -> bool:
        """(e) DecodeServer: requests of tokens each over slots, run twice;
        ms a step, tokens/s and the step's bytes bound; a traced window."""
        torch = self.torch
        from repro_torch.serving import DecodeServer

        runs = []
        for _ in range(2):
            srv = DecodeServer(p, cfg, n_slots=sv["slots"], max_len=sv["max_len"])
            for rid in range(sv["requests"]):
                srv.submit(rid, prompt_token=(rid % (cfg.vocab - 1)) + 1, n_tokens=sv["tokens"])
            steps = []
            t0 = time.perf_counter()
            while srv.queue or any(srv.slots):
                t1 = time.perf_counter()
                srv.step()  # ends in the copy of the sampled ids to the host
                steps.append((time.perf_counter() - t1) * 1e3)
            wall = time.perf_counter() - t0
            runs.append(({s.rid: s.tokens for s in srv.completed}, steps, wall))
        done = runs[0][0]
        complete = (sorted(done) == list(range(sv["requests"]))
                    and all(len(t) == 1 + sv["tokens"] for t in done.values()))
        pads = sum(1 for t in done.values() for x in t[1:] if not 0 <= x < cfg.vocab)
        same = runs[0][0] == runs[1][0]
        ok = complete and pads == 0 and same
        # bytes a step must move: every weight but the embedding table once
        # (its slots rows gathered), the whole K/V cache read (the decode
        # attends over all max_len positions, masked), one position a layer
        # written, the f32 logits written
        params = sum(t.numel() * t.element_size() for t in p.parameters())
        emb = p.embed.numel() * p.embed.element_size()
        cache = srv.cache["k"].numel() * srv.cache["k"].element_size() * 2
        step_bytes = (params - emb + sv["slots"] * cfg.d_model * p.embed.element_size() + cache
                      + cache // sv["max_len"] + sv["slots"] * cfg.vocab_padded * 4)
        bound = step_bytes / self.bw * 1e3
        n_tok = sv["requests"] * sv["tokens"]
        for i, (_, steps, wall) in enumerate(runs):
            log(f"lm (e) {label} DecodeServer run {i + 1}: {sv['slots']} slots, max_len "
                f"{sv['max_len']}, {sv['requests']} requests x {sv['tokens']} tokens: "
                f"{len(steps)} steps in {wall:.3f} s, {statistics.median(steps):.3f} ms a step "
                f"(median; min {min(steps):.3f}, max {max(steps):.3f}; first {steps[0]:.3f}), "
                f"{n_tok / wall:.1f} tokens/s; bytes bound {step_bytes / 1e9:.3f} GB a step "
                f"(weights {(params - emb) / 1e9:.3f} + cache {cache / 1e9:.3f}) / "
                f"{self.bw / 1e12:.2f} TB/s = {bound:.3f} ms [{self.card}]")
        log(f"lm (e) {label}: every request complete with prompt + {sv['tokens']} tokens "
            f"{complete}, pad ids {pads}, second run the same tokens {same}; ok={ok}")
        self._lm_profile(label, p, cfg, sv)
        return ok

    @staticmethod
    def _device_ms(prof, n: int) -> tuple[float, float, int, dict]:
        """A trace's device time: GEMM ms, other kernels' and copies' ms,
        kernels launched, and (launches, ms a step) by name over n steps."""
        from torch.autograd import DeviceType

        gemm = other = 0.0
        kernels = 0
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            row = by_name.setdefault(e.name[:60], [0, 0.0])
            row[0] += 1
            row[1] += us / 1e3 / n
            if "Memcpy" in e.name or "Memset" in e.name:
                other += us / 1e3
                continue
            kernels += 1
            if any(w in e.name.lower() for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
                gemm += us / 1e3
            else:
                other += us / 1e3
        return gemm, other, kernels, by_name

    def _lm_profile(self, label, p, cfg, sv) -> None:
        """A traced window of steady DecodeServer steps: device ms by kind
        (GEMMs, others), kernels a step, and the device's idle share."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.serving import DecodeServer

        srv = DecodeServer(p, cfg, n_slots=sv["slots"], max_len=sv["max_len"])
        for rid in range(sv["slots"]):
            srv.submit(rid, prompt_token=rid + 1, n_tokens=sv["tokens"])
        for _ in range(2):
            srv.step()
        n = LM["profile_steps"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                srv.step()
            wall = (time.perf_counter() - t0) * 1e3
        gemm, other, kernels, by_name = self._device_ms(prof, n)
        busy = gemm + other
        log(f"lm (e) {label} traced: {n} steps in {wall:.3f} ms ({wall / n:.3f} ms a step under "
            f"the profiler); device busy {busy / n:.3f} ms a step (GEMM/GEMV {gemm / n:.3f}, "
            f"other kernels and copies {other / n:.3f}); {kernels / n:.0f} kernels a step; "
            f"device idle share {1 - busy / wall:.3f} [{self.card}]")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        log(f"lm (e) {label} traced, device ms a step by kernel (launches in {n} steps): "
            + "; ".join(f"{name} {ms:.3f} ({cnt})" for name, (cnt, ms) in top))

    # --------------------------------------------------- phase 15: train
    def phase_train(self) -> bool:
        """LM training at minicpm-2b's full width: the CLI, card against CPU
        at 2 layers, a checkpoint of that state, the whole model, recovery."""
        ok = True
        for step in (self._train_cli, self._train_cut, self._train_full, self._train_recovery):
            t0 = time.perf_counter()
            ok &= step()
            log(f"train: {step.__name__} {time.perf_counter() - t0:.1f} s")
        return ok

    def _train_cli(self) -> bool:
        """(a) python -m repro_torch.launch.train --smoke with an injected
        failure, in a subprocess on the card."""
        import os
        import shutil

        import repro_torch

        directory = ROOT / "build" / "train_ckpt"
        shutil.rmtree(directory, ignore_errors=True)  # the manager resumes what it finds
        env = dict(os.environ, PYTHONPATH=str(Path(repro_torch.__file__).resolve().parents[1]))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN["arch"],
               "--smoke", "--steps", str(TRAIN["cli_steps"]), "--ckpt-dir",
               str(directory.relative_to(ROOT)), "--inject-failure", str(TRAIN["cli_failure"])]
        t0 = time.perf_counter()
        try:
            run = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                                 timeout=TRAIN["cli_timeout_s"])
        finally:
            written = sorted(p.name for p in directory.glob("step_*"))
            shutil.rmtree(directory, ignore_errors=True)
        out = run.stdout.strip().splitlines()
        report = next((line for line in out if line.startswith("arch=")), "")
        traj = next((line for line in out if line.startswith("loss trajectory: [")), "")
        ok = (run.returncode == 0 and traj != "" and bool(re.fullmatch(
            rf"arch={TRAIN['arch']} steps={TRAIN['cli_steps']} restarts=1 stragglers=\d+ "
            r"wall=\S+s", report)) and not directory.exists())
        log(f"train (a) {' '.join(cmd[1:])}: exit {run.returncode} in "
            f"{time.perf_counter() - t0:.1f} s: {report!r}, {traj!r}; checkpoints written "
            f"{written}, directory removed; ok={ok} [{self.card}]")
        if not ok:
            log(run.stderr[-4000:])
        return ok

    def _tree_err(self, got, want) -> tuple[float, str]:
        """The largest |got - want| over its leaf's largest |want|, over two
        trees of one structure (dicts, lists, tuples of tensors), and the
        leaf's path."""
        def paths(tree, at=""):
            if isinstance(tree, dict):
                return [p for k in sorted(tree) for p in paths(tree[k], f"{at}.{k}")]
            if isinstance(tree, (list, tuple)):
                return [p for i, x in enumerate(tree) for p in paths(x, f"{at}[{i}]")]
            return [(at.lstrip(".") or ".", tree)]

        worst, where = 0.0, ""
        for (name, g), (_, w) in zip(paths(got), paths(want), strict=True):
            g = g.detach().to(w.device, self.torch.float32)
            w = w.detach().to(self.torch.float32)
            err = float((g - w).abs().max()) / (float(w.abs().max()) or 1.0)
            if err > worst or not math.isfinite(err):
                worst, where = err, name
        return worst, where

    def _train_cut(self) -> bool:
        """(b) the full width cut to TRAIN["cut_layers"] layers in f32: loss,
        gradients and one AdamW step on the card against the CPU; (d) that
        state through an async checkpoint and back into a fresh template."""
        torch = self.torch
        import copy
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, apply_updates

        full = get_config(TRAIN["arch"]).model
        cfg = dataclasses.replace(full, n_layers=TRAIN["cut_layers"], dtype=torch.float32)
        p = self._lm_init(cfg, f" (cut to {cfg.n_layers} of {full.n_layers} layers, f32)")
        host = copy.deepcopy(p).to("cpu")
        p.requires_grad_(True)
        host.requires_grad_(True)
        b, s = TRAIN["cut_batch"]
        g = torch.Generator(device=self.dev).manual_seed(TRAIN["seed"] + 4)
        tok = torch.randint(0, cfg.vocab, (b, s + 1), generator=g, device=self.dev)
        t0 = time.perf_counter()
        (loss, _), grads = T.value_and_grad(p, cfg, {"tokens": tok})
        self.sync()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        (hloss, _), hgrads = T.value_and_grad(host, cfg, {"tokens": tok.cpu()})
        t_cpu = time.perf_counter() - t0
        loss_err = abs(float(loss) - float(hloss)) / abs(float(hloss))
        grad_err, grad_at = self._tree_err(grads, hgrads)
        opt_cfg = AdamWConfig(lr=TRAIN["lr"], moment_dtype="f32")
        opt, hopt = adamw_init(p, opt_cfg), adamw_init(host, opt_cfg)
        u, opt = adamw_update({n: v.to(self.dev) for n, v in hgrads.items()}, opt, p, opt_cfg)
        hu, hopt = adamw_update(hgrads, hopt, host, opt_cfg)
        upd_err, upd_at = self._tree_err(u, hu)
        apply_updates(p, u)
        apply_updates(host, hu)
        par_err, par_at = self._tree_err(dict(p.named_parameters()), dict(host.named_parameters()))
        del grads, hgrads, u, hu, host, hopt
        ok = max(loss_err, grad_err, upd_err, par_err) <= TRAIN_TOL
        log(f"train (b) {cfg.name} cut to {cfg.n_layers} layers, f32, {b} x {s} tokens, card "
            f"against the host CPU (TF32 off): loss {float(loss):.6f} / {float(hloss):.6f}, "
            f"relative {loss_err:.3e}; gradients {grad_err:.3e} of their leaf's largest ({grad_at}); "
            f"one AdamW step (lr {TRAIN['lr']}) from the CPU's gradients: updates {upd_err:.3e} "
            f"({upd_at}), params after it {par_err:.3e} ({par_at}) (gate {TRAIN_TOL}); loss and "
            f"backward {t_card * 1e3:.1f} ms on the card (first call), {t_cpu:.1f} s on the CPU; "
            f"ok={ok} [{self.card}]")
        ok &= self._train_checkpoint(cfg, p, opt)
        del p, opt
        gc.collect()
        torch.cuda.empty_cache()
        return ok

    def _train_checkpoint(self, cfg, p, opt) -> bool:
        """(d) (params, f32 moments) saved async from the card and restored
        into a fresh template on the card: bit-equal, write and read GB/s."""
        torch = self.torch
        import shutil

        from repro_torch.checkpoint import ckpt
        from repro_torch.models import transformer as T
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.tree import reference_layout, tree_leaves

        directory = ROOT / "build" / "train_ckpt_card"
        shutil.rmtree(directory, ignore_errors=True)
        try:
            self.sync()
            t0 = time.perf_counter()
            path = ckpt.save_checkpoint(directory, 1, (p, opt), blocking=False)
            t_call = time.perf_counter() - t0
            ckpt.wait_for_pending()
            t_write = time.perf_counter() - t0
            nbytes = sum(f.stat().st_size for f in path.iterdir())
            fresh = T.init(torch.Generator(device=self.dev).manual_seed(TRAIN["seed"] + 9), cfg,
                           self.dev)
            tmpl = (fresh, adamw_init(fresh, AdamWConfig(moment_dtype="f32")))
            self.sync()
            t0 = time.perf_counter()
            got, manifest = ckpt.load_checkpoint(directory, tmpl)
            self.sync()
            t_read = time.perf_counter() - t0
            pairs = list(zip(tree_leaves(reference_layout((p, opt))),
                             tree_leaves(reference_layout(got))))
            same = all(torch.equal(x, y) and y.device.type == self.dev.type
                       for a, b in pairs for x, y in zip(getattr(a, "parts", [a]),
                                                         getattr(b, "parts", [b])))
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        ok = same and manifest["n_leaves"] == len(pairs) and not directory.exists()
        log(f"train (d) checkpoint of the {cfg.n_layers}-layer f32 model and its f32 moments: "
            f"{manifest['n_leaves']} leaves, {nbytes / 1e9:.3f} GB; save call {t_call:.2f} s (the "
            f"copy to the host), written in {t_write:.2f} s ({nbytes / t_write / 1e9:.2f} GB/s), "
            f"read into a fresh template on the card in {t_read:.2f} s ({nbytes / t_read / 1e9:.2f} "
            f"GB/s, warm page cache); bit-equal {same}; files deleted; ok={ok} [{self.card}]")
        return ok

    def _train_full(self) -> bool:
        """(c) the whole model, bf16, remat, f32 moments: the train cell of
        launch.steps on one fixed batch for TRAIN["steps"] steps; ms a
        step, tokens/s, peak memory, one traced step, the bound."""
        torch = self.torch
        import numpy as np
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch import demo, steps
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.roofline.hw import H100_SXM

        arch = get_config(TRAIN["arch"])
        cfg = arch.model
        b, s = TRAIN["batch"]
        full = arch.shape("train_4k")
        cut = ShapeSpec(f"{full.name} cut to a batch of {b}", "train",
                        {"seq_len": s, "global_batch": b})
        if s != full["seq_len"]:
            raise ValueError(f"the sequence of {full.name} is {full['seq_len']}, not {s}")
        cell = steps.build_lm_cell(arch, cut)
        torch.cuda.reset_peak_memory_stats()
        p = self._lm_init(cfg).requires_grad_(True)
        opt = adamw_init(p, AdamWConfig(moment_dtype=arch.train_moment_dtype))
        batch = demo.lm_batch(np.random.default_rng(TRAIN["seed"]), cfg.vocab, cell.inputs[2],
                              self.dev)
        losses, times = [], []
        for _ in range(TRAIN["steps"]):
            self.sync()
            t0 = time.perf_counter()
            p, opt, metrics = cell.fn(p, opt, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(times[1:])
        # device activity only: a step launches ~180,000 kernels, and the
        # host-side op events would cost the trace more than the step
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self.sync()
            t0 = time.perf_counter()
            p, opt, metrics = cell.fn(p, opt, batch)
            losses.append(float(metrics["loss"]))
            wall = (time.perf_counter() - t0) * 1e3
        gemm, other, kernels, by_name = self._device_ms(prof, 1)
        busy = gemm + other
        # the bound: the model's FLOPs (launch.steps' meta: 6 x params x
        # tokens) at the bf16 peak, then the optimizer's bytes (each param,
        # gradient and moment read once, each param and moment written once)
        # at the memory rate
        n = sum(t.numel() for t in p.parameters())
        opt_bytes = sum(t.numel() * (3 * t.element_size() + 4 * (4 if arch.train_moment_dtype
                                                                   == "f32" else 2))
                        for t in p.parameters())
        t_flops = cell.meta["model_flops"] / H100_SXM.peak_flops_bf16 * 1e3
        t_bytes = opt_bytes / self.bw * 1e3
        bound = t_flops + t_bytes
        finite = all(math.isfinite(x) for x in losses)
        ok = finite and losses[TRAIN["steps"] - 1] < losses[0]
        log(f"train (c) {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, remat {cfg.remat}, "
            f"{arch.train_moment_dtype} moments, {n:,} parameters, one batch of {b} x {s} tokens "
            f"(train_4k's sequence; its global batch of {full['global_batch']} cut to {b}): losses "
            f"{[round(x, 4) for x in losses[:TRAIN['steps']]]} (finite {finite}, last below first "
            f"{losses[TRAIN['steps'] - 1] < losses[0]}); step ms {[round(t, 1) for t in times]}, "
            f"{ms:.1f} ms a step (median of steps 2-{TRAIN['steps']}), {b * s / ms * 1e3:.1f} "
            f"tokens/s; peak allocated {peak / 1e9:.2f} GB; bound {bound:.1f} ms = model FLOPs "
            f"{cell.meta['model_flops']:.3e} / {H100_SXM.peak_flops_bf16 / 1e12:.0f} TFLOP/s "
            f"{t_flops:.1f} ms + optimizer {opt_bytes / 1e9:.2f} GB / {self.bw / 1e12:.2f} TB/s "
            f"{t_bytes:.1f} ms ({bound / ms:.3f} of the step); ok={ok} [{self.card}]")
        log(f"train (c) traced step: {wall:.1f} ms under the profiler, {kernels} kernels, device "
            f"busy {busy:.1f} ms (GEMM {gemm:.1f}, other kernels and copies {other:.1f}), device "
            f"idle share {1 - busy / wall:.3f} (against the untraced median step: "
            f"{1 - busy / ms:.3f}) [{self.card}]")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        log("train (c) traced step, device ms by kernel (launches): "
            + "; ".join(f"{name} {ms_:.1f} ({cnt})" for name, (cnt, ms_) in top))
        del p, opt, batch, prof
        gc.collect()
        torch.cuda.empty_cache()
        return ok

    def _train_recovery(self) -> bool:
        """(e) the smoke model's supervised run with failures injected, under
        deterministic algorithms, against a clean run: bit-equal."""
        torch = self.torch
        import os
        import shutil

        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.launch import demo, train
        from repro_torch.runtime.fault import FailureInjector, supervised_train
        from repro_torch.tree import reference_layout, tree_leaves

        arch = get_config(TRAIN["arch"])
        shape = arch.shape("train_4k")
        saved = (torch.are_deterministic_algorithms_enabled(),
                 os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        dirs = [ROOT / "build" / f"train_recovery_{i}" for i in range(2)]
        runs = []
        try:
            # cuBLAS is deterministic only with a fixed workspace
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            torch.use_deterministic_algorithms(True)
            for directory, fail_at in zip(dirs, ((), TRAIN["recovery_fail_at"])):
                shutil.rmtree(directory, ignore_errors=True)
                cell, (p, opt, _) = demo.materialize(arch, shape, smoke=True,
                                                     seed=TRAIN["seed"], device=self.dev)

                def step_fn(state, batch, cell=cell):
                    params, o, metrics = cell.fn(*state, batch)
                    return (params, o), metrics

                state, rep = supervised_train(
                    step_fn, (p, opt), train.build_batches(arch, cell, True, self.dev),
                    TRAIN["recovery_steps"],
                    CheckpointManager(directory, interval=TRAIN["recovery_interval"], keep=2),
                    injector=FailureInjector(fail_at) if fail_at else None)
                runs.append((state, rep))
        finally:
            torch.use_deterministic_algorithms(saved[0])
            if saved[1] is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[1]
            for directory in dirs:
                shutil.rmtree(directory, ignore_errors=True)
        (clean, rep0), (crashy, rep1) = runs
        pairs = list(zip(tree_leaves(reference_layout(clean)), tree_leaves(reference_layout(crashy))))
        same = all(torch.equal(x, y) for a, b in pairs
                   for x, y in zip(getattr(a, "parts", [a]), getattr(b, "parts", [b])))
        ok = (rep0.restarts == 0 and rep1.restarts == len(TRAIN["recovery_fail_at"]) and same
              and rep1.steps_done == TRAIN["recovery_steps"])
        log(f"train (e) {arch.smoke_model.name}, {TRAIN['recovery_steps']} supervised steps, "
            f"checkpoints every {TRAIN['recovery_interval']}, deterministic algorithms: clean run "
            f"restarts {rep0.restarts}, losses {[round(x, 4) for x in rep0.losses]}; failures at "
            f"{TRAIN['recovery_fail_at']}: restarts {rep1.restarts}, {len(rep1.losses)} steps run; "
            f"final params and moments bit-equal ({len(pairs)} leaves) {same}; ok={ok} "
            f"[{self.card}]")
        return ok

    # ------------------------------------------------- phase 16: recsys
    def phase_recsys(self) -> bool:
        """The recommenders: card against CPU at full width with cut tables,
        serving at full size, two-tower retrieval on the kernel, training at
        full size, the examples."""
        ok = True
        for step in (self._recsys_cut, self._recsys_serve, self._recsys_retrieval,
                     self._recsys_train, self._examples_recsys):
            t0 = time.perf_counter()
            ok &= step()
            log(f"recsys: {step.__name__} {time.perf_counter() - t0:.1f} s")
        return ok

    def _to_host(self, tree):
        """A copy of a tree of tensors on the host CPU (trainable leaves stay
        trainable)."""
        from repro_torch.tree import tree_map

        return tree_map(lambda t: t.detach().to("cpu", copy=True).requires_grad_(t.requires_grad),
                        tree)

    def _free(self) -> None:
        gc.collect()
        self.torch.cuda.empty_cache()

    def _recsys_cut(self) -> bool:
        """(a) each config at full width, every table cut to RECSYS["cut_rows"]
        rows, a batch of RECSYS["cut_batch"]: serve_scores, the loss and every
        gradient on the card against the host's CPU."""
        torch = self.torch
        import dataclasses

        import numpy as np

        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch import demo, steps
        from repro_torch.models import recsys as R
        from repro_torch.tree import requires_grad_, tree_leaves

        ok = True
        for arch_id in RECSYS["archs"]:
            arch = get_config(arch_id)
            cfg = dataclasses.replace(arch.model, table_sizes=tuple(
                min(s, RECSYS["cut_rows"]) for s in arch.model.table_sizes))
            b = RECSYS["cut_batch"]
            cell = steps.build_recsys_cell(dataclasses.replace(arch, model=cfg), ShapeSpec(
                f"train_batch cut to {b}", "train", {"batch": b}))
            p = requires_grad_(R.init(torch.Generator(device=self.dev).manual_seed(RECSYS["seed"]),
                                      cfg, self.dev))
            batch = demo.recsys_batch(np.random.default_rng(RECSYS["seed"]), cfg, cell.inputs[2],
                                      self.dev)
            host, hbatch = self._to_host(p), self._to_host(batch)
            (loss, _), grads = R.value_and_grad(p, cfg, batch)
            (hloss, _), hgrads = R.value_and_grad(host, cfg, hbatch)
            scores, hscores = R.serve_scores(p, cfg, batch), R.serve_scores(host, cfg, hbatch)
            loss_err = abs(float(loss) - float(hloss)) / abs(float(hloss))
            grad_err, at = self._tree_err(grads, hgrads)
            serve_err, _ = self._tree_err(scores, hscores)
            finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
            good = finite and max(loss_err, grad_err, serve_err) <= MODEL_TOL
            ok &= good
            log(f"recsys (a) {arch_id} at full width, tables cut to {cfg.table_sizes[:4]}... "
                f"({cfg.padded_rows:,} rows x {cfg.embed_dim}), batch {b}, card against the "
                f"host CPU (TF32 off): loss {float(loss):.6f} / {float(hloss):.6f} relative "
                f"{loss_err:.3e}; gradients {grad_err:.3e} of their leaf's largest ({at}); "
                f"serve_scores {serve_err:.3e} (gate {MODEL_TOL}); ok={good} [{self.card}]")
            del p, host, grads, hgrads, batch, hbatch
            self._free()
        return ok

    @staticmethod
    def _table_bytes(cfg, batch_rows: int) -> int:
        """The embedding rows one forward gathers for ``batch_rows`` examples."""
        per = {"dlrm": cfg.n_sparse * cfg.embed_dim, "two_tower": 2 * cfg.embed_dim,
               "bst": (cfg.seq_len + 1) * cfg.embed_dim,
               "wide_deep": cfg.n_sparse * (cfg.embed_dim + 1)}[cfg.kind]
        return batch_rows * per * 4

    def _recsys_serve(self) -> bool:
        """(b) serve_p99 (batch 512) of each config at full size: ms a call
        (CUDA events, median of RECSYS["serve_calls"]) beside the bytes
        bound of the rows gathered plus the dense weights read."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import demo
        from repro_torch.tree import tree_leaves

        ok = True
        for arch_id in RECSYS["archs"]:
            arch = get_config(arch_id)
            cfg = arch.model
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cell, (p, batch) = demo.materialize(arch, arch.shape("serve_p99"), smoke=False,
                                                seed=RECSYS["seed"], device=self.dev)
            self.sync()
            t_init = time.perf_counter() - t0
            out = cell.fn(p, batch)
            self.sync()
            good = tuple(out.shape) == (cell.meta["batch"],) and bool(torch.isfinite(out).all())
            ms = self.ms(lambda: cell.fn(p, batch), repeats=RECSYS["serve_calls"])
            tables = ("embed", "wide")
            dense = sum(t.numel() * t.element_size() for k, v in p.items() if k not in tables
                        for t in tree_leaves(v))
            nbytes = (self._table_bytes(cfg, cell.meta["batch"]) + dense
                      + sum(t.numel() * t.element_size() for t in batch.values())
                      + out.numel() * 4)
            bb, by = self.bound(nbytes, cell.meta["model_flops"])
            ok &= good
            log(f"recsys (b) {arch_id} serve_p99 at full size: table {tuple(p['embed'].shape)} "
                f"({p['embed'].numel() * 4 / 1e9:.2f} GB) drawn on the card in {t_init:.1f} s; "
                f"{ms:.4f} ms a call of {cell.meta['batch']} (median of {RECSYS['serve_calls']}), "
                f"{cell.meta['batch'] / ms * 1e3:,.0f} examples/s; bound {bb:.4f} ms ({by}: "
                f"{nbytes / 1e6:.2f} MB of gathered rows, dense weights, ids and scores; "
                f"{cell.meta['model_flops']:.3e} FLOPs), {bb / ms:.3f} of the call; peak "
                f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; finite, shape "
                f"{tuple(out.shape)}: {good} [{self.card}]")
            del p, batch, out
            self._free()
        return ok

    def _recsys_retrieval(self) -> bool:
        """(c) retrieval_cand on the fused kernel: two-tower retrieve_topk
        and dlrm-rm2's generic retrieval, each against the plain chunk_step
        on the card, with knn_scan and knn_merge timed at the shape."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch.configs import get_config
        from repro_torch.core.fqsd import chunk_step
        from repro_torch.core.topk import empty_topk
        from repro_torch.launch import demo
        from repro_torch.models import recsys as R

        ok = True
        for arch_id in RECSYS["retrieval"]:
            arch = get_config(arch_id)
            cfg = arch.model
            cell, (p, uid, cand) = demo.materialize(arch, arch.shape("retrieval_cand"),
                                                    smoke=False, seed=RECSYS["seed"],
                                                    device=self.dev)
            k = 100
            self.sync()
            K.reset_launch_counts()
            out = cell.fn(p, uid, cand)
            self.sync()
            launches = dict(K.LAUNCHES)
            with torch.no_grad():  # the user rows as the cell computes them
                if cfg.kind == "two_tower":
                    u = R._two_tower_embed(p, cfg, uid, "user_tower")
                else:
                    u = R.embedding_lookup(p["embed"], uid)
            m, (n, d) = u.shape[0], cand.shape
            plain = chunk_step(empty_topk((m,), k, device=self.dev), u, cand, None, 0, n, "ip")
            tol = torch.tensor(RETRIEVAL_TOL, device=self.dev)
            ok_end, err_end, checked = self._close(out.scores, out.indices, plain.scores,
                                                   plain.indices, tol, gap=tol)
            pilot = self.pilots(n, d, m, k)  # a pilot's pair where the rule engages
            ok_end &= launches["knn_scan"] >= 1 + pilot and launches["knn_merge"] == 1 + pilot
            retrieve_ms = self.ms(lambda: cell.fn(p, uid, cand))
            label = f"retrieval_{arch_id}_m{m}_n{n}_d{d}_k{k}"
            log(f"{label}: {cell.shape_name} through the cell (one knn_scan + one knn_merge, "
                f"metric ip) launches={launches}; against the plain chunk_step on the card: "
                f"max|d|={err_end:.3e} (tol {RETRIEVAL_TOL}), indices checked {checked}/{k} "
                f"(gaps over {RETRIEVAL_TOL}); whole call {retrieve_ms:.4f} ms; ok={ok_end} "
                f"[{self.card}]")
            ok &= self._retrieval_kernels(label, u, cand, k, launches, retrieve_ms) and ok_end
            del p, uid, cand, u, out, plain
            self._free()
        return ok

    def _retrieval_kernels(self, label, u, cand, k, launches, retrieve_ms) -> bool:
        """knn_scan and knn_merge at the retrieval shape on the operands the
        wrapper prepares, each against its plain version, timed beside it,
        the library call and the bound; one shape of the kernels line."""
        torch, K, ops = self.torch, self.K, self.ops
        call = ops.prepare(u, cand, k, "ip")
        bm, bn, _ = call.blocks
        cq, cx, cxn = call.q, call.x, call.xn
        qn = self.qnorm(cq)
        m_tiles, n_tiles = cq.shape[0] // bm, cx.shape[0] // bn
        splits = K.scan_config(m_tiles, n_tiles, bm, self.dev)[0]
        sv, si, _ = K.knn_scan(cq, cx, qn, cxn, call.k_eff, "ip", bm, bn, True, splits)
        pv, pi, _ = K.knn_scan_plain(cq, cx, qn, cxn, call.k_eff, "ip", bm, bn, True, splits)
        mv, mi = K.knn_merge(sv, si)
        mpv, mpi = K.knn_merge_plain(sv, si)
        self.sync()
        tol = torch.tensor(RETRIEVAL_TOL, device=self.dev)
        ok_scan, err_scan, _ = self._close(sv, si, pv, pi, tol, gap=tol)
        merge_exact = torch.equal(mv, mpv) and torch.equal(mi, mpi)
        scan_ms = self.ms(lambda: K.knn_scan(cq, cx, qn, cxn, call.k_eff, "ip", bm, bn, True,
                                             splits))
        merge_ms = self.ms(lambda: K.knn_merge(sv, si))
        plain_scan_ms = self.ms(lambda: K.knn_scan_plain(cq, cx, qn, cxn, call.k_eff, "ip",
                                                         bm, bn, True, splits))
        plain_merge_ms = self.ms(lambda: K.knn_merge_plain(sv, si))
        lib_scan_ms = self.ms(lambda: torch.topk(u @ cand.T, k))
        flat = sv.reshape(sv.shape[0], -1)
        lib_merge_ms = self.ms(lambda: torch.topk(flat, call.k_eff, largest=False))
        m, (n, d) = u.shape[0], cand.shape
        # the function: the candidates and users read once, the (m, k)
        # answer written once; 2·d + the ip epilogue's negation per pair
        scan_bytes = (n + m) * d * 4 + m * k * 8
        scan_ops = m * n * (2 * d + 1)
        merge_bytes, merge_ops = self.merge_work(sv, si, mv, mi)
        shape = {"shape": label, "splits": splits, "blocks": list(call.blocks),
                 "search_ms": retrieve_ms, "kernels": {}}
        for name, t, tp, tl, lib, (bb, by), err in (
                ("knn_scan", scan_ms, plain_scan_ms, lib_scan_ms, f"torch.topk(u @ cand.T, {k})",
                 self.bound(scan_bytes, scan_ops), err_scan),
                ("knn_merge", merge_ms, plain_merge_ms, lib_merge_ms,
                 "torch.topk(queues.reshape(m, -1))", self.bound(merge_bytes, merge_ops),
                 0.0 if merge_exact else math.inf)):
            shape["kernels"][name] = {
                "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": tp,
                "bound_ms": bb, "bound_by": by, "library_ms": tl, "library": lib}
            log(f"{label}: {name} ms={t:.4f} plain_ms={tp:.4f} library_ms={tl:.4f} "
                f"bound_ms={bb:.4f} ({by}) launches={launches[name]} [{self.card}]")
        log(f"{label}: scan against its plain version max|d|={err_scan:.3e}, merge "
            f"bit-identical={merge_exact}; splits={splits} blocks={call.blocks}; the wrapper's "
            f"padding copies the {n:,} x {d} candidates to {cx.shape[0]:,} rows a call")
        self.shapes.append(shape)
        return ok_scan and merge_exact

    def _train_steps(self, label, cell, args, batches, steps):
        """``steps`` train steps of ``cell`` from ``args`` on ``batches(i)``
        (drawn before each step's clock starts), then one traced step:
        (state, losses, step ms, peak bytes, traced (wall, busy, kernels,
        by_name))."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        p, opt = args[0], args[1]
        losses, times = [], []
        for i in range(steps):
            batch = batches(i)
            self.sync()
            t0 = time.perf_counter()
            p, opt, metrics = cell.fn(p, opt, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        batch = batches(steps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self.sync()
            t0 = time.perf_counter()
            p, opt, metrics = cell.fn(p, opt, batch)
            losses.append(float(metrics["loss"]))
            wall = (time.perf_counter() - t0) * 1e3
        gemm, other, kernels, by_name = self._device_ms(prof, 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        log(f"{label} traced step: {wall:.1f} ms under the profiler, {kernels} kernels, device "
            f"busy {gemm + other:.1f} ms (GEMM {gemm:.1f}, other kernels and copies "
            f"{other:.1f}), device idle share {1 - (gemm + other) / wall:.3f} (against the "
            f"untraced median step: {1 - (gemm + other) / statistics.median(times[1:]):.3f}); "
            f"device ms by kernel (launches): "
            + "; ".join(f"{name} {ms_:.2f} ({cnt})" for name, (cnt, ms_) in top))
        return (p, opt), losses, times, peak

    def _recsys_train(self) -> bool:
        """(d) train_batch (65,536) at full size, f32 moments, for
        RECSYS["train_archs"]: finite losses, ms a step, examples/s, peak
        memory, a traced step, the bound; then one step with each leaf
        updated whole (the optimizer before its row chunks), its peak."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import demo, train
        from repro_torch.optim import adamw

        ok = True
        for arch_id in RECSYS["train_archs"]:
            arch = get_config(arch_id)
            shape = arch.shape("train_batch")
            torch.cuda.reset_peak_memory_stats()
            cell, args = demo.materialize(arch, shape, smoke=False, seed=RECSYS["seed"],
                                          device=self.dev)
            batches = train.build_batches(arch, cell, False, self.dev)
            label = f"recsys (d) {arch_id} train_batch"
            state, losses, times, peak = self._train_steps(label, cell, args, batches,
                                                           RECSYS["train_steps"])
            ms = statistics.median(times[1:])
            n = cell.meta["params_total"]
            t_flops = cell.meta["model_flops"] / self.flops * 1e3
            # the optimizer: each param, gradient and both moments read
            # once, each param and moment written once (f32: 28 B a param)
            t_bytes = n * 28 / self.bw * 1e3
            bound = t_flops + t_bytes
            finite = all(math.isfinite(x) for x in losses)
            ok &= finite
            b = cell.meta["batch"]
            log(f"{label} at full size ({n:,} parameters, {arch.train_moment_dtype} moments, "
                f"batch {b}): losses {[round(x, 5) for x in losses]} (finite {finite}); step ms "
                f"{[round(t, 1) for t in times]}, {ms:.1f} ms a step (median of steps "
                f"2-{RECSYS['train_steps']}), {b / ms * 1e3:,.0f} examples/s; peak allocated "
                f"{peak / 1e9:.2f} GB; bound {bound:.2f} ms = model FLOPs "
                f"{cell.meta['model_flops']:.3e} / {self.flops / 1e12:.0f} TFLOP/s {t_flops:.2f} "
                f"ms + optimizer {n * 28 / 1e9:.2f} GB / {self.bw / 1e12:.2f} TB/s {t_bytes:.2f} "
                f"ms ({bound / ms:.3f} of the step) [{self.card}]")
            saved = adamw.CHUNK_ELEMS
            batch = batches(0)
            try:
                adamw.CHUNK_ELEMS = 1 << 62
                torch.cuda.reset_peak_memory_stats()
                p, opt, _ = cell.fn(*state, batch)
                self.sync()
                whole = f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            except torch.cuda.OutOfMemoryError:
                whole = "out of device memory"
            finally:
                adamw.CHUNK_ELEMS = saved
            log(f"{label}: one step with every leaf updated whole (no row chunks): peak "
                f"allocated {whole}; with chunks of {saved:,} elements: {peak / 1e9:.2f} GB "
                f"[{self.card}]")
            del args, state, batch
            p = opt = None
            self._free()
        return ok

    def _example(self, name: str, timeout: int):
        """examples/<name>.py on the card in a subprocess: (exit code, stdout,
        stderr, seconds)."""
        import os

        import repro_torch

        env = dict(os.environ, PYTHONPATH=str(Path(repro_torch.__file__).resolve().parents[1]))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py")],
                             capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
        return run.returncode, run.stdout, run.stderr, time.perf_counter() - t0

    def _examples_recsys(self) -> bool:
        """(e) the dense retrieval and streamed image retrieval examples."""
        ok = True
        checks = {"torch_dense_retrieval": r"recall@10 of source passage: (\S+)",
                  "torch_image_retrieval_streaming": r"streamed result == resident result"}
        for name in RECSYS["examples"]:
            rc, out, err, secs = self._example(name, RECSYS["example_timeout_s"])
            hit = re.search(checks[name], out)
            good = rc == 0 and hit is not None
            if name == "torch_dense_retrieval" and good:
                good = float(hit.group(1)) >= 0.95
            ok &= good
            log(f"recsys (e) examples/{name}.py: exit {rc} in {secs:.1f} s; ok={good} "
                f"[{self.card}]")
            for line in out.strip().splitlines():
                log(f"  {line}")
            if not good:
                log(err[-4000:])
        return ok

    # ---------------------------------------------------- phase 17: gnn
    def phase_gnn(self) -> bool:
        """MeshGraphNet: card against CPU (smoke, and full width cut to 2
        layers), training at full width and depth on three shapes, the
        world-edges example."""
        ok = True
        for step in (self._gnn_cut, self._gnn_train, self._example_gnn):
            t0 = time.perf_counter()
            ok &= step()
            log(f"gnn: {step.__name__} {time.perf_counter() - t0:.1f} s")
        return ok

    def _gnn_cut(self) -> bool:
        """(a) loss and gradients on the card against the host's CPU: the
        smoke model on its smoke batch, and the full width cut to
        GNN["cut_layers"] layers on GNN["cut_shape"] at full size."""
        torch = self.torch
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.launch import demo
        from repro_torch.models import gnn as G
        from repro_torch.tree import tree_leaves

        arch = get_config(GNN["arch"])
        cut = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=GNN["cut_layers"]))
        ok = True
        for what, a, smoke in (("smoke model", arch, True),
                               (f"full width cut to {GNN['cut_layers']} layers", cut, False)):
            cell, (p, _, batch) = demo.materialize(a, a.shape(GNN["cut_shape"]), smoke=smoke,
                                                   seed=GNN["seed"], device=self.dev)
            base = a.smoke_model if smoke else a.model
            cfg = dataclasses.replace(base, d_node_in=batch["graph"]["nodes"].shape[-1])
            host, hbatch = self._to_host(p), self._to_host(batch)
            (loss, _), grads = G.value_and_grad(p, cfg, batch)
            t0 = time.perf_counter()
            (hloss, _), hgrads = G.value_and_grad(host, cfg, hbatch)
            t_cpu = time.perf_counter() - t0
            loss_err = abs(float(loss) - float(hloss)) / abs(float(hloss))
            grad_err, at = self._tree_err(grads, hgrads)
            finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
            good = finite and max(loss_err, grad_err) <= MODEL_TOL
            ok &= good
            log(f"gnn (a) {cfg.name} {what} on {GNN['cut_shape']} ({cfg.n_layers} layers, "
                f"d_hidden {cfg.d_hidden}, {tuple(batch['graph']['nodes'].shape)} nodes, "
                f"{tuple(batch['graph']['edges'].shape)} edges), card against the host CPU: "
                f"loss {float(loss):.6e} / {float(hloss):.6e} relative {loss_err:.3e}; "
                f"gradients {grad_err:.3e} of their leaf's largest ({at}) (gate "
                f"{MODEL_TOL}); CPU {t_cpu:.1f} s; ok={good} [{self.card}]")
            del p, host, grads, hgrads, batch, hbatch
            self._free()
        return ok

    def _minibatch_source(self, shape):
        """minibatch_lg's batches: the sampler over a synthetic graph of the
        shape's nodes and edges (receivers drawn, then laid out sorted, so the
        CSR build sorts a sorted array), N(0, 1) features of d_feat; each
        step's subgraph with N(0, 1) edge features and targets, the loss on
        its seeds. Returns (batches(step), host seconds to build the graph,
        sampling ms per subgraph so far (a list))."""
        import numpy as np

        from repro_torch.models.sampler import CSRGraph, minibatch_stream

        torch = self.torch
        t0 = time.perf_counter()
        rng = np.random.default_rng(GNN["seed"])
        n, e = shape["n_nodes"], shape["n_edges"]
        counts = np.bincount(rng.integers(0, n, e, dtype=np.int32), minlength=n)
        receivers = np.repeat(np.arange(n, dtype=np.int32), counts)
        senders = rng.integers(0, n, e, dtype=np.int32)
        graph = CSRGraph(n, senders, receivers)
        del senders, receivers
        feat = rng.standard_normal((n, shape["d_feat"]), dtype=np.float32)
        build_s = time.perf_counter() - t0
        stream = minibatch_stream(graph, feat, shape["batch_nodes"],
                                  (shape["fanout0"], shape["fanout1"]), seed=GNN["seed"])
        sample_ms = []

        def batches(step: int):
            t1 = time.perf_counter()
            sub = next(stream)
            sample_ms.append((time.perf_counter() - t1) * 1e3)
            g = torch.Generator().manual_seed(step)
            on = lambda a: torch.from_numpy(a).to(self.dev)  # noqa: E731
            e_pad, n_pad = sub.senders.shape[0], sub.node_feat.shape[0]
            return {"graph": {"nodes": on(sub.node_feat),
                              "edges": torch.randn(e_pad, 4, generator=g).to(self.dev),
                              "senders": on(sub.senders), "receivers": on(sub.receivers),
                              "edge_mask": on(sub.edge_mask)},
                    "targets": torch.randn(n_pad, 2, generator=g).to(self.dev),
                    "node_mask": on(sub.seed_mask.astype(np.float32))}

        return batches, build_s, sample_ms

    def _masked_padding(self, arch, cell, args, batches, shape):
        """A full-batch shape's batches with only its graph's n_edges edges
        valid and the padding up to the cell's edge count masked, as the
        shape describes its graph. materialize's batch marks every padded
        edge valid (131,072 edges into 2,708 nodes, 48 a node): through 15
        sum layers with no normalisation its activations grow past f32, and
        its loss, computed once first, is printed beside."""
        torch = self.torch
        import dataclasses

        from repro_torch.models import gnn as G

        cfg = dataclasses.replace(arch.model, d_node_in=args[2]["graph"]["nodes"].shape[-1])
        with torch.no_grad():
            loss, _ = G.loss_fn(args[0], cfg, args[2])
        n_edges = shape["n_edges"]
        log(f"gnn (b) {cell.arch_id} {cell.shape_name}: materialize's batch, every one of its "
            f"{args[2]['graph']['edge_mask'].shape[0]:,} edges valid: loss {float(loss):.4e} "
            f"(15 layers of sum aggregation, no normalisation); the steps below mask the "
            f"padding past the graph's {n_edges:,} edges [{self.card}]")

        def masked(step: int):
            batch = batches(step)
            batch["graph"]["edge_mask"][n_edges:] = False
            return batch

        return masked

    def _gnn_train(self) -> bool:
        """(b) the whole model (15 layers, d_hidden 128, remat, f32 moments)
        for GNN["steps"] steps on each of GNN["shapes"]: finite losses, ms a
        step, edges/s, peak memory, a traced step, the bound."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import demo, train

        arch = get_config(GNN["arch"])
        ok = True
        for name in GNN["shapes"]:
            shape = arch.shape(name)
            torch.cuda.reset_peak_memory_stats()
            cell, args = demo.materialize(arch, shape, smoke=False, seed=GNN["seed"],
                                          device=self.dev)
            extra = ""
            if shape.kind == "train_sampled":
                batches, build_s, sample_ms = self._minibatch_source(shape)
                extra = f"; the graph built on the host in {build_s:.1f} s"
            else:
                batches, sample_ms = train.build_batches(arch, cell, False, self.dev), []
            if shape.kind == "train":  # full batch: the padding masked
                batches = self._masked_padding(arch, cell, args, batches, shape)
            label = f"gnn (b) {arch.arch_id} {name}"
            state, losses, times, peak = self._train_steps(label, cell, args, batches,
                                                           GNN["steps"])
            ms = statistics.median(times[1:])
            edges = cell.meta["edges"]
            bound = cell.meta["model_flops"] / self.flops * 1e3
            finite = all(math.isfinite(x) for x in losses)
            ok &= finite
            graph = args[2]["graph"]
            if sample_ms:
                extra += (f"; sampling {statistics.median(sample_ms):.1f} ms a subgraph on the "
                          f"host (median of {len(sample_ms)})")
            log(f"{label} ({cell.meta['params_total']:,} parameters, nodes "
                f"{tuple(graph['nodes'].shape)}, edges {tuple(graph['edges'].shape)}): losses "
                f"{[f'{x:.4e}' for x in losses]} (finite {finite}); step ms "
                f"{[round(t, 1) for t in times]}, {ms:.1f} ms a step (median of steps "
                f"2-{GNN['steps']}), {edges / ms * 1e3:,.0f} edges/s; peak allocated "
                f"{peak / 1e9:.2f} GB; bound {bound:.2f} ms (model FLOPs "
                f"{cell.meta['model_flops']:.3e} / {self.flops / 1e12:.0f} TFLOP/s), "
                f"{bound / ms:.3f} of the step{extra} [{self.card}]")
            del args, state
            self._free()
        return ok

    def _example_gnn(self) -> bool:
        """(c) the world-edges example: exit 0, its edge counts, finite."""
        rc, out, err, secs = self._example(GNN["example"], GNN["example_timeout_s"])
        good = (rc == 0 and "finite=True" in out
                and re.search(r"mesh edges: \d+, world \(collision\) edges: \d+", out) is not None)
        log(f"gnn (c) examples/{GNN['example']}.py: exit {rc} in {secs:.1f} s; ok={good} "
            f"[{self.card}]")
        for line in out.strip().splitlines():
            log(f"  {line}")
        if not good:
            log(err[-4000:])
        return good

    # ------------------------------------------------------------ model_mesh
    def phase_model_mesh(self) -> bool:
        """The substrate on a mesh of logical positions: (a) the MoE and
        flash-decode islands, (b) the row-sharded table, (c) the kNN cells,
        (d) the sharded retrieval, (e) the elastic round trip."""
        ok = True
        state = {}
        # (e) right after (a): it takes (a)'s parameters and frees them
        for step in (self._mm_islands, self._mm_elastic, self._mm_table, self._mm_knn,
                     self._mm_retrieval):
            t0 = time.perf_counter()
            ok &= step(state)
            log(f"model_mesh: {step.__name__} {time.perf_counter() - t0:.1f} s [{self.card}]")
            self._free()
        return ok

    def _logical_mesh(self, shape):
        from repro_torch.core.mesh import make_mesh

        return make_mesh(shape, ("data", "model"), devices=[self.dev] * math.prod(shape))

    @contextlib.contextmanager
    def _island_calls(self):
        """Count the calls of the two islands of repro_torch.models.layers."""
        from repro_torch.models import layers as L

        calls = {"_flash_decode_sharded": 0, "_moe_manual": 0}
        saved = {name: getattr(L, name) for name in calls}

        def counted(name):
            def fn(*a, **kw):
                calls[name] += 1
                return saved[name](*a, **kw)
            return fn

        for name in calls:
            setattr(L, name, counted(name))
        try:
            yield calls
        finally:
            for name, fn in saved.items():
                setattr(L, name, fn)

    @contextlib.contextmanager
    def _route_sets(self):
        """Record every routing of repro_torch.models.layers (the meshless
        MoE's and each island position's): each token's top-k expert set
        (sorted) and the gap between its k-th and (k+1)-th probability."""
        torch = self.torch
        from repro_torch.models import layers as L

        calls, orig = [], L._route

        def traced(xf, router, top_k):
            probs, gate_vals, gate_idx = orig(xf, router, top_k)
            vals = torch.sort(probs, dim=-1, descending=True, stable=True).values
            calls.append((gate_idx.sort(-1).values, vals[:, top_k - 1] - vals[:, top_k]))
            return probs, gate_vals, gate_idx

        L._route = traced
        try:
            yield calls
        finally:
            L._route = orig

    def _mm_islands(self, state) -> bool:
        """(a) the MoE arch's decode cell on the (2, 8) mesh against itself
        meshless on the card, at a capacity factor of E / top_k (no
        assignment dropped on either path: the island's capacity is its own
        data block's, as in the reference, so drops would differ by
        design). A token whose top-k experts differ between the two runs in
        any layer (the bf16 combine moves the next layer's router input by
        a bf16 step) is left out of the gates, as phase lm leaves out its
        MoE flips; their count and meshless k-th gaps are printed."""
        torch = self.torch
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.core.mesh import use_mesh
        from repro_torch.launch import demo
        from repro_torch.launch.steps import build_cell

        c = MODEL_MESH["moe"]
        full = get_config(c["arch"])
        cfg = dataclasses.replace(full.model, n_layers=c["layers"], capacity_factor=(
            full.model.n_experts / full.model.expert_top_k))
        arch = dataclasses.replace(full, model=cfg)
        shape = arch.shape(c["shape"])
        cell, (p, cache, tok) = demo.materialize(arch, shape, smoke=False,
                                                 seed=MODEL_MESH["seed"], device=self.dev)
        g = torch.Generator(device=self.dev).manual_seed(MODEL_MESH["seed"])
        for t in (cache["k"], cache["v"]):
            t.normal_(generator=g)
        mcache = {"k": cache["k"].clone(), "v": cache["v"].clone(), "len": cache["len"]}
        mesh = self._logical_mesh(c["mesh"])
        with use_mesh(mesh):
            mcell = build_cell(arch, shape)
        with self._route_sets() as plain_routes:
            want, _ = cell.fn(p, cache, tok)
        with use_mesh(mesh), self._island_calls() as calls, self._route_sets() as mesh_routes:
            got, _ = mcell.fn(p, mcache, tok)
        self.sync()
        # the mesh routes a layer: data blocks x model positions, each block's
        # routing the same at every model position
        tp, per = mesh.shape["model"], len(mesh_routes) // cfg.n_layers
        flips = torch.zeros(tok.shape[0], dtype=torch.bool, device=self.dev)
        gaps = []
        for layer in range(cfg.n_layers):
            sets = torch.cat([mesh_routes[layer * per + i * tp][0] for i in range(per // tp)])
            here = (sets != plain_routes[layer][0]).any(-1)
            flips |= here
            gaps.append(plain_routes[layer][1][here])
        gaps = torch.cat(gaps)
        keep = ~flips
        ms_plain = self.ms(lambda: cell.fn(p, cache, tok), repeats=3)
        with use_mesh(mesh):
            ms_mesh = self.ms(lambda: mcell.fn(p, mcache, tok), repeats=3)
        err = self._logits_err(got, want, keep)
        top = want.topk(2, dim=-1).values
        sure = ((top[:, 0] - top[:, 1]) > MESH_MOE_TOL) & keep
        same = got.argmax(-1) == want.argmax(-1)
        tokens_ok = bool((same | ~sure).all())
        islands = calls == {"_flash_decode_sharded": c["layers"], "_moe_manual": c["layers"]}
        ok = err <= MESH_MOE_TOL and tokens_ok and islands and bool(torch.isfinite(
            got[:, :cfg.vocab]).all())
        kv = mcell.in_specs[1]["k"]
        log(f"model_mesh (a) {cfg.name} cut to {cfg.n_layers} of {full.model.n_layers} layers, "
            f"{shape.name} (batch {tok.shape[0]}, cache {tuple(cache['k'].shape)} "
            f"{cache['k'].dtype}, {2 * cache['k'].numel() * 2 / 1e9:.2f} GB, len "
            f"{cache['len']}) on {mesh.shape} of {self.dev} x {mesh.size}: cache spec {kv}, "
            f"{cfg.n_experts // mesh.shape['model']} experts a position, capacity factor "
            f"{cfg.capacity_factor} (no drops); island calls {calls}; tokens whose top-"
            f"{cfg.expert_top_k} experts differ in some layer: {int(flips.sum())} (meshless k-th "
            f"gaps there {[round(float(g), 6) for g in gaps[:8]]}), left out; max|mesh - "
            f"meshless| over the other {int(keep.sum())} tokens' logits {err:.4e} (tol "
            f"{MESH_MOE_TOL}); next tokens equal {int(same.sum())}/{same.numel()} "
            f"({int(sure.sum())} kept with a top-2 margin over the tol, all equal: {tokens_ok}); "
            f"decode step {ms_mesh:.2f} ms on the mesh, "
            f"{ms_plain:.2f} ms meshless (CUDA events, median of 3); ok={ok} [{self.card}]")
        state["moe"] = (p, mcell, cfg, mesh)
        del cache, mcache, want, got
        return ok

    def _mm_table(self, state) -> bool:
        """(b) dlrm-rm2 at full size on (1, 8): serve_p99 bit-identical, one
        train step within the meshless spread."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core.mesh import use_mesh
        from repro_torch.launch import demo
        from repro_torch.launch.steps import build_cell

        c = MODEL_MESH["table"]
        arch = get_config(c["arch"])
        mesh = self._logical_mesh(c["mesh"])
        seed = MODEL_MESH["seed"]
        shape = arch.shape("serve_p99")
        cell, (p, batch) = demo.materialize(arch, shape, smoke=False, seed=seed, device=self.dev)
        want = cell.fn(p, batch)
        with use_mesh(mesh):
            mcell = build_cell(arch, shape)
            got = mcell.fn(p, batch)
            ms_mesh = self.ms(lambda: mcell.fn(p, batch))
        ms_plain = self.ms(lambda: cell.fn(p, batch))
        serve_ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
        log(f"model_mesh (b) {arch.arch_id} serve_p99 (batch {batch['sparse'].shape[0]}) on "
            f"{mesh.shape}: table {tuple(p['embed'].shape)} spec {mcell.in_specs[0]['embed']}, "
            f"bit-identical to the meshless cell: {serve_ok}; {ms_mesh:.4f} ms a call on the "
            f"mesh, {ms_plain:.4f} ms meshless (CUDA events, median of {REPEATS}) "
            f"[{self.card}]")
        del p, batch, want, got
        self._free()

        shape = arch.shape("train_batch")

        def step(on_mesh):
            ctx = use_mesh(mesh) if on_mesh else contextlib.nullcontext()
            with ctx:
                cell, (p, opt, batch) = demo.materialize(arch, shape, smoke=False, seed=seed,
                                                         device=self.dev)
                self.sync()
                t0 = time.perf_counter()
                p, opt, metrics = cell.fn(p, opt, batch)
                loss = float(metrics["loss"])
                t = (time.perf_counter() - t0) * 1e3
            del opt, batch
            return loss, p, t

        loss_a, p_a, t_a = step(False)
        self._free()
        loss_b, p_b, t_b = step(False)
        spread, at = self._tree_err(p_b, p_a)
        del p_b
        self._free()
        loss_c, p_c, t_c = step(True)
        err, at_c = self._tree_err(p_c, p_a)
        del p_c, p_a
        loss_spread, loss_err = abs(loss_b - loss_a), abs(loss_c - loss_a)
        train_ok = err <= 2 * spread and loss_err <= 2 * loss_spread
        log(f"model_mesh (b) {arch.arch_id} train_batch ({shape['batch']:,}) one step from the "
            f"seed's state: two meshless steps differ by {spread:.3e} of a leaf's largest value "
            f"({at or 'every leaf equal'}), loss {loss_a!r} / "
            f"{loss_b!r}; the step on {mesh.shape} differs from the first by {err:.3e} "
            f"({at_c or 'every leaf equal'}), loss {loss_c!r} (gate: within twice the meshless "
            f"spread): {train_ok}; "
            f"step ms (first step, host clock) meshless {t_a:.1f} / {t_b:.1f}, mesh {t_c:.1f} "
            f"[{self.card}]")
        return serve_ok and train_ok

    def _knn_data(self, cell, d, seed):
        """Integer-valued queries and rows of the cell's padded shapes (the
        columns past d zero), made on the card in row chunks, and exact
        norms."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        (m, dp), (n, _) = cell.inputs[0].shape, cell.inputs[1].shape
        q = torch.zeros((m, dp), device=self.dev)
        q[:, :d] = torch.randint(-4, 5, (m, d), generator=g, device=self.dev,
                                 dtype=torch.float32)
        x = torch.zeros((n, dp), device=self.dev)
        xn = torch.empty(n, device=self.dev)
        step = 1 << 18
        for a in range(0, n, step):
            b = min(n, a + step)
            x[a:b, :d] = torch.randint(-4, 5, (b - a, d), generator=g, device=self.dev,
                                       dtype=torch.float32)
            xn[a:b] = torch.sum(x[a:b] * x[a:b], dim=-1)
        x[n // 2] = x[7]  # a duplicate row: a tie decided by index
        xn[n // 2] = xn[7]
        q[0] = x[7]
        return q, x, xn

    def _mm_knn(self, state) -> bool:
        """(c) the kNN cells on (2, 2), bit-identical to the meshless cells."""
        torch = self.torch
        import dataclasses
        from types import SimpleNamespace

        from repro_torch.configs import get_config
        from repro_torch.core.mesh import use_mesh
        from repro_torch.core.sharded import shard_dataset
        from repro_torch.launch.steps import build_cell

        c = MODEL_MESH["knn"]
        arch = get_config("knn-search")
        mesh = self._logical_mesh(c["mesh"])
        ok = True
        for name in c["shapes"]:
            shape = arch.shape(name)
            cut = ""
            if shape.kind in ("knn_ring", "knn_ring_q"):
                shape = dataclasses.replace(shape, dims={**shape.dims, "n": c["cut"]})
                cut = f", N cut from {arch.shape(name)['n']:,} to {c['cut']:,}"
            with use_mesh(mesh):
                mcell = build_cell(arch, shape)
            d, k = shape["d"], shape["k"]
            q, x, xn = self._knn_data(mcell, d, c["seed"])
            want = build_cell(arch, shape).fn(q, x, xn)
            self.sync()
            with use_mesh(mesh):
                got, launches = self._counted(lambda: mcell.fn(q, x, xn))
                ms_mesh = self.ms(lambda: mcell.fn(q, x, xn), repeats=3)
            same = torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)
            axes = (("model",) if shape.kind == "knn_fqsd" else
                    ("data", "model") if shape.kind == "knn_fdsq" else ("data", "model"))
            v, n_ = shard_dataset(mesh, x, xn, axes)
            qb = q if shape.kind == "knn_fdsq" else q[: q.shape[0] // mesh.shape["data"]]
            label = f"model_mesh_{name}_{mesh.shape['data']}x{mesh.shape['model']}"
            shapes = self._mesh_f32_shapes(label, qb, SimpleNamespace(vectors=v, norms=n_), k,
                                           launches, d=d)
            for sh in shapes:
                sh["search_ms"] = ms_mesh
            self.shapes.extend(shapes)
            good = same and launches["knn_scan"] > 0 and launches["knn_merge"] > 0
            ok &= good
            log(f"model_mesh (c) {name} ({shape.kind}: n {x.shape[0]:,} x {x.shape[1]} padded, "
                f"m {q.shape[0]}, k {k}{cut}; {x.numel() * 4 / 1e9:.2f} GB) on {mesh.shape}, "
                f"in_specs {list(mcell.in_specs)}: launches {launches}; values and indices "
                f"bit-identical to the meshless cell: {same}; {ms_mesh:.3f} ms a search on the "
                f"mesh (median of 3) [{self.card}]")
            del q, x, xn, v, n_, got, want
            self._free()
        return ok

    def _mm_retrieval(self, state) -> bool:
        """(d) two-tower retrieval_cand on (1, 4): candidates P(rows, None)
        through fdsq_sharded(metric="ip"), bit-identical to the meshless
        retrieval on the kernel."""
        torch = self.torch
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.core.mesh import use_mesh
        from repro_torch.launch import demo
        from repro_torch.launch.steps import build_cell
        from repro_torch.models import recsys as R

        c = MODEL_MESH["retrieval"]
        full = get_config(c["arch"])
        cfg = dataclasses.replace(full.model, table_sizes=tuple(
            min(s, c["cut_rows"]) for s in full.model.table_sizes))
        arch = dataclasses.replace(full, model=cfg)
        shape = arch.shape("retrieval_cand")
        cell, (p, uid, cand) = demo.materialize(arch, shape, smoke=False,
                                                seed=MODEL_MESH["seed"], device=self.dev)
        want, plain_launches = self._counted(lambda: cell.fn(p, uid, cand))
        mesh = self._logical_mesh(c["mesh"])
        with use_mesh(mesh):
            mcell = build_cell(arch, shape)
            got, launches = self._counted(lambda: mcell.fn(p, uid, cand))
            ms_mesh = self.ms(lambda: mcell.fn(p, uid, cand))
        ms_plain = self.ms(lambda: cell.fn(p, uid, cand))
        same = torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)
        with torch.no_grad():
            u = R._two_tower_embed(p, cfg, uid, "user_tower")
        block = cand.shape[0] // mesh.shape["model"]
        label = (f"model_mesh_retrieval_m{u.shape[0]}_n{block}_of_{cand.shape[0]}_"
                 f"d{cand.shape[1]}_k100")
        ok = self._retrieval_kernels(label, u, cand[:block], 100, launches, ms_mesh)
        log(f"model_mesh (d) {full.arch_id} retrieval_cand ({u.shape[0]} x {cand.shape[0]:,} x "
            f"{cand.shape[1]}, k 100; table cut to {cfg.padded_rows:,} rows) on {mesh.shape}: "
            f"candidates {mcell.in_specs[2]}, launches {launches} (meshless {plain_launches}); "
            f"bit-identical to the meshless retrieval: {same}; {ms_mesh:.4f} ms a call on the "
            f"mesh, {ms_plain:.4f} ms meshless [{self.card}]")
        del p, uid, cand, u, got, want
        return ok and same and launches["knn_merge"] == mesh.shape["model"] + 1

    def _mm_elastic(self, state) -> bool:
        """(e) (a)'s parameters placed on 16 positions, saved, restored on 8
        with shardings=, saved, restored on 16: bitwise the original."""
        torch = self.torch
        import shutil

        from repro_torch.checkpoint import load_checkpoint, save_checkpoint
        from repro_torch.runtime.elastic import remesh, reshard_tree
        from repro_torch.runtime.sharding import NamedSharding, Sharded, sanitize_spec
        from repro_torch.tree import Stack, reference_layout, tree_leaves, tree_map

        if "moe" not in state:
            log("model_mesh (e) needs (a)'s parameters")
            return False
        p, mcell, cfg, mesh16 = state.pop("moe")
        layout = reference_layout(p)
        specs = mcell.in_specs[0]
        big, small = MODEL_MESH["elastic"]
        root = Path(MODEL_MESH["ckpt"])
        shutil.rmtree(root, ignore_errors=True)

        def shardings(mesh):
            sizes = dict(mesh.shape)
            return tree_map(lambda x, sp: NamedSharding(mesh, sanitize_spec(
                tuple(x.shape), sp, sizes)), layout, specs)

        def whole(x):
            if isinstance(x, Stack):
                return torch.stack([whole(t) for t in x.parts])
            return x.full() if isinstance(x, Sharded) else x

        try:
            t0 = time.perf_counter()
            placed = reshard_tree(layout, specs, mesh16)  # (a)'s (2, 8) mesh
            save_checkpoint(root / "a", 1, placed)
            t_save = time.perf_counter() - t0
            mesh8 = remesh([self.dev] * small)
            t0 = time.perf_counter()
            on8, _ = load_checkpoint(root / "a", placed, shardings=shardings(mesh8))
            self.sync()
            t_load = time.perf_counter() - t0
            save_checkpoint(root / "b", 2, on8)
            del on8
            mesh16b = remesh([self.dev] * big)
            back, _ = load_checkpoint(root / "b", placed, shardings=shardings(mesh16b))
            same = all(torch.equal(whole(a).view(torch.int16) if a.dtype == torch.bfloat16
                                   else whole(a), whole(b).view(torch.int16)
                                   if b.dtype == torch.bfloat16 else whole(b))
                       for a, b in zip(tree_leaves(layout), tree_leaves(back)))
            nbytes = sum(t.numel() * t.element_size() for t in p.parameters())
            log(f"model_mesh (e) {cfg.name} (2 layers, {nbytes / 1e9:.2f} GB): placed under "
                f"the decode cell's in_specs on {mesh16.shape}, saved in {t_save:.1f} s, "
                f"restored on remesh({small}) = {mesh8.shape} with shardings= in {t_load:.1f} s, "
                f"saved, restored on remesh({big}) = {mesh16b.shape}: every leaf bitwise the "
                f"original: {same} "
                f"[{self.card}]")
            return same
        finally:
            shutil.rmtree(root, ignore_errors=True)

    def kernels_line(self) -> dict:
        """One entry per kernel: the main path's launches and times summed
        over its runs (one of each shape), per-shape numbers beside."""
        out = []
        for name, (source, replaces) in KERNELS.items():
            per = [s["kernels"][name] | {"shape": s["shape"]} for s in self.shapes
                   if name in s["kernels"]]
            if not per:
                continue
            total = lambda key: sum(p[key] for p in per)  # noqa: E731
            lib = [p["library_ms"] for p in per]
            bound_ms = total("bound_ms")
            out.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": total("launches"), "max_abs_err": max(p["max_abs_err"] for p in per),
                "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": bound_ms,
                "bound_by": ("bytes" if sum(p["bound_ms"] for p in per if p["bound_by"] == "bytes")
                             >= bound_ms / 2 else "operations"),
                "library_ms": None if None in lib else sum(lib),
                "shapes": per,
            })
        return {"kernels": out}


class Listen:
    """Phase listen: one KnnServer, its scheduler instrumented on the
    instance (the launch counters reset and read around every dispatch on
    the worker, each dispatch's label, rows, thread and service time kept,
    and every SearchResult the batcher resolved kept by rid), the traffic
    of steps 1-4, the stats probe riding along, and the loadgen runs."""

    LABELS = ("fdsq", "fqsd", "fqsd-int8")

    def __init__(self, smoke, server, eng, q, k, name):
        self.smoke, self.torch, self.K = smoke, smoke.torch, smoke.K
        self.server, self.eng, self.q, self.k, self.name = server, eng, q, k, name
        self.qt = smoke.torch.from_numpy(q).to(smoke.dev)
        self.path = f"/v1/collections/{name}"
        self.log = []  # [label, rows, launches, thread, service s, end] a dispatch
        self.resolved = {}  # rid -> the SearchResult the batcher resolved
        self.totals = {label: {"knn_scan": 0, "knn_merge": 0, "knn_int8_scan": 0}
                       for label in self.LABELS}
        sched = server.schedulers[name]
        search, execute, dispatch = sched._search, sched._execute, sched.dispatch_batch

        def counted_search(request):
            self.K.reset_launch_counts()
            res = search(request)
            label = "fqsd-int8" if request.tier == "int8" else request.mode_hint
            self.log.append([label, int(request.queries.shape[0]), dict(self.K.LAUNCHES),
                             threading.current_thread().name])
            return res

        def timed_execute(reqs, mode, clock_s, tier="f32"):
            results, dt_s = execute(reqs, mode, clock_s, tier=tier)
            self.log[-1] += [dt_s, time.perf_counter()]
            return results, dt_s

        def kept_dispatch(reqs, clock_s=None):
            out = dispatch(reqs, clock_s)
            self.resolved.update((r.rid, r) for r in out)
            return out

        sched._search, sched._execute = counted_search, timed_execute
        sched.dispatch_batch = kept_dispatch

    # ----------------------------------------------------------- helpers
    @staticmethod
    async def request(conn, method, path, body=None, headers=None):
        import asyncio

        return await asyncio.wait_for(conn.request(method, path, body, headers=headers),
                                      LISTEN["wait_s"])

    async def raw(self, method, path, body, headers) -> tuple[int, dict, dict]:
        """One request on a connection of its own: (status, headers, body)."""
        import asyncio

        async def go():
            reader, writer = await asyncio.open_connection(*self.server.address)
            data = json.dumps(body).encode()
            head = [f"{method} {path} HTTP/1.1", "Host: t", f"Content-Length: {len(data)}"]
            head += [f"{name}: {value}" for name, value in headers.items()]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
            await writer.drain()
            lines = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
            fields = dict(line.split(": ", 1) for line in lines[1:] if ": " in line)
            n = int(fields.get("Content-Length", 0))
            payload = json.loads(await reader.readexactly(n)) if n else {}
            writer.close()
            with contextlib.suppress(ConnectionError, OSError):
                await writer.wait_closed()
            return int(lines[0].split(" ")[1]), fields, payload

        return await asyncio.wait_for(go(), LISTEN["wait_s"])

    async def on_worker(self, fn, *args):
        """Run fn on the server's dispatch worker (serialised with its
        dispatches, as every engine call of this phase is)."""
        import asyncio
        import functools

        return await asyncio.get_running_loop().run_in_executor(
            self.server._executor, functools.partial(fn, *args))

    async def reference(self):
        return await self.on_worker(self.smoke._serve_reference, self.eng, self.qt, self.k)

    def connection(self, server=None):
        from repro_torch.server.loadgen import Connection, LoadReport

        return Connection(*(server or self.server).address,
                          LoadReport(mode="listen", duration_s=0.0))

    async def lane(self, rids, answers, on_answer=None) -> None:
        """Send the query rows of rids in turn on one persistent connection."""
        conn = self.connection()
        try:
            for rid in rids:
                answers[rid] = await self.request(
                    conn, "POST", f"{self.path}/search",
                    {"queries": self.q[rid].tolist(), "rid": rid})
                if on_answer is not None:
                    on_answer()
        finally:
            await conn.close()

    async def burst(self, rids, answers) -> None:
        """One request a rid, each on its own connection, while the dispatch
        worker is held: the first alone until the batcher has taken it (its
        dispatch then waits for the worker), then the rest, released once
        all are queued, so they form one batch."""
        import asyncio

        adm, batcher = self.server.admission, self.server.batchers[self.name]

        async def until(cond):
            t_end = time.perf_counter() + LISTEN["wait_s"]
            while not cond():
                if time.perf_counter() > t_end:
                    raise TimeoutError("a held burst did not queue")
                await asyncio.sleep(0.002)

        gate = threading.Event()
        held = asyncio.get_running_loop().run_in_executor(
            self.server._executor, gate.wait, LISTEN["wait_s"])
        base, (plug, *rest) = adm.inflight, rids
        tasks = [asyncio.create_task(self.lane([plug], answers))]
        try:
            await until(lambda: adm.inflight == base + 1 and batcher.depth() == 0)
            tasks += [asyncio.create_task(self.lane([rid], answers)) for rid in rest]
            await until(lambda: batcher.depth() == len(rest))
        finally:
            gate.set()
            await held
        await asyncio.gather(*tasks)

    async def traffic(self) -> dict:
        """Every query row once, by rid: a stretch over a few persistent
        connections, then each held burst. Returns rid -> (status, body)."""
        import asyncio

        answers = {}
        m, c = self.q.shape[0], LISTEN["stretch_connections"]
        start = m - sum(LISTEN["bursts"])
        await asyncio.gather(*(self.lane(range(i, start, c), answers) for i in range(c)))
        for size in LISTEN["bursts"]:
            await self.burst(range(start, start + size), answers)
            start += size
        return answers

    @staticmethod
    def wire_f32(values):
        """JSON scores as f32 (null stands for a non-finite score)."""
        import numpy as np

        return np.array([np.inf if v is None else v for v in values], np.float32)

    def same_bits(self, body, res) -> bool:
        """The wire answer decodes to the resolved result's very bits."""
        import numpy as np

        want = res.topk.scores.numpy()
        want = np.where(np.isfinite(want), want, np.float32(np.inf))
        return (np.array_equal(self.wire_f32(body["scores"]).view(np.uint32),
                               want.view(np.uint32))
                and body["indices"] == res.topk.indices.tolist()
                and body["certified"] == bool(res.certified))

    def check(self, step, answers, ref, first, deleted=(), upserted=None,
              read_launches=True) -> bool:
        """Gates (a), (b) and (d) of one step's 512 answers."""
        torch, m = self.torch, self.q.shape[0]
        statuses = sorted({st for st, _ in answers.values()})
        if sorted(answers) != list(range(m)) or statuses != [200]:
            log(f"listen {step}: answered {len(answers)}/{m}, statuses {statuses}; ok=False")
            return False
        bodies = [answers[rid][1] for rid in range(m)]
        same = sum(self.same_bits(bodies[rid], self.resolved[rid]) for rid in range(m))
        scores = torch.tensor(self.wire_f32([v for b in bodies for v in b["scores"]]),
                              device=self.smoke.dev).reshape(m, -1)
        ids = torch.tensor([b["indices"] for b in bodies], device=self.smoke.dev)
        qn = torch.sum(self.qt * self.qt, dim=-1)
        norms = self.eng._ds.norms
        tol = TOL_REL * (qn[:, None] + float(norms[torch.isfinite(norms)].max()))
        ok_a, err, checked = self.smoke._close(scores, ids, ref[0], ref[1], tol)
        gone = sorted({i for b in bodies for i in b["indices"]} & set(deleted))
        found = all(bodies[row]["indices"][0] == new_id
                    for row, new_id in (upserted or {}).items() if new_id not in deleted)
        mine = self.log[first:]
        threads = sorted({entry[3] for entry in mine})
        on_worker = all(t.startswith("knn-dispatch") for t in threads)
        labels = {entry[0] for entry in mine}
        ok_b, bad = True, []
        for lab, rows, launches, *_ in mine if read_launches else ():
            good = self.smoke._dispatch_launches(self.eng, lab, rows, self.k, launches)
            ok_b &= good
            if not good:
                bad.append((lab, rows, launches))
            for name in self.totals[lab]:
                self.totals[lab][name] += launches[name]
        ok_d = not read_launches or labels >= set(self.LABELS)
        ok = same == m and ok_a and not gone and found and on_worker and ok_b and ok_d
        sizes = {lab: sorted({e[1] for e in mine if e[0] == lab}) for lab in sorted(labels)}
        log(f"listen {step}: (a) wire vs direct search max|d|={err:.3e} (tol "
            f"{float(tol.max()):.3e}), indices checked {checked}/{ids.numel()}; bit-identical to "
            f"the resolved results {same}/{m}; deleted ids served {gone}; upserted rows found "
            f"{found} ({len(upserted or {})}); (b) {len(mine)} dispatches on threads {threads}, "
            f"kernels of the label launched by all="
            f"{ok_b if read_launches else 'not read'} {bad[:3]}; (d) 512 answered 200, labels "
            f"{sorted(labels)}, padded rows by label {sizes}; ok={ok} [{self.smoke.card}]")
        return ok

    async def mutate(self, conn, answers, round_) -> tuple[bool, dict, set]:
        """Upsert LISTEN["upserts"] query rows and delete the nearest ids of
        LISTEN["deletes"] other queries (from the last answers) over the
        wire; returns (ok, row -> new id, deleted ids)."""
        u, dl = LISTEN["upserts"], LISTEN["deletes"]
        rows = list(range(2 * u * round_, 2 * u * round_ + u))
        ids = sorted({answers[r][1]["indices"][0] for r in range(rows[-1] + 1, rows[-1] + 1 + dl)})
        t0 = time.perf_counter()
        st_u, up = await self.request(conn, "POST", f"{self.path}/upsert",
                                      {"vectors": self.q[rows].tolist()})
        t1 = time.perf_counter()
        st_d, gone = await self.request(conn, "POST", f"{self.path}/delete", {"ids": ids})
        t2 = time.perf_counter()
        ok = (st_u == st_d == 200 and up.get("count") == u
              and gone.get("deleted") == len(ids))
        log(f"listen: round {round_}: upsert {u} rows over the wire {(t1 - t0) * 1e3:.3f} ms, "
            f"delete {len(ids)} ids {(t2 - t1) * 1e3:.3f} ms; ok={ok} [{self.smoke.card}]")
        return ok, dict(zip(rows, up.get("ids", []))), set(ids)

    # -------------------------------------------------------------- steps
    async def phase(self) -> bool:
        import asyncio

        from repro_torch.server.loadgen import stats_stream_probe

        frames, done = [], asyncio.Event()

        async def ride():  # the stats stream, in segments, until told to stop
            while not done.is_set():
                frames.extend(await asyncio.wait_for(
                    stats_stream_probe(*self.server.address, LISTEN["probe_s"],
                                       interval_ms=LISTEN["probe_interval_ms"]),
                    LISTEN["probe_s"] + LISTEN["wait_s"]))

        async with self.server:
            probe = asyncio.create_task(ride())
            conn = self.connection()
            try:
                ok, answers = await self.step_exact()
                ok2, answers = await self.step_mutate(conn, answers)
                ok &= ok2
                ok &= await self.step_background(conn, answers)
                ok &= await self.step_ladder(conn)
            finally:
                done.set()
                await conn.close()
                await asyncio.wait_for(probe, LISTEN["probe_s"] + LISTEN["wait_s"])
            good = len(frames) >= 2 and all(isinstance(f, dict) and self.name in f["schedulers"]
                                            for f in frames)
            log(f"listen step 5: stats stream {len(frames)} frames, each JSON with the "
                f"collection's scheduler={good}; ok={good}")
            ok &= good
            log(f"listen: launches by plan over steps 1 and 2 {self.totals} [{self.smoke.card}]")
            await self.measure()
        return ok

    async def step_exact(self) -> tuple[bool, dict]:
        ref = await self.reference()
        first = len(self.log)
        answers = await self.traffic()
        return self.check("step 1", answers, ref, first), answers

    async def step_mutate(self, conn, answers) -> tuple[bool, dict]:
        ok, upserted, deleted = await self.mutate(conn, answers, 1)
        t0 = time.perf_counter()
        st_c, status = await self.request(conn, "POST", f"{self.path}/compact", {"wait": True})
        t1 = time.perf_counter()
        st_g, got = await self.request(conn, "GET", f"{self.path}/compact")
        ok &= (st_c == st_g == 200 and status["generation"] == got["generation"] == 1
               and status["error"] is None and not got["running"])
        log(f"listen step 2: POST compact {{\"wait\": true}} {t1 - t0:.3f} s -> generation "
            f"{status['generation']}, error {status['error']}; GET compact generation "
            f"{got['generation']}; ok={ok} [{self.smoke.card}]")
        self.upserted, self.deleted = upserted, deleted
        ref = await self.reference()
        first = len(self.log)
        answers = await self.traffic()
        ok &= self.check("step 2", answers, ref, first, deleted, upserted)
        return ok, answers

    async def step_background(self, conn, answers) -> bool:
        """Mutate, then the 512 over many connections with POST compact {}
        sent after the first answers; GET compact polled until the new
        generation stands."""
        import asyncio

        ok, upserted, deleted = await self.mutate(conn, answers, 2)
        upserted, deleted = self.upserted | upserted, self.deleted | deleted
        ref = await self.reference()  # the live rows, which compaction keeps
        first = len(self.log)
        m, c = self.q.shape[0], LISTEN["compaction_connections"]
        answers, arrivals, started = {}, [], asyncio.Event()
        marks = {}

        def on_answer():
            arrivals.append(time.perf_counter())
            if len(arrivals) == LISTEN["compact_after"]:
                started.set()

        async def trigger():
            await asyncio.wait_for(started.wait(), LISTEN["wait_s"])
            marks["trigger"] = time.perf_counter()
            st, status = await self.request(conn, "POST", f"{self.path}/compact", {})
            t_end = time.perf_counter() + LISTEN["wait_s"]
            poll = self.connection()
            try:
                while time.perf_counter() < t_end:
                    st_g, got = await self.request(poll, "GET", f"{self.path}/compact")
                    if not got["running"] and got["generation"] >= 2:
                        marks["stood"] = time.perf_counter()
                        return st == st_g == 200, status, got
                    await asyncio.sleep(0.02)
            finally:
                await poll.close()
            return False, status, got

        (good, status, got), *_ = await asyncio.gather(
            trigger(), *(self.lane(range(i, m, c), answers, on_answer) for i in range(c)))
        ok &= good and got["generation"] == 2 and got["error"] is None
        stood = marks.get("stood", math.inf)
        during = sum(marks["trigger"] <= t <= stood for t in arrivals)
        overlap = sum(e[5] - e[4] < stood and e[5] > marks["trigger"]
                      for e in self.log[first:] if len(e) == 6)
        log(f"listen step 3: POST compact {{}} after {LISTEN['compact_after']} answers -> running "
            f"{status['running']}; generation {got['generation']} stood "
            f"{stood - marks['trigger']:.3f} s later, error {got['error']}; dispatches that "
            f"overlapped it {overlap}, answers that arrived meanwhile {during}; ok={ok} "
            f"[{self.smoke.card}]")
        return ok & self.check("step 3", answers, ref, first, deleted, upserted,
                               read_launches=False)

    async def step_ladder(self, conn) -> bool:
        """A tenant past its rate draws 429s with Retry-After and no hard
        error; a second server with a short queue timeout answers 503s
        under a burst; no admission slot is left held."""
        import asyncio

        from repro_torch.server import KnnServer
        from repro_torch.server.loadgen import closed_loop

        adm = self.server.admission
        adm.tenant_qps = LISTEN["ladder_tenant_qps"]
        try:
            rep = await asyncio.wait_for(closed_loop(
                *self.server.address, self.name, connections=LISTEN["ladder_connections"],
                duration_s=LISTEN["ladder_s"], d=self.q.shape[1], k=self.k,
                tenant_fn=lambda w: "hot-tenant", honor_retry_after=False),
                LISTEN["ladder_s"] + LISTEN["wait_s"])
            # one request more at a time until one is refused, for its headers
            for _ in range(2 * math.ceil(LISTEN["ladder_tenant_qps"]) + 2):
                st, fields, body = await self.raw("POST", f"{self.path}/search",
                                                  {"queries": self.q[0].tolist()},
                                                  {"X-Tenant": "hot-tenant"})
                if st != 200:
                    break
        finally:
            adm.tenant_qps = None
        ok = (rep.rejected > 0 and rep.errors == 0 and rep.ok > 0 and st == 429
              and body.get("reason") == "rate_limit" and float(fields.get("Retry-After", 0)) > 0)
        log(f"listen step 4: tenant_qps={LISTEN['ladder_tenant_qps']} under closed-loop traffic "
            f"from one tenant over {LISTEN['ladder_connections']} connections: "
            f"{json.dumps(rep.summary())}; one more: {st} {body.get('reason')} Retry-After "
            f"{fields.get('Retry-After')}; ok={ok} [{self.smoke.card}]")

        second = KnnServer(self.server.router, port=0, policy="adaptive",
                           int8_min_depth=LISTEN["int8_min_depth"],
                           queue_timeout_ms=LISTEN["queue_timeout_ms"])
        async with second:
            async def one(row):
                conn2 = self.connection(second)
                try:
                    return await self.request(conn2, "POST", f"{self.path}/search",
                                              {"queries": self.q[row].tolist()})
                finally:
                    await conn2.close()

            # the worker busy for 100 ms as the burst lands (a long dispatch):
            # every request queued meanwhile outlives its queue timeout
            busy = asyncio.get_running_loop().run_in_executor(second._executor, time.sleep, 0.1)
            out = await asyncio.gather(*(one(r) for r in range(LISTEN["timeout_burst"])))
            await busy
            probe2 = self.connection(second)
            try:
                st2, stats2 = await self.request(probe2, "GET", "/stats")
                sh2, _ = await self.request(probe2, "GET", "/healthz")
            finally:
                await probe2.close()
        statuses = [s for s, _ in out]
        timeouts = sum(s == 503 and b.get("reason") == "queue_timeout" for s, b in out)
        st1, stats1 = await self.request(conn, "GET", "/stats")
        sh1, _ = await self.request(conn, "GET", "/healthz")
        good = (timeouts > 0 and set(statuses) <= {200, 503} and st2 == sh2 == st1 == sh1 == 200
                and stats2["admission"]["inflight"] == 0 and stats1["admission"]["inflight"] == 0)
        log(f"listen step 4: a second KnnServer, queue_timeout_ms={LISTEN['queue_timeout_ms']}, "
            f"burst of {LISTEN['timeout_burst']} onto a worker busy for 100 ms: {statuses.count(200)} answered, {timeouts} "
            f"503 queue_timeout, others {sorted(set(statuses) - {200, 503})}; admission inflight "
            f"after: {stats2['admission']['inflight']} / {stats1['admission']['inflight']}, "
            f"/healthz {sh2} / {sh1}; ok={good} [{self.smoke.card}]")
        return ok and good

    # ------------------------------------------------------ measurements
    async def measure(self) -> None:
        """loadgen --port in a subprocess at each connection count (printed,
        not gated), beside the dispatches of each run, the scheduler's
        per-plan p50 from /stats and the server's codec medians."""
        import asyncio
        import os

        import repro_torch

        env = dict(os.environ, PYTHONPATH=str(Path(repro_torch.__file__).resolve().parents[1]))
        host, port = self.server.address
        conn = self.connection()
        try:
            for c in LISTEN["loadgen_connections"]:
                first = len(self.log)
                for samples in self.server.codec_ms.values():
                    samples.clear()
                proc = await asyncio.create_subprocess_exec(
                    sys.executable, "-m", "repro_torch.server.loadgen", "--host", host,
                    "--port", str(port), "--collection", self.name, "--connections", str(c),
                    "--duration", str(LISTEN["loadgen_s"]), "--d", str(self.q.shape[1]),
                    "--k", str(self.k), stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
                try:
                    out, err = await asyncio.wait_for(
                        proc.communicate(), LISTEN["loadgen_s"] + LISTEN["wait_s"])
                except asyncio.TimeoutError:
                    proc.kill()
                    await proc.wait()
                    log(f"listen loadgen --connections {c}: timed out, killed")
                    continue
                if proc.returncode:
                    log(f"listen loadgen --connections {c}: exit {proc.returncode}: "
                        f"{err.decode()[-400:]}")
                    continue
                summary = json.loads(out)
                per = {}
                for entry in self.log[first:]:
                    if len(entry) == 6:
                        per.setdefault(entry[0], []).append((entry[1], entry[4] * 1e3))
                runs = {lab: {"dispatches": len(v),
                              "median_rows": statistics.median(r for r, _ in v),
                              "median_service_ms": round(statistics.median(t for _, t in v), 3)}
                        for lab, v in sorted(per.items())}
                _, stats = await self.request(conn, "GET", "/stats")
                p50 = {lab: round(r["p50_ms"], 3)
                       for lab, r in stats["schedulers"][self.name]["per_plan"].items()}
                codec = {key: round(statistics.median(v), 4) if v else None
                         for key, v in self.server.codec_ms.items()}
                log(f"listen loadgen --connections {c} --duration {LISTEN['loadgen_s']} (a "
                    f"subprocess): {json.dumps(summary)}; dispatches of the run {runs}; "
                    f"scheduler per-plan p50 ms from /stats (since start) {p50}; server codec "
                    f"ms a request, median: parse {codec['parse']}, encode {codec['encode']} "
                    f"[{self.smoke.card}]")
        finally:
            await conn.close()


PHASES = ("exact", "gist", "msmarco", "int8", "streamed", "mmap", "mutate", "serve",
          "listen", "tune", "kernels", "mesh", "lm", "train", "recsys", "gnn", "model_mesh")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (build always runs)")
    ap.add_argument("--package", type=Path, default=ROOT,
                    help="root of the checkout whose src/repro_torch is driven (default: "
                         "this script's)")
    args = ap.parse_args(argv)
    wanted = args.phases.split(",")
    if not set(wanted) <= set(PHASES):
        ap.error(f"unknown phases {sorted(set(wanted) - set(PHASES))}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.package.resolve() / "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.roofline.hw import H100_SXM
        from repro_torch.tuning import AutotuneCache, set_default_cache
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 2
    if torch.cuda.get_device_name(0) != H100_SXM.name:
        print(f"chip_smoke: the bounds are stated for {H100_SXM.name}, not for "
              f"{torch.cuda.get_device_name(0)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every phase plans with an empty in-memory autotune cache (the default
    # blocks and knobs whatever the machine's artifacts/autotune/ holds);
    # phase tune installs its own cache for itself alone
    set_default_cache(AutotuneCache(path=None))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    failed = []
    t0 = time.perf_counter()
    try:
        lib = build.build()
        log(f"phase build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
        build.load_library()
    except Exception:
        traceback.print_exc()
        failed.append("build")
    smoke = Smoke(torch, torch.device("cuda"), " ".join(smi)) if not failed else None
    for name in PHASES if smoke else ():
        if name not in wanted:
            continue
        t1 = time.perf_counter()
        try:
            if not getattr(smoke, f"phase_{name}")():
                failed.append(name)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        log(f"phase {name}: {time.perf_counter() - t1:.1f} s, "
            f"{'FAILED' if name in failed else 'ok'}")
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all, build included [{' '.join(smi)}]")
    if smoke is not None:
        log(json.dumps(smoke.kernels_line()))
    for line in smi:
        log(line)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
