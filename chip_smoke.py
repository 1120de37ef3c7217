#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result):
  1. device: card name, count, and nvidia-smi's name and power limit;
  2. build: every kernel source in ``src/repro_torch/csrc`` compiled
     with nvcc, one process per source, in parallel;
  3. parity at full width (B=512, N=1,000,448, m=8, b=256): each kernel
     against its plain PyTorch version on the same inputs on the card,
     values and ids bit-equal (tolerance 0) — k in {10, 100}, a
     tie-heavy quantised LUT, and for the pruned kernel identity,
     popularity-permuted and an overshooting warm floor (which must
     demote and still give the exact top-k);
  4. main path: the full-width RecJPQ two-tower model (random weights
     from a seeded generator) serves 20 fresh-id requests of B=512
     through the port's serve loop, once ``--fused`` and once
     ``--prune --perm --warm``; launch counters are zeroed just before
     each run and must show its kernel ran; one request is held against
     the materialise-then-top-k path (bit-equal);
  5. timing with CUDA events at the main path's shapes: kernel, plain
     version and the least time the card could take (bound); both
     kernels' general code path (uint8 codes at an odd address), held
     bit-equal to the 8-byte path and timed; ``jpq_topk``'s launch shape
     (the wrapper's record) and its time at k = 100; then the
     pruned kernel again on a skip-heavy full-width catalogue (codes that
     follow each item's rank, swept in popularity order; bit-equal to
     its plain version, skip map included), with the items it swept and
     the bound over the swept tiles, the tile bounds' own work included;
  6. parity of the training kernels on the card: jpq_scores forward at
     T=512 over the full catalogue (N=1,000,002), bit-equal to its plain
     version on normal and quantised LUTs; its backward against the
     plain version in float64 within the fp32 recursive-sum bound
     gamma(chain - 1) sum|terms| (chain: the longest run of adds into
     each output, a chunk's items of its bin and then the chunk
     partials), bit-identical across two calls, and over one item chunk
     its first 32 rows bit-equal to the plain version run on the CPU;
     jpq_lookup forward
     (bit-equal) and backward (bit-identical across two calls, bit-equal
     to its plain version run on CPU copies of its inputs, and within
     the float64 bound) at T=3,200;
  7. main path, training: full-width RecJPQ SASRec (d=512, 2 layers, 4
     heads, N=1,000,000 items, svd codebook over the synthetic data)
     trains through ``repro_torch.train.loop.Trainer`` for 1 + 20 steps
     of B=16 x S=200 with the full_ce loss; launch counters zeroed just
     before and each of the four training kernels must show launches;
     losses finite and falling; one step at B=2 held against the same
     step through PyTorch gathers (use_kernel=False); then score_last
     for 256 eval users through jpq_scores, NDCG@10 / HR@10, bit-equal
     to the plain version on the same LUT;
  8. the four training kernels at the main path's shapes (T=3,200, the
     trained weights, a training batch's ids): each held against its
     plain version as in phase 6 (jpq_scores' float64 backward in row
     blocks of 512); then kernel, plain version, bound, and one PyTorch
     library call timed, and for jpq_lookup and its backward also the
     card's own time of the kernel and of the library call under
     ``torch.profiler`` (``device_ms``, ``library_device_ms``); the
     jpq_scores forward's launch shape (queries a block, item ranges,
     blocks) at the training T and at score_last's T=256, and its time
     at both; the jpq_scores backward also timed over one item chunk,
     and its three kernels' device times under the profiler;
  9. embedding_bag parity on the card, bit-equal (tolerance 0) to its
     plain version: the two-tower user tower's shape (V=1,000,448,
     d=256, B=512, L=50, mask weights), FM's linear term (V=3,090,000,
     d=1, B=512, L=39, unit weights), FM's ``candidate_scores`` (one
     bag of L=38), B=65,536 at the two-tower shape, the ``mean`` combiner and ``weights=None`` through ``ops``, an
     all-padding bag over a negative pad row (-0.0), and an id outside
     [0, V) refused;
 10. embedding_bag timed at those four shapes (CUDA events): the kernel,
     the kernel with its id check, the plain version,
     ``F.embedding_bag`` and the bound (the distinct rows the ids name,
     read once); and the card's own time of the kernel and of
     ``F.embedding_bag`` under ``torch.profiler`` (``device_ms``,
     ``library_device_ms``);
 11. main path, CTR serving: two-tower-retrieval (full table), fm,
     fm-jpq, dlrm-rm2 (a 57.1 GB table), dlrm-rm2-jpq, dien and dien-jpq
     built at full width with ``make_model`` (random weights, seeded)
     and each serving 1 + 20 fresh requests of B=512 through
     ``serve_loop``, one model on the card at a time; launch counters
     zeroed before each run, and embedding_bag must show launches for
     the two-tower model and both FMs, whose output on one request is
     bit-equal with the plain version in the kernel's place; outputs
     finite, ``serve`` in [0, 1]; FM's ``candidate_scores`` and the
     DLRM and DIEN ``score_candidates`` over the 1,000,000-item field,
     once each, timed (FM's again with the plain version in the
     kernel's place, bit-equal); three more requests under ``torch.profiler`` give
     the card's busy time a request (its idle share against the p50)
     and the three largest device items.
Phases 12-15 run between phases 8 and 9, once SASRec's memory is freed:
 12. main path, the other two backbones: full-width RecJPQ BERT4Rec and
     GRU4Rec (SeqRecConfig defaults, phase 7's data and svd codebook,
     BERT4Rec's batches masked by ``mask_batch`` seeded from the step)
     train for 1 + 10 steps of B=16 x S=200, each checked as phase 7
     checks SASRec: launch counters zeroed just before, every training
     kernel launched, losses finite and falling, a B=2 step through the
     kernels against PyTorch gathers, and eval over 256 users (BERT4Rec
     at a [MASK] appended to the history) bit-equal to the kernel's
     scores on the same LUT; then a ``{"train_archs": ...}`` line;
 13. the quickstart example (``repro_torch.examples.quickstart``) at 50
     steps: both models' results finite, the training kernels launched;
 14. the serve_retrieval example as shipped (N=200,000, B=1/32/256):
     fused, materialise and pruned ids equal, fused values equal to
     materialise's, jpq_topk, jpq_topk_pruned and jpq_scores launched,
     the kernel's scores equal to the gathers';
 15. the paper-validation grid (2 profiles x 3 archs x 5 variants, 30
     runs at 30 steps; RecJPQ tables of b=64, dk=8): every NDCG@10
     finite, every RecJPQ run launching the training kernels (counters
     zeroed before each run); then a ``{"paper_validation": [...]}``
     line; then the four training kernels at every shape phases 13 and
     15 gave them (the quickstart's b=256 over 1,502 rows and the grid's
     b=64 over 242 and 2,002, training and eval, the eval T as the
     wrapper recorded it) and jpq_topk at serve_retrieval's, each held
     against its plain version (forwards bit-equal, backwards within
     the fp32 sum bound) and timed beside it and its bound (an
     ``{"example_shapes": ...}`` line).
Phases 16-22 run between phases 12 and 13, on phase 7's data and svd
codebook, one model on the card at a time:
 16-18. main path, SASRec's other objectives: full-width RecJPQ SASRec
     trains 1 + 10 steps with sampled_bce (one negative a position),
     code_ce, and full_ce + semantic_weight=0.5, each checked as phase 7
     checks SASRec, except that the jpq_scores pair must never launch in
     training where no [T, N] logits exist (sampled_bce, code_ce);
 19. full_ce at microbatches=2 (1 + 5 steps), checked the same way; the
     four training kernels at a slice's T = 1,600 held against their
     plain versions as phase 8 holds them, and timed; one step at
     microbatches=2 on [x; x] bit-equal to the single step on x; one
     step at microbatches=2 on a batch of 16 with distinct halves against
     the mean of the single steps on each half; then a
     ``{"seq_objectives": ...}`` line;
 20. checkpoints: a 6-step full_ce run; the save of its values and
     optimizer state timed and its bytes counted; a run sent a real
     SIGTERM while drawing step 3's batch stops with its checkpoint at
     step 3, and its resume ends bit-equal to the uninterrupted run; the
     checkpoint restored into a fresh model on the card (as
     ``launch/serve.py --ckpt-dir`` does) bit-equal; a ``{"checkpoint":
     ...}`` line;
 21. main path, the semantic-ID head: two-tower-retrieval-jpq at full
     width serves ``--head semantic`` (k = 10, auto beams) through
     ``serve_loop``, 1 + 20 requests of B=512, no sweep kernel launched;
     the code trie's build timed; on one more request every value
     bit-equal to the jpq_scores kernel's score of its id, and recall@10
     against ``--fused``; the exhaustive decode at 2,000 rows with
     duplicate codes bit-equal to jpq_topk;
 22. the SASRec of phase 20 through ``retrieve_topk``, fused and pruned,
     for 256 eval users, bit-equal to the top-10 of its ``score_last``;
     a ``{"semantic_serve": ...}`` line.
Phases 23-24 run after phase 11, one model on the card at a time:
 23. the embedding_bag backward on the card (the two-tower table,
     V=1,000,448, d=256, L=50, mask weights with ~10% pads; FM's linear
     term, V=3,090,000, d=1, L=39, unit weights; each at n_bags=65,536
     and 512; FM's with half of all ids on one row) and the table
     gathers' route through it (L=1, unit weights: DIEN's hist, hist_neg
     and target ids of one 32,768-row training slice over its 1,000,001
     rows at d=18, the same ids' flat centroid ids for DIEN-jpq over
     m*b=1,536 rows at dk=3, a 100,000-term run at d=18): bit-identical
     across two calls, bit-equal to its plain version run on CPU copies
     and within the fp32 recursive-sum bound of a float64 sum; timed by
     CUDA events (the whole call as autograd runs it, the kernels alone,
     the sort apart, the plain version, the one PyTorch call —
     ``F.embedding_bag``'s or ``F.embedding``'s backward —, ``torch.
     zeros`` + ``index_add_``, ``zero_`` of dtable, for a gather
     ``table[ids]``'s backward;
     the bytes bound and the chain bound: the longest run's dependent
     adds at 4 cycles each at nvidia-smi's clocks.max.sm) and under
     ``torch.profiler``;
 24. main path, CTR training: seven bundles at the reference's full
     width (two-tower-retrieval and -jpq, fm and -jpq, dlrm-rm2-jpq,
     dien and -jpq) train through ``Trainer`` at B=65,536, adamw lr
     3e-3, 1 + 5 steps, at the smallest power-of-two ``microbatches``
     whose warm-up step peaks under 70 GB; launch counters zeroed before
     the run, the embedding_bag backward launched for every bundle (the
     table gathers' route) and the forward for the two-tower model and
     both FMs, losses finite, DIEN's and DIEN-jpq's profiled step free of
     PyTorch's ``indexing_backward_kernel``, a B=64 step through
     the kernels against the plain versions in their place (loss within
     1e-5 relative, gradients within 1e-4 of each leaf's largest entry);
     the backward timed again at the main path's own ids; the
     arithmetic that keeps the full dlrm-rm2 off one card; a
     ``{"ctr_train": ...}`` line.
Phase 25 runs after phase 22, on the card beside phase 20's SASRec:
 25. main path, the request-level server: the full-width
     two-tower-retrieval-jpq model serves 400 single-user requests
     (Poisson at 500/s, the real clock) through ``launch/server
     .serve_requests``, the CLI's body, three times: (a) the CLI's
     defaults (pruned, ``--max-batch 8 --max-delay-ms 5``, one replica)
     with a non-blocking hot swap to a popularity-permuted catalogue
     after 200 requests (both versions serve, one swap, the build on a
     stream of its own; its seconds and the batches served meanwhile
     printed); (b) ``--prune --perm --warm --replicas 2 --merge-every
     4``; (c) ``--no-prune``; launch counters zeroed just before each
     timed run: ``jpq_topk_pruned`` launched in (a) (once a batch,
     the swap probe's launches, counted alone, taken off) and (b),
     ``jpq_topk`` and not the pruned kernel in (c); every response
     bit-equal to the request served alone (row 0 of an all-pad [8, L]
     batch, unpruned fused path) and to the plain scan of the batch it
     was served in (``ops.jpq_topk_scan``, no kernel); snapshot valid, completed = submitted,
     nothing dropped or duplicated, fewer batches than requests; p50 /
     p95 / p99, wall, occupancy, queue depth, skip fraction, warm-hit
     rate and the largest arrival-to-submit lag (``server.submit``
     wrapped); then phase 20's SASRec in one replica (buckets (100,
     200), 64 requests, some longer than 200), each response bit-equal
     to its alone-at-shape reference and to the top-10 of
     ``score_last``; then ``jpq_topk`` and ``jpq_topk_pruned`` held
     bit-equal to their plain versions (the pruned skip map too) and
     timed at B = 8 and 64 on real batches' LUTs beside their bounds,
     blocks,
     the pruned skip fraction and launches a request.
Phase 26 runs after phase 25, phase 7's data and codebook:
 26. main path, the training engine: ``Trainer`` with elastic specs on
     a mesh of one card (NCCL, ``launch.mesh.make_host_mesh``), V = 4
     virtual shards.  Full-width SASRec-RecJPQ, 3 steps a run: none and
     int8 under each overlap mode (none / dispatch / backward), bf16,
     and int8 + fsdp; launch counters zeroed just before each run and
     the jpq_scores and jpq_lookup pairs launched in every one; the
     modes bit-identical (values, moments, err); int8's err nonzero and
     finite; one exchange with fsdp within 2e-6 of dp's gradients
     with err bit-equal (none and int8; after the 3-step runs, max |d|
     recorded); none's gradients and loss after one step against the
     plain step at ``microbatches=4`` on the same batch (phase 19's
     microbatch limits: 1e-5 and 1e-4 of each leaf's largest entry),
     max |d| recorded; with clip_norm=None (no global norm in the
     update) int8 + fsdp bit-equal to int8 after the 3 steps; the four
     training kernels at a round's shape (T = 800: round 0 of step 0)
     held against their plain versions as phase 8 holds them; an int8
     run of 4 steps bit-equal to 2 + a checkpoint (train_spec stamp,
     err arrays) + a resume of 2.  Then the full-table and RecJPQ
     two-tower models at B = 65,536, int8, 2 steps each (the
     embedding_bag pair launched), and the embedding_bag kernels at a
     round's shape (16,384 bags of 50 over the 1,000,448 x 256 table,
     the item gather; RecJPQ's centroid gathers) held against their
     plain versions as phase 23 holds them.
     Each run: median step ms, peak GB, forward/backward and
     quantise_pack + combine ms by CUDA events, payload bytes a shard
     and a step, err bytes, the card; a ``{"engine": ...}`` line with
     each kernel's max |err| at the rounds' shapes.
Phase 27 runs last:
 27. main path, serving over a model-sharded catalogue: the ``--mesh
     S`` CLI's per-rank body (``serve._mesh_rank``, what
     ``launch/serve.serve_mesh`` spawns) with ``--share-card``, one task
     a mesh on the rank pools (``RankPool``: the 2- and 4-rank processes
     of phases 27-31 and 37-40, started here, once), running its cases in
     turn: S = 2 and 4 ranks time-share the one card as a (1, S) mesh,
     collectives over gloo staged through host memory (NCCL refuses two
     ranks on one device), the kernels built before they start; each rank builds phase 4's full-width model from the
     seed and keeps its rows of the catalogue.  two-tower-retrieval-jpq
     ``--fused`` and ``--prune --perm --warm`` (the global state at
     block_n 7,816, total_tiles = nt_loc x S) at each S, 20 requests of
     B = 512, every rank's every response bit-equal to the unsharded
     fused path on the same request; the full-table two-tower at S = 4
     through the row-sharded pooled_lookup (values within 1e-5 of the
     largest, ids at least 99% equal: the pooled sum runs over the
     ranks in another order); each rank launched its path's kernel;
     p50/p99 beside the unsharded path's, the collectives' ms, bytes and
     calls a request.  Then ``jpq_topk``, ``jpq_topk_pruned`` (its two
     launches around the threshold exchange) and ``embedding_bag`` at
     the last rank's shard shapes, bit-equal to their plain versions,
     timed beside their bounds (the kernels JSON's ``mesh_shape``).
Phase 28 runs after phase 27:
 28. main path, training on a ``"model"`` mesh axis (the Trainer's
     tensor parallelism: the catalogue's rows, the heads and the MLP's
     width split, the vocab-parallel cross-entropy), ranks time-sharing
     the one card over gloo staged through host memory, as
     ``launch/train.py --model-axis 2 --share-card`` runs them: (a)
     (1, 2) full-width RecJPQ SASRec ``full_ce``, 10 steps of phase 7's
     batches from phase 7's start, step 0's loss within 1e-5 relative
     of the (1, 1) step and its gathered gradient within ``leaf_rule``,
     the later losses beside phase 7's, each rank's peak at most 0.55 x
     64.40 GB, two runs bit-identical; (b) BERT4Rec, 5 steps, and (d)
     GRU4Rec, 3 steps, at (1, 2), step 0 against phase 12's; (c) (2, 2)
     SASRec on four ranks, step 0 against the (1, 1) step on the whole
     batch (the data group's counted rule); (e) (a)'s step-5 checkpoint resumed at (1, 2),
     bit-equal, and at (1, 1), its losses within 1e-4 relative; every
     rank launched the four training kernels; the collectives' ms,
     bytes and calls a step against their count.  Then the four
     training kernels at the shards' shapes (500,001 code rows, T =
     3,200 and 1,600), each against its plain version, timed beside its
     bound and library call (the kernels JSON's ``model_axis_shape``).
Phase 29 runs after phase 28:
 29. main path, the CTR and two-tower models on a ``"model"`` mesh axis,
     ranks time-sharing the one card (gloo staged), as ``launch/train.py
     --arch A --model-axis S --share-card`` runs them, phase 24's full
     widths and batches: (a) two-tower-retrieval and (b) its ``-jpq`` at
     (1, 2), B = 65,536 in 2 microbatches; (c) fm and fm-jpq and (d)
     dlrm-rm2-jpq at (1, 4); (e) dien and dien-jpq at (1, 2), B cut to
     32,768 (two ranks at phase 24's 41.25 GB do not fit); (f) fm at
     (2, 2); 3-4 steps each: step 0 within 1e-5 relative of the one-card
     step on the same batch, every rank's losses equal, the bag kernels
     launched on every rank, each rank's peak, step and collectives
     beside phase 24's; full-table dlrm-rm2 is left out (57 GB a
     rank).  Then ``launch/serve.py --mesh S`` (the CLI's per-rank body,
     ``serve._mesh_rank``) at S = 2 and 4 for fm, fm-jpq, dlrm-rm2-jpq,
     dien and dien-jpq, 20 requests of B = 512, every rank's every
     response bit-equal to the unsharded path (one pool task a world
     size runs its training jobs, each mesh made from the running group, then
     its serving); then the
     ``embedding_bag``
     forward and backward at the shards' shapes (the two-tower pool on
     a (1, 2) block, FM's table gather and linear term at (1, 4)),
     bit-equal to their plain versions, timed beside bound, plain and
     ``F.embedding_bag``, with the longest run the backward sees on a
     block and on one card (the kernels JSON's ``model_axis_ctr``).
Phases 30-31 run after phase 29:
 30. main path, the elastic exchange on a ``(D, S)`` mesh, ranks
     time-sharing the one card (gloo staged), the model replicated over
     ``"model"`` as the reference's ``shard_map`` runs it: phase 26's
     world-1 peaks printed first (a batch is cut only where the ranks'
     peaks would pass 75 GB together); SASRec int8, V = 4, 3 steps at
     (1, 1) on this process, then (b) int8 + fsdp, overlap
     ``backward``, at (2, 2) and (d) a SIGTERM on rank 3 of (2, 2) at
     step 2, then (a) int8 at (1, 2), (d) resumed there and (c)
     two-tower-retrieval-jpq int8 at phase 26's batch: every rank's
     values, moments and error state after each step bit-equal (sha1)
     to the same step at (1, 1); each rank's peak, the kernels launched
     on every rank, the median step beside phase 26's, the data group's
     collectives a step exactly as counted; then rows 3, 3b, 4, 4b at
     the SASRec round's shape and 5b at the two-tower round's against
     their plain versions;
 31. main path, the request server under ``--mesh S`` (S = 2, 4, ranks
     sharing the card): phase 25's model and settings, (a) pruned with
     a non-blocking hot swap before request 200, (c) ``--no-prune``,
     again at 100/s where S ranks cannot keep up at 500/s; every
     response bit-equal to the request served alone unsharded, none
     dropped or duplicated, every rank on rank 0's batches and
     versions; p50 / p95 / p99 beside phase 25's, a batch's broadcast
     and its serve's collectives; then both top-k kernels at the
     shards' shapes at B = 8 (the kernels JSON's ``server_mesh_shape``).
Phases 32-34 run last, the LM family (``models/lm.py``) at every
published width (d_model, heads, n_kv, head_dim, d_ff, experts, top_k,
vocab, window, rope_theta), depth and batch cut to one card:
 32. serving, bf16, ``no_grad``: each of mixtral-8x7b (2 layers),
     olmoe-1b-7b (4 of 16), stablelm-1.6b (4 of 24), qwen3-14b (4),
     stablelm-12b (4; depths cut for the script's time)
     runs ``prefill`` at S = 32,768, B = 1, and 64 ``decode_step``s
     against a random bf16 cache of 32,768 positions (B = 128, 4, 2,
     16, 8), ms, tokens/s and peak GB each; mixtral then decodes
     long_500k's last 8 positions from a ring cache at 524,280 whose
     bytes equal a 4,096-position cache's.  Check, the reference's
     test_decode_matches_full_forward at full width in fp32: mixtral at
     1 layer, S = 4,608 (across its 4,096-slot ring), and qwen3-14b at
     2 layers, S = 1,024, every position's decode logits within 2e-3 of
     the full forward's, mixtral at capacity_factor E / top_k (nothing
     drops; the drops at the configured 1.25 counted beside it);
 33. training through ``Trainer`` and adamw, bf16: (a) stablelm-1.6b at
     4 of its 24 layers (cut in PR 30 for phases 37-38's time), full
     table, B = 2, S = 4,096, 3 steps (step 0 near
     ln V, the token gather's bag backward every step, then held at the
     step's shape); (b) the same with a RecJPQ vocabulary (m 8, b 256,
     ``use_kernel=True``): jpq_scores and jpq_lookup, forward and
     backward, every step, then each held against its plain version at
     T = 8,192, N = 100,352 and timed, and ``ops.jpq_scores`` bit-equal
     to ``ref.jpq_scores_ref``; (c) olmoe-1b-7b at 2 layers, B = 1, S =
     4,096, 2 steps twice: bit-identical run to run, the bag backward
     19 times a step (the token gather, each layer's dispatch and 8
     combine gathers), then held at the dispatch gather's shape;
 34. ``launch/train.py --arch A --steps 2`` for each LM arch, the smoke
     config on the card.
Phases 35-36 run after them, MACE (``models/mace.py``) at its published
width (2 layers, C = 128, l_max 2, correlation 3, 8 RBFs, fp32, random
weights from seed 0) on three of ``configs/mace_arch``'s shapes, each
batch built once on the host and padded as ``SHAPES`` pads it:
molecule (128 molecules, 4,096 nodes, 8,192 edges, energy head),
full_graph_sm (Cora-sized, 3,072 / 10,752) and minibatch_lg (1,024 seeds
sampled with fanouts (15, 10) from a Reddit-sized graph, 169,984 /
168,960), saved on the host for phases 39-40; ogb_products needs more
cards than a run has:
 35. serving: ``MACE.serve`` 20 times a shape, median ms, peak GB, the
     card's busy share (``torch.profiler``) and the bag backward's
     launches a call (14 sums over receivers, and the sum over graphs);
     molecule's energies within 1e-4 of the largest against the same
     model on the CPU (plain versions), and under a random proper
     rotation and a shift of the positions; ``ops.segment_sum`` with the
     batch's order bit-equal to its plain version on CPU copies at each
     shape's ``[E, C·(2l+1)]``, l = 0, 1, 2; then ``launch/serve.py
     --arch mace`` for 5 requests;
 36. training through ``Trainer`` and adamw: 4 steps a shape, median
     step ms, peak GB, losses, the bag backward's launches a step (the
     15 sums and the 4 sender gathers' backward), one profiled step's
     busy share and top device items; minibatch_lg run twice from the
     same seed, the digest of every parameter and moment after every
     step equal; the segment sum and the gather backward timed at
     minibatch_lg's ``[E, 640]`` (``bag_bwd_row``: kernels, whole call,
     sort, plain, ``index_add_``, the library's backward, bounds); then
     ``launch/train.py --arch mace --steps 2`` and the example
     ``train_mace_molecule`` at 5 steps.
Phases 37-38 run next, the LMs on a ``(data, model)`` mesh at full
width (random weights from seed 0, depth cut), the ranks time-sharing
the one card (the rank pools: gloo staged through host memory), each
against one card on the same weights and tokens:
 37. training through ``Trainer`` and adamw, bf16: (a) stablelm-1.6b at
     2 layers, full table, (1, 2), B = 2, S = 4,096, 3 steps: losses
     finite, steps 0 and 1 within 1e-4 and 3e-4 relative of one card's
     ``Trainer`` on the same weights and batch, the token gather's
     backward (the bag backward, on the rank's vocabulary block) every
     step on each rank; (b) the same with a RecJPQ vocabulary (m 8, b
     256, ``use_kernel=True``): jpq_scores forward and backward and both
     jpq_lookup kernels every step on each rank; (c) olmoe-1b-7b at 2
     layers, (2, 2), B = 2 (1 a data rank), 2 steps, run twice: every
     rank's losses and blocks bit-identical run to run, the bag
     backward 19 times a step on each rank; (d) stablelm-1.6b at 2
     layers in fp32 (logits too, TF32 off) at (1, 2), 2 steps: both
     within 1e-5 relative of one card's; (e) olmoe-1b-7b at 2 layers,
     (1, 2), B = 2 (one routing group, as on one card), 2 steps: steps
     0 and 1 within 1e-4 and 3e-4 of one card's, the bag backward 19
     times a step; each rank's peak (the whole model's init included)
     with the allocator's slack and a context each, beside what the
     card held before the ranks started, within 75 GB; the collectives
     a step; then the four jpq
     kernels at a rank's T = 8,192, N = 50,176 against their plain
     versions (forwards bit-equal, backwards within the fp32 sum
     bound), the token gather's backward on a rank's 50,176-row block
     and the dispatch gather's at a rank's 32 experts' slots, bit-equal
     to their plain versions, timed beside their bounds;
 38. serving at (1, 2): ``prefill`` of 4,096 tokens and 16
     ``decode_step``s (B = 2, after a random cache of 4,096 positions)
     of stablelm-1.6b and olmoe-1b-7b (2 layers each), in fp32
     (logits and caches too) and in bf16: fp32's logits within 1e-4 of
     the largest |logit| of one card's, each rank's cache block (its kv
     heads) within 1e-4 of the same heads of one card's; bf16's, whose
     own rounding is coarser than that (one card's bf16 against its
     fp32), no further from one card's fp32 outputs than twice one
     card's bf16 are; prefill ms and decode ms a step beside one
     card's.
Phases 39-40 run last, MACE on a ``(data, model)`` mesh at full width
(fp32, TF32 off, the phase 35 batches), the ranks time-sharing the card
(gloo staged through host memory), each held against one card:
 39. training through ``Trainer`` and adamw (lr 1e-3), 3 steps a job, one
     pool task a world size whose ranks run each of its meshes in turn (a
     mesh made from the running group) and each mesh its shapes in turn:
     four ranks (4, 1) minibatch_lg, then (2, 2) molecule twice (then
     that pool ends); two ranks (2, 1) molecule, full_graph_sm and
     minibatch_lg, then (1, 2) molecule and minibatch_lg (only the
     readout split);
     each rank's share (``MACE.local_batch``: its node and edge blocks,
     the halo and the remote receivers exchanged over "data"); step 0
     within 1e-5 and steps 1-2 within 1e-4 relative of phase 36's one
     card on the same weights and graph, step 0's gradient summed over
     "data" within 1e-5 of each leaf's largest, the bag backward every
     step on every rank (a sum a path and the graph sum, a gather's
     backward an l a layer), (2, 2) bit-identical run to run, the ranks'
     need with the card's use before them (the waiting ranks' contexts
     in it) within 75 GB; step ms beside
     one card's, peaks, halo and owner-sum rows, the collectives a step;
     then the segment sum and the gather backward at the last rank's
     share of minibatch_lg at D = 2 and 4 against their plain versions
     (bit-equal), timed beside their bounds;
 40. ``launch/serve.py --arch mace --mesh 2 --share-card`` at full
     width, 5 requests of the shape's node count: molecule through the
     CLI's body, ``launch/serve.serve_mesh`` (its checks, the kernels'
     build, its spawn of 2 ranks), minibatch_lg through its ranks' body
     (``serve._mesh_rank``) on the 2-rank pool, which then ends: every
     rank's
     outputs within 1e-5 of the largest of the unsharded ``serve_loop``
     on the same requests, the bag backward every call.
Then JSON lines of the serving runs, the CTR serving runs, CTR
training, the request server (``{"server": ...}``), phase 27's
``{"mesh_serve": ...}``, phase 28's ``{"model_axis_train": ...}``,
phase 29's ``{"ctr_model_axis": ...}``, phase 30's
``{"elastic_mesh": ...}``, phase 31's ``{"server_mesh": ...}``,
phases 32-34's ``{"lm": ...}``, phases 35-36's ``{"mace": ...}``,
phases 37-38's ``{"lm_mesh": ...}``, phases 39-40's
``{"mace_mesh": ...}`` and the per-kernel numbers (eight kernels; rows 3-5b also carry phases
33's ``lm_shape`` and ``lm_launches`` and phase 37's ``lm_mesh_shape``
(a rank's shape, its launches a rank and run), the bag backward phase
36's ``mace_shape`` and phase 39's ``mace_mesh_shape`` and
``mace_mesh_launches_per_rank_step``; the two top-k kernels also carry
phase 25's ``server_shape`` and phase 31's ``server_mesh_shape``, rows
3-5 phase 26's ``elastic_launches`` and ``elastic_round_max_abs_err``
and phase 30's ``elastic_mesh_launches_per_rank`` and
``elastic_mesh_round_max_abs_err``), the
nvidia-smi line, and the result line ``{"ok":
true, "device": {...}}`` last.  Imports nothing of
JAX or of the JAX package.
"""
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

B, M, BC = 512, 8, 256            # serve_p99 batch, code length, centroids
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# fp32 outside the tensor cores: 67 TFLOP/s on the data sheet counts an
# FMA as 2 flops (132 SMs x 128 lanes x 2 x 1.98 GHz), so plain adds and
# maxes issue at half that.  A lookup in a per-query table (the LUT
# gather) goes through shared memory, 32 lanes per SM per clock: a
# quarter of the add rate.
FADD_PER_S = 67e12 / 2
LOOKUP_PER_S = 67e12 / 8
REQUESTS = 20
U = 2.0 ** -24                     # fp32 unit roundoff


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ok ({time.perf_counter() - t0:.1f}s)", flush=True)


def cuda_ms(fn, iters):
    """Mean ms per call over ``iters`` calls after one warm-up, by CUDA
    events."""
    import torch
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


def device_profile(torch, fn, reqs, attempts=6, pad_s=0.05, top_n=3,
                   names=None):
    """Run ``fn`` on each request under ``torch.profiler`` and return
    (device-busy ms per request: the summed durations of the kernels
    and copies the card ran, the top ``top_n`` of them by name as
    [(name, ms per request)]).  Busy 0 means the profiler traced no
    device activity in any of ``attempts`` sessions.

    The profiler keeps only the device records whose (converted) time
    stamps fall inside its capture window, so a window that holds no
    more than a millisecond of short kernels can come back empty.  Each
    session therefore waits ``pad_s`` of idle host time on both sides
    of the requests (no device work, so the busy time is unchanged),
    and a session that still traced nothing is run again (on an H100
    80GB HBM3 about a third of first sessions, and once all three of
    three, traced nothing).  ``names``: a
    dict to fill with every device item's full name and ms a request."""
    from torch.profiler import ProfilerActivity, profile
    reqs = list(reqs)
    per = {}
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            for r in reqs:
                fn(r)
            torch.cuda.synchronize()
            time.sleep(pad_s)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per[e.name] = (per.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
        if per:
            break
        print(f"   (the profiler traced no device time in session "
              f"{attempt + 1} of {attempts})")
    n = len(reqs) * 1e3
    if names is not None:
        names.update({k: v / n for k, v in per.items()})
    top = sorted(per.items(), key=lambda kv: -kv[1])[:top_n]
    return sum(per.values()) / n, [(k[:80], v / n) for k, v in top]


def odd_address(torch, x):
    """A contiguous copy of the uint8 tensor ``x`` at an odd address."""
    buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def bound(bytes_, ops):
    """(bound ms, bound_by): bytes over HBM against each operation type
    over its own rate (``ops``: {name: (count, rate)})."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = max([n / r * 1e3 for n, r in ops.values()], default=0.0)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bits_equal(a, b):
    """Two float32 tensors equal bit for bit."""
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def scores_fwd_err(P, codes, what):
    """jpq_scores against its plain version: bit-equal; returns the
    max |kernel - plain| of that comparison (0)."""
    import torch

    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    kern = sc.jpq_scores(P, codes)
    plain = sref.jpq_scores_lut_ref(P, codes)
    check(bits_equal(kern, plain), f"jpq_scores != plain ({what})")
    e = float(kern.sub_(plain).abs_().max())
    del kern, plain
    torch.cuda.empty_cache()
    return e


def scores_bwd_err(dS, codes, b, what):
    """jpq_scores' backward (``b`` centroids a split) as the training
    path calls it (item chunks picked for the card, ``sc.bwd_chunks``):
    bit-identical across two calls and |kernel - float64| <=
    gamma(chain - 1) sum|terms|, chain the longest run of fp32 adds into
    each output (``sc.bwd_chain``: a chunk's items of the bin, then the
    chunk partials).  Over one chunk: the same bound, and rows 0-31
    bit-equal to the plain version run on CPU copies (one chain in item
    order from +0.0).  The float64 plain version runs in row blocks of
    512.  Returns (max |err|, largest bound, longest chain, chunks)."""
    import torch

    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    T_, N_ = dS.shape
    chunks = sc.bwd_chunks(T_, codes.shape[1], b, N_, dS.device)
    d1 = sc.jpq_scores_bwd(dS, codes, b)
    check(bits_equal(d1, sc.jpq_scores_bwd(dS, codes, b)),
          f"jpq_scores backward differs between calls ({what})")
    want = torch.empty(d1.shape, dtype=torch.float64, device=dS.device)
    mass = torch.empty_like(want)
    for r in range(0, T_, 512):
        blk = dS[r:r + 512].double()
        want[r:r + 512] = sref.jpq_scores_lut_bwd_ref(blk, codes, b)
        mass[r:r + 512] = sref.jpq_scores_lut_bwd_ref(blk.abs_(), codes, b)
        del blk
    out = None
    for c, got in ((chunks, d1),
                   (1, sc.jpq_scores_bwd(dS, codes, b, chunks=1))):
        chain = sc.bwd_chain(codes, b, c)
        n = chain.double() - 1
        lim = (n * U / (1 - n * U)) * mass
        diff = (got.double() - want).abs()
        check(bool((diff <= lim).all()),
              f"jpq_scores backward outside the fp32 sum bound over "
              f"{c} chunks ({what})")
        if out is None:
            out = (float(diff.max()), float(lim.max()), int(chain.max()),
                   chunks)
        del lim, diff
    on_cpu = sref.jpq_scores_lut_bwd_ref(dS[:32].cpu(), codes.cpu(), b)
    check(bits_equal(got[:32].cpu(), on_cpu),
          f"jpq_scores backward over one chunk != plain on the CPU, "
          f"rows 0-31 ({what})")
    del d1, got, want, mass
    torch.cuda.empty_cache()
    return out


def lookup_errs(ids, codes, cent, dout, what):
    """jpq_lookup bit-equal to its plain version; its backward
    bit-identical across two calls, bit-equal to the plain version
    run on CPU copies of its inputs (both sum each entry's positions
    in ascending order from +0.0) and |kernel - float64| <=
    T u sum|terms|.  ``dout`` None: the forward alone.  Returns the max
    |err| of the forward and of the backward against float64 (None)."""
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_lookup import ref as lref
    kern = lc.jpq_lookup(ids, codes, cent)
    plain = lref.jpq_lookup_ref(ids, codes, cent)
    check(bits_equal(kern, plain), f"jpq_lookup != plain ({what})")
    e_fwd = float((kern - plain).abs().max())
    if dout is None:
        return e_fwd, None
    b = cent.shape[1]
    g1 = lc.jpq_lookup_bwd(ids, codes, dout, b)
    check(bits_equal(g1, lc.jpq_lookup_bwd(ids, codes, dout, b)),
          f"jpq_lookup backward differs between calls ({what})")
    on_cpu = lref.jpq_lookup_bwd_ref(ids.cpu(), codes.cpu(), dout.cpu(), b)
    check(bits_equal(g1.cpu(), on_cpu),
          f"jpq_lookup backward != plain on the CPU ({what})")
    want = lref.jpq_lookup_bwd_ref(ids, codes, dout.double(), b)
    mass = lref.jpq_lookup_bwd_ref(ids, codes, dout.double().abs(), b)
    diff = (g1.double() - want).abs()
    check(bool((diff <= ids.numel() * U * mass).all()),
          f"jpq_lookup backward outside the fp32 sum bound ({what})")
    return e_fwd, float(diff.max())


def slice_kernel_errs(torch, dev, model, params, seq, what):
    """The four training kernels at one slice's shape, T = rows of
    ``seq`` x S: jpq_scores on the LUT that ``model`` makes of ``seq``
    with ``params`` and its backward on a random [T, N] dS, jpq_lookup
    and its backward on seq's ids and a random dout, each held against
    its plain version as ``scores_fwd_err``, ``scores_bwd_err`` and
    ``lookup_errs`` hold them.  Returns (errs, inputs): {"T", each
    kernel's max |err|, the backward's bound, chain and chunks, the
    forward's launch shape} and {P, codes, cent, ids, dS, dout}."""
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.kernels.jpq_scores import cuda as sc
    T = seq.numel()
    gen = torch.Generator(device=dev).manual_seed(3)
    codes = params["item_emb"]["codes"]
    cent = params["item_emb"]["centroids"].detach()
    ids = seq.reshape(-1)
    with torch.no_grad():
        P = jpq_mod.partial_scores(params["item_emb"],
                                   model.encode(params, seq)).reshape(
            T, M, BC).contiguous()
    out = {"T": T, "jpq_scores_err": scores_fwd_err(P, codes, what),
           "jpq_scores_launch_shape": dict(sc.fwd_launch_shape)}
    dS = torch.randn((T, codes.shape[0]), generator=gen, device=dev)
    (out["jpq_scores_bwd_err"], out["jpq_scores_bwd_bound"],
     out["jpq_scores_bwd_chain"],
     out["jpq_scores_bwd_chunks"]) = scores_bwd_err(dS, codes, BC, what)
    dout = torch.randn((T, M, cent.shape[-1]), generator=gen, device=dev)
    out["jpq_lookup_err"], out["jpq_lookup_bwd_err"] = lookup_errs(
        ids, codes, cent, dout, what)
    return out, {"P": P, "codes": codes, "cent": cent, "ids": ids,
                 "dS": dS, "dout": dout}


def train_kernel_work(T, N, b, dk):
    """The least work of each training kernel at T positions over N code
    rows of ``M`` codes, ``b`` centroids of ``dk`` floats a split:
    {name: (bytes, {op type: (count, rate)})}, inputs read once and
    outputs written once."""
    lut_b, out_b = T * M * b * 4, T * N * 4
    # the ids, the code rows they name, the centroids, the output
    look_b = T * 8 + T * M + M * b * dk * 4 + T * M * dk * 4
    return {
        "jpq_scores": (N * M + lut_b + out_b,
                       {"LUT lookups": (T * N * M, LOOKUP_PER_S),
                        "fp32 adds": (T * N * (M - 1), FADD_PER_S)}),
        "jpq_scores_bwd": (out_b + N * M + lut_b,
                           {"histogram updates": (T * N * M, LOOKUP_PER_S),
                            "fp32 adds": (T * N * M, FADD_PER_S)}),
        "jpq_lookup": (look_b, {}),
        "jpq_lookup_bwd": (look_b, {"fp32 adds": (T * M * dk, FADD_PER_S)}),
    }


def topk_work(Bq, N, k):
    """(bytes, fp32 adds, LUT lookups) of the unpruned fused top-k of
    ``Bq`` queries over N code rows: the codes and LUTs read once, the
    values and ids written once, one lookup and add a (query, item,
    split)."""
    return N * M + Bq * M * BC * 4 + Bq * k * 8, Bq * N * M, Bq * N * M


def pruned_work(torch, st, skip, Bq, k):
    """(bytes, fp32 adds, LUT lookups, swept items) of a pruned sweep of
    ``Bq`` queries over the state ``st`` whose skip map [groups, tiles]
    is ``skip``: only the (group, tile) pairs it swept, plus every
    tile's bound (its LUT reads and max/add)."""
    from repro_torch.kernels.jpq_topk import cuda as kc
    group = kc.pruned_group_size()        # queries per block (the library's)
    n_rows, dev = st.codes.shape[0], skip.device
    nt = st.present.shape[0]
    tile_items = torch.full((nt,), st.block_n, device=dev)
    tile_items[-1] = n_rows - (nt - 1) * st.block_n
    rows_per_group = torch.full((skip.shape[0],), group, device=dev)
    rows_per_group[-1] = Bq - group * (skip.shape[0] - 1)
    swept = (1 - skip).to(torch.int64)
    scored = int((swept * tile_items[None, :] * rows_per_group[:, None]
                  ).sum()) * M                  # (query, item, split)s
    lookups = scored + Bq * nt * M * BC       # + the bound's LUT reads
    adds = scored + Bq * nt * M * (BC + 1)    # + the bound's max/add
    items = int(((1 - skip.min(0).values) * tile_items).sum())
    bytes_ = (items * (M + 4) + nt * M * BC * 4 + Bq * M * BC * 4 + Bq * 4
              + 2 * Bq * k * 8)
    return bytes_, adds, lookups, items


def bound_of(bytes_, adds, lookups):
    """(bound ms, bound_by, (bytes ms, adds ms, lookups ms)) of a top-k
    sweep: its bytes over HBM against its fp32 adds and its LUT lookups,
    each over its own rate."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_adds = adds / FADD_PER_S * 1e3
    t_lookups = lookups / LOOKUP_PER_S * 1e3
    t_ops = max(t_adds, t_lookups)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            (t_bytes, t_adds, t_lookups))


def full_two_tower(arch, device):
    """The arch's model at full width (random weights from seed 0) and
    phase 4's request template: Zipf-skewed history ids, the popularity
    tally --perm sweeps by.  Module-level and deterministic, so phase
    27's ranks (``launch.serve.serve_mesh``'s ``make``) build the same."""
    import numpy as np

    from repro_torch.configs import get_bundle
    model = get_bundle(arch).make_model(device=device, seed=0)
    rng = np.random.default_rng(0)
    template = {"user_hist": (rng.zipf(1.2, (B, model.cfg.hist_len)) - 1)
                % model.cfg.n_items + 1}
    return model, template


# the full-width training configuration (the repo's SeqRecConfig defaults
# with the paper's RecJPQ table) and its batch
N_ITEMS, SEQ_LEN, TRAIN_B = 1_000_000, 200, 16
EVAL_USERS, TRAIN_STEPS = 256, 20


def train_phases(torch, np, dev, smi):
    """Phases 6-8: the training kernels' parity, the training main path
    and the kernels' timing.  Returns (their entries of the kernels line,
    the synthetic data, the svd codebook, the main path's summary),
    which phases 12 and 28 reuse."""
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.core.assign import build_codebook
    from repro_torch.data.sequences import SeqDataConfig, SyntheticSequences
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_lookup import ref as lref
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    from repro_torch.models.sequential import _xent

    err = {}
    n_rows = N_ITEMS + 2
    T = TRAIN_B * SEQ_LEN
    dk = 512 // M
    gen = torch.Generator(device=dev).manual_seed(2)

    t0 = phase(f"training kernels' parity: jpq_scores T=512 N={n_rows}, "
               f"jpq_lookup T={T}")
    codes = torch.randint(0, BC, (n_rows, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    luts = {"normal": torch.randn((512, M, BC), generator=gen, device=dev),
            "quantised": torch.randint(-2, 3, (512, M, BC), generator=gen,
                                       device=dev).float()}
    err["jpq_scores"] = max(scores_fwd_err(P, codes, f"{name} LUT, T=512")
                            for name, P in luts.items())
    del luts
    dS = torch.randn((512, n_rows), generator=gen, device=dev)
    err["jpq_scores_bwd"], worst, chain, chunks = scores_bwd_err(
        dS, codes, BC, "T=512")
    print(f"   jpq_scores: forward bit-equal (normal, quantised LUT); "
          f"backward over {chunks} item chunks deterministic, max |err| vs "
          f"float64 {err['jpq_scores_bwd']:.3e} (bound gamma(chain - 1) "
          f"sum|dS|, longest chain {chain}, largest {worst:.3e}); over one "
          f"chunk within its bound, rows 0-31 bit-equal to plain on the CPU")
    del dS
    cent = torch.randn((M, BC, dk), generator=gen, device=dev)
    ids = torch.randint(0, n_rows, (T,), generator=gen, device=dev)
    ids[: T * 9 // 10] = 0                 # the main path's left padding
    ids = ids[torch.randperm(T, generator=gen, device=dev)]
    dout = torch.randn((T, M, dk), generator=gen, device=dev)
    err["jpq_lookup"], err["jpq_lookup_bwd"] = lookup_errs(
        ids, codes, cent, dout, f"T={T}")
    print(f"   jpq_lookup: forward bit-equal; backward bit-equal to plain "
          f"on the CPU, deterministic, max |err| vs float64 "
          f"{err['jpq_lookup_bwd']:.3e}")
    del codes, cent, ids, dout
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase(f"main path: full-width RecJPQ SASRec training, B={TRAIN_B} "
               f"S={SEQ_LEN} N={N_ITEMS}, 1 + {TRAIN_STEPS} steps")
    t1 = time.perf_counter()
    data = SyntheticSequences(SeqDataConfig(n_items=N_ITEMS,
                                            seq_len=SEQ_LEN, seed=0))
    t_data = time.perf_counter() - t1
    u, i = data.train_interactions()
    t1 = time.perf_counter()
    codes_np = build_codebook("svd", n_rows, M, BC, interactions=(u, i + 1),
                              n_users=data.n_users_eff, seed=0)
    t_codes = time.perf_counter() - t1
    print(f"   set-up on the host: data {t_data:.1f}s "
          f"({data.n_users_eff} users, {len(u)} train interactions), "
          f"svd codebook {t_codes:.1f}s")
    model, params, run = seq_main_path(torch, np, dev, smi, data, codes_np,
                                       "sasrec", TRAIN_STEPS)
    losses, step_ms, peak_gb, launches, ndcg, hr = (
        run[k] for k in ("losses", "median_step_ms", "peak_gb", "launches",
                         "ndcg10", "hr10"))
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase("the training kernels at the main path's shapes: parity, "
               "then timing (CUDA events)")
    codes = params["item_emb"]["codes"]
    cent = params["item_emb"]["centroids"].detach()
    batch = data.train_batch(0, TRAIN_B)
    seq = torch.as_tensor(batch["seq"], device=dev)
    ids = seq.reshape(-1)
    with torch.no_grad():
        P = jpq_mod.partial_scores(params["item_emb"],
                                   model.encode(params, seq)).reshape(
            T, M, BC).contiguous()
    # the kernels against their plain versions on these inputs, one
    # output alive at a time
    err["jpq_scores"] = max(err["jpq_scores"],
                            scores_fwd_err(P, codes, f"main path, T={T}"))
    dS = torch.randn((T, n_rows), generator=gen, device=dev)
    e, worst, chain, chunks = scores_bwd_err(dS, codes, BC,
                                             f"main path, T={T}")
    err["jpq_scores_bwd"] = max(err["jpq_scores_bwd"], e)
    print(f"   at T={T}: jpq_scores forward bit-equal to plain on the "
          f"trained LUT; backward over {chunks} item chunks deterministic, "
          f"max |err| vs float64 {e:.3e} (largest bound {worst:.3e}, "
          f"longest chain {chain}); over one chunk within its bound, rows "
          f"0-31 bit-equal to plain on the CPU")
    dout = torch.randn((T, M, dk), generator=gen, device=dev)
    e, e_bwd = lookup_errs(ids, codes, cent, dout, f"main path, T={T}")
    err["jpq_lookup"] = max(err["jpq_lookup"], e)
    err["jpq_lookup_bwd"] = max(err["jpq_lookup_bwd"], e_bwd)
    print(f"   at T={T}: jpq_lookup forward bit-equal to plain on the "
          f"batch's ids and trained centroids; backward bit-equal to plain "
          f"on the CPU, deterministic, max |err| vs float64 {e_bwd:.3e}")
    # the one-hot of the codes as a sparse [N, m*b] matrix (and its
    # transpose): one library call computes scores (transposed) and dP
    col = (codes.long() + BC * torch.arange(M, device=dev)).reshape(-1)
    onehot = torch.sparse_csr_tensor(
        torch.arange(0, n_rows * M + 1, M, device=dev), col,
        torch.ones(n_rows * M, device=dev), size=(n_rows, M * BC),
        check_invariants=False)
    onehot_t = onehot.to_sparse_coo().t().coalesce().to_sparse_csr()
    flat = (codes[ids].long() + BC * torch.arange(M, device=dev)).reshape(-1)
    cent2 = cent.reshape(M * BC, dk)
    P2t = P.reshape(T, M * BC).t().contiguous()
    lookup_fns = {   # the kernel and its library call
        "jpq_lookup": (lambda: lc.jpq_lookup(ids, codes, cent),
                       lambda: torch.index_select(cent2, 0, flat)),
        "jpq_lookup_bwd": (
            lambda: lc.jpq_lookup_bwd(ids, codes, dout, BC),
            lambda: torch.zeros_like(cent2).index_add_(
                0, flat, dout.reshape(T * M, dk))),
    }
    # the forward's time at the training T and at score_last's T, each
    # beside the launch shape the wrapper recorded (cuda.fwd_launch_shape:
    # queries a block, item ranges, blocks)
    fwd_shape = {"train": {"ms": cuda_ms(lambda: sc.jpq_scores(P, codes), 5),
                           **sc.fwd_launch_shape}}
    P_eval = P[:EVAL_USERS].contiguous()
    fwd_shape["eval"] = {"ms": cuda_ms(lambda: sc.jpq_scores(P_eval, codes),
                                       10), **sc.fwd_launch_shape}
    del P_eval
    for what, f in fwd_shape.items():
        print(f"   jpq_scores forward at T={f['T']} ({what}): {f['ms']:.4f} "
              f"ms; G={f['G']} queries a block, {f['item_ranges']} item "
              f"ranges of {f['items_per_block']} items, {f['blocks']} blocks "
              f"on {f['sms']} SMs")
    # its general code path (codes read a byte at a time), which uint8
    # codes at m = 8 take when their rows are not 8-byte aligned
    codes_odd = odd_address(torch, codes)
    check(bits_equal(sc.jpq_scores(P[:512], codes_odd),
                     sc.jpq_scores(P[:512], codes)),
          "jpq_scores' general path != its 8-byte path (T=512)")
    fwd_general_ms = cuda_ms(lambda: sc.jpq_scores(P, codes_odd), 5)
    print(f"   jpq_scores forward, general code path (codes at an odd "
          f"address): {fwd_general_ms:.4f} ms at T={T}, bit-equal to the "
          f"8-byte path at T=512 ({fwd_shape['train']['ms']:.4f} ms at "
          f"T={T})")
    del codes_odd
    times = {
        "jpq_scores": (
            fwd_shape["train"]["ms"],
            cuda_ms(lambda: sref.jpq_scores_lut_ref(P, codes), 2),
            cuda_ms(lambda: torch.sparse.mm(onehot, P2t), 2)),
        "jpq_scores_bwd": (
            cuda_ms(lambda: sc.jpq_scores_bwd(dS, codes, BC), 3),
            cuda_ms(lambda: sref.jpq_scores_lut_bwd_ref(dS, codes, BC), 2),
            cuda_ms(lambda: torch.sparse.mm(onehot_t, dS.t()), 2)),
        "jpq_lookup": (
            cuda_ms(lookup_fns["jpq_lookup"][0], 50),
            cuda_ms(lambda: lref.jpq_lookup_ref(ids, codes, cent), 20),
            cuda_ms(lookup_fns["jpq_lookup"][1], 50)),
        "jpq_lookup_bwd": (
            cuda_ms(lookup_fns["jpq_lookup_bwd"][0], 50),
            cuda_ms(lambda: lref.jpq_lookup_bwd_ref(ids, codes, dout, BC), 20),
            cuda_ms(lookup_fns["jpq_lookup_bwd"][1], 50)),
    }
    # the backward over one item chunk (one chain an output, bit-equal
    # to the CPU's index_add_; 200 blocks, a wave and a half on 132 SMs)
    one_chunk_ms = cuda_ms(
        lambda: sc.jpq_scores_bwd(dS, codes, BC, chunks=1), 3)
    print(f"   jpq_scores_bwd over one chunk: {one_chunk_ms:.4f} ms (over "
          f"{chunks}, as the training path runs it: "
          f"{times['jpq_scores_bwd'][0]:.4f} ms)")
    # the card's time in each of the backward's kernels (the sort, the
    # sums, the chunk reduction) under torch.profiler
    bwd_dev_ms, bwd_top = device_profile(
        torch, lambda _: sc.jpq_scores_bwd(dS, codes, BC), range(3))
    check(bwd_dev_ms > 0, "the profiler traced no device time for "
          "jpq_scores_bwd")
    print(f"   jpq_scores_bwd: device {bwd_dev_ms:.4f} ms a call: "
          + "; ".join(f"{k} {v:.4f}" for k, v in bwd_top))
    # the card's own time a call (torch.profiler: the summed durations of
    # the kernels a call ran) for the two small kernels and their library
    # calls, whose event times above may be the host's issue time
    dev_times = {}
    for name, fns in lookup_fns.items():
        (k_ms, k_top), (l_ms, l_top) = (
            device_profile(torch, lambda _, f=f: f(), range(50)) for f in fns)
        check(k_ms > 0, f"the profiler traced no device time for {name}")
        check(l_ms > 0, f"the profiler traced no device time for {name}'s "
              f"library call")
        dev_times[name] = {"device_ms": k_ms, "library_device_ms": l_ms}
        print(f"   {name}: device {k_ms:.4f} ms a call ({k_top[0][0]}); "
              f"library device {l_ms:.4f} ms ("
              + "; ".join(f"{k} {v:.4f}" for k, v in l_top) + ")")
    work = train_kernel_work(T, n_rows, BC, dk)
    line = {"jpq_scores": 60, "jpq_lookup": 62}
    out = []
    for name, (ms, plain_ms, lib_ms) in times.items():
        base = name.replace("_bwd", "")
        b_ms, b_by = bound(*work[name])
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{base}.cu",
            "replaces": f"src/repro/kernels/{base}/{base}.py:{line[base]}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms})
        dev_note = ""
        if name == "jpq_scores":
            out[-1]["launch_shape"] = fwd_shape
            out[-1]["general_path_ms"] = fwd_general_ms
        if name in dev_times:
            out[-1].update(dev_times[name])
            dev_note = " (device {device_ms:.4f} ms, library device " \
                "{library_device_ms:.4f} ms)".format(**dev_times[name])
        print(f"   {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"{lib_ms:.4f} ms library{dev_note}, bound {b_ms:.4f} ms "
              f"({b_by}), {launches[name]} launches in the training run, "
              f"T={T} on {smi}")
    print("   library calls: torch.sparse.mm with the codes' one-hot (CSR) "
          "for jpq_scores (output transposed) and its backward; "
          "index_select / index_add_ on a precomputed flat index for "
          "jpq_lookup and its backward")
    # what a step spends: the four kernels once each, the cross-entropy
    # forward and backward over [T, N] logits, and the encoder's forward
    # and backward, each timed alone at the step's shapes
    del dS, dout, onehot, onehot_t, P2t
    torch.cuda.empty_cache()
    labels = torch.as_tensor(batch["labels"], device=dev)
    valid = labels > 0
    logits = torch.randn((TRAIN_B, SEQ_LEN, n_rows), generator=gen,
                         device=dev).requires_grad_()

    def ce_pass():
        ce = _xent(logits, labels)
        torch.autograd.grad(torch.sum(ce * valid) / valid.sum(), logits)

    enc = list(model.parameters())
    split = {"kernels": sum(times[n][0] for n in times),
             "cross-entropy": cuda_ms(ce_pass, 3),
             "encoder": cuda_ms(lambda: torch.autograd.grad(
                 model.encode(params, seq).sum(), enc), 5)}
    del logits
    print(f"   step split (each part alone, ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; median step {step_ms:.1f} ms")
    print(json.dumps({"train": {
        "losses": losses, "median_step_ms": step_ms, "peak_gb": peak_gb,
        "launches": launches, "ndcg10": ndcg, "hr10": hr,
        "step_split_ms": split, "jpq_scores_bwd_chunks": chunks,
        "jpq_scores_bwd_one_chunk_ms": one_chunk_ms,
        "jpq_scores_bwd_device_ms": bwd_dev_ms,
        "jpq_scores_bwd_device_top": bwd_top, "card": smi}}))
    done(t0)
    return out, data, codes_np, run


# the paper's two other backbones at full width (SeqRecConfig defaults,
# the same RecJPQ table, data and codebook as phase 7), and the
# paper-validation grid's steps on the card
ARCHS, ARCH_STEPS, GRID_STEPS = ("bert4rec", "gru4rec"), 10, 30


def full_width_model(codes_np, dev, arch="sasrec", **kw):
    """Full-width RecJPQ ``arch`` (SeqRecConfig defaults, the svd codebook
    ``codes_np``, ``use_kernel=True``; ``kw`` more config fields) drawn
    from the seeded generator SeqRecModel defaults to."""
    from repro_torch.core import EmbeddingConfig
    from repro_torch.models.sequential import SeqRecConfig, SeqRecModel
    cfg = SeqRecConfig(arch=arch, n_items=N_ITEMS, max_len=SEQ_LEN,
                       embedding=EmbeddingConfig(0, 0, kind="jpq", m=M, b=BC,
                                                 assignment="svd",
                                                 use_kernel=True), **kw)
    return SeqRecModel(cfg, codes=codes_np, device=dev)


def free_card(torch, dev, what):
    """Collect and empty the cache; fail unless under 2 GB is left
    allocated before ``what`` runs."""
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated(dev) < 2e9,
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB still "
          f"allocated before {what}")


# ---------------------------------------------------------------- rank pools
# Phases 27-31 and 37-40 hand their rank functions to one pool of rank
# processes a world size (2 and 4), started at phase 27 and ended in
# phases 39-40, where a spawn a run paid every rank's start (the
# interpreter, torch, the card's context, the process group) again.
POOLS: dict = {}


def pool_worker(rank, n, store_path, device, task_dir):
    """One rank of a ``RankPool`` (module-level: it is pickled): join
    the pool's group (several ranks on one card: gloo staged), mark
    ``ready.<rank>``, then run each ``task_dir/task<i>.pkl`` = (fn, args,
    model) in turn as ``fn(mesh, *args)``, ``mesh`` a new ``HostMesh`` of
    ``(n // model, model)`` over the group (the axis groups made once a
    shape), from the state a new rank process starts in (the launch
    counters zeroed, the global generators at their first seed, the peak
    memory reset); after it the card is left empty and
    ``done<i>.<rank>`` written, or ``error<i>.<rank>`` with the
    traceback if it raised.  Task None: leave the group."""
    import pickle
    import traceback

    import torch
    import torch.distributed as tdist

    from repro_torch.core import semantic
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.launch import mesh as mesh_mod
    dev = torch.device(device)
    share = dev.type == "cuda"
    mesh_mod.init_group(rank, n, store_path, dev, share)
    torch.zeros(1, device=dev)                     # the card's context
    open(os.path.join(task_dir, f"ready.{rank}"), "w").close()
    seed, groups, i = torch.initial_seed(), {}, 0
    while True:
        i += 1
        path = os.path.join(task_dir, f"task{i}.pkl")
        while not os.path.exists(path):
            time.sleep(0.01)
        with open(path, "rb") as f:
            task = pickle.load(f)
        if task is None:
            break
        fn, args, model = task
        if model not in groups:
            groups[model] = mesh_mod.axis_groups(n // model, model, rank)
        mesh = mesh_mod.HostMesh(
            n // model, model, rank=rank, group=tdist.group.WORLD,
            device=dev, transport=mesh_mod.transport_for(dev, share),
            groups=groups[model])
        for c in (ec, lc, sc, kc):
            c.reset_launches()
        torch.manual_seed(seed)
        if share:
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            fn(mesh, *args)
        except BaseException:
            with open(os.path.join(task_dir, f"error{i}.{rank}"), "w") as f:
                f.write(traceback.format_exc())
            raise
        del mesh, fn, args, task
        gc.collect()
        semantic.clear_index_cache()
        if share:
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
        open(os.path.join(task_dir, f"done{i}.{rank}"), "w").close()
    gc.collect()
    tdist.barrier()
    tdist.destroy_process_group()


class RankPool:
    """``n`` rank processes on ``dev`` (a CUDA ``dev``: all on its card,
    as ``launch.mesh.spawn`` with ``share_card`` runs them), started
    once; ``run`` hands them one rank function after another, ``close``
    ends them."""

    def __init__(self, n, dev):
        import tempfile

        import torch.multiprocessing as mp
        self.n, self.i = n, 0
        self.dir = tempfile.mkdtemp(prefix=f"chip_smoke_pool{n}-")
        self.ctx = mp.start_processes(
            pool_worker, args=(n, os.path.join(self.dir, "store"), str(dev),
                               self.dir),
            nprocs=n, join=False, start_method="spawn")

    def _wait(self, marks, timeout, what):
        """Until every file of ``marks`` exists in the pool's directory;
        raises if a rank wrote its task's error, a rank process ended, or
        ``timeout`` seconds passed."""
        deadline = time.monotonic() + timeout
        while not all(os.path.exists(os.path.join(self.dir, m))
                      for m in marks):
            ended = [r for r, p in enumerate(self.ctx.processes)
                     if not p.is_alive()]
            errs = sorted(f for f in os.listdir(self.dir)
                          if f.startswith(f"error{self.i}."))
            if errs:
                with open(os.path.join(self.dir, errs[0])) as f:
                    raise RuntimeError(f"chip_smoke: {what} failed on rank "
                                       f"{errs[0].split('.')[1]} of "
                                       f"{self.n}:\n{f.read()}")
            if ended:
                raise RuntimeError(
                    f"chip_smoke: rank processes {ended} of the {self.n}-"
                    f"rank pool ended during {what} (exit codes "
                    f"{[self.ctx.processes[r].exitcode for r in ended]})")
            if time.monotonic() > deadline:
                raise TimeoutError(f"chip_smoke: {what} on {self.n} ranks "
                                   f"still running after {timeout} s")
            time.sleep(0.02)

    def ready(self, timeout=300):
        self._wait([f"ready.{r}" for r in range(self.n)], timeout,
                   "the pool's start")

    def run(self, fn, args=(), *, model=1, timeout=900):
        """``fn(mesh, *args)`` on every rank, ``mesh`` an ``(n // model,
        model)`` mesh; returns when every rank has finished it."""
        import pickle
        self.ready()
        self.i += 1
        path = os.path.join(self.dir, f"task{self.i}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump((fn, tuple(args), model), f)
        os.replace(path + ".tmp", path)
        self._wait([f"done{self.i}.{r}" for r in range(self.n)], timeout,
                   fn.__name__)

    def close(self, timeout=60):
        """Hand the ranks the end task and wait ``timeout`` seconds for
        them to leave their group (0: not at all); kill whatever is
        left."""
        import pickle
        import shutil
        if self.ctx is None:
            return
        try:
            if timeout and all(p.is_alive() for p in self.ctx.processes):
                self.i += 1
                path = os.path.join(self.dir, f"task{self.i}.pkl")
                with open(path + ".tmp", "wb") as f:
                    pickle.dump(None, f)
                os.replace(path + ".tmp", path)
                deadline = time.monotonic() + timeout
                for p in self.ctx.processes:
                    p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            shutil.rmtree(self.dir, ignore_errors=True)
            self.ctx = None


def start_pools(dev, sizes):
    """Start a pool of each size in ``sizes`` not running yet, all
    together, and wait until every rank has joined its group."""
    for n in sizes:
        if n not in POOLS:
            POOLS[n] = RankPool(n, dev)
    for n in sizes:
        POOLS[n].ready()


def run_ranks(fn, n, args, dev, *, model, timeout):
    """``fn(mesh, *args)`` on the ``n``-rank pool (started here if it is
    not running), ``mesh`` an ``(n // model, model)`` mesh."""
    start_pools(dev, (n,))
    POOLS[n].run(fn, args, model=model, timeout=timeout)


def close_pools(timeout=60):
    """End every pool (``RankPool.close``)."""
    while POOLS:
        POOLS.popitem()[1].close(timeout)


def seq_main_path(torch, np, dev, smi, data, codes_np, arch, steps, *,
                  loss="full_ce", semantic_weight=0.0, microbatches=1):
    """Train full-width RecJPQ ``arch`` (SeqRecConfig defaults, the svd
    codebook ``codes_np``, ``use_kernel=True``; ``loss``,
    ``semantic_weight`` and ``microbatches`` as given) for 1 + ``steps``
    steps of B=16 x S=200 through ``Trainer``, the launch counters zeroed
    just before: the jpq_lookup pair launched, and the jpq_scores pair
    launched exactly when the objective builds [T, N] logits (full_ce),
    else never; the losses finite and falling.  Then one step at B=2
    through the kernels against PyTorch gathers on the trained weights
    (loss within 1e-5 relative, every gradient within 1e-4 of its
    largest entry: the sums run in other orders), and ``score_last``
    for 256 eval users through jpq_scores, bit-equal to the kernel's
    scores on the same LUT (pad and [MASK] columns masked), with NDCG@10
    and HR@10.  BERT4Rec's batches are masked by ``mask_batch`` with a
    generator seeded from the step, as the train CLI masks them;
    sampled_bce's carry ``n_negatives`` negatives a position, as
    ``train_batch`` draws them.  Returns (model, params, summary)."""
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    from repro_torch.models.sequential import SeqRecModel, mask_batch
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.metrics import hr_at_k, ndcg_at_k
    from repro_torch.train.optimizer import OptConfig

    model = full_width_model(codes_np, dev, arch, loss=loss,
                             semantic_weight=semantic_weight)
    cfg = model.cfg
    what = arch if (loss, semantic_weight, microbatches) == \
        ("full_ce", 0.0, 1) else (f"{arch} {loss} semantic_weight="
                                  f"{semantic_weight} microbatches="
                                  f"{microbatches}")

    def batch_fn(B):
        def fn(s):
            if loss == "sampled_bce":
                return data.train_batch(s, B, n_negatives=cfg.n_negatives)
            b = data.train_batch(s, B)
            if arch != "bert4rec":
                return b
            seq = torch.as_tensor(b["seq"], device=dev)
            ms, tg = mask_batch(torch.Generator(device=dev).manual_seed(s),
                                seq, cfg.mask_prob, cfg.mask_id)
            return {"seq": ms, "targets": tg}
        return fn

    trainer = Trainer(model, OptConfig(lr=3e-3),
                      TrainConfig(steps=1 + steps, batch_size=TRAIN_B,
                                  log_every=1, eval_every=0,
                                  microbatches=microbatches),
                      data_fn=batch_fn(TRAIN_B))
    torch.cuda.reset_peak_memory_stats(dev)
    sc.reset_launches()
    lc.reset_launches()
    params, hist = trainer.run(
        generator=torch.Generator(device=dev).manual_seed(0))
    launches = {**sc.launches, **lc.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # the input side (and sampled_bce's labels and negatives) always
    # goes through jpq_lookup; only full_ce builds [T, N] logits
    logits = loss == "full_ce" or arch == "bert4rec" and loss != "code_ce"
    for name, n in launches.items():
        if logits or name.startswith("jpq_lookup"):
            check(n > 0, f"the {what} training run never launched {name}")
        else:
            check(n == 0, f"the {what} training run launched {name} {n} "
                  f"times: it builds no [T, N] logits")
    losses = [h["loss"] for h in hist if "loss" in h]
    secs = [h["sec"] for h in hist if "loss" in h][1:]
    check(len(losses) == 1 + steps and all(np.isfinite(losses)),
          f"{what} losses not finite: {losses}")
    check(np.mean(losses[-5:]) < losses[0],
          f"{what} loss did not fall: first {losses[0]}, last 5 "
          f"{losses[-5:]}")
    code_ce = [h["code_ce"] for h in hist if "code_ce" in h]
    check(len(code_ce) == (1 + steps if semantic_weight else 0)
          and all(np.isfinite(code_ce)),
          f"{what} code_ce rows malformed: {code_ce}")
    step_ms = float(np.median(secs)) * 1e3
    print(f"   losses {' '.join(f'{v:.4f}' for v in losses)}")
    if code_ce:
        print(f"   code_ce {' '.join(f'{v:.4f}' for v in code_ce)}")
    print(f"   median step {step_ms:.1f} ms (steps 1-{steps}), peak "
          f"memory {peak_gb:.2f} GB, launches {launches} on {smi}")

    plain = SeqRecModel(dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, use_kernel=False)), codes=codes_np, device=dev)
    small = {k: torch.as_tensor(v[:2], device=dev)
             for k, v in batch_fn(2)(10_000).items()}
    floats = list(model.parameters())
    res = {}
    for name, m in (("kernels", model), ("gathers", plain)):
        loss, _ = m.train_loss(params, small)
        res[name] = (float(loss.detach()),
                     torch.autograd.grad(loss, floats))
    (lk, gk), (lg, gg) = res["kernels"], res["gathers"]
    check(abs(lk - lg) <= 1e-5 * abs(lg),
          f"{what} B=2 loss through kernels {lk} != gathers {lg}")
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(gk, gg))
    check(worst <= 1e-4, f"{what} B=2 gradients differ by {worst:.3e} of "
          f"their largest entry")
    print(f"   B=2 step: loss {lk:.6f} (kernels) vs {lg:.6f} (gathers), "
          f"gradients within {worst:.2e} of their largest entry")
    del res, gk, gg, plain, floats

    ev = data.eval_batch(range(EVAL_USERS), split="test")
    seq = torch.as_tensor(ev["seq"], device=dev)
    target = torch.as_tensor(ev["target"], device=dev)
    sc.reset_launches()
    with torch.no_grad():
        scores = model.score_last(params, seq)
        check(sc.launches["jpq_scores"] > 0,
              f"{arch} eval never launched jpq_scores")
        h = model.encode(params, model._serve_seq(seq))[:, -1]
        P = jpq_mod.partial_scores(params["item_emb"], h).contiguous()
        kern = sc.jpq_scores(P, params["item_emb"]["codes"])
        ref = sref.jpq_scores_lut_ref(P, params["item_emb"]["codes"])
    check(tuple(scores.shape) == (EVAL_USERS, N_ITEMS + 2)
          and bool(torch.isfinite(scores).all()),
          f"{arch} eval scores malformed")
    check(bits_equal(kern, ref), f"{arch} eval scores != plain on the same "
          f"LUT")
    kern[:, 0] = kern[:, -1] = -1e9
    check(bits_equal(scores, kern),
          f"{arch} score_last != kernel scores, masked")
    ndcg = float(ndcg_at_k(scores, target).mean())
    hr = float(hr_at_k(scores, target).mean())
    print(f"   eval {EVAL_USERS} users: NDCG@10 {ndcg:.4f} HR@10 {hr:.4f}; "
          f"scores bit-equal to the plain version on the same LUT")
    return model, params, {
        "losses": losses, **({"code_ce": code_ce} if code_ce else {}),
        "median_step_ms": step_ms,
        "step_ms": [t * 1e3 for t in secs], "peak_gb": peak_gb,
        "launches": launches, "ndcg10": ndcg, "hr10": hr,
        "b2_loss_kernels": lk, "b2_loss_gathers": lg,
        "b2_grad_rel_err": worst}


def arch_phases(torch, np, dev, smi, data, codes_np):
    """Phase 12: full-width RecJPQ BERT4Rec and GRU4Rec training through
    the four training kernels, each checked as phase 7 checks SASRec
    (``seq_main_path``).  Returns the ``train_archs`` summary."""
    summary = {}
    for arch in ARCHS:
        t0 = phase(f"main path: full-width RecJPQ {arch} training, "
                   f"B={TRAIN_B} S={SEQ_LEN} N={N_ITEMS}, 1 + {ARCH_STEPS} "
                   f"steps")
        free_card(torch, dev, arch)
        model, params, summary[arch] = seq_main_path(
            torch, np, dev, smi, data, codes_np, arch, ARCH_STEPS)
        del model, params
        done(t0)
    print(json.dumps({"train_archs": summary, "card": smi}))
    return summary


# the ninth slice: SASRec's other objectives, microbatching, checkpoints
# with SIGTERM preemption, and the semantic-ID head, at full width
OBJECTIVES = (("sampled_bce", 0.0), ("code_ce", 0.0), ("full_ce", 0.5))
OBJ_STEPS, MICRO_STEPS, CKPT_STEPS, CKPT_STOP = 10, 5, 6, 3
SEM_K, SEM_DUP_ROWS, SEM_DUP_B = 10, 2_000, 64


def _leaves_equal(torch, a, b):
    """Two params() trees equal bit for bit, leaf by leaf."""
    from repro_torch.nn.module import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.detach().view(torch.uint8),
                                           y.detach().view(torch.uint8))
        for x, y in zip(la, lb))


def objective_phases(torch, np, dev, smi, data, codes_np):
    """Phases 16-19: full-width RecJPQ SASRec trained with sampled_bce,
    code_ce and full_ce + semantic_weight=0.5 (1 + 10 steps each) and with
    full_ce at microbatches=2 (1 + 5 steps), each checked by
    ``seq_main_path``; then the training kernels at a microbatch slice's
    T = 1,600, held as phase 8 holds them and timed, and the microbatched
    step against the single step on one batch and against the mean of
    the single steps on its two halves.  Returns the ``seq_objectives``
    summary."""
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train.loop import TrainConfig, Trainer, step_generator
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.spec import accumulate_grads

    summary = {}
    for loss, w in OBJECTIVES:
        name = loss if not w else f"{loss}+semantic_weight={w}"
        t0 = phase(f"main path: full-width RecJPQ SASRec, {name}, "
                   f"B={TRAIN_B} S={SEQ_LEN} N={N_ITEMS}, 1 + {OBJ_STEPS} "
                   f"steps")
        free_card(torch, dev, name)
        model, params, summary[name] = seq_main_path(
            torch, np, dev, smi, data, codes_np, "sasrec", OBJ_STEPS,
            loss=loss, semantic_weight=w)
        del model, params
        done(t0)

    t0 = phase(f"main path: full-width RecJPQ SASRec, full_ce at "
               f"microbatches=2, B={TRAIN_B} S={SEQ_LEN} N={N_ITEMS}, 1 + "
               f"{MICRO_STEPS} steps")
    free_card(torch, dev, "microbatches=2")
    model, params, run = seq_main_path(
        torch, np, dev, smi, data, codes_np, "sasrec", MICRO_STEPS,
        microbatches=2)
    summary["full_ce+microbatches=2"] = run
    # the training kernels at a slice's shape, T = 8 x 200 = 1,600, on the
    # trained weights and a training batch's ids, held as phase 8 holds
    # them at T = 3,200, then timed
    half = TRAIN_B // 2
    seq = torch.as_tensor(data.train_batch(0, TRAIN_B)["seq"][:half],
                          device=dev)
    slice_k, ins = slice_kernel_errs(torch, dev, model, params, seq,
                                     f"T={half * SEQ_LEN}")
    T2, worst, chain = (slice_k[k] for k in (
        "T", "jpq_scores_bwd_bound", "jpq_scores_bwd_chain"))
    P, codes, cent, ids, dS, dout = (ins[k] for k in (
        "P", "codes", "cent", "ids", "dS", "dout"))
    n_rows, dk = codes.shape[0], cent.shape[-1]
    work = train_kernel_work(T2, n_rows, BC, dk)
    for name, fn, iters in (
            ("jpq_scores", lambda: sc.jpq_scores(P, codes), 5),
            ("jpq_scores_bwd", lambda: sc.jpq_scores_bwd(dS, codes, BC), 3),
            ("jpq_lookup", lambda: lc.jpq_lookup(ids, codes, cent), 50),
            ("jpq_lookup_bwd",
             lambda: lc.jpq_lookup_bwd(ids, codes, dout, BC), 50)):
        slice_k[f"{name}_ms"] = cuda_ms(fn, iters)
        slice_k[f"{name}_bound_ms"] = bound(*work[name])[0]
    print(f"   T={T2}: jpq_scores forward bit-equal to plain (launch shape "
          f"{slice_k['jpq_scores_launch_shape']}); backward over "
          f"{slice_k['jpq_scores_bwd_chunks']} chunks deterministic, max "
          f"|err| vs float64 {slice_k['jpq_scores_bwd_err']:.3e} (largest "
          f"bound {worst:.3e}, longest chain {chain}); jpq_lookup forward "
          f"bit-equal, backward bit-equal to plain on the CPU")
    print(f"   T={T2}: ms kernel / bound: " + ", ".join(
        f"{n} {slice_k[n + '_ms']:.4f} / {slice_k[n + '_bound_ms']:.4f}"
        for n in ("jpq_scores", "jpq_scores_bwd", "jpq_lookup",
                  "jpq_lookup_bwd")) + f" on {smi}")
    del model, params, P, dS, dout, cent, codes, seq, ids, ins
    free_card(torch, dev, "the microbatched step against the single step")
    # one step at microbatches=2 on [x; x] gives each slice the single
    # step's gradient on x, and (g + g) / 2 == g: the two steps must end
    # bit-equal, loss included
    x = data.train_batch(1, half)
    xx = {k: np.concatenate([v, v]) for k, v in x.items()}
    outs = {}
    for n, b in ((1, x), (2, xx)):
        m = full_width_model(codes_np, dev)
        tr = Trainer(m, OptConfig(lr=3e-3),
                     TrainConfig(steps=1, batch_size=len(b["seq"]),
                                 log_every=1, eval_every=0, microbatches=n),
                     data_fn=lambda s, b=b: b)
        p, hist = tr.run(params=m.params())
        outs[n] = (m, p, hist[0]["loss"])
    check(outs[1][2] == outs[2][2] and
          _leaves_equal(torch, outs[1][1], outs[2][1]),
          f"the microbatched step on [x; x] != the single step on x (loss "
          f"{outs[2][2]} vs {outs[1][2]})")
    slice_k["microbatched_equals_single_step"] = True
    print(f"   microbatches=2 on [x; x] (B={2 * half}) bit-equal to the "
          f"single step on x (B={half}): loss {outs[1][2]:.6f}, every "
          f"parameter")
    del outs, m, p, tr
    free_card(torch, dev, "the microbatched step on distinct halves")
    # microbatches=2 on a batch of 16 with distinct halves a and b against
    # its definition, the mean of the single steps' gradients on a and on
    # b (each slice's loss is the mean over its own labelled positions).
    # b keeps only its last 3 positions (the rest made padding), so the
    # halves hold unequal counts and the single step on the whole batch
    # differs from that mean: a slice that took the whole batch would
    # show, as would one slice taken twice.  The limits are the B=2
    # step's: the slices sum in other orders
    ab = data.train_batch(2, TRAIN_B)
    for v in ab.values():
        v[half:, :-3] = 0
    m = full_width_model(codes_np, dev)
    p = m.params()
    floats = [x for x in tree_leaves(p) if torch.is_floating_point(x)]

    def step_grads(n, b):
        _, g, mets = accumulate_grads(
            m.train_loss, n, p, {k: torch.as_tensor(v, device=dev)
                                 for k, v in b.items()},
            lambda i: step_generator(0, 0, dev, i), floats, has_aux=True)
        return float(mets["loss"]), g

    lm, gm = step_grads(2, ab)
    la, ga = step_grads(1, {k: v[:half] for k, v in ab.items()})
    lb, gb = step_grads(1, {k: v[half:] for k, v in ab.items()})
    lw, _ = step_grads(1, ab)
    lr_ = (la + lb) / 2
    err = max(float((x - (y + z) / 2).abs().max()
                    / ((y + z) / 2).abs().max().clamp(min=1e-30))
              for x, y, z in zip(gm, ga, gb))
    check(abs(lm - lr_) <= 1e-5 * abs(lr_) and err <= 1e-4,
          f"the microbatched step on distinct halves != the mean of the "
          f"single steps on each: loss {lm} vs {lr_}, gradients within "
          f"{err:.3e} of their largest entry")
    check(abs(lw - lr_) > 1e-5 * abs(lr_),
          f"the single step on the whole batch ({lw}) equals the halves' "
          f"mean ({lr_}): the check could not see a slice that took the "
          f"whole batch")
    slice_k.update(halves_loss_microbatched=lm, halves_loss_mean=lr_,
                   halves_loss_whole_batch=lw, halves_grad_rel_err=err)
    print(f"   microbatches=2 on distinct halves (B={TRAIN_B}): loss {lm:.6f}"
          f" vs the halves' mean {lr_:.6f} (whole batch {lw:.6f}), "
          f"gradients within {err:.2e} of their largest entry")
    summary["kernels_at_the_slice_shape"] = slice_k
    del m, p, floats, ga, gb, gm
    done(t0)
    print(json.dumps({"seq_objectives": summary, "card": smi}))
    return summary


def checkpoint_phase(torch, np, dev, smi, data, codes_np):
    """Phase 20: full-width RecJPQ SASRec (full_ce) trains 6 steps through
    ``Trainer``; a checkpoint of its values and optimizer state is saved
    and timed (the host copy that blocks training, and the whole write)
    and its bytes counted; a run that gets a real SIGTERM while drawing
    step 3's batch stops with a checkpoint stamped at step 3, and its
    resume ends bit-equal to the uninterrupted run; the checkpoint then
    restores onto the card into a fresh model, as ``launch/serve.py
    --ckpt-dir`` restores it.  Returns (the trained model, its params,
    the ``checkpoint`` summary)."""
    import shutil
    import signal
    import tempfile

    from repro_torch.ckpt import (AsyncCheckpointer, latest_step,
                                  restore_values)
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    t0 = phase(f"checkpoints at full width: SASRec full_ce, SIGTERM at step "
               f"{CKPT_STOP} of {CKPT_STEPS}, resume, restore onto the card")
    free_card(torch, dev, "the checkpoint phase")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt-",
                            dir=os.path.join(HERE, "build"))
    out = {}
    try:
        def run(d, sigterm_at=None):
            model = full_width_model(codes_np, dev)

            def data_fn(s):
                if s == sigterm_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return data.train_batch(s, TRAIN_B)

            tr = Trainer(model, OptConfig(lr=3e-3),
                         TrainConfig(steps=CKPT_STEPS, batch_size=TRAIN_B,
                                     log_every=1, eval_every=0, ckpt_dir=d,
                                     ckpt_every=0),
                         data_fn=data_fn)
            params, hist = tr.run(params=model.params())
            return model, tr, params, hist

        model, _, want, _ = run(None)
        # what a save costs: the host copy (training waits for it) and
        # the whole write, of the values and a same-sized optimizer state
        ck = AsyncCheckpointer(os.path.join(root, "timed"), keep=1)
        state = {"values": want, "opt": {**init_opt_state(want),
                                         "step": np.int32(CKPT_STEPS)}}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ck.save(state, CKPT_STEPS)
        t2 = time.perf_counter()
        ck.wait()
        t3 = time.perf_counter()
        npz = os.path.join(root, "timed", f"step_{CKPT_STEPS:010d}",
                           "arrays.npz")
        out.update(host_copy_ms=(t2 - t1) * 1e3, save_ms=(t3 - t1) * 1e3,
                   bytes=os.path.getsize(npz))
        del state
        d = os.path.join(root, "run")
        _, tr, _, _ = run(d, sigterm_at=CKPT_STOP - 1)
        check(tr._preempted and tr.done_step == CKPT_STOP
              and latest_step(d) == CKPT_STOP,
              f"SIGTERM at step {CKPT_STOP}: preempted={tr._preempted}, "
              f"done_step={tr.done_step}, latest checkpoint "
              f"{latest_step(d)}")
        _, tr, got, hist = run(d)
        check(not tr._preempted and tr.done_step == CKPT_STEPS
              and hist[0]["step"] == CKPT_STOP,
              f"the resumed run: done_step={tr.done_step}, first row "
              f"{hist[0]}")
        check(_leaves_equal(torch, want, got),
              "the preempted and resumed run != the uninterrupted run")
        del got
        fresh = full_width_model(codes_np, dev)
        p = fresh.params()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step = restore_values(d, p)
        torch.cuda.synchronize()
        out["restore_ms"] = (time.perf_counter() - t1) * 1e3
        check(step == CKPT_STEPS and _leaves_equal(torch, want, p) and all(
            x.device == dev for x in p["item_emb"].values()),
            "the restored checkpoint != the trained parameters on the card")
        del fresh, p
        out.update(preempted_at=CKPT_STOP, steps=CKPT_STEPS,
                   resume_bit_equal=True, restore_bit_equal=True)
        print(f"   save: host copy {out['host_copy_ms']:.1f} ms, write "
              f"{out['save_ms']:.1f} ms, {out['bytes']} bytes; SIGTERM at "
              f"step {CKPT_STOP}, resumed to {CKPT_STEPS}: bit-equal to the "
              f"uninterrupted run; restored onto the card in "
              f"{out['restore_ms']:.1f} ms, bit-equal, on {smi}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    done(t0)
    print(json.dumps({"checkpoint": out, "card": smi}))
    return model, want, out


# the training engine on the card (phase 26): V virtual shards, the
# SASRec runs' methods and overlap modes, and the two-tower models whose
# exchange is heavy
ENG_V, ENG_STEPS, ENG_RESUME = 4, 3, (2, 2)
ENG_SEQ_RUNS = (("none", False, "none"), ("none", False, "dispatch"),
                ("none", False, "backward"), ("int8", False, "none"),
                ("int8", False, "dispatch"), ("int8", False, "backward"),
                ("bf16", False, "dispatch"), ("int8", True, "dispatch"))
ENG_TT = ("two-tower-retrieval", "two-tower-retrieval-jpq")
ENG_TT_B, ENG_TT_STEPS = 65_536, 2


def tt_engine_batch(np, cfg, s, rows=ENG_TT_B):
    """Step ``s``'s two-tower training batch of phases 26 and 30 (a
    function of the seed and step alone): ``rows`` histories of the
    model's ``hist_len`` ids over the catalogue, positives, zero logq."""
    r = np.random.default_rng((0, s))
    return {"user_hist": r.integers(0, cfg.n_items + 1,
                                    (rows, cfg.hist_len)),
            "pos_item": r.integers(1, cfg.n_items + 1, (rows,)),
            "logq": np.zeros(rows, np.float32)}


def _timed_trainer(Trainer, torch):
    """A Trainer whose elastic step records CUDA events around each
    stage call (the scheduler calls the stages through the step's
    attributes): ``stage_events[name]`` = [(start, end), ...]."""
    class Timed(Trainer):
        def _build_dp_step(self, shapes):
            step = super()._build_dp_step(shapes)
            self.stage_events = {"forward_backward": [],
                                 "quantise_pack": [], "combine": []}
            for name, evs in self.stage_events.items():
                def wrapped(*a, _fn=getattr(step, name), _evs=evs):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    out = _fn(*a)
                    e.record()
                    _evs.append((s, e))
                    return out
                setattr(step, name, wrapped)
            return step

        def stage_ms(self):
            """Each stage's ms a step: the events' sum over the run's
            steps after its first (the warm-up), over their count."""
            torch.cuda.synchronize()
            n = len(self.stage_events["combine"])     # one a step
            out = {}
            for k, v in self.stage_events.items():
                per = len(v) // n
                out[k] = sum(s.elapsed_time(e) for s, e in v[per:]) / max(
                    n - 1, 1)
            return out
    return Timed


def _state_bits(torch, tr, params):
    """(values, moments, err) of a finished run, cloned on the card."""
    from repro_torch.nn.module import tree_leaves
    pick = [x.detach().clone() for x in tree_leaves(params)]
    opt = [x.clone() for x in tree_leaves({"m": tr.opt_state["m"],
                                           "v": tr.opt_state["v"]})]
    err = [x.clone() for x in tree_leaves(tr.err_state)]
    return pick, opt, err


def _bits_equal_lists(torch, a, b):
    """Two lists of tensors equal bit for bit."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and (not x.numel() or (
            torch.equal(x.contiguous().view(torch.uint8),
                        y.contiguous().view(torch.uint8))))
        for x, y in zip(a, b))


def _max_rel(torch, a, b):
    """The largest |a - b| of any float leaf over that leaf's largest
    |b| (0 for all-zero leaves), and the largest |a - b|."""
    rel, ab = 0.0, 0.0
    for x, y in zip(a, b):
        if not torch.is_floating_point(y) or not y.numel():
            continue
        d = float((x - y).abs().max())
        s = float(y.abs().max())
        ab = max(ab, d)
        rel = max(rel, d / s if s else (0.0 if d == 0 else float("inf")))
    return rel, ab


def tt_round_errs(torch, dev, name, params, batch, n):
    """The embedding_bag kernels at a two-tower elastic round's shape:
    round 0's ``n`` rows of ``batch`` on the model's trained tables.
    The full table: the user tower's bag forward (ids [n, H], mask
    weights) bit-equal to its plain version, and its backward and the
    item gather's (``bag_bwd_parity``) on random cotangents; RecJPQ:
    the centroid gather's backward over the history's and the items'
    code ids, as ``core/jpq.lookup`` forms them.  Returns each kernel's
    max |err| (the backward's against float64)."""
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ref as eref
    gen = torch.Generator(device=dev).manual_seed(5)
    hist = torch.as_tensor(batch["user_hist"][:n], device=dev)
    pos = torch.as_tensor(batch["pos_item"][:n], device=dev)
    what = f"{name} round n={n}"
    out = {}
    if "table" in params["item_emb"]:
        tab = params["item_emb"]["table"].detach()
        V, d = tab.shape
        w = (hist > 0).float()
        kern = ec.embedding_bag(tab, hist, w)
        plain = eref.embedding_bag_ref(tab, hist, w)
        check(bits_equal(kern, plain), f"embedding_bag != plain ({what})")
        out["embedding_bag"] = float((kern - plain).abs().max())
        del kern, plain
        dout = torch.randn((n, d), generator=gen, device=dev)
        bag = bag_bwd_parity(torch, hist, w, dout, V, what)
        dpos = torch.randn((n, d), generator=gen, device=dev)
        item = bag_bwd_parity(torch, pos.reshape(-1, 1), None, dpos, V,
                              what + " item gather", gather=True)
        out["embedding_bag_backward"] = max(bag["f64_err"],
                                            item["f64_err"])
        shapes = (f"bag V={V} d={d} n_bags={n} L={hist.shape[1]}, item "
                  f"gather n={n}")
        del dout, dpos, w
    else:
        cent = params["item_emb"]["centroids"].detach()
        codes = params["item_emb"]["codes"]
        m, b, dk = cent.shape
        shift = b * torch.arange(m, device=dev)
        out["embedding_bag_backward"], sizes = 0.0, []
        for x, part in ((hist, "history"), (pos, "items")):
            flat = (codes[x.long()].long() + shift).reshape(-1, 1)
            dout = torch.randn((flat.shape[0], dk), generator=gen,
                               device=dev)
            row = bag_bwd_parity(torch, flat, None, dout, m * b,
                                 f"{what} {part} centroid gather",
                                 gather=True)
            out["embedding_bag_backward"] = max(
                out["embedding_bag_backward"], row["f64_err"])
            sizes.append(f"{part} n={flat.shape[0]}")
            del flat, dout
        shapes = f"centroid gathers V={m * b} d={dk}, " + ", ".join(sizes)
    torch.cuda.empty_cache()
    print(f"   {name}, the kernels at a round's shape ({shapes}): "
          + ("forward bit-equal to plain; " if "embedding_bag" in out
             else "") + f"backward bit-identical twice, bit-equal to "
          f"plain on the CPU, max |err| vs float64 "
          f"{out['embedding_bag_backward']:.3e}")
    return out


def engine_phases(torch, np, dev, smi, data, codes_np):
    """Phase 26: the training engine (``repro_torch.train.spec``,
    ``repro_torch.dist.compression``) on the card, NCCL at world 1,
    V = 4 virtual shards.  Returns the ``{"engine": ...}`` summary."""
    import shutil
    import tempfile

    from repro_torch.ckpt import checkpoint_metadata
    from repro_torch.configs import get_bundle
    from repro_torch.dist import compression
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train import spec as spec_mod
    from repro_torch.train.loop import TrainConfig, Trainer, step_generator
    from repro_torch.train.optimizer import OptConfig

    Timed = _timed_trainer(Trainer, torch)
    counters = (ec, sc, lc)
    out = {"seq": {}, "two_tower": {}, "card": smi}
    t0 = phase(f"main path: the training engine on the card (NCCL, world 1,"
               f" V={ENG_V}): SASRec-RecJPQ at full width, B={TRAIN_B} "
               f"S={SEQ_LEN}, {ENG_STEPS} steps a run; then the two-tower "
               f"models at B={ENG_TT_B}, int8")
    free_card(torch, dev, "the training engine phase")
    mesh = make_host_mesh(1, device=dev)
    batches = [data.train_batch(s, TRAIN_B)
               for s in range(max(ENG_STEPS, sum(ENG_RESUME)))]
    opt = OptConfig(lr=3e-3)
    unclipped = OptConfig(lr=3e-3, clip_norm=None)

    def seq_run(method, fsdp, overlap, steps, ckpt_dir=None, clip=True):
        model = full_width_model(codes_np, dev)
        params = model.params()
        for c in counters:
            c.reset_launches()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = Timed(model, opt if clip else unclipped, TrainConfig(
            steps=steps, batch_size=TRAIN_B, log_every=1, eval_every=0,
            ckpt_dir=ckpt_dir, ckpt_every=0, grad_compression=method,
            grad_accum_shards=ENG_V, fsdp=fsdp, overlap=overlap),
            data_fn=lambda s: batches[s], mesh=mesh)
        _, hist = tr.run(params=params)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: v for c in counters for k, v in c.launches.items()}
        return model, params, tr, hist, peak, launches

    try:
        states = {}
        for method, fsdp, overlap in ENG_SEQ_RUNS:
            key = f"{method}{'+fsdp' if fsdp else ''}/{overlap}"
            model, params, tr, hist, peak, launches = seq_run(
                method, fsdp, overlap, ENG_STEPS)
            for k in ("jpq_scores", "jpq_scores_bwd", "jpq_lookup",
                      "jpq_lookup_bwd"):
                check(launches[k] > 0, f"engine {key}: {k} never launched "
                      f"in the elastic rounds: {launches}")
            losses = [h["loss"] for h in hist if "loss" in h]
            check(len(losses) == ENG_STEPS and all(np.isfinite(losses)),
                  f"engine {key}: losses {losses}")
            states[key] = _state_bits(torch, tr, params)
            err = states[key][2]
            err_max = max(float(e.abs().max()) for e in err if e.numel())
            check(all(bool(torch.isfinite(e).all()) for e in err),
                  f"engine {key}: non-finite error state")
            if method == "none":
                check(err_max == 0.0, f"engine {key}: err {err_max} != 0")
            else:
                check(err_max > 0.0, f"engine {key}: err all zero")
            stage = tr.stage_ms()
            steps_ms = [h["sec"] * 1e3 for h in hist if "sec" in h]
            row = {k: hist[0][k] for k in (
                "payload_bytes", "exchange_fraction", "exchange_shards",
                "exchange_fsdp", "exchange_wire_bytes")}
            row.update(
                step_ms=float(np.median(steps_ms)), steps_ms=steps_ms,
                peak_gb=peak / 1e9, losses=losses, launches=launches,
                fb_ms=stage["forward_backward"],
                qp_combine_ms=stage["quantise_pack"] + stage["combine"],
                qp_ms=stage["quantise_pack"], combine_ms=stage["combine"],
                err_bytes=sum(e.numel() * e.element_size() for e in err),
                err_max=err_max)
            out["seq"][key] = row
            print(f"   SASRec {key}: step {row['step_ms']:.1f} ms (median "
                  f"of {ENG_STEPS}; plain step 140.9-145.8), peak "
                  f"{row['peak_gb']:.2f} GB, forward/backward "
                  f"{row['fb_ms']:.1f} ms + quantise_pack/combine "
                  f"{row['qp_combine_ms']:.2f} ms a step after the first; "
                  f"payload "
                  f"{row['payload_bytes']} B a shard, "
                  f"{row['exchange_wire_bytes']} B a step; err "
                  f"{row['err_bytes']} B (max {err_max:.3e}); loss "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches "
                  f"{launches}; on {smi}")
            del model, params, tr, hist
        for method in ("none", "int8"):
            ref = states[f"{method}/none"]
            for overlap in ("dispatch", "backward"):
                got = states[f"{method}/{overlap}"]
                check(all(_bits_equal_lists(torch, a, b)
                          for a, b in zip(ref, got)),
                      f"engine {method}: overlap {overlap} != none")
        print("   none and int8: the three overlap modes bit-identical "
              "(values, moments, err)")
        # the four training kernels at a round's shape, T = 16 / V x 200 =
        # 800: round 0 of step 0 (its rows of the batch, the fresh
        # model's weights), each against its plain version
        free_card(torch, dev, "the kernels at a round's shape")
        model = full_width_model(codes_np, dev)
        params = model.params()
        seq = torch.as_tensor(batches[0]["seq"][:TRAIN_B // ENG_V],
                              device=dev)
        rnd, ins = slice_kernel_errs(torch, dev, model, params, seq,
                                     f"elastic round T={seq.numel()}")
        out["kernels_at_round_shape"] = {"T": rnd["T"], "max_abs_err": {
            k: rnd[k + "_err"] for k in ("jpq_scores", "jpq_scores_bwd",
                                         "jpq_lookup", "jpq_lookup_bwd")}}
        print(f"   the kernels at a round's shape, T={rnd['T']}: "
              f"jpq_scores forward bit-equal to plain; backward over "
              f"{rnd['jpq_scores_bwd_chunks']} chunks deterministic, max "
              f"|err| vs float64 {rnd['jpq_scores_bwd_err']:.3e} (largest "
              f"bound {rnd['jpq_scores_bwd_bound']:.3e}); jpq_lookup "
              f"forward bit-equal, backward bit-equal to plain on the CPU "
              f"(max |err| vs float64 {rnd['jpq_lookup_bwd_err']:.3e})")
        del model, params, seq, ins
        # fsdp against dp as the reference's test holds it: one exchange
        # (grads-only) on the same batch, gradients within rtol = atol =
        # 2e-6 (the fsdp chain against the [V, ...] mean), err bit-equal
        # (made before the combine); after the 3-step runs, max |d|
        free_card(torch, dev, "the engine's fsdp check")
        model = full_width_model(codes_np, dev)
        p = model.params()
        b0 = {k: torch.as_tensor(v, device=dev)
              for k, v in batches[0].items()}
        fsdp_one = {}
        for method in ("none", "int8"):
            got = {}
            for fsdp in (False, True):
                step = compression.make_elastic_dp_step(
                    lambda v, b: model.train_loss(v, b), mesh, method,
                    accum_shards=ENG_V, has_aux=True, fsdp=fsdp, shapes=p)
                vals = step.shard(p) if fsdp else p
                g, e, _, _ = step(vals, compression.zeros_error_state(
                    p, ENG_V), b0)
                got[fsdp] = (tree_leaves(step.gather(g) if fsdp else g),
                             tree_leaves(e))
                del step, vals, g, e
            (g_d, e_d), (g_f, e_f) = got[False], got[True]
            check(_bits_equal_lists(torch, e_d, e_f),
                  f"engine {method}: fsdp err != dp err after one exchange")
            worst = 0.0
            for x, y in zip(g_f, g_d):
                if torch.is_floating_point(y) and y.numel():
                    d = (x - y).abs()
                    check(bool((d <= 2e-6 + 2e-6 * y.abs()).all()),
                          f"engine {method}: fsdp gradients beyond 2e-6 of "
                          f"dp: {float(d.max())}")
                    worst = max(worst, float(d.max()))
            fsdp_one[method] = worst
            del got, g_d, e_d, g_f, e_f
        dp, fs = states["int8/dispatch"], states["int8+fsdp/dispatch"]
        _, fsdp_run = _max_rel(torch, fs[0] + fs[1], dp[0] + dp[1])
        del states, model, p, b0
        # without clipping no global norm enters the update, and the
        # gradients agree bit for bit (above): so must the runs
        unclip = {}
        for fsdp in (False, True):
            *_, tr, _, _, _ = seq_run("int8", fsdp, "dispatch", ENG_STEPS,
                                      clip=False)
            unclip[fsdp] = _state_bits(torch, tr, tr.model.params())
            del tr
        check(all(_bits_equal_lists(torch, a, b)
                  for a, b in zip(unclip[False], unclip[True])),
              f"engine int8, clip_norm=None: fsdp != dp after "
              f"{ENG_STEPS} steps")
        del unclip
        out["fsdp_vs_dp"] = {"one_exchange_grad_max_abs": fsdp_one,
                             "after_3_steps_max_abs": fsdp_run,
                             "after_3_steps_unclipped_bit_equal": True}
        print(f"   fsdp against dp, one exchange: err bit-equal, gradients "
              f"within {fsdp_one} (limit 2e-6); int8 after "
              f"{ENG_STEPS} steps: values and moments max |d| "
              f"{fsdp_run:.3e} with clip_norm=1.0, bit-equal (values, "
              f"moments, err) with clip_norm=None")

        # "none" after one step against the plain step microbatched over
        # the same V slices (phase 19's microbatch limits: loss 1e-5
        # relative, gradients 1e-4 of each leaf's largest entry)
        free_card(torch, dev, "the engine's one-step check")
        model = full_width_model(codes_np, dev)
        p = model.params()
        floats = [x for x in tree_leaves(p) if torch.is_floating_point(x)]
        b0 = {k: torch.as_tensor(v, device=dev)
              for k, v in batches[0].items()}
        grad_step = compression.make_elastic_dp_step(
            lambda v, b: model.train_loss(v, b), mesh, "none",
            accum_shards=ENG_V, has_aux=True)
        g_e, _, loss_e, _ = grad_step(
            p, compression.zeros_error_state(p, ENG_V), b0)
        g_e = [g for g, x in zip(tree_leaves(g_e), tree_leaves(p))
               if torch.is_floating_point(x)]
        _, g_m, mets = spec_mod.accumulate_grads(
            model.train_loss, ENG_V, p, b0,
            lambda i: step_generator(0, 0, dev, i), floats, has_aux=True)
        loss_m = float(mets["loss"])
        rel, ab = _max_rel(torch, g_e, g_m)
        check(abs(float(loss_e) - loss_m) <= 1e-5 * abs(loss_m) and
              rel <= 1e-4, f"engine none, one step: loss {float(loss_e)} vs "
              f"{loss_m}, gradients within {rel:.3e} of their largest entry")
        out["one_step_vs_microbatched"] = {
            "loss": [float(loss_e), loss_m], "grad_rel": rel,
            "grad_max_abs": ab}
        print(f"   none, one step against microbatches={ENG_V} of the "
              f"plain step on the same batch: loss {float(loss_e):.7f} / "
              f"{loss_m:.7f}, gradients max |d| {ab:.3e} ({rel:.3e} of "
              f"their leaf's largest entry)")
        del model, p, floats, g_e, g_m, grad_step

        # an int8 run of 4 steps against 2 + a checkpoint + a resume of 2
        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        root = tempfile.mkdtemp(prefix="chip_smoke_ckpt-engine-",
                                dir=os.path.join(HERE, "build"))
        try:
            total = sum(ENG_RESUME)
            *_, tr, _, _, _ = seq_run("int8", False, "dispatch", total)
            want = _state_bits(torch, tr, tr.model.params())
            del tr
            d = os.path.join(root, "ck")
            seq_run("int8", False, "dispatch", ENG_RESUME[0], ckpt_dir=d)
            stamp = checkpoint_metadata(d).get("train_spec")
            check(stamp == spec_mod.spec_for(
                grad_compression="int8",
                grad_accum_shards=ENG_V).layout_stamp(mesh),
                f"engine: checkpoint stamp {stamp}")
            with np.load(os.path.join(d, f"step_{ENG_RESUME[0]:010d}",
                                      "arrays.npz")) as z:
                err_keys = [k for k in z.files if k.startswith("err/")]
            check(err_keys, "engine: the checkpoint holds no err tree")
            *_, tr, hist, _, _ = seq_run("int8", False, "dispatch", total,
                                         ckpt_dir=d)
            check(hist[0]["step"] == ENG_RESUME[0],
                  f"engine: resumed at {hist[0]['step']}")
            got = _state_bits(torch, tr, tr.model.params())
            check(all(_bits_equal_lists(torch, a, b)
                      for a, b in zip(want, got)),
                  "engine: int8 2 + checkpoint + 2 != 4 uninterrupted")
            del tr, want, got
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out["resume"] = {"steps": list(ENG_RESUME), "bit_equal": True,
                         "err_keys": len(err_keys), "stamp": stamp}
        print(f"   int8: {ENG_RESUME[0]} steps + checkpoint (train_spec "
              f"stamp, {len(err_keys)} err arrays) + resume of "
              f"{ENG_RESUME[1]} bit-equal to {sum(ENG_RESUME)} "
              f"uninterrupted")

        # the two-tower models: a 1 GB table's gradient through int8
        for name in ENG_TT:
            free_card(torch, dev, f"the engine's {name} run")
            model = get_bundle(name).make_model(device=dev, seed=0)
            params = model.params()
            bs = [tt_engine_batch(np, model.cfg, s)
                  for s in range(ENG_TT_STEPS)]
            for c in counters:
                c.reset_launches()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            tr = Timed(model, opt, TrainConfig(
                steps=ENG_TT_STEPS, batch_size=ENG_TT_B, log_every=1,
                eval_every=0, grad_compression="int8",
                grad_accum_shards=ENG_V),
                data_fn=lambda s: bs[s], mesh=mesh)
            _, hist = tr.run(params=params)
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
            launches = {k: v for c in counters for k, v in
                        c.launches.items()}
            check(launches["embedding_bag_backward"] > 0,
                  f"engine {name}: the embedding_bag backward never "
                  f"launched in the elastic rounds: {launches}")
            if name == "two-tower-retrieval":
                check(launches["embedding_bag"] > 0,
                      f"engine {name}: embedding_bag never launched: "
                      f"{launches}")
            losses = [h["loss"] for h in hist if "loss" in h]
            check(all(np.isfinite(losses)), f"engine {name}: {losses}")
            err = tree_leaves(tr.err_state)
            check(all(bool(torch.isfinite(e).all()) for e in err) and
                  max(float(e.abs().max()) for e in err if e.numel()) > 0,
                  f"engine {name}: err not finite and nonzero")
            stage = tr.stage_ms()
            steps_ms = [h["sec"] * 1e3 for h in hist if "sec" in h]
            row = {k: hist[0][k] for k in (
                "payload_bytes", "exchange_fraction", "exchange_shards",
                "exchange_wire_bytes")}
            row.update(
                step_ms=float(np.median(steps_ms)), steps_ms=steps_ms,
                peak_gb=peak / 1e9, losses=losses, launches=launches,
                fb_ms=stage["forward_backward"],
                qp_combine_ms=stage["quantise_pack"] + stage["combine"],
                qp_ms=stage["quantise_pack"], combine_ms=stage["combine"],
                err_bytes=sum(e.numel() * e.element_size() for e in err),
                fp32_payload_bytes=compression.payload_bytes(params, "none"))
            out["two_tower"][name] = row
            print(f"   {name}: step {row['step_ms']:.1f} ms (median of "
                  f"{ENG_TT_STEPS}), peak {row['peak_gb']:.2f} GB, "
                  f"forward/backward {row['fb_ms']:.1f} ms + quantise_pack"
                  f"/combine {row['qp_combine_ms']:.1f} ms the second "
                  f"step; int8 "
                  f"payload {row['payload_bytes']} B a shard, "
                  f"{row['exchange_wire_bytes']} B a step (fp32: "
                  f"{row['fp32_payload_bytes']} B a shard); err "
                  f"{row['err_bytes']} B; launches {launches}; on {smi}")
            del tr, hist, err
            row["kernels_at_round_shape"] = tt_round_errs(
                torch, dev, name, params, bs[0], ENG_TT_B // ENG_V)
            del model, params, bs
        full, jpq = (out["two_tower"][n] for n in ENG_TT)
        out["two_tower_payload_ratio"] = (full["payload_bytes"]
                                          / jpq["payload_bytes"])
        print(f"   RecJPQ ships {out['two_tower_payload_ratio']:.1f}x fewer "
              f"payload bytes than the full table: "
              f"{full['payload_bytes']} vs {jpq['payload_bytes']} B a "
              f"virtual shard")
    finally:
        mesh.close()
    done(t0)
    names = ("jpq_scores", "jpq_scores_bwd", "jpq_lookup", "jpq_lookup_bwd",
             "embedding_bag", "embedding_bag_backward")
    out["elastic_launches"] = {
        k: sum(r["launches"].get(k, 0) for part in ("seq", "two_tower")
               for r in out[part].values())
        for k in names}
    # each kernel's largest |err| at the rounds' shapes (the backward
    # kernels' against float64)
    errs = [out["kernels_at_round_shape"]["max_abs_err"]] + [
        r["kernels_at_round_shape"] for r in out["two_tower"].values()]
    out["elastic_round_max_abs_err"] = {
        k: max(e[k] for e in errs if k in e) for k in names}
    print(json.dumps({"engine": out}))
    return out


def semantic_phases(torch, np, dev, smi, data, template, seq_model,
                    seq_params):
    """Phases 21-22: ``two-tower-retrieval-jpq`` at full width serves
    --head semantic (k = 10, auto beams) through ``serve_loop``, 1 + 20
    fresh requests of B=512, after its code trie is built (timed); on
    one more request every value is bit-equal to the jpq_scores kernel's
    score of its id, and recall@10 against ``--fused``'s ids is
    reported; at 2,000 rows with duplicate codes the exhaustive decode is
    bit-equal to jpq_topk (values and ids).  Then the trained SASRec's
    ``retrieve_topk``, fused and pruned, for 256 eval users: bit-equal
    to the total-order top-10 of its ``score_last`` through the kernels.
    Returns the ``semantic_serve`` summary."""
    from repro_torch.configs import get_bundle
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.core import semantic
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.kernels.jpq_topk import ops
    from repro_torch.launch import serve as serve_mod

    t0 = phase(f"main path: full-width two-tower-retrieval-jpq --head "
               f"semantic (k={SEM_K}, auto beams), {REQUESTS} requests of "
               f"B={B}")
    free_card(torch, dev, "semantic serving")
    model = get_bundle("two-tower-retrieval-jpq").make_model(device=dev,
                                                             seed=0)
    params = model.params()
    codes = params["item_emb"]["codes"]
    n_rows = codes.shape[0]
    t1 = time.perf_counter()
    idx = semantic.index_for(codes, BC)
    build_s = time.perf_counter() - t1
    args = serve_mod.build_parser().parse_args(
        ["--batch-size", str(B), "--requests", str(REQUESTS), "--device",
         "cuda", "--head", "semantic"])
    kc.reset_launches()
    sc.reset_launches()
    res = serve_mod.serve_loop(model, params, template, args)
    check(res["path"] == "semantic", f"semantic serving ran {res['path']}")
    check(not any(kc.launches.values()) and not any(sc.launches.values()),
          f"the semantic head launched a sweep kernel: {kc.launches} "
          f"{sc.launches}")
    spec = engine_mod.spec_from_args(args, kind="jpq", k=SEM_K)
    beams = max(32, 4 * SEM_K)
    req = next(serve_mod.make_requests(template, B, 1, seed=321,
                                       reserved=(0,)))
    req = {k: torch.as_tensor(v, device=dev) for k, v in req.items()}
    with torch.inference_mode():
        v, i = model.bind_engine(params, spec).retrieve(req)
        fv, fi = model.bind_engine(params, engine_mod.RetrievalSpec(
            kind="jpq", k=SEM_K)).retrieve(req)
        h = model.user_vec(params, req["user_hist"])
        S = sc.jpq_scores(jpq_mod.partial_scores(params["item_emb"],
                                                 h).contiguous(), codes)
    check(tuple(i.shape) == (B, SEM_K) and bool((i >= 0).all())
          and bool((i < n_rows).all()), "semantic ids out of range")
    check(bits_equal(v, S.gather(1, i.long())),
          "a semantic value != the jpq_scores kernel's score of its id")
    recall = float((i[:, :, None] == fi[:, None, :]).any(-1).float().mean())
    del S, h
    print(f"   index: {idx.n_paths} paths over {n_rows} rows (largest "
          f"leaf {idx.max_leaf}) built in {build_s:.2f} s on the host")
    print(f"   p50={res['p50_ms']:.3f}ms p99={res['p99_ms']:.3f}ms "
          f"(beams {beams}); every value bit-equal to the kernel's score; "
          f"recall@{SEM_K} vs --fused {recall:.4f} on {smi}")
    # exhaustive decode at 2,000 rows with duplicate code rows (ties),
    # against jpq_topk on a canonical LUT (no -0.0)
    gen = torch.Generator(device=dev).manual_seed(4)
    dup = torch.randint(0, BC, (SEM_DUP_ROWS, M), generator=gen, device=dev,
                        dtype=torch.int32)
    dup[SEM_DUP_ROWS // 2:SEM_DUP_ROWS // 2 + 50] = dup[:50]
    dup = dup.to(torch.uint8)
    lut = ops.canonicalise_lut(torch.randint(
        -3, 4, (SEM_DUP_B, M, BC), generator=gen, device=dev).float() / 2)
    didx = semantic.build_code_index(dup, BC)
    ev_, ei_ = semantic.semantic_decode(lut, didx, SEM_K, beams=None)
    tv_, ti_ = kc.jpq_topk(lut.contiguous(), dup, SEM_K)
    check(bits_equal(ev_, tv_) and torch.equal(ei_, ti_),
          "exhaustive semantic decode != jpq_topk at 2,000 rows")
    print(f"   exhaustive decode ({didx.n_paths} paths over {SEM_DUP_ROWS} "
          f"rows, 50 duplicated, B={SEM_DUP_B}) bit-equal to jpq_topk")
    out = {"p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
           "lat_ms": res["lat_ms"], "beams": beams, "k": SEM_K,
           "index_build_s": build_s, "n_paths": idx.n_paths,
           "max_leaf": idx.max_leaf, "recall_vs_fused": recall,
           "values_equal_kernel_scores": True,
           "exhaustive_equals_jpq_topk": True}
    del model, params, codes, idx, didx, v, i, fv, fi
    # the scorer's cache holds the trie and the codes (≈ 40 MB on the
    # card): release them before the CTR phases read peak memory
    semantic.clear_index_cache()
    done(t0)

    t0 = phase(f"SeqRecModel.retrieve_topk on the trained full-width SASRec: "
               f"fused and pruned, {EVAL_USERS} users, k={SEM_K}")
    ev = data.eval_batch(range(EVAL_USERS), split="test")
    seq = torch.as_tensor(ev["seq"], device=dev)
    with torch.no_grad():
        scores = seq_model.score_last(seq_params, seq)
        want = engine_mod.rerank_candidates(
            scores, torch.arange(scores.shape[1], dtype=torch.int32,
                                 device=dev).expand_as(scores), SEM_K)
        del scores
        kc.reset_launches()
        got = {"fused": seq_model.retrieve_topk(seq_params, seq, k=SEM_K),
               "pruned": seq_model.retrieve_topk(seq_params, seq, k=SEM_K,
                                                 prune=True)}
    check(kc.launches["jpq_topk"] > 0 and kc.launches["jpq_topk_pruned"] > 0,
          f"retrieve_topk launched {kc.launches}")
    for name, (gv, gi) in got.items():
        check(bits_equal(gv, want[0]) and torch.equal(gi, want[1]),
              f"retrieve_topk ({name}) != the top-k of score_last")
    out["seqrec_retrieve_topk"] = {"users": EVAL_USERS, "k": SEM_K,
                                   "fused_equal": True, "pruned_equal": True,
                                   "launches": dict(kc.launches)}
    print(f"   fused and pruned top-{SEM_K} bit-equal to score_last's "
          f"(launches {dict(kc.launches)})")
    done(t0)
    print(json.dumps({"semantic_serve": out, "card": smi}))
    return out


# the request-level server at full width (phase 25): the reference CLI's
# defaults and two more configurations, each on the same Poisson stream
SRV_REQUESTS, SRV_SWAP_AT, SRV_SEQ_REQUESTS, SRV_K = 400, 200, 64, 10
SRV_RUNS = (("a", [], "jpq_topk_pruned"),
            ("b", ["--prune", "--perm", "--warm", "--replicas", "2",
                   "--merge-every", "4"], "jpq_topk_pruned"),
            ("c", ["--no-prune"], "jpq_topk"))


def server_phases(torch, np, dev, smi, seq_model, seq_params):
    """Phase 25: the request-level server (``repro_torch.serve``) at full
    width.  The full-width two-tower-retrieval-jpq model serves 400
    single-user requests, Poisson arrivals at 500/s on the real clock,
    through ``launch/server.serve_requests`` (the CLI's body; every
    (bucket, replica) dispatch warmed first) three times: (a) the CLI's
    defaults (``--max-batch 8 --max-delay-ms 5``, pruned, one replica),
    with a non-blocking hot swap to a popularity-permuted catalogue
    after 200 requests; (b) ``--prune --perm --warm --replicas 2
    --merge-every 4``; (c) ``--no-prune``.  Launch counters zeroed just
    before each timed run and read just after (run (a)'s less the hot
    swap probe's, counted alone first).  Every response is bit-equal to
    the same request served alone (row 0 of an all-pad [8, L] batch
    through ``TwoTower.retrieve``'s unpruned fused path) and to the
    plain scan (``ops.jpq_topk_scan``, no kernel) of the batch it was
    served in; the snapshot validates, nothing is dropped or
    duplicated, the queue batched.  The arrival-to-submit lag is read by wrapping
    ``server.submit``.  Then the trained full-width SASRec of phase 20
    in one replica, buckets (100, 200), 64 requests some longer than
    200, each bit-equal to its alone-at-shape reference and to the
    top-10 of ``score_last`` on its window; and both top-k kernels held
    against their plain versions (results and skip map) and timed at the
    server's B = 8 and at B = 64 on real batches' LUTs.  Returns
    the ``server`` summary (the kernel times under
    ``kernels_at_server_shape``)."""
    from repro_torch import serve
    from repro_torch.configs import get_bundle
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.core.assign import popularity_permutation
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.kernels.jpq_topk import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import server as server_mod

    t0 = phase(f"main path: the request server at full width, "
               f"two-tower-retrieval-jpq, {len(SRV_RUNS)} configurations "
               f"x {SRV_REQUESTS} requests")
    free_card(torch, dev, "the request server")
    model = get_bundle("two-tower-retrieval-jpq").make_model(device=dev,
                                                             seed=0)
    params = model.params()
    codes = params["item_emb"]["codes"]
    n_rows, b = codes.shape[0], int(model.emb.cfg.b)
    serving_stream = torch.cuda.current_stream(dev).cuda_stream

    def alone(hist, L, max_batch):
        """``hist`` served alone: row 0 of an all-pad [max_batch, L]
        batch through the unpruned fused path."""
        xb = np.zeros((max_batch, L), np.int32)
        h = np.asarray(hist)[-L:]
        xb[0, :h.size] = h
        with torch.inference_mode():
            v, i = model.retrieve(params, {"user_hist": xb}, top_k=SRV_K)
        return v[0].cpu().numpy(), i[0].cpu().numpy()

    def same(res, v, i):
        return (np.array_equal(res.values.view(np.int32), v.view(np.int32))
                and np.array_equal(res.ids, i))

    def lut(hist):
        with torch.inference_mode():
            return ops.canonicalise_lut(jpq_mod.partial_scores(
                params["item_emb"], model.user_vec(params, hist))
            ).contiguous()

    def plain_batch(batch):
        """A served batch through the plain unpruned scan
        (``ops.jpq_topk_scan``, no kernel): its rows' top-k on the host."""
        v, i = ops.jpq_topk_scan(lut(batch.padded_hist()), codes, SRV_K,
                                 block_n=ops.scan_block_n(n_rows))
        return v.cpu().numpy(), i.cpu().numpy()

    # the stream every run serves (the CLI's seed 0), and run (a)'s hot
    # swap: its popularity order, computed before the timed run
    arrivals = serve.poisson_arrivals(500.0, SRV_REQUESTS, seed=0)
    hists = serve.request_stream(SRV_REQUESTS, n_items=model.cfg.n_items,
                                 max_len=model.cfg.hist_len, seed=0)
    perm = popularity_permutation(serve_mod._template_popularity(
        {"user_hist": np.concatenate(hists)}, n_rows))
    # the hot swap's probe launches both kernels on the build thread,
    # inside run (a)'s counted window: count one publish of the same
    # catalogue alone, and take it off run (a)'s counts
    kc.reset_launches()
    serve.CatalogueRegistry(prune=True).publish(codes, b, perm=perm)
    probe = dict(kc.launches)
    out = {"requests": SRV_REQUESTS, "k": SRV_K, "card": smi,
           "probe_launches": probe}
    for name, flags, kern in SRV_RUNS:
        args = server_mod.build_parser().parse_args(
            ["--requests", str(SRV_REQUESTS), "--rate", "500",
             "--max-batch", "8", "--max-delay-ms", "5", "--top-k",
             str(SRV_K), "--seed", "0", "--device", "cuda", *flags])
        seen = {"hists": {}, "lag": [], "service_ms": [], "t_batch": [],
                "batches": [], "server": None}
        swap = {}

        def on_ready(server, name=name, seen=seen, swap=swap):
            """Wrap ``server.submit``: each request's lag behind its
            scheduled arrival (an upper bound: this clock starts a few
            microseconds before the loop's), and in run (a) the hot swap
            before request ``SRV_SWAP_AT``; wrap ``server.pool.serve``:
            each batch's service time on the host clock (it ends with
            the batch's readback); zero the counters."""
            submit, t_start = server.submit, time.monotonic()
            serve_batch = server.pool.serve

            def batches():
                return sum(r.batches_served for r in server.pool.replicas)

            def timed_serve(batch, version):
                t = time.perf_counter()
                out = serve_batch(batch, version)
                seen["service_ms"].append((time.perf_counter() - t) * 1e3)
                seen["t_batch"].append(t)
                seen["batches"].append(batch)
                return out

            def timed_submit(hist):
                i = len(seen["lag"])
                seen["lag"].append(time.monotonic() - t_start - arrivals[i])
                if name == "a" and i == SRV_SWAP_AT:
                    swap["at_batches"] = batches()
                    swap["t"] = time.perf_counter()
                    server.registry.publish(codes, b, perm=perm,
                                            block=False)
                if swap and "during_build" not in swap and \
                        server.registry.live().version == 2:
                    swap["during_build"] = batches() - swap["at_batches"]
                rid = submit(hist)
                seen["hists"][rid] = hist
                return rid

            server.submit, server.pool.serve = timed_submit, timed_serve
            seen["server"] = server
            kc.reset_launches()

        snap, wall = server_mod.serve_requests(model, params, args,
                                               on_ready=on_ready)
        counts = dict(kc.launches)
        if name == "a":                   # the probe's launches taken off
            counts = {n: c - probe[n] for n, c in counts.items()}
        server = seen["server"]
        check(serve.validate_snapshot(snap) == [],
              f"server run {name}: snapshot invalid "
              f"{serve.validate_snapshot(snap)}")
        check(snap["requests_completed"] == snap["requests_submitted"]
              == SRV_REQUESTS and snap["requests_dropped"] == 0
              and snap["requests_duplicated"] == 0,
              f"server run {name}: completed {snap['requests_completed']} "
              f"of {snap['requests_submitted']}, dropped "
              f"{snap['requests_dropped']}, duplicated "
              f"{snap['requests_duplicated']}")
        check(snap["batches"] < SRV_REQUESTS,
              f"server run {name}: the queue never batched")
        check(counts[kern] > 0, f"server run {name} never launched {kern}")
        if kern == "jpq_topk":
            check(counts["jpq_topk_pruned"] == 0,
                  f"server run {name} (--no-prune) launched the pruned "
                  f"kernel")
        if name == "a":                   # cold floors: one sweep a batch
            check(counts["jpq_topk"] == 0
                  and counts["jpq_topk_pruned"] == snap["batches"],
                  f"server run a: {counts} launches (probe's taken off) "
                  f"for {snap['batches']} batches")
        versions = set()
        for rid, hist in seen["hists"].items():
            res = server.result(rid)
            versions.add(res.version)
            check(same(res, *alone(hist, server.queue.bucket_of(len(hist)),
                                   server.queue.max_batch)),
                  f"server run {name}: request {rid} != the request "
                  f"served alone")
        # every served batch against the plain scan (no kernel) on its
        # own padded rows
        check(len(seen["batches"]) == snap["batches"],
              f"server run {name}: {len(seen['batches'])} batches seen, "
              f"{snap['batches']} in the snapshot")
        for batch in seen["batches"]:
            pv, pi = plain_batch(batch)
            for i, r in enumerate(batch.requests):
                check(same(server.result(r.rid), pv[i], pi[i]),
                      f"server run {name}: request {r.rid} != the plain "
                      f"scan of its batch")
        run = {"config": snap["config"], "wall_s": wall,
               "latency_ms": snap["latency_ms"],
               "batch_occupancy": snap["batch_occupancy"],
               "queue_depth": snap["queue_depth"],
               "batches": snap["batches"],
               "skip_fraction": snap["skip_fraction"],
               "warm_hit_rate": snap["warm_hit_rate"],
               "catalogue_swaps": snap["catalogue_swaps"],
               "max_submit_lag_ms": max(seen["lag"]) * 1e3,
               "max_lag_request": int(np.argmax(seen["lag"])),
               "service_ms": {"p50": float(np.percentile(
                   seen["service_ms"], 50)), "max": max(seen["service_ms"])},
               "launches": counts,
               "launches_per_request": {
                   n: c / SRV_REQUESTS for n, c in counts.items()},
               "versions": sorted(versions), "bit_equal_alone": True,
               "bit_equal_plain": True}
        if name == "a":
            live = server.registry.live()
            check(versions == {1, 2} and snap["catalogue_swaps"] == 1,
                  f"hot swap: versions {sorted(versions)}, swaps "
                  f"{snap['catalogue_swaps']}")
            check(live.validated and live.build_stream is not None
                  and live.build_stream != serving_stream,
                  f"hot swap: the build ran on stream {live.build_stream} "
                  f"(serving {serving_stream})")
            slowest = int(np.argmax(seen["service_ms"]))
            run["swap"] = {"build_s": live.built_s,
                           "batches_during_build": swap.get("during_build"),
                           "own_stream": True,
                           "slowest_batch_after_publish_ms":
                           (seen["t_batch"][slowest] - swap["t"]) * 1e3}
        out[name] = run
        lat = snap["latency_ms"]
        print(f"   ({name}) {snap['config']}: p50={lat['p50']:.3f} "
              f"p95={lat['p95']:.3f} p99={lat['p99']:.3f} ms, wall "
              f"{wall:.3f} s, occupancy {snap['batch_occupancy']:.3f}, "
              f"queue depth mean {snap['queue_depth']['mean']:.2f} max "
              f"{snap['queue_depth']['max']}, skip {snap['skip_fraction']}, "
              f"warm-hit {snap['warm_hit_rate']}, max submit lag "
              f"{run['max_submit_lag_ms']:.3f} ms (request "
              f"{run['max_lag_request']}), {snap['batches']} "
              f"batches (service p50 {run['service_ms']['p50']:.3f} ms, "
              f"max {run['service_ms']['max']:.3f}), launches {counts}"
              + (f" (the probe's {probe} taken off)" if name == "a" else "")
              + f"; every response bit-equal to the request served alone "
              f"and to the plain scan of its batch, on {smi}")
        if name == "a":
            print(f"   (a) hot swap after {SRV_SWAP_AT} requests: versions "
                  f"{sorted(versions)}, built and probed in "
                  f"{run['swap']['build_s']:.4f} s on its own stream, "
                  f"{run['swap']['batches_during_build']} batches served "
                  f"meanwhile (counted at the first submit that saw it); "
                  f"the slowest batch started "
                  f"{run['swap']['slowest_batch_after_publish_ms']:.1f} ms "
                  f"after the publish")
        del server, seen
    done(t0)

    t0 = phase(f"the request server with the trained full-width SASRec: "
               f"buckets (100, 200), max_batch 8, {SRV_SEQ_REQUESTS} "
               f"requests, the fused path")
    cfg = seq_model.cfg
    registry = serve.CatalogueRegistry(prune=False)
    registry.publish(seq_params["item_emb"]["codes"], int(seq_model.emb.cfg.b))
    spec = engine_mod.RetrievalSpec(kind="jpq", k=SRV_K)
    server = serve.RetrievalServer(
        serve.ReplicaPool([serve.Replica(seq_model, seq_params, k=SRV_K,
                                         spec=spec)]),
        registry, max_batch=8, max_delay=0.005, buckets=(100, 200))
    for L in server.queue.buckets:
        server.pool.replicas[0].serve(
            serve.Batch([serve.Request(-1, np.ones(L, np.int32))], L, 8),
            registry.live())
    hists = serve.request_stream(SRV_SEQ_REQUESTS, n_items=cfg.n_items,
                                 max_len=300, reserved=(0, cfg.mask_id),
                                 seed=1)
    kc.reset_launches()
    submitted = serve.run_open_loop(
        server, hists, serve.poisson_arrivals(500.0, len(hists), seed=1))
    server.drain()
    counts = dict(kc.launches)
    check(counts["jpq_topk"] > 0, f"the SASRec server launched {counts}")
    bound = seq_model.bind_engine(seq_params, spec)
    overlong = 0
    for (rid, _), hist in zip(submitted, hists):
        overlong += hist.size > 200
        L = server.queue.bucket_of(hist.size)
        padded = torch.as_tensor(serve.Batch(
            [serve.Request(rid, hist)], L, 8).padded_hist(), device=dev)
        with torch.inference_mode():
            rv, ri = bound.retrieve(padded)
            s = seq_model.score_last(seq_params, padded)
            sv, si = engine_mod.rerank_candidates(
                s, torch.arange(s.shape[1], dtype=torch.int32,
                                device=dev).expand_as(s), SRV_K)
        res = server.result(rid)
        for v, i, what in ((rv, ri, "served alone"),
                           (sv, si, "the top-10 of score_last")):
            check(same(res, v[0].cpu().numpy(), i[0].cpu().numpy()),
                  f"SASRec server: request {rid} != {what}")
    check(overlong > 0, "no SASRec request was longer than 200")
    snap = server.metrics.snapshot()
    out["sasrec"] = {"requests": len(hists), "overlong": int(overlong),
                     "batches": snap["batches"],
                     "latency_ms": snap["latency_ms"], "launches": counts,
                     "bit_equal_alone": True, "equal_score_last": True}
    print(f"   {len(hists)} requests ({overlong} longer than 200) in "
          f"{snap['batches']} batches, p50={snap['latency_ms']['p50']:.3f} "
          f"ms; each bit-equal to its alone-at-shape reference and to the "
          f"top-{SRV_K} of score_last (launches {counts})")
    del server, registry, bound
    done(t0)

    t0 = phase("both top-k kernels at the server's shape: B = 8 and 64, "
               "full-width catalogue, real batches' LUTs (CUDA events); "
               "a batch's host and device time")
    st = engine_mod.build_prune_state(codes, b)       # run (a)'s v1
    group = kc.pruned_group_size()
    hists = serve.request_stream(64, n_items=model.cfg.n_items,
                                 max_len=model.cfg.hist_len, seed=0)
    shapes = {}
    for Bq in (8, 64):
        hist = serve.Batch([serve.Request(i, h) for i, h in
                            enumerate(hists[:Bq])], model.cfg.hist_len,
                           Bq).padded_hist()
        P = lut(hist)
        cold = (torch.full((Bq,), -float("inf"), device=dev),
                torch.full((Bq, SRV_K), -float("inf"), device=dev),
                torch.zeros((Bq, SRV_K), dtype=torch.int32, device=dev))
        pr = dict(k=SRV_K, block_n=st.block_n, tie_break_ids=st.tie_break_ids)
        args_p = (P, st.codes, st.ids, st.present, *cold)
        top = kc.jpq_topk(P, codes, SRV_K)
        ranges = kc.launch_shape["ranges"]
        blocks_u = kc.launch_shape["blocks"]
        pv, pi, skip = kc.jpq_topk_pruned(*args_p, **pr)
        # both kernels against their plain versions at this launch plan
        plain = ops.jpq_topk_scan(P, codes, SRV_K,
                                  block_n=ops.scan_block_n(n_rows))
        ppv, ppi, pskip = ops.jpq_topk_scan_pruned(*args_p, **pr)
        check(bits_equal(top[0], plain[0]) and torch.equal(top[1], plain[1]),
              f"jpq_topk != plain at B={Bq}")
        check(bits_equal(pv, ppv) and torch.equal(pi, ppi)
              and bits_equal(pv, plain[0]) and torch.equal(pi, plain[1]),
              f"jpq_topk_pruned != plain at B={Bq}")
        check(torch.equal(skip.min(0).values, pskip),
              f"pruned skip map != plain at B={Bq}")
        row = {}
        for kname, fn, work in (
                ("jpq_topk", lambda: kc.jpq_topk(P, codes, SRV_K),
                 topk_work(Bq, n_rows, SRV_K)),
                ("jpq_topk_pruned", lambda: kc.jpq_topk_pruned(*args_p, **pr),
                 pruned_work(torch, st, skip, Bq, SRV_K)[:3])):
            b_ms, b_by, _ = bound_of(*work)
            row[kname] = {"ms": cuda_ms(fn, 50), "bound_ms": b_ms,
                          "bound_by": b_by}
        row["jpq_topk"].update(
            blocks=blocks_u, ranges=ranges,
            max_abs_err=float((top[0] - plain[0]).abs().max()))
        row["jpq_topk_pruned"].update(
            blocks=-(-Bq // group),
            skip_fraction=float(skip.float().mean()),
            max_abs_err=float((pv - ppv).abs().max()))
        shapes[Bq] = row
        for kname, r in row.items():
            print(f"   B={Bq} {kname}: {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{r['blocks']} blocks, bit-equal to plain"
                  + (f", skip fraction {r['skip_fraction']:.4f}"
                     if "skip_fraction" in r else
                     f" ({r['ranges']} item ranges)") + f", on {smi}")
    for kname, run in (("jpq_topk", "c"), ("jpq_topk_pruned", "a")):
        per = out[run]["launches_per_request"][kname]
        for Bq in shapes:
            shapes[Bq][kname]["launches_per_request"] = per
        print(f"   {kname}: {per:.4f} launches a request in run ({run})")
    out["kernels_at_server_shape"] = shapes
    # where a batch's service time goes: one replica serves 20 real
    # batches of 8 (bucket 50) on the host clock, then again under
    # torch.profiler for the card's busy time
    hists = serve.request_stream(160, n_items=model.cfg.n_items,
                                 max_len=model.cfg.hist_len, seed=2)
    batches = [serve.Batch([serve.Request(j, h) for j, h in
                            enumerate(hists[i:i + 8])],
                           model.cfg.hist_len, 8) for i in range(0, 160, 8)]
    out["batch_split"] = {}
    for label, prune in (("pruned", True), ("unpruned", False)):
        registry = serve.CatalogueRegistry(prune=prune)
        registry.publish(codes, b)
        live, rep = registry.live(), serve.Replica(model, params, k=SRV_K)
        rep.serve(batches[0], live)
        t1 = time.perf_counter()
        for bt in batches:
            rep.serve(bt, live)
        host_ms = (time.perf_counter() - t1) * 1e3 / len(batches)
        busy_ms, top = device_profile(
            torch, lambda bt, rep=rep, live=live: rep.serve(bt, live),
            batches)
        check(busy_ms > 0, f"the profiler traced no device time ({label})")
        out["batch_split"][label] = {"host_ms": host_ms,
                                     "device_busy_ms": busy_ms,
                                     "idle_share": 1 - busy_ms / host_ms,
                                     "top": top}
        print(f"   a batch of 8, {label}: {host_ms:.3f} ms on the host "
              f"clock, the card busy {busy_ms:.3f} ms of it (idle "
              f"{1 - busy_ms / host_ms:.2f}); largest device items "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in top))
        del registry, live, rep
    del st, P, model, params, codes
    done(t0)
    return out


def example_phases(torch, np, dev, smi):
    """Phases 13-15: the port's three examples on the card, as a user runs
    them (``python -m repro_torch.examples.<name>``): the quickstart at
    50 steps, serve_retrieval as shipped, and the paper-validation grid
    (2 profiles x 3 archs x 5 variants) at ``GRID_STEPS`` steps, the
    launch counters zeroed before each and read after.  Then the training
    kernels at every shape these runs gave them (``example_shape_times``:
    the eval shapes as the jpq_scores wrapper recorded them at each run's
    last launch, its ``score_last``).  Returns the summary of the
    three."""
    from repro_torch.examples import paper_validation as pv
    from repro_torch.examples import quickstart, serve_retrieval
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_topk import cuda as kc

    counters = (kc, sc, lc)
    train_kernels = ("jpq_scores", "jpq_scores_bwd", "jpq_lookup",
                     "jpq_lookup_bwd")

    def reset():
        for c in counters:
            c.reset_launches()

    def read():
        return {k: v for c in counters for k, v in c.launches.items() if v}

    def eval_shape(what, n_rows):
        """(T, N) of the last jpq_scores launch: the run's score_last."""
        T, N = sc.fwd_launch_shape["T"], sc.fwd_launch_shape["N"]
        check(N == n_rows, f"{what}: the last jpq_scores launch was over "
              f"{N} rows, not the {n_rows} of its catalogue")
        return T

    # (what, scores T, lookup T, N, b, dk, backward too): the shapes the
    # examples ran the training kernels at
    shapes = []
    out = {}
    t0 = phase("example: quickstart --steps 50 (SASRec base vs RecJPQ-svd)")
    reset()
    qs = quickstart.main(["--steps", "50"])
    launches = read()
    for name in train_kernels:
        check(launches.get(name, 0) > 0, f"quickstart never launched {name}")
    for variant, r in qs.items():
        check(all(np.isfinite([r["ndcg10"], r["hr10"], r["final_loss"]])),
              f"quickstart {variant}: non-finite result {r}")
    check(qs["recjpq-svd"]["param_bytes"] < qs["base"]["param_bytes"],
          "quickstart: RecJPQ model not smaller than the base")
    qs_n = quickstart.N_ITEMS + 2
    qs_args = quickstart.build_parser().parse_args([])
    qs_dk = qs_args.d_model // qs_args.m
    qs_eval = eval_shape("quickstart", qs_n)
    qs_train = quickstart.BATCH * quickstart.SEQ_LEN
    shapes += [("quickstart train", qs_train, qs_train, qs_n,
                quickstart.CENTROIDS, qs_dk, True),
               ("quickstart eval", qs_eval, qs_eval * quickstart.SEQ_LEN,
                qs_n, quickstart.CENTROIDS, qs_dk, False)]
    out["quickstart"] = {**qs, "launches": launches}
    print(f"   launches {launches}")
    done(t0)

    t0 = phase("example: serve_retrieval (two-tower, N=200,000, B=1/32/256)")
    reset()
    sr = serve_retrieval.main([])
    launches = read()
    for name in ("jpq_topk", "jpq_topk_pruned", "jpq_scores"):
        check(launches.get(name, 0) > 0,
              f"serve_retrieval never launched {name}")
    check(sr["fused_ids_equal"] and sr["pruned_ids_equal"],
          "serve_retrieval: fused, materialise and pruned ids differ")
    check(sr["fused_max_abs_dv"] == 0.0,
          f"serve_retrieval: fused values differ from materialise's by "
          f"{sr['fused_max_abs_dv']}")
    check(sr["jpq_scores_max_abs_diff"] == 0.0,
          "serve_retrieval: jpq_scores kernel != gather path")
    out["serve_retrieval"] = {**sr, "launches": launches}
    print(f"   launches {launches}")
    done(t0)

    t0 = phase(f"example: paper_validation grid, 2 profiles x 3 archs x 5 "
               f"variants at --steps {GRID_STEPS}")
    profiles = ("ml1m", "gowalla")
    data_cfg = {p: pv.make_data(p).cfg for p in profiles}
    rows, grid_eval = [], {}
    runs = pv.grid(list(profiles), ["sasrec", "bert4rec", "gru4rec"],
                   steps=GRID_STEPS, device=dev)
    while True:
        reset()
        row = next(runs, None)
        if row is None:
            break
        row["launches"] = read()
        check(np.isfinite(row["ndcg10"]), f"grid row not finite: {row}")
        if row["variant"].startswith("jpq"):
            for name in train_kernels:
                check(row["launches"].get(name, 0) > 0,
                      f"grid {row['dataset']}/{row['arch']}/"
                      f"{row['variant']} never launched {name}")
            n_rows = data_cfg[row["dataset"]].n_items + 2
            grid_eval.setdefault(row["dataset"], set()).add(
                (eval_shape(f"grid {row['dataset']}", n_rows), n_rows))
        rows.append(row)
        print(f"   {row}")
    check(len(rows) == 30, f"the grid ran {len(rows)} of 30 runs")
    grid_dk = pv.D_MODEL // pv.CODE_LEN
    for p in profiles:
        check(len(grid_eval[p]) == 1, f"grid {p}: eval shapes "
              f"{grid_eval[p]} differ between runs")
        (T_eval, n_rows), = grid_eval[p]
        S = data_cfg[p].seq_len
        shapes += [(f"{p} train", pv.BATCH * S, pv.BATCH * S, n_rows,
                    pv.CENTROIDS, grid_dk, True),
                   (f"{p} eval", T_eval, T_eval * S, n_rows, pv.CENTROIDS,
                    grid_dk, False)]
    out["paper_validation"] = rows
    print(json.dumps({"paper_validation": rows, "steps": GRID_STEPS,
                      "card": smi}))
    done(t0)

    t0 = phase("the kernels at the examples' shapes: parity, then timing "
               "(CUDA events)")
    out["example_shapes"] = example_shape_times(torch, dev, smi, shapes)
    print(json.dumps({"example_shapes": out["example_shapes"],
                      "card": smi}))
    done(t0)
    return out


def example_shape_times(torch, dev, smi, shapes):
    """The kernels at the shapes the examples gave them, each held
    against its plain version and timed beside it and its bound.  The
    training kernels at each of ``shapes`` ((what, scores T, lookup T,
    N, b, dk, backward too): the quickstart's b = 256 and the grid's
    b = 64, training and eval): forwards bit-equal, backwards
    deterministic and within the fp32 sum bound (``scores_bwd_err``,
    ``lookup_errs``).  Then jpq_topk at serve_retrieval's B = 1, 32 and
    256 over its 200,192 rows, values bit-equal and ids equal."""
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_lookup import ref as lref
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.kernels.jpq_topk import ops

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for what, T, T_look, N, b, dk, bwd in shapes:
        codes = torch.randint(0, b, (N, M), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        P = torch.randn((T, M, b), generator=gen, device=dev)
        cent = torch.randn((M, b, dk), generator=gen, device=dev)
        ids = torch.randint(0, N, (T_look,), generator=gen, device=dev)
        dS = torch.randn((T, N), generator=gen, device=dev) if bwd else None
        dout = (torch.randn((T_look, M, dk), generator=gen, device=dev)
                if bwd else None)
        err = {"jpq_scores": scores_fwd_err(P, codes, what)}
        err["jpq_lookup"], err["jpq_lookup_bwd"] = lookup_errs(
            ids, codes, cent, dout, what)
        cases = {
            "jpq_scores": (T, lambda: sc.jpq_scores(P, codes),
                           lambda: sref.jpq_scores_lut_ref(P, codes)),
            "jpq_lookup": (T_look, lambda: lc.jpq_lookup(ids, codes, cent),
                           lambda: lref.jpq_lookup_ref(ids, codes, cent)),
        }
        if bwd:
            err["jpq_scores_bwd"] = scores_bwd_err(dS, codes, b, what)[0]
            cases["jpq_scores_bwd"] = (
                T, lambda: sc.jpq_scores_bwd(dS, codes, b),
                lambda: sref.jpq_scores_lut_bwd_ref(dS, codes, b))
            cases["jpq_lookup_bwd"] = (
                T_look, lambda: lc.jpq_lookup_bwd(ids, codes, dout, b),
                lambda: lref.jpq_lookup_bwd_ref(ids, codes, dout, b))
        for name, (T_k, kern, plain) in cases.items():
            b_ms, b_by = bound(*train_kernel_work(T_k, N, b, dk)[name])
            rows.append({"shape": what, "name": name, "T": T_k, "N": N,
                         "b": b, "dk": dk, "max_abs_err": err[name],
                         "ms": cuda_ms(kern, 50),
                         "plain_ms": cuda_ms(plain, 10), "bound_ms": b_ms,
                         "bound_by": b_by})
        del codes, P, cent, ids, dS, dout
    N, k = 200_192, 10
    codes = torch.randint(0, BC, (N, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    for Bq in (1, 32, 256):
        P = ops.canonicalise_lut(torch.randn((Bq, M, BC), generator=gen,
                                             device=dev)).contiguous()
        want = ops.jpq_topk_scan(P, codes, k, block_n=ops.scan_block_n(N))
        got = kc.jpq_topk(P, codes, k)
        check(bits_equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"jpq_topk != plain (serve_retrieval, B={Bq})")
        b_ms, b_by, _ = bound_of(*topk_work(Bq, N, k))
        rows.append({"shape": f"serve B={Bq}", "name": "jpq_topk", "B": Bq,
                     "N": N, "max_abs_err": float(
                         (got[0] - want[0]).abs().max()),
                     "ms": cuda_ms(lambda: kc.jpq_topk(P, codes, k), 50),
                     "plain_ms": cuda_ms(lambda: ops.jpq_topk_scan(
                         P, codes, k, block_n=ops.scan_block_n(N)), 5),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "launch_shape": dict(kc.launch_shape)})
    for r in rows:
        print(f"   {r['name']} ({r['shape']}, T/B={r.get('T', r.get('B'))}, "
              f"N={r['N']}): {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} "
              f"ms plain, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"max |err| {r['max_abs_err']:.3e} on {smi}")
    return rows


# the CTR serving slice: the archs served, those whose path runs
# embedding_bag, and the kernel's shapes on that path
CTR_ARCHS = ("two-tower-retrieval", "fm", "fm-jpq", "dlrm-rm2",
             "dlrm-rm2-jpq", "dien", "dien-jpq")
BAG_ARCHS = ("two-tower-retrieval", "fm", "fm-jpq")
BAG_SHAPES = {   # V, d, n_bags, L, weights
    "two-tower B=512": (1_000_448, 256, B, 50, "masked"),
    "FM linear B=512": (3_090_000, 1, B, 39, None),
    "FM candidates n_bags=1": (3_090_000, 1, 1, 38, None),
    "two-tower B=65536": (1_000_448, 256, 65_536, 50, "masked"),
}


@contextlib.contextmanager
def plain_bag():
    """``ops.embedding_bag`` on CUDA tensors, forward and backward, and
    the table gathers' backward (``ops.gather``), through their plain
    versions for the duration (to hold the kernels' callers against
    them)."""
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ref as eref
    kernels = ec.embedding_bag, ec.embedding_bag_backward, ec.gather_backward
    ec.embedding_bag = eref.embedding_bag_ref
    ec.embedding_bag_backward = eref.embedding_bag_backward_ref
    ec.gather_backward = (lambda ids, dout, V, order=None:
                          eref.gather_backward_ref(ids, dout, V))
    try:
        yield
    finally:
        (ec.embedding_bag, ec.embedding_bag_backward,
         ec.gather_backward) = kernels


def ctr_phases(torch, np, dev, smi, data, tt_template):
    """Phases 9-11: embedding_bag's parity on the card, the CTR serving
    main path (seven archs at full width) and embedding_bag's timing.
    Returns (embedding_bag's entry of the kernels line, the serve_ctr
    summary)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_bundle
    from repro_torch.core import engine as engine_mod
    from repro_torch.data.clicks import ClickDataConfig, SyntheticClicks
    from repro_torch.data.clicks import dien_batch
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag import ref as eref
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.launch import serve as serve_mod

    counters = (ec, kc, sc, lc)

    gen = torch.Generator(device=dev).manual_seed(3)
    tables = {}

    def bag_case(V, d, n, L, weights):
        """A table whose pad row 0 is all negative (one per (V, d)), ids
        with left padding in a quarter of the bags and, where there is
        more than one bag, one all-padding bag (bag 1), and mask, unit
        (None) or random weights."""
        if (V, d) not in tables:
            tab = torch.randn((V, d), generator=gen, device=dev)
            tab[0] = -tab[0].abs() - 0.25
            tables[(V, d)] = tab
        ids = torch.randint(0, V, (n, L), generator=gen, device=dev)
        ids[: n // 4, : L // 2] = 0
        if n > 1:
            ids[1] = 0
        w = {None: None, "masked": (ids > 0).float(),
             "random": torch.randn((n, L), generator=gen, device=dev)}[weights]
        return tables[(V, d)], ids, w

    t0 = phase("embedding_bag parity on the card (tolerance 0)")
    err = 0.0
    cases = {name: bag_case(*shape) for name, shape in BAG_SHAPES.items()}
    for name, (tab, ids, w) in cases.items():
        kern = ec.embedding_bag(tab, ids, w)
        plain = eref.embedding_bag_ref(tab, ids, w)
        check(bits_equal(kern, plain), f"embedding_bag != plain ({name})")
        err = max(err, float((kern - plain).abs().max()))
        padded = w is not None and ids.shape[0] > 1
        if padded:   # the all-padding bag: -0.0 from the pad row
            check(bool((kern[1] == 0).all()) and
                  bool(torch.signbit(kern[1]).all()),
                  f"all-padding bag is not -0.0 ({name})")
        print(f"   {name} (V={tab.shape[0]} d={tab.shape[1]} "
              f"n_bags={ids.shape[0]} L={ids.shape[1]}): bit-equal"
              + (", all-padding bag -0.0" if padded else ""))
    tab, ids, _ = cases["two-tower B=512"]
    rand_w = torch.randn(ids.shape, generator=gen, device=dev)
    for weights, combiner in ((None, "sum"), (None, "mean"),
                              (rand_w, "sum"), (rand_w, "mean")):
        kern = eops.embedding_bag(tab, ids, weights, combiner=combiner)
        with plain_bag():
            plain = eops.embedding_bag(tab, ids, weights, combiner=combiner)
        what = f"{combiner}, {'random' if weights is not None else 'no'} " \
            f"weights"
        check(bits_equal(kern, plain), f"embedding_bag != plain ({what})")
        err = max(err, float((kern - plain).abs().max()))
    print("   ops.embedding_bag, combiner sum and mean, weights None and "
          "random: bit-equal")
    bad = ids.clone()
    bad[7, 3] = tab.shape[0]
    try:
        ec.embedding_bag(tab, bad)
        check(False, "embedding_bag read an id outside [0, V)")
    except IndexError as e:
        print(f"   out-of-range id refused: {e}")
    del kern, plain, bad, rand_w
    done(t0)

    t0 = phase("embedding_bag timing (CUDA events): kernel, kernel + id "
               "check, plain version, F.embedding_bag, bound")
    timing = {}
    for name, (tab, ids, w) in cases.items():
        n, L = ids.shape
        d = tab.shape[1]
        iters = 20 if n > B else 200
        # bytes: the distinct rows the ids name (a row named twice need
        # not be read twice), the ids, the weights and the output; the
        # count with every gathered row read once is printed beside it
        small = ids.numel() * ids.element_size() + n * d * 4 \
            + (0 if w is None else w.numel() * 4)
        rows = torch.unique(ids).numel()
        b_ms, b_by = bound(rows * d * 4 + small,
                           {"fp32 FMAs": (n * L * d, FADD_PER_S)})
        all_rows_ms = (n * L * d * 4 + small) / HBM_BYTES_PER_S * 1e3
        timing[name] = {
            "ms": cuda_ms(lambda: ec.launch(tab, ids, w), iters),
            "checked_ms": cuda_ms(lambda: ec.embedding_bag(tab, ids, w),
                                  iters),
            "plain_ms": cuda_ms(lambda: eref.embedding_bag_ref(tab, ids, w),
                                max(iters // 10, 2)),
            "library_ms": cuda_ms(lambda: F.embedding_bag(
                ids, tab, mode="sum", per_sample_weights=w), iters),
            "bound_ms": b_ms, "bound_by": b_by, "distinct_rows": rows,
            "bound_all_rows_ms": all_rows_ms}
        t = timing[name]
        # the card's own time a call (torch.profiler), apart from the
        # host's issue time that the event times above may show
        n_prof = 10 if n > B else 50
        for key, f in (("device_ms", lambda _: ec.launch(tab, ids, w)),
                       ("library_device_ms", lambda _: F.embedding_bag(
                           ids, tab, mode="sum", per_sample_weights=w))):
            t[key], top = device_profile(torch, f, range(n_prof))
            check(t[key] > 0, f"the profiler traced no device time for "
                  f"embedding_bag ({name}, {key})")
            t[key + "_top"] = top
        print(f"   {name}: {t['ms']:.4f} ms kernel (device "
              f"{t['device_ms']:.4f}), {t['checked_ms']:.4f} ms "
              f"with the id check, {t['plain_ms']:.4f} ms plain, "
              f"{t['library_ms']:.4f} ms F.embedding_bag (device "
              f"{t['library_device_ms']:.4f}: "
              + "; ".join(f"{k} {v:.4f}" for k, v in
                          t["library_device_ms_top"]) + "), bound "
              f"{b_ms:.4f} ms ({b_by}; {rows} distinct rows; "
              f"{all_rows_ms:.4f} ms with all {n * L} rows) on {smi}")
    del cases, tables, tab, ids, w
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase(f"main path: CTR serving at full width, {REQUESTS} requests "
               f"of B={B} (+ 1 warm-up) per arch")
    serve_ctr = {"embedding_bag_ms": timing}

    def streams(name, model, n):
        """Fresh request batches for ``name``: SyntheticClicks for FM and
        DLRM, dien_batch for DIEN, phase 4's Zipf template (make_requests)
        for the two-tower model."""
        if name.startswith("two-tower"):
            return serve_mod.make_requests(tt_template, B, n, seed=7,
                                           reserved=(0,))
        if name.startswith("dien"):
            return ({k: b[k] for k in ("hist", "target")}
                    for b in (dien_batch(data, s, B, model.cfg.seq_len)
                              for s in range(n)))
        keys = ("sparse",) if name.startswith("fm") else ("dense", "sparse")
        clicks = SyntheticClicks(ClickDataConfig(
            n_dense=getattr(model.cfg, "n_dense", 13),
            vocab_sizes=model.cfg.vocabs(), seed=0))
        return ({k: b[k] for k in keys}
                for b in (clicks.batch(s, B) for s in range(n)))

    def sync():
        torch.cuda.synchronize(dev)

    for name in CTR_ARCHS:
        check(torch.cuda.memory_allocated(dev) < 2e9,
              f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB still "
              f"allocated before {name}")
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        model = get_bundle(name).make_model(device=dev, seed=0)
        params = model.params()
        sync()
        build_s = time.perf_counter() - t1
        args = serve_mod.build_parser().parse_args(
            ["--arch", name, "--batch-size", str(B), "--requests",
             str(REQUESTS), "--device", "cuda"])
        for c in counters:
            c.reset_launches()
        res = serve_mod.serve_loop(model, params, tt_template, args,
                                   requests=streams(name, model,
                                                    REQUESTS + 1))
        launches = {k: v for c in counters for k, v in c.launches.items()
                    if v}
        if name in BAG_ARCHS:
            check(ec.launches["embedding_bag"] > 0,
                  f"the {name} serving run never launched embedding_bag")
        # one more request: the output's form, and (where the path runs
        # embedding_bag) the same request through the plain version
        req = next(iter(streams(name, model, REQUESTS + 2)))
        with torch.inference_mode():
            if name.startswith("two-tower"):
                spec = engine_mod.RetrievalSpec(kind="full", k=10)
                fn = model.bind_engine(params, spec).retrieve
                v, i = out = fn(req)
                check(tuple(v.shape) == (B, 10) and
                      bool(torch.isfinite(v).all()) and
                      bool(((i >= 0) &
                            (i < params["item_emb"]["table"].shape[0])).all()),
                      f"{name}: malformed top-10")
            else:
                fn = lambda r: model.serve(params, r)  # noqa: E731
                out = fn(req)
                check(tuple(out.shape) == (B,) and
                      bool(torch.isfinite(out).all()) and
                      bool(((out >= 0) & (out <= 1)).all()),
                      f"{name}: serve output not finite in [0, 1]")
            if name in BAG_ARCHS:
                with plain_bag():
                    plain = fn(req)
                if isinstance(out, tuple):
                    same = bits_equal(out[0], plain[0]) and \
                        torch.equal(out[1], plain[1])
                else:
                    same = bits_equal(out, plain)
                check(same, f"{name}: kernel path != plain path on the "
                      f"same request")
            # where a request's time goes: the card's busy time against
            # the unprofiled p50 (the rest is the host issuing work)
            busy_ms, top = device_profile(
                torch, fn, list(streams(name, model, 3)))
            # candidate scoring for one context over the catalogue
            rng = np.random.default_rng(11)
            t1 = time.perf_counter()
            if name.startswith("fm"):
                rest = next(iter(streams(name, model, 1)))["sparse"][:1, 1:]
                cand = model.candidate_scores(params, {"sparse_rest": rest})
                n_cand = model.cfg.vocabs()[0]
                sync()
                cand_ms = (time.perf_counter() - t1) * 1e3
                with plain_bag():
                    plain_cand = model.candidate_scores(
                        params, {"sparse_rest": rest})
                check(bits_equal(cand, plain_cand),
                      f"{name}: candidate_scores through the kernel != "
                      f"through the plain version")
                del plain_cand
            elif name.startswith("dlrm"):
                b = next(iter(streams(name, model, 1)))
                n_cand = model.cfg.vocabs()[0]          # the item field
                cand = model.score_candidates(params, {
                    "dense": b["dense"][:1], "sparse_rest": b["sparse"][:1, 1:],
                    "candidates": rng.permutation(n_cand)})
            elif name.startswith("dien"):
                n_cand = model.cfg.n_items
                cand = model.score_candidates(params, {
                    "hist": req["hist"][:1],
                    "candidates": rng.permutation(n_cand) + 1})
            else:
                cand, n_cand = None, 0
            sync()
            if not name.startswith("fm"):
                cand_ms = (time.perf_counter() - t1) * 1e3 if n_cand else None
        if cand is not None:
            check(cand.numel() == n_cand and bool(torch.isfinite(cand).all()),
                  f"{name}: candidate scores malformed")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        serve_ctr[name] = {"path": res["path"], "p50_ms": res["p50_ms"],
                           "p99_ms": res["p99_ms"], "peak_gb": peak_gb,
                           "build_s": build_s, "launches": launches,
                           "candidates": n_cand, "candidates_ms": cand_ms,
                           "device_busy_ms": busy_ms,
                           "idle_share": (1 - busy_ms / res["p50_ms"]
                                          if busy_ms else None),
                           "top_device_ms": top}
        print(f"   {name}: device busy {busy_ms:.3f} ms a request (of p50 "
              f"{res['p50_ms']:.3f} ms); top: "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
        print(f"   {name}: p50={res['p50_ms']:.3f}ms p99={res['p99_ms']:.3f}"
              f"ms peak {peak_gb:.2f} GB (built in {build_s:.1f}s), "
              f"launches {launches}"
              + (f", {n_cand} candidates in {cand_ms:.1f} ms"
                 if n_cand else "")
              + (", kernel == plain on one request" if name in BAG_ARCHS
                 else "")
              + (" and on candidate_scores" if name.startswith("fm") else "")
              + f" on {smi}")
        del model, params, out, req, fn, cand
        if name in BAG_ARCHS:
            del plain
        gc.collect()
        torch.cuda.empty_cache()
    done(t0)

    main_t = timing["two-tower B=512"]
    entry = {"name": "embedding_bag", "route": "cuda",
             "source": "src/repro_torch/csrc/embedding_bag.cu",
             "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:59",
             "launches": sum(r["launches"].get("embedding_bag", 0)
                             for r in serve_ctr.values() if "launches" in r),
             "max_abs_err": err, "ms": main_t["ms"],
             "checked_ms": main_t["checked_ms"],
             "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
             "bound_by": main_t["bound_by"],
             "library_ms": main_t["library_ms"],
             "device_ms": main_t["device_ms"],
             "library_device_ms": main_t["library_device_ms"]}
    return entry, serve_ctr


# the CTR training slice: the bundles trained at full width, their batch
# and steps, the peak they must stay under, the bundles whose path runs
# the embedding_bag (bag) kernels, and the backward's shapes in phase 23
# (ids "uniform" as the training data draws them, "padded" with ~10% pad
# slots of weight 0, "skewed": half of all positions one row, "dien":
# one training slice's hist, hist_neg and target ids from dien_batch,
# "dien-jpq": the same ids' flat centroid ids j * b + code over random
# codes, "run": 100,000 of the positions one row; weights "masked", None
# or "gather": the table gathers' route, L = 1 and unit weights)
CTR_TRAIN_ARCHS = ("two-tower-retrieval", "two-tower-retrieval-jpq", "fm",
                   "fm-jpq", "dlrm-rm2-jpq", "dien", "dien-jpq")
CTR_B, CTR_STEPS, PEAK_LIMIT = 65_536, 5, 70e9
DIEN_SLICE, DIEN_ROWS, DIEN_M, DIEN_B = 32_768, 1_000_001, 6, 256
BAG_BWD_SHAPES = {   # V, d, n_bags, L, ids, weights
    "two-tower B=65536, 10% pads": (1_000_448, 256, 65_536, 50, "padded",
                                    "masked"),
    "FM linear B=65536": (3_090_000, 1, 65_536, 39, "uniform", None),
    "two-tower B=512, 10% pads": (1_000_448, 256, B, 50, "padded", "masked"),
    "FM linear B=512": (3_090_000, 1, B, 39, "uniform", None),
    "FM linear B=65536, skewed": (3_090_000, 1, 65_536, 39, "skewed", None),
    "DIEN gather, a training slice": (DIEN_ROWS, 18, DIEN_SLICE * 201, 1,
                                      "dien", "gather"),
    "DIEN-jpq flat centroid gather": (DIEN_M * DIEN_B, 3,
                                      DIEN_SLICE * 201 * DIEN_M, 1,
                                      "dien-jpq", "gather"),
    "a 100K-term run, d=18": (DIEN_ROWS, 18, 400_000, 1, "run", "gather"),
}


def bag_bwd_parity(torch, ids, w, dout, V, what, gather=False):
    """embedding_bag's backward kernels on (ids, w, dout) — with
    ``gather``, the table gathers' route (``cuda.gather_backward``: L =
    1, unit weights) — bit-identical across two calls, bit-equal to its
    plain version run on CPU copies (one chain a row in ascending
    position from +0.0), and |kernel - float64| <= gamma_n sum|w dout| a
    row (n: its positions; the float64 plain version on the card).
    Returns {"f64_err", "longest_chain", "rows_named"}."""
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ref as eref
    if gather:
        def whole():
            return ec.gather_backward(ids, dout, V)
        on_cpu = eref.gather_backward_ref(ids.cpu(), dout.cpu(), V)
    else:
        def whole():
            return ec.embedding_bag_backward(ids, w, dout, V)
        on_cpu = eref.embedding_bag_backward_ref(
            ids.cpu(), None if w is None else w.cpu(), dout.cpu(), V)
    got = whole()
    check(bits_equal(got, whole()),
          f"embedding_bag backward differs between calls ({what})")
    check(bits_equal(got.cpu(), on_cpu),
          f"embedding_bag backward != plain on the CPU ({what})")
    del on_cpu
    wd = None if w is None else w.double()
    want = eref.embedding_bag_backward_ref(ids, wd, dout.double(), V)
    mass = eref.embedding_bag_backward_ref(
        ids, None if wd is None else wd.abs(), dout.double().abs(), V)
    cnt = torch.bincount(ids.reshape(-1).long(), minlength=V).double()
    lim = (cnt * U / (1 - cnt * U))[:, None] * mass
    diff = (got.double() - want).abs_()
    check(bool((diff <= lim).all()),
          f"embedding_bag backward outside the fp32 sum bound ({what})")
    row = {"f64_err": float(diff.max()), "longest_chain": int(cnt.max()),
           "rows_named": int((cnt > 0).sum())}
    del got, want, mass, lim, diff, cnt, wd
    torch.cuda.empty_cache()
    return row


def bag_bwd_row(torch, ids, w, dout, V, iters, what, smi, clock_hz,
                gather=False):
    """embedding_bag's backward kernels on (ids, w, dout), held as
    ``bag_bwd_parity`` holds them (with ``gather``, the table gathers'
    route).  Then
    timed by CUDA events: the whole call as autograd runs it (the sort
    and the id check in), the kernels alone on an order made
    beforehand (and the short-run kernel alone), the sort apart, the plain version on the card, the one
    PyTorch call (``F.embedding_bag``'s backward for a bag,
    ``F.embedding``'s for a gather), ``torch.zeros`` + ``index_add_``
    over the products (atomics, no fixed order), ``zero_`` of dtable
    (the write alone), for a gather today's
    ``table[ids]`` backward, the bytes bound and the chain bound (the
    longest run's dependent adds at 4 cycles each); and the card's own
    time of the kernels under ``torch.profiler``.  Returns the row."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ref as eref
    dev = dout.device
    n, L = ids.shape
    d, P = dout.shape[1], n * L
    if gather:
        def whole():
            return ec.gather_backward(ids, dout, V)
    else:
        def whole():
            return ec.embedding_bag_backward(ids, w, dout, V)
    row = bag_bwd_parity(torch, ids, w, dout, V, what, gather=gather)
    order = ec.sort_ids(ids, V, wrap=gather)
    row["long_runs"] = order.n_long
    row["whole_ms"] = cuda_ms(whole, iters)
    row["ms"] = cuda_ms(
        lambda: ec.launch_backward(ids, w, dout, V, order=order), iters)
    row["rows_ms"] = cuda_ms(lambda: ec.launch_backward(
        ids, w, dout, V, order=order, rows_only=True), iters)
    row["sort_ms"] = cuda_ms(lambda: ec.sort_ids(ids, V, wrap=gather),
                             iters)
    row["plain_ms"] = cuda_ms(
        lambda: eref.embedding_bag_backward_ref(ids, w, dout, V),
        max(iters // 5, 2))
    flat = ids.reshape(-1)
    prods = dout.repeat_interleave(L, 0)
    if w is not None:
        prods = w.reshape(-1, 1) * prods
    row["index_add_ms"] = cuda_ms(lambda: torch.zeros(
        (V, d), device=dev).index_add_(0, flat, prods), iters)
    del prods
    # the table written once and nothing read: a floor for any kernel
    # that writes every row
    table = torch.empty((V, d), device=dev)
    row["write_ms"] = cuda_ms(lambda: table.zero_(), iters)
    # the one PyTorch call for the same function, its backward alone
    table = table.requires_grad_()
    if gather:
        lib_out = F.embedding(flat, table)
    else:
        lib_out = F.embedding_bag(ids, table, mode="sum",
                                  per_sample_weights=w)
    row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        lib_out, table, dout, retain_graph=True), iters)
    row["library"] = ("F.embedding backward" if gather
                      else "F.embedding_bag backward")
    del lib_out
    if gather:                       # today's table[ids] backward
        idx_out = table[flat]
        row["indexing_ms"] = cuda_ms(lambda: torch.autograd.grad(
            idx_out, table, dout, retain_graph=True), max(iters // 3, 1))
        del idx_out
    del table
    # dout, the ids and weights read once, dtable written once; a product
    # and an add a (position, column), each over the fp32 add rate
    bytes_ = (n * d * 4 + P * ids.element_size()
              + (0 if w is None else P * 4) + V * d * 4)
    ops = P * d * (1 if w is None else 2)
    row["bound_ms"], row["bound_by"] = bound(
        bytes_, {"fp32 adds and multiplies": (ops, FADD_PER_S)})
    row["bytes_bound_ms"] = bytes_ / HBM_BYTES_PER_S * 1e3
    row["chain_ms"] = row["longest_chain"] * 4 / clock_hz * 1e3
    row["device_ms"], top = device_profile(
        torch, lambda _: ec.launch_backward(ids, w, dout, V, order=order),
        range(5 if n > B else 20))
    check(row["device_ms"] > 0, f"the profiler traced no device time for "
          f"the embedding_bag backward ({what})")
    row["device_top"] = top
    row["shape"] = {"V": V, "d": d, "n_bags": n, "L": L,
                    "weights": "gather" if gather else w is not None}
    del order, flat
    torch.cuda.empty_cache()
    extra = (f", table[ids] backward {row['indexing_ms']:.4f} ms"
             if gather else "")
    print(f"   {what} (V={V} d={d} n_bags={n} L={L}): whole call "
          f"{row['whole_ms']:.4f} ms; kernels {row['ms']:.4f} ms (short "
          f"runs alone {row['rows_ms']:.4f}; device {row['device_ms']:.4f})"
          f", sort {row['sort_ms']:.4f} ms; plain "
          f"{row['plain_ms']:.4f} ms; {row['library']} "
          f"{row['library_ms']:.4f} ms, zeros + index_add_ "
          f"{row['index_add_ms']:.4f} ms{extra}; dtable's zero_ "
          f"{row['write_ms']:.4f} ms; bound {row['bound_ms']:.4f}"
          f" ms ({row['bound_by']}), chain bound {row['chain_ms']:.4f} ms "
          f"(longest chain {row['longest_chain']}, {row['long_runs']} long "
          f"runs); |err| vs float64 {row['f64_err']:.3e}; bit-identical "
          f"twice, bit-equal to the CPU, on {smi}")
    return row


def ctr_train_phases(torch, np, dev, smi, data):
    """Phases 23-24: the embedding_bag backward on the card, then CTR
    training at full width (seven bundles, one on the card at a time).
    Returns (the backward's entry of the kernels line, the forward's
    launches in training, the ctr_train summary)."""
    from repro_torch.configs import get_bundle
    from repro_torch.configs.recsys_archs import DLRM_VOCABS
    from repro_torch.data.clicks import ClickDataConfig, SyntheticClicks
    from repro_torch.data.clicks import dien_batch
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig

    counters = (ec, kc, sc, lc)
    gen = torch.Generator(device=dev).manual_seed(23)

    t0 = phase("embedding_bag backward on the card: bit-identical, bit-equal"
               " to the CPU, fp32 sum bound; timed (CUDA events)")
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    shapes = {}
    for what, (V, d, n, L, kind, weights) in BAG_BWD_SHAPES.items():
        if kind in ("dien", "dien-jpq"):
            bd = dien_batch(data, 0, DIEN_SLICE, 100)
            ids = torch.as_tensor(np.concatenate(
                [bd["hist"], bd["hist_neg"], bd["target"][:, None]], 1),
                device=dev).reshape(-1, 1)
            if kind == "dien-jpq":
                codes = torch.randint(0, DIEN_B, (DIEN_ROWS, DIEN_M),
                                      generator=gen, device=dev)
                ids = (codes[ids[:, 0]] + DIEN_B * torch.arange(
                    DIEN_M, device=dev)).reshape(-1, 1)
                del codes
            del bd
        else:
            ids = torch.randint(0, V, (n, L), generator=gen, device=dev)
        if kind == "padded":
            ids[torch.rand((n, L), generator=gen, device=dev) < 0.1] = 0
        elif kind == "skewed":
            ids.view(-1)[::2] = V // 3
        elif kind == "run":
            ids.view(-1)[::4] = V // 3
        check(tuple(ids.shape) == (n, L), f"{what}: ids {tuple(ids.shape)}")
        w = (ids > 0).float() if weights == "masked" else None
        dout = torch.randn((n, d), generator=gen, device=dev)
        shapes[what] = bag_bwd_row(
            torch, ids, w, dout, V, 3 if n > 10 * CTR_B else
            5 if n > B else 50, what, smi, clock_hz,
            gather=weights == "gather")
        del ids, w, dout
        torch.cuda.empty_cache()
    done(t0)

    t0 = phase(f"main path: CTR training at full width, B={CTR_B}, adamw lr "
               f"3e-3, TF32 off, 1 + {CTR_STEPS} steps per bundle")
    rows = sum(DLRM_VOCABS)
    table_gb = rows * 64 * 4 / 1e9
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    print(f"   dlrm-rm2 (full table) is not trained on one card: its fp32 "
          f"table is {rows:,} rows x 64 x 4 B = {table_gb:.1f} GB, and "
          f"adamw keeps the values, a dense gradient and two moments: "
          f"4 x {table_gb:.1f} = {4 * table_gb:.1f} GB against the card's "
          f"{card_gb:.1f} GB ({smi})")

    cache = {}

    def make_batches(name, model):
        """1 + CTR_STEPS host batches of CTR_B rows (one set a family):
        the two-tower smoke template's distributions at full shape from
        (seed 0, step); SyntheticClicks for FM and DLRM; dien_batch over
        phase 7's sequences for DIEN."""
        fam = name.replace("-jpq", "")
        if fam in cache:
            return cache[fam]
        t1 = time.perf_counter()
        steps = range(1 + CTR_STEPS)
        if fam == "two-tower-retrieval":
            n_items, H = model.cfg.n_items, model.cfg.hist_len

            def one(s):
                r = np.random.default_rng((0, s))
                return {"user_hist": r.integers(0, n_items + 1, (CTR_B, H)),
                        "pos_item": r.integers(1, n_items + 1, (CTR_B,)),
                        "logq": np.zeros(CTR_B, np.float32)}
            bs = [one(s) for s in steps]
        elif fam == "dien":
            bs = [dien_batch(data, s, CTR_B, model.cfg.seq_len)
                  for s in steps]
        else:
            clicks = SyntheticClicks(ClickDataConfig(
                n_dense=getattr(model.cfg, "n_dense", 13),
                vocab_sizes=model.cfg.vocabs(), seed=0))
            keys = ("sparse", "label") if fam == "fm" else \
                ("dense", "sparse", "label")
            bs = [{k: b[k] for k in keys}
                  for b in (clicks.batch(s, CTR_B) for s in steps)]
        cache[fam] = bs, (time.perf_counter() - t1) / len(bs) * 1e3
        return cache[fam]

    def grads_at(model, params, batch):
        """(loss, gradients of the float leaves) of one step on batch."""
        fl = [x for x in tree_leaves(params) if torch.is_floating_point(x)]
        for x in fl:
            x.requires_grad_(True)
        try:
            loss, _ = model.train_loss(params, {
                k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
            g = torch.autograd.grad(loss, fl, allow_unused=True)
        finally:
            for x in fl:
                x.requires_grad_(False)
        return float(loss.detach()), g

    summary, main_rows, fwd_launches = {}, {}, 0
    opt = OptConfig(lr=3e-3)
    for name in CTR_TRAIN_ARCHS:
        free_card(torch, dev, name)
        t1 = time.perf_counter()
        model = get_bundle(name).make_model(device=dev, seed=0)
        params = model.params()
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t1
        bs, batch_ms = make_batches(name, model)
        # the warm-up step picks microbatches: the smallest power of two
        # whose peak stays under PEAK_LIMIT (the step's slices take B / n
        # rows each; for the two-tower model B / n in-batch negatives)
        n, over = 1, []
        while True:
            for c in counters:
                c.reset_launches()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            warm = Trainer(model, opt, TrainConfig(
                steps=1, log_every=1, eval_every=0, microbatches=n),
                data_fn=lambda s: bs[0])
            try:
                _, h0 = warm.run(params=params)
                warm_peak = torch.cuda.max_memory_allocated(dev)
            except torch.cuda.OutOfMemoryError:
                warm_peak = None
            del warm
            if warm_peak is not None and warm_peak <= PEAK_LIMIT:
                break
            over.append({"microbatches": n, "peak_gb": None if warm_peak
                         is None else warm_peak / 1e9})
            print(f"   {name}: microbatches={n} "
                  + ("ran out of memory" if warm_peak is None else
                     f"peaked at {warm_peak / 1e9:.2f} GB")
                  + f" (limit {PEAK_LIMIT / 1e9:.0f} GB): trying {2 * n}")
            n *= 2
            check(n <= 16, f"{name}: no microbatches up to 16 fits")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = Trainer(model, opt, TrainConfig(
            steps=CTR_STEPS, log_every=1, eval_every=0, microbatches=n),
            data_fn=lambda s: bs[s + 1])
        _, hist = tr.run(params=params)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: v for c in counters for k, v in c.launches.items()
                    if v}
        losses = [h0[0]["loss"]] + [h["loss"] for h in hist if "loss" in h]
        steps_s = [h["sec"] for h in hist if "sec" in h]
        check(len(losses) == 1 + CTR_STEPS and
              all(np.isfinite(x) for x in losses),
              f"{name}: losses {losses}")
        check(peak <= PEAK_LIMIT, f"{name}: peak {peak / 1e9:.2f} GB")
        # every bundle's tables take their gradient from the backward
        # kernels: the bags' and the table gathers' (ops.gather)
        check(ec.launches["embedding_bag_backward"] > 0,
              f"the {name} training run did not launch the embedding_bag "
              f"backward: {launches}")
        if name in BAG_ARCHS:
            check(ec.launches["embedding_bag"] > 0,
                  f"the {name} training run did not launch embedding_bag: "
                  f"{launches}")
            fwd_launches += ec.launches["embedding_bag"]
        # one step at B = 64 through the kernels against the same step
        # with the plain versions in their place, on the card
        small = {k: v[:64] for k, v in bs[0].items()}
        k_loss, k_g = grads_at(model, params, small)
        with plain_bag():
            p_loss, p_g = grads_at(model, params, small)
        check(abs(k_loss - p_loss) <= 1e-5 * abs(p_loss),
              f"{name}: B=64 loss {k_loss} (kernels) vs {p_loss} (plain)")
        worst = 0.0
        for a, b in zip(k_g, p_g):
            if b is None:
                continue
            scale = float(b.abs().max())
            e = float((a - b).abs().max())
            check(e <= 1e-4 * scale, f"{name}: B=64 gradient {e} vs scale "
                  f"{scale} (kernels vs plain)")
            worst = max(worst, e / scale if scale else 0.0)
        del k_g, p_g
        # where a step's time goes: the card's busy time (kernels and
        # copies) in one more step under the profiler, against the median
        one = Trainer(model, opt, TrainConfig(
            steps=1, log_every=1, eval_every=0, microbatches=n),
            data_fn=lambda s: bs[1])
        names = {}
        busy_ms, top = device_profile(
            torch, lambda _: one.run(params=params), [None], top_n=6,
            names=names)
        del one
        # PyTorch's gather backward, which the route replaces
        indexing_ms = sum(v for k, v in names.items()
                          if "indexing_backward_kernel" in k)
        bag_bwd_ms = sum(v for k, v in names.items()
                         if "embedding_bag::rows_" in k
                         or "embedding_bag::long_kernel" in k)
        if name.startswith("dien"):
            check(indexing_ms == 0, f"{name}: the profiled step ran "
                  f"indexing_backward_kernel ({indexing_ms:.1f} ms): a "
                  f"table gather's backward missed the route")
        if name in BAG_ARCHS:
            # the backward at the main path's own inputs: the last
            # slice's ids of the first timed batch
            rows_ = CTR_B // n
            if name.startswith("two-tower"):
                ids = torch.as_tensor(bs[1]["user_hist"][-rows_:],
                                      device=dev)
                w = (ids > 0).float()
                V, d = params["item_emb"]["table"].shape
            else:
                ids = (torch.as_tensor(bs[1]["sparse"][-rows_:], device=dev)
                       + model.offsets[None, :]).contiguous()
                w, V, d = None, params["linear"].shape[0], 1
            dout = torch.randn((rows_, d), generator=gen, device=dev)
            main_rows[name] = bag_bwd_row(
                torch, ids, w, dout, V, 10, f"{name} training slice", smi,
                clock_hz)
            del ids, w, dout
        summary[name] = {
            "microbatches": n, "over_limit": over,
            "step_ms": float(np.median(steps_s)) * 1e3,
            "steps_ms": [x * 1e3 for x in steps_s], "batch_ms": batch_ms,
            "peak_gb": peak / 1e9, "warmup_peak_gb": warm_peak / 1e9,
            "first_loss": losses[0], "last_loss": losses[-1],
            "losses": losses, "build_s": build_s, "launches": launches,
            "b64_grad_worst": worst, "b64_loss": [k_loss, p_loss],
            "device_busy_ms": busy_ms, "top_device_ms": top,
            "indexing_backward_ms": indexing_ms,
            "bag_backward_device_ms": bag_bwd_ms}
        step_ms = summary[name]["step_ms"]
        print(f"   {name}: microbatches={n}, step {step_ms:.1f} ms (median "
              f"of {CTR_STEPS}), batch {batch_ms:.1f} ms on the "
              f"host, peak {peak / 1e9:.2f} GB, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, launches {launches}; B=64 kernels vs "
              f"plain: loss {k_loss:.7f} / {p_loss:.7f}, worst gradient "
              f"{worst:.2e} of its leaf's largest entry; built in "
              f"{build_s:.1f}s, on {smi}")
        print(f"   {name}: device busy {busy_ms:.1f} ms of a step; the "
              f"backward kernels {bag_bwd_ms:.1f} ms, indexing_backward_"
              f"kernel {indexing_ms:.1f} ms; top: "
              + "; ".join(f"{k} {v:.1f} ms" for k, v in top))
        del model, params, tr, hist, bs
        if name.endswith("-jpq"):        # its family's last bundle
            cache.pop(name[:-len("-jpq")], None)
    done(t0)

    main = main_rows["two-tower-retrieval"]
    entry = {"name": "embedding_bag_backward", "route": "cuda",
             "source": "src/repro_torch/csrc/embedding_bag.cu",
             "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:59",
             "launches": sum(r["launches"].get("embedding_bag_backward", 0)
                             for r in summary.values()),
             "max_abs_err": 0.0, "f64_err": max(
                 r["f64_err"] for r in [*shapes.values(),
                                        *main_rows.values()]),
             "ms": main["ms"], "whole_ms": main["whole_ms"],
             "sort_ms": main["sort_ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "chain_ms": main["chain_ms"], "library_ms": main["library_ms"],
             "library": main["library"],
             "index_add_ms": main["index_add_ms"],
             "device_ms": main["device_ms"], "shape": main["shape"],
             "callers": ["ops.embedding_bag (FM's linear term, the two-"
                         "tower user tower)", "ops.gather (core/full.lookup"
                         ", core/jpq.lookup with use_kernel=False: every "
                         "CTR and sequential table gather in training)"],
             "main_path": main_rows, "shapes": shapes}
    return entry, fwd_launches, summary


# ---------------------------------------------------------------- phase 27
# serving over a model-sharded catalogue: launch/serve.py --mesh S
# --share-card, S ranks time-sharing the one card (gloo, staged through
# host memory: NCCL refuses two ranks on one device), each holding its
# rows of the full-width catalogue

MESH_SHARDS = (2, 4)


def shard_kernel_rows(torch, dev, smi, template, Bq=B):
    """The three kernels of the mesh path at its shard shapes, ``Bq``
    queries, on the
    last rank's block (the largest offset) of the full-width catalogue,
    each against its plain version and timed: ``jpq_topk`` over the
    block's code rows; ``jpq_topk_pruned``'s two launches (the first
    tile, then the rest under the exchanged floor and the carried lists)
    on its slice of one global popularity-permuted state at
    ``mesh_prune_block_n`` (7,816); ``embedding_bag`` over the block's
    rows of the 1,000,448 x 256 table with the ids rebased and those
    outside clipped with weight 0 (``ms`` the launch alone, as phase 10
    times it; ``checked_ms`` the wrapper with its id check), unless
    ``template`` is None (the request server's path, phase 31, has no
    bag).  Returns {kernel: {S: row}}."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ref as eref
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.kernels.jpq_topk import ops

    N, k = 1_000_448, 10
    gen = torch.Generator(device=dev).manual_seed(27)
    codes = torch.randint(0, BC, (N, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    P = ops.canonicalise_lut(torch.randn((Bq, M, BC), generator=gen,
                                         device=dev)).contiguous()
    perm = torch.randperm(N, generator=gen, device=dev)
    rows = {"jpq_topk": {}, "jpq_topk_pruned": {}}
    if template is not None:
        table = torch.randn((N, 256), generator=gen, device=dev)
        ids = torch.as_tensor(template["user_hist"], device=dev)
        rows["embedding_bag"] = {}
    for S in MESH_SHARDS:
        L, s = N // S, S - 1
        block = codes[s * L:(s + 1) * L]
        kern = kc.jpq_topk(P, block, k)
        plain = ops.jpq_topk_scan(P, block, k, block_n=ops.scan_block_n(L))
        check(bits_equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1]),
              f"jpq_topk != plain on a {S}-way shard")
        b_ms, b_by, _ = bound_of(*topk_work(Bq, L, k))
        rows["jpq_topk"][S] = {
            "rows": L, "max_abs_err": float((kern[0] - plain[0]).abs().max()),
            "ms": cuda_ms(lambda: kc.jpq_topk(P, block, k), 20),
            "plain_ms": cuda_ms(lambda: ops.jpq_topk_scan(
                P, block, k, block_n=ops.scan_block_n(L)), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

        bn = ops.mesh_prune_block_n(N, S)
        check(bn == 7816, f"mesh_prune_block_n({N}, {S}) = {bn}, not 7816")
        st = ops.prepare_pruning(codes, BC, bn, perm=perm)
        nt, lo = L // bn, s * L
        mine = ops.PruneState(st.codes[lo:lo + L], st.ids[lo:lo + L],
                              st.present[s * nt:(s + 1) * nt], bn, True)

        def sub(a, b, st=mine, bn=bn):
            return (st.codes[a * bn:b * bn], st.ids[a * bn:b * bn],
                    st.present[a:b])

        cold = (torch.full((Bq,), -float("inf"), device=dev),
                torch.full((Bq, k), -float("inf"), device=dev),
                torch.zeros((Bq, k), dtype=torch.int32, device=dev))
        kw = dict(k=k, block_n=bn, tie_break_ids=True)

        def two(fn, sub=sub, cold=cold, kw=kw, nt=nt):
            v1, i1, s1 = fn(P, *sub(0, 1), *cold, **kw)
            fl = torch.maximum(cold[0], v1[:, -1])
            v2, i2, s2 = fn(P, *sub(1, nt), fl, v1, i1, **kw)
            return v2, i2, s1, s2

        kv, ki, ks1, ks2 = two(kc.jpq_topk_pruned)
        pv, pi, ps1, ps2 = two(ops.jpq_topk_scan_pruned)
        check(bits_equal(kv, pv) and torch.equal(ki, pi)
              and torch.equal(ks1.min(0).values, ps1)
              and torch.equal(ks2.min(0).values, ps2),
              f"jpq_topk_pruned != plain on a {S}-way shard at block_n {bn}")
        skip = torch.cat([ks1, ks2], 1)
        bytes_, adds, lookups, items = pruned_work(torch, mine, skip, Bq, k)
        b_ms, b_by, _ = bound_of(bytes_, adds, lookups)
        rows["jpq_topk_pruned"][S] = {
            "rows": L, "block_n": bn, "tiles": nt, "swept_items": items,
            "max_abs_err": float((kv - pv).abs().max()),
            "ms": cuda_ms(lambda: two(kc.jpq_topk_pruned), 20),
            "plain_ms": cuda_ms(lambda: two(ops.jpq_topk_scan_pruned), 2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

        if template is not None:
            tab = table[s * L:(s + 1) * L]
            loc = ids - s * L
            ok = (loc >= 0) & (loc < L)
            w = ((ids > 0) & ok).float()
            loc = torch.where(ok, loc, 0)    # the block's foreign ids
            kern = ec.embedding_bag(tab, loc, w)
            plain = eref.embedding_bag_ref(tab, loc, w)
            check(bits_equal(kern, plain),
                  f"embedding_bag != plain on a {S}-way shard")
            n, H = loc.shape
            distinct = torch.unique(loc).numel()
            b_ms, b_by = bound(distinct * 256 * 4 + loc.numel() * 8
                               + n * H * 4 + n * 256 * 4,
                               {"fp32 FMAs": (n * H * 256, FADD_PER_S)})
            rows["embedding_bag"][S] = {
                "rows": L, "bags": n, "distinct_rows": distinct,
                "ids_in_shard": int(ok.sum()),
                "max_abs_err": float((kern - plain).abs().max()),
                "ms": cuda_ms(lambda: ec.launch(tab, loc, w), 50),
                "checked_ms": cuda_ms(
                    lambda: ec.embedding_bag(tab, loc, w), 50),
                "plain_ms": cuda_ms(
                    lambda: eref.embedding_bag_ref(tab, loc, w), 10),
                "library_ms": cuda_ms(lambda: F.embedding_bag(
                    loc, tab, mode="sum", per_sample_weights=w), 50),
                "bound_ms": b_ms, "bound_by": b_by}
        for name in rows:
            r = rows[name][S]
            print(f"   S={S} {name} on {r['rows']} rows: {r['ms']:.4f} ms "
                  f"kernel"
                  + ("" if "checked_ms" not in r else
                     f" ({r['checked_ms']:.4f} with the id check)")
                  + f", {r['plain_ms']:.4f} ms plain, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
                  + ("" if r.get("library_ms") is None else
                     f", {r['library_ms']:.4f} ms F.embedding_bag")
                  + f"; B={Bq}, bit-equal to plain, on {smi}")
    del codes, P, perm, st, mine
    torch.cuda.empty_cache()
    return rows


def _mesh_serve_argv(arch, flags, S=0):
    """Phase 27's serve CLI arguments (``--mesh S --share-card`` where S
    is given)."""
    argv = ["--arch", arch, "--batch-size", str(B), "--requests",
            str(REQUESTS), "--device", "cuda", *flags]
    return argv + (["--mesh", str(S), "--share-card"] if S else [])


def mesh_serve_rank(mesh, cases, out_dir):
    """One rank of phase 27 (module-level: it is pickled): the ``--mesh
    S`` CLI's per-rank body (``serve._mesh_rank``: build the full-width
    model, keep this rank's catalogue rows, ``serve_loop`` under the
    mesh) for each ``(arch, name, flags)`` case in turn, the results under
    ``out_dir/<name>``; one pool task a mesh."""
    import functools

    import torch

    from repro_torch.launch import serve as serve_mod
    S = mesh.shape["model"]
    for arch, name, flags in cases:
        sub = os.path.join(out_dir, name)
        os.makedirs(sub, exist_ok=True)
        serve_mod._mesh_rank(
            mesh, serve_mod.build_parser().parse_args(
                _mesh_serve_argv(arch, flags, S)),
            functools.partial(full_two_tower, arch), sub, True)
        gc.collect()
        torch.cuda.empty_cache()


def mesh_phases(torch, np, dev, smi):
    """Phase 27: the ``--mesh S`` CLI's per-rank body (what
    ``launch.serve.serve_mesh`` spawns) with ``--share-card``, S = 2 and
    4 ranks on the one card, one pool task a mesh running its cases in
    turn (the rank pools start here),
    at full width: two-tower-retrieval-jpq ``--fused`` and ``--prune --perm
    --warm`` at each S, the full-table two-tower at S = 4; every rank's
    every response held against the unsharded path on the same request
    (RecJPQ: bit-equal; the full table: its pooled user tower sums over
    the ranks in another order, so values within 1e-5 of the largest
    and ids at least 99% equal); each rank launched its path's kernel;
    the pruned stats' total_tiles = nt_loc * S.  Then the kernels at the
    shards' shapes (``shard_kernel_rows``).  On one card the ranks
    time-share the device: the latencies are what S ranks cost on one
    card, not what S cards would give."""
    import shutil

    from repro_torch.launch import serve as serve_mod

    t0 = phase("main path: serving over a model-sharded catalogue, S = 2 "
               "and 4 ranks on the one card (serve --mesh S --share-card)")
    t1 = time.perf_counter()
    start_pools(dev, MESH_SHARDS)
    print(f"   the rank pools of {MESH_SHARDS} ranks (phases 27-31, "
          f"37-38) started in {time.perf_counter() - t1:.1f} s")
    k = 10
    cases = {S: [("two-tower-retrieval-jpq", name, flags)
                 for name, flags in (("fused", ["--fused"]),
                                     ("pruned", ["--prune", "--perm",
                                                 "--warm"]))]
             for S in MESH_SHARDS}
    cases[4].append(("two-tower-retrieval", "full", []))
    refs, n_rows = {}, {}
    for arch in ("two-tower-retrieval-jpq", "two-tower-retrieval"):
        model, template = full_two_tower(arch, dev)
        refs[arch] = serve_mod.serve_loop(
            model, model.params(), template, serve_mod.build_parser()
            .parse_args(_mesh_serve_argv(arch, ["--fused"])),
            keep_outputs=True)
        n_rows[arch] = model.emb.cfg.n_items
        del model
        gc.collect()
        torch.cuda.empty_cache()
    root = os.path.join(HERE, "build", "chip_smoke_mesh_serve")
    shutil.rmtree(root, ignore_errors=True)
    results = {}
    for S in MESH_SHARDS:
        out_dir = os.path.join(root, f"S{S}")
        run_ranks(mesh_serve_rank, S, (cases[S], out_dir), dev, model=S,
                  timeout=600)
        for arch, name, _ in cases[S]:
            results[(S, name)] = [torch.load(os.path.join(
                out_dir, name, f"rank{r}.pt"), weights_only=False)
                for r in range(S)]
    shutil.rmtree(root, ignore_errors=True)

    runs = {}
    launches = {"jpq_topk": {}, "jpq_topk_pruned": {}, "embedding_bag": {}}
    for S in MESH_SHARDS:
        for arch, name, _ in cases[S]:
            ref = refs[arch]
            kern = {"fused": "jpq_topk", "pruned": "jpq_topk_pruned",
                    "full": "embedding_bag"}[name]
            ranks = results[(S, name)]
            worst = {"ids_differ": 0, "max_abs_dv": 0.0}
            for r, res in enumerate(ranks):
                check(res["mesh"] == S and res["transport"] == "gloo-staged"
                      and res["rank"] == r, f"rank {r}: {res['transport']}")
                check(res["launches"][kern] > 0,
                      f"{arch} mesh={S} {name}: rank {r} never launched "
                      f"{kern}")
                if name == "pruned":
                    nt_loc = n_rows[arch] // S // 7816
                    check(res["total_tiles"] == [nt_loc * S]
                          * (REQUESTS + 1),
                          f"total_tiles {set(res['total_tiles'])} != "
                          f"{nt_loc} x {S}")
                check(len(res["outputs"]) == len(ref["outputs"]) == REQUESTS,
                      "response counts differ")
                for (gv, gi), (wv, wi) in zip(res["outputs"], ref["outputs"]):
                    check(tuple(gv.shape) == (B, k)
                          and bool(torch.isfinite(gv).all()),
                          f"{arch} mesh={S} {name}: bad response")
                    if name != "full":
                        check(bits_equal(gv, wv) and torch.equal(gi, wi),
                              f"{arch} mesh={S} {name}: rank {r} != the "
                              f"unsharded path")
                        continue
                    dv = float((gv - wv).abs().max())
                    worst["max_abs_dv"] = max(worst["max_abs_dv"], dv)
                    worst["ids_differ"] += int((gi != wi).sum())
                    check(dv <= 1e-5 * float(wv.abs().max()),
                          f"full two-tower mesh={S}: |dv| {dv}")
            if name == "full":
                check(worst["ids_differ"] <= 0.01 * S * REQUESTS * B * k,
                      f"full two-tower mesh={S}: {worst['ids_differ']} ids "
                      f"differ")
            r0 = ranks[0]
            row = {"arch": arch, "S": S, "path": r0["path"],
                   "transport": r0["transport"], "p50_ms": r0["p50_ms"],
                   "p99_ms": r0["p99_ms"], "skip": r0["skip"],
                   "unsharded_p50_ms": ref["p50_ms"],
                   "unsharded_p99_ms": ref["p99_ms"],
                   "comm_ms_per_request": float(np.median(r0["comm_ms"])),
                   "comm_calls_per_request": int(np.median(
                       r0["comm_calls"])),
                   "comm_bytes_per_request": int(np.median(
                       r0["comm_bytes"])),
                   "merge_bytes": S * B * k * 8,
                   "launches_per_rank": [x["launches"][kern] for x in ranks],
                   **({"full_table": worst} if name == "full" else {})}
            runs[f"{arch}@{S}:{name}"] = row
            launches[kern][f"{arch}@{S}"] = row["launches_per_rank"]
            print(f"   {arch} mesh={S} {row['path']}: p50={row['p50_ms']:.3f}"
                  f"ms p99={row['p99_ms']:.3f}ms (unsharded "
                  f"{row['unsharded_p50_ms']:.3f}/{row['unsharded_p99_ms']:.3f}"
                  f" ms), collectives {row['comm_ms_per_request']:.3f} ms "
                  f"and {row['comm_bytes_per_request']} bytes in "
                  f"{row['comm_calls_per_request']} calls a request (the "
                  f"merge's S·B·k·8 = {row['merge_bytes']}), transport "
                  f"{row['transport']}, {kern} launches by rank "
                  f"{row['launches_per_rank']}, skip={row['skip']}; "
                  + ("every response bit-equal to the unsharded path"
                     if name != "full" else
                     f"|dv| <= {worst['max_abs_dv']:.3g}, "
                     f"{worst['ids_differ']} ids differ")
                  + f"; on {smi}")
    done(t0)

    t0 = phase("the mesh path's kernels at the shards' shapes (CUDA events)")
    shard_rows = shard_kernel_rows(torch, dev, smi, template)
    del template
    done(t0)
    return {"mesh_serve": runs, "shard_kernels": shard_rows,
            "launches": launches}


# ---------------------------------------------------------------- phase 28
# training the sequential recommenders on a "model" mesh axis: the
# Trainer's tensor parallelism (the catalogue's rows, the heads and the
# MLP's width split, the vocab-parallel cross-entropy) with the ranks
# time-sharing the one card, as ``launch/train.py --model-axis S
# --share-card`` runs them (gloo staged through host memory: NCCL
# refuses two ranks on one device)

TP_SHARDS, TP_CKPT_AT = 2, 5
TP_STEPS = {"sasrec": 10, "bert4rec": 5, "gru4rec": 3, "data": 5}
TP_PEAK_LIMIT_GB = 0.55 * 64.40     # phase 7's single-card peak, 64.40 GB
TP_KERNELS = ("jpq_scores", "jpq_scores_bwd", "jpq_lookup",
              "jpq_lookup_bwd")


def _flat(tree, path=""):
    """{"a/b/0/c": leaf} of a tree of dicts and lists (tuples are
    leaves: the placement specs)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}{k}/"))
    return out


def leaf_rule(want, got):
    """Each leaf of a gradient against the rule of
    tests/test_torch_recsys_train.py: |got - want| within 1e-5 of the
    leaf's largest entry, or 1e-6 of the whole gradient's largest.
    Returns the worst leaf's share of its allowance."""
    top = max(float(w.abs().max()) for w in want.values())
    check(set(want) == set(got), f"gradient leaves differ: "
          f"{sorted(set(want) ^ set(got))}")
    worst = 0.0
    for k, w in want.items():
        err = float((got[k].double() - w.double()).abs().max())
        lim = max(1e-5 * float(w.abs().max()), 1e-6 * top)
        check(err <= lim, f"gradient leaf {k}: |err| {err:.3e} > {lim:.3e}")
        worst = max(worst, err / lim if lim else 0.0)
    return worst


def tp_rank(mesh, codes_np, batches, jobs, out_dir):
    """One rank of phase 28 (module-level: it is pickled).  Each job
    builds the full-width RecJPQ model of phase 7 (``full_width_model``)
    from seed 0, optionally takes one step's loss and gradient at the
    start (this rank's data rows over the whole batch's counts, the
    data group's sum, the blocks gathered), then trains it through ``Trainer`` on this rank's mesh
    for ``steps`` steps of phase 7's batches (BERT4Rec masked as phase
    12 masks them), the launch counters, the peak memory and
    ``HostMesh.comm`` read around the run; ``ckpt`` saves every 5 steps,
    ``resume`` first copies a step's checkpoint there; ``keep`` gathers
    the final parameters.  Writes ``out_dir/rank<r>.pt``."""
    import shutil

    import torch

    from repro_torch import bridge, dist, fp32_matmuls
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.models.sequential import mask_batch
    from repro_torch.train.loop import TrainConfig, Trainer, counted_loss
    from repro_torch.train.optimizer import OptConfig
    fp32_matmuls()
    dev, D = mesh.device, mesh.shape["data"]
    res = {"rank": mesh.rank, "transport": mesh.transport}
    for job in jobs:
        arch = job["arch"]
        model = full_width_model(codes_np, dev, arch)
        cfg = model.cfg

        def data_fn(s, arch=arch, cfg=cfg):
            b = batches[s]
            if arch != "bert4rec":
                return b
            seq = torch.as_tensor(b["seq"], device=dev)
            ms, tg = mask_batch(torch.Generator(device=dev).manual_seed(s),
                                seq, cfg.mask_prob, cfg.mask_id)
            return {"seq": ms, "targets": tg}

        out = {}
        if job.get("grad0"):
            model.init_params(torch.Generator(device=dev).manual_seed(0))
            specs = _flat(bridge.keep_local_blocks(model, mesh))
            p = model.params()
            leaves = {k: x for k, x in _flat(p).items()
                      if torch.is_floating_point(x)}
            n = TRAIN_B // D
            b = {k: torch.as_tensor(v, device=dev)[mesh.data_index * n:
                                                   (mesh.data_index + 1) * n]
                 for k, v in data_fn(0).items()}
            loss_fn = counted_loss(model, mesh) if D > 1 \
                else model.train_loss
            with dist.use_mesh_rules(mesh, local_batch=D > 1):
                loss, _ = loss_fn(p, b)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            out["grad0_loss"] = float(mesh.all_reduce(
                loss.detach().reshape(1), "data"))
            out["grad0"] = {k: dist.gather_block(
                mesh.all_reduce(g, "data"), specs[k], mesh).cpu()
                for k, g in zip(leaves, grads)}
            del p, leaves, b, loss, grads
            gc.collect()
            torch.cuda.empty_cache()
        if job.get("resume"):
            src, step = job["resume"]
            if mesh.rank == 0:
                shutil.rmtree(job["ckpt"], ignore_errors=True)
                os.makedirs(job["ckpt"])
                name = f"step_{step:010d}"
                shutil.copytree(os.path.join(src, name),
                                os.path.join(job["ckpt"], name))
        mesh.all_reduce(torch.zeros(1, device=dev), ("data", "model"))
        trainer = Trainer(model, OptConfig(lr=3e-3), TrainConfig(
            steps=job["steps"], batch_size=TRAIN_B, log_every=1,
            eval_every=0, ckpt_dir=job.get("ckpt"), ckpt_every=TP_CKPT_AT),
            data_fn=data_fn, mesh=mesh)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sc.reset_launches()
        lc.reset_launches()
        comm0 = dict(mesh.comm)
        params, hist = trainer.run(
            generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize(dev)
        out["launches"] = {**sc.launches, **lc.launches}
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["comm"] = {k: mesh.comm[k] - comm0[k] for k in comm0}
        rows = [h for h in hist if "loss" in h]
        out["losses"] = [h["loss"] for h in rows]
        out["grad_norms"] = [h["grad_norm"] for h in rows]
        out["step_ms"] = [h["sec"] * 1e3 for h in rows]
        out["steps_run"] = len(rows)
        out["done_step"] = trainer.done_step
        if job.get("keep"):
            specs = _flat(bridge.keep_local_blocks(model, mesh))
            out["final"] = {k: dist.gather_block(x.detach(), specs[k],
                                                 mesh).cpu()
                            for k, x in _flat(params).items()}
        res[job["name"]] = out
        del trainer, params, model, hist
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def tp_step_bytes(T, d, n_layers, cent_bytes, n_split, D, held_floats):
    """The bytes one rank's collectives return in a SASRec step on a
    (D, S) mesh, ``T`` its positions: each layer's two forward
    ``reduce_from_model`` and two backward ``copy_to_model`` sums of
    [T, d]; the logits' dh [T, d] and dcent; the cross-entropy's max [T]
    and its [2, T] of sum-exp and label logit; the input's code gather
    [T, m] uint8; the clip norm's split leaves' squares; the stop flag;
    at D > 1 the data group's sums of the loss's count (one int64), of
    the rank's ``held_floats`` gradient entries and of the loss."""
    f = 4
    b = (4 * n_layers * T * d * f + T * d * f + cent_bytes + 3 * T * f
         + T * M + n_split * f + 4)
    if D > 1:
        b += 8 + (held_floats + 1) * f
    return b


def tp_shard_kernels(torch, dev, smi, codes_np, batches):
    """The four training kernels at the shards' shapes of phase 28: the
    jpq_scores pair over the last rank's 500,001 code rows at T = 3,200
    ((1, 2): a rank's whole batch) and 1,600 ((2, 2): half of it), the
    jpq_lookup pair on the code rows a rank gathers (``take_rows``) for
    the batch's ids; each held against its plain version as phase 8
    holds them (``scores_fwd_err``, ``scores_bwd_err``, ``lookup_errs``)
    and timed beside its plain version, its bound and the library call
    phase 8 times.  Returns {kernel: {T: row}}."""
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_lookup import ref as lref
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ref as sref
    n_rows, dk = N_ITEMS + 2, 512 // M
    L = n_rows // TP_SHARDS
    codes_all = torch.as_tensor(codes_np, device=dev).to(torch.uint8)
    block = codes_all[(TP_SHARDS - 1) * L:].contiguous()
    gen = torch.Generator(device=dev).manual_seed(28)
    cent = torch.randn((M, BC, dk), generator=gen, device=dev)
    col = (block.long() + BC * torch.arange(M, device=dev)).reshape(-1)
    onehot = torch.sparse_csr_tensor(
        torch.arange(0, L * M + 1, M, device=dev), col,
        torch.ones(L * M, device=dev), size=(L, M * BC),
        check_invariants=False)
    onehot_t = onehot.to_sparse_coo().t().coalesce().to_sparse_csr()
    rows = {k: {} for k in TP_KERNELS}
    for T in (TRAIN_B * SEQ_LEN, TRAIN_B * SEQ_LEN // 2):
        what = f"a rank's shard, T={T} N={L}"
        P = torch.randn((T, M, BC), generator=gen, device=dev)
        dS = torch.randn((T, L), generator=gen, device=dev)
        seq = torch.as_tensor(batches[0]["seq"], device=dev).reshape(-1)[:T]
        got_codes = codes_all[seq.long()].contiguous()    # take_rows' rows
        ids = torch.arange(T, dtype=torch.int32, device=dev)
        dout = torch.randn((T, M, dk), generator=gen, device=dev)
        e_f = scores_fwd_err(P, block, what)
        e_b, _, chain, chunks = scores_bwd_err(dS, block, BC, what)
        e_l, e_lb = lookup_errs(ids, got_codes, cent, dout, what)
        P2t = P.reshape(T, M * BC).t().contiguous()
        flat = (got_codes.long() + BC * torch.arange(M, device=dev)
                ).reshape(-1)
        cent2 = cent.reshape(M * BC, dk)
        work = train_kernel_work(T, L, BC, dk)
        look = train_kernel_work(T, T, BC, dk)
        timed = {
            "jpq_scores": (e_f, work["jpq_scores"],
                           lambda: sc.jpq_scores(P, block),
                           lambda: sref.jpq_scores_lut_ref(P, block),
                           lambda: torch.sparse.mm(onehot, P2t), 5, 2),
            "jpq_scores_bwd": (e_b, work["jpq_scores_bwd"],
                               lambda: sc.jpq_scores_bwd(dS, block, BC),
                               lambda: sref.jpq_scores_lut_bwd_ref(
                                   dS, block, BC),
                               lambda: torch.sparse.mm(onehot_t, dS.t()),
                               3, 2),
            "jpq_lookup": (e_l, look["jpq_lookup"],
                           lambda: lc.jpq_lookup(ids, got_codes, cent),
                           lambda: lref.jpq_lookup_ref(ids, got_codes, cent),
                           lambda: torch.index_select(cent2, 0, flat),
                           50, 20),
            "jpq_lookup_bwd": (e_lb, look["jpq_lookup_bwd"],
                               lambda: lc.jpq_lookup_bwd(ids, got_codes,
                                                         dout, BC),
                               lambda: lref.jpq_lookup_bwd_ref(
                                   ids, got_codes, dout, BC),
                               lambda: torch.zeros_like(cent2).index_add_(
                                   0, flat, dout.reshape(T * M, dk)),
                               50, 20)}
        for name, (err, wk, kern, plain, lib, it, pit) in timed.items():
            b_ms, b_by = bound(*wk)
            r = rows[name][T] = {
                "T": T, "N": L if name.startswith("jpq_scores") else T,
                "max_abs_err": err, "ms": cuda_ms(kern, it),
                "plain_ms": cuda_ms(plain, pit),
                "library_ms": cuda_ms(lib, it), "bound_ms": b_ms,
                "bound_by": b_by}
            if name == "jpq_scores_bwd":
                r.update(chunks=chunks, chain=chain)
            print(f"   {name} at T={T} over {r['N']} rows: {r['ms']:.4f} ms "
                  f"kernel, {r['plain_ms']:.4f} ms plain, "
                  f"{r['library_ms']:.4f} ms library, bound "
                  f"{b_ms:.4f} ms ({b_by}), max |err| {err:.3e}, on {smi}")
        del P, dS, dout, P2t, got_codes, timed
        torch.cuda.empty_cache()
    del codes_all, block, onehot, onehot_t
    torch.cuda.empty_cache()
    return rows


def model_axis_phases(torch, np, dev, smi, data, codes_np, seq_runs):
    """Phase 28: full-width RecJPQ training on a ``(data, model)`` mesh
    of ranks time-sharing the one card (a ``RankPool``: the ``--model-axis
    S --share-card`` CLI's transport) through the Trainer's tensor parallelism.  (a) (1, 2), SASRec
    ``full_ce``, 10 steps of phase 7's batches from phase 7's start:
    step 0's loss within 1e-5 relative of the (1, 1) step on the same
    batch and its gathered gradient within ``leaf_rule`` of that step's;
    each later loss printed beside phase 7's; each rank's peak under
    0.55 x 64.40 GB; two runs bit-identical; every rank launched the
    four training kernels.  (b) (1, 2) BERT4Rec, 5 steps, the [MASK]
    column on the last rank; (d) (1, 2) GRU4Rec, 3 steps; each step 0
    within 1e-5 relative of phase 12's.  (c) (2, 2) SASRec, 5 steps on
    four ranks: step 0 against the (1, 1) step on the whole batch (each
    data rank's share over the whole batch's counts, summed).  (e) (a) saves at step 5; a (1, 2) resume
    from it is bit-equal to (a), a (1, 1) resume within 1e-4 relative
    of its losses.  Then the kernels at the shards' shapes
    (``tp_shard_kernels``).  ``seq_runs``: phases 7's and 12's
    summaries by arch (their losses, median step and peak).  Returns
    {"runs", "shard_kernels", "launches"}."""
    import shutil
    import tempfile

    from repro_torch import bridge
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig

    t0 = phase(f"main path: training on a 'model' mesh axis, full-width "
               f"RecJPQ, ranks sharing the one card (train --model-axis "
               f"{TP_SHARDS} --share-card)")
    free_card(torch, dev, "the model-axis training phase")
    batches = [data.train_batch(s, TRAIN_B) for s in range(10)]
    T = TRAIN_B * SEQ_LEN
    # the (1, 1) step 0 (phase 7's start and batch), and its two halves'
    ref = {}
    model = full_width_model(codes_np, dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    leaves = {k: x for k, x in _flat(params).items()
              if torch.is_floating_point(x)}
    for name, lo, hi in (("whole", 0, TRAIN_B),):
        b = {k: torch.as_tensor(v[lo:hi], device=dev)
             for k, v in batches[0].items()}
        loss, _ = model.train_loss(params, b)
        g = torch.autograd.grad(loss, list(leaves.values()))
        ref[name] = (float(loss.detach()),
                     {k: x.cpu() for k, x in zip(leaves, g)})
        del loss, g, b
    split_specs = _flat(model.placement(mesh_mod.HostMesh(1, TP_SHARDS)))
    n_split = sum(1 for k, sp in split_specs.items()
                  if k in leaves and any(e == "model" for e in sp))
    held_floats = sum(x.numel() // (TP_SHARDS if any(
        e == "model" for e in split_specs[k]) else 1)
        for k, x in leaves.items())
    del model, params, leaves
    free_card(torch, dev, "the model-axis ranks")
    root = os.path.join(HERE, "build", "chip_smoke_tp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ck_a, ck_r = os.path.join(root, "ck_a"), os.path.join(root, "ck_r")
    jobs = [dict(name="a", arch="sasrec", steps=TP_STEPS["sasrec"],
                 grad0=True, ckpt=ck_a, keep=True),
            dict(name="a_again", arch="sasrec", steps=TP_STEPS["sasrec"],
                 keep=True),
            dict(name="a_resume", arch="sasrec", steps=TP_STEPS["sasrec"],
                 ckpt=ck_r, resume=(ck_a, TP_CKPT_AT), keep=True),
            dict(name="b", arch="bert4rec", steps=TP_STEPS["bert4rec"]),
            dict(name="d", arch="gru4rec", steps=TP_STEPS["gru4rec"])]
    ranks = {}
    for shape, n, js in (("1x2", TP_SHARDS, jobs),
                         ("2x2", 2 * TP_SHARDS,
                          [dict(name="c", arch="sasrec",
                                steps=TP_STEPS["data"], grad0=True)])):
        out_dir = tempfile.mkdtemp(prefix=f"ranks-{shape}-", dir=root)
        t1 = time.perf_counter()
        run_ranks(tp_rank, n, (codes_np, batches, js, out_dir), dev,
                  model=TP_SHARDS, timeout=900)
        ranks[shape] = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                                   weights_only=False) for r in range(n)]
        print(f"   {shape}: {n} ranks, {time.perf_counter() - t1:.1f} s "
              f"(the runs, on the pool's ranks)")
    runs, launches = {}, {k: {} for k in TP_KERNELS}
    seq7 = seq_runs["sasrec"]
    for shape, rs in ranks.items():
        for name in rs[0]:
            if name in ("rank", "transport"):
                continue
            r0 = rs[0][name]
            for r, res in enumerate(rs):
                check(res["transport"] == "gloo-staged",
                      f"rank {r}: transport {res['transport']}")
                for k in TP_KERNELS:
                    check(res[name]["launches"][k] > 0,
                          f"{shape} {name}: rank {r} never launched {k}")
                check(res[name]["peak_gb"] <= TP_PEAK_LIMIT_GB,
                      f"{shape} {name}: rank {r} peaked at "
                      f"{res[name]['peak_gb']:.2f} GB > "
                      f"{TP_PEAK_LIMIT_GB:.2f}")
                check(res[name]["losses"] == r0["losses"],
                      f"{shape} {name}: rank {r}'s losses differ from "
                      f"rank 0's")
            check(all(np.isfinite(r0["losses"])),
                  f"{shape} {name}: losses not finite {r0['losses']}")
            steps = r0["steps_run"]
            row = {"shape": shape, "losses": r0["losses"],
                   "grad_norms": r0["grad_norms"],
                   "median_step_ms": float(np.median(r0["step_ms"][1:]))
                   if steps > 1 else r0["step_ms"][0],
                   "step_ms": r0["step_ms"],
                   "peak_gb_by_rank": [x[name]["peak_gb"] for x in rs],
                   "launches_by_rank": [x[name]["launches"] for x in rs],
                   "comm_ms_per_step": 1e3 * r0["comm"]["seconds"] / steps,
                   "comm_bytes_per_step": r0["comm"]["bytes"] / steps,
                   "comm_calls_per_step": r0["comm"]["calls"] / steps}
            for k in TP_KERNELS:
                launches[k][f"{shape}:{name}"] = [
                    x[name]["launches"][k] for x in rs]
            runs[f"{shape}:{name}"] = row
    a, again, resumed = (ranks["1x2"][0][k] for k in ("a", "a_again",
                                                      "a_resume"))
    # (a) step 0 against the (1, 1) step, the losses beside phase 7's
    want_loss, want_g = ref["whole"]
    check(abs(a["grad0_loss"] - want_loss) <= 1e-5 * abs(want_loss),
          f"(1, 2) step 0 loss {a['grad0_loss']} != (1, 1) {want_loss}")
    check(abs(a["losses"][0] - want_loss) <= 1e-5 * abs(want_loss),
          f"(1, 2) Trainer step 0 loss {a['losses'][0]} != {want_loss}")
    worst = leaf_rule(want_g, a["grad0"])
    runs["1x2:a"]["step0"] = {"loss": a["grad0_loss"], "loss_1x1": want_loss,
                              "grad_worst_share_of_rule": worst}
    print(f"   (a) (1, 2) SASRec step 0: loss {a['grad0_loss']:.7f} vs "
          f"(1, 1) {want_loss:.7f}; gathered gradients within the leaf rule "
          f"(worst leaf at {worst:.3f} of its allowance)")
    print("   (a) losses (1, 2) | phase 7's (1, 1): " + "; ".join(
        f"{x:.5f} | {y:.5f}" for x, y in zip(a["losses"], seq7["losses"])))
    # run to run, and the (1, 2) resume
    check(again["losses"] == a["losses"] and all(
        torch.equal(again["final"][k], a["final"][k]) for k in a["final"]),
          "(a) two (1, 2) runs differ")
    check(resumed["losses"] == a["losses"][TP_CKPT_AT:] and all(
        torch.equal(resumed["final"][k], a["final"][k])
        for k in a["final"]),
          "(e) the (1, 2) resume from step 5 != the uninterrupted run")
    print("   (a) two runs bit-identical; (e) the (1, 2) resume from step "
          f"{TP_CKPT_AT} bit-equal to the uninterrupted run")
    # (e) the (1, 1) resume from (a)'s step-5 checkpoint, on the parent
    ck_1 = os.path.join(root, "ck_1x1")
    name = f"step_{TP_CKPT_AT:010d}"
    shutil.copytree(os.path.join(ck_a, name), os.path.join(ck_1, name))
    model = full_width_model(codes_np, dev)
    tr = Trainer(model, OptConfig(lr=3e-3), TrainConfig(
        steps=TP_STEPS["sasrec"], batch_size=TRAIN_B, log_every=1,
        eval_every=0, ckpt_dir=ck_1, ckpt_every=0),
        data_fn=lambda s: batches[s])
    params, hist = tr.run(generator=torch.Generator(device=dev).manual_seed(0))
    l11 = [h["loss"] for h in hist if "loss" in h]
    rel = max(abs(x - y) / abs(y) for x, y in
              zip(l11, a["losses"][TP_CKPT_AT:]))
    check(len(l11) == TP_STEPS["sasrec"] - TP_CKPT_AT and rel <= 1e-4,
          f"(e) the (1, 1) resume's losses {l11} vs (1, 2)'s "
          f"{a['losses'][TP_CKPT_AT:]}")
    dmax = max(float((x.detach().cpu().double()
                      - a["final"][k].double()).abs().max())
               for k, x in _flat(params).items()
               if torch.is_floating_point(x))
    runs["1x2:a"]["resume_1x1"] = {"losses": l11, "max_rel_loss": rel,
                                   "max_abs_param_diff": dmax}
    print(f"   (e) the (1, 1) resume: losses within {rel:.2e} relative of "
          f"(1, 2)'s; parameters at most {dmax:.3e} apart after "
          f"{TP_STEPS['sasrec'] - TP_CKPT_AT} steps")
    del model, params, tr, hist
    # (b), (d): step 0 against phase 12's
    for key, arch in (("b", "bert4rec"), ("d", "gru4rec")):
        got, want = ranks["1x2"][0][key]["losses"][0], \
            seq_runs[arch]["losses"][0]
        check(abs(got - want) <= 1e-5 * abs(want),
              f"({key}) {arch} (1, 2) step 0 loss {got} != phase 12's {want}")
        print(f"   ({key}) {arch} (1, 2): losses "
              + " ".join(f"{x:.5f}" for x in ranks["1x2"][0][key]["losses"])
              + f"; phase 12's (1, 1) " + " ".join(
                  f"{x:.5f}" for x in seq_runs[arch]["losses"][
                      :TP_STEPS[arch]]))
    # (c) the data group: the whole batch's step
    c = ranks["2x2"][0]["c"]
    want_loss, want_g = ref["whole"]
    check(abs(c["grad0_loss"] - want_loss) <= 1e-5 * abs(want_loss)
          and abs(c["losses"][0] - want_loss) <= 1e-5 * abs(want_loss),
          f"(c) (2, 2) step 0 loss {c['grad0_loss']} != the whole batch's "
          f"{want_loss}")
    worst_c = leaf_rule(want_g, c["grad0"])
    runs["2x2:c"]["step0"] = {"loss": c["grad0_loss"],
                              "loss_1x1": want_loss,
                              "grad_worst_share_of_rule": worst_c}
    print(f"   (c) (2, 2) SASRec step 0: loss {c['grad0_loss']:.7f} vs the "
          f"(1, 1) whole batch's {want_loss:.7f}; gradients within the leaf "
          f"rule (worst at {worst_c:.3f}); losses "
          + " ".join(f"{x:.5f}" for x in c["losses"]))
    # the collectives' bytes a step, against the count
    cent_b = M * BC * (512 // M) * 4
    for key, D in (("1x2:a_again", 1), ("2x2:c", 2)):
        r = runs[key]
        counted = tp_step_bytes(T // D, 512, 2, cent_b, n_split, D,
                                held_floats)
        r["counted_bytes_per_step_model_axis"] = counted
        print(f"   {key}: step {r['median_step_ms']:.1f} ms (phase 7's "
              f"plain step {seq7['median_step_ms']:.1f} ms), peak GB by rank "
              + ", ".join(f"{x:.2f}" for x in r["peak_gb_by_rank"])
              + f" (phase 7's {seq7['peak_gb']:.2f}); collectives "
              f"{r['comm_ms_per_step']:.2f} ms, "
              f"{r['comm_bytes_per_step']:.0f} bytes, "
              f"{r['comm_calls_per_step']:.1f} calls a step (counted: "
              f"{counted} bytes), on {smi}")
    for key in ("1x2:b", "1x2:d"):
        r = runs[key]
        print(f"   {key}: step {r['median_step_ms']:.1f} ms, peak GB by rank "
              + ", ".join(f"{x:.2f}" for x in r["peak_gb_by_rank"])
              + f", collectives {r['comm_ms_per_step']:.2f} ms, "
              f"{r['comm_bytes_per_step']:.0f} bytes a step")
    shutil.rmtree(root, ignore_errors=True)
    done(t0)

    t0 = phase("the model-axis path's training kernels at the shards' "
               "shapes (CUDA events)")
    free_card(torch, dev, "the shard-shape kernels")
    shard = tp_shard_kernels(torch, dev, smi, codes_np, batches)
    done(t0)
    return {"runs": runs, "shard_kernels": shard, "launches": launches}


# ---------------------------------------------------------------- phase 29
# the CTR and two-tower models on a "model" mesh axis: training with their
# tables' rows and towers split over the ranks, and serving FM, DLRM-RM2
# and DIEN under --mesh, ranks time-sharing the one card (gloo staged
# through host memory)

# (run, arch, (D, S), batch rows, microbatches, steps): phase 24's
# batches and microbatches; DIEN's batch cut to 32,768, since two ranks
# at phase 24's 41.25 GB do not fit on the card
CTR_TP_RUNS = (
    ("a", "two-tower-retrieval", (1, 2), CTR_B, 2, 4),
    ("b", "two-tower-retrieval-jpq", (1, 2), CTR_B, 2, 4),
    ("c", "fm", (1, 4), CTR_B, 1, 4),
    ("c", "fm-jpq", (1, 4), CTR_B, 1, 4),
    ("d", "dlrm-rm2-jpq", (1, 4), CTR_B, 1, 4),
    ("e", "dien", (1, 2), 32_768, 2, 3),
    ("e", "dien-jpq", (1, 2), 32_768, 2, 3),
    ("f", "fm", (2, 2), CTR_B, 1, 4))
CTR_TP_PEAK_GB = 75.0            # the ranks' peaks together, one card
CTR_MESH_ARCHS = ("fm", "fm-jpq", "dlrm-rm2-jpq", "dien", "dien-jpq")


def ctr_batches(np, data, arch, rows, n):
    """``n`` host batches of ``rows`` rows for ``arch``, phase 24's: the
    two-tower template's distributions at full shape from (seed 0,
    step), SyntheticClicks for FM and DLRM, dien_batch over phase 7's
    sequences for DIEN."""
    from repro_torch.configs.recsys_archs import (DLRM_VOCABS, FM_VOCABS,
                                                  N_CANDIDATES)
    from repro_torch.data.clicks import ClickDataConfig, SyntheticClicks
    from repro_torch.data.clicks import dien_batch
    fam = arch.replace("-jpq", "")
    if fam == "two-tower-retrieval":
        def one(s):
            r = np.random.default_rng((0, s))
            return {"user_hist": r.integers(0, N_CANDIDATES + 1, (rows, 50)),
                    "pos_item": r.integers(1, N_CANDIDATES + 1, (rows,)),
                    "logq": np.zeros(rows, np.float32)}
        return [one(s) for s in range(n)]
    if fam == "dien":
        return [dien_batch(data, s, rows, 100) for s in range(n)]
    vocabs, keys = ((FM_VOCABS, ("sparse", "label")) if fam == "fm" else
                    (DLRM_VOCABS, ("dense", "sparse", "label")))
    clicks = SyntheticClicks(ClickDataConfig(n_dense=13, vocab_sizes=vocabs,
                                             seed=0))
    return [{k: b[k] for k in keys}
            for b in (clicks.batch(s, rows) for s in range(n))]


def ctr_tp_rank(mesh, jobs, batch_dir, out_dir, serve_archs=()):
    """One rank of phase 29 (module-level: it is pickled): one pool
    task a world size.  Each job ``(run, arch,
    (D, S), rows, microbatches, steps)`` builds the arch's full-width
    model from seed 0 on the card and trains it through ``Trainer`` on
    a ``(D, S)`` mesh of this world (``mesh``, or one made from the
    running group; its placement's blocks kept, the rows of the batch
    its data index gives it), on the host batches saved under
    ``batch_dir``; the embedding_bag launch counters, the peak memory
    and ``HostMesh.comm`` are read around the run.  Then the ``--mesh
    S`` serving of ``serve_archs`` on the ``(1, world)`` mesh
    (``ctr_serve_rank``, under ``out_dir/serve``).  Writes
    ``out_dir/rank<r>.pt``."""
    import numpy as np
    import torch

    from repro_torch import fp32_matmuls
    from repro_torch.configs import get_bundle
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig
    fp32_matmuls()
    dev = mesh.device
    res = {"rank": mesh.rank, "transport": mesh.transport}
    on = {(mesh.shape["data"], mesh.shape["model"]): mesh}

    def of(shape):
        if shape not in on:
            on[shape] = mesh_mod.make_host_mesh(
                shape[0] * shape[1], shape[1], device=dev, share_card=True)
        return on[shape]
    for run, arch, shape, rows, mb, steps in jobs:
        m = of(shape)
        with np.load(os.path.join(batch_dir, f"{arch}.npz")) as z:
            batches = [{k.split("/")[1]: z[k] for k in z.files
                        if k.startswith(f"{s}/")} for s in range(steps)]
        model = get_bundle(arch).make_model(device=dev, seed=0)
        tr = Trainer(model, OptConfig(lr=3e-3), TrainConfig(
            steps=steps, batch_size=rows, log_every=1, eval_every=0,
            microbatches=mb), data_fn=lambda s: batches[s], mesh=m)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ec.reset_launches()
        comm0 = dict(m.comm)
        params, hist = tr.run(params=model.params())
        torch.cuda.synchronize(dev)
        hrows = [h for h in hist if "loss" in h]
        specs = _flat(tr._specs)
        res[f"{run}:{arch}"] = {
            "losses": [h["loss"] for h in hrows],
            "step_ms": [h["sec"] * 1e3 for h in hrows],
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": dict(ec.launches),
            "comm": {k: m.comm[k] - comm0[k] for k in comm0},
            "split": {k: tuple(x.shape) for k, x in _flat(params).items()
                      if any(e == "model" for e in specs[k])}}
        del model, tr, params, hist, batches
        # the next job in this process may need the card whole: a cuBLAS
        # workspace made while a large block was free pins its segment
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
    if serve_archs:
        ctr_serve_rank(of((1, mesh.world_size)), serve_archs,
                       os.path.join(out_dir, "serve"))
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def ctr_serve_model(arch, device):
    """The arch's full-width model from seed 0 and a request template
    whose ids lie in every field's range (``make_requests`` draws each
    integer field over the template's [min, max]): FM's below its
    smallest vocabulary, 10,000; DLRM's below 4,000; DIEN's histories
    and targets over the catalogue.  Module-level: it is pickled."""
    import numpy as np

    from repro_torch.configs import get_bundle
    model = get_bundle(arch).make_model(device=device, seed=0)
    r = np.random.default_rng(29)
    if arch.startswith("fm"):
        tmpl = {"sparse": r.integers(0, 10_000, (B, 39))}
    elif arch.startswith("dlrm"):
        tmpl = {"dense": r.standard_normal((B, 13)).astype(np.float32),
                "sparse": r.integers(0, 4_000, (B, 26))}
    else:
        tmpl = {"hist": r.integers(0, 1_000_001, (B, 100)),
                "target": r.integers(1, 1_000_001, (B,))}
    return model, tmpl


def _ctr_serve_args(arch, S=0):
    from repro_torch.launch import serve as serve_mod
    argv = ["--arch", arch, "--batch-size", str(B), "--requests",
            str(REQUESTS), "--device", "cuda"]
    if S:
        argv += ["--mesh", str(S), "--share-card"]
    return serve_mod.build_parser().parse_args(argv)


def ctr_serve_rank(mesh, archs, out_dir):
    """One rank of phase 29's serving (module-level: it is pickled):
    the ``--mesh S`` CLI's per-rank body (``serve._mesh_rank``: build,
    keep this rank's catalogue rows, ``serve_loop`` under the mesh) for
    each arch in turn, the results under ``out_dir/<arch>``."""
    import functools

    import torch

    from repro_torch.launch import serve as serve_mod
    for arch in archs:
        sub = os.path.join(out_dir, arch)
        os.makedirs(sub, exist_ok=True)
        serve_mod._mesh_rank(mesh, _ctr_serve_args(arch, mesh.shape["model"]),
                             functools.partial(ctr_serve_model, arch), sub,
                             True)
        gc.collect()
        torch.cuda.empty_cache()


def _longest_run(ec, ids, V):
    """The longest run of one row the bag backward's sort gives ``ids``
    over a ``V``-row table (the sentinel V, foreign slots, not a row)."""
    order = ec.sort_ids(ids.contiguous(), V)
    return int((order.offs[1:] - order.offs[:-1]).max())


def ctr_shard_bag_rows(torch, dev, smi, tt_batch, fm_batch):
    """The embedding_bag kernels at phase 29's shard shapes, each against
    its plain version and timed beside its bound, plain version and
    library call: (1) the two-tower user tower's pool on the last rank's
    500,224-row block at (1, 2), one microbatch slice of 32,768 bags x
    50 (``embedding_bag_block``), forward and backward; (2) FM's table
    gather on the last rank's 772,500-row block at (1, 4), 65,536 x 39
    slots, d = 10 (``gather_block``'s backward: ``cuda.block_backward``);
    (3) FM's linear term at (1, 4), the bag over the 2,555,904 gathered
    rows (forward).  Each block's backward is bit-equal to the same rows
    of the whole table's backward on the same dout; the longest run the
    backward sees on a block is printed beside one card's.  Returns
    {kernel: {shape: row}}."""
    import torch.nn.functional as F

    from repro_torch.configs.recsys_archs import FM_VOCABS
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag import ref as eref
    gen = torch.Generator(device=dev).manual_seed(29)
    rows = {"embedding_bag": {}, "embedding_bag_backward": {}}

    def show(kernel, shape, r):
        rows[kernel][shape] = r
        print(f"   {kernel}, {shape}: {r['ms']:.4f} ms kernel"
              + ("" if "checked_ms" not in r else
                 f" ({r['checked_ms']:.4f} through the ops call)")
              + f", {r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} ms "
              f"{r['library']}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); bit-equal to plain"
              + ("" if "longest_run" not in r else
                 f"; longest run {r['longest_run']} on the block, "
                 f"{r['longest_run_one_card']} on one card, "
                 f"{r['foreign_slots']} foreign slots skipped (the old "
                 f"clamp put {r['clamped_edge_max']} on one edge row)")
              + f"; on {smi}")

    # (1) the two-tower pool on a (1, 2) block
    V, d, S = 1_000_448, 256, 2
    nb = V // S
    lo = (S - 1) * nb
    ids = torch.as_tensor(tt_batch["user_hist"][:CTR_B // 2], device=dev)
    mask = (ids > 0).float()
    n, L = ids.shape
    table = torch.randn((nb, d), generator=gen, device=dev)
    loc = ids - lo
    own = (loc >= 0) & (loc < nb)
    safe, marked = torch.where(own, loc, 0), torch.where(own, loc, nb)
    w = torch.where(own, mask, 0.0)
    with torch.no_grad():
        out = eops.embedding_bag_block(table, loc, own, mask)
    check(bits_equal(out, eref.embedding_bag_ref(table, safe, w)),
          "embedding_bag_block != plain on the two-tower block")
    distinct = torch.unique(loc[own]).numel()
    b_ms, b_by = bound(distinct * d * 4 + n * L * 12 + n * d * 4,
                       {"fp32 FMAs": (n * L * d, FADD_PER_S)})
    show("embedding_bag", "two-tower (1, 2) block, a 32,768-bag slice", {
        "V": nb, "d": d, "n_bags": n, "L": L, "own_slots": int(own.sum()),
        "distinct_rows": distinct, "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: ec.launch(table, safe, w), 20),
        "checked_ms": cuda_ms(lambda: eops.embedding_bag_block(
            table, loc, own, mask), 20),
        "plain_ms": cuda_ms(lambda: eref.embedding_bag_ref(table, safe, w),
                            3),
        "library_ms": cuda_ms(lambda: F.embedding_bag(
            safe, table, mode="sum", per_sample_weights=w), 20),
        "library": "F.embedding_bag", "bound_ms": b_ms, "bound_by": b_by})
    dout = torch.randn((n, d), generator=gen, device=dev)
    g = ec.block_backward(marked, w, dout, nb)
    whole = ec.embedding_bag_backward(ids, mask, dout, V)
    check(bits_equal(g, whole[lo:].contiguous()),
          "the two-tower block's backward != the whole table's rows")
    del whole
    leaf = table.clone().requires_grad_(True)
    b_ms, b_by = bound(n * d * 4 + n * L * 12 + nb * d * 4,
                       {"fp32 FMAs": (int(own.sum()) * d, FADD_PER_S)})
    show("embedding_bag_backward", "two-tower (1, 2) block, a 32,768-bag "
         "slice", {
             "V": nb, "d": d, "n_bags": n, "L": L,
             "own_slots": int(own.sum()), "max_abs_err": 0.0,
             "longest_run": _longest_run(ec, marked, nb),
             "longest_run_one_card": _longest_run(ec, ids, V),
             "foreign_slots": int((~own).sum()),
             "clamped_edge_max": int(max((loc < 0).sum(), (loc >= nb).sum())),
             "ms": cuda_ms(lambda: ec.block_backward(marked, w, dout, nb),
                           10),
             "plain_ms": cuda_ms(lambda: eref.block_backward_ref(
                 marked, w, dout, nb), 3),
             "library_ms": cuda_ms(lambda: torch.autograd.grad(
                 F.embedding_bag(safe, leaf, mode="sum",
                                 per_sample_weights=w), leaf, dout), 5),
             "library": "F.embedding_bag's backward", "bound_ms": b_ms,
             "bound_by": b_by})
    del table, leaf, dout, g, ids, loc, own, safe, marked, w, mask, out
    torch.cuda.empty_cache()

    # (2) FM's table gather on a (1, 4) block, (3) its linear term
    V, d, S = sum(FM_VOCABS), 10, 4
    nb = V // S
    lo = (S - 1) * nb
    off = torch.cumsum(torch.tensor([0, *FM_VOCABS[:-1]], device=dev), 0)
    flat = torch.as_tensor(fm_batch["sparse"], device=dev) + off[None, :]
    n, L = flat.shape
    loc = flat - lo
    own = (loc >= 0) & (loc < nb)
    marked = torch.where(own, loc, nb).reshape(-1, 1).contiguous()
    dout = torch.randn((n * L, d), generator=gen, device=dev)
    g = ec.block_backward(marked, None, dout, nb)
    check(bits_equal(g, eref.block_backward_ref(marked.cpu(), None,
                                                dout.cpu(), nb).to(dev)),
          "FM's block gather backward != its plain version")
    check(bits_equal(g, ec.gather_backward(flat, dout.view(n, L, d), V)[
        lo:].contiguous()), "FM's block gather backward != the whole rows")
    safe = torch.where(own, loc, 0).reshape(-1)
    leaf = torch.randn((nb, d), generator=gen, device=dev,
                       requires_grad=True)
    b_ms, b_by = bound(n * L * (d * 4 + 8) + nb * d * 4,
                       {"fp32 adds": (int(own.sum()) * d, FADD_PER_S)})
    show("embedding_bag_backward", "FM table gather (1, 4) block, 65,536 x "
         "39", {
             "V": nb, "d": d, "slots": n * L, "own_slots": int(own.sum()),
             "max_abs_err": 0.0,
             "longest_run": _longest_run(ec, marked, nb),
             "longest_run_one_card": _longest_run(ec, flat, V),
             "foreign_slots": int((~own).sum()),
             "clamped_edge_max": int(max((loc < 0).sum(), (loc >= nb).sum())),
             "ms": cuda_ms(lambda: ec.block_backward(marked, None, dout, nb),
                           10),
             "plain_ms": cuda_ms(lambda: eref.block_backward_ref(
                 marked, None, dout, nb), 3),
             "library_ms": cuda_ms(lambda: torch.autograd.grad(
                 F.embedding(safe, leaf), leaf, dout), 10),
             "library": "F.embedding's backward", "bound_ms": b_ms,
             "bound_by": b_by})
    lin = torch.randn((V, 1), generator=gen, device=dev)
    got = lin[flat].reshape(-1, 1).contiguous()      # take_rows' rows
    at = torch.arange(n * L, device=dev).view(n, L)
    check(bits_equal(ec.embedding_bag(got, at), ec.embedding_bag(lin, flat)),
          "FM's linear term over the gathered rows != over the whole linear")
    check(bits_equal(ec.embedding_bag(got, at),
                     eref.embedding_bag_ref(got, at)),
          "FM's linear bag over the gathered rows != plain")
    b_ms, b_by = bound(n * L * 12 + n * 4,
                       {"fp32 FMAs": (n * L, FADD_PER_S)})
    show("embedding_bag", "FM linear (1, 4), 65,536 bags over the "
         "2,555,904 gathered rows", {
             "V": n * L, "d": 1, "n_bags": n, "L": L, "max_abs_err": 0.0,
             "ms": cuda_ms(lambda: ec.launch(got, at), 20),
             "checked_ms": cuda_ms(lambda: ec.embedding_bag(got, at), 20),
             "plain_ms": cuda_ms(lambda: eref.embedding_bag_ref(got, at), 3),
             "library_ms": cuda_ms(lambda: F.embedding_bag(at, got,
                                                           mode="sum"), 20),
             "library": "F.embedding_bag", "bound_ms": b_ms,
             "bound_by": b_by})
    del flat, loc, own, marked, dout, g, safe, leaf, lin, got, at
    torch.cuda.empty_cache()
    return rows


def ctr_model_axis_phases(torch, np, dev, smi, data, ctr_train):
    """Phase 29: the CTR and two-tower models on a ``(data, model)`` mesh
    of ranks time-sharing the one card (a ``RankPool``: the
    ``--model-axis S --share-card`` CLI's transport), then ``--mesh S`` serving of FM, DLRM-RM2 and DIEN, then
    the embedding_bag kernels at the shards' shapes.  ``ctr_train``:
    phase 24's summary by arch (its first loss, median step and peak),
    printed beside each run.  Returns {"runs", "serve", "shard_kernels",
    "launches"}."""
    import shutil
    import tempfile

    from repro_torch.configs import get_bundle
    from repro_torch.configs.recsys_archs import DLRM_VOCABS
    from repro_torch.launch import serve as serve_mod

    t0 = phase("main path: the CTR and two-tower models on a 'model' mesh "
               "axis, full width, ranks sharing the one card (train --arch "
               "A --model-axis S --share-card)")
    free_card(torch, dev, "the CTR model-axis phase")
    rows_ = sum(DLRM_VOCABS)
    print(f"   dlrm-rm2 (full table) is left out: each of 4 ranks builds "
          f"the whole {rows_ * 64 * 4 / 1e9:.1f} GB table before keeping its "
          f"quarter, and a quarter with adamw is "
          f"{4 * rows_ * 64 * 4 / 4 / 1e9:.1f} GB a rank: four ranks do "
          f"not fit on one card (the CPU tests hold it at reduced rows)")
    root = os.path.join(HERE, "build", "chip_smoke_ctr_tp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # the host batches (saved for the ranks) and the one-card step-0 loss
    # on the same batch, microbatched as the run is
    one_card, batches0 = {}, {}
    for run, arch, (D, S), rows, mb, steps in CTR_TP_RUNS:
        key = f"{run}:{arch}"
        bs = ctr_batches(np, data, arch, rows, steps)
        np.savez(os.path.join(root, f"{arch}.npz"),
                 **{f"{s}/{k}": v for s, b in enumerate(bs)
                    for k, v in b.items()})
        batches0[arch] = bs[0]
        model = get_bundle(arch).make_model(device=dev, seed=0)
        params = model.params()
        with torch.no_grad():
            n = rows // mb
            one_card[key] = float(np.mean([float(model.train_loss(params, {
                k: torch.as_tensor(v[i * n:(i + 1) * n], device=dev)
                for k, v in bs[0].items()})[0]) for i in range(mb)]))
        del model, params, bs
        free_card(torch, dev, f"{key}'s ranks")
    # the serving below runs in the same processes, after the training
    # jobs of its world: its unsharded references first
    ref = {}
    for arch in CTR_MESH_ARCHS:
        model, tmpl = ctr_serve_model(arch, dev)
        ref[arch] = serve_mod.serve_loop(model, model.params(), tmpl,
                                         _ctr_serve_args(arch),
                                         keep_outputs=True)
        del model
        free_card(torch, dev, f"{arch}'s unsharded reference")
    ranks, serve_dirs = {}, {}
    worlds = {}                       # world size -> its jobs, in order
    for run, arch, sh, rows, mb, steps in CTR_TP_RUNS:
        worlds.setdefault(sh[0] * sh[1], []).append(
            (run, arch, sh, rows, mb, steps))
    for n, jobs in worlds.items():
        out_dir = tempfile.mkdtemp(prefix=f"ranks-{n}-", dir=root)
        t1 = time.perf_counter()
        run_ranks(ctr_tp_rank, n, (jobs, root, out_dir, CTR_MESH_ARCHS
                                   if n in MESH_SHARDS else ()),
                  dev, model=jobs[0][2][1], timeout=900)
        per = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(n)]
        for sh in dict.fromkeys(j[2] for j in jobs):
            ranks[sh] = per
        serve_dirs[n] = os.path.join(out_dir, "serve")
        print(f"   {n} ranks (" + ", ".join(
            f"({D}, {S})" for D, S in dict.fromkeys(j[2] for j in jobs))
            + (f", then serving at (1, {n})" if n in MESH_SHARDS else "")
            + f"): {time.perf_counter() - t1:.1f} s (the runs, on the "
            f"pool's ranks)")
    runs = {}
    launches = {"embedding_bag": {}, "embedding_bag_backward": {}}
    for run, arch, shape, rows, mb, steps in CTR_TP_RUNS:
        key = f"{run}:{arch}"
        rs = [x[key] for x in ranks[shape]]
        r0 = rs[0]
        for r, x in enumerate(rs):
            check(ranks[shape][r]["transport"] == "gloo-staged",
                  f"{key}: rank {r} transport "
                  f"{ranks[shape][r]['transport']}")
            check(x["losses"] == r0["losses"],
                  f"{key}: rank {r}'s losses differ from rank 0's")
            check(x["launches"]["embedding_bag_backward"] > 0,
                  f"{key}: rank {r} never launched the embedding_bag "
                  f"backward")
            if arch in BAG_ARCHS:
                check(x["launches"]["embedding_bag"] > 0,
                      f"{key}: rank {r} never launched embedding_bag")
        check(len(r0["losses"]) == steps and all(np.isfinite(r0["losses"])),
              f"{key}: losses {r0['losses']}")
        want = one_card[key]
        check(abs(r0["losses"][0] - want) <= 1e-5 * abs(want),
              f"{key}: step 0 loss {r0['losses'][0]} != one card's {want}")
        peaks = [x["peak_gb"] for x in rs]
        check(sum(peaks) <= CTR_TP_PEAK_GB,
              f"{key}: the ranks' peaks {peaks} exceed {CTR_TP_PEAK_GB} GB")
        p24 = ctr_train.get(arch, {})
        row = {"shape": list(shape), "batch": rows, "microbatches": mb,
               "losses": r0["losses"], "one_card_step0_loss": want,
               "median_step_ms": float(np.median(r0["step_ms"][1:])),
               "step_ms": r0["step_ms"], "peak_gb_by_rank": peaks,
               "phase24_step_ms": p24.get("step_ms"),
               "phase24_peak_gb": p24.get("peak_gb"),
               "phase24_batch": CTR_B,
               "comm_ms_per_step": 1e3 * r0["comm"]["seconds"] / steps,
               "comm_bytes_per_step": r0["comm"]["bytes"] / steps,
               "comm_calls_per_step": r0["comm"]["calls"] / steps,
               "split_leaves": {k: list(v) for k, v in r0["split"].items()},
               "launches_by_rank": [x["launches"] for x in rs]}
        runs[key] = row
        for k in launches:
            launches[k][f"{shape[0]}x{shape[1]}:{arch}"] = [
                x["launches"][k] for x in rs]
        print(f"   ({run}) {arch} ({shape[0]}, {shape[1]}), B={rows}, "
              f"microbatches={mb}: losses "
              + " ".join(f"{x:.5f}" for x in r0["losses"])
              + f" (one card's step 0 {want:.5f}); step "
              f"{row['median_step_ms']:.1f} ms (phase 24's one-card step "
              f"{p24.get('step_ms', float('nan')):.1f} ms at B={CTR_B}); "
              f"peak GB by rank " + ", ".join(f"{x:.2f}" for x in peaks)
              + f" (phase 24's {p24.get('peak_gb', float('nan')):.2f}); "
              f"collectives {row['comm_ms_per_step']:.1f} ms, "
              f"{row['comm_bytes_per_step']:.0f} bytes, "
              f"{row['comm_calls_per_step']:.1f} calls a step; "
              f"{len(r0['split'])} split leaves; launches by rank "
              f"{[x['launches'] for x in rs]}; on {smi}")
    done(t0)

    t0 = phase(f"main path: serve --mesh S --share-card for "
               f"{', '.join(CTR_MESH_ARCHS)}, S = 2 and 4, {REQUESTS} "
               f"requests of B={B}, against the unsharded path")
    print("   dlrm-rm2 (full table) is left out: each rank builds the whole "
          "57.1 GB table before keeping its rows; each S ran on the ranks of "
          "the training above, after its jobs")
    serve = {}
    for S in MESH_SHARDS:
        out_dir = serve_dirs[S]
        for arch in CTR_MESH_ARCHS:
            res = [torch.load(os.path.join(out_dir, arch, f"rank{r}.pt"),
                              weights_only=False) for r in range(S)]
            for r, x in enumerate(res):
                check(x["mesh"] == S and x["transport"] == "gloo-staged",
                      f"{arch} mesh={S}: rank {r} {x['transport']}")
                check(len(x["outputs"]) == len(ref[arch]["outputs"])
                      == REQUESTS, f"{arch} mesh={S}: response counts")
                for got, want in zip(x["outputs"], ref[arch]["outputs"]):
                    check(tuple(got.shape) == (B,)
                          and bool(torch.isfinite(got).all())
                          and bits_equal(got, want),
                          f"{arch} mesh={S}: rank {r}'s response != the "
                          f"unsharded path")
            x = res[0]
            row = {"arch": arch, "S": S, "p50_ms": x["p50_ms"],
                   "p99_ms": x["p99_ms"],
                   "unsharded_p50_ms": ref[arch]["p50_ms"],
                   "unsharded_p99_ms": ref[arch]["p99_ms"],
                   "comm_ms_per_request": float(np.median(x["comm_ms"])),
                   "comm_bytes_per_request": int(np.median(
                       x["comm_bytes"])),
                   "comm_calls_per_request": int(np.median(
                       x["comm_calls"])),
                   "launches_by_rank": [y["launches"] for y in res]}
            serve[f"{arch}@{S}"] = row
            print(f"   {arch} mesh={S}: p50={row['p50_ms']:.3f}ms "
                  f"p99={row['p99_ms']:.3f}ms (unsharded "
                  f"{row['unsharded_p50_ms']:.3f}/"
                  f"{row['unsharded_p99_ms']:.3f} ms), collectives "
                  f"{row['comm_ms_per_request']:.3f} ms, "
                  f"{row['comm_bytes_per_request']} bytes in "
                  f"{row['comm_calls_per_request']} calls a request; every "
                  f"rank's {REQUESTS} responses bit-equal to the unsharded "
                  f"path; on {smi}")
    shutil.rmtree(root, ignore_errors=True)
    done(t0)

    t0 = phase("the CTR model-axis path's embedding_bag kernels at the "
               "shards' shapes (CUDA events)")
    free_card(torch, dev, "the CTR shard-shape kernels")
    shard = ctr_shard_bag_rows(torch, dev, smi,
                               batches0["two-tower-retrieval"],
                               batches0["fm"])
    done(t0)
    return {"runs": runs, "serve": serve, "shard_kernels": shard,
            "launches": launches}


# ---------------------------------------------------------------- phase 30
# the elastic exchange on a (D, S) mesh: the model replicated over
# "model" (as the reference's shard_map runs it), the exchange over the
# "data" group, ranks time-sharing the one card over gloo staged through
# host memory

EM_V, EM_STEPS, EM_STOP_AT = 4, 3, 1
EM_BUDGET_GB = 75.0               # the ranks' peaks together, one card
# what a rank holds beyond its peak allocation: the caching allocator's
# unused blocks (on an H100 80GB HBM3, four SASRec ranks at B = 16 ran
# out of memory with 12.20 GiB allocated and 2.96 GiB reserved besides
# on a rank) and its CUDA context
EM_SLACK, EM_CONTEXT_GB = 1.2, 0.6
EM_TT = "two-tower-retrieval-jpq"
EM_SEQ_KERNELS = ("jpq_scores", "jpq_scores_bwd", "jpq_lookup",
                  "jpq_lookup_bwd")


def state_digest(torch, trees):
    """sha1 of the dtype, shape and bytes of every tensor leaf of
    ``trees``, in order: equal digests, equal bits."""
    import hashlib

    from repro_torch.nn.module import tree_leaves
    h = hashlib.sha1()
    for x in tree_leaves(list(trees)):
        h.update(f"{x.dtype}{tuple(x.shape)}".encode())
        if x.numel():
            h.update(x.detach().contiguous().reshape(-1).view(
                torch.uint8).cpu().numpy())
    return h.hexdigest()


def elastic_step_bytes(values, D, fsdp, n_meta):
    """(bytes, calls) the data group's collectives return to one rank in
    an int8 elastic step at V = EM_V over D data ranks (none at D = 1):
    each round's gather of the ranks' meta (``n_meta`` fp32: the leaves'
    scales, the loss, the aux metrics) and of the replicated leaves'
    payloads (16-byte aligned), and with fsdp its all-to-all of the
    owned rows' payloads; with fsdp also the parameters' gather at the
    start (the row-sharded leaves, fp32) and the norm's segment gather
    (L fp32 a sharded leaf)."""
    from repro_torch.dist import compression
    from repro_torch.nn.module import tree_leaves
    if D == 1:
        return 0, 0
    leaves = tree_leaves(values)
    flags = [fsdp and compression.fsdp_leaf_sharded(x, EM_V)
             for x in leaves]
    lay = compression._Layout(leaves, flags, D, "int8")
    L = EM_V // D
    total = L * D * (4 * n_meta + lay.g_bytes + lay.c_bytes)
    calls = L * (2 + (1 if lay.c_bytes else 0))
    if any(flags):
        total += sum(x.numel() * x.element_size()
                     for x, f in zip(leaves, flags) if f)
        total += D * sum(lay.sharded) * L * 4
        calls += 2
    return total, calls


def _digest_trainer(Trainer, torch):
    """A Trainer whose elastic step also records, after each step, the
    digest of the whole state (values and moments gathered from fsdp's
    slices, the error rows over the data group), and the step alone:
    its host ms (synchronised) and the mesh's comm delta; and the fp32
    entries of a round's meta (``n_meta``: the exchanged leaves' scales,
    the loss, the aux metrics, as ``quantise_pack`` is handed them)."""
    from repro_torch.dist import compression

    class Digest(Trainer):
        def _build_dp_step(self, shapes):
            step = super()._build_dp_step(shapes)
            mesh, fsdp = self.mesh, self._fsdp
            self.digests, self.inner = [], []
            pack = step.quantise_pack

            def counted_pack(lay, grads, err_r, new_err_r, loss, aux):
                self.n_meta = len(grads) + 1 + len(aux)
                return pack(lay, grads, err_r, new_err_r, loss, aux)
            step.quantise_pack = counted_pack

            def whole(t):
                return step.gather(t) if fsdp else t

            def stepped(values, opt, err, batch, rng):
                torch.cuda.synchronize(mesh.device)
                c0, t0 = dict(mesh.comm), time.perf_counter()
                nv, no, ne, mets = step(values, opt, err, batch, rng)
                torch.cuda.synchronize(mesh.device)
                row = {k: mesh.comm[k] - c0[k] for k in c0}
                row["ms"] = (time.perf_counter() - t0) * 1e3
                self.inner.append(row)
                self.digests.append(state_digest(torch, [
                    whole(nv), whole(no["m"]), whole(no["v"]),
                    compression.gather_rows(ne, mesh)]))
                return nv, no, ne, mets
            stepped.shard, stepped.gather = step.shard, step.gather
            return stepped
    return Digest


def elastic_run(mesh, job, codes_np):
    """One run of phase 30 on ``mesh`` (every rank calls it alike):
    ``job["arch"]``, "sasrec" (phase 7's full-width model on
    ``job["batches"]``) or ``EM_TT`` (phase 26's batches,
    ``job["rows"]`` a step), trained ``job["steps"]`` steps, int8 at V = EM_V with
    ``job["fsdp"]`` and ``job["overlap"]``; ``job["ckpt"]`` its
    checkpoint directory, ``job["sigterm"]`` = (rank, step) a SIGTERM
    to that rank as it reads that step's batch.  Returns the per-step
    digests, the steps' own ms and collectives, their expected bytes
    and calls, the peak GB, the launches, the losses and where it
    stopped."""
    import signal

    import numpy as np
    import torch

    from repro_torch.configs import get_bundle
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig
    dev = mesh.device
    if job["arch"] == "sasrec":
        model = full_width_model(codes_np, dev)

        def batch_of(s):
            return job["batches"][s]
    else:
        model = get_bundle(EM_TT).make_model(device=dev, seed=0)

        def batch_of(s):
            return tt_engine_batch(np, model.cfg, s, job["rows"])

    def data_fn(s):
        if job.get("sigterm") == (mesh.rank, s):
            os.kill(os.getpid(), signal.SIGTERM)
        return batch_of(s)

    for c in (ec, sc, lc):
        c.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = _digest_trainer(Trainer, torch)(
        model, OptConfig(lr=3e-3), TrainConfig(
            steps=job["steps"], batch_size=TRAIN_B, log_every=1,
            eval_every=0, ckpt_dir=job.get("ckpt"), ckpt_every=0,
            grad_compression="int8", grad_accum_shards=EM_V,
            fsdp=job["fsdp"], overlap=job["overlap"]),
        data_fn=data_fn, mesh=mesh)
    params, hist = tr.run(params=model.params())
    torch.cuda.synchronize(dev)
    rows = [h for h in hist if "loss" in h]
    exp_bytes, exp_calls = elastic_step_bytes(
        params, mesh.shape["data"], job["fsdp"], tr.n_meta)
    out = {"digests": tr.digests, "inner": tr.inner,
           "expected_bytes": exp_bytes, "expected_calls": exp_calls,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": {k: v for c in (ec, sc, lc)
                        for k, v in c.launches.items()},
           "losses": [h["loss"] for h in rows],
           "first_step": rows[0]["step"], "done_step": tr.done_step,
           "preempted": tr._preempted,
           "payload_bytes": rows[0]["payload_bytes"]}
    del tr, params, model, hist
    gc.collect()
    torch.cuda.empty_cache()
    return out


def elastic_mesh_rank(mesh, codes_np, jobs, out_dir):
    """One rank of phase 30 (module-level: it is pickled): each job
    through ``elastic_run``; writes ``out_dir/rank<r>.pt``."""
    import torch

    from repro_torch import fp32_matmuls
    fp32_matmuls()
    res = {"rank": mesh.rank, "transport": mesh.transport}
    for job in jobs:
        res[job["name"]] = elastic_run(mesh, job, codes_np)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def elastic_mesh_phases(torch, np, dev, smi, data, codes_np, engine):
    """Phase 30: the elastic exchange on a ``(D, S)`` mesh, ranks
    time-sharing the one card (gloo staged), the model replicated over
    ``"model"`` as the reference's ``shard_map`` runs it.  The (1, 1)
    runs first on this process (NCCL, world 1), then (2, 2) on four
    ranks: (b) SASRec int8 + fsdp, overlap ``backward``, and (d) SASRec
    int8 SIGTERM'd on rank 3 as it reads step 1's batch (every rank
    stops after it; rank 0 saves at step 2); then (1, 2) on two ranks:
    (a) SASRec int8, overlap ``none``; (d) resumed from (2, 2)'s
    checkpoint; (c) two-tower-retrieval-jpq int8 at phase 26's batch.
    Every rank's values, moments and error state after each step
    bit-equal (sha1 digests) to the same step at (1, 1); each rank
    launched its path's kernels; its peak, the ranks' sum against the
    card; the data group's collectives a step exactly as counted
    (``elastic_step_bytes``); then the kernels at the rounds' shapes.
    ``engine``: phase 26's summary (its world-1 peaks and steps).
    Returns {"runs", "kernels_at_round_shape", "launches"}."""
    import shutil
    import tempfile

    from repro_torch.configs import get_bundle
    from repro_torch.launch import mesh as mesh_mod

    t0 = phase(f"main path: the elastic exchange on a (D, S) mesh, the "
               f"model replicated over 'model', ranks sharing the one card"
               f" (train --model-axis S --grad-compression int8 "
               f"--grad-accum-shards {EM_V} --share-card)")
    free_card(torch, dev, "the elastic mesh phase")
    seq26 = engine["seq"]["int8/none"]
    tt26 = engine["two_tower"][EM_TT]
    def need(peak, n):
        return n * (peak * EM_SLACK + EM_CONTEXT_GB)
    print(f"   phase 26's world-1 peaks: SASRec int8 "
          f"{seq26['peak_gb']:.2f} GB, {EM_TT} int8 {tt26['peak_gb']:.2f} "
          f"GB; every rank holds the whole model, its moments and a "
          f"round's logits, so with the allocator's slack (x{EM_SLACK}) "
          f"and a context each ({EM_CONTEXT_GB} GB) 4 SASRec ranks need "
          f"{need(seq26['peak_gb'], 4):.2f} GB and 2 two-tower ranks "
          f"{need(tt26['peak_gb'], 2):.2f} GB (budget {EM_BUDGET_GB} GB)")
    cuts = {}

    def cut(what, rows, peak, n):
        """The batch rows that fit n ranks (a multiple of V; the peak
        taken to scale with the rows)."""
        if need(peak, n) <= EM_BUDGET_GB:
            return rows
        got = max(EM_V, int(rows * EM_BUDGET_GB / need(peak, n))
                  // EM_V * EM_V)
        cuts[what] = (f"B cut from {rows} to {got}: {n} ranks x "
                      f"({peak:.2f} GB x {EM_SLACK} + {EM_CONTEXT_GB}) = "
                      f"{need(peak, n):.2f} GB > {EM_BUDGET_GB} GB")
        return got
    seq_b = cut("sasrec", TRAIN_B, seq26["peak_gb"], 4)
    tt_rows = cut(EM_TT, ENG_TT_B, tt26["peak_gb"], 2)
    for what, why in cuts.items():
        print(f"   {what} on four ranks: {why}")
    full = [data.train_batch(s, TRAIN_B) for s in range(EM_STEPS)]
    small = full if seq_b == TRAIN_B else [data.train_batch(s, seq_b)
                                           for s in range(EM_STEPS)]
    root = os.path.join(HERE, "build", "chip_smoke_elastic_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ck = os.path.join(root, "ck")
    # (a) on two ranks takes the whole batch; (b) and (d) run on four
    spec = {"a": dict(arch="sasrec", fsdp=False, overlap="none",
                      batches=full),
            "b": dict(arch="sasrec", fsdp=True, overlap="backward",
                      batches=small, cut=cuts.get("sasrec")),
            "c": dict(arch=EM_TT, fsdp=False, overlap="dispatch",
                      rows=tt_rows, cut=cuts.get(EM_TT)),
            "d": dict(arch="sasrec", fsdp=False, overlap="none",
                      batches=small, cut=cuts.get("sasrec"))}
    ref = {}
    mesh = mesh_mod.make_host_mesh(1, device=dev)
    try:
        for name, job in spec.items():
            if name == "d" and small is full:
                ref["d"] = ref["a"]
                continue
            ref[name] = elastic_run(mesh, dict(job, name=name,
                                               steps=EM_STEPS), codes_np)
            check(all(np.isfinite(ref[name]["losses"])),
                  f"(1, 1) {name}: losses {ref[name]['losses']}")
    finally:
        mesh.close()
    free_card(torch, dev, "the elastic mesh ranks")
    ranks = {}
    plan = (("2x2", 4, [dict(spec["b"], name="b", steps=EM_STEPS),
                        dict(spec["d"], name="d_stop", steps=EM_STEPS,
                             ckpt=ck, sigterm=(3, EM_STOP_AT))]),
            ("1x2", 2, [dict(spec["a"], name="a", steps=EM_STEPS),
                        dict(spec["d"], name="d_resume", steps=EM_STEPS,
                             ckpt=ck),
                        dict(spec["c"], name="c", steps=EM_STEPS)]))
    for shape, n, jobs in plan:
        out_dir = tempfile.mkdtemp(prefix=f"ranks-{shape}-", dir=root)
        t1 = time.perf_counter()
        run_ranks(elastic_mesh_rank, n, (codes_np, jobs, out_dir), dev,
                  model=2, timeout=900)
        ranks[shape] = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                                   weights_only=False) for r in range(n)]
        print(f"   {shape}: {n} ranks, {time.perf_counter() - t1:.1f} s "
              f"(the runs, on the pool's ranks)")
    shutil.rmtree(root, ignore_errors=True)
    runs, launches = {}, {}
    for shape, rs in ranks.items():
        for name in [k for k in rs[0] if k not in ("rank", "transport")]:
            base = "d" if name.startswith("d_") else name
            want = ref[base]["digests"]
            for r, res in enumerate(rs):
                x = res[name]
                check(res["transport"] == "gloo-staged",
                      f"rank {r}: transport {res['transport']}")
                if name == "d_stop":
                    check(x["preempted"] and x["done_step"] == EM_STOP_AT + 1
                          and x["digests"] == want[:EM_STOP_AT + 1],
                          f"(2, 2) d_stop rank {r}: preempted "
                          f"{x['preempted']} at {x['done_step']}, or its "
                          f"steps != (1, 1)'s")
                elif name == "d_resume":
                    check(x["first_step"] == EM_STOP_AT + 1
                          and x["digests"] == want[EM_STOP_AT + 1:],
                          f"(1, 2) d_resume rank {r}: from step "
                          f"{x['first_step']}, != the uninterrupted (1, 1)")
                else:
                    check(x["digests"] == want,
                          f"{shape} {name} rank {r}: a step's state != the "
                          f"same step at (1, 1)")
                kerns = ("embedding_bag_backward",) if base == "c" \
                    else EM_SEQ_KERNELS
                for k in kerns:
                    check(x["launches"][k] > 0,
                          f"{shape} {name}: rank {r} never launched {k}")
                for i, st in enumerate(x["inner"]):
                    check(st["bytes"] == x["expected_bytes"]
                          and st["calls"] == x["expected_calls"],
                          f"{shape} {name} rank {r} step {i}: the data "
                          f"group returned {st['bytes']} bytes in "
                          f"{st['calls']} calls, counted "
                          f"{x['expected_bytes']} in {x['expected_calls']}")
            peaks = [res[name]["peak_gb"] for res in rs]
            check(sum(peaks) <= EM_BUDGET_GB,
                  f"{shape} {name}: the ranks' peaks {peaks} exceed "
                  f"{EM_BUDGET_GB} GB together")
            x0 = rs[0][name]
            w26 = tt26 if base == "c" else (
                engine["seq"]["int8+fsdp/dispatch"] if base == "b"
                else seq26)
            row = {"mesh": shape, "arch": spec[base]["arch"],
                   "fsdp": spec[base]["fsdp"],
                   "overlap": spec[base]["overlap"],
                   "step_ms": float(np.median([s["ms"] for s in x0["inner"]])),
                   "steps_ms": [s["ms"] for s in x0["inner"]],
                   "phase26_step_ms": w26["step_ms"],
                   "peak_gb_by_rank": peaks,
                   "phase26_peak_gb": w26["peak_gb"],
                   "comm_ms": float(np.median([s["seconds"] * 1e3
                                               for s in x0["inner"]])),
                   "comm_bytes": x0["inner"][0]["bytes"],
                   "comm_calls": x0["inner"][0]["calls"],
                   "payload_bytes": x0["payload_bytes"],
                   "payload_x_V": x0["payload_bytes"] * EM_V,
                   "losses": x0["losses"], "digests_equal_1x1": True,
                   "launches_by_rank": [res[name]["launches"] for res in rs],
                   "batch": (spec[base]["rows"] if base == "c" else
                             len(spec[base]["batches"][0]["seq"])),
                   "batch_cut": spec[base].get("cut")}
            runs[f"{shape}:{name}"] = row
            for k, v in x0["launches"].items():
                launches.setdefault(k, {})[f"{shape}:{name}"] = [
                    res[name]["launches"][k] for res in rs]
            print(f"   {shape} {name} ({row['arch']}, B={row['batch']}, "
                  f"int8{' + fsdp' if row['fsdp'] else ''}, overlap "
                  f"{row['overlap']}): step {row['step_ms']:.1f} ms (median "
                  f"of {len(row['steps_ms'])}; phase 26's world-1 step "
                  f"{row['phase26_step_ms']:.1f}), peak GB by rank "
                  + ", ".join(f"{p:.2f}" for p in peaks)
                  + f" (world 1: {row['phase26_peak_gb']:.2f}); the data "
                  f"group's collectives {row['comm_ms']:.2f} ms, "
                  f"{row['comm_bytes']} bytes in {row['comm_calls']} calls "
                  f"a step (counted; payload {row['payload_bytes']} B a "
                  f"shard, x V = {row['payload_x_V']}); every rank's state "
                  f"after each step bit-equal to (1, 1)"
                  + (f"; {row['batch_cut']}" if row["batch_cut"] else "")
                  + f"; on {smi}")
    print(f"   (d) SIGTERM on rank 3 of (2, 2) as it read step "
          f"{EM_STOP_AT}'s batch: every rank stopped at step "
          f"{EM_STOP_AT + 1} and rank 0 saved there; resumed on (1, 2), "
          f"bit-equal to the uninterrupted (1, 1) run")
    done(t0)

    t0 = phase("the elastic rounds' kernels at the rounds' shapes on the "
               "card: rows 3, 3b, 4, 4b (SASRec) and 5b (two-tower-jpq)")
    free_card(torch, dev, "the elastic mesh rounds' kernels")
    model = full_width_model(codes_np, dev)
    params = model.params()
    seq = torch.as_tensor(small[0]["seq"][:seq_b // EM_V], device=dev)
    rnd, ins = slice_kernel_errs(torch, dev, model, params, seq,
                                 f"elastic mesh round T={seq.numel()}")
    errs = {k: rnd[k + "_err"] for k in EM_SEQ_KERNELS}
    del model, params, seq, ins
    free_card(torch, dev, "the two-tower round's kernels")
    model = get_bundle(EM_TT).make_model(device=dev, seed=0)
    errs.update(tt_round_errs(torch, dev, EM_TT, model.params(),
                              tt_engine_batch(np, model.cfg, 0, tt_rows),
                              tt_rows // EM_V))
    del model
    print(f"   round T={rnd['T']}: jpq_scores forward and jpq_lookup "
          f"forward bit-equal to plain; backwards max |err| vs float64 "
          f"{errs['jpq_scores_bwd']:.3e} / {errs['jpq_lookup_bwd']:.3e}; "
          f"the two-tower round's bag backward "
          f"{errs['embedding_bag_backward']:.3e}; "
          f"row 5 (the bag forward) is not on this path: the -jpq tables' "
          f"gathers run forward as table[ids]; on {smi}")
    done(t0)
    return {"runs": runs, "kernels_at_round_shape": {
        "T": rnd["T"], "two_tower_rows": tt_rows // EM_V,
        "max_abs_err": errs}, "launches": launches}


# ---------------------------------------------------------------- phase 31
# the request server under --mesh S: rank 0 runs the server and
# broadcasts each batch and each publish, the other ranks follow; S
# ranks time-sharing the one card over gloo staged through host memory

SRVM_SHARDS = (2, 4)
SRVM_RUNS = (("a", []), ("c", ["--no-prune"]))
SRVM_SLOW_RATE = 100


def server_mesh_rank(mesh, runs, out_dir):
    """One rank of phase 31 (module-level: it is pickled): phase 25's
    full-width two-tower-retrieval-jpq from seed 0, the hot swap's probe
    launches counted alone, this rank's rows kept; then each run through
    ``launch/server.serve_requests`` under the mesh at 500/s, and again
    at ``SRVM_SLOW_RATE``/s where rank 0 found it could not keep up
    (its wall beyond 1.25x the last arrival; the decision broadcast).
    Rank 0 zeroes the launch counters in ``on_ready`` (the others as
    they start to follow), publishes a popularity-permuted catalogue
    without blocking before request ``SRV_SWAP_AT`` in run (a), and
    records each batch (request ids, version), the collectives of each
    broadcast and of each batch's serve, and every response.  Writes
    ``out_dir/rank<r>.pt``."""
    import numpy as np
    import torch

    from repro_torch import bridge, fp32_matmuls, serve
    from repro_torch.configs import get_bundle
    from repro_torch.core.assign import popularity_permutation
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import server as server_mod
    fp32_matmuls()
    dev, S = mesh.device, mesh.world_size
    model = get_bundle("two-tower-retrieval-jpq").make_model(device=dev,
                                                             seed=0)
    codes = model.params()["item_emb"]["codes"]
    b = int(model.emb.cfg.b)
    hists = serve.request_stream(SRV_REQUESTS, n_items=model.cfg.n_items,
                                 max_len=model.cfg.hist_len, seed=0)
    perm = popularity_permutation(serve_mod._template_popularity(
        {"user_hist": np.concatenate(hists)}, codes.shape[0]))
    kc.reset_launches()
    serve.CatalogueRegistry(prune=True).publish(codes, b, perm=perm)
    res = {"rank": mesh.rank, "transport": mesh.transport,
           "probe": dict(kc.launches)}
    del codes
    bridge.keep_local_rows(model, mesh)
    real_follow = serve.server.follow

    def counted_follow(*a, **kw):
        kc.reset_launches()
        return real_follow(*a, **kw)
    serve.server.follow = counted_follow
    arrivals = serve.poisson_arrivals(500.0, SRV_REQUESTS, seed=0)
    for name, flags in runs:
        for rate in (500, SRVM_SLOW_RATE):
            if rate != 500:
                slow = torch.tensor([int(res[f"{name}@500"]["slow"])
                                     if mesh.rank == 0 else 0], device=dev)
                if not int(mesh.broadcast(slow, 0)[0]):
                    break
            args = server_mod.build_parser().parse_args(
                ["--requests", str(SRV_REQUESTS), "--rate", str(rate),
                 "--max-batch", "8", "--max-delay-ms", "5", "--top-k",
                 str(SRV_K), "--seed", "0", "--device", "cuda", "--mesh",
                 str(S), "--share-card", *flags])
            seen = {"order": [], "served": [], "serve_comm": [],
                    "bcast": [], "server": None}

            def on_ready(server, name=name, seen=seen):
                submit, serve_batch = server.submit, server.pool.serve
                bcast = server.mesh.broadcast

                def timed_bcast(x, src=0, axis=None):
                    c0 = dict(mesh.comm)
                    out = bcast(x, src, axis)
                    seen["bcast"].append(
                        (int(x["kind"]), {k: mesh.comm[k] - c0[k]
                                          for k in c0}))
                    return out

                def timed_serve(batch, version, *floor):
                    c0 = dict(mesh.comm)
                    out = serve_batch(batch, version, *floor)
                    seen["serve_comm"].append({k: mesh.comm[k] - c0[k]
                                               for k in c0})
                    seen["served"].append(
                        ([r.rid for r in batch.requests], version.version))
                    return out

                def swap_submit(hist):
                    if name == "a" and len(seen["order"]) == SRV_SWAP_AT:
                        live = server.registry.live()
                        server.registry.publish(live.codes, b, perm=perm,
                                                block=False)
                    rid = submit(hist)
                    seen["order"].append(rid)
                    return rid

                server.submit, server.pool.serve = swap_submit, timed_serve
                server.mesh.broadcast = timed_bcast
                seen["server"] = server
                kc.reset_launches()

            snap, wall = server_mod.serve_requests(
                model, model.params(), args, mesh=mesh, on_ready=on_ready)
            row = {"launches": dict(kc.launches), "wall_s": wall}
            if mesh.rank == 0:
                server = seen["server"]
                del mesh.broadcast                 # the class's again
                row.update(
                    snapshot=snap, order=seen["order"],
                    served=seen["served"], serve_comm=seen["serve_comm"],
                    bcast=seen["bcast"], slow=bool(
                        rate == 500 and wall > 1.25 * float(arrivals[-1])),
                    results={rid: (r.values.view(np.int32).copy(),
                                   r.ids.copy(), r.version)
                             for rid, r in server.results.items()})
            else:
                row["followed"] = snap
            res[f"{name}@{rate}"] = row
            del seen
    serve.server.follow = real_follow
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def server_mesh_phases(torch, np, dev, smi, server):
    """Phase 31: ``launch/server.py --mesh S --share-card`` (the CLI's
    per-rank body, ``serve_requests`` under the mesh) at S = 2 and 4,
    phase 25's full-width two-tower-retrieval-jpq and settings (400
    Poisson requests at 500/s, max batch 8, 5 ms): (a) the pruned
    default with a non-blocking hot swap to a popularity-permuted
    catalogue before request 200, (c) ``--no-prune``, each again at
    100/s where S ranks cannot keep up at 500/s.  Every response
    bit-equal (values and ids) to the request served alone through the
    unsharded path (row 0 of an all-pad [8, L] batch); none dropped or
    duplicated; every other rank served rank 0's batches on rank 0's
    versions; the snapshot valid, its config ``...+mesh{S}``; each
    rank launched its path's kernel (the swap's probe taken off).  Then
    both top-k kernels at the shards' shapes at B = 8
    (``shard_kernel_rows``).  ``server``: phase 25's summary.  Returns
    {"runs", "shard_kernels", "launches"}."""
    import shutil
    import tempfile

    from repro_torch import serve
    from repro_torch.configs import get_bundle

    t0 = phase(f"main path: the request server under --mesh S, S = "
               f"{SRVM_SHARDS}, ranks sharing the one card (server --mesh "
               f"S --share-card), two-tower-retrieval-jpq at full width, "
               f"{SRV_REQUESTS} requests")
    free_card(torch, dev, "the mesh server phase")
    root = os.path.join(HERE, "build", "chip_smoke_server_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ranks = {}
    for S in SRVM_SHARDS:
        out_dir = tempfile.mkdtemp(prefix=f"ranks-{S}-", dir=root)
        t1 = time.perf_counter()
        run_ranks(server_mesh_rank, S, (SRVM_RUNS, out_dir), dev,
                  model=S, timeout=600)
        ranks[S] = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                               weights_only=False) for r in range(S)]
        print(f"   S={S}: {S} ranks, {time.perf_counter() - t1:.1f} s "
              f"(the runs, on the pool's ranks)")
    shutil.rmtree(root, ignore_errors=True)
    # the unsharded reference: each request served alone
    model = get_bundle("two-tower-retrieval-jpq").make_model(device=dev,
                                                             seed=0)
    params = model.params()
    hist_len, mb = model.cfg.hist_len, 8
    buckets = sorted({max(1, hist_len // 2), hist_len})
    hists = serve.request_stream(SRV_REQUESTS, n_items=model.cfg.n_items,
                                 max_len=hist_len, seed=0)
    alone = []
    for h in hists:
        L = next((x for x in buckets if h.size <= x), buckets[-1])
        xb = np.zeros((mb, L), np.int32)
        xb[0, :min(h.size, L)] = h[-L:]
        with torch.inference_mode():
            v, i = model.retrieve(params, {"user_hist": xb}, top_k=SRV_K)
        alone.append((v[0].cpu().numpy().view(np.int32),
                      i[0].cpu().numpy()))
    del model, params
    runs, launches = {}, {"jpq_topk": {}, "jpq_topk_pruned": {}}
    for S, rs in ranks.items():
        r0 = rs[0]
        for key in [k for k in r0 if "@" in k]:
            name, rate = key.split("@")
            kern = "jpq_topk" if name == "c" else "jpq_topk_pruned"
            x = r0[key]
            snap = x["snapshot"]
            check(serve.validate_snapshot(snap) == [],
                  f"mesh server S={S} {key}: snapshot invalid")
            check(snap["requests_completed"] == snap["requests_submitted"]
                  == SRV_REQUESTS and snap["requests_dropped"] == 0
                  and snap["requests_duplicated"] == 0,
                  f"mesh server S={S} {key}: completed "
                  f"{snap['requests_completed']}, dropped "
                  f"{snap['requests_dropped']}, duplicated "
                  f"{snap['requests_duplicated']}")
            check(snap["config"].endswith(f"+mesh{S}"),
                  f"mesh server S={S} {key}: config {snap['config']}")
            check(x["order"] == list(range(SRV_REQUESTS)),
                  f"mesh server S={S} {key}: request ids out of order")
            for rid, (vals, ids, _) in x["results"].items():
                check(np.array_equal(vals, alone[rid][0])
                      and np.array_equal(ids, alone[rid][1]),
                      f"mesh server S={S} {key}: request {rid} != the "
                      f"request served alone unsharded")
            log = [(v, tuple(rids)) for rids, v in x["served"]]
            for r in range(1, S):
                check(list(rs[r][key]["followed"]) == log,
                      f"mesh server S={S} {key}: rank {r} served other "
                      f"batches or versions than rank 0")
            versions = sorted({v for v, _ in log})
            if name == "a":
                check(versions == [1, 2] and snap["catalogue_swaps"] == 1,
                      f"mesh server S={S} {key}: versions {versions}, "
                      f"swaps {snap['catalogue_swaps']}")
            per_rank = []
            for r, rr in enumerate(rs):
                got = dict(rr[key]["launches"])
                if name == "a":          # the swap's probe taken off
                    got = {k: v - rr["probe"][k] for k, v in got.items()}
                check(got[kern] > 0, f"mesh server S={S} {key}: rank {r} "
                      f"never launched {kern}")
                per_rank.append(got[kern])
            launches[kern][f"{S}:{key}"] = per_rank
            bc = [c for kind, c in x["bcast"] if kind == serve.server.BATCH]
            lat = snap["latency_ms"]
            row = {"S": S, "rate": int(rate), "config": snap["config"],
                   "latency_ms": lat, "wall_s": x["wall_s"],
                   "batches": snap["batches"],
                   "batch_occupancy": snap["batch_occupancy"],
                   "queue_depth": snap["queue_depth"],
                   "versions": versions, "slow": x["slow"],
                   "phase25_latency_ms": server[name]["latency_ms"],
                   "broadcast_ms": float(np.median([c["seconds"] * 1e3
                                                    for c in bc])),
                   "broadcast_bytes": int(np.median([c["bytes"]
                                                     for c in bc])),
                   "broadcast_calls": int(np.median([c["calls"]
                                                     for c in bc])),
                   "merge_ms": float(np.median([c["seconds"] * 1e3 for c
                                                in x["serve_comm"]])),
                   "merge_bytes": int(np.median([c["bytes"] for c
                                                 in x["serve_comm"]])),
                   "merge_calls": int(np.median([c["calls"] for c
                                                 in x["serve_comm"]])),
                   "launches_by_rank": per_rank,
                   "bit_equal_alone": True}
            runs[f"{S}:{key}"] = row
            p25 = server[name]["latency_ms"]
            print(f"   S={S} ({name}) {snap['config']} at {rate}/s: p50="
                  f"{lat['p50']:.3f} p95={lat['p95']:.3f} p99="
                  f"{lat['p99']:.3f} ms (phase 25, one process: "
                  f"{p25['p50']:.3f} / {p25['p95']:.3f} / {p25['p99']:.3f}),"
                  f" wall {x['wall_s']:.3f} s"
                  + (" (behind the arrivals: run again at "
                     f"{SRVM_SLOW_RATE}/s)" if x["slow"] else "")
                  + f", {snap['batches']} batches, occupancy "
                  f"{snap['batch_occupancy']:.3f}, queue depth mean "
                  f"{snap['queue_depth']['mean']:.2f}; a batch's broadcast "
                  f"{row['broadcast_ms']:.3f} ms, {row['broadcast_bytes']} "
                  f"bytes in {row['broadcast_calls']} calls, its serve's "
                  f"collectives {row['merge_ms']:.3f} ms, "
                  f"{row['merge_bytes']} bytes in {row['merge_calls']} "
                  f"calls (medians); {kern} launches by rank {per_rank}; "
                  f"versions {versions}; every response bit-equal to the "
                  f"request served alone unsharded, every rank on rank 0's "
                  f"batches and versions; on {smi}")
    done(t0)

    t0 = phase("the mesh server's top-k kernels at the shards' shapes, "
               "B = 8 (CUDA events)")
    free_card(torch, dev, "the mesh server's shard-shape kernels")
    shard = shard_kernel_rows(torch, dev, smi, None, Bq=8)
    done(t0)
    return {"runs": runs, "shard_kernels": shard, "launches": launches}


# ---------------------------------------------------------------- phase 32
# the LM family at every published width, depth and batch cut to one
# card: (arch, layers, prefill B, decode B).  The decode batch is the
# largest power of two (at most decode_32k's 128) whose bf16 cache of
# 32,768 positions a layer takes at most 20 GB; mixtral's ring holds its
# 4,096-position window.  Depths cut for the script's time: mixtral 2 of
# 32, the others 4 (olmoe-1b-7b of 16, stablelm-1.6b of 24, qwen3-14b and
# stablelm-12b of 40).
LM_SERVE = (("mixtral-8x7b", 2, 1, 128), ("olmoe-1b-7b", 4, 1, 4),
            ("stablelm-1.6b", 4, 1, 2), ("qwen3-14b", 4, 1, 16),
            ("stablelm-12b", 4, 1, 8))
LM_DECODE_STEPS, LM_LONG_STEPS, LM_WARM_S = 64, 8, 4096
# decode against the full forward at full width, fp32 (arch, layers, S):
# mixtral's S crosses its 4,096-slot ring and is a multiple of q_chunk;
# its 4,608 decode steps run one layer for the script's time (qwen3-14b's
# two hold the stacked caches' layer index)
LM_CHECKS = (("mixtral-8x7b", 1, 4608), ("qwen3-14b", 2, 1024))
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 2, 4096, 3
# phase 33's stablelm-1.6b depth: 4 of 24, cut so that phases 37-38 fit
# the script's time
LM_TRAIN_LAYERS = 4
LM_KERNELS = ("jpq_scores", "jpq_scores_bwd", "jpq_lookup",
              "jpq_lookup_bwd", "embedding_bag_backward")


def lm_model(arch, dev, **changes):
    """The published config of ``arch`` with ``changes`` (a cut depth),
    random fp32 weights from seed 0, on ``dev``."""
    from repro_torch.configs import get_bundle
    return get_bundle(arch).make_model(device=dev, seed=0, **changes)


def cache_bytes(caches):
    return sum(t.numel() * t.element_size() for t in caches.values())


def _timed(torch, fn):
    """(fn's result, ms by the host clock between two synchronises)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def lm_decode_run(torch, model, params, caches, toks, start):
    """Decode ``toks`` [B, n] from position ``start`` (written into every
    layer's ``pos``): one warm-up step, then n - 1 timed ones.  Returns
    (the last logits, ms a timed step)."""
    caches["pos"].fill_(start)
    model.decode_step(params, toks[:, :1], caches)
    n = toks.shape[1] - 1

    def steps():
        lg = None
        for s in range(n):
            lg, _ = model.decode_step(params, toks[:, 1 + s:2 + s], caches)
        return lg
    lg, ms = _timed(torch, steps)
    return lg, ms / n


def lm_serve_phases(torch, np, dev, smi):
    """Phase 32: each LM at every published width (layers and batch cut,
    ``LM_SERVE``), bf16, under ``no_grad``: ``prefill`` at prefill_32k's
    S = 32,768 (after a warm-up at S = 4,096) and 64 ``decode_step``s
    (after one warm-up step) against a bf16 cache of decode_32k's
    32,768 positions, random, ending at position 32,767; ms, tokens/s
    and peak GB of each.  Mixtral then decodes long_500k's last 8
    positions from a ring cache at 524,280, whose bytes equal those of
    a 4,096-position cache.  Then ``lm_decode_check``.  Returns the
    summary."""
    from repro_torch.configs.lm_common import (DECODE_32K, LONG_500K,
                                               PREFILL_32K)
    t0 = phase("phase 32: LM serving at full width (bf16): prefill "
               "S=32,768, 64 decode steps at a 32,768-position cache, "
               "mixtral's long_500k ring")
    gen = torch.Generator(device=dev).manual_seed(32)
    S_pre, S_dec = PREFILL_32K[1], DECODE_32K[1]
    rows = {}
    for arch, depth, Bp, Bd in LM_SERVE:
        model = lm_model(arch, dev, n_layers=depth)
        cfg, params = model.cfg, model.params()
        V = cfg.vocab
        row = {"layers": depth, "prefill_B": Bp, "decode_B": Bd,
               "weights_gb": sum(t.numel() * 4 for t in model.parameters())
               / 1e9}
        with torch.no_grad():
            toks = torch.randint(0, V, (Bp, S_pre), generator=gen,
                                 device=dev)
            model.prefill(params, toks[:, :LM_WARM_S])
            torch.cuda.reset_peak_memory_stats(dev)
            lg, ms = _timed(torch, lambda: model.prefill(params, toks))
            check(tuple(lg.shape) == (Bp, 1, V)
                  and bool(torch.isfinite(lg).all()),
                  f"{arch} prefill logits malformed")
            row.update(prefill_ms=ms, prefill_tokens_per_s=Bp * S_pre / ms
                       * 1e3, prefill_peak_gb=torch.cuda.max_memory_allocated(
                           dev) / 1e9)
            del toks, lg
            caches = model.init_caches(Bd, S_dec)
            for k in ("k", "v"):
                caches[k].normal_(generator=gen)
            toks = torch.randint(0, V, (Bd, 1 + LM_DECODE_STEPS),
                                 generator=gen, device=dev)
            torch.cuda.reset_peak_memory_stats(dev)
            lg, ms = lm_decode_run(torch, model, params, caches, toks,
                                   S_dec - LM_DECODE_STEPS - 1)
            check(caches["pos"].tolist() == [S_dec] * cfg.n_layers
                  and bool(torch.isfinite(lg).all())
                  and tuple(lg.shape) == (Bd, 1, V),
                  f"{arch} decode malformed")
            row.update(cache_slots=caches["k"].shape[2],
                       cache_gb=cache_bytes(caches) / 1e9,
                       decode_ms_per_step=ms,
                       decode_tokens_per_s=Bd / ms * 1e3,
                       decode_peak_gb=torch.cuda.max_memory_allocated(dev)
                       / 1e9)
            # the card's busy time a step (torch.profiler), three more
            # steps (their slots wrap the ring past 32,767)
            busy, top = device_profile(torch, lambda s: model.decode_step(
                params, toks[:, s:s + 1], caches), range(3), top_n=4)
            check(busy > 0, f"the profiler traced no device time for "
                  f"{arch}'s decode")
            row.update(decode_device_ms_per_step=busy,
                       decode_idle_share=max(0.0, 1 - busy / ms),
                       decode_device_top=top)
            del caches, toks, lg
            if cfg.window is not None:         # long_500k: the ring cache
                S_long, B_long = LONG_500K[1], LONG_500K[2]
                caches = model.init_caches(B_long, S_long)
                small = cache_bytes(model.init_caches(B_long, cfg.window))
                check(cache_bytes(caches) == small,
                      f"{arch} long_500k cache {cache_bytes(caches)} B != "
                      f"{small} B at {cfg.window} positions")
                for k in ("k", "v"):
                    caches[k].normal_(generator=gen)
                toks = torch.randint(0, V, (B_long, 1 + LM_LONG_STEPS),
                                     generator=gen, device=dev)
                lg, ms = lm_decode_run(torch, model, params, caches, toks,
                                       S_long - LM_LONG_STEPS - 1)
                check(caches["pos"].tolist() == [S_long] * cfg.n_layers
                      and bool(torch.isfinite(lg).all())
                      and cache_bytes(caches) == small,
                      f"{arch} long_500k decode malformed")
                row["long_500k"] = {"B": B_long, "last_pos": S_long - 1,
                                    "cache_bytes": small,
                                    "decode_ms_per_step": ms}
                del caches, toks, lg
        rows[arch] = row
        long = row.get("long_500k")
        print(f"   {arch} ({depth} layers, {row['weights_gb']:.2f} GB fp32 "
              f"weights): prefill B={Bp} S={S_pre} {row['prefill_ms']:.1f} "
              f"ms ({row['prefill_tokens_per_s']:.0f} tokens/s, peak "
              f"{row['prefill_peak_gb']:.2f} GB); decode B={Bd} over "
              f"{row['cache_slots']} slots ({row['cache_gb']:.2f} GB "
              f"cache) {row['decode_ms_per_step']:.2f} ms a step "
              f"({row['decode_tokens_per_s']:.0f} tokens/s, peak "
              f"{row['decode_peak_gb']:.2f} GB; the card busy "
              f"{row['decode_device_ms_per_step']:.2f} ms of it, idle "
              f"{row['decode_idle_share']:.0%}: "
              + "; ".join(f"{k} {v:.2f}" for k, v in
                          row["decode_device_top"]) + ")"
              + ("" if long is None else
                 f"; long_500k to position {long['last_pos']}: "
                 f"{long['decode_ms_per_step']:.2f} ms a step, cache "
                 f"{long['cache_bytes']} B as at {cfg.window} positions")
              + f" on {smi}")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    done(t0)
    checks = {arch: lm_decode_check(torch, np, dev, smi, arch, depth, S)
              for arch, depth, S in LM_CHECKS}
    return {"serve": rows, "decode_check": checks}


def lm_decode_check(torch, np, dev, smi, arch, depth, S):
    """The reference's test_decode_matches_full_forward at full width:
    ``arch`` at ``depth`` layers in fp32 (``compute_dtype`` float32, fp32
    logits), B = 1: the logits of ``decode_step`` at every position of S
    tokens within 2e-3 + 2e-3 |full| of the full forward's.  A MoE runs
    it at capacity_factor E / top_k, where nothing drops: the forward
    sizes capacity from S tokens and decode from 1.  The drops the
    forward makes at the configured factor are counted beside it."""
    from repro_torch.nn import moe as moe_mod
    t0 = phase(f"phase 32 check: {arch} ({depth} layers, fp32) decode "
               f"against the full forward at S={S}")
    from repro_torch.configs import get_bundle
    moe = get_bundle(arch).config.moe
    changes = {"n_layers": depth, "compute_dtype": "float32",
               "logits_bf16": False}
    if moe is not None:
        changes["moe"] = dataclasses.replace(
            moe, capacity_factor=moe.n_experts / moe.top_k)
    model = lm_model(arch, dev, **changes)
    cfg = model.cfg
    params = model.params()
    gen = torch.Generator(device=dev).manual_seed(33)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=dev)
    out = {"layers": depth, "S": S}
    with torch.no_grad():
        (h, _), fwd_ms = _timed(torch, lambda: model.hidden_states(params,
                                                                   toks))
        full = model.logits(params, h)[0]
        del h
        caches = model.init_caches(1, S, dtype=torch.float32)
        dec = torch.empty_like(full)

        def run():
            for t in range(S):
                dec[t] = model.decode_step(params, toks[:, t:t + 1],
                                           caches)[0][0, 0]
        _, dec_ms = _timed(torch, run)
        err = (dec - full).abs()
        ok = bool((err <= 2e-3 + 2e-3 * full.abs()).all())
        out.update(max_abs_err=float(err.max()), forward_ms=fwd_ms,
                   decode_ms_per_step=dec_ms / S,
                   cache_slots=caches["k"].shape[2])
        check(ok, f"{arch} decode logits outside 2e-3 of the full forward "
              f"(max |err| {out['max_abs_err']:.3e})")
        del dec, full, caches, err
        if moe is not None:
            drops = []
            route = moe_mod.route

            def counting(idx, E, C):
                inv, slot_of = route(idx, E, C)
                drops.append(int((slot_of == E * C).sum()))
                return inv, slot_of
            # the same weights at the configured capacity factor
            model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=moe.capacity_factor))
            moe_mod.route = counting
            try:
                model.hidden_states(params, toks)
            finally:
                moe_mod.route = route
                model.cfg = cfg
            out.update(capacity_factor=cfg.moe.capacity_factor,
                       drops_at_configured=drops,
                       configured_capacity_factor=moe.capacity_factor,
                       assignments_a_layer=S * cfg.moe.top_k)
    print(f"   {arch}: decode at every one of {S} positions within "
          f"2e-3 of the full forward (max |err| {out['max_abs_err']:.3e}); "
          f"forward {fwd_ms:.1f} ms, decode {out['decode_ms_per_step']:.2f}"
          f" ms a step over {out['cache_slots']} slots"
          + ("" if moe is None else
             f"; capacity_factor {out['capacity_factor']:g} (no drop "
             f"possible); at {moe.capacity_factor} the forward drops "
             f"{out['drops_at_configured']} of {S * cfg.moe.top_k} "
             f"assignments"
             f" a layer")
          + f" on {smi}")
    del model, params, toks
    gc.collect()
    torch.cuda.empty_cache()
    done(t0)
    return out


# ---------------------------------------------------------------- phase 33
def lm_train_run(torch, np, model, toks, steps, *, lr=3e-4):
    """Train ``model`` through ``Trainer`` and adamw on the fixed batch
    ``toks`` (targets: the tokens shifted by one), ``steps`` steps, the
    launch counters of the four jpq kernels and the bag kernels zeroed
    just before.  Returns (history losses, ms a step after the first,
    peak GB, launches, the trained params)."""
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tr = Trainer(model, OptConfig(lr=lr),
                 TrainConfig(steps=steps, batch_size=toks.shape[0],
                             log_every=1, eval_every=0),
                 data_fn=lambda s: batch)
    for mod in (ec, lc, sc):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats(toks.device)
    params, hist = tr.run(params=model.params())
    launches = {**ec.launches, **lc.launches, **sc.launches}
    rows = [h for h in hist if "loss" in h]
    return ([h["loss"] for h in rows],
            float(np.median([h["sec"] for h in rows[1:]])) * 1e3,
            torch.cuda.max_memory_allocated(toks.device) / 1e9, launches,
            params)


def lm_step_profile(torch, model, params, toks):
    """The card's busy time of one forward and backward of ``model`` on
    ``toks`` (torch.profiler) and its top device items by time."""
    from repro_torch.nn.module import tree_leaves
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    floats = [x for x in tree_leaves(params) if x.is_floating_point()]

    def step(_):
        loss, _ = model.train_loss(params, batch)
        torch.autograd.grad(loss, floats)
    busy, top = device_profile(torch, step, range(1), top_n=6)
    check(busy > 0, "the profiler traced no device time for the LM step")
    print(f"   one forward + backward: the card busy {busy:.1f} ms: "
          + "; ".join(f"{k} {v:.1f}" for k, v in top))
    return {"busy_ms": busy, "top": top}


def lm_jpq_kernels(torch, dev, smi, model, params, toks, rows=None):
    """The four jpq kernels at the RecJPQ vocabulary's step shape (T =
    B x S positions over N = vocab rows, dk = d / 8): jpq_scores on the
    LUT of the trained model's hidden states and its backward on a random
    [T, N] dS, jpq_lookup and its backward on the tokens and a random
    dout, each held against its plain version as phase 8 holds them,
    then kernel, plain version and bound (CUDA events); and the public
    ``ops.jpq_scores`` against ``ref.jpq_scores_ref`` (bit-equal).
    ``rows``: a rank's shape on a ``"model"`` mesh (phase 37), the
    scores over the first ``rows`` code rows (rank 0's block) and the
    lookup over the tokens' code rows as the rank gathers them (ids 0..T
    - 1).  Returns {kernel: row}."""
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_lookup import ref as lref
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.kernels.jpq_scores import ops as sops
    from repro_torch.kernels.jpq_scores import ref as sref
    gen = torch.Generator(device=dev).manual_seed(34)
    emb = params["tok_emb"]
    codes, cent = emb["codes"], emb["centroids"].detach()
    ids, lcodes = toks.reshape(-1), codes
    if rows is not None:
        lcodes = codes[ids.long()].contiguous()
        ids = torch.arange(ids.numel(), device=dev)
        codes = codes[:rows]
    N, T = codes.shape[0], toks.numel()
    dk = cent.shape[-1]
    what = f"LM vocab T={T} N={N}"
    with torch.no_grad():
        h = model.hidden_states(params, toks)[0].reshape(T, -1)
        P = jpq_mod.partial_scores(emb, h).reshape(T, M, BC).contiguous()
        before = sc.launches["jpq_scores"]
        got = sops.jpq_scores(h, cent, codes)
        check(sc.launches["jpq_scores"] == before + 1,
              "ops.jpq_scores did not launch the jpq_scores kernel")
        check(bits_equal(got, sref.jpq_scores_ref(h, cent, codes)),
              f"ops.jpq_scores != ref.jpq_scores_ref ({what})")
        del got
    torch.cuda.empty_cache()
    dS = torch.randn((T, N), generator=gen, device=dev)
    dout = torch.randn((T, M, dk), generator=gen, device=dev)
    err = {"jpq_scores": scores_fwd_err(P, codes, what)}
    err["jpq_scores_bwd"] = scores_bwd_err(dS, codes, BC, what)[0]
    err["jpq_lookup"], err["jpq_lookup_bwd"] = lookup_errs(
        ids, lcodes, cent, dout, what)
    fns = {"jpq_scores": (lambda: sc.jpq_scores(P, codes),
                          lambda: sref.jpq_scores_lut_ref(P, codes)),
           "jpq_scores_bwd": (lambda: sc.jpq_scores_bwd(dS, codes, BC),
                              lambda: sref.jpq_scores_lut_bwd_ref(dS, codes,
                                                                  BC)),
           "jpq_lookup": (lambda: lc.jpq_lookup(ids, lcodes, cent),
                          lambda: lref.jpq_lookup_ref(ids, lcodes, cent)),
           "jpq_lookup_bwd": (lambda: lc.jpq_lookup_bwd(ids, lcodes, dout,
                                                        BC),
                              lambda: lref.jpq_lookup_bwd_ref(ids, lcodes,
                                                              dout, BC))}
    work = train_kernel_work(T, N, BC, dk)
    out = {}
    for name, (kern, plain) in fns.items():
        b_ms, b_by = bound(*work[name])
        out[name] = {"T": T, "N": N, "dk": dk, "max_abs_err": err[name],
                     "ms": cuda_ms(kern, 10), "plain_ms": cuda_ms(plain, 2),
                     "bound_ms": b_ms, "bound_by": b_by}
        print(f"   {name} at T={T} N={N} dk={dk}: {out[name]['ms']:.4f} ms "
              f"kernel, {out[name]['plain_ms']:.4f} ms plain, bound "
              f"{b_ms:.4f} ms ({b_by}), max |err| {err[name]:.3e} on {smi}")
    del P, dS, dout, h, lcodes
    torch.cuda.empty_cache()
    return out


def lm_train_phases(torch, np, dev, smi):
    """Phase 33: training at full width through ``Trainer`` and adamw,
    bf16.  (a) stablelm-1.6b at ``LM_TRAIN_LAYERS`` of its 24 layers,
    full table, train_4k's
    S = 4,096 at B = 2, 3 steps: step 0's loss near ln(vocab), every
    loss finite, the token gather's backward (the bag backward) launched
    every step and held against its plain version at the step's shape
    (``bag_bwd_row``).  (b) the same with a RecJPQ vocabulary (m 8, b
    256, ``use_kernel=True``; the softmax tied): jpq_scores forward and
    backward and both jpq_lookup kernels launched every step, then held
    at the step's shape (``lm_jpq_kernels``).  (c) olmoe-1b-7b at 2
    layers, B = 1, S = 4,096, 2 steps, twice from the same weights: the
    losses and every parameter bit-identical run to run, the MoE's
    gathers' backward launched; the bag backward at the dispatch
    gather's shape.  Returns the summary and the kernels' rows."""
    from repro_torch.core import EmbeddingConfig
    from repro_torch.nn import moe as moe_mod
    t0 = phase(f"phase 33: LM training at full width (bf16): stablelm-1.6b "
               f"{LM_TRAIN_LAYERS} layers B={LM_TRAIN_B} S={LM_TRAIN_S}, "
               f"full table and "
               f"RecJPQ vocab; olmoe-1b-7b 2 layers, run twice")
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    gen = torch.Generator(device=dev).manual_seed(35)
    out, kernels = {}, {}
    for run, emb in (("a", None),
                     ("b", EmbeddingConfig(0, 0, kind="jpq", m=8, b=256,
                                           use_kernel=True))):
        model = lm_model("stablelm-1.6b", dev, embedding=emb,
                         n_layers=LM_TRAIN_LAYERS)
        V = model.cfg.vocab
        toks = torch.randint(0, V, (LM_TRAIN_B, LM_TRAIN_S + 1),
                             generator=gen, device=dev)
        losses, step_ms, peak, launches, params = lm_train_run(
            torch, np, model, toks, LM_TRAIN_STEPS)
        check(len(losses) == LM_TRAIN_STEPS and all(np.isfinite(losses)),
              f"({run}) losses not finite: {losses}")
        check(abs(losses[0] - np.log(V)) < 1.0,
              f"({run}) step 0's loss {losses[0]} is not near ln({V}) = "
              f"{np.log(V):.3f}")
        want = (("embedding_bag_backward",) if run == "a" else
                ("jpq_scores", "jpq_lookup", "jpq_lookup_bwd"))
        for name in want:
            check(launches[name] == LM_TRAIN_STEPS,
                  f"({run}) {name} launched {launches[name]} times in "
                  f"{LM_TRAIN_STEPS} steps")
        if run == "b":
            check(launches["jpq_scores_bwd"] >= LM_TRAIN_STEPS,
                  f"(b) jpq_scores_bwd launched {launches['jpq_scores_bwd']}"
                  f" times")
        out[run] = {"losses": losses, "median_step_ms": step_ms,
                    "peak_gb": peak, "launches": launches,
                    "params_b": sum(t.numel() for t in model.parameters())
                    / 1e9}
        print(f"   ({run}) {'full table' if run == 'a' else 'RecJPQ vocab'}"
              f": losses {' '.join(f'{v:.4f}' for v in losses)} (ln V = "
              f"{np.log(V):.4f}); step {step_ms:.1f} ms, peak {peak:.2f} "
              f"GB, launches {launches} on {smi}")
        if run == "a":
            out[run]["step_device"] = lm_step_profile(torch, model, params,
                                                      toks)
            ids = toks[:, :-1].reshape(-1, 1).contiguous()
            dout = torch.randn((ids.shape[0], model.cfg.d_model),
                               generator=gen, device=dev)
            row = bag_bwd_row(torch, ids, None, dout, V, 10,
                              "LM token gather (stablelm-1.6b)", smi,
                              clock_hz, gather=True)
            kernels["embedding_bag_backward"] = {"token_gather": row}
            del ids, dout
        else:
            kernels.update(lm_jpq_kernels(
                torch, dev, smi, model, params, toks[:, :-1]))
        del model, params, toks
        gc.collect()
        torch.cuda.empty_cache()

    # (c) MoE, run twice
    runs, toks = [], None
    for _ in range(2):
        model = lm_model("olmoe-1b-7b", dev, n_layers=2)
        if toks is None:
            toks = torch.randint(0, model.cfg.vocab, (1, LM_TRAIN_S + 1),
                                 generator=gen, device=dev)
        losses, step_ms, peak, launches, params = lm_train_run(
            torch, np, model, toks, 2)
        runs.append((losses, state_digest(torch, [params]), step_ms, peak,
                     launches))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    (l1, d1, ms1, pk1, n1), (l2, d2, ms2, _, _) = runs
    check(all(np.isfinite(l1)), f"(c) losses not finite: {l1}")
    check(l1 == l2 and d1 == d2, f"(c) the MoE runs differ: losses {l1} vs "
          f"{l2}, parameters {d1} vs {d2}")
    # a step: the token gather, and per layer the dispatch gather and
    # top_k combine gathers
    per_step = 1 + 2 * (1 + 8)
    check(n1["embedding_bag_backward"] == 2 * per_step,
          f"(c) the bag backward launched {n1['embedding_bag_backward']} "
          f"times in 2 steps, not {2 * per_step}")
    out["c"] = {"losses": l1, "step_ms": [ms1, ms2], "peak_gb": pk1,
                "launches": n1, "digest": d1, "bit_identical": True}
    print(f"   (c) olmoe-1b-7b 2 layers: losses {l1} twice, parameters "
          f"bit-identical ({d1[:12]}); step {ms1:.1f} / {ms2:.1f} ms, peak "
          f"{pk1:.2f} GB, launches {n1} on {smi}")
    # the dispatch gather's backward at its shape: inv over E*C slots
    # (unfilled slots all name the pad row: one long run)
    from repro_torch.configs.olmoe_1b_7b import FULL as OLMOE
    x = torch.randn((LM_TRAIN_S, OLMOE.d_model), generator=gen, device=dev)
    router = 0.02 * torch.randn((OLMOE.d_model, OLMOE.moe.n_experts),
                                generator=gen, device=dev)
    _, idx = moe_mod.top_k(torch.softmax(x @ router, -1), OLMOE.moe.top_k)
    C = moe_mod.capacity(OLMOE.moe, LM_TRAIN_S)
    inv, _ = moe_mod.route(idx, OLMOE.moe.n_experts, C)
    ids = inv.reshape(-1, 1).contiguous()
    dout = torch.randn((ids.shape[0], OLMOE.d_model), generator=gen,
                       device=dev)
    kernels["embedding_bag_backward"]["moe_dispatch"] = bag_bwd_row(
        torch, ids, None, dout, LM_TRAIN_S + 1, 10,
        "olmoe dispatch gather", smi, clock_hz, gather=True)
    del x, router, idx, inv, ids, dout, toks
    torch.cuda.empty_cache()
    done(t0)
    return out, kernels


# ---------------------------------------------------------------- phase 34
def lm_cli_phase(torch, np, dev, smi):
    """Phase 34: ``launch/train.py --arch A --steps 2`` for each LM arch
    on the card, as the reference's CLI runs them (the smoke config, its
    fixed batch): finite losses, and the bag backward launched (the token
    gather; the MoE's gathers)."""
    from repro_torch.configs.registry import LM_ARCHS
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.launch import train as train_cli
    t0 = phase("phase 34: launch/train.py --arch A --steps 2 for each LM "
               "arch on the card")
    rows = {}
    for arch in LM_ARCHS:
        ec.reset_launches()
        hist = train_cli.main(["--arch", arch, "--steps", "2"])
        losses = [h["loss"] for h in hist if "loss" in h]
        n = ec.launches["embedding_bag_backward"]
        check(len(losses) == 2 and all(np.isfinite(losses)) and n > 0,
              f"{arch}: losses {losses}, bag backward launches {n}")
        rows[arch] = {"losses": losses, "bag_backward_launches": n}
        print(f"   {arch}: losses {losses}, bag backward launched {n} times")
    done(t0)
    return rows


# ---------------------------------------------------------------- phase 35
# MACE at its published width on one card: the shapes it runs
# (ogb_products needs more cards than a run has), the serve calls and
# training steps a shape, and the tolerance of its energies against the CPU and
# under a rotation or a shift (fp32, of the largest energy)
MACE_SHAPES = ("molecule", "full_graph_sm", "minibatch_lg")
MACE_SERVE_CALLS, MACE_STEPS = 20, 4
MACE_TOL = 1e-4


def mace_model(shape, dev):
    """``configs/mace_arch``'s published config of ``shape``, random fp32
    weights from seed 0, on ``dev``."""
    from repro_torch.configs import get_bundle
    return get_bundle("mace").make_model(device=dev, seed=0, shape=shape)


def mace_launches(cfg):
    """(the bag backward's launches in one forward, in one backward) of a
    ``MACEConfig``: a sum over receivers a path whose l1 the layer holds
    (layer 1 holds l = 0 alone), the energy head's sum over graphs; a
    sender gather's backward an l1 a layer."""
    from repro_torch.models.equivariant import product_paths
    paths = product_paths(cfg.lmax)
    sums = sum(1 for p in paths if p[0] == 0) \
        + (cfg.n_layers - 1) * len(paths) + (cfg.head == "energy")
    return sums, 1 + (cfg.n_layers - 1) * (cfg.lmax + 1)


def mace_on_cpu(torch, model, shape, batch):
    """``model``'s serve on the CPU (the plain versions), from its
    weights."""
    from repro_torch import bridge
    from repro_torch.train.optimizer import tree_map
    cpu = mace_model(shape, "cpu")
    bridge.load_values(cpu, tree_map(lambda t: t.detach().cpu().numpy(),
                                     model.params()))
    with torch.inference_mode():
        return cpu.serve(cpu.params(), batch)


def mace_serve_phases(torch, np, dev, smi, batches):
    """Phase 35: ``MACE.serve`` at full width on each shape (see the
    module docstring).  Returns {shape: row, "cli": ...}."""
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag import ref as eref
    from repro_torch.launch import serve as serve_mod
    t0 = phase("phase 35: MACE serving at full width (C = 128): "
               + ", ".join(MACE_SHAPES))
    gen = torch.Generator(device=dev).manual_seed(35)
    out = {}
    for shape in MACE_SHAPES:
        model = mace_model(shape, dev)
        params, cfg = model.params(), model.cfg
        host = {k: v for k, v in batches[shape].items() if k != "labels"}
        batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        N, E = host["positions"].shape[0], host["senders"].shape[0]
        sums, _ = mace_launches(cfg)

        def call(_=None, batch=batch):
            return model.serve(params, batch)

        with torch.inference_mode():
            got = call()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ec.reset_launches()
            lat = []
            for _ in range(MACE_SERVE_CALLS):
                t = time.perf_counter()
                got = call()
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t) * 1e3)
            launches = ec.launches["embedding_bag_backward"]
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            busy, top = device_profile(torch, call, range(3), top_n=4)
        check(busy > 0, f"the profiler traced no device time ({shape})")
        check(launches == sums * MACE_SERVE_CALLS,
              f"{shape}: the bag backward launched {launches} times in "
              f"{MACE_SERVE_CALLS} calls, not {sums} a call")
        want = ((cfg.n_graphs,) if cfg.head == "energy"
                else (N, cfg.n_classes))
        check(tuple(got.shape) == want and bool(torch.isfinite(got).all()),
              f"{shape}: output {tuple(got.shape)} (want {want}) or not "
              f"finite")
        ms = float(np.median(lat))
        row = {"nodes": N, "edges": E, "d_feat": cfg.d_feat,
               "head": cfg.head, "median_ms": ms,
               "p99_ms": float(np.percentile(lat, 99)), "peak_gb": peak,
               "busy_ms": busy, "busy_share": busy / ms, "top": top,
               "sums_per_call": sums}
        # the segment sum with the batch's order at [E, C(2l+1)], against
        # its plain version on CPU copies, bit for bit
        recv = batch["receivers"]
        order = eops.segment_order(recv, N)
        for l in range(cfg.lmax + 1):
            data = torch.randn((E, cfg.channels * (2 * l + 1)),
                               generator=gen, device=dev)
            kern = eops.segment_sum(data, recv, N, order)
            plain = eref.embedding_bag_backward_ref(
                recv.cpu().long()[:, None], None, data.cpu(), N)
            check(bits_equal(kern.cpu(), plain),
                  f"{shape}: segment_sum != plain at [{E}, "
                  f"{data.shape[1]}]")
        del order, data, kern, plain
        extra = ""
        if shape == "molecule":
            # the card against the CPU, and invariance under a proper
            # rotation and a shift of the positions
            scale = float(got.abs().max())
            cpu_err = float((got.cpu() - mace_on_cpu(torch, model, shape,
                                                     host)).abs().max())
            rng = np.random.default_rng(35)
            Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            if np.linalg.det(Q) < 0:
                Q[:, 0] *= -1
            pos = host["positions"]
            with torch.inference_mode():
                rot = model.serve(params, dict(batch, positions=torch.as_tensor(
                    pos @ Q.T.astype(np.float32), device=dev)))
                shift = model.serve(params, dict(batch, positions=torch.as_tensor(
                    pos + np.array([5.0, -2.0, 1.0], np.float32), device=dev)))
            rot_err = float((rot - got).abs().max())
            shift_err = float((shift - got).abs().max())
            for what, err in (("the CPU", cpu_err), ("a rotation", rot_err),
                              ("a shift", shift_err)):
                check(err <= MACE_TOL * scale,
                      f"molecule energies against {what}: max |err| {err} "
                      f"> {MACE_TOL} x {scale}")
            row.update(largest_energy=scale, cpu_max_abs_err=cpu_err,
                       rotation_max_abs_err=rot_err,
                       shift_max_abs_err=shift_err)
            extra = (f"; energies vs the CPU {cpu_err:.2e}, rotated "
                     f"{rot_err:.2e}, shifted {shift_err:.2e} (largest "
                     f"{scale:.3f})")
        out[shape] = row
        print(f"   {shape} (N={N}, E={E}, F={cfg.d_feat}): serve median "
              f"{ms:.2f} ms (p99 {row['p99_ms']:.2f}), peak {peak:.2f} GB, "
              f"busy {busy:.2f} ms ({100 * busy / ms:.0f}%; "
              + "; ".join(f"{k} {v:.2f}" for k, v in top)
              + f"), bag backward {sums} a call; segment_sum bit-equal "
              f"to plain at l = 0..{cfg.lmax}{extra} on {smi}")
        del model, params, batch, got
        gc.collect()
        torch.cuda.empty_cache()
    ec.reset_launches()
    res = serve_mod.main(["--arch", "mace", "--requests", "5"])
    n = ec.launches["embedding_bag_backward"]
    check(res["path"] == "serve" and n == 15 * 6,
          f"serve CLI: path {res['path']}, bag backward launches {n}, not "
          f"15 in each of 6 calls")
    out["cli"] = {"p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
                  "launches": n}
    done(t0)
    return out


# ---------------------------------------------------------------- phase 36
def _digest_steps(Trainer, torch):
    """A Trainer whose plain step records the digest of the parameters
    and both moments after each step."""
    class Digest(Trainer):
        def _build_step(self):
            step = super()._build_step()
            self.digests = []

            def stepped(values, opt, batch, rng=None):
                nv, no, mets = step(values, opt, batch, rng)
                self.digests.append(state_digest(torch, [nv, no["m"],
                                                         no["v"]]))
                return nv, no, mets
            return stepped
    return Digest


def mace_train_run(torch, np, model, batch, steps):
    """``steps`` Trainer steps (adamw, lr 1e-3) of ``model`` on the fixed
    device ``batch``, the bag kernels' counters and the peak reset just
    before.  Returns (losses, median ms a step after the first, peak GB,
    bag backward launches, digests after each step)."""
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig
    tr = _digest_steps(Trainer, torch)(
        model, OptConfig(lr=1e-3),
        TrainConfig(steps=steps, log_every=1, eval_every=0),
        data_fn=lambda s: batch)
    ec.reset_launches()
    torch.cuda.reset_peak_memory_stats(model.device)
    _, hist = tr.run(params=model.params())
    rows = [h for h in hist if "loss" in h]
    return ([h["loss"] for h in rows],
            float(np.median([h["sec"] for h in rows[1:]])) * 1e3,
            torch.cuda.max_memory_allocated(model.device) / 1e9,
            ec.launches["embedding_bag_backward"], tr.digests)


def mace_train_phases(torch, np, dev, smi, batches):
    """Phase 36: training at full width (see the module docstring).
    Returns (summary, the bag backward's rows at minibatch_lg)."""
    from repro_torch.configs.mace_arch import SMOKE, model_cfg
    from repro_torch.examples import train_mace_molecule
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.launch import train as train_cli
    from repro_torch.nn.module import tree_leaves
    t0 = phase(f"phase 36: MACE training at full width (C = 128), "
               f"{MACE_STEPS} adamw steps a shape; minibatch_lg twice")
    out = {}
    for shape in MACE_SHAPES:
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batches[shape].items()}
        runs = []
        for _ in range(2 if shape == "minibatch_lg" else 1):
            model = mace_model(shape, dev)
            runs.append(mace_train_run(torch, np, model, batch, MACE_STEPS))
            if len(runs) == 1:
                params = model.params()
                floats = tree_leaves(params)

                def step(_):
                    loss, _ = model.train_loss(params, batch)
                    torch.autograd.grad(loss, floats, allow_unused=True)
                busy, top = device_profile(torch, step, range(1), top_n=5)
                check(busy > 0, f"the profiler traced no device time "
                      f"({shape} step)")
                del params, floats
            del model
            gc.collect()
            torch.cuda.empty_cache()
        losses, ms, peak, launches, digests = runs[0]
        sums, gathers = mace_launches(model_cfg(shape))
        check(len(losses) == MACE_STEPS and all(np.isfinite(losses)),
              f"{shape}: losses {losses}")
        check(launches == MACE_STEPS * (sums + gathers),
              f"{shape}: the bag backward launched {launches} times in "
              f"{MACE_STEPS} steps, not {sums} + {gathers} a step")
        row = {"losses": losses, "median_step_ms": ms, "peak_gb": peak,
               "busy_ms": busy, "busy_share": busy / ms, "top": top,
               "launches_per_step": {"segment_sum": sums,
                                     "gather_backward": gathers}}
        if len(runs) == 2:
            l2, ms2, _, _, d2 = runs[1]
            check(losses == l2 and digests == d2 and len(digests)
                  == MACE_STEPS,
                  f"{shape}: the two runs differ: losses {losses} vs {l2}")
            row.update(bit_identical=True, step_ms_run2=ms2,
                       digest=digests[-1])
        out[shape] = row
        print(f"   {shape}: losses {' '.join(f'{v:.4f}' for v in losses)}; "
              f"step {ms:.1f} ms, peak {peak:.2f} GB, one step busy "
              f"{busy:.1f} ms ({100 * busy / ms:.0f}%; "
              + "; ".join(f"{k} {v:.2f}" for k, v in top)
              + f"); bag backward {sums} + {gathers} a step"
              + (f"; run twice, every parameter and moment bit-identical "
                 f"after every step ({digests[-1][:12]}; step "
                 f"{row['step_ms_run2']:.1f} ms)" if len(runs) == 2 else "")
              + f" on {smi}")
        del batch
        gc.collect()
        torch.cuda.empty_cache()

    # the two kernels' calls at minibatch_lg's [E, C x 5]
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    host = batches["minibatch_lg"]
    N = host["positions"].shape[0]
    recv = torch.as_tensor(host["receivers"], device=dev).long()
    send = torch.as_tensor(host["senders"], device=dev).long()
    gen = torch.Generator(device=dev).manual_seed(36)
    dout = torch.randn((recv.shape[0], 128 * 5), generator=gen, device=dev)
    kernels = {
        "segment_sum": bag_bwd_row(
            torch, recv[:, None].contiguous(), None, dout, N, 10,
            "MACE sum over receivers (minibatch_lg, l = 2)", smi, clock_hz),
        "gather_backward": bag_bwd_row(
            torch, send[:, None].contiguous(), None, dout, N, 10,
            "MACE sender gather's backward (minibatch_lg, l = 2)", smi,
            clock_hz, gather=True),
        "launches_per_step": out["minibatch_lg"]["launches_per_step"]}
    del recv, send, dout
    torch.cuda.empty_cache()

    # the smoke config and the example's: 2 layers, lmax 2, the energy
    # head, so the same launches a call and a step
    sums, gathers = mace_launches(SMOKE)
    ec.reset_launches()
    hist = train_cli.main(["--arch", "mace", "--steps", "2"])
    losses = [h["loss"] for h in hist if "loss" in h]
    n = ec.launches["embedding_bag_backward"]
    check(len(losses) == 2 and all(np.isfinite(losses))
          and n == 2 * (sums + gathers),
          f"train CLI: losses {losses}, bag backward launches {n}")
    ec.reset_launches()
    ex = train_mace_molecule.main(["--steps", "5"])
    n_ex = ec.launches["embedding_bag_backward"]
    # 5 steps, then the invariance check's two serve calls
    check(all(np.isfinite(ex["losses"])) and ex["rotation_rel_err"] < 1e-3
          and n_ex == 5 * (sums + gathers) + 2 * sums,
          f"example: {ex}, launches {n_ex}")
    out["cli"] = {"losses": losses, "launches": n}
    out["example"] = {**ex, "launches": n_ex}
    print(f"   launch/train.py --arch mace --steps 2: losses {losses}, bag "
          f"backward {n}; the example: losses {ex['losses'][0]:.4f} -> "
          f"{ex['losses'][-1]:.4f}, rotation rel err "
          f"{ex['rotation_rel_err']:.2e}, bag backward {n_ex}")
    done(t0)
    return out, kernels


# ---------------------------------------------------------------- phase 37
# the LMs on a (data, model) mesh at full width, the ranks time-sharing
# the one card (gloo staged through host memory, as ``launch/train.py
# --model-axis S --share-card`` runs them).  Every block's activations
# cross the ranks several times a step (two forward sums, two again under
# remat, two backward), so the depth is cut, never the width.  Jobs:
# (name, arch, layers, batch rows, steps); (b) a RecJPQ vocabulary, (d)
# fp32 throughout (logits too), (e) the MoE on the model group alone (one
# routing group, as one card routes it), (c) run twice on four ranks.
LM_MESH_S, LM_MESH_DECODE, LM_MESH_DECODE_B = 4096, 16, 2
LM_MESH_TRAIN = (
    dict(kind="train", name="a", arch="stablelm-1.6b", layers=2, batch=2,
         steps=3),
    dict(kind="train", name="b", arch="stablelm-1.6b", layers=2, batch=2,
         steps=3, jpq=True),
    dict(kind="train", name="d", arch="stablelm-1.6b", layers=2, batch=2,
         steps=2, changes={"compute_dtype": "float32",
                           "logits_bf16": False}),
    dict(kind="train", name="e", arch="olmoe-1b-7b", layers=2, batch=2,
         steps=2))
LM_MESH_MOE = dict(kind="train", name="c", arch="olmoe-1b-7b", layers=2,
                   batch=2, steps=2, runs=2)
# phase 38: prefill and decode at (1, 2), bf16 (the full configs) and
# fp32 throughout (logits and caches too)
LM_MESH_SERVE = tuple(
    dict(kind="serve", name=f"serve-{arch}-{dt}", arch=arch, layers=n,
         dtype=dt, changes={} if dt == "bf16" else {
             "compute_dtype": "float32", "logits_bf16": False})
    for arch, n in (("stablelm-1.6b", 2), ("olmoe-1b-7b", 2))
    for dt in ("bf16", "fp32"))
# relative gaps of the (1, 2) jobs' losses from one card's Trainer on
# the same weights and batch: (step 0, step 1, after one adamw step on
# the mesh's summed gradients), about 10x the largest measured on an
# H100 80GB HBM3 (bf16 step 0 1.10e-5, step 1 2.96e-5; fp32 0).  A wrong
# forward moves step 0 by about 1e-3 at random init (ln_f normalises).
# fp32 serving: of the largest (measured 3.3e-6).  bf16 serving is held to bf16's own error: its distance from
# one card's fp32 outputs within LM_MESH_BF16 times one card's bf16's
LM_MESH_TOL = {"a": (1e-4, 3e-4), "b": (1e-4, 3e-4), "d": (1e-5, 1e-5),
               "e": (1e-4, 3e-4), "serve": 1e-4}
LM_MESH_REF_STEPS = 2          # one card's Trainer steps a (1, 2) job
LM_MESH_BF16 = 2.0
LM_SERVE_OUTS = ("prefill", "decode", "cache")


def lm_mesh_model(job, dev):
    """The published config of a phase 37-38 job at its cut depth,
    random fp32 weights from seed 0 (the same bits in every process on
    the card)."""
    from repro_torch.core import EmbeddingConfig
    changes = dict(job.get("changes", {}))
    if job.get("jpq"):
        changes["embedding"] = EmbeddingConfig(0, 0, kind="jpq", m=M, b=BC,
                                               use_kernel=True)
    return lm_model(job["arch"], dev, n_layers=job["layers"], **changes)


def lm_mesh_tokens(torch, dev, V, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, V, shape, generator=gen, device=dev)


def lm_mesh_batch(torch, dev, job, V):
    """A training job's fixed batch: B x S tokens, the targets shifted
    by one."""
    toks = lm_mesh_tokens(torch, dev, V, (job["batch"], LM_MESH_S + 1), 37)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def lm_mesh_train(torch, mesh, job, dev=None, steps=None):
    """A phase 37 job on this rank, ``runs`` times: the model from seed 0
    (the peak counter zeroed before it is built, so the whole model's
    init counts) trained through ``Trainer`` on ``mesh`` (None: one card,
    ``dev``) for ``steps`` (default the job's) steps of the fixed batch,
    the launch counters and ``HostMesh.comm`` read around the run.
    Returns a summary a run: losses, step ms, peak GB, launches, the
    collectives, and the digest of this rank's blocks."""
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.jpq_lookup import cuda as lc
    from repro_torch.kernels.jpq_scores import cuda as sc
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import OptConfig
    dev = mesh.device if mesh is not None else dev
    steps = steps or job["steps"]
    out = []
    for _ in range(job.get("runs", 1)):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        model = lm_mesh_model(job, dev)
        batch = lm_mesh_batch(torch, dev, job, model.cfg.vocab)
        tr = Trainer(model, OptConfig(lr=3e-4), TrainConfig(
            steps=steps, batch_size=job["batch"], log_every=1,
            eval_every=0), data_fn=lambda s, b=batch: b, mesh=mesh)
        for mod in (ec, lc, sc):
            mod.reset_launches()
        comm0 = {} if mesh is None else dict(mesh.comm)
        params, hist = tr.run(params=model.params())
        torch.cuda.synchronize(dev)
        rows = [h for h in hist if "loss" in h]
        out.append({
            "losses": [h["loss"] for h in rows],
            "step_ms": [h["sec"] * 1e3 for h in rows],
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": {**ec.launches, **lc.launches, **sc.launches},
            "comm": {k: mesh.comm[k] - comm0[k] for k in comm0},
            "digest": state_digest(torch, [params])})
        del tr, params, model, batch, hist
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lm_serve_run(torch, model, params, dev, mesh=None):
    """Phase 38's serving of ``model`` under ``no_grad``, on ``mesh``'s
    ranks (None: one card): ``prefill`` of 4,096 tokens at B = 1 (after
    a warm-up of 512), then 16 ``decode_step``s at B = 2 after a random
    cache of 4,096 positions in the compute dtype (seed 39, drawn whole;
    a rank keeps the block of kv heads its ``init_caches`` holds).
    Returns (prefill's logits, each step's logits, the cache slots the
    steps wrote, prefill ms, ms a decode step after the first)."""
    from repro_torch import dist
    V, S, n = model.cfg.vocab, LM_MESH_S, LM_MESH_DECODE
    toks = lm_mesh_tokens(torch, dev, V, (1, S), 38)
    dec = lm_mesh_tokens(torch, dev, V, (LM_MESH_DECODE_B, n), 40)
    ctx = (contextlib.nullcontext() if mesh is None else
           dist.use_mesh_rules(mesh))
    with ctx, torch.no_grad():
        model.prefill(params, toks[:, :512])
        pre, pre_ms = _timed(torch, lambda: model.prefill(params, toks))
        caches = model.init_caches(LM_MESH_DECODE_B, S + n,
                                   dtype=model.dtype)
        L, B, _, hkv, dh = caches["k"].shape
        H = model.cfg.n_kv
        lo = 0 if hkv == H else mesh.model_index * hkv
        gen = torch.Generator(device=dev).manual_seed(39)
        for name in ("k", "v"):
            whole = torch.randn((L, B, S, H, dh), generator=gen,
                                device=dev).to(model.dtype)
            caches[name][:, :, :S].copy_(whole[..., lo:lo + hkv, :])
            del whole
        caches["pos"].fill_(S)
        steps = [model.decode_step(params, dec[:, :1], caches)[0]]

        def rest():
            for i in range(1, n):
                steps.append(model.decode_step(params, dec[:, i:i + 1],
                                               caches)[0])
        _, ms = _timed(torch, rest)
        new = {k: caches[k][:, :, S:].clone() for k in ("k", "v")}
    del caches
    return pre, steps, new, pre_ms, ms / (n - 1)


def lm_serve_err(torch, outs, ref, kv=None):
    """{output: |err| over the largest |ref|} of ``lm_serve_run``'s
    outputs (prefill, the decode steps, the cache slots written) against
    a saved ``ref``; ``kv``: the (first, count) of the kv heads held."""
    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / float(
            b.float().abs().max())
    pre, steps, new = outs
    lo, n = kv or (0, new["k"].shape[3])
    return {"prefill": rel(pre, ref["prefill"]),
            "decode": max(rel(a, b) for a, b in zip(steps, ref["steps"])),
            "cache": max(rel(new[k], ref[k][..., lo:lo + n, :])
                         for k in ("k", "v"))}


def lm_mesh_serve(torch, mesh, job, ref_dir):
    """A phase 38 job on this rank: the model cut to its blocks, served
    as ``lm_serve_run`` serves it, each output against one card's in the
    same dtype (and a bf16 job's also against one card's fp32 outputs),
    as ``lm_serve_err`` measures them."""
    from repro_torch import bridge
    dev = mesh.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = lm_mesh_model(job, dev)
    bridge.keep_local_blocks(model, mesh)
    comm0 = dict(mesh.comm)
    pre, steps, new, pre_ms, step_ms = lm_serve_run(
        torch, model, model.params(), dev, mesh)
    hkv = new["k"].shape[3]
    kv = (0 if hkv == model.cfg.n_kv else mesh.model_index * hkv, hkv)
    out = {"kv_heads_held": hkv, "prefill_ms": pre_ms,
           "decode_step_ms": step_ms,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "comm": {k: mesh.comm[k] - comm0[k] for k in comm0}}
    for dt in dict.fromkeys((job["dtype"], "fp32")):
        ref = torch.load(os.path.join(
            ref_dir, f"serve-{job['arch']}-{dt}.pt"), map_location=dev)
        out["err" if dt == job["dtype"] else "err_fp32"] = lm_serve_err(
            torch, (pre, steps, new), ref, kv)
        del ref
    del model, pre, steps, new
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_mesh_rank(mesh, jobs, ref_dir, out_dir):
    """One rank of phases 37-38 (module-level: it is pickled): each
    job in turn, a barrier after each; writes ``out_dir/rank<r>.pt``."""
    import torch

    from repro_torch import fp32_matmuls
    fp32_matmuls()
    res = {"rank": mesh.rank, "transport": mesh.transport}
    for job in jobs:
        if job["kind"] == "train":
            res[job["name"]] = lm_mesh_train(torch, mesh, job)
        else:
            res[job["name"]] = lm_mesh_serve(torch, mesh, job, ref_dir)
        mesh.all_reduce(torch.zeros(1, device=mesh.device),
                        ("data", "model"))
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def live_cuda_tensors(torch):
    """[(bytes, shape, dtype)] of the CUDA tensors this process still
    reaches, one a storage, the largest first."""
    seen = {}
    for o in gc.get_objects():
        try:
            if not (torch.is_tensor(o) and o.is_cuda):
                continue
            st = o.untyped_storage()
            seen.setdefault(st.data_ptr(), (st.nbytes(), tuple(o.shape),
                                            str(o.dtype)))
        except (ReferenceError, RuntimeError):
            continue
    return sorted(seen.values(), reverse=True)


def lm_block_gather_row(torch, dev, smi, ids, V, S, d):
    """The token gather's backward on the last rank's block of a
    ``V``-row vocabulary split ``S`` ways (phase 37 (a)'s shape): ids
    [T] at this block's rows or the sentinel, ``cuda.block_backward``
    bit-identical across two calls, bit-equal to its plain version on
    CPU copies and to the same rows of the whole table's gather
    backward; then kernel, plain version, ``F.embedding``'s backward and
    bound (CUDA events).  Returns the row."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ref as eref
    gen = torch.Generator(device=dev).manual_seed(41)
    nb = V // S
    lo = (S - 1) * nb
    flat = ids.reshape(-1)
    T = flat.numel()
    loc = flat - lo
    own = (loc >= 0) & (loc < nb)
    marked = torch.where(own, loc, nb).reshape(-1, 1).contiguous()
    dout = torch.randn((T, d), generator=gen, device=dev)
    what = f"LM token gather, vocab block {nb} of {V}"
    g = ec.block_backward(marked, None, dout, nb)
    check(bits_equal(g, ec.block_backward(marked, None, dout, nb)),
          f"the block backward differs between calls ({what})")
    check(bits_equal(g.cpu(), eref.block_backward_ref(
        marked.cpu(), None, dout.cpu(), nb)),
          f"the block backward != plain on the CPU ({what})")
    check(bits_equal(g, ec.gather_backward(flat, dout, V)[lo:].contiguous()),
          f"the block backward != the whole table's rows ({what})")
    safe = torch.where(own, loc, 0)
    leaf = torch.randn((nb, d), generator=gen, device=dev,
                       requires_grad=True)
    # ids read, this block's rows of dout read (foreign slots are
    # skipped), the block's gradient written
    n_own = int(own.sum())
    b_ms, b_by = bound(T * 8 + n_own * d * 4 + nb * d * 4,
                       {"fp32 adds": (n_own * d, FADD_PER_S)})
    row = {"V": nb, "d": d, "slots": T, "own_slots": n_own,
           "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: ec.block_backward(marked, None, dout, nb),
                         10),
           "plain_ms": cuda_ms(lambda: eref.block_backward_ref(
               marked, None, dout, nb), 3),
           "library_ms": cuda_ms(lambda: torch.autograd.grad(
               F.embedding(safe, leaf), leaf, dout), 10),
           "library": "F.embedding's backward", "bound_ms": b_ms,
           "bound_by": b_by}
    print(f"   {what} (d={d}, {T} slots, {row['own_slots']} own): "
          f"{row['ms']:.4f} ms kernel, {row['plain_ms']:.4f} ms plain, "
          f"{row['library_ms']:.4f} ms {row['library']}, bound "
          f"{b_ms:.4f} ms ({b_by}); bit-equal to plain and to the whole "
          f"rows, on {smi}")
    del g, dout, marked, loc, own, safe, leaf
    torch.cuda.empty_cache()
    return row


def lm_mesh_phases(torch, np, dev, smi):
    """Phases 37-38: the LMs on a ``(data, model)`` mesh at full width,
    ranks time-sharing the one card (a ``RankPool``, gloo staged).
    First one card's ``Trainer`` losses (2 steps) of
    the (1, 2) training jobs and its serving outputs in bf16 and fp32
    (saved under ``build/chip_smoke_lm_mesh``, removed after); then (1,
    2) runs (a) stablelm-1.6b at 2 layers, full table, B = 2, S = 4,096,
    3 steps, (b) the same with a RecJPQ vocabulary, (d) 2 layers in
    fp32, 2 steps, (e) olmoe-1b-7b at 2 layers, 2 steps, and phase 38's
    prefill and decode of stablelm-1.6b and olmoe-1b-7b (2 layers each),
    bf16 and fp32; then (2, 2) runs (c) olmoe-1b-7b at 2 layers, B = 2,
    2 steps, twice.  Checks: losses finite, steps 0 and 1 within
    ``LM_MESH_TOL`` of one card's, the kernels launched on every rank
    every step, (c) bit-identical run to run on every rank, fp32 serving
    within 1e-4 of one card's and bf16 serving within ``LM_MESH_BF16``
    times one card's bf16 error, the ranks' need (``EM_SLACK``,
    ``EM_CONTEXT_GB``) and the card's use before them within
    ``EM_BUDGET_GB``.  Then the kernels at a rank's shapes: the four jpq
    kernels at T = 8,192, N = 50,176 (``lm_jpq_kernels``), the token
    gather's block backward (``lm_block_gather_row``) and the dispatch
    gather of a rank's 32 experts (``bag_bwd_row``).  Returns the
    summary, with ``kernels``: {kernel: row} and ``launches``: {kernel:
    {run: [a rank's launches]}}."""
    import shutil

    from repro_torch.configs.olmoe_1b_7b import FULL as OLMOE
    from repro_torch.nn import moe as moe_mod
    t0 = phase("phases 37-38: the LMs on a (data, model) mesh at full "
               "width, ranks sharing the one card: training (1, 2) and "
               "(2, 2), prefill and decode at (1, 2)")
    free_card(torch, dev, "the LM mesh phases")
    root = os.path.join(HERE, "build", "chip_smoke_lm_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    one, one_run, serve_one = {}, {}, {}
    for job in LM_MESH_TRAIN:
        run = lm_mesh_train(torch, None, job, dev,
                            min(job["steps"], LM_MESH_REF_STEPS))[0]
        one[job["name"]] = run["losses"]
        one_run[job["name"]] = {k: run[k] for k in ("losses", "step_ms",
                                                    "peak_gb")}
        free_card(torch, dev, "the next one-card run")
    for job in LM_MESH_SERVE:
        model = lm_mesh_model(job, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pre, steps, new, pre_ms, step_ms = lm_serve_run(
            torch, model, model.params(), dev)
        torch.save({"prefill": pre.cpu(), "steps": [x.cpu() for x in steps],
                    **{k: v.cpu() for k, v in new.items()}},
                   os.path.join(root, job["name"] + ".pt"))
        serve_one[job["name"]] = {
            "prefill_ms": pre_ms, "decode_step_ms": step_ms,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        del model, pre, steps, new
        free_card(torch, dev, "the next one-card serve")
    for job in LM_MESH_SERVE:         # one card's own bf16 error
        if job["dtype"] == "bf16":
            refs = [torch.load(os.path.join(root, f"serve-{job['arch']}-{dt}"
                                            ".pt")) for dt in ("bf16", "fp32")]
            serve_one[job["name"]]["bf16_err_fp32"] = lm_serve_err(
                torch, (refs[0]["prefill"], refs[0]["steps"],
                        {k: refs[0][k] for k in ("k", "v")}), refs[1])
            del refs
    print("   one card's Trainer: losses " + ", ".join(
        f"({k}) {[round(x, 6) for x in v]}" for k, v in one.items())
        + "; serving " + ", ".join(
        f"{k}: prefill {v['prefill_ms']:.1f} ms, decode "
        f"{v['decode_step_ms']:.2f} ms a step" for k, v in serve_one.items())
        + f" on {smi}")

    ranks, walls, before = {}, {}, {}
    for shape, n, jobs in (("1x2", 2, LM_MESH_TRAIN + LM_MESH_SERVE),
                           ("2x2", 4, (LM_MESH_MOE,))):
        out_dir = os.path.join(root, shape)
        os.makedirs(out_dir)
        # what this process and the card hold before the ranks start.
        # The cuBLAS workspaces live in the caching allocator: one made
        # while a large block was free pins that block's whole segment
        # (a 12.80 GB segment holding 32 MiB, on an H100 80GB HBM3)
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        before[shape] = {
            "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9,
            "reserved_gb": torch.cuda.memory_reserved(dev) / 1e9,
            "card_used_gb": float(subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split()[0]) * 2**20 / 1e9,
            "live_tensors": live_cuda_tensors(torch)[:8],
            # (segment bytes, bytes allocated in it) of the segments that
            # empty_cache cannot release
            "held_segments": sorted(
                ((s["total_size"], s["allocated_size"])
                 for s in torch.cuda.memory_snapshot()
                 if s["allocated_size"] > 0), reverse=True)[:8]}
        print(f"   {shape}: before the ranks this process holds "
              f"{before[shape]['allocated_gb']:.2f} GB allocated, "
              f"{before[shape]['reserved_gb']:.2f} reserved; the card "
              f"{before[shape]['card_used_gb']:.2f} GB used (nvidia-smi); "
              f"the largest live tensors {before[shape]['live_tensors']}, "
              f"the largest held segments {before[shape]['held_segments']}")
        t1 = time.perf_counter()
        run_ranks(lm_mesh_rank, n, (list(jobs), root, out_dir), dev,
                  model=2, timeout=900)
        walls[shape] = time.perf_counter() - t1
        ranks[shape] = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                                   weights_only=False) for r in range(n)]
        print(f"   {shape}: {n} ranks, {walls[shape]:.1f} s (the runs, on "
              f"the pool's ranks)")
    shutil.rmtree(root, ignore_errors=True)

    def need(peaks):
        return sum(p * EM_SLACK + EM_CONTEXT_GB for p in peaks)

    runs, launches = {}, {}
    per_layer = 1 + OLMOE.moe.top_k          # the dispatch and k combines
    for job in LM_MESH_TRAIN + (LM_MESH_MOE,):
        name = job["name"]
        shape = "2x2" if name == "c" else "1x2"
        per = [r[name] for r in ranks[shape]]
        steps = job["steps"]
        for r, rr in enumerate(per):
            for x in rr:
                check(len(x["losses"]) == steps
                      and all(np.isfinite(x["losses"])),
                      f"({name}) rank {r}: losses {x['losses']}")
            x = rr[0]
            n_bag = x["launches"]["embedding_bag_backward"]
            if job["arch"] == "olmoe-1b-7b":
                want = steps * (1 + job["layers"] * per_layer)
                check(n_bag == want, f"({name}) rank {r}: the bag backward "
                      f"launched {n_bag} times, not {want}")
            elif name == "b":
                for k in ("jpq_scores", "jpq_lookup", "jpq_lookup_bwd"):
                    check(x["launches"][k] == steps,
                          f"(b) rank {r}: {k} launched {x['launches'][k]} "
                          f"times in {steps} steps")
                check(x["launches"]["jpq_scores_bwd"] >= steps,
                      f"(b) rank {r}: jpq_scores_bwd launched "
                      f"{x['launches']['jpq_scores_bwd']} times")
            else:
                check(n_bag == steps, f"({name}) rank {r}: the bag backward "
                      f"launched {n_bag} times in {steps} steps")
            if name == "c":
                check(rr[0]["losses"] == rr[1]["losses"]
                      and rr[0]["digest"] == rr[1]["digest"],
                      f"(c) rank {r} differs run to run: {rr[0]['losses']} "
                      f"vs {rr[1]['losses']}, {rr[0]['digest']} vs "
                      f"{rr[1]['digest']}")
            for i, ref in enumerate(one.get(name, ())):
                gap = abs(x["losses"][i] - ref) / abs(ref)
                check(gap <= LM_MESH_TOL[name][i],
                      f"({name}) rank {r}: step {i} {x['losses'][i]} vs one "
                      f"card's {ref} (relative gap {gap:.3e} > "
                      f"{LM_MESH_TOL[name][i]})")
        first = [rr[0] for rr in per]
        for k in LM_KERNELS:
            launches.setdefault(k, {})[name] = [x["launches"].get(k, 0)
                                                 for x in first]
        runs[name] = {
            "arch": job["arch"], "layers": job["layers"],
            "mesh": shape, "batch": job["batch"], "S": LM_MESH_S,
            "losses": first[0]["losses"],
            "one_card": one_run.get(name),
            "loss_rel_gaps": ([[abs(a - b) / abs(b) for a, b in
                                zip(x["losses"], one[name])] for x in first]
                              if name in one else None),
            "loss_limits": LM_MESH_TOL.get(name),
            "step_ms": [x["step_ms"] for x in first],
            "median_step_ms": [float(np.median(x["step_ms"][1:]))
                               if len(x["step_ms"]) > 1 else None
                               for x in first],
            "peak_gb": [max(y["peak_gb"] for y in rr) for rr in per],
            "comm": [x["comm"] for x in first],
            "comm_per_step": [{k: v / steps for k, v in x["comm"].items()}
                              for x in first],
            "launches": [x["launches"] for x in first],
            "bit_identical": True if name == "c" else None}
        print(f"   ({name}) {job['arch']} {job['layers']} layers at {shape}: "
              f"losses {first[0]['losses']}"
              + ("" if name not in one else
                 f" (one card's {one[name]}, gaps a rank and step "
                 f"{[[f'{g:.2e}' for g in gs] for gs in runs[name]['loss_rel_gaps']]}"
                 f" within {LM_MESH_TOL[name]})")
              + f"; median step {runs[name]['median_step_ms']} ms, peaks "
              f"{[f'{p:.2f}' for p in runs[name]['peak_gb']]} GB, "
              f"collectives a step {runs[name]['comm_per_step'][0]} on rank "
              f"0" + ("; bit-identical run to run on every rank"
                      if name == "c" else "") + f", on {smi}")
    serve = {}
    for job in LM_MESH_SERVE:
        name = job["name"]
        per = [r[name] for r in ranks["1x2"]]
        noise = serve_one[name].get("bf16_err_fp32")
        for r, x in enumerate(per):
            for k in LM_SERVE_OUTS:
                if noise is None:
                    check(x["err"][k] <= LM_MESH_TOL["serve"],
                          f"{name} rank {r}: {k} {x['err'][k]:.3e} > "
                          f"{LM_MESH_TOL['serve']} of the largest")
                else:
                    lim = LM_MESH_BF16 * noise[k]
                    check(x["err_fp32"][k] <= lim,
                          f"{name} rank {r}: {k} {x['err_fp32'][k]:.3e} "
                          f"from one card's fp32, over {LM_MESH_BF16} x one "
                          f"card's bf16's {noise[k]:.3e}")
        serve[name] = {"one_card": serve_one[name], "ranks": per}
        worst = {k: max(x["err"][k] for x in per) for k in LM_SERVE_OUTS}
        print(f"   phase 38 {name} at (1, 2): prefill "
              f"{[round(x['prefill_ms'], 1) for x in per]} ms (one card "
              f"{serve_one[name]['prefill_ms']:.1f}), decode "
              f"{[round(x['decode_step_ms'], 2) for x in per]} ms a step "
              f"(one card {serve_one[name]['decode_step_ms']:.2f}); against "
              f"one card's: {worst} of the largest"
              + ("" if noise is None else
                 f"; from one card's fp32 "
                 f"{ {k: max(x['err_fp32'][k] for x in per) for k in noise} }"
                 f" (one card's bf16: {noise})") + f", on {smi}")
    peaks = {"1x2": [max([max(y["peak_gb"] for y in rk[j["name"]])
                          for j in LM_MESH_TRAIN]
                         + [rk[j["name"]]["peak_gb"] for j in LM_MESH_SERVE])
                     for rk in ranks["1x2"]],
             "2x2": runs["c"]["peak_gb"]}
    for shape, pk in peaks.items():
        # what the ranks need (each one's peak with the allocator's slack,
        # and its context) beside what the card held before they started
        total = need(pk) + before[shape]["card_used_gb"]
        check(total <= EM_BUDGET_GB,
              f"{shape}: the ranks' peaks {pk} need {need(pk):.1f} GB, with "
              f"the card's {before[shape]['card_used_gb']:.2f} GB in use "
              f"before them {total:.1f} GB > {EM_BUDGET_GB} GB")
        print(f"   {shape}: the ranks' peaks {[f'{p:.2f}' for p in pk]} GB "
              f"({sum(pk):.1f} together) need {need(pk):.1f} GB with the "
              f"allocator's slack and the contexts, {total:.1f} of "
              f"{EM_BUDGET_GB} GB with the card's use before them, on {smi}")

    # the kernels at a rank's shapes
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    job = LM_MESH_TRAIN[1]
    model = lm_mesh_model(job, dev)
    V = model.cfg.vocab
    batch = lm_mesh_batch(torch, dev, job, V)
    kernels = lm_jpq_kernels(torch, dev, smi, model, model.params(),
                             batch["tokens"], rows=V // 2)
    d_lm = model.cfg.d_model
    del model
    free_card(torch, dev, "the bag backward at the ranks' shapes")
    gen = torch.Generator(device=dev).manual_seed(42)
    d, E, k = OLMOE.d_model, OLMOE.moe.n_experts, OLMOE.moe.top_k
    x = torch.randn((LM_MESH_S, d), generator=gen, device=dev)
    router = 0.02 * torch.randn((d, E), generator=gen, device=dev)
    _, idx = moe_mod.top_k(torch.softmax(x @ router, -1), k)
    C = moe_mod.capacity(OLMOE.moe, LM_MESH_S)       # a data rank's tokens
    inv, _ = moe_mod.route(idx, E, C)
    ids = inv[:E // 2 * C].reshape(-1, 1).contiguous()
    dout = torch.randn((ids.shape[0], d), generator=gen, device=dev)
    kernels["embedding_bag_backward"] = {
        "token_gather_block": lm_block_gather_row(
            torch, dev, smi, batch["tokens"], V, 2, d_lm),
        "moe_dispatch_rank": bag_bwd_row(
            torch, ids, None, dout, LM_MESH_S + 1, 10,
            f"olmoe dispatch gather, a rank's {E // 2} experts", smi,
            clock_hz, gather=True)}
    del x, router, idx, inv, ids, dout, batch
    torch.cuda.empty_cache()
    done(t0)
    return {"runs": runs, "serve": serve, "peaks_gb": peaks,
            "before_ranks": before, "walls_s": walls, "kernels": kernels,
            "launches": launches}


# ---------------------------------------------------------------- phase 39
# MACE on a (data, model) mesh at full width, the ranks time-sharing the
# card (gloo staged through host memory, as ``launch/train.py --arch mace
# --devices N --model-axis S --share-card`` runs them): the graph's
# nodes and edges split over "data" (``MACE.local_batch``: each rank's
# share, its halo and its remote receivers exchanged), the readout over
# "model".  One task a world size on its rank pool, whose ranks run
# each of its meshes in turn, each mesh made from the running group, and
# each mesh its shapes in turn; a shape named twice runs twice
# (bit-identity).
MACE_MESH_RUNS = ((2, 1, ("molecule", "full_graph_sm", "minibatch_lg")),
                  (1, 2, ("molecule", "minibatch_lg")),
                  (4, 1, ("minibatch_lg",)),
                  (2, 2, ("molecule", "molecule")))
MACE_MESH_STEPS = 3
# relative gaps of a job's losses from one card's Trainer on the same
# weights and graph (phase 36's runs, adamw lr 1e-3): step 0, and steps
# 1-2 after adamw steps on the mesh's summed gradients (adam's first
# update is the gradient's sign, so an entry near zero may flip)
MACE_MESH_TOL = (1e-5, 1e-4)
# step 0's gradient summed over "data" and gathered over "model": of
# each leaf's largest entry, or 1e-6 of the whole gradient's largest
# (tests/test_torch_mace.py's leaf rule); (1, 2) serving: of the largest
# unsharded output
MACE_MESH_GRAD, MACE_MESH_FLOOR = 1e-5, 1e-6
MACE_MESH_SERVE = ("molecule", "minibatch_lg")
MACE_MESH_REQUESTS = 5
MACE_MESH_DIR = os.path.join(HERE, "build", "chip_smoke_mace_mesh")


def mace_host_batch(np, shape, data_dir=MACE_MESH_DIR):
    """A shape's host batch as phase 35 built it (saved under
    ``data_dir``)."""
    with np.load(os.path.join(data_dir, f"{shape}.npz")) as z:
        return {k: z[k] for k in z.files}


def mace_grad_err(torch, got, want):
    """The leaf rule's worst ratio: max over leaves of |got - want| over
    max(the leaf's largest |want|, MACE_MESH_FLOOR / MACE_MESH_GRAD of
    the whole gradient's largest); within MACE_MESH_GRAD when every leaf
    is within its tolerance."""
    big = max(float(w.abs().max()) for w in want if w.numel())
    floor = MACE_MESH_FLOOR / MACE_MESH_GRAD * big
    return max(float((g.cpu() - w).abs().max()) / max(
        float(w.abs().max()), floor) for g, w in zip(got, want) if w.numel())


def mace_mesh_job(torch, np, mesh, shape, batch, data_dir):
    """One phase 39 job on this rank: step 0's gradient (this rank's
    share over the whole batch's counts, summed over ``"data"``, the
    readout's blocks gathered over ``"model"``) against one card's saved
    under ``data_dir``; then ``MACE_MESH_STEPS`` adamw steps (lr 1e-3)
    through ``Trainer`` on the host batch, each step building its share
    (``MACE.local_batch``), the bag kernels' counter and
    ``HostMesh.comm`` read around the run; the peak since the job's
    start.  Returns its summary."""
    from repro_torch import bridge, dist
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.nn.module import tree_leaves
    from repro_torch.train.loop import (TrainConfig, Trainer, _spec_leaves,
                                        counted_loss, sum_over_ranks)
    from repro_torch.train.optimizer import OptConfig
    dev, D = mesh.device, mesh.shape["data"]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = mace_model(shape, dev)
    specs = _spec_leaves(bridge.keep_local_blocks(model, mesh))
    p = model.params()
    t0 = time.perf_counter()
    b = (model.local_batch(batch, mesh) if D > 1 else
         {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    torch.cuda.synchronize(dev)
    share_ms = (time.perf_counter() - t0) * 1e3
    ex = b.get("exchange")
    with dist.use_mesh_rules(mesh, local_batch=D > 1):
        fn = counted_loss(model, mesh) if D > 1 else model.train_loss
        loss, _ = fn(p, b)
    leaves = tree_leaves(p)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = sum_over_ranks([torch.zeros_like(x) if g is None else g
                          for x, g in zip(leaves, got)], mesh)
    got = [dist.gather_block(g, sp, mesh) for g, sp in zip(got, specs)]
    grad_err = mace_grad_err(torch, got, torch.load(
        os.path.join(data_dir, f"grads-{shape}.pt")))
    del model, p, b, loss, got, leaves
    gc.collect()
    torch.cuda.empty_cache()
    model = mace_model(shape, dev)
    if D == 1:                    # the whole graph: on the card once
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    tr = Trainer(model, OptConfig(lr=1e-3), TrainConfig(
        steps=MACE_MESH_STEPS, log_every=1, eval_every=0),
        data_fn=lambda s: batch, mesh=mesh)
    ec.reset_launches()
    comm0 = dict(mesh.comm)
    params, hist = tr.run(params=model.params())
    torch.cuda.synchronize(dev)
    rows = [h for h in hist if "loss" in h]
    out = {"shape": shape, "losses": [h["loss"] for h in rows],
           "step_ms": [h["sec"] * 1e3 for h in rows],
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": dict(ec.launches),
           "comm": {k: mesh.comm[k] - comm0[k] for k in comm0},
           "digest": state_digest(torch, [params]), "grad_err": grad_err,
           "share_ms": share_ms,
           "share": None if ex is None else {
               "own_rows": ex.n_own, "halo_rows": ex.n_halo,
               "remote_rows": ex.n_remote, "halo_pad": ex.halo.pad,
               "owner_pad": ex.owners.pad}}
    del tr, params, model, hist, batch
    # the next job on this rank may need the card's memory whole: a
    # cuBLAS workspace made while a large block was free pins its segment
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return out


def mace_mesh_rank(mesh, meshes, data_dir, out_dir):
    """One rank of phase 39 (module-level: it is pickled): each
    ``(D, S, shapes)`` of ``meshes`` in turn on a mesh of that shape
    (``mesh`` itself for the first, then one made from the running
    group), each shape in turn with a barrier after it.  Writes
    ``out_dir/rank<r>.pt``."""
    import numpy as np
    import torch

    from repro_torch import fp32_matmuls
    from repro_torch.launch import mesh as mesh_mod
    fp32_matmuls()
    res = {"rank": mesh.rank, "transport": mesh.transport, "meshes": {}}
    on = {}
    for D, S, shapes in meshes:
        if (D, S) not in on:
            on[(D, S)] = (mesh if (mesh.shape["data"], mesh.shape["model"])
                          == (D, S) else mesh_mod.make_host_mesh(
                              D * S, S, device=mesh.device,
                              share_card=True))
        m, jobs = on[(D, S)], []
        for shape in shapes:
            jobs.append(mace_mesh_job(torch, np, m, shape, mace_host_batch(
                np, shape, data_dir), data_dir))
            m.all_reduce(torch.zeros(1, device=m.device), ("data", "model"))
        res["meshes"][(D, S)] = jobs
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def mace_serve_make(shape, data_dir, device):
    """(model, template) of a phase 40 run (module-level: it is
    pickled): ``shape``'s published config from seed 0 and its batch less the
    labels."""
    import numpy as np
    template = mace_host_batch(np, shape, data_dir)
    template.pop("labels")
    return mace_model(shape, device), template


def mace_serve_rank(mesh, argv, shape, data_dir, out_dir):
    """One rank of phase 40's pooled serving (module-level: it is
    pickled): the ``--mesh 2`` CLI's per-rank body
    (``serve._mesh_rank``) on ``shape``'s batch, the result under
    ``out_dir``."""
    import functools

    from repro_torch.launch import serve as serve_mod
    serve_mod._mesh_rank(mesh, serve_mod.build_parser().parse_args(argv),
                         functools.partial(mace_serve_make, shape, data_dir),
                         out_dir, True)


def mace_share_rows(torch, np, dev, smi, batch, D):
    """The segment sum over receivers and the sender gather's backward
    at the last rank's share of ``batch`` at D data ranks, ``[E/D,
    C·5]`` (layer 2's l = 2 width): bit-identical twice, bit-equal to
    the plain version on CPU copies and within the fp32 sum bound
    (``bag_bwd_parity``); then by CUDA events the kernels on an order
    made beforehand, the ``ops`` call (its sort in), the plain version,
    ``zeros`` + ``index_add_``, ``F.embedding``'s backward, and the
    bytes bound (dout and the ids read once, the sums written once).
    Returns {kernel: row}."""
    import torch.nn.functional as F

    from repro_torch.data.graphs import partition_graph
    from repro_torch.kernels.embedding_bag import cuda as ec
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag import ref as eref
    share = partition_graph(batch, D, D - 1, graph_labels=False)
    ex = share["exchange"]
    gen = torch.Generator(device=dev).manual_seed(39)
    out = {}
    for name, key, V, gather in (
            ("segment_sum", "receivers", ex.n_own + ex.n_remote, False),
            ("gather_backward", "senders", ex.n_own + ex.n_halo, True)):
        ids = torch.as_tensor(share[key], device=dev).long()
        n, d = ids.shape[0], 128 * 5
        dout = torch.randn((n, d), generator=gen, device=dev)
        ids2 = ids[:, None].contiguous()
        what = f"MACE {name} at rank {D - 1}'s share of minibatch_lg, D = {D}"
        row = bag_bwd_parity(torch, ids2, None, dout, V, what, gather=gather)
        order = ec.sort_ids(ids2, V, wrap=gather)
        if gather:
            def whole():
                return ec.gather_backward(ids, dout, V)
        else:
            def whole():
                return eops.segment_sum(dout, ids, V)
        leaf = torch.zeros((V, d), device=dev, requires_grad=True)
        lib_out = F.embedding(ids, leaf)
        b_ms, b_by = bound(n * d * 4 + n * 8 + V * d * 4,
                           {"fp32 adds": (n * d, FADD_PER_S)})
        row.update({
            "V": V, "d": d, "ids": n, "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: ec.launch_backward(ids2, None, dout, V,
                                                     order=order), 10),
            "whole_ms": cuda_ms(whole, 10),
            "plain_ms": cuda_ms(lambda: eref.embedding_bag_backward_ref(
                ids2, None, dout, V), 3),
            "index_add_ms": cuda_ms(lambda: torch.zeros(
                (V, d), device=dev).index_add_(0, ids, dout), 10),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                lib_out, leaf, dout, retain_graph=True), 10),
            "library": "F.embedding backward", "bound_ms": b_ms,
            "bound_by": b_by})
        out[name] = row
        print(f"   {what} (V={V}, d={d}, {n} ids): kernels {row['ms']:.4f} "
              f"ms, ops call {row['whole_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, zeros + index_add_ "
              f"{row['index_add_ms']:.4f} ms, F.embedding's backward "
              f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"bit-identical twice, bit-equal to the CPU, on {smi}")
        del ids, ids2, dout, order, leaf, lib_out
        torch.cuda.empty_cache()
    return out


def mace_mesh_phases(torch, np, dev, smi, one_card):
    """Phases 39-40: MACE on a ``(data, model)`` mesh at full width
    (fp32, TF32 off), ranks time-sharing the one card
    (the rank pools), on the host batches
    phase 35 built (saved under ``MACE_MESH_DIR``, removed after).
    ``one_card``: phase 36's summary (its losses are the anchor).
    Phase 39: one card's step-0 gradient a shape, saved; then one pool
    task a world size (four ranks first, then their pool ends), whose
    ranks run each of its meshes of
    ``MACE_MESH_RUNS`` in turn, and each mesh its shapes
    (``mace_mesh_job``).  Checks: every job's step-0 loss within
    ``MACE_MESH_TOL[0]`` relative of one card's and steps 1-2 within
    ``[1]``, its step-0 gradient by the leaf rule, the bag backward
    launched on every rank every step (a sum a path and the graph sum,
    a gather's backward an l a layer), the (2, 2) runs bit-identical, the ranks' need
    (``EM_SLACK``, ``EM_CONTEXT_GB``) with the card's use before them
    within ``EM_BUDGET_GB``.  Then the two kernels at the last rank's
    share of minibatch_lg at D = 2 and 4 (``mace_share_rows``).  Phase
    40: ``launch/serve.serve_mesh`` (the ``--mesh 2 --share-card``
    CLI's body: its checks, the kernels' build, its spawn) on molecule,
    its ranks' body (``serve._mesh_rank``) on the 2-rank pool on
    minibatch_lg, ``MACE_MESH_REQUESTS`` requests of the
    shape's node count, every rank's outputs within ``MACE_MESH_GRAD``
    of the largest of the unsharded ``serve_loop`` on the same
    requests.  Returns the summary, with ``kernels``: {D:
    {kernel: row}} and ``launches``: {job: [a rank's launches a
    step]}."""
    import functools
    import shutil

    from repro_torch.configs.mace_arch import model_cfg
    from repro_torch.launch import serve as serve_mod
    from repro_torch.nn.module import tree_leaves
    t0 = phase("phase 39: MACE on a (data, model) mesh at full width, "
               "ranks sharing the one card: " + "; ".join(
                   f"({D}, {S}) {', '.join(shapes)}"
                   for D, S, shapes in MACE_MESH_RUNS))
    free_card(torch, dev, "the MACE mesh phases")
    root = os.path.join(HERE, "build", "chip_smoke_mace_mesh_runs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shapes = sorted({s for _, _, ss in MACE_MESH_RUNS for s in ss})
    for shape in shapes:             # one card's step-0 gradient
        model = mace_model(shape, dev)
        p = model.params()
        loss, _ = model.train_loss(p, mace_host_batch(np, shape))
        leaves = tree_leaves(p)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.save([torch.zeros(x.shape) if g is None else g.cpu()
                    for x, g in zip(leaves, got)],
                   os.path.join(MACE_MESH_DIR, f"grads-{shape}.pt"))
        del model, p, loss, leaves, got
        free_card(torch, dev, "the next one-card gradient")

    ranks, walls, before = {}, {}, {}
    worlds = {}                       # world size -> its meshes, in order
    for D, S, job_shapes in MACE_MESH_RUNS:
        worlds.setdefault(D * S, []).append((D, S, job_shapes))
    # the four ranks first, then their pool ends: the (1, 2) ranks need
    # the card but for their own pool's processes and this one
    for n, meshes in sorted(worlds.items(), reverse=True):
        out_dir = os.path.join(root, f"world{n}")
        os.makedirs(out_dir)
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        start_pools(dev, (n,))
        # the card's use with the pool's ranks waiting: their contexts
        # are in it
        before[n] = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0]) * 2**20 / 1e9
        t1 = time.perf_counter()
        run_ranks(mace_mesh_rank, n, (meshes, MACE_MESH_DIR, out_dir), dev,
                  model=meshes[0][1], timeout=600)
        walls[n] = time.perf_counter() - t1
        if n != min(worlds):
            POOLS.pop(n).close()
        per = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(n)]
        for D, S, _ in meshes:
            ranks[f"({D}, {S})"] = [{"jobs": r["meshes"][(D, S)]}
                                    for r in per]
        print(f"   {n} ranks ({', '.join(f'({D}, {S})' for D, S, _ in meshes)}"
              f"): {walls[n]:.1f} s (the runs, on the pool's ranks); the "
              f"card held {before[n]:.2f} GB before them, their contexts "
              f"included")
    shutil.rmtree(root, ignore_errors=True)

    def need(peaks):
        # the ranks' contexts are in the card's use before them
        return sum(p * EM_SLACK for p in peaks)

    runs, launches, peaks = {}, {}, {}
    for D, S, job_shapes in MACE_MESH_RUNS:
        mesh_name = f"({D}, {S})"
        per = ranks[mesh_name]
        for i, shape in enumerate(job_shapes):
            name = f"{mesh_name} {shape}" + (" (again)" if shape in
                                             job_shapes[:i] else "")
            jobs = [r["jobs"][i] for r in per]
            ref = one_card[shape]
            sums, gathers = mace_launches(model_cfg(shape))
            for r, x in enumerate(jobs):
                check(len(x["losses"]) == MACE_MESH_STEPS
                      and all(np.isfinite(x["losses"])),
                      f"{name} rank {r}: losses {x['losses']}")
                for s, (a, b) in enumerate(zip(x["losses"], ref["losses"])):
                    gap = abs(a - b) / abs(b)
                    lim = MACE_MESH_TOL[min(s, 1)]
                    check(gap <= lim, f"{name} rank {r}: step {s} {a} vs "
                          f"one card's {b} (relative gap {gap:.3e} > {lim})")
                check(x["grad_err"] <= MACE_MESH_GRAD,
                      f"{name} rank {r}: step 0's gradient {x['grad_err']:.3e}"
                      f" of its leaves' largest, over {MACE_MESH_GRAD}")
                n = x["launches"]["embedding_bag_backward"]
                want = MACE_MESH_STEPS * (sums + gathers)
                check(n == want, f"{name} rank {r}: the bag backward "
                      f"launched {n} times, not {want}")
            if shape in job_shapes[:i]:
                first = [r["jobs"][job_shapes.index(shape)] for r in per]
                check(all(a["losses"] == b["losses"]
                          and a["digest"] == b["digest"]
                          for a, b in zip(first, jobs)),
                      f"{name}: a rank differs run to run")
            launches[name] = [x["launches"]["embedding_bag_backward"]
                              // MACE_MESH_STEPS for x in jobs]
            runs[name] = {
                "mesh": [D, S], "shape": shape, "losses": jobs[0]["losses"],
                "one_card_losses": ref["losses"][:MACE_MESH_STEPS],
                "loss_rel_gaps": [[abs(a - b) / abs(b) for a, b in
                                   zip(x["losses"], ref["losses"])]
                                  for x in jobs],
                "grad_err": [x["grad_err"] for x in jobs],
                "median_step_ms": [float(np.median(x["step_ms"][1:]))
                                   for x in jobs],
                "step_ms": [x["step_ms"] for x in jobs],
                "one_card_step_ms": ref["median_step_ms"],
                "one_card_peak_gb": ref["peak_gb"],
                "peak_gb": [x["peak_gb"] for x in jobs],
                "share_ms": [x["share_ms"] for x in jobs],
                "share": [x["share"] for x in jobs],
                "comm_per_step": [{k: v / MACE_MESH_STEPS
                                   for k, v in x["comm"].items()}
                                  for x in jobs],
                "bit_identical": True if shape in job_shapes[:i] else None}
            c = runs[name]["comm_per_step"]
            print(f"   {name}: losses {[round(v, 6) for v in jobs[0]['losses']]}"
                  f" (one card's {[round(v, 6) for v in runs[name]['one_card_losses']]},"
                  f" largest gap {max(max(g) for g in runs[name]['loss_rel_gaps']):.2e});"
                  f" step 0's gradient {max(runs[name]['grad_err']):.2e} of"
                  f" the leaves' largest; median step "
                  f"{[round(v, 1) for v in runs[name]['median_step_ms']]} ms "
                  f"a rank (one card {ref['median_step_ms']:.1f}), peak "
                  f"{[round(v, 2) for v in runs[name]['peak_gb']]} GB (one "
                  f"card {ref['peak_gb']:.2f}); halo / owner-sum rows "
                  f"{[(s['halo_rows'], s['remote_rows']) if s else None for s in runs[name]['share']]},"
                  f" share build {[round(v, 1) for v in runs[name]['share_ms']]}"
                  f" ms; collectives a step on rank 0: {c[0]['calls']:.0f} "
                  f"calls, {c[0]['bytes'] / 1e6:.1f} MB, "
                  f"{c[0]['seconds']:.3f} s; bag backward "
                  f"{launches[name]} a rank and step"
                  + ("; bit-identical to the first run" if
                     runs[name]["bit_identical"] else "") + f", on {smi}")
        peaks[mesh_name] = [max(j["peak_gb"] for j in r["jobs"]) for r in per]
        total = need(peaks[mesh_name]) + before[D * S]
        check(total <= EM_BUDGET_GB,
              f"{mesh_name}: the ranks' peaks {peaks[mesh_name]} need "
              f"{need(peaks[mesh_name]):.1f} GB, with the card's "
              f"{before[D * S]:.2f} GB before them {total:.1f} > "
              f"{EM_BUDGET_GB} GB")
        print(f"   {mesh_name}: the ranks' peaks "
              f"{[round(v, 2) for v in peaks[mesh_name]]} GB need "
              f"{need(peaks[mesh_name]):.1f} GB with the allocator's slack, "
              f"{total:.1f} of {EM_BUDGET_GB} GB with the card's use "
              f"before them (the ranks' contexts included)")
    kernels = {}
    host = mace_host_batch(np, "minibatch_lg")
    for D in (2, 4):
        kernels[D] = mace_share_rows(torch, np, dev, smi, host, D)
        kernels[D]["launches_per_rank_step"] = launches[
            f"({D}, 1) minibatch_lg"]
    del host
    done(t0)

    t0 = phase(f"phase 40: launch/serve.py --arch mace --mesh 2 "
               f"--share-card at full width, {MACE_MESH_REQUESTS} "
               f"requests on {MACE_MESH_SERVE[0]} (serve.serve_mesh) and "
               + ", ".join(MACE_MESH_SERVE[1:])
               + " (its ranks' body on the 2-rank pool)")
    serve = {}
    for shape in MACE_MESH_SERVE:
        # one card's serve_loop on the requests the ranks will draw (the
        # shape's node count a request), then the CLI's body on 2 ranks
        make = functools.partial(mace_serve_make, shape, MACE_MESH_DIR)
        model, template = make(dev)
        N = int(template["positions"].shape[0])
        argv = ["--arch", "mace", "--requests", str(MACE_MESH_REQUESTS),
                "--batch-size", str(N), "--device", "cuda"]
        one = serve_mod.serve_loop(model, model.params(), template,
                                   serve_mod.build_parser().parse_args(argv),
                                   keep_outputs=True)
        del model, template
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        free_card(torch, dev, f"the {shape} serving ranks")
        t1 = time.perf_counter()
        argv += ["--mesh", "2", "--share-card"]
        if shape == MACE_MESH_SERVE[0]:      # the CLI's body, its spawn
            per = serve_mod.serve_mesh(serve_mod.build_parser().parse_args(
                argv), make=make, keep_outputs=True, timeout=600)
        else:                                # its ranks' body, pooled
            out_dir = os.path.join(root, f"serve-{shape}")
            os.makedirs(out_dir)
            run_ranks(mace_serve_rank, 2, (argv, shape, MACE_MESH_DIR,
                                           out_dir), dev, model=2,
                      timeout=600)
            per = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                              weights_only=False) for r in range(2)]
        wall = time.perf_counter() - t1
        sums, _ = mace_launches(model_cfg(shape))
        scale = max(float(o.abs().max()) for o in one["outputs"])
        errs = []
        for r, res in enumerate(per):
            check(res["mesh"] == 2 and res["rank"] == r
                  and res["transport"] == "gloo-staged",
                  f"serve --mesh 2 {shape} rank {r}: {res['transport']}")
            err = max(float((a - b).abs().max()) for a, b in
                      zip(res["outputs"], one["outputs"]))
            errs.append(err / scale)
            check(len(res["outputs"]) == MACE_MESH_REQUESTS
                  and err <= MACE_MESH_GRAD * scale,
                  f"serve --mesh 2 {shape} rank {r}: max |err| {err} > "
                  f"{MACE_MESH_GRAD} x {scale}")
            n = res["launches"]["embedding_bag_backward"]
            check(n == sums * (MACE_MESH_REQUESTS + 1),
                  f"serve --mesh 2 {shape} rank {r}: the bag backward "
                  f"launched {n} times, not {sums} a call")
        serve[shape] = {
            "one_card": {"p50_ms": one["p50_ms"], "p99_ms": one["p99_ms"]},
            "p50_ms": [x["p50_ms"] for x in per],
            "p99_ms": [x["p99_ms"] for x in per],
            "max_rel_err": errs,
            "comm_ms": [float(np.mean(x["comm_ms"])) for x in per],
            "comm_calls": [float(np.mean(x["comm_calls"])) for x in per],
            "comm_bytes": [float(np.mean(x["comm_bytes"])) for x in per],
            "launches": [x["launches"]["embedding_bag_backward"]
                         for x in per], "wall_s": wall}
        print(f"   {shape} (batch {N}, {wall:.1f} s with the ranks' "
              f"{'spawn' if shape == MACE_MESH_SERVE[0] else 'task'}): p50 "
              f"{[round(x, 2) for x in serve[shape]['p50_ms']]} ms a rank "
              f"(one card {one['p50_ms']:.2f}); against one card's "
              f"outputs {max(errs):.2e} of the largest ({scale:.3f}); "
              f"collectives a request {serve[shape]['comm_calls'][0]:.0f} "
              f"calls, {serve[shape]['comm_ms'][0]:.2f} ms; bag backward "
              f"{serve[shape]['launches']} a rank, on {smi}")
    shutil.rmtree(MACE_MESH_DIR, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    done(t0)
    return {"runs": runs, "serve": serve, "peaks_gb": peaks,
            "card_used_before_gb": before, "walls_s": walls,
            "kernels": kernels, "launches": launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import fp32_matmuls
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import jpq as jpq_mod
    from repro_torch.core.assign import popularity_permutation
    from repro_torch.kernels import build
    from repro_torch.kernels.jpq_topk import cuda as kc
    from repro_torch.kernels.jpq_topk import ops
    from repro_torch.launch import serve as serve_mod

    fp32_matmuls()
    dev = torch.device("cuda", 0)

    t0 = phase("device")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"   device={kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"   nvidia-smi: {smi}")
    done(t0)

    t0 = phase("build kernels (nvcc, sm_90a, one process per source)")
    build.build()
    for name in build.SOURCES:
        log = build.library_path(name).with_suffix(".log").read_text()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"   {name}: {'; '.join(regs)}")
    done(t0)

    def key_equal(a, b):
        return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
                and torch.equal(a[1], b[1]))

    def abs_err(a, b):
        return float((a[0] - b[0]).abs().max())

    err = {"jpq_topk": 0.0, "jpq_topk_pruned": 0.0}
    gen = torch.Generator(device=dev).manual_seed(1)
    N = 1_000_448

    t0 = phase(f"parity at full width B={B} N={N} m={M} b={BC}")
    codes = torch.randint(0, BC, (N, M), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    luts = {"normal": torch.randn((B, M, BC), generator=gen, device=dev),
            "quantised": torch.randint(-2, 3, (B, M, BC), generator=gen,
                                       device=dev).float()}
    pop = torch.randperm(N, generator=gen, device=dev)
    bn = ops.prune_block_n(N)
    states = {"identity": ops.prepare_pruning(codes, BC, bn),
              "permuted": ops.prepare_pruning(codes, BC, bn, perm=pop)}
    for lut_name, lut in luts.items():
        P = ops.canonicalise_lut(lut)
        for k in (10, 100):
            kern = kc.jpq_topk(P, codes, k)
            plain = ops.jpq_topk_scan(P, codes, k,
                                      block_n=ops.scan_block_n(N))
            check(key_equal(kern, plain),
                  f"jpq_topk != plain ({lut_name}, k={k})")
            err["jpq_topk"] = max(err["jpq_topk"], abs_err(kern, plain))
            cold = (torch.full((B,), -float("inf"), device=dev),
                    torch.full((B, k), -float("inf"), device=dev),
                    torch.zeros((B, k), dtype=torch.int32, device=dev))
            for st_name, st in states.items():
                kv, ki, kskip = kc.jpq_topk_pruned(
                    P, st.codes, st.ids, st.present, *cold, k=k, block_n=bn,
                    tie_break_ids=st.tie_break_ids)
                pv, pi, pskip = ops.jpq_topk_scan_pruned(
                    P, st.codes, st.ids, st.present, *cold, k=k, block_n=bn,
                    tie_break_ids=st.tie_break_ids)
                check(key_equal((kv, ki), (pv, pi)) and
                      key_equal((kv, ki), plain),
                      f"jpq_topk_pruned != plain ({lut_name}, k={k}, "
                      f"{st_name})")
                check(torch.equal(kskip.min(0).values, pskip),
                      f"pruned skip map != plain ({lut_name}, k={k}, "
                      f"{st_name})")
                err["jpq_topk_pruned"] = max(err["jpq_topk_pruned"],
                                             abs_err((kv, ki), (pv, pi)))
            # an overshooting warm floor: half the rows get a floor above
            # their true k-th value, so they must demote and re-sweep
            theta = plain[0][:, -1]
            floor = torch.where(torch.arange(B, device=dev) % 2 == 0,
                                theta + 1.0, theta - 1.0)
            wv, wi, stats = ops.jpq_topk_lut(
                P, codes, k, prune=states["permuted"], warm=floor,
                return_stats=True)
            check(key_equal((wv, wi), plain),
                  f"warm-floored pruned top-k != plain ({lut_name}, k={k})")
            check(int(stats["demoted"].sum()) == B // 2,
                  f"expected {B // 2} demoted rows, got "
                  f"{int(stats['demoted'].sum())}")
            err["jpq_topk_pruned"] = max(err["jpq_topk_pruned"],
                                         abs_err((wv, wi), plain))
            print(f"   {lut_name} k={k}: jpq_topk, jpq_topk_pruned "
                  f"(identity, permuted, warm floor) bit-equal to plain")
    del luts, states, codes, pop
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase("main path: full-width two-tower-retrieval-jpq serving")
    model, template = full_two_tower("two-tower-retrieval-jpq", dev)
    params = model.params()
    n_rows = params["item_emb"]["codes"].shape[0]
    runs = {}
    for name, flags, kern in (("fused", ["--fused"], "jpq_topk"),
                              ("pruned", ["--prune", "--perm", "--warm"],
                               "jpq_topk_pruned")):
        args = serve_mod.build_parser().parse_args(
            ["--batch-size", str(B), "--requests", str(REQUESTS),
             "--device", "cuda", *flags])
        per_req = []

        def counted(reqs, kern=kern, per_req=per_req):
            """The requests serve_loop would draw, with the launches of
            ``kern`` each one made (read when the loop asks for the next,
            after the request and its accounting)."""
            last = None
            for r in reqs:
                if last is not None:
                    per_req.append(kc.launches[kern] - last)
                last = kc.launches[kern]
                yield r
            per_req.append(kc.launches[kern] - last)

        kc.reset_launches()
        res = serve_mod.serve_loop(model, params, template, args, requests=(
            counted(serve_mod.make_requests(template, B, REQUESTS + 1,
                                            args.seed, reserved=(0,)))))
        counts = dict(kc.launches)
        check(counts[kern] > 0, f"main path '{name}' never launched {kern}")
        check(sum(per_req) == counts[kern] and len(per_req) == REQUESTS + 1,
              f"per-request launches of {kern} do not add up")
        res["launches"] = counts
        # the timed requests' launches of the path's kernel, and the p50
        # of the requests at each count
        res["launches_per_request"] = per_req[1:]
        lat = np.asarray(res["lat_ms"])
        res["p50_ms_by_launches"] = {
            int(n): float(np.percentile(lat[np.asarray(per_req[1:]) == n],
                                        50))
            for n in sorted(set(per_req[1:]))}
        runs[name] = res
        print(f"   {name}: p50={res['p50_ms']:.3f}ms p99={res['p99_ms']:.3f}"
              f"ms skip={res['skip']} launches={counts} "
              f"({REQUESTS + 1} requests incl. warm-up) on {smi}")
        print(f"   {name}: {kern} launches a timed request "
              f"{res['launches_per_request']}; p50 by launches "
              + ", ".join(f"{n}: {v:.3f} ms ({per_req[1:].count(n)} "
                          f"requests)"
                          for n, v in res["p50_ms_by_launches"].items()))

    # the output, held against the materialise path on one fresh request
    req = next(serve_mod.make_requests(template, B, 1, seed=123,
                                       reserved=(0,)))
    with torch.inference_mode():
        outs = {}
        for fused in (True, False):
            spec = engine_mod.RetrievalSpec(kind="jpq", k=10, fused=fused)
            outs[fused] = model.bind_engine(params, spec).retrieve(req)
    v, i = outs[True]
    check(tuple(v.shape) == (B, 10) and bool(torch.isfinite(v).all()),
          f"fused output shape {tuple(v.shape)} / non-finite values")
    check(bool((i >= 0).all()) and bool((i < n_rows).all()),
          "fused ids out of range")
    check(key_equal(outs[True], outs[False]),
          "fused serving != materialise-then-top-k on the same request")
    print("   fused top-10 bit-equal to the materialise path on one "
          "request")
    done(t0)

    t0 = phase("timing at the main path's shapes (CUDA events)")

    k = 10
    codes = params["item_emb"]["codes"]
    with torch.inference_mode():
        h = model.user_vec(params, torch.as_tensor(req["user_hist"],
                                                   device=dev))
        P = ops.canonicalise_lut(jpq_mod.partial_scores(
            params["item_emb"], h)).contiguous()
    # the pruned main path's state: the template's popularity order
    perm = popularity_permutation(
        serve_mod._template_popularity(template, n_rows))
    st = engine_mod.build_prune_state(codes, BC, perm=perm)
    nt = st.present.shape[0]
    cold = (torch.full((B,), -float("inf"), device=dev),
            torch.full((B, k), -float("inf"), device=dev),
            torch.zeros((B, k), dtype=torch.int32, device=dev))
    times = {
        "jpq_topk": (cuda_ms(lambda: kc.jpq_topk(P, codes, k), 20),
                     cuda_ms(lambda: ops.jpq_topk_scan(
                         P, codes, k, block_n=ops.scan_block_n(n_rows)), 3)),
        "jpq_topk_pruned": (
            cuda_ms(lambda: kc.jpq_topk_pruned(
                P, st.codes, st.ids, st.present, *cold, k=k,
                block_n=st.block_n, tie_break_ids=st.tie_break_ids), 20),
            cuda_ms(lambda: ops.jpq_topk_scan_pruned(
                P, st.codes, st.ids, st.present, *cold, k=k,
                block_n=st.block_n, tie_break_ids=st.tie_break_ids), 2)),
    }
    # least time for the same work: inputs read once, outputs written
    # once, over HBM; or the operations, each type over its own peak —
    # fp32 adds (and, pruned, the bound's maxes) and LUT lookups, which
    # run on different units, so the slower of the two.  Pruned: only
    # the (group, tile) pairs this run swept.
    bytes_u, adds_u, lookups_u = topk_work(B, n_rows, k)
    pruned_out = kc.jpq_topk_pruned(P, st.codes, st.ids, st.present, *cold,
                                    k=k, block_n=st.block_n,
                                    tie_break_ids=st.tie_break_ids)
    skip = pruned_out[2]
    bytes_p, adds_p, lookups_p, swept_items = pruned_work(
        torch, st, skip, B, k)
    # the general code path (codes read a byte at a time), which uint8
    # codes at m = 8 take when their rows are not 8-byte aligned, against
    # the main path's one 8-byte load a row
    codes_odd = odd_address(torch, st.codes)
    gen_out = kc.jpq_topk_pruned(P, codes_odd, st.ids, st.present, *cold,
                                 k=k, block_n=st.block_n,
                                 tie_break_ids=st.tie_break_ids)
    check(key_equal(gen_out[:2], pruned_out[:2]) and
          torch.equal(gen_out[2], skip),
          "jpq_topk_pruned's general path != its 8-byte path")
    general_ms = {"jpq_topk_pruned": cuda_ms(lambda: kc.jpq_topk_pruned(
        P, codes_odd, st.ids, st.present, *cold, k=k, block_n=st.block_n,
        tie_break_ids=st.tie_break_ids), 20)}
    print(f"   jpq_topk_pruned, general code path (codes at an odd "
          f"address): {general_ms['jpq_topk_pruned']:.4f} ms, bit-equal "
          f"to the 8-byte path ({times['jpq_topk_pruned'][0]:.4f} ms)")
    del codes_odd, gen_out, pruned_out
    # the unpruned kernel: its launch shape at k = 10 and 100 (the
    # wrapper's record), its general code path at k = 10 against the
    # 8-byte path and the plain version, and its time at k = 100
    top_out = kc.jpq_topk(P, codes, k)
    launch_shape = dict(kc.launch_shape)
    codes_odd = odd_address(torch, codes)
    gen_top = kc.jpq_topk(P, codes_odd, k)
    top_plain = ops.jpq_topk_scan(P, codes, k,
                                  block_n=ops.scan_block_n(n_rows))
    check(key_equal(gen_top, top_out) and key_equal(gen_top, top_plain),
          "jpq_topk's general path != its 8-byte path or the plain version")
    general_ms["jpq_topk"] = cuda_ms(lambda: kc.jpq_topk(P, codes_odd, k), 20)
    k100_ms = cuda_ms(lambda: kc.jpq_topk(P, codes, 100), 20)
    launch_shape_k100 = dict(kc.launch_shape)
    print(f"   jpq_topk launch shape k={k}: {launch_shape}; "
          f"k=100: {launch_shape_k100}")
    print(f"   jpq_topk, general code path (codes at an odd address): "
          f"{general_ms['jpq_topk']:.4f} ms, bit-equal to the 8-byte path "
          f"({times['jpq_topk'][0]:.4f} ms) and the plain version; k=100: "
          f"{k100_ms:.4f} ms, on {smi}")
    del codes_odd, gen_top, top_out, top_plain

    # the pruned kernel a second time, on a skip-heavy catalogue at full
    # width: codes that follow each item's rank (the card tests'
    # _structured catalogue), swept in popularity order, and a LUT that
    # falls with the code, so the running k-th value soon passes the
    # bounds of later tiles
    rank = torch.randperm(n_rows, generator=gen, device=dev)
    sh_codes = (rank[:, None] * BC // n_rows
                + torch.randint(0, 2, (n_rows, M), generator=gen,
                                device=dev)).clamp_(0, BC - 1).to(torch.uint8)
    sh_P = ops.canonicalise_lut(
        -(torch.arange(BC, device=dev) / BC)[None, None, :] * 4.0
        + 0.1 * torch.randn((B, M, BC), generator=gen, device=dev))
    sh_st = ops.prepare_pruning(sh_codes, BC, st.block_n,
                                perm=torch.argsort(rank))
    sh_args = (sh_P, sh_st.codes, sh_st.ids, sh_st.present, *cold)
    sh_kw = dict(k=k, block_n=sh_st.block_n,
                 tie_break_ids=sh_st.tie_break_ids)
    sh_kern = kc.jpq_topk_pruned(*sh_args, **sh_kw)
    sh_plain = ops.jpq_topk_scan_pruned(*sh_args, **sh_kw)
    check(key_equal(sh_kern[:2], sh_plain[:2]) and
          torch.equal(sh_kern[2].min(0).values, sh_plain[2]),
          "jpq_topk_pruned != plain on the skip-heavy catalogue")
    sh_bytes, sh_adds, sh_lookups, sh_items = pruned_work(
        torch, sh_st, sh_kern[2], B, k)
    sh_bound, sh_by, sh_parts = bound_of(sh_bytes, sh_adds, sh_lookups)
    skip_heavy = {
        "ms": cuda_ms(lambda: kc.jpq_topk_pruned(*sh_args, **sh_kw), 20),
        "plain_ms": cuda_ms(
            lambda: ops.jpq_topk_scan_pruned(*sh_args, **sh_kw), 2),
        "bound_ms": sh_bound, "bound_by": sh_by, "swept_items": sh_items,
        "skipped_group_tiles": int(sh_kern[2].sum()),
        "group_tiles": sh_kern[2].numel()}
    print(f"   jpq_topk_pruned, skip-heavy catalogue: "
          f"{skip_heavy['ms']:.4f} ms kernel, {skip_heavy['plain_ms']:.4f} "
          f"ms plain, bound over the swept tiles {sh_bound:.4f} ms ({sh_by}; "
          f"bytes {sh_parts[0]:.4f}, fp32 adds and the tile bounds' maxes "
          f"{sh_parts[1]:.4f}, LUT lookups {sh_parts[2]:.4f} ms); swept "
          f"{sh_items} of {n_rows} items (skip map: "
          f"{skip_heavy['skipped_group_tiles']} of "
          f"{skip_heavy['group_tiles']} group-tiles); bit-equal to plain")
    del sh_codes, sh_P, sh_st, sh_args, sh_kern, sh_plain, rank
    kernels = []
    for name, bytes_, adds, lookups, src, line in (
            ("jpq_topk", bytes_u, adds_u, lookups_u, "jpq_topk.cu", 329),
            ("jpq_topk_pruned", bytes_p, adds_p, lookups_p,
             "jpq_topk_pruned.cu", 281)):
        b_ms, b_by, (t_bytes, t_adds, t_lookups) = bound_of(bytes_, adds,
                                                            lookups)
        ms, plain_ms = times[name]
        run = runs["fused" if name == "jpq_topk" else "pruned"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/jpq_topk/jpq_topk.py:{line}",
            "launches": run["launches"][name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        kernels[-1]["general_path_ms"] = general_ms[name]
        if name == "jpq_topk_pruned":
            kernels[-1]["skip_heavy"] = skip_heavy
        else:
            kernels[-1]["launch_shape"] = launch_shape
            kernels[-1]["k100_ms"] = k100_ms
            kernels[-1]["launch_shape_k100"] = launch_shape_k100
        print(f"   {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f} ms, fp32 "
              f"adds {t_adds:.4f} ms, LUT lookups {t_lookups:.4f} ms), "
              f"B={B} k={k} on {smi}")
    print(f"   pruned sweep swept {swept_items} of {n_rows} items "
          f"(skip map: {int(skip.sum())} of {skip.numel()} group-tiles)")
    done(t0)

    del P, st, codes, params, model, h
    torch.cuda.empty_cache()
    train_kernels, data, codes_np, sasrec_run = train_phases(
        torch, np, dev, smi)
    kernels += train_kernels
    gc.collect()
    torch.cuda.empty_cache()
    seq_runs = {"sasrec": sasrec_run,
                **arch_phases(torch, np, dev, smi, data, codes_np)}
    objective_phases(torch, np, dev, smi, data, codes_np)
    seq_model, seq_params, _ = checkpoint_phase(torch, np, dev, smi, data,
                                                codes_np)
    semantic_phases(torch, np, dev, smi, data, template, seq_model,
                    seq_params)
    server = server_phases(torch, np, dev, smi, seq_model, seq_params)
    del seq_model, seq_params
    gc.collect()
    torch.cuda.empty_cache()
    engine = engine_phases(torch, np, dev, smi, data, codes_np)
    gc.collect()
    torch.cuda.empty_cache()
    example_phases(torch, np, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    bag_kernel, serve_ctr = ctr_phases(torch, np, dev, smi, data, template)
    gc.collect()
    torch.cuda.empty_cache()
    bag_bwd, bag_train_launches, ctr_train = ctr_train_phases(
        torch, np, dev, smi, data)
    bag_kernel["train_launches"] = bag_train_launches
    kernels += [bag_kernel, bag_bwd]
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_phases(torch, np, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    tp = model_axis_phases(torch, np, dev, smi, data, codes_np, seq_runs)
    gc.collect()
    torch.cuda.empty_cache()
    ctr_tp = ctr_model_axis_phases(torch, np, dev, smi, data, ctr_train)
    gc.collect()
    torch.cuda.empty_cache()
    em = elastic_mesh_phases(torch, np, dev, smi, data, codes_np, engine)
    del codes_np, data
    gc.collect()
    torch.cuda.empty_cache()
    srvm = server_mesh_phases(torch, np, dev, smi, server)
    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_serve_phases(torch, np, dev, smi)
    lm["train"], lm_kernels = lm_train_phases(torch, np, dev, smi)
    lm["cli"] = lm_cli_phase(torch, np, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = phase("MACE's batches on the host: " + ", ".join(MACE_SHAPES))
    from repro_torch.configs import mace_arch
    batches = {shape: mace_arch.make_batch(shape, seed=0)
               for shape in MACE_SHAPES}
    # kept on the host for phases 39-40, whose ranks read them
    import shutil
    shutil.rmtree(MACE_MESH_DIR, ignore_errors=True)
    os.makedirs(MACE_MESH_DIR)
    for shape, b in batches.items():
        np.savez(os.path.join(MACE_MESH_DIR, f"{shape}.npz"), **b)
    done(t0)
    mace = {"serve": mace_serve_phases(torch, np, dev, smi, batches)}
    mace["train"], mace_kernels = mace_train_phases(torch, np, dev, smi,
                                                    batches)
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    lm_mesh = lm_mesh_phases(torch, np, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    mace_mesh = mace_mesh_phases(torch, np, dev, smi, mace["train"])
    close_pools()
    for entry in kernels:                 # phase 39: a rank's share
        if entry["name"] == "embedding_bag_backward":
            entry["mace_mesh_shape"] = mace_mesh["kernels"]
            entry["mace_mesh_launches_per_rank_step"] = mace_mesh[
                "launches"]
    for entry in kernels:                 # phases 37-38: a rank's shapes
        entry["lm_mesh_shape"] = None     # not on the LM mesh path
        if entry["name"] in lm_mesh["kernels"]:
            entry["lm_mesh_shape"] = {
                **lm_mesh["kernels"][entry["name"]],
                "launches_per_rank": lm_mesh["launches"][entry["name"]]}
    for entry in kernels:                 # phase 36's shapes
        if entry["name"] == "embedding_bag_backward":
            entry["mace_shape"] = mace_kernels
    for entry in kernels:                 # phases 32-34: the LM's shapes
        if entry["name"] in lm_kernels:
            entry["lm_shape"] = lm_kernels[entry["name"]]
            entry["lm_launches"] = {
                run: r["launches"].get(entry["name"], 0)
                for run, r in lm["train"].items()}
    for entry in kernels:                 # phase 31's shard shapes
        if entry["name"] in srvm["shard_kernels"]:
            entry["server_mesh_shape"] = srvm["shard_kernels"][entry["name"]]
            entry["server_mesh_launches_per_rank"] = srvm["launches"][
                entry["name"]]
    for entry in kernels:                 # phase 30's launches and errs
        name = entry["name"]
        if name in em["kernels_at_round_shape"]["max_abs_err"]:
            entry["elastic_mesh_round_max_abs_err"] = em[
                "kernels_at_round_shape"]["max_abs_err"][name]
        if name in em["launches"]:
            entry["elastic_mesh_launches_per_rank"] = em["launches"][name]
    for entry in kernels:                 # phase 29's shard shapes
        if entry["name"] in ctr_tp["shard_kernels"]:
            entry["model_axis_ctr_shape"] = ctr_tp["shard_kernels"][
                entry["name"]]
            entry["model_axis_ctr_launches_per_rank"] = ctr_tp["launches"][
                entry["name"]]
    for entry in kernels:                 # phase 28's shard shapes
        if entry["name"] in tp["shard_kernels"]:
            entry["model_axis_shape"] = tp["shard_kernels"][entry["name"]]
            entry["model_axis_launches_per_rank"] = tp["launches"][
                entry["name"]]
    for entry in kernels:                 # phase 27's shard shapes
        if entry["name"] in mesh["shard_kernels"]:
            entry["mesh_shape"] = mesh["shard_kernels"][entry["name"]]
            entry["mesh_launches_per_rank"] = mesh["launches"][entry["name"]]
    for entry in kernels:                 # phase 26's launches and errs
        if entry["name"] in engine["elastic_launches"]:
            entry["elastic_launches"] = engine["elastic_launches"][
                entry["name"]]
            entry["elastic_round_max_abs_err"] = engine[
                "elastic_round_max_abs_err"][entry["name"]]
    for entry in kernels:                 # phase 25's times at B = 8, 64
        if entry["name"] in server["kernels_at_server_shape"][8]:
            entry["server_shape"] = {
                Bq: row[entry["name"]]
                for Bq, row in server["kernels_at_server_shape"].items()}

    print(json.dumps({"serve": {
        n: {key: r[key] for key in ("path", "p50_ms", "p99_ms", "skip",
                                    "demoted_rows", "launches",
                                    "launches_per_request",
                                    "p50_ms_by_launches")}
        for n, r in runs.items()}, "card": smi}))
    print(json.dumps({"serve_ctr": serve_ctr, "card": smi}))
    print(json.dumps({"ctr_train": ctr_train, "card": smi}))
    print(json.dumps({"server": server}))
    print(json.dumps({"mesh_serve": mesh["mesh_serve"], "card": smi}))
    print(json.dumps({"model_axis_train": tp["runs"], "card": smi}))
    print(json.dumps({"ctr_model_axis": {"train": ctr_tp["runs"],
                                         "serve": ctr_tp["serve"]},
                      "card": smi}))
    print(json.dumps({"elastic_mesh": em["runs"], "card": smi}))
    print(json.dumps({"server_mesh": srvm["runs"], "card": smi}))
    print(json.dumps({"lm": lm, "card": smi}))
    print(json.dumps({"mace": mace, "card": smi}))
    print(json.dumps({"lm_mesh": {k: lm_mesh[k] for k in (
        "runs", "serve", "peaks_gb", "before_ranks", "walls_s")},
        "card": smi}))
    print(json.dumps({"mace_mesh": {k: mace_mesh[k] for k in (
        "runs", "serve", "peaks_gb", "card_used_before_gb", "walls_s")},
        "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        close_pools(timeout=0)      # after a failure: kill the ranks
    sys.exit(rc)
