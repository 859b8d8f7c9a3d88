#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # full run: 32 layers of Llama-3-8B
    python3 chip_smoke.py --layers 2   # same, with the depth cut to 2
    python3 chip_smoke.py --train-layers 4   # phase 20 trains 4 layers

Phases 7-17, 21 and phase 18's paged and tiered engines serve their
models at ``--serving-layers`` (default 8, at most ``--layers``; phases
14-16 served Llama-3-8B and Hymba-1.5B at full depth until phase 17 came,
phases 11 and 13 theirs until phase 18 came, phase 13's Hymba-1.5B until
phase 22 came); phase 18's and 19's models serve at full depth.

Phases, each fatal on failure (exit code 1, no result line):

1. Device: the card's name, count, and ``nvidia-smi`` name + power limit.
2. Build: every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together), with the ptxas register and
   shared-memory lines; the prefill GEMM's SASS must hold HGMMA.
3. Kernels against their plain PyTorch versions on the card, at the shapes
   the Llama-3-8B paths give them: the quantizer bitwise (up to counted
   candidate near-ties) on a weight cast (nxfp4, f32), on a prefill
   activation (amxfp4, bf16 read as it is, uint32 meta) and on the two
   K/V cache writes (nxfp4, bf16, K and V in one launch into the cache
   rows: a decode step's at ragged rows, a 4 x 128 prefill's), the
   dequant GEMM (at the four
   main-path (K, N) pairs and M 4, 16 and 512, bitwise on a second
   launch), the decode attention (S 256, 512 and 4096, bitwise on a second
   launch) and the quantized x quantized (qq) GEMM (the four (K, N) pairs
   at M 16, 32 and 512, bitwise on a second launch and equal to the
   dequant GEMM fed the plain-decoded X) within a stated tolerance. Then
   every kernel at the formats beyond the main path's (``WIDE_FMTS``:
   nxfp3, nxfp4_bs8/_bs64/_bs128, mxfp4_cr with Fig. 11's recycled value
   5.0, and nxfp6, phase 10's standard tier): the quantizer bitwise on a
   4096 x 14336 weight cast, the dequant GEMM at M 4, 32 and 512, the qq
   GEMM at M 512 and decode attention at S 256, each bitwise on a second
   launch and within the tolerances above. The dense family's shapes: the
   dequant GEMM at the (K, N) pairs of Llama-2-7B, StarCoder2-3B and
   H2O-Danube3-4B at M 4 and 512, decode attention at G 1 (32 KV heads),
   G 12 (2 KV heads) and head_dim 120 over a 4096-row ring, the K/V
   write of head_dim 120 rows into that ring. The attention kernel's
   dense-row instance (bf16 K/V, the premium tier's cache) at the same
   head shapes: within 1e-5 of max|V| of its plain version (the
   reference's einsum), bitwise on a second launch, a row's bits the same
   at B 1, 4 and 8. The bf16 GEMM's route (cuBLAS on 128-row tiles above
   16 rows): rows at M 17, 32 and 200 bitwise M 512's, timed at M 32 and
   512 against one ``torch.mm``. Each is timed with CUDA events (cold L2), beside its plain
   version, one PyTorch library call computing the same function (a
   yardstick the port never calls) and its bound on the card.
4. Reference on a small input: the smoke Llama through the kernels on the
   card against the plain path on the CPU, teacher-forced, logits within
   tolerance; and its qq prefill (``act_fmt="amxfp4"``) likewise.
5. Main path: Llama-3-8B at full width (random weights from a seed),
   ``ServeEngine`` with nxfp4 weights and nxfp4 KV, 4 prompts of 128
   tokens, 32 greedy tokens through the device loop (chunk 16: one CUDA
   graph, captured in the first call, replayed twice a call) and the host
   loop, which must agree. Every kernel's launch counter is set to 0 just
   before and read just after (the graph's launches count at its warm-up
   and capture, through the wrappers; a replay re-runs them); each kernel
   of the path (all but the qq GEMM) must be > 0, and a decode step must
   launch the quantizer once per layer (K and V of a layer in one
   launch). Then ms per decode step of the graph device loop, the eager
   device loop (``decode_loop`` called directly) and the host loop, in
   ``LOOP_ROUNDS`` rounds of (graph, eager, host, host, eager, graph),
   every run's tokens equal.
6. The qq prefill path at full width: the same weights, 4 x 128 prompt
   tokens through ``prefill(..., kv_fmt="nxfp4", act_fmt="amxfp4")``
   (amxfp4 activations x nxfp4 weights in every projection), then 32
   greedy tokens through ``decode_loop``. Counters are set to 0 just
   before and read just after; every kernel of the path (quantizer, qq
   GEMM, dequant GEMM, decode attention) must be > 0, with 7 qq GEMMs and
   5 quantizer launches (4 activation encodes, K and V) per layer in the
   prefill. Logits must be finite and bitwise equal on a
   second run. The qq and dense-activation prefills are timed in turns,
   8 rounds of (qq, dense, dense, qq), and compared by their medians and
   by each round's ratio.
7. Wide serving: Llama-3-8B at full width, the depth of ``--layers``,
   served with nxfp3 weights and nxfp3 KV, then with nxfp4_bs64 weights
   and KV: 16 greedy tokens through the graph device loop equal the host
   loop's, and the quantizer, the dequant GEMM and decode attention run
   at those formats.

8. Continuous serving: first a decode row at B 4, 8 and 16 against the same
   row at B 1, bitwise, for every row-spanning op and ``decode_step``'s
   logits (``scripts/batch_invariance.py``, the smoke Llama and a 2-layer
   Llama-3-8B at full width). Then Llama-3-8B at full width (depth of
   ``--layers``, random weights from seed 0, nxfp4 weights and KV) through
   ``ContinuousEngine`` (4 slots, chunk 16, max_len 512): 8 requests
   (prompts 32-256, max_new 8-64, 4 at once then 4 over 0.3 s, two
   sampled with their own seeds, one with a stop token) served twice,
   every stream equal to its solo ``ServeEngine`` host-loop stream
   bitwise; the quantizer, the dequant GEMM and decode attention launch
   on the path (first serve: prefills and the graphs' capture); every
   decode chunk of the second serve is a graph replay. Printed: tok/s,
   TTFT and queue delay, ms a step of a 4-slot chunk, admission seconds,
   slot occupancy, the same requests as two static batches, peak memory.

9. The chunked-prefill lane: first a prompt's rows through the whole
   prefill against the lane at P 16, 32, 64 and 128, bitwise, for every
   op of the lane's path and ``prefill_chunk``'s logits and packed K/V,
   eager and as graph replays (``scripts/batch_invariance.py --chunked``;
   the dequant GEMM's rows at M 16, its split-K regime, against M 512 are
   reported, not held). Then phase 8's 8 requests through
   ``ContinuousEngine(prefill_mode="chunked", p_chunk=32)`` with phase 8's
   weights and settings: every stream equal to its solo stream bitwise
   on every serve, the quantizer, the dequant GEMM and decode attention
   launched on the path, every lane chunk a replay of one of the lane's
   two CUDA graphs; and through a P 128 lane and whole admission. Printed
   for the three in 1 round (2 until phase 22 came) of (P 32, whole,
   P 128, P 128, whole, P 32): tok/s, TTFT and queue delay (median,
   max), lane chunks, the largest stall a decode chunk waited behind and
   slot occupancy; one lane-chunk replay at P 16-128 against one
   decode-chunk replay (CUDA events); a serve under ``TtftDeadline`` with
   one more request whose ``deadline_s`` expires in the queue (its status
   DEADLINE_EXPIRED, the others bitwise). Phase 3 also holds the lane
   chunk's K/V write (slot and n_valid read on the device) against its
   plain version.

10. Admission control and serving tiers, at phase 8's settings. First
   ``ContinuousEngine(prefill_mode="chunked", p_chunk="auto")`` with
   phase 8's weights: its sweep (one decode-chunk replay and one lane-chunk
   replay at P 16-128, least of 3 after a warm-up) and pick, which must be
   > 16 (at 16 the lane's GEMMs run split-K, outside the bitwise oracle);
   phase 8's requests bitwise their solo streams on every serve, timed in
   2 rounds of (auto, whole, whole, auto). Then overload: 16 requests at
   t 0 (phase 8's, twice) into 4 slots with ``max_queue`` 4, under
   ``RejectNew``, ``DropOldest`` and ``DegradeOverBudget(max_new_cap=8)``:
   the shed and degraded uids are the rule's (8 over budget at the first
   sweep: the newest, the oldest, the newest), every served stream its
   solo stream (a degraded one's at max_new 8, greedy); goodput, shed
   count, queue delay. Then ``TieredContinuousEngine(default_tiers())``
   over a bf16 Llama-3-8B: first the premium path's invariance
   (``batch_invariance.py --dense``: cuBLAS rows, dense decode attention,
   the norm and the softmax at B 4 and 8 vs B 1, the lane at P 32 vs the
   whole prompt; every count must be 0); phase 8's requests by uid % 3
   over premium, standard and economy, served whole and chunked (P 32),
   each three times: every stream bitwise its solo stream
   (``ServeEngine``'s host loop at the tier; the economy prefill with
   amxfp4 activations); the dense-row attention launched on the premium
   tier's path; the qq GEMM launched 7 times a layer
   per economy prefill and per lane-graph warm-up and capture, every
   decode and lane chunk a graph replay; a tier engine restricted to
   standard, and to premium, bitwise the plain engine at that policy; the
   degrade rung once (a premium request over a KV watermark repacked into
   the standard arena, its rows bitwise the plain codec's encode of its
   dense rows, ``degraded=True``, a ``kv-repack`` event). Printed: tok/s,
   TTFT by tier, group dispatches and ms a chunk by group count, arena and
   weight bytes, peak memory, the phase's seconds.

11. The rest of the dense family at full width and ``--serving-layers``
   (their full depths until phase 18 came), nxfp4 weights and KV,
   random weights from seed 0 cast on the card: Llama-2-7B (MHA) and
   StarCoder2-3B (2 KV heads) serve 4 requests
   through ``ContinuousEngine`` (4 slots, chunk 16, max_len 512); H2O-
   Danube3-4B (head_dim 120, a 4096-row ring) serves 3
   requests, one of 4500 prompt tokens (its ring wraps in prefill and in
   decode), whole and through the lane at P 128, whose 4224 rows make it
   a ring too (the chunks from offset 4224 on run the ring lane's
   graphs). Each serve twice; every stream bitwise its solo host-loop
   stream; the quantizer, the dequant GEMM and decode attention launched
   on each model's path.

12. The paged KV cache at full width, held bitwise against the dense
   ``ContinuousEngine`` in the same process. Llama-3-8B (at
   ``--serving-layers`` since phase 14 came, 32 before; nxfp4 weights and
   KV): 16 requests (prompts 32-512, max_new 16-64,
   four extending one 256-token prefix) into 8 slots, max_len 2048, chunk
   16, through ``PagedContinuousEngine`` with 32-row pages and a pool of
   a quarter of the dense arena (129 pages), whole and through the lane
   at P 32: every stream the dense engine's, a prefix hit, admission
   refused on pages at least once, the high watermark within capacity,
   the pool empty after each serve. The dense cache (``kv_fmt=None``, 4
   of the requests) through the paged engine: the dense-row attention over
   the gathered view. H2O-Danube3-4B (24 layers): a registrar of a
   4000-token prompt and two claimants of it with 160 new tokens, whose
   ring wraps into the shared pages: COW breaks, bitwise. Launches are
   counted over the paged serves (``launches_paged_path``). Printed: KV
   bytes of pool and arena, each engine's peak memory, tok/s and ms a
   decode chunk of second serves in turns, the gather's share of a decode
   step. Phase 3 holds the quantizer through a block table (decode rows
   and a lane chunk, null-page and dropped rows) against its plain
   version, timed beside the unpaged write.

13. The SSM and hybrid families at full width, nxfp4 weights (random
   from seed 0, cast on the card). Falcon-Mamba-7B (attention-free; at
   ``--serving-layers``, its 64 Mamba layers until phase 18 came): ``ServeEngine`` 4 x 128 tokens, 32 new, the
   graph device loop bitwise the host loop (ms a step, tok/s, launches a
   step); 3 requests (prompts 1000, 300, 64) through ``ContinuousEngine``
   whole and at P 256 (max_len 2048) and ``PagedContinuousEngine`` (no
   pages: no attention), every stream bitwise its solo host-loop stream.
   Hymba-1.5B (at ``--serving-layers``, its 32 layers until phase 22
   came; windowed attention and a Mamba head, nxfp4 KV
   in a 1024-row ring): 3 requests (2600, 300, 64) whole and at P 256
   picked by ``p_chunk="auto"`` (the only candidate that is a multiple of
   ``ssm_chunk``; max_len 1280: the chunks from offset 1280 on run the
   ring lane), and
   4 requests extending one 512-token prefix through the paged engine at
   P 256 (a prefix hit), bitwise the dense engine's. For each family a
   decode step's rows (logits, ``h``, ``conv``) bitwise at B 4 and B 1
   and as a graph replay, and the whole prefill's state bitwise the
   lane's at P 256. Printed: per-slot state bytes against the KV bytes,
   peak memory, launches on each family's path. Phase 3 holds the kernels
   at these families' shapes (``SSM_KN``, ``SSM_ATTENTION``,
   ``SSM_CASTS``, ``SSM_KV``); their rows join the kernel table.

14. Self-speculative decoding (``ContinuousEngine(speculative=
   SpeculativeConfig(k=4))``), every greedy stream bitwise the plain
   engine's in the same call. Llama-3-8B at full width and
   ``--serving-layers`` depth (32 layers until phase 17 came):
   ``verify_step`` at B 4, Q 5 (logits, and the cache after a commit of 1,
   3, 5 and ragged [1, 2, 5, 3] rows) bitwise 5 sequential
   ``decode_step`` calls; 8 staggered requests (prompts 32-256, max_new
   32-64, 4 slots, chunk 16, max_len 512) under two pairings: nxfp4
   weights and KV with ``draft="recycled"`` (the bf16 tensors the codes
   decode to), and bf16 weights and dense KV with ``draft="nxfp4"``; a
   seeded sampled request served twice equal to itself; a request whose
   prompt + max_new fills max_len. Hymba-1.5B (``--serving-layers``): a
   1000-token
   prompt whose 64 new tokens wrap its 1024-row ring mid-speculation,
   beside two short ones, whole and at P 256. Falcon-Mamba-7B at
   ``--serving-layers``: three requests. Launches are counted around the
   speculative serves alone (the plain engines' serves, the oracles, run
   outside) and every kernel of each path must launch. Printed for each
   pairing: accept rate, ms a speculative chunk and a round, tok/s
   against the plain engine (second serves in turns).

15. The paged engine's speculative rounds and tiered serving for the SSM
   and hybrid families. Llama-3-8B at full width and ``--serving-layers``
   depth (32 layers until phase 16 came; nxfp4 weights
   and KV, recycled draft, k 4, 4 slots, chunk 16, max_len 512, pages of
   32 rows, prefix sharing): 6 requests, four on one 96-token prefix,
   through ``PagedContinuousEngine(speculative=)``: every stream bitwise
   the dense speculative engine's and the plain paged engine's,
   ``spec_stats()`` equal to the dense engine's, a prefix hit, page 0
   all zeros, the pool empty; tok/s and ms a chunk against the plain paged
   engine in turns. Hymba-1.5B at ``--serving-layers``: a registrar of a
   990-token
   prompt and two claimants whose speculative rounds wrap the 1024-row
   ring into its pages at chunk 1 (the round's k + 1 rows the write
   horizon): streams bitwise the dense speculative engine's, every COW
   break inside that horizon, one where the chunk's row alone would not
   have broken. ``TieredContinuousEngine(default_tiers())``
   over bf16 models of Hymba-1.5B and Falcon-Mamba-7B, both at
   ``--serving-layers`` (Hymba at full depth until phase 17 came): 6
   requests by uid % 3 over premium, standard
   and economy, whole and at P 256, every stream bitwise its solo stream
   at its tier; qq GEMM launches around the serves 7 a layer per economy
   prefill on Hymba and none on Falcon; the standard tier alone bitwise
   the plain engine, whole and at P 256; on Hymba the degrade rung's
   repack (``DegradeOverBudget(pool_watermark=0.05)``): the moved slot's
   ``h``/``conv`` bitwise, its K/V rows ``repack_kv``'s of the source rows
   through the plain codec. Launches are counted around the engines under
   test alone (``launches_phase15_path``). Phase 3 holds the quantizer's
   paged verify write ((4, 1) rows, one on a null page) and the qq GEMM
   at Hymba's (K, N) pairs at M 256 and 512; their rows join the table.

16. Suspension, preemption, slot snapshots and checkpoints
   (``phase_suspend_resume``), every interrupted stream bitwise the same
   engine's uninterrupted stream (served in turn in the same process, so
   the graphs are captured once). Llama-3-8B at full width and
   ``--serving-layers`` depth (32 layers until phase 17 came; nxfp4
   weights and KV, 4 slots, chunk 16, max_len 512): four batch requests
   at priority 0 and two interactive ones at priority 1 arriving
   at 0.2 s under ``PriorityPreemption`` (a preemption and a resume
   required), tok/s against the uninterrupted serve in turns; a sampled
   request suspended by ``suspend()`` resuming in another slot, the
   restored slot read back bitwise its snapshot; its snapshot bytes at
   nxfp4 and at bf16 KV; two slots of a speculative engine (k 4, recycled
   draft) suspended, the streams the plain engine's and ``spec_k`` back
   (one set to 2 first); a checkpoint after the second chunk, a crash (an
   exception out of ``progress_cb``), then ``restore`` on a fresh dense and
   a fresh paged engine. Hymba-1.5B (``--serving-layers``; its 1000-token
   prompt's
   ring wrapped) and Falcon-Mamba-7B (``--serving-layers``), whole and at
   P 256: a request suspended after 32 tokens, its ``h``/``conv`` and K/V
   rows bitwise across the round trip, the decode graphs captured afresh
   after the resume. ``TieredContinuousEngine(default_tiers())`` on
   Llama-3-8B at ``--serving-layers``: an economy request back in its
   arena in another slot. Printed: suspend and resume ms, checkpoint bytes
   and write seconds, snapshot and state bytes, launches counted around
   the interrupted serves alone (``launches_phase16_path``).

17. Faults, quarantine and the KV/SSM canaries (``phase_faults``), at
   full width and ``--serving-layers``. Llama-3-8B (nxfp4 weights and KV,
   4 slots, chunk 16, max_len 512, ``kv_integrity=True``) under a seeded
   ``FaultPlan``: ``nan_logits`` on uid 1 at chunk 1 (one retry: it heals
   to its solo stream), ``kv_flip`` of 2 bytes on uid 2 at chunk 2 (no
   retry: FAILED with a prefix of its fault-free stream; the K/V canary
   must trip) and a 0.05 s delay; every other stream bitwise the same
   engine's fault-free serve, every chunk a graph replay. Then the same
   serve with the canaries off and on in turns, twice (three times until
   phase 22 came; its wall a
   chunk, the canary work a chunk and its share of a chunk's dispatch and
   of that wall), one fold's CUDA-event ms, the
   quarantine-to-requeue ms; the speculative (k 4, recycled draft) and
   paged engines under ``nan_logits`` (the victim failed, the pool back to
   its fault-free count); Falcon-Mamba-7B with an at-rest ``h`` upset
   quarantined as ``ssm_integrity`` and healed; an economy request of
   ``TieredContinuousEngine(default_tiers())`` poisoned and healed.
   Launches are counted around the faulted serves alone, each of which
   captures its decode graphs afresh (``launches_phase17_path``).
18. The weights built a layer at a time and the MoE family
   (``phase_moe``), at full width. Llama-3-8B (32 layers, nxfp4): the
   whole f32 build and its cast against ``init_params(policy=)``, every
   QTensor bitwise, both peaks above what was allocated before (the
   layered one must stay under the packed bytes plus two layers of f32).
   DeepSeek-67B (95 layers) and Phi-3.5-MoE (32 layers), built a layer at
   a time at nxfp4: ServeEngine on 4 x 128 prompt tokens, 16 new, graph
   loop bitwise the host loop. Qwen1.5-MoE-A2.7B (24 layers): the same
   with 32 new, then ``ContinuousEngine`` (6 staggered requests, 4 slots,
   chunk 16) under whole admission, every stream bitwise its solo
   host-loop stream, and chunked admission (P 32), which warns and serves.
   Qwen-MoE at ``--serving-layers``: ``PagedContinuousEngine`` (no shared
   prefix: bitwise the solos; a shared 96-token prefix: statuses and
   prefix hits), ``TieredContinuousEngine(default_tiers())`` under whole
   admission (the tiers' solo streams, one-tier == plain, the degrade
   rung), ``speculative=`` refused. The dequant GEMM's grouped instance
   (routed experts' rows) at Qwen's decode and prefill shapes and Phi's
   decode shapes: within 1e-5 of its plain version, bitwise on a second
   launch, every row bitwise ``ops.qmatmul`` of its expert's rows at up
   to 16, timed beside its bound and ``torch.matmul`` of each routed
   expert's rows (``launches_phase18_path``).
19. The vision and audio families and the quantized-KV simulation
   (``phase_vlm_audio``). (a) The smoke Llama-3.2-Vision and Whisper
   models (memory inputs drawn from a seeded generator on the card)
   through the kernels against the plain path on the CPU, prefill and 4
   teacher-forced steps within 1e-2; the smoke Llama with
   ``kv_sim_fmt="nxfp4"`` and a dense cache: every K/V fake-quantized on
   the card (the quantizer kernel, then the decode) equal to the plain
   ``fake_quant`` of the same tensor but for counted near-tie blocks,
   logits within 1e-2 of the CPU's. (b) Llama-3.2-Vision-90B at full
   width and depth (100 layers, d 8192; every fifth a cross layer over
   1601 patches), built a layer at a time at nxfp4 (peak against the
   packed bytes + 2 layers of f32), and (c) Whisper-tiny at its published
   config (1500 frames; the encoder's seconds and peak): ServeEngine on 4
   x 128 prompt tokens with vision (4, 1601, 8192) or frames (4, 1500,
   384), 32 greedy tokens, the graph loop (chunk 16) bitwise the host
   loop, rows 1 and 3 served alone at B 1 bitwise their batch rows, the
   dense-row attention launched once per cross layer a decode step and
   the quantizer once per self layer. (d) The kernels at the families'
   shapes: the GEMM at Vision-90B's and Whisper's (K, N) at M 4 and 512,
   the memory projections at M 6404 and 6000; the dense-row instance at
   S 1601 (KVH 8, G 8, D 128) and S 1500 (KVH 6, G 1, D 64), bitwise at B
   1/4/8, no read past S; packed attention and the K/V write at Whisper's
   heads; the weight casts of both models' widest MLP weight; the kv_sim
   quantizer at a Llama-3-8B prefill's K (``launches_phase19_path``).
20. Training (``phase_train``). (a) The smoke Llama (f32 training tree,
   B 4 x T 32) on the card against the CPU from the same weights: the
   loss within 1e-4 and every gradient leaf within 2e-2 of its norm; the
   NxFP8 gradient cast of those gradients on the quantizer kernel (one
   launch a leaf of at least 4096 values) equal to the plain codec's but
   for counted candidate near-tie blocks; ``forward_train``'s last row
   bitwise ``prefill(kv_fmt=None)``'s logits at B 4 x T 4 (both heads on
   the 16-row tile) and within 1e-5 of max|logit| at T 32 (a 128-row
   tile against the 16-row one); the forward's values with grad on
   bitwise those with grad off. (b) Llama-3-8B at full width and
   ``--train-layers`` depth (default 2: 1.487B parameters; 4 until
   phase 21 came) trained in
   f32 by ``train_loop``: 20 steps (30 until phase 22 came) of B 4 x T
   256 from
   ``SyntheticLM(vocab=128256)``, 2 microbatches, remat, AdamW (cosine,
   peak 1e-3), ``grad_compress="nxfp8"``; every loss finite and the
   mean of the last 5 below step 0's; then a run with a
   ``CheckpointManager`` saving every 10 steps (keep 1, under
   ``build/``) whose data source raises after step 10's checkpoint, and
   a run resumed from it, which must reach step 30 with the uninterrupted
   run's losses and weights bitwise and its moments' bit sums. Printed:
   the losses, a step's forward+backward, cast and optimizer ms (CUDA
   events), tok/s, the data draw, peak memory against the prediction,
   the crash and resume seconds, the checkpoint bytes. (c) The trained
   weights cast with ``load_params`` to nxfp4 and mxfp4: ``loss_fn`` on
   a held-out batch through the dequant GEMM (M 1024) within 2e-3 of
   ``loss_fn`` over each tree's ``dense_like``, both deltas against the
   f32 loss printed; ``ServeEngine`` on the nxfp4 tree (4 x 32 prompt
   tokens, 16 new), graph loop == host loop. (d) Launches counted around
   each path alone: the quantizer once a compressed leaf a step in
   training, the dequant GEMM in the eval, every kernel of the serve.
   (e) The quantizer at the gradient casts' widest shapes (``tok_embed``
   (128256, 4096) and ``lm_head`` (4096, 128256) f32, NxFP8), bitwise
   but near ties, and the dequant GEMM at M 1024 for the four (K, N)
   pairs, timed beside their bounds (``launches_phase20_path``).
21. Slot-sharded serving (``phase_sharded``): Llama-3-8B at full width
   and ``--serving-layers``, nxfp4 weights and KV, on
   ``make_serving_mesh(2, ["cuda:0"] * 2)`` (both shards on the one
   card), 8 slots, chunk 16, max_len 512. (a) 12 staggered requests (two
   sampled with their own seeds) through the lane at P 32: every stream
   bitwise and every status equal to the unsharded ``ContinuousEngine``'s
   (8 slots: up to 16 rows both sides run the split-K GEMM), at 2 shards
   of 4 slots and at 4 shards of 2; then the unsharded and the 2-shard
   engine's second serves in turns (tok/s, ms a decode chunk), and one
   shard's decode chunk counted eagerly (its launches; a chunk replays
   one such graph a shard). (b) A ``shard_down`` fault on shard 1 at
   chunk 1 (whole admission): every stream OK and bitwise the no-drain
   unsharded serve's, ``drain`` and ``migrate`` in the events, no
   admission on shard 1 after the drain, the migrations' ms, and
   draining the last healthy shard refused. (c) The sharded paged engine
   bitwise the unsharded paged engine, every pool empty after. (d) The
   sharded speculative engine (k 4, recycled draft; the first 8
   requests) bitwise the unsharded speculative engine, with
   ``spec_shard_stats()``. Launches
   are counted around each sharded serve alone (first serves: the
   shards' graph captures), peak memory printed.
22. The paper's figures (``phase_figures``). (a) The quantizer's
   table-driven instances (``KIND_TAB`` without code recycling,
   ``KIND_CRT`` with it: the cast the reference's ``direct_cast_tree``
   and ``fake_quant`` make) at full width: Llama-3-8B's w1 (4096 x 14336
   f32, seeded) cast along K under every format the figures cast (Table
   1's 16, Fig. 12's block sizes 8-128, Fig. 10's 3-bit ones, Fig. 11's
   14 recycle points), each bitwise the plain ``quantize_blocks`` on
   every 64th row of the blocked weight but counted candidate near-ties,
   timed beside its bound and nxfp4's beside the serving instance; the
   kv_sim route (``fake_quant_rows``) at a prefill's K (4, 128, 8, 128)
   bf16 under mxfp4 and bfp4 against the plain ``fake_quant``. (b)
   ``figures.common.trained_model`` (600 steps of 24 x 128 into a
   temporary directory; its ppl must show training), then Table 1 and
   Figs. 3 and 8-12 on it, every cast and fake-quantization the suite
   makes held against the plain version (codes and meta, bitwise but
   counted near-ties); every ordering the reference asserts printed
   with its verdict (not held: a finding about the trained model), the
   CSV rows and each figure's seconds. (c) Both example twins
   (``examples/train_then_serve_quantized_torch.py``,
   ``examples/longcontext_ssm_serving_torch.py``) run to completion. (d)
   Table 1's W4 row through the table cast on phase 20's trained
   Llama-3-8B (printed, not held). Launches are counted around (b), (c)
   and (d) alone (``launches_phase22_path``).

The last three lines are the kernel table as JSON, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# f32 operations per element per candidate in the quantizer's encode:
# scale, abs, clamp, exponent read, two ulp multiplies + round, clamp,
# sign select, dequant multiply, subtract, square, add; counted over the
# candidates the kernel evaluates for this data (evaluated_candidates)
QUANT_OPS = 13


# kernels a dense model's packed serving path does not launch: the qq GEMM
# (the qq prefill, phase 6), the dense-row attention (bf16 KV) and the
# dequant GEMM's grouped instance (the MoE experts, phase 18)
NOT_DENSE_PATH = ("nxfp_qq_matmul", "dense_attention", "nxfp_matmul_grouped")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Median kernel time over launches, each after an L2 flush.

    A spin of the card (``torch.cuda._sleep``) after the flush keeps it
    busy while the host enqueues the start event and the wrapper's launch,
    so the events time the device and not the ~50 us a wrapper spends in
    Python (at decode shapes the host took longer than the kernel)."""

    SPIN_CYCLES = 400_000        # ~0.2 ms at the H100's 1.98 GHz

    def __init__(self, device):
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 20) -> float:
        fn()
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        ts = sorted(a.elapsed_time(b) for a, b in events)
        return ts[len(ts) // 2]


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}); nvidia-smi: {smi_line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return name, count, smi_line


def hgmma_count(lib_path: str) -> dict:
    """HGMMA instructions per kernel in the built library's SASS
    (``cuobjdump -sass``); the prefill GEMM must hold them."""
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(
        shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc")), "cuobjdump")
    try:
        out = subprocess.run([cuobjdump, "-sass", lib_path],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"cuobjdump: {e}")
    if out.returncode != 0:
        fail(f"cuobjdump: {out.stderr.strip()[-500:]}")
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in ln:
            counts[fn] += 1
    return counts


def phase_build():
    from repro_torch.kernels import build
    info = build.build()
    log(f"build: {info['seconds']:.1f} s -> {info['path']}"
        f"{' (cached)' if info['cached'] else ''}")
    for src, lines in info["ptxas"].items():
        for ln in lines:
            log(f"  ptxas {src}: {ln}")
    build.library()
    hg = hgmma_count(info["path"])
    prefill = {f: c for f, c in hg.items() if "matmul_prefill" in f}
    if not prefill or min(prefill.values()) == 0:
        fail(f"the prefill GEMM's SASS holds no HGMMA: {prefill}")
    log(f"  SASS: {len(prefill)} prefill GEMM instances, HGMMA per instance "
        f"{sorted(set(prefill.values()))}; HGMMA elsewhere "
        f"{sum(c for f, c in hg.items() if f not in prefill)}")


def _quantizer_traits(nq, flat, fmt):
    """(candidates the quantizer evaluates over ``flat``, its regime) for
    the quantizer module ``nq`` of the tree under test; a quantizer
    without a plan (``scripts/compare_kernels.py`` times older trees)
    runs a thread per block over every candidate."""
    if not hasattr(nq, "quantize_plan"):
        from repro_torch.core.quantize import candidates
        return flat.shape[0] * len(candidates(fmt)), "thread per block"
    return (int(nq.evaluated_candidates(flat, fmt).sum()),
            nq.quantize_plan(flat.shape[0], fmt.block_size).regime)


def check_quantizer(timer, rows, shape=(4096, 14336), key="nxfp_quantize"):
    """A weight cast (K, N) f32 -> nxfp4 blocks along K (padded to whole
    blocks), bitwise up to counted candidate near-ties."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.quantize import near_tie_blocks, to_blocks
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.decode_lib import decode_block_values
    from repro_torch.core.pack import unpack_codes

    fmt = get_format("nxfp4")
    gen = torch.Generator(device="cuda").manual_seed(1)
    w = torch.randn(shape, generator=gen, device="cuda") * 0.02
    xb, _ = to_blocks(w, fmt.block_size, -2)            # the weight cast
    flat = xb.reshape(-1, fmt.block_size).contiguous()
    kp, km = nq.nxfp_quantize_pack(flat, fmt)
    pp, pm = nq.nxfp_quantize_pack_plain(flat, fmt)
    torch.cuda.synchronize()
    diff = (kp != pp).any(dim=-1) | (km.to(torch.int32) != pm.to(torch.int32))
    n_diff = int(diff.sum())
    if n_diff:
        ties = near_tie_blocks(flat[diff], fmt)
        if not bool(ties.all()):
            fail(f"quantizer: {int((~ties).sum())} blocks differ from the "
                 "plain version beyond a candidate near-tie")

    def deq(p, m):
        return decode_block_values(unpack_codes(p, fmt.bits, 32), m, fmt)

    err = float((deq(kp, km) - deq(pp, pm)).abs().max())
    t = flat.shape[0]
    n_cands, regime = _quantizer_traits(nq, flat, fmt)
    n_bytes = t * 32 * 4 + t * fmt.bytes_per_block + t * 2
    n_ops = n_cands * 32 * QUANT_OPS
    ms = timer(lambda: nq.nxfp_quantize_pack(flat, fmt))
    plain_ms = timer(lambda: nq.nxfp_quantize_pack_plain(flat, fmt), 3)
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_F32)
    log(f"quantizer ({shape[0]}x{shape[1]} f32 weight, {t} blocks, {regime} "
        f"regime): packed+meta bitwise "
        f"except {n_diff} near-tie blocks; {n_cands / t:.4f} of 4 "
        f"candidates evaluated per block; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows[key] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, near_ties=n_diff,
        candidates_per_block=n_cands / t,
        shape=f"{tuple(shape)} f32 weight, {t} blocks of 32, nxfp4")


def check_act_quantizer(timer, rows):
    """amxfp4 over the W2 input of a 4 x 128 prefill: (512, 14336) bf16."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.pack import unpack_codes
    from repro_torch.core.quantize import (meta_int32, near_tie_blocks,
                                           to_blocks)
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.decode_lib import decode_block_values

    fmt = get_format("amxfp4")
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = (torch.randn((512, 14336), generator=gen, device="cuda")
         * torch.rand((512, 1), generator=gen, device="cuda")).to(
        torch.bfloat16)
    xb, _ = to_blocks(x, fmt.block_size, -1)
    flat = xb.reshape(-1, fmt.block_size).contiguous()       # bf16, no copy
    if not hasattr(nq, "quantize_plan"):     # a quantizer that reads f32 only
        flat = flat.float()
    kp, km = nq.nxfp_quantize_pack(flat, fmt)
    pp, pm = nq.nxfp_quantize_pack_plain(flat, fmt)
    torch.cuda.synchronize()
    if km.dtype != torch.uint32 or pm.dtype != torch.uint32:
        fail(f"activation quantizer: meta {km.dtype}/{pm.dtype}, not uint32")
    diff = (kp != pp).any(dim=-1) | (meta_int32(km) != meta_int32(pm))
    n_diff = int(diff.sum())
    if n_diff and not bool(near_tie_blocks(flat[diff], fmt).all()):
        fail(f"activation quantizer: {n_diff} blocks differ from the plain "
             "version, not all of them candidate near-ties")

    def deq(p, m):
        return decode_block_values(unpack_codes(p, fmt.bits, 32), m, fmt)

    err = float((deq(kp, km) - deq(pp, pm)).abs().max())
    t = flat.shape[0]
    n_cands, regime = _quantizer_traits(nq, flat, fmt)
    n_bytes = (t * 32 * flat.element_size() + t * fmt.bytes_per_block
               + t * 4)
    # asym: two sides (exponent, nano, reciprocal) and a sign select more
    n_ops = n_cands * 32 * (QUANT_OPS + 2)
    ms = timer(lambda: nq.nxfp_quantize_pack(flat, fmt))
    plain_ms = timer(lambda: nq.nxfp_quantize_pack_plain(flat, fmt), 3)
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_F32)
    log(f"activation quantizer (512x14336 bf16 activation read as "
        f"{flat.dtype}, {t} blocks, amxfp4, {regime} regime): "
        f"packed+uint32 meta bitwise except {n_diff} near-tie blocks; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    rows["nxfp_quantize amxfp4"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, near_ties=n_diff,
        shape=f"(512, 14336) bf16 activation read as {flat.dtype}, {t} "
              "blocks of 32, amxfp4")


# the K/V cache writes of the main path (Llama-3-8B's 8 KV heads of 128,
# B 4, max_len 256): a decode step at ragged rows and a 4 x 128 prefill;
# and H2O-Danube3-4B's (8 KV heads of 120, padded to 4 blocks of 32) into
# its 4096-row ring: a decode step at rows pos % 4096 and a 128-row chunk
# (T, rows, head_dim, S, KV heads)
KV_CASES = {"decode": (1, (128, 200, 17, 255), 128, 256, 8),
            "prefill": (128, None, 128, 256, 8),
            "decode danube": (1, (4095, 0, 17, 3000), 120, 4096, 8),
            "prefill danube": (128, None, 120, 4096, 8)}


def check_kv_write(timer, rows, cases=KV_CASES):
    """K and V encoded in one launch straight into the layer cache's rows,
    bitwise (up to counted near-ties) against the codec + row writes."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.pack import unpack_codes
    from repro_torch.core.quantize import near_tie_blocks, to_blocks
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.decode_lib import decode_block_values

    fmt = get_format("nxfp4")
    b = 4
    gen = torch.Generator(device="cuda").manual_seed(6)
    for case, (t, pos, hd, s, kvh) in cases.items():
        nb = -(-hd // fmt.block_size)
        k, v = (torch.randn((b, t, kvh, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        pos_t = (None if pos is None
                 else torch.tensor(pos, dtype=torch.int32, device="cuda"))

        def empty():
            return {f"{n}_{key}": torch.zeros(
                (b, s, kvh, nb) + tail, dtype=dt, device="cuda")
                for n in "kv" for key, tail, dt in (
                    ("packed", (fmt.bytes_per_block,), torch.uint8),
                    ("meta", (), torch.uint16))}

        cache, plain = empty(), empty()
        nq.nxfp_quantize_kv_rows(k, v, cache, pos_t, fmt)
        nq.nxfp_quantize_kv_rows_plain(k, v, plain, pos_t, fmt)
        torch.cuda.synchronize()
        n_diff, err, n_cands = 0, 0.0, 0
        at = (torch.arange(t, device="cuda")[None, :] if pos_t is None
              else pos_t[:, None] + torch.arange(t, device="cuda"))
        slots = torch.arange(b, device="cuda")[:, None]
        for n, x in (("k", k), ("v", v)):
            kp, km = cache[f"{n}_packed"], cache[f"{n}_meta"]
            pp, pm = plain[f"{n}_packed"], plain[f"{n}_meta"]
            diff = (kp != pp).any(-1) | (km.to(torch.int32)
                                         != pm.to(torch.int32))
            src = torch.zeros((b, s, kvh, nb * fmt.block_size),
                              device="cuda")
            src[slots, at, :, :hd] = x.float()
            xb, _ = to_blocks(src, fmt.block_size, -1)
            if diff.any() and not bool(near_tie_blocks(xb[diff], fmt).all()):
                fail(f"KV write ({case}): {int(diff.sum())} blocks differ "
                     "from the plain version beyond a candidate near-tie")
            n_diff += int(diff.sum())
            err = max(err, float((decode_block_values(
                unpack_codes(kp, fmt.bits, 32), km, fmt) - decode_block_values(
                unpack_codes(pp, fmt.bits, 32), pm, fmt)).abs().max()))
            n_cands += int(nq.evaluated_candidates(
                to_blocks(x, fmt.block_size, -1)[0].reshape(
                    -1, fmt.block_size), fmt).sum())
        n_blocks = 2 * b * t * kvh * nb
        ms = timer(lambda: nq.nxfp_quantize_kv_rows(k, v, cache, pos_t, fmt))
        plain_ms = timer(lambda: nq.nxfp_quantize_kv_rows_plain(
            k, v, plain, pos_t, fmt), 5)
        n_bytes = (2 * k.numel() * 2 + n_blocks * (fmt.bytes_per_block + 2)
                   + (0 if pos_t is None else b * 4))
        b_ms, b_by = bound(n_bytes, n_cands * 32 * QUANT_OPS, PEAK_F32)
        regime = nq.quantize_plan(n_blocks, fmt.block_size).regime
        log(f"KV write ({case}: K and V (4, {t}, {kvh}, {hd}) bf16 -> nxfp4 "
            f"cache rows {'0..' + str(t - 1) if pos is None else list(pos)}, "
            f"{n_blocks} blocks, one launch, {regime} regime): bitwise except "
            f"{n_diff} near-tie blocks; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        rows[f"nxfp_quantize kv {case}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, near_ties=n_diff,
            shape=f"K, V (4, {t}, {kvh}, {hd}) bf16 into an nxfp4 cache of {s} "
                  f"rows, {n_blocks} blocks")


def check_lane_kv_write(timer, rows):
    """The lane chunk's K/V write (phase 9's shape): K and V (1, 32, 8,
    128) bf16 into slot 2 of a 4-slot nxfp4 cache of 512 rows at rows
    224 + t, t < n_valid = 20 (a ragged final chunk), slot, offset and
    n_valid read on the device: bitwise (up to counted near-ties) against
    the codec + row writes, every other row and slot as it was."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.pack import unpack_codes
    from repro_torch.core.quantize import near_tie_blocks, to_blocks
    from repro_torch.kernels import build
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.decode_lib import decode_block_values

    fmt = get_format("nxfp4")
    cb, s, kvh, hd, p, slot, off, n_valid = 4, 512, 8, 128, 32, 2, 224, 20
    nb = hd // fmt.block_size
    gen = torch.Generator(device="cuda").manual_seed(7)
    k, v = (torch.randn((1, p, kvh, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    cache = {f"{n}_{key}": torch.randint(
        0, 200, (cb, s, kvh, nb) + tail, generator=gen, device="cuda",
        dtype=torch.int32).to(dt) for n in "kv" for key, tail, dt in (
            ("packed", (fmt.bytes_per_block,), torch.uint8),
            ("meta", (), torch.uint16))}
    before = {n: a.clone() for n, a in cache.items()}
    plain = {n: a.clone() for n, a in cache.items()}
    idx = torch.tensor([slot, off, n_valid], dtype=torch.int32,
                       device="cuda")
    args = dict(slot=idx[0:1], n_valid=idx[2:3])
    nq.nxfp_quantize_kv_rows(k, v, cache, idx[1:2], fmt, **args)
    nq.nxfp_quantize_kv_rows_plain(k, v, plain, idx[1:2], fmt, **args)
    torch.cuda.synchronize()
    n_diff, err = 0, 0.0
    for n, x in (("k", k), ("v", v)):
        kp, km = cache[f"{n}_packed"], cache[f"{n}_meta"]
        pp, pm = plain[f"{n}_packed"], plain[f"{n}_meta"]
        diff = (kp != pp).any(-1) | (km != pm)
        err = max(err, float((decode_block_values(
            unpack_codes(kp, fmt.bits, 32), km, fmt) - decode_block_values(
            unpack_codes(pp, fmt.bits, 32), pm, fmt)).abs().max()))
        src = torch.zeros((cb, s, kvh, hd), device="cuda")
        src[slot, off:off + n_valid] = x[0, :n_valid].float()
        xb, _ = to_blocks(src, fmt.block_size, -1)
        if diff.any() and not bool(near_tie_blocks(xb[diff], fmt).all()):
            fail(f"KV write (lane): {int(diff.sum())} blocks differ from "
                 "the plain version beyond a candidate near-tie")
        n_diff += int(diff.sum())
    kept = torch.ones((cb, s), dtype=torch.bool, device="cuda")
    kept[slot, off:off + n_valid] = False
    if not all(torch.equal(build.bit_view(cache[n])[kept],
                           build.bit_view(before[n])[kept]) for n in cache):
        fail("KV write (lane): a row outside the chunk's valid rows changed")
    n_blocks = 2 * n_valid * kvh * nb
    n_cands = sum(int(nq.evaluated_candidates(
        x[0, :n_valid].reshape(-1, fmt.block_size), fmt).sum())
        for x in (k, v))
    ms = timer(lambda: nq.nxfp_quantize_kv_rows(k, v, cache, idx[1:2], fmt,
                                                **args))
    plain_ms = timer(lambda: nq.nxfp_quantize_kv_rows_plain(
        k, v, plain, idx[1:2], fmt, **args), 5)
    n_bytes = 2 * n_valid * kvh * hd * 2 + n_blocks * (
        fmt.bytes_per_block + 2) + 12
    b_ms, b_by = bound(n_bytes, n_cands * 32 * QUANT_OPS, PEAK_F32)
    log(f"KV write (lane chunk: K and V (1, {p}, 8, 128) bf16 -> slot "
        f"{slot} of a {cb}-slot nxfp4 cache, rows {off}..{off + n_valid - 1}"
        f" (n_valid {n_valid}), one launch): bitwise except {n_diff} "
        f"near-tie blocks, other rows and slots untouched; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    rows["nxfp_quantize kv lane"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, near_ties=n_diff,
        shape=f"K, V (1, {p}, 8, 128) bf16 into slot {slot} of a (4, 512) "
              f"nxfp4 cache, {n_valid} valid rows, {n_blocks} blocks")


def check_paged_kv_write(timer, rows, cases=None):
    """The quantizer writing through a block table (the paged cache,
    phase 12's shapes): decode rows of 8 slots (one slot's row on a null
    page, one not live: row S) and a lane chunk (1, 32) at rows 48 + t, t
    < n_valid = 20, of slot 2, whose last 4 valid rows (64-67) fall on a
    null page, into a 129-page pool of 32 rows: bitwise (up to counted
    near-ties) against the plain version, every other pool row (the null
    page included) as it was; its time beside the unpaged write of the
    same rows into a (8, 2048) cache. ``cases`` ({name: (rows a slot,
    pos, slot, n_valid)}) replaces the two (phase 15's verify rows)."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.pack import unpack_codes
    from repro_torch.core.quantize import near_tie_blocks, to_blocks
    from repro_torch.kernels import build
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.decode_lib import decode_block_values

    fmt = get_format("nxfp4")
    cb, n_pages, page, tw, kvh, hd = 8, PAGED_POOL_PAGES, PAGED_PAGE, \
        PAGED_MAX_LEN // PAGED_PAGE, 8, 128
    nb = hd // fmt.block_size
    gen = torch.Generator(device="cuda").manual_seed(12)
    # slot s holds pages 1 + 16 s .. 16 s + 16, bar two null entries:
    # slot 1's third page (a decode row) and slot 2's (the chunk's tail)
    table = torch.zeros((cb, tw), dtype=torch.int32)
    for s in range(cb):
        table[s, :16] = torch.arange(1 + 16 * s, 17 + 16 * s)
    table[1, 2] = 0
    table[2, 2] = 0
    table = table.cuda()

    def pool():
        return {f"pool_{n}_{key}": torch.randint(
            0, 200, (n_pages, page, kvh, nb) + tail, generator=gen,
            device="cuda", dtype=torch.int32).to(dt)
            for n in "kv" for key, tail, dt in (
                ("packed", (fmt.bytes_per_block,), torch.uint8),
                ("meta", (), torch.uint16))}

    if cases is None:
        cases = {
            # pos per slot: 300 / 70 (slot 1's null page) / S (not live) /
            "decode": (1, [300, 70, PAGED_MAX_LEN, 17, 255, 480, 3, 511],
                       None, None),
            "chunk": (32, [48], 2, 20)}
    for case, (t, pos, slot, n_valid) in cases.items():
        b = len(pos)
        # rows of b slots (decode, verify) read the table's first b rows
        blk = table if slot is not None else table[:b]
        ncb = blk.shape[0]
        k, v = (torch.randn((b, t, kvh, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        args = {}
        if slot is not None:
            args = dict(slot=torch.tensor([slot], dtype=torch.int32,
                                          device="cuda"),
                        n_valid=torch.tensor([n_valid], dtype=torch.int32,
                                             device="cuda"))
        cache = pool()
        before = {n: a.clone() for n, a in cache.items()}
        plain = {n: a.clone() for n, a in cache.items()}
        nq.nxfp_quantize_kv_rows(k, v, cache, pos_t, fmt, block=blk,
                                 **args)
        nq.nxfp_quantize_kv_rows_plain(k, v, plain, pos_t, fmt,
                                       block=blk, **args)
        torch.cuda.synchronize()
        # the rows the write owns: (page, row in page) of each valid row
        owned = torch.zeros((n_pages, page), dtype=torch.bool,
                            device="cuda")
        src = {n: torch.zeros((n_pages, page, kvh, hd), device="cuda")
               for n in "kv"}
        for bi in range(b):
            sl = bi if slot is None else slot
            for ti in range(t if n_valid is None else n_valid):
                r = pos[bi] + ti
                if not 0 <= r < PAGED_MAX_LEN:
                    continue
                pg = int(blk[sl, r // page])
                if pg:
                    owned[pg, r % page] = True
                    src["k"][pg, r % page] = k[bi, ti].float()
                    src["v"][pg, r % page] = v[bi, ti].float()
        n_diff, err = 0, 0.0
        for n in "kv":
            pk, pm = cache[f"pool_{n}_packed"], cache[f"pool_{n}_meta"]
            qk, qm = plain[f"pool_{n}_packed"], plain[f"pool_{n}_meta"]
            diff = (pk != qk).any(-1) | (build.bit_view(pm)
                                         != build.bit_view(qm))
            xb, _ = to_blocks(src[n], fmt.block_size, -1)
            if diff.any() and not bool(near_tie_blocks(xb[diff], fmt).all()):
                fail(f"paged KV write ({case}): {int(diff.sum())} blocks "
                     "differ from the plain version beyond a near-tie")
            n_diff += int(diff.sum())
            err = max(err, float((decode_block_values(
                unpack_codes(pk, fmt.bits, 32), pm, fmt)
                - decode_block_values(unpack_codes(qk, fmt.bits, 32), qm,
                                      fmt)).abs().max()))
        if owned[0].any() or not all(
                torch.equal(build.bit_view(cache[n])[~owned],
                            build.bit_view(before[n])[~owned])
                for n in cache):
            fail(f"paged KV write ({case}): a row it does not own changed")
        n_rows = int(owned.sum())
        n_blocks = 2 * n_rows * kvh * nb
        n_cands = sum(int(nq.evaluated_candidates(
            to_blocks(src[n][owned], fmt.block_size, -1)[0].reshape(
                -1, fmt.block_size), fmt).sum()) for n in "kv")
        ms = timer(lambda: nq.nxfp_quantize_kv_rows(
            k, v, cache, pos_t, fmt, block=blk, **args))
        plain_ms = timer(lambda: nq.nxfp_quantize_kv_rows_plain(
            k, v, plain, pos_t, fmt, block=blk, **args), 5)
        # the same rows into an unpaged (ncb, 2048) cache, for comparison
        dense = {f"{n}_{key}": torch.zeros(
            (ncb, PAGED_MAX_LEN, kvh, nb) + tail, dtype=dt, device="cuda")
            for n in "kv" for key, tail, dt in (
                ("packed", (fmt.bytes_per_block,), torch.uint8),
                ("meta", (), torch.uint16))}
        unpaged_ms = timer(lambda: nq.nxfp_quantize_kv_rows(
            k, v, dense, pos_t, fmt, **args))
        n_bytes = (2 * n_rows * kvh * hd * 2 + n_blocks * (
            fmt.bytes_per_block + 2) + 4 * (b + n_rows))
        b_ms, b_by = bound(n_bytes, n_cands * 32 * QUANT_OPS, PEAK_F32)
        log(f"paged KV write ({case}: K and V ({b}, {t}, 8, 128) bf16 "
            f"through a ({ncb}, {tw}) block table into a {n_pages}-page "
            f"nxfp4 pool of {page} rows, {n_rows} rows written, null-page "
            f"and dropped rows skipped, one launch): bitwise except {n_diff} "
            f"near-tie blocks, every other row untouched; kernel {ms:.4f} "
            f"ms, unpaged {unpaged_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
        rows[f"nxfp_quantize kv paged {case}"] = dict(
            max_abs_err=err, ms=ms,
            unpaged_ms=unpaged_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, near_ties=n_diff,
            shape=f"K, V ({b}, {t}, 8, 128) bf16 through a ({ncb}, {tw}) "
                  f"table into a {n_pages} x {page}-row nxfp4 pool, "
                  f"{n_rows} rows written")


# the qq GEMM's rows: a 4 x 128 prefill (the wgmma regime), 32 rows (the
# economy tier's lane chunk in phase 10, ``TIER_P``, and its shortest
# prompt: one partial wgmma M tile) and 16 rows (the split-K streaming
# regime, the most a decode-regime call takes), at every projection's
# (K, N) pair of the economy prefill (``MATMUL_KN``)
QQ_M = (16, 32, 512)


def check_qq_matmul(timer, rows, pairs=None, row_counts=QQ_M):
    """amxfp4 activations x nxfp4 weights at the (K, N) pairs (default
    ``MATMUL_KN``, the four projections') and ``row_counts`` rows, held to
    the bits of ``nxfp_matmul`` fed the plain-decoded X (the kernel runs
    that GEMM on its own decode of X)."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import nxfp_matmul as nm
    from repro_torch.kernels import nxfp_qq_matmul as nqq
    from repro_torch.kernels.ops import quantize_qtensor

    x_fmt, w_fmt = get_format("amxfp4"), get_format("nxfp4")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for k, n in pairs or MATMUL_KN:
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        wq = quantize_qtensor(w, w_fmt, axis=-2, device="cuda")
        del w
        wd = nm.dequant_weight_bf16(wq.packed, wq.meta, w_fmt)   # (N, K)
        for m in row_counts:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            xq = quantize_qtensor(x, x_fmt, axis=-1, device="cuda")
            args = (xq.packed, xq.meta, wq.packed, wq.meta, x_fmt, w_fmt)
            y = nqq.nxfp_qq_matmul(*args)
            again = nqq.nxfp_qq_matmul(*args)
            y_plain = nqq.nxfp_qq_matmul_plain(*args)
            xd = nm.dequant_weight_bf16(xq.packed, xq.meta, x_fmt)  # (M, K)
            mag = xd.float().abs() @ wd.float().abs().T
            err = float((y - y_plain).abs().max())
            rel = float(((y - y_plain).abs() / mag.clamp(min=1e-30)).max())
            # both sum exact bf16 products in f32, in different orders
            if not (torch.isfinite(y).all() and rel <= 1e-5):
                fail(f"qq matmul M={m} K={k} N={n}: error {rel:.3g} of "
                     "sum|x||w| exceeds 1e-5")
            if not torch.equal(y, again):
                fail(f"qq matmul M={m} K={k} N={n}: a second launch gave "
                     "other bits")
            if not torch.equal(y, nm.nxfp_matmul(xd, wq.packed, wq.meta,
                                                  w_fmt)):
                fail(f"qq matmul M={m} K={k} N={n}: not the bits of "
                     "nxfp_matmul on the plain-decoded X")
            ms = timer(lambda: nqq.nxfp_qq_matmul(*args))
            plain_ms = timer(lambda: nqq.nxfp_qq_matmul_plain(*args), 5)
            lib_ms = timer(lambda: torch.matmul(xd, wd.T))
            n_bytes = (xq.packed.numel() + xq.meta.numel() * 4
                       + wq.packed.numel() + wq.meta.numel() * 2 + m * n * 4)
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, PEAK_BF16)
            log(f"qq matmul M={m} K={k} N={n} (amxfp4 x nxfp4): max err "
                f"{err:.3g} ({rel:.3g} of sum|x||w|), bitwise on a second "
                f"launch and equal to nxfp_matmul on the decoded X; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul of the "
                f"bf16-dequantized operands {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}, {n_bytes} bytes)")
            rows[f"nxfp_qq_matmul M={m} K={k} N={n}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"amxfp4 X ({m}, {k}) x nxfp4 W ({k}, {n})")


# the dequant GEMM's (K, N) pairs on the Llama-3-8B main path (wq/wo,
# wk/wv, w1/w3, w2) and its rows: two decode batches (the split-K
# streaming regime) and a 4 x 128 prefill (the wgmma regime)
MATMUL_KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
MATMUL_M = (4, 16, 512)
# the (K, N) pairs the dense family adds (phase 11's models), at a decode
# batch and a prefill: Llama-2-7B's w1/w3 and w2 (d_ff 11008: 344 blocks
# of 32, 86 K tiles of 128), StarCoder2-3B's wq/wo, wk/wv (N 256), w1/w3
# and w2, H2O-Danube3-4B's wq/wo (K 3840), wk/wv (N 960: 7.5 N tiles of
# 128), w1/w3 and w2
FAMILY_KN = ((4096, 11008), (11008, 4096), (3072, 3072), (3072, 256),
             (3072, 12288), (12288, 3072), (3840, 3840), (3840, 960),
             (3840, 10240), (10240, 3840))
FAMILY_M = (4, 512)


def check_matmul(timer, rows, pairs=MATMUL_KN, row_counts=MATMUL_M):
    """The dequant GEMM at each (K, N) and M: x (M, K) bf16 (zero-padded to
    the weight's blocks where quantization padded K, as ``ops.qmatmul``
    pads it) against its plain version, bitwise on a second launch."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import nxfp_matmul as nm
    from repro_torch.kernels.ops import quantize_qtensor

    fmt = get_format("nxfp4")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for k, n in pairs:
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        wq = quantize_qtensor(w, fmt, axis=-2, device="cuda")
        del w
        wd = nm.dequant_weight_bf16(wq.packed, wq.meta, fmt)     # (N, K)
        for m in row_counts:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            x = torch.nn.functional.pad(x, (0, wd.shape[1] - k))
            y = nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
            again = nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
            y_plain = nm.nxfp_matmul_plain(x, wq.packed, wq.meta, fmt)
            mag = x.float().abs() @ wd.float().abs().T
            err = float((y - y_plain).abs().max())
            rel = float(((y - y_plain).abs() / mag.clamp(min=1e-30)).max())
            # both sum exact bf16 products in f32, in different orders
            if not rel <= 1e-5:
                fail(f"qmatmul M={m} K={k} N={n}: error {rel:.3g} of "
                     "sum|x||w| exceeds 1e-5")
            # split-K partials are summed in split order, never by atomics
            if not torch.equal(y, again):
                fail(f"qmatmul M={m} K={k} N={n}: a second launch gave "
                     "other bits")
            ms = timer(lambda: nm.nxfp_matmul(x, wq.packed, wq.meta, fmt))
            plain_ms = timer(
                lambda: nm.nxfp_matmul_plain(x, wq.packed, wq.meta, fmt), 5)
            lib_ms = timer(lambda: torch.matmul(x, wd.T))
            n_bytes = (wq.packed.numel() + wq.meta.numel() * 2 + m * k * 2
                       + m * n * 4)
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, PEAK_BF16)
            regime = ("split-K streaming" if m <= nm.decode_geometry().max_m
                      else "wgmma")
            log(f"qmatmul M={m} K={k} N={n} ({regime}): max err {err:.3g} "
                f"({rel:.3g} of sum|x||w|), bitwise on a second launch; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
                f"bf16 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            key = f"nxfp_matmul M={m} K={k} N={n}"
            rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             shape=f"x ({m}, {k}) bf16 @ nxfp4 W ({k}, {n})")


# decode attention's shapes: Llama-3-8B's heads (8 KV heads, G 4, D 128)
# at B 4, the main path's cache (max_len 256), the continuous path's (512)
# and a long one (S 4096), ragged lengths; then the dense family's heads:
# Llama-2-7B's (32 KV heads, G 1), StarCoder2-3B's (2 KV heads, G 12) and
# H2O-Danube3-4B's (head_dim 120, padded to 4 blocks) over its 4096-row
# ring
LLAMA_HEADS = (8, 4, 128)
ATTENTION_CASES = ((LLAMA_HEADS, 256, (256, 200, 131, 17)),
                   (LLAMA_HEADS, 512, (512, 300, 131, 17)),
                   (LLAMA_HEADS, 4096, (4096, 3001, 1024, 17)),
                   ((32, 1, 128), 512, (512, 300, 131, 17)),
                   ((2, 12, 128), 512, (512, 300, 131, 17)),
                   ((8, 4, 120), 4096, (4096, 3001, 1024, 17)))


def _attention_key(name, heads, s):
    if heads == LLAMA_HEADS:
        return name + ("" if s == 256 else f" S={s}")
    kvh, g, d = heads
    return f"{name} KVH={kvh} G={g} D={d} S={s}"


def _sdpa_yardstick(q, k, v, lengths):
    """One SDPA call over f32 K/V (B, S, KVH, D), one query token a head:
    the library's time for the same function (the port never calls it).
    Returns (run, out)."""
    import torch.nn.functional as F
    b, kvh, g, d = q.shape
    s = k.shape[1]
    qh = q.reshape(b, kvh * g, 1, d)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    mask = (torch.arange(s, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]

    def run():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              scale=1.0)
    return run, run().reshape(q.shape)


def check_attention(timer, rows, cases=ATTENTION_CASES):
    import torch.nn.functional as F
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import nxfp_attention as na
    from repro_torch.kernels.ops import quantize_qtensor

    fmt = get_format("nxfp4")
    b = 4
    gen = torch.Generator(device="cuda").manual_seed(3)
    for (kvh, g, hd), s, lens in cases:
        k = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        v = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        kq = quantize_qtensor(k, fmt, axis=-1, device="cuda")
        vq = quantize_qtensor(v, fmt, axis=-1, device="cuda")
        del k, v
        # head_dim 120 is cast in 4 blocks of 32: q padded as
        # ops.decode_attention pads it
        d = kq.packed.shape[-2] * fmt.block_size
        q = F.pad(torch.randn((b, kvh, g, hd), generator=gen, device="cuda")
                  * hd ** -0.5, (0, d - hd))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (q, kq.packed, kq.meta, vq.packed, vq.meta, lengths, fmt)
        out = na.nxfp_decode_attention(*args)
        again = na.nxfp_decode_attention(*args)
        ref = na.nxfp_decode_attention_plain(*args)
        kd = na.dequant_cache(kq.packed, kq.meta, fmt)      # (B, S, KVH, D)
        vd = na.dequant_cache(vq.packed, vq.meta, fmt)
        err = float((out - ref).abs().max())
        # f32 online softmax and dots in another order than the one-pass
        # plain version: 1e-5 of the largest |V|
        if not err <= 1e-5 * float(vd.abs().max()):
            fail(f"decode attention S={s}: max error {err:.3g} exceeds "
                 "1e-5 max|V|")
        # the split partials are merged in split order, never by atomics
        if not torch.equal(out, again):
            fail(f"decode attention S={s}: a second launch gave other bits")
        # yardstick: SDPA over pre-dequantized K/V, one query token per head
        lib, lib_out = _sdpa_yardstick(q, kd, vd, lengths)
        del kd, vd
        lib_err = float((lib_out - ref).abs().max())
        ms = timer(lambda: na.nxfp_decode_attention(*args))
        plain_ms = timer(lambda: na.nxfp_decode_attention_plain(*args), 5)
        lib_ms = timer(lib)
        del lib
        tot = int(lengths.sum())
        nb = d // 32
        n_bytes = (q.numel() * 4
                   + 2 * tot * kvh * nb * (fmt.bytes_per_block + 2)
                   + b * 4 + out.numel() * 4)
        n_ops = 2 * 2 * tot * kvh * g * d              # QK^T and PV, f32
        b_ms, b_by = bound(n_bytes, n_ops, PEAK_F32)
        log(f"decode attention B={b} KVH={kvh} G={g} D={d} (head_dim {hd}) "
            f"S={s} lengths {list(lens)}: max err {err:.3g} (SDPA "
            f"{lib_err:.3g}), bitwise on a second launch; kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, SDPA f32 {lib_ms:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by})")
        rows[_attention_key("nxfp_decode_attention", (kvh, g, hd), s)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms,
            shape=f"q ({b}, {kvh}, {g}, {d}), nxfp4 K/V S={s}, "
                  f"lengths {list(lens)}")
        torch.cuda.empty_cache()


def check_dense_attention(timer, rows, cases=None):
    """The dense-row instance of the attention kernel (bf16 K/V, no
    padding of head_dim) at every head shape of ``ATTENTION_CASES`` but
    S 256 (or at ``cases``): within 1e-5 of max|V| of its plain version
    (the reference's einsum), bitwise on a second launch, and row 0's bits
    the same at B 1, 4 and 8 (the decode batch of a continuous engine's
    slots)."""
    from repro_torch.kernels import dense_attention as da

    gen = torch.Generator(device="cuda").manual_seed(13)
    if cases is None:
        cases = [c for c in ATTENTION_CASES if c[1] != 256]
    for (kvh, g, d), s, lens in cases:
        b = 8
        k, v = (torch.randn((b, s, kvh, d), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        q = torch.randn((b, kvh, g, d), generator=gen, device="cuda") \
            * d ** -0.5
        lengths = torch.tensor(lens + (s, 77, 1, 250), dtype=torch.int32,
                               device="cuda")
        args4 = (q[:4], k[:4], v[:4], lengths[:4])
        out = da.dense_decode_attention(*args4)
        again = da.dense_decode_attention(*args4)
        ref = da.dense_decode_attention_plain(*args4)
        err = float((out - ref).abs().max())
        if not err <= 1e-5 * float(v[:4].float().abs().max()):
            fail(f"dense decode attention KVH={kvh} G={g} D={d} S={s}: "
                 f"max error {err:.3g} exceeds 1e-5 max|V|")
        if not torch.equal(out, again):
            fail(f"dense decode attention KVH={kvh} G={g} D={d} S={s}: a "
                 "second launch gave other bits")
        row0 = {bb: da.dense_decode_attention(
            q[:bb], k[:bb], v[:bb], lengths[:bb])[0] for bb in (1, 4, 8)}
        moved = {bb: int((row0[bb] != row0[1]).sum()) for bb in (4, 8)}
        if any(moved.values()):
            fail(f"dense decode attention KVH={kvh} G={g} D={d} S={s}: row "
                 f"0 moves with the batch ({moved} of {row0[1].numel()} "
                 f"outputs at B 4, 8 against B 1)")
        lib, lib_out = _sdpa_yardstick(q[:4], k[:4].float(), v[:4].float(),
                                       lengths[:4])
        lib_err = float((lib_out - ref).abs().max())
        ms = timer(lambda: da.dense_decode_attention(*args4))
        plain_ms = timer(lambda: da.dense_decode_attention_plain(*args4), 5)
        lib_ms = timer(lib)
        del lib
        tot = int(lengths[:4].sum())
        n_bytes = q[:4].numel() * 4 + 2 * tot * kvh * d * 2 + 16 \
            + out.numel() * 4
        b_ms, b_by = bound(n_bytes, 2 * 2 * tot * kvh * g * d, PEAK_F32)
        log(f"dense decode attention B=4 KVH={kvh} G={g} D={d} S={s} "
            f"lengths {list(lens)}: max err {err:.3g} (SDPA {lib_err:.3g}), "
            f"bitwise on a second launch, row 0 the same bits at B 1/4/8; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA f32 "
            f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        rows[_attention_key("dense_decode_attention", (kvh, g, d), s)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms,
            shape=f"q (4, {kvh}, {g}, {d}), bf16 K/V S={s}, lengths "
                  f"{list(lens)}")
        del k, v
        torch.cuda.empty_cache()


# the bf16 GEMM's route (``ops._dense_matmul``, cuBLAS on 128-row tiles
# above 16 rows): rows at these M against the same rows at M 512, and its
# time at a lane chunk and a prefill against one torch.matmul
DENSE_GEMM_M = (17, 32, 200)
DENSE_GEMM_TIMED = (32, 512)
# the bf16 heads that stay dense (Llama-3-8B's on every decode step of
# phase 5, Hymba's): up to 16 rows the route is one product on exactly 16
# rows, zero-padded, timed at a decode batch beside one torch.mm of the
# unpadded rows (the route before the pad)
DENSE_HEADS = {"llama3_8b lm_head": (4096, 128256),
               "hymba lm_head": (1600, 32001)}
DENSE_HEAD_M = (1, 4)


def check_dense_gemm(timer, rows):
    """Not a kernel of the port (the reference leaves the product to XLA):
    the premium tier's projections and the dense heads. A row's bits must
    not follow M; its time beside one torch.matmul of the same operands."""
    from repro_torch.kernels.ops import _dense_matmul

    gen = torch.Generator(device="cuda").manual_seed(14)
    for k, n in MATMUL_KN:
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        x = torch.randn((512, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        ref = _dense_matmul(x, w)
        moved = {m: int((_dense_matmul(x[:m], w) != ref[:m]).sum())
                 for m in DENSE_GEMM_M}
        if any(moved.values()):
            fail(f"dense GEMM K={k} N={n}: rows differ from M 512's at "
                 f"{moved}")
        for m in DENSE_GEMM_TIMED:
            xm = x[:m].contiguous()
            ms = timer(lambda: _dense_matmul(xm, w))
            lib_ms = timer(lambda: torch.mm(xm, w, out_dtype=torch.float32))
            n_bytes = k * n * 2 + m * k * 2 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, PEAK_BF16)
            log(f"dense GEMM route M={m} K={k} N={n} (cuBLAS on 128-row "
                f"tiles): rows at M {list(DENSE_GEMM_M)} bitwise M 512's; "
                f"{ms:.4f} ms, one torch.mm {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
            rows[f"dense_gemm M={m} K={k} N={n}"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=None, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"x ({m}, {k}) bf16 @ W ({k}, {n}) bf16, f32 out")
        del w, x
        torch.cuda.empty_cache()
    for name, (k, n) in DENSE_HEADS.items():
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        x = torch.randn((16, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        ref = _dense_matmul(x, w)
        moved = {m: int((_dense_matmul(x[:m], w) != ref[:m]).sum())
                 for m in DENSE_HEAD_M}
        if any(moved.values()):
            fail(f"dense GEMM {name}: rows differ from M 16's at {moved}")
        for m in DENSE_HEAD_M:
            xm = x[:m].contiguous()
            ms = timer(lambda: _dense_matmul(xm, w))
            lib_ms = timer(lambda: torch.mm(xm, w, out_dtype=torch.float32))
            n_bytes = k * n * 2 + m * k * 2 + m * n * 4
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, PEAK_BF16)
            log(f"dense GEMM route {name} M={m} K={k} N={n} (one cuBLAS "
                f"product on 16 rows): rows at M {list(DENSE_HEAD_M)} "
                f"bitwise M 16's; {ms:.4f} ms, one torch.mm of the {m} rows "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            rows[f"dense_gemm {name} M={m} K={k} N={n}"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=None, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"x ({m}, {k}) bf16 @ W ({k}, {n}) bf16, f32 out, "
                      f"run on 16 rows")
        del w, x
        torch.cuda.empty_cache()


# the formats the reference serves beyond the main path's (phase 3's wide
# rows): 3-bit codes, block sizes 8/64/128, and a custom recycle value from
# Fig. 11's sweep (benchmarks/fig11_remap_sweep.py: the midpoint of
# mxfp4's two largest levels, 5.0, one of the two best remaps it finds),
# and nxfp6, the standard tier's weights in phase 10
WIDE_FMTS = ("nxfp3", "nxfp4_bs8", "nxfp4_bs64", "nxfp4_bs128",
             "mxfp4_cr@5.0", "nxfp6")
# the activation format each weight format's qq row pairs with (one block
# size for both operands)
WIDE_QQ_ACT = {"nxfp3": "amxfp3", "nxfp4_bs8": "amxfp4_bs8",
               "nxfp4_bs64": "amxfp4_bs64", "nxfp4_bs128": "amxfp4_bs128",
               "mxfp4_cr@5.0": "amxfp4", "nxfp6": "amxfp6"}
# the decode regime, a lane chunk (phase 10's ``TIER_P``: one partial
# wgmma M tile) and a 4 x 128 prefill
WIDE_MATMUL_M = (4, 32, 512)


def wide_format(name):
    """A registry format, or ``base@value``: ``base`` with that recycle
    value."""
    from repro_torch.core.formats import get_format
    if "@" not in name:
        return get_format(name)
    base, value = name.split("@")
    return dataclasses.replace(get_format(base), recycle=float(value),
                               name=name)


def check_wide_formats(timer, rows):
    """Every kernel at the formats of ``WIDE_FMTS`` (the generic kernel
    instances and the quantizer's 3-bit, block-size and custom-recycle
    instances), at Llama-3-8B shapes, against its plain version: the
    quantizer bitwise on the w1/w3 weight cast (up to counted near-ties),
    the dequant GEMM (K 4096, N 14336, M of ``WIDE_MATMUL_M``), decode
    attention (S 256) and the qq GEMM (M 512) bitwise on a second launch
    and within the main path's tolerances."""
    import torch.nn.functional as F
    from repro_torch.core.pack import unpack_codes
    from repro_torch.core.quantize import meta_int32, near_tie_blocks
    from repro_torch.core.quantize import to_blocks
    from repro_torch.kernels import nxfp_attention as na
    from repro_torch.kernels.decode_lib import decode_block_values
    from repro_torch.kernels import nxfp_matmul as nm
    from repro_torch.kernels import nxfp_qq_matmul as nqq
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.ops import quantize_qtensor

    gen = torch.Generator(device="cuda").manual_seed(7)
    k, n = 4096, 14336
    for name in WIDE_FMTS:
        fmt = wide_format(name)
        bs = fmt.block_size
        # the weight cast (axis 0 of the (K, N) weight)
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        xb, _ = to_blocks(w, bs, -2)
        flat = xb.reshape(-1, bs).contiguous()
        kp, km = nq.nxfp_quantize_pack(flat, fmt)
        pp, pm = nq.nxfp_quantize_pack_plain(flat, fmt)
        torch.cuda.synchronize()
        diff = (kp != pp).any(-1) | (meta_int32(km) != meta_int32(pm))
        n_diff = int(diff.sum())
        if n_diff and not bool(near_tie_blocks(flat[diff], fmt).all()):
            fail(f"quantizer {name}: {n_diff} blocks differ from the plain "
                 "version, not all of them candidate near-ties")
        err = float((decode_block_values(unpack_codes(kp, fmt.bits, bs), km,
                                         fmt)
                     - decode_block_values(unpack_codes(pp, fmt.bits, bs), pm,
                                           fmt)).abs().max())
        t = flat.shape[0]
        n_cands, regime = _quantizer_traits(nq, flat, fmt)
        ms = timer(lambda: nq.nxfp_quantize_pack(flat, fmt))
        plain_ms = timer(lambda: nq.nxfp_quantize_pack_plain(flat, fmt), 3)
        b_ms, b_by = bound(t * bs * 4 + t * (fmt.bytes_per_block + 2),
                           n_cands * bs * QUANT_OPS, PEAK_F32)
        log(f"wide quantizer {name} (4096x14336 f32 weight, {t} blocks of "
            f"{bs}, {regime} regime): bitwise except {n_diff} near-tie "
            f"blocks; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        rows[f"nxfp_quantize {name}"] = dict(
            max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            near_ties=n_diff, fmt=name,
            shape=f"(4096, 14336) f32 weight, {t} blocks of {bs}")
        del flat, xb, kp, km, pp, pm
        # the dequant GEMM on that weight
        wq = quantize_qtensor(w, fmt, axis=-2, device="cuda")
        del w
        wd = nm.dequant_weight_bf16(wq.packed, wq.meta, fmt)     # (N, K)
        for m in WIDE_MATMUL_M:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            y = nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
            again = nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
            y_plain = nm.nxfp_matmul_plain(x, wq.packed, wq.meta, fmt)
            mag = x.float().abs() @ wd.float().abs().T
            err = float((y - y_plain).abs().max())
            rel = float(((y - y_plain).abs() / mag.clamp(min=1e-30)).max())
            if not rel <= 1e-5:
                fail(f"qmatmul {name} M={m}: error {rel:.3g} of sum|x||w| "
                     "exceeds 1e-5")
            if not torch.equal(y, again):
                fail(f"qmatmul {name} M={m}: a second launch gave other bits")
            ms = timer(lambda: nm.nxfp_matmul(x, wq.packed, wq.meta, fmt))
            plain_ms = timer(
                lambda: nm.nxfp_matmul_plain(x, wq.packed, wq.meta, fmt), 3)
            lib_ms = timer(lambda: torch.matmul(x, wd.T))
            n_bytes = (wq.packed.numel() + wq.meta.numel() * 2 + m * k * 2
                       + m * n * 4)
            b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, PEAK_BF16)
            log(f"wide qmatmul {name} M={m} K={k} N={n}: max err {err:.3g} "
                f"({rel:.3g} of sum|x||w|), bitwise on a second launch; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
                f"bf16 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            rows[f"nxfp_matmul {name} M={m} K={k} N={n}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, fmt=name,
                shape=f"x ({m}, {k}) bf16 @ {name} W ({k}, {n})")
        # the qq GEMM, an activation format of the same block size
        x_fmt = wide_format(WIDE_QQ_ACT[name])
        m = 512
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        xq = quantize_qtensor(x, x_fmt, axis=-1, device="cuda")
        args = (xq.packed, xq.meta, wq.packed, wq.meta, x_fmt, fmt)
        y = nqq.nxfp_qq_matmul(*args)
        if not torch.equal(y, nqq.nxfp_qq_matmul(*args)):
            fail(f"qq matmul {x_fmt.name} x {name}: a second launch gave "
                 "other bits")
        y_plain = nqq.nxfp_qq_matmul_plain(*args)
        xd = nm.dequant_weight_bf16(xq.packed, xq.meta, x_fmt)
        mag = xd.float().abs() @ wd.float().abs().T
        err = float((y - y_plain).abs().max())
        rel = float(((y - y_plain).abs() / mag.clamp(min=1e-30)).max())
        if not (torch.isfinite(y).all() and rel <= 1e-5):
            fail(f"qq matmul {x_fmt.name} x {name}: error {rel:.3g} of "
                 "sum|x||w| exceeds 1e-5")
        if not torch.equal(y, nm.nxfp_matmul(xd, wq.packed, wq.meta, fmt)):
            fail(f"qq matmul {x_fmt.name} x {name}: not the bits of "
                 "nxfp_matmul on the plain-decoded X")
        ms = timer(lambda: nqq.nxfp_qq_matmul(*args))
        plain_ms = timer(lambda: nqq.nxfp_qq_matmul_plain(*args), 3)
        lib_ms = timer(lambda: torch.matmul(xd, wd.T))
        n_bytes = (xq.packed.numel() + xq.meta.numel()
                   * xq.meta.element_size() + wq.packed.numel()
                   + wq.meta.numel() * 2 + m * n * 4)
        b_ms, b_by = bound(n_bytes, 2.0 * m * n * k, PEAK_BF16)
        log(f"wide qq matmul {x_fmt.name} x {name} M={m} K={k} N={n}: max "
            f"err {err:.3g} ({rel:.3g} of sum|x||w|), bitwise on a second "
            f"launch and equal to nxfp_matmul on the decoded X; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f}"
            f" ms, bound {b_ms:.4f} ms ({b_by})")
        rows[f"nxfp_qq_matmul {x_fmt.name} x {name} M={m} K={k} N={n}"] = \
            dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib_ms, fmt=name,
                 shape=f"{x_fmt.name} X ({m}, {k}) x {name} W ({k}, {n})")
        del wq, wd, xq, xd, x, y, y_plain, mag
        # decode attention over a cache in this format (the main path's
        # B 4, 8 KV heads of 128, S 256, ragged lengths)
        b, kvh, g, d, s = 4, 8, 4, 128, 256
        lens = (256, 200, 131, 17)
        kq, vq = (quantize_qtensor(torch.randn(
            (b, s, kvh, d), generator=gen, device="cuda").to(torch.bfloat16),
            fmt, axis=-1, device="cuda") for _ in range(2))
        q = torch.randn((b, kvh, g, d), generator=gen, device="cuda") \
            * d ** -0.5
        d_pad = kq.packed.shape[-2] * bs
        q = F.pad(q, (0, d_pad - d))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (q, kq.packed, kq.meta, vq.packed, vq.meta, lengths, fmt)
        out = na.nxfp_decode_attention(*args)
        if not torch.equal(out, na.nxfp_decode_attention(*args)):
            fail(f"decode attention {name}: a second launch gave other bits")
        ref = na.nxfp_decode_attention_plain(*args)
        kd = na.dequant_cache(kq.packed, kq.meta, fmt)
        vd = na.dequant_cache(vq.packed, vq.meta, fmt)
        err = float((out - ref).abs().max())
        if not err <= 1e-5 * float(vd.abs().max()):
            fail(f"decode attention {name}: max error {err:.3g} exceeds "
                 "1e-5 max|V|")
        qh = q.reshape(b, kvh * g, 1, d_pad)
        kh = kd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        vh = vd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        mask = (torch.arange(s, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        ms = timer(lambda: na.nxfp_decode_attention(*args))
        plain_ms = timer(lambda: na.nxfp_decode_attention_plain(*args), 3)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1.0))
        tot = int(lengths.sum())
        nb = kq.packed.shape[-2]
        n_bytes = (q.numel() * 4 + 2 * tot * kvh * nb
                   * (fmt.bytes_per_block + 2) + b * 4 + out.numel() * 4)
        b_ms, b_by = bound(n_bytes, 2 * 2 * tot * kvh * g * d_pad, PEAK_F32)
        log(f"wide decode attention {name} B={b} KVH={kvh} G={g} D={d} "
            f"S={s}: max err {err:.3g}, bitwise on a second launch; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA f32 {lib_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
        rows[f"nxfp_decode_attention {name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, fmt=name,
            shape=f"q ({b}, {kvh}, {g}, {d}), {name} K/V S={s}, lengths "
                  f"{list(lens)}")
        del kq, vq, kd, vd, kh, vh, q, out, ref
        torch.cuda.empty_cache()


def phase_reference():
    """The smoke Llama through the kernels vs the plain path on the CPU."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeEngine

    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device="cpu")
    pol = QuantPolicy("nxfp4", "nxfp4")
    eng = {dev: ServeEngine(cfg, params, pol, max_len=32, device=dev)
           for dev in ("cpu", "cuda")}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab,
                                                              (2, 9)))
    out = {dev: prefill(cfg, e.params, {"tokens": toks.to(dev)}, max_len=32,
                        kv_fmt="nxfp4") for dev, e in eng.items()}
    worst = 0.0
    tok = torch.argmax(out["cpu"][0], dim=-1)
    for step in range(4):
        lc, lg = out["cpu"][0], out["cuda"][0].cpu()
        if not torch.isfinite(lg).all():
            fail("smoke model: non-finite logits on the card")
        worst = max(worst, float((lc - lg).abs().max()))
        for dev, e in eng.items():
            out[dev] = decode_step(cfg, e.params, tok.to(dev)[:, None],
                                   out[dev][1], "nxfp4")
        tok = torch.argmax(out["cpu"][0], dim=-1)
    # bf16 activations: one GEMM summed in another order can flip a bf16
    # rounding, and a K/V value near an nxfp4 level boundary a code
    if worst > 1e-2:
        fail(f"smoke model: card vs CPU logits differ by {worst:.3g} > 1e-2")
    log(f"reference: smoke Llama (2 layers, d 64) through the kernels vs "
        f"the plain CPU path, prefill + 4 teacher-forced steps: max logit "
        f"difference {worst:.3g} (tolerance 1e-2)")
    act = {dev: prefill(cfg, e.params, {"tokens": toks.to(dev)}, max_len=32,
                        kv_fmt="nxfp4", act_fmt="amxfp4")[0].cpu()
           for dev, e in eng.items()}
    if not torch.isfinite(act["cuda"]).all():
        fail("smoke model: non-finite qq prefill logits on the card")
    act_err = float((act["cpu"] - act["cuda"]).abs().max())
    # a bf16 activation an ulp apart can sit across an amxfp4 level
    # boundary and move by a whole code
    if act_err > 3e-2:
        fail(f"smoke model: qq prefill, card vs CPU logits differ by "
             f"{act_err:.3g} > 3e-2")
    log(f"reference: smoke Llama qq prefill (amxfp4 x nxfp4, nxfp4 KV) "
        f"through the kernels vs the plain CPU path: max logit difference "
        f"{act_err:.3g} (tolerance 3e-2)")


def phase_main(n_layers: int):
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeEngine

    cfg = get_config("llama3_8b")
    if n_layers != cfg.n_layers:
        log(f"main path: depth cut from {cfg.n_layers} to {n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    log(f"main path: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.n_layers} layers, random weights (seed 0)")
    t0 = time.time()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_params: {time.time() - t0:.2f} s")

    reset_launch_counts()
    t0 = time.time()
    engine = ServeEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                         max_len=256, device="cuda")
    del params                                  # drop the dense weights
    torch.cuda.synchronize()
    cast_s = time.time() - t0
    torch.cuda.empty_cache()
    foot = engine.weights_footprint_bytes()
    log(f"  load-time cast: {cast_s:.2f} s; weights footprint {foot} bytes")
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (4, 128), generator=gen)
    batch = {"tokens": prompts.numpy()}
    torch.cuda.reset_peak_memory_stats()
    # the first device-loop call captures the chunk graph (a warm-up chunk
    # on the capture stream, then the capture) and replays it
    warm = engine.generate(batch, max_new=32, loop="device", chunk=16)
    dev = engine.generate(batch, max_new=32, loop="device", chunk=16)
    host = engine.generate(batch, max_new=32, loop="host")
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    for name, r in (("device", dev), ("host", host), ("warm-up", warm)):
        if r.tokens.shape != (4, 32) or not (r.n_generated == 32).all():
            fail(f"main path ({name} loop): shape {r.tokens.shape}, "
                 f"n_generated {r.n_generated.tolist()}")
        if r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab:
            fail(f"main path ({name} loop): token out of range")
    if not ((dev.tokens == host.tokens).all()
            and (warm.tokens == dev.tokens).all()):
        fail("main path: graph device loop and host loop disagree")
    for name, c in counts.items():
        # qq: phase 6's path; the dense-row attention: phase 10's premium;
        # the grouped GEMM: the MoE experts (phase 18)
        if c <= 0 and name not in NOT_DENSE_PATH:
            fail(f"main path: kernel {name} was never launched")
    prog = _device_loop_of(engine)
    if set(prog.graphs) != {(16, True)} or prog.replays != 4:
        fail(f"main path: the device loop ran {prog.replays} graph replays "
             f"of {sorted(prog.graphs)}, expected 4 of one 16-step graph")

    reset_launch_counts()
    logits, cache = prefill(cfg, engine.params,
                            {"tokens": prompts.to("cuda")}, max_len=256,
                            kv_fmt="nxfp4")
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all():
        fail("main path: non-finite prefill logits")
    reset_launch_counts()
    decode_step(cfg, engine.params, logits.argmax(-1).to(torch.int32)[:, None],
                cache, "nxfp4")
    per_step = launch_counts()
    if per_step["nxfp_quantize"] != cfg.n_layers:
        fail(f"decode step: {per_step['nxfp_quantize']} quantizer launches, "
             f"expected one per layer ({cfg.n_layers})")
    del cache

    steps = 32
    loops = time_loops(cfg, engine, batch, prompts, dev.tokens, steps)
    med = {k: statistics.median(v) for k, v in loops.items()}
    log(f"  greedy 4 x 32 tokens, graph device loop (chunk 16) == host loop "
        f"== eager device loop: {dev.tokens[:, :8].tolist()} ...")
    log(f"  prefill (4 x 128 tokens): device loop {dev.prefill_seconds:.4f} "
        f"s, host loop {host.prefill_seconds:.4f} s")
    log(f"  decode ms per step, {LOOP_ROUNDS} rounds of (graph, eager, host, "
        f"host, eager, graph): graph {loops['graph']}, eager "
        f"{loops['eager']}, host {loops['host']}")
    log(f"  decode medians: graph device loop {med['graph']:.3f} ms/step "
        f"({4e3 / med['graph']:.2f} tok/s), eager device loop (decode_loop) "
        f"{med['eager']:.3f} ms/step, host loop {med['host']:.3f} ms/step; "
        f"graph replays {prog.replays} of {len(prog.graphs)} graph(s)")
    log(f"  peak device memory during generate: {peak} bytes")
    log(f"  launches on the main path (cast + 3 generate calls, the graph's "
        f"launches counted at its warm-up and capture): {counts}")
    log(f"  launches per decode step: {per_step}")
    return counts, per_step, cfg, engine, prompts, med


LOOP_ROUNDS = 2       # phase 5: rounds of the three decode loops in turns
                      # (4 until phase 22 came)


def _device_loop_of(engine):
    from repro_torch.serving import engine as engine_mod
    progs = [p for k, p in engine_mod._PROGRAM_CACHE.items()
             if k[0] == engine._uid]
    if len(progs) != 1:
        fail(f"main path: {len(progs)} device loops cached for the engine")
    return progs[0]


def time_loops(cfg, engine, batch, prompts, tokens, steps):
    """ms per decode step of the graph device loop, the eager device loop
    (``decode_loop`` called directly, greedy) and the host loop, timed in
    ``LOOP_ROUNDS`` rounds of (graph, eager, host, host, eager, graph):
    the host's speed drifts within a run. Every run's tokens must equal
    ``tokens``."""
    from repro_torch.models import decode_loop, prefill
    out = {"graph": [], "eager": [], "host": []}
    for kind in ("graph", "eager", "host", "host", "eager", "graph") \
            * LOOP_ROUNDS:
        if kind == "eager":
            logits, cache = prefill(cfg, engine.params,
                                    {"tokens": prompts.to("cuda")},
                                    max_len=256, kv_fmt="nxfp4")
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, _, _ = decode_loop(cfg, engine.params, tok, cache, steps,
                                     "nxfp4",
                                     lambda lg: lg.argmax(-1).to(torch.int32))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got = toks.cpu().numpy()
            del cache
        else:
            r = engine.generate(batch, max_new=steps,
                                loop="device" if kind == "graph" else "host",
                                chunk=16)
            sec, got = r.decode_seconds, r.tokens
        if not (got == tokens).all():
            fail(f"main path: the {kind} loop's tokens differ in the timed "
                 "rounds")
        out[kind].append(round(sec / steps * 1e3, 3))
    return out


# phase 7: the main path at the formats the paper sweeps beyond nxfp4
WIDE_SERVE = (("nxfp3", "nxfp3"), ("nxfp4_bs64", "nxfp4_bs64"))


def phase_wide_serving(n_layers: int, prompts):
    """Llama-3-8B at full width (depth ``n_layers``) served with nxfp3
    weights and KV, and with nxfp4_bs64: the graph device loop's tokens
    equal the host loop's, and the path runs the quantizer, the dequant
    GEMM and decode attention at those formats."""
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=n_layers)
    batch = {"tokens": prompts.numpy()}
    out = {}
    for wfmt, kvfmt in WIDE_SERVE:
        params = init_params(cfg, seed=0, device="cuda")
        reset_launch_counts()
        engine = ServeEngine(cfg, params, QuantPolicy(wfmt, kvfmt),
                             max_len=256, device="cuda")
        del params
        torch.cuda.empty_cache()
        dev = engine.generate(batch, max_new=16, loop="device", chunk=8)
        host = engine.generate(batch, max_new=16, loop="host")
        dev2 = engine.generate(batch, max_new=16, loop="device", chunk=8)
        torch.cuda.synchronize()
        counts = launch_counts()
        for name, r in (("graph", dev), ("host", host)):
            if r.tokens.shape != (4, 16) or r.tokens.min() < 0 \
                    or r.tokens.max() >= cfg.vocab:
                fail(f"wide serving {wfmt}: {name} loop tokens "
                     f"{r.tokens.shape} out of range")
        if not ((dev.tokens == host.tokens).all()
                and (dev2.tokens == host.tokens).all()):
            fail(f"wide serving {wfmt} weights, {kvfmt} KV: graph device "
                 "loop and host loop disagree")
        for name, c in counts.items():
            if c <= 0 and name not in NOT_DENSE_PATH:
                fail(f"wide serving {wfmt}: kernel {name} was never launched")
        log(f"wide serving: Llama-3-8B full width, {n_layers} layers, "
            f"{wfmt} weights, {kvfmt} KV, 4 x 128 prompt tokens, 16 greedy "
            f"tokens: graph device loop == host loop "
            f"{dev.tokens[:, :6].tolist()} ...; decode "
            f"{dev2.decode_seconds / 16 * 1e3:.3f} ms/step (graph), "
            f"{host.decode_seconds / 16 * 1e3:.3f} ms/step (host); weights "
            f"footprint {engine.weights_footprint_bytes()} bytes; launches "
            f"{counts}")
        out[wfmt] = counts
        del engine
        torch.cuda.empty_cache()
    return out


PREFILL_ROUNDS = 8    # phase 6: rounds of (qq, dense, dense, qq) prefills


def _timed_prefill(cfg, params, tokens, act_fmt):
    from repro_torch.models import prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = prefill(cfg, params, {"tokens": tokens}, max_len=256,
                  kv_fmt="nxfp4", act_fmt=act_fmt)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_act(cfg, engine, prompts):
    """The qq prefill (amxfp4 activations) at full width, then decode."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_loop

    tokens = prompts.to("cuda")
    for act_fmt in ("amxfp4", None):                           # warm-up
        _timed_prefill(cfg, engine.params, tokens, act_fmt)
    reset_launch_counts()
    (logits, cache), _ = _timed_prefill(cfg, engine.params, tokens,
                                        "amxfp4")
    per_prefill = launch_counts()
    tok = logits.argmax(-1).to(torch.int32)
    out, _, _ = decode_loop(cfg, engine.params, tok, cache, 32, "nxfp4",
                            lambda lg: lg.argmax(-1))
    torch.cuda.synchronize()
    counts = launch_counts()

    if not torch.isfinite(logits).all():
        fail("qq prefill: non-finite logits")
    for name, c in counts.items():
        # a packed cache here; no MoE expert
        if c <= 0 and name not in ("dense_attention", "nxfp_matmul_grouped"):
            fail(f"qq prefill path: kernel {name} was never launched")
    if per_prefill["nxfp_qq_matmul"] != 7 * cfg.n_layers:
        fail(f"qq prefill: {per_prefill['nxfp_qq_matmul']} qq GEMMs, "
             f"expected 7 per layer ({7 * cfg.n_layers})")
    if per_prefill["nxfp_quantize"] != 5 * cfg.n_layers:
        fail(f"qq prefill: {per_prefill['nxfp_quantize']} quantizer "
             f"launches, expected 5 per layer ({5 * cfg.n_layers})")
    if out.shape != (4, 32) or out.min() < 0 or out.max() >= cfg.vocab:
        fail(f"qq prefill path: decoded tokens {tuple(out.shape)} out of "
             "range")
    # timed in turns with the dense-activation prefill, PREFILL_ROUNDS
    # rounds of (qq, dense, dense, qq): the host's speed drifts within a
    # run, and a prefill of this host-bound path sees outliers of 3-5x
    secs = {"amxfp4": [], None: []}
    for act_fmt in ("amxfp4", None, None, "amxfp4") * PREFILL_ROUNDS:
        (res, _), sec = _timed_prefill(cfg, engine.params, tokens, act_fmt)
        secs[act_fmt].append(sec)
        if act_fmt is None:
            dense = res
        elif not torch.equal(logits, res):
            fail("qq prefill: a second run gave other logits")
    act_med, dense_med = (statistics.median(v) for v in secs.values())
    # each round's qq over dense seconds: the drift between rounds cancels
    rounds = [(secs["amxfp4"][i] + secs["amxfp4"][i + 1])
              / (secs[None][i] + secs[None][i + 1])
              for i in range(0, 2 * PREFILL_ROUNDS, 2)]
    dev = float((logits - dense).abs().max() / dense.abs().max())
    # how that deviation builds up with depth: the first n layers alone
    sweep = {}
    for n in sorted({1, 2, 4, 8, 16, cfg.n_layers}):
        if n > cfg.n_layers:
            continue
        cut = dataclasses.replace(cfg, n_layers=n)
        params = dict(engine.params, layers=engine.params["layers"][:n])
        la = _timed_prefill(cut, params, tokens, "amxfp4")[0][0]
        ld = _timed_prefill(cut, params, tokens, None)[0][0]
        sweep[n] = round(float((la - ld).abs().max() / ld.abs().max()), 4)
    log(f"qq prefill path ({cfg.n_layers} layers, 4 x 128 tokens, amxfp4 "
        f"activations x nxfp4 weights, nxfp4 KV) + 32 greedy tokens:")
    log(f"  launches per prefill: {per_prefill} (7 qq GEMMs and "
        f"{per_prefill['nxfp_quantize'] // cfg.n_layers} quantizer launches "
        f"per layer: 4 activation encodes + one for K and V)")
    log(f"  launches on the path (prefill + decode_loop): {counts}")
    log(f"  prefill seconds, {PREFILL_ROUNDS} rounds of (qq, dense, dense, "
        f"qq) after the counted run: act_fmt=amxfp4 {secs['amxfp4']}, "
        f"act_fmt=None {secs[None]}; medians {act_med:.4f} / "
        f"{dense_med:.4f} s, ratio {act_med / dense_med:.3f}; minima "
        f"{min(secs['amxfp4']):.4f} / {min(secs[None]):.4f} s, ratio "
        f"{min(secs['amxfp4']) / min(secs[None]):.3f}; by round "
        f"{[round(r, 3) for r in rounds]}, median "
        f"{statistics.median(rounds):.3f}")
    log(f"  logits bitwise equal on {2 * PREFILL_ROUNDS} more runs; max "
        f"|logit - dense-act "
        f"logit| / max |dense-act logit| = {dev:.4g}; by depth (layers: "
        f"deviation) {sweep}")
    log(f"  greedy tokens after the qq prefill: {out[:, :8].tolist()} ...")
    return counts


# phase 8: continuous serving at full width
CONT_SLOTS, CONT_CHUNK, CONT_MAX_LEN = 4, 16, 512
CONT_PROMPTS = (32, 64, 128, 256, 32, 64, 128, 256)
CONT_MAX_NEW = (8, 16, 24, 32, 40, 48, 56, 64)
CONT_SAMPLED = {2: (0.8, 17), 5: (1.3, 23)}     # uid: (temperature, seed)
CONT_STOP_UID, CONT_STOP_AT = 7, 20   # its stop: its solo stream's 21st token


def phase_invariance():
    """A decode row at B 4 and 8 against the same row at B 1, bitwise
    (``scripts/batch_invariance.py``: the smoke Llama and a 2-layer
    Llama-3-8B at full width, each row-spanning op and ``decode_step``'s
    logits, ``lm_head`` included)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import batch_invariance
    res = batch_invariance.measure(2)
    bad = {f"{m} {op} B={b}": r for m, rows in res.items()
           for op, by_b in rows.items() for b, r in by_b.items()
           if r["differ"] and op != batch_invariance.PLAIN_MEAN}
    if bad:
        fail(f"batch invariance: row 0 differs from B 1 in {bad}")
    log(f"batch invariance: row 0 at B {list(batch_invariance.BATCHES)} "
        f"equals B 1 bitwise in every op the port runs and in "
        f"decode_step's logits (eager and as a graph replay; "
        f"'{batch_invariance.PLAIN_MEAN}' is for comparison) "
        f"(smoke Llama; Llama-3-8B full width, 2 layers, lm_head "
        f"included; nxfp4 weights and KV, S {batch_invariance.MAX_LEN}): "
        f"{json.dumps(res)}")


def phase_chunked_invariance():
    """A prompt's rows through the whole prefill against the lane at P 16,
    32, 64 and 128, bitwise (``scripts/batch_invariance.py --chunked``:
    each op's f32 result, ``prefill_chunk``'s logits and the slot's packed
    K/V, eagerly and as graph replays; the smoke Llama and a 2-layer
    Llama-3-8B at full width). The GEMM's rows at M 16 (split-K) against
    M 512 (wgmma) are reported, not held: the lane's own path at P > 16
    runs wgmma only."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import batch_invariance
    res = batch_invariance.measure_chunked(2)
    bad = {}
    for m, rows in res.items():
        for op, by_p in rows.items():
            for key, r in by_p.items():
                held = op != batch_invariance.PLAIN_MEAN and not (
                    op.startswith("nxfp_matmul") and key == "M=16") and not (
                    op.startswith("prefill_chunk") and key == "P=16")
                if held and r["differ"]:
                    bad[f"{m} {op} {key}"] = r
    if bad:
        fail(f"chunked invariance: the lane's rows differ from the whole "
             f"prefill's in {bad}")
    log(f"chunked invariance: a {batch_invariance.PROMPT}-token prompt "
        f"through the lane at P {list(batch_invariance.LANE_P)} equals the "
        f"whole prefill bitwise in every op of the lane's path and in "
        f"prefill_chunk's logits and K/V bytes, eager and as graph replays "
        f"(P 16, split-K GEMMs against wgmma, and the plain torch.mean: "
        f"reported): {json.dumps(res)}")


def _continuous_requests(cfg):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, temperature=CONT_SAMPLED.get(i, (0.0, 0))[0],
                    seed=CONT_SAMPLED.get(i, (0.0, 0))[1],
                    arrival_time=0.0 if i < 4 else 0.075 * (i - 3))
            for i, (t, m) in enumerate(zip(CONT_PROMPTS, CONT_MAX_NEW))]


def _static_batches(cfg, params, reqs):
    """The same requests as two static batches of 4 through
    ``ServeEngine``'s graph loop: prompts left-padded with token 0 to the
    batch's longest, every row decoded to the batch's largest max_new
    (what a lockstep batch without ragged prefill pays). Returns (useful
    tokens per second, seconds), after one warm-up of each batch."""
    import numpy as np
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, params, QuantPolicy(None, "nxfp4"),
                      max_len=CONT_MAX_LEN, device="cuda")
    batches = []
    for group in (reqs[:4], reqs[4:]):
        t = max(len(r.tokens) for r in group)
        toks = np.stack([np.pad(r.tokens, (t - len(r.tokens), 0))
                         for r in group])
        batches.append(({"tokens": toks}, max(r.max_new for r in group)))
    for batch, max_new in batches:                             # warm-up
        eng.generate(batch, max_new=max_new, loop="device",
                     chunk=CONT_CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch, max_new in batches:
        eng.generate(batch, max_new=max_new, loop="device",
                     chunk=CONT_CHUNK)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return sum(r.max_new for r in reqs) / sec, sec


def phase_continuous(n_layers: int, graph_ms: float, card: str):
    """Continuous batching at full width: ``ContinuousEngine`` (4 slots,
    chunk 16, max_len 512, nxfp4 weights and KV) serves 8 requests
    against each one's solo host-loop stream, bitwise. Every measured
    line names ``card`` (nvidia-smi's name and power limit)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousEngine, ServeEngine

    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=n_layers)
    params = init_params(cfg, seed=0, device="cuda")
    engine = ContinuousEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                              n_slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
                              chunk=CONT_CHUNK, device="cuda")
    del params                                  # drop the dense weights
    torch.cuda.empty_cache()
    reqs = _continuous_requests(cfg)

    def solo(req):
        # the engine's cast weights, uncast policy: no second cast
        eng = ServeEngine(cfg, engine.params, QuantPolicy(None, "nxfp4"),
                          max_len=CONT_MAX_LEN, rng_seed=req.seed,
                          device="cuda")
        out = eng.generate({"tokens": req.tokens[None]}, max_new=req.max_new,
                           temperature=req.temperature,
                           stop_token=req.stop_token, loop="host")
        return out.tokens[0, :int(out.n_generated[0])]

    stop = int(solo(reqs[CONT_STOP_UID])[CONT_STOP_AT])
    reqs[CONT_STOP_UID] = dataclasses.replace(reqs[CONT_STOP_UID],
                                              stop_token=stop)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    first = {r.uid: r for r in engine.serve(reqs)}    # captures the graphs
    torch.cuda.synchronize()
    counts = launch_counts()
    replays_first = engine.replays
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    second = {r.uid: r for r in results}

    solos = {}
    for req in reqs:
        want = solos[req.uid] = solo(req)
        for name, got in (("first", first), ("second", second)):
            if not np.array_equal(got[req.uid].tokens, want):
                fail(f"continuous: uid {req.uid} ({name} serve) "
                     f"{got[req.uid].tokens[:8].tolist()} ... differs from "
                     f"its solo stream {want[:8].tolist()} ...")
    if second[CONT_STOP_UID].tokens[-1] != stop:
        fail("continuous: the stop request did not end on its stop token")
    for name in ("nxfp_quantize", "nxfp_matmul", "nxfp_attention"):
        if counts[name] <= 0:
            fail(f"continuous path: kernel {name} was never launched")
    if engine.replays - replays_first != engine.chunks or \
            replays_first == 0 or set(engine._graphs) != {True, False}:
        fail(f"continuous: {engine.replays} replays of graphs "
             f"{sorted(engine._graphs)} over {engine.chunks} chunks")

    n_tok = sum(r.n_generated for r in results)
    ttft = [r.ttft for r in results]
    qd = [r.queue_delay for r in results]
    full = [sec / CONT_CHUNK * 1e3 for live, sec in engine.chunk_times
            if live == CONT_SLOTS]
    occupancy = n_tok / (engine.chunks * CONT_CHUNK * CONT_SLOTS)
    static_tok_s, static_s = _static_batches(cfg, engine.params, reqs)
    log(f"continuous serving: Llama-3-8B full width, {n_layers} layers, "
        f"nxfp4 weights and KV, {CONT_SLOTS} slots, chunk {CONT_CHUNK}, "
        f"max_len {CONT_MAX_LEN}; 8 requests (prompts {list(CONT_PROMPTS)}, "
        f"max_new {list(CONT_MAX_NEW)}, uids 2 and 5 sampled, uid "
        f"{CONT_STOP_UID} stops on token {stop}); every stream equals its "
        f"solo host-loop stream bitwise, on both serves")
    log(f"  second serve ({card}): {n_tok} tokens in {wall:.4f} s = "
        f"{n_tok / wall:.2f} tok/s; TTFT median {statistics.median(ttft):.4f}"
        f" s, max {max(ttft):.4f} s; queue delay median "
        f"{statistics.median(qd):.4f} s, max {max(qd):.4f} s")
    log(f"  decode chunks ({card}) {engine.chunks} (graph replays: "
        f"{engine.replays - replays_first} this serve, {replays_first} in "
        f"the first, which captured graphs {sorted(engine._graphs)}); ms per "
        f"step of a chunk with {CONT_SLOTS} live slots: median "
        f"{statistics.median(full) if full else float('nan'):.3f} over "
        f"{len(full)} chunks {[round(x, 3) for x in full]} (phase 5's graph "
        f"loop at B 4: {graph_ms:.3f}); live slots per chunk "
        f"{[live for live, _ in engine.chunk_times]}")
    log(f"  admission prefill seconds ({card}; prompts in admission "
        f"order): "
        f"{[round(x, 4) for x in engine.admit_seconds]}; slot occupancy "
        f"(tokens / slot-steps) {occupancy:.3f}")
    log(f"  static batches ({card}; 2 x 4 through ServeEngine's graph "
        f"loop, padded "
        f"to the longest prompt, run to the largest max_new): "
        f"{static_tok_s:.2f} useful tok/s, {static_s:.4f} s")
    log(f"  peak device memory over both serves ({card}): {peak} bytes; "
        f"launches on "
        f"the continuous path (first serve: prefills, graph warm-ups and "
        f"captures): {counts}")
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    return counts, params, reqs, solos


# phase 9: the chunked-prefill lane at full width
LANE_P = 32                   # the lane's chunk width
LANE_WIDE_P = 128             # served too: the wgmma GEMM's whole M tile
LANE_ROUNDS = 1               # rounds of each mode in turns, and reversed
                              # (2 until phase 22 came)
LANE_TIMED_P = (16, 32, 64, 128)
LANE_REPLAYS = 20             # replays timed per graph


def _serve_figures(engine, results, wall):
    """One serve's end-to-end figures (host clock)."""
    n_tok = sum(r.n_generated for r in results)
    ttft = [r.ttft for r in results]
    qd = [r.queue_delay for r in results]
    return dict(
        seconds=round(wall, 4), tok_s=round(n_tok / wall, 2),
        ttft_median=round(statistics.median(ttft), 4),
        ttft_max=round(max(ttft), 4),
        queue_median=round(statistics.median(qd), 4),
        queue_max=round(max(qd), 4), lane_chunks=engine.lane_chunks,
        max_stall=round(max(engine.stall_seconds, default=0.0), 4),
        occupancy=round(n_tok / (engine.chunks * CONT_CHUNK * CONT_SLOTS),
                        3))


def _replay_ms(graph, n: int = LANE_REPLAYS) -> float:
    """Median ms of one replay of a captured graph (CUDA events)."""
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return round(statistics.median(times), 4)


def phase_lane(n_layers: int, params, reqs, solos, card: str):
    """The chunked-prefill lane at full width: phase 8's requests through
    ``ContinuousEngine(prefill_mode="chunked", p_chunk=32)`` (lane chunks
    as CUDA-graph replays), every stream bitwise its solo stream, then
    both admission modes in alternated rounds, the lane chunk's replay
    time at P 16-128 against a decode chunk's, and the lifecycle (a serve
    under ``TtftDeadline`` with one request that expires in the queue).
    ``params`` are phase 8's cast weights, ``solos`` its solo streams.
    Every measured line names ``card``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (ContinuousEngine, Request, Status,
                                     TtftDeadline)

    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=n_layers)

    def engine(mode, p=LANE_P):
        # the weights are cast already: an uncast weight policy
        return ContinuousEngine(cfg, params, QuantPolicy(None, "nxfp4"),
                                n_slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
                                chunk=CONT_CHUNK, prefill_mode=mode,
                                p_chunk=p, device="cuda")

    def check(name, results):
        got = {r.uid: r for r in results}
        for req in reqs:
            r = got[req.uid]
            if r.status != Status.OK or not np.array_equal(
                    r.tokens, solos[req.uid]):
                fail(f"chunked lane: uid {req.uid} ({name}, {r.status}) "
                     f"{r.tokens[:8].tolist()} ... differs from its solo "
                     f"stream {solos[req.uid][:8].tolist()} ...")

    lane, whole = engine("chunked"), engine("whole")
    wide = engine("chunked", LANE_WIDE_P)
    reset_launch_counts()
    check("first serve", lane.serve(reqs))  # captures the lane's graphs
    torch.cuda.synchronize()
    counts = launch_counts()
    for name in ("nxfp_quantize", "nxfp_matmul", "nxfp_attention"):
        if counts[name] <= 0:
            fail(f"chunked lane path: kernel {name} was never launched")
    if lane.lane_replays != lane.lane_chunks or lane.lane_chunks == 0 or \
            set(lane._lane_graphs) != {False, True}:
        fail(f"chunked lane: {lane.lane_replays} lane replays of graphs "
             f"{sorted(lane._lane_graphs)} over {lane.lane_chunks} chunks")
    check("whole, first serve", whole.serve(reqs))   # captures its graphs
    check(f"P {LANE_WIDE_P}, first serve", wide.serve(reqs))
    engines = {"chunked": lane, "whole": whole,
               f"chunked P {LANE_WIDE_P}": wide}
    figures = {mode: [] for mode in engines}
    order = tuple(engines)
    for mode in (order + order[::-1]) * LANE_ROUNDS:
        eng = engines[mode]
        replays = eng.lane_replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.serve(reqs)
        wall = time.perf_counter() - t0
        check(f"{mode} round", results)
        if eng.lane_replays - replays != eng.lane_chunks:
            fail(f"chunked lane: a lane chunk ran outside its graph "
                 f"({eng.lane_replays - replays} replays, "
                 f"{eng.lane_chunks} chunks)")
        figures[mode].append(_serve_figures(eng, results, wall))
    med = {mode: {k: statistics.median(f[k] for f in rows)
                  for k in rows[0]} for mode, rows in figures.items()}

    decode_ms = _replay_ms(lane._graphs[True][0])
    lane_ms = {}
    probe = Request(uid=0, tokens=reqs[3].tokens, max_new=1)  # 256 tokens
    for p in LANE_TIMED_P:
        eng = {LANE_P: lane, LANE_WIDE_P: wide}.get(p)
        if eng is None:
            eng = engine("chunked", p)
            eng.serve([probe])              # captures both lane graphs
        lane_ms[p] = {"chunk": _replay_ms(eng._lane_graphs[False][0]),
                      "final": _replay_ms(eng._lane_graphs[True][0])}
        del eng
        torch.cuda.empty_cache()

    doomed = Request(uid=99, tokens=reqs[0].tokens, max_new=8,
                     arrival_time=0.05, deadline_s=1e-6)
    lane.admission_policy = TtftDeadline(deadline_s=60.0)
    results = lane.serve(reqs + [doomed])
    lane.admission_policy = None
    check("TtftDeadline serve", [r for r in results if r.uid != 99])
    gone = next(r for r in results if r.uid == 99)
    if gone.status != Status.DEADLINE_EXPIRED or gone.n_generated != 0 \
            or gone.ttft != float("inf"):
        fail(f"chunked lane: the request past its deadline ended "
             f"{gone.status} with {gone.n_generated} tokens, TTFT "
             f"{gone.ttft}")

    log(f"chunked-prefill lane: Llama-3-8B full width, {n_layers} layers, "
        f"nxfp4 weights and KV, {CONT_SLOTS} slots, chunk {CONT_CHUNK}, "
        f"max_len {CONT_MAX_LEN}, p_chunk {LANE_P} (lane scratch "
        f"{lane._lane_rows} rows); phase 8's 8 requests: every stream "
        f"equals its solo host-loop stream bitwise on every serve (the "
        f"P {LANE_P} and P {LANE_WIDE_P} lanes and whole admission, "
        f"{1 + 2 * LANE_ROUNDS} serves each); every lane chunk a graph "
        f"replay ({lane.lane_replays} replays of 2 graphs at P {LANE_P})")
    for mode in engines:
        log(f"  {mode} admission ({card}), {2 * LANE_ROUNDS} serves in "
            f"rounds of {order + order[::-1]}: medians {med[mode]}; by "
            f"serve {figures[mode]}")
    log(f"  one replay ({card}; CUDA events, median of {LANE_REPLAYS}): "
        f"decode chunk ({CONT_SLOTS} slots x {CONT_CHUNK} steps) "
        f"{decode_ms} ms; lane chunk at P: " + ", ".join(
            f"{p}: {v['chunk']} ms ({v['final']} ms with the head)"
            for p, v in lane_ms.items()))
    log(f"  TtftDeadline(60 s) serve with one more request (deadline_s "
        f"1e-6, arriving at 0.05 s): the 8 streams equal their solo "
        f"streams; uid 99 ended {gone.status}, 0 tokens, TTFT inf")
    log(f"  launches on the chunked path (first serve: lane chunks and the "
        f"graphs' warm-ups and captures): {counts}")
    del lane, whole, wide, engines
    torch.cuda.empty_cache()
    return counts


# phase 10: admission control and serving tiers at full width
AUTO_ROUNDS = 2               # rounds of (auto, whole, whole, auto)
BURST, BURST_QUEUE, BURST_CAP = 16, 4, 8   # overload: requests, max_queue,
#                                            DegradeOverBudget's max_new_cap
TIER_OF = ("premium", "standard", "economy")   # phase 8's uid % 3
TIER_P = 32                   # the tiered lane's chunk width
REPACK_WATERMARK = 0.1        # the degrade rung's KV occupancy trigger


class _TierSolo:
    """A request served alone at a tier: ``ServeEngine``'s host loop over
    the tier's weights (already cast), its prefill with the tier's
    ``act_fmt`` (the economy tier's quantized activations)."""

    def __init__(self, cfg, params, kv_fmt, act_fmt, max_len=CONT_MAX_LEN):
        self.cfg, self.params = cfg, params
        self.kv_fmt, self.act_fmt = kv_fmt, act_fmt
        self.max_len = max_len

    def __call__(self, req, greedy_cap=None):
        import numpy as np
        from repro_torch.core.qtensor import QuantPolicy
        from repro_torch.models import prefill
        from repro_torch.serving import ServeEngine
        cfg, act = self.cfg, self.act_fmt

        class Solo(ServeEngine):
            def _prefill(self, batch):
                toks = torch.as_tensor(np.asarray(batch["tokens"]),
                                       dtype=torch.int64).to(self.device)
                return prefill(cfg, self.params, {"tokens": toks},
                               max_len=self.max_len,
                               kv_fmt=self.policy.kv_fmt, act_fmt=act)

        eng = Solo(cfg, self.params, QuantPolicy(None, self.kv_fmt),
                   max_len=self.max_len, rng_seed=req.seed, device="cuda")
        max_new, temp = req.max_new, req.temperature
        if greedy_cap is not None:
            max_new, temp = min(max_new, greedy_cap), 0.0
        out = eng.generate({"tokens": req.tokens[None]}, max_new=max_new,
                           temperature=temp, stop_token=req.stop_token,
                           loop="host")
        return out.tokens[0, :int(out.n_generated[0])]


class _Journal(logging.Handler):
    """The serving journal's records (kind and fields) of a run."""

    def __init__(self):
        from repro_torch.serving import events
        super().__init__()
        self.parse, self.records = events.parse_event, []
        self.log = logging.getLogger("repro_torch.serving.scheduler")
        self.log.addHandler(self)
        self.log.setLevel(logging.INFO)

    def emit(self, rec):
        e = self.parse(rec.getMessage())
        if e:
            self.records.append(e)


def _held(res, op_prefixes, keys) -> dict:
    """The rows of ``res`` (``batch_invariance``'s output) whose op starts
    with one of ``op_prefixes``, at ``keys``, that differ."""
    return {f"{m} {op} {k}": r for m, rows in res.items()
            for op, by in rows.items() for k, r in by.items()
            if op.startswith(op_prefixes) and k in keys and r["differ"]}


def phase_auto_and_overload(n_layers, params, reqs, solos, card):
    """``p_chunk="auto"`` and bounded-queue shedding at phase 8's settings,
    with its cast weights, requests and solo streams."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (ContinuousEngine, DegradeOverBudget,
                                     DropOldest, RejectNew, Status)

    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=n_layers)
    policy = QuantPolicy(None, "nxfp4")       # the weights are cast already

    def check(name, results, want=solos):
        got = {r.uid: r for r in results}
        for uid, stream in want.items():
            r = got[uid]
            if r.status != Status.OK or not np.array_equal(r.tokens, stream):
                fail(f"{name}: uid {uid} ({r.status}) {r.tokens[:8].tolist()}"
                     f" ... differs from its solo stream "
                     f"{stream[:8].tolist()} ...")

    auto = ContinuousEngine(cfg, params, policy, n_slots=CONT_SLOTS,
                            max_len=CONT_MAX_LEN, chunk=CONT_CHUNK,
                            prefill_mode="chunked", p_chunk="auto",
                            device="cuda")
    sweep = {p: round(s * 1e3, 4) for p, s in auto.p_chunk_sweep.items()}
    pick = auto.p_chunk
    if pick <= 16:
        fail(f"p_chunk='auto' picked {pick} (sweep {sweep} ms, decode chunk "
             f"{auto.p_chunk_decode_s * 1e3:.4f} ms): the lane's GEMMs run "
             f"split-K and leave the bitwise oracle")
    if set(auto._lane_graphs) != {False}:
        fail(f"p_chunk='auto' kept lane graphs {sorted(auto._lane_graphs)}")
    whole = ContinuousEngine(cfg, params, policy, n_slots=CONT_SLOTS,
                             max_len=CONT_MAX_LEN, chunk=CONT_CHUNK,
                             device="cuda")
    reset_launch_counts()
    check("p_chunk='auto', first serve", auto.serve(reqs))
    torch.cuda.synchronize()
    counts = launch_counts()
    check("whole, first serve", whole.serve(reqs))
    figures = {"auto": [], "whole": []}
    for mode in ("auto", "whole", "whole", "auto") * AUTO_ROUNDS:
        eng = auto if mode == "auto" else whole
        replays = eng.lane_replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.serve(reqs)
        wall = time.perf_counter() - t0
        check(f"{mode} round", results)
        if eng.lane_replays - replays != eng.lane_chunks:
            fail("p_chunk='auto': a lane chunk ran outside its graph")
        figures[mode].append(_serve_figures(eng, results, wall))
    med = {mode: {k: statistics.median(f[k] for f in rows)
                  for k in rows[0]} for mode, rows in figures.items()}
    log(f"p_chunk='auto' ({card}): decode chunk "
        f"{auto.p_chunk_decode_s * 1e3:.4f} ms, lane chunk by P (ms, least "
        f"of 3 replays after a warm-up) {sweep} -> P {pick} (> 16: "
        f"{pick > 16}); phase 8's 8 requests: every stream equals its solo "
        f"stream bitwise on {1 + 2 * AUTO_ROUNDS} serves")
    for mode in figures:
        log(f"  {mode} admission ({card}), {2 * AUTO_ROUNDS} serves in "
            f"rounds of (auto, whole, whole, auto): medians {med[mode]}; "
            f"by serve {figures[mode]}")
    log(f"  launches on the auto path (first serve: lane chunks and the "
        f"graphs' warm-ups and captures): {counts}")
    del auto
    torch.cuda.empty_cache()

    # overload: a burst of BURST at t 0 (phase 8's requests twice, uid i a
    # copy of request i % 8) into CONT_SLOTS slots, the queue bounded at
    # BURST_QUEUE: at the first sweep BURST - BURST_QUEUE - CONT_SLOTS
    # arrivals are over budget, the newest (RejectNew, DegradeOverBudget)
    # or the oldest (DropOldest)
    burst = [dataclasses.replace(reqs[i % len(reqs)], uid=i,
                                 arrival_time=0.0) for i in range(BURST)]
    n_over = BURST - BURST_QUEUE - CONT_SLOTS
    newest, oldest = set(range(BURST - n_over, BURST)), set(range(n_over))
    greedy_solo = _TierSolo(cfg, params, "nxfp4", None)
    capped = {uid: (solos[uid][:BURST_CAP]
                    if reqs[uid].temperature == 0.0
                    else greedy_solo(reqs[uid], BURST_CAP))
              for uid in solos}
    whole.max_queue = BURST_QUEUE
    overload = {}
    for pol, shed, degraded in ((RejectNew(), newest, set()),
                                (DropOldest(), oldest, set()),
                                (DegradeOverBudget(max_new_cap=BURST_CAP),
                                 set(), newest)):
        whole.shedding = pol
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = whole.serve(burst)
        wall = time.perf_counter() - t0
        got_shed = {r.uid for r in results if r.status == Status.SHED}
        got_deg = {r.uid for r in results if r.degraded}
        if got_shed != shed or got_deg != degraded:
            fail(f"overload under {pol.name}: shed {sorted(got_shed)}, "
                 f"degraded {sorted(got_deg)}; the rule gives shed "
                 f"{sorted(shed)}, degraded {sorted(degraded)}")
        check(f"overload under {pol.name}",
              [r for r in results if r.uid not in shed],
              {u: (capped if u in degraded else solos)[u % len(reqs)]
               for u in range(BURST) if u not in shed})
        served = [r for r in results if r.status == Status.OK]
        qd = [r.queue_delay for r in served]
        overload[pol.name] = dict(
            seconds=round(wall, 4),
            goodput_tok_s=round(sum(r.n_generated for r in served) / wall,
                                2),
            shed=len(got_shed), degraded=len(got_deg),
            queue_median=round(statistics.median(qd), 4),
            queue_max=round(max(qd), 4))
    whole.max_queue = whole.shedding = None
    log(f"overload ({card}): {BURST} requests at t 0 into {CONT_SLOTS} "
        f"slots, max_queue {BURST_QUEUE} ({n_over} over budget at the first "
        f"sweep); shed and degraded uids as the rule gives, every served "
        f"stream its solo stream (a degraded one's at max_new "
        f"{BURST_CAP}, greedy): {json.dumps(overload)}")
    del whole
    torch.cuda.empty_cache()
    return counts, {"sweep_ms": sweep, "pick": pick, "auto": med["auto"],
                    "whole": med["whole"], "overload": overload}


def _check_repack(cfg, before, after, max_len, what):
    """A slot the degrade rung moved from a dense-KV arena into an nxfp4
    one: its K/V rows (up to ``pos``; a ring's: its window) bitwise
    ``repack_kv`` of the source's dense rows through the plain codec (on
    the CPU), its Mamba state (``h``, ``conv``) bitwise the source's.
    Returns (pos, rows held, K/V bytes held)."""
    from repro_torch.models.kvcache import cache_rows
    from repro_torch.serving import (pack_device_state, repack_kv,
                                     unpack_device_state)
    rows = cache_rows(cfg, max_len)
    pos = int(before["pos"][0])
    used = min(pos, rows)
    cpu = {"pos": before["pos"].cpu(),
           "layers": [{k: v.cpu() for k, v in layer.items()}
                      for layer in before["layers"]]}
    want = repack_kv(cfg, unpack_device_state(pack_device_state(cpu, used),
                                              rows), None, "nxfp4")
    n_bytes = 0
    for mine, src, ref in zip(after["layers"], cpu["layers"],
                              want["layers"]):
        for name, buf in mine.items():
            if name in ("h", "conv"):
                if not torch.equal(buf.cpu(), src[name]):
                    fail(f"{what}: the moved slot's {name} changed")
                continue
            if not torch.equal(buf[:, :used].cpu(), ref[name][:, :used]):
                fail(f"{what}: the repacked slot's {name} rows differ "
                     f"from the plain codec's encode of its dense rows")
            n_bytes += buf[:, :used].numel() * buf.element_size()
    return pos, used, n_bytes


def phase_tiers(n_layers, card):
    """``TieredContinuousEngine(default_tiers())`` at full width: phase
    8's requests spread over premium, standard and economy, both admission
    modes, every stream against its solo stream at its tier; a tier engine
    restricted to one tier against the plain engine; the degrade rung."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import batch_invariance
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params, read_cache_slot
    from repro_torch.serving import (ContinuousEngine, DegradeOverBudget,
                                     Status, TieredContinuousEngine,
                                     default_tiers, kv_row_bytes)
    from repro_torch.serving.engine import load_params

    # (c): the premium tier's bf16 weights (cuBLAS) and dense KV, a row at
    # B 4 and 8 against B 1, and a lane chunk's rows against the whole
    # prompt's, per op
    dense_inv = batch_invariance.measure(2, None)
    dense_lane = batch_invariance.measure_chunked(2, None, (TIER_P,))
    inv_bad = _held(dense_inv, ("dense_matmul", "decode_attention", "lm_head",
                                "softmax", "rmsnorm", "decode_step"),
                    batch_invariance.BATCHES)
    lane_bad = _held(dense_lane, ("dense_matmul", "prefill", "rmsnorm"),
                     (f"P={TIER_P}",) + tuple(
                         f"M={m}" for m in batch_invariance.GEMM_M
                         if m >= TIER_P))
    log(f"premium path invariance ({card}; bf16 weights through cuBLAS on "
        f"128-row tiles above 16 rows, dense KV through the dense-row "
        f"attention kernel; smoke Llama and Llama-3-8B full width, 2 "
        f"layers): a decode row at B {list(batch_invariance.BATCHES)} vs B "
        f"1: {len(inv_bad)} differing ops {sorted(inv_bad)}; the lane at P "
        f"{TIER_P} vs the whole prompt: {len(lane_bad)} differing ops "
        f"{sorted(lane_bad)}: {json.dumps({'decode': dense_inv, 'lane': dense_lane})}")
    if inv_bad or lane_bad:
        fail(f"premium path invariance: {sorted(inv_bad)} "
             f"{sorted(lane_bad)} differ")

    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=n_layers)
    raw = init_params(cfg, seed=0, device="cuda")
    # the model in bf16 (the premium tier's weight set; the casts below
    # read it): one dense copy serves every engine of the phase
    model = load_params(raw, QuantPolicy(None, None), torch.device("cuda"))
    del raw
    torch.cuda.empty_cache()
    tiers = default_tiers()
    rng_reqs = _continuous_requests(cfg)
    reqs = [dataclasses.replace(r, tier=TIER_OF[r.uid % 3])
            for r in rng_reqs]
    torch.cuda.reset_peak_memory_stats()
    whole = TieredContinuousEngine(cfg, model, tiers, n_slots=CONT_SLOTS,
                                   max_len=CONT_MAX_LEN, chunk=CONT_CHUNK,
                                   device="cuda")
    lane = TieredContinuousEngine(cfg, model, tiers, n_slots=CONT_SLOTS,
                                  max_len=CONT_MAX_LEN, chunk=CONT_CHUNK,
                                  prefill_mode="chunked", p_chunk=TIER_P,
                                  device="cuda")
    solo_of = {name: _TierSolo(cfg, whole._wparams[spec.weight_fmt],
                               spec.kv_fmt, spec.act_fmt)
               for name, spec in tiers.items()}
    solos = {r.uid: solo_of[r.tier](r) for r in reqs}

    journal = _Journal()
    reset_launch_counts()
    first = {"whole": whole.serve(reqs)}
    torch.cuda.synchronize()
    whole_counts = launch_counts()
    replays = lane.lane_replays, lane.replays
    first["chunked"] = lane.serve(reqs)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_econ = sum(r.tier == "economy" for r in reqs)
    qq_per = 7 * n_layers
    if whole_counts["nxfp_qq_matmul"] != qq_per * n_econ:
        fail(f"tiers: {whole_counts['nxfp_qq_matmul']} qq GEMM launches in "
             f"the whole serve, want 7 a layer x {n_layers} layers x "
             f"{n_econ} economy prefills")
    lane_qq = counts["nxfp_qq_matmul"] - whole_counts["nxfp_qq_matmul"]
    econ_graphs = [k for k in lane._lane_graphs if k[2] is not None]
    if lane_qq != 2 * qq_per * len(econ_graphs) or not econ_graphs:
        fail(f"tiers: {lane_qq} qq GEMM launches in the chunked serve's "
             f"lane graphs {econ_graphs} (a warm-up and a capture each), "
             f"want {2 * qq_per} a graph")
    if lane.lane_replays - replays[0] != lane.lane_chunks or \
            lane.replays - replays[1] != sum(lane.chunk_groups) or \
            whole.replays != sum(whole.chunk_groups):
        fail(f"tiers: a chunk ran outside its graph (lane {lane.lane_replays}"
             f" replays / {lane.lane_chunks} chunks, decode "
             f"{lane.replays} / {sum(lane.chunk_groups)} group dispatches)")
    if counts["dense_attention"] <= 0:
        fail("tiers: the premium tier never launched the dense-row "
             "attention kernel")
    figures = {"whole": [], "chunked": []}
    for mode in ("whole", "chunked", "chunked", "whole"):
        eng = whole if mode == "whole" else lane
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.serve(reqs)
        wall = time.perf_counter() - t0
        for res in (results, first.pop(mode, [])):
            for r in res:
                same = r.status == Status.OK and np.array_equal(
                    r.tokens, solos[r.uid])
                if same:
                    continue
                tier = reqs[r.uid].tier
                fail(f"tiers ({mode}): uid {r.uid} ({tier}, {r.status}) "
                     f"{r.tokens[:8].tolist()} ... differs from its solo "
                     f"stream {solos[r.uid][:8].tolist()} ...")
        by_tier = {t: statistics.median(r.ttft for r in results
                                        if reqs[r.uid].tier == t)
                   for t in TIER_OF}
        groups = {}
        for g, (live, sec) in zip(eng.chunk_groups, eng.chunk_times):
            groups.setdefault(g, []).append(sec * 1e3)
        figures[mode].append(dict(
            _serve_figures(eng, results, wall),
            ttft_median_by_tier={t: round(v, 4) for t, v in by_tier.items()},
            group_dispatches=sum(eng.chunk_groups),
            chunk_ms_by_groups={g: round(statistics.median(v), 3)
                                for g, v in sorted(groups.items())}))
    # one replay of each group's decode graph, every slot parked (a
    # chunk's cost follows its shapes, not the live rows)
    whole._upload(whole._host)
    group_ms = {f"{k[0]}/{k[1]} {'greedy' if k[2] else 'sampled'}":
                _replay_ms(g[0], 10) for k, g in whole._graphs.items()}
    admits = [e["uid"] for e in journal.records if e["event"] == "admit"]
    admit_s = {t: [] for t in TIER_OF}
    for uid, sec in zip(admits[-len(whole.admit_seconds):],
                        whole.admit_seconds):
        admit_s[reqs[uid].tier].append(round(sec, 4))

    # the tier engine restricted to one tier is the plain engine
    single = {}
    for name in ("standard", "premium"):
        spec = tiers[name]
        one = TieredContinuousEngine(cfg, model, {name: spec},
                                     n_slots=CONT_SLOTS,
                                     max_len=CONT_MAX_LEN, chunk=CONT_CHUNK,
                                     device="cuda")
        plain = ContinuousEngine(cfg, one._wparams[spec.weight_fmt],
                                 QuantPolicy(None, spec.kv_fmt),
                                 n_slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
                                 chunk=CONT_CHUNK, device="cuda")
        a = {r.uid: r.tokens for r in one.serve(rng_reqs)}
        b = {r.uid: r.tokens for r in plain.serve(rng_reqs)}
        bad = [u for u in a if not np.array_equal(a[u], b[u])]
        if bad:
            fail(f"tiers: the engine restricted to {name} differs from the "
                 f"plain engine at its policy in uids {bad}")
        single[name] = "bitwise"
        del one, plain
        torch.cuda.empty_cache()

    # the degrade rung: a premium request over the watermark is repacked
    # into the standard tier's arena once, its neighbour stays standard
    repacked = []
    repack = whole._repack_slot

    def spy(sched, slot, dst):
        before = read_cache_slot(whole._slot_cache(slot), slot)
        repack(sched, slot, dst)
        repacked.append((slot, before,
                         read_cache_slot(whole._slot_cache(slot), slot)))

    whole._repack_slot = spy
    whole.degrade_kv_to = "standard"
    whole.shedding = DegradeOverBudget(max_new_cap=None,
                                       pool_watermark=REPACK_WATERMARK)
    pair = [reqs[3], reqs[1]]          # premium (256 tokens), standard
    n_events = len(journal.records)
    rung = {r.uid: r for r in whole.serve(pair)}
    whole._repack_slot, whole.degrade_kv_to, whole.shedding = repack, None, \
        None
    events_ = [e for e in journal.records[n_events:]
               if e["event"] == "kv-repack"]
    if len(repacked) != 1 or len(events_) != 1 or \
            events_[0]["uid"] != 3 or not rung[3].degraded or \
            rung[1].degraded or rung[3].status != Status.OK:
        fail(f"degrade rung: {len(repacked)} repacks, events {events_}, "
             f"results {[(r.uid, r.status, r.degraded) for r in rung.values()]}")
    if not np.array_equal(rung[1].tokens, solos[1]):
        fail("degrade rung: the standard neighbour's stream moved")
    _, before, after = repacked[0]
    pos, _, n_bytes = _check_repack(cfg, before, after, CONT_MAX_LEN,
                                    "degrade rung")
    peak = torch.cuda.max_memory_allocated()
    arenas = {str(k): sum(b.numel() * b.element_size()
                          for layer in c["layers"] for b in layer.values())
              for k, c in whole._caches.items()}
    weights = {str(k): sum(
        (x.packed.numel() + x.meta.numel() * x.meta.element_size())
        if hasattr(x, "packed") else x.numel() * x.element_size()
        for layer in w["layers"] for x in layer.values())
        for k, w in whole._wparams.items()}
    def median_of(values):
        if isinstance(values[0], dict):
            return {k: median_of([v[k] for v in values if k in v])
                    for k in values[0]}
        return statistics.median(values)

    med = {mode: {k: median_of([f[k] for f in rows]) for k in rows[0]}
           for mode, rows in figures.items()}
    log(f"serving tiers ({card}): Llama-3-8B full width, {n_layers} layers "
        f"(bf16 model), default_tiers() {json.dumps({k: dataclasses.astuple(v) for k, v in tiers.items()})}, "
        f"{CONT_SLOTS} slots, chunk {CONT_CHUNK}, max_len {CONT_MAX_LEN}; "
        f"phase 8's 8 requests by uid % 3 over {TIER_OF}: every stream "
        f"equals its solo stream bitwise, whole and chunked (economy: the "
        f"amxfp4 prefill, whole and lane alike; premium: bf16 weights and "
        f"dense KV); one-tier engines vs the plain engine: {single}")
    for mode in figures:
        log(f"  {mode} ({card}) 3 serves (first captures): medians "
            f"{med[mode]}; by serve {figures[mode]}")
    log(f"  whole admission seconds by tier ({card}): {admit_s}")
    log(f"  one decode-chunk replay by (weights/KV) group ({card}; "
        f"CUDA events, median of 10; {CONT_SLOTS} slots x {CONT_CHUNK} "
        f"steps): {group_ms} ms")
    log(f"  launches on the tiered path (whole serve, then the chunked "
        f"serve's lane chunks and graph captures): whole {whole_counts}, "
        f"both {counts}; qq GEMM 7 a layer ({qq_per}) per economy prefill "
        f"and per lane-graph warm-up and capture "
        f"({sorted(map(str, lane._lane_graphs))})")
    log(f"  degrade rung: premium uid 3 repacked at occupancy >= "
        f"{REPACK_WATERMARK} ({events_[0]}), {pos} rows x {n_layers} layers "
        f"({n_bytes} packed bytes) bitwise the plain codec's encode of its "
        f"dense rows; degraded=True; its standard neighbour unchanged")
    log(f"  memory ({card}): weight sets {weights} bytes, KV arenas "
        f"{arenas} bytes (row bytes "
        f"{ {str(k): kv_row_bytes(cfg, k) for k in whole._caches} }), peak "
        f"{peak} bytes")
    del whole, lane, model
    torch.cuda.empty_cache()
    return counts, {"tiers": med, "admit_seconds": admit_s,
                    "group_ms": group_ms}


# phase 11: the rest of the dense family at full width (nxfp4 weights and
# KV, random weights from seed 0): requests served through
# ContinuousEngine, every stream against its solo stream
FAMILY = ("llama2_7b", "starcoder2_3b")
FAMILY_PROMPTS, FAMILY_NEW = (48, 160, 96, 256), (16, 8, 24, 12)
# H2O-Danube3-4B's 4096-row ring: a 4500-token prompt wraps it in prefill
# and, 24 tokens on, again in decode; whole admission and the lane at P
# 128, whose lane of 4224 rows is a ring too (4224 >= 4096 + 128): its
# chunks from offset 4224 on run the ring lane
DANUBE_MAX_LEN, DANUBE_P = 4224, 128
DANUBE_PROMPTS, DANUBE_NEW = (4500, 200, 64), (24, 16, 8)


def _family_requests(cfg, prompts, news):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(1)
    return [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m) for i, (t, m) in enumerate(zip(prompts, news))]


def _family_serve(arch, modes, max_len, prompts, news, card, n_layers):
    """``arch`` at full width and ``n_layers`` deep served through
    ``ContinuousEngine`` in each
    of ``modes`` ("whole", or a lane width), twice (the first serve
    captures the graphs), every stream against its solo host-loop stream;
    the kernels' launches over the first serves. Returns (launch counts,
    figures)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousEngine, ServeEngine, Status
    from repro_torch.serving.engine import load_params

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    t0 = time.time()
    raw = init_params(cfg, seed=0, device="cuda")
    params = load_params(raw, QuantPolicy("nxfp4", None),
                         torch.device("cuda"))
    del raw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cast_s = time.time() - t0
    reqs = _family_requests(cfg, prompts, news)
    policy = QuantPolicy(None, "nxfp4")         # the weights are cast
    solos = {}
    for req in reqs:
        out = ServeEngine(cfg, params, policy, max_len=max_len,
                          device="cuda").generate(
            {"tokens": req.tokens[None]}, max_new=req.max_new, loop="host")
        solos[req.uid] = out.tokens[0]
    reset_launch_counts()
    figures = {}
    for mode in modes:
        kw = ({} if mode == "whole" else
              dict(prefill_mode="chunked", p_chunk=mode))
        eng = ContinuousEngine(cfg, params, policy, n_slots=CONT_SLOTS,
                               max_len=max_len, chunk=CONT_CHUNK,
                               device="cuda", **kw)
        for serve in ("first", "second"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            results = eng.serve(reqs)
            wall = time.perf_counter() - t1
            for r in results:
                if r.status != Status.OK or not np.array_equal(
                        r.tokens, solos[r.uid]):
                    fail(f"{arch} ({mode}, {serve} serve): uid {r.uid} "
                         f"({r.status}) {r.tokens[:8].tolist()} ... differs "
                         f"from its solo stream {solos[r.uid][:8].tolist()}")
        if eng.replays == 0 or (mode != "whole"
                                and eng.lane_replays == 0):
            fail(f"{arch} ({mode}): no graph replays")
        figures[str(mode)] = dict(
            _serve_figures(eng, results, wall),
            lane_graphs=sorted(map(str, getattr(eng, "_lane_graphs", {}))))
        del eng
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = launch_counts()
    for name in ("nxfp_quantize", "nxfp_matmul", "nxfp_attention"):
        if counts[name] <= 0:
            fail(f"{arch}: kernel {name} was never launched")
    log(f"{arch} ({card}): full width, {cfg.n_layers} layers (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
        f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
        f"{cfg.sliding_window}), nxfp4 weights and KV, random weights "
        f"(seed 0, cast in {cast_s:.2f} s), {CONT_SLOTS} slots, chunk "
        f"{CONT_CHUNK}, max_len {max_len}; {len(reqs)} requests (prompts "
        f"{list(prompts)}, max_new {list(news)}) served {list(modes)} "
        f"twice: every stream equals its solo host-loop stream bitwise; "
        f"second serves {figures}; launches {counts}")
    del params
    torch.cuda.empty_cache()
    return counts, figures


def phase_dense_family(card, n_layers):
    """Llama-2-7B and StarCoder2-3B served whole, and H2O-Danube3-4B
    (window 4096) served whole and through the ring lane at P 128 with a
    prompt that wraps its ring, each at full width and ``n_layers`` deep
    (``--serving-layers``; their full depths, 32, 30 and 24, until phase
    18 came)."""
    out = {}
    for arch in FAMILY:
        out[arch] = _family_serve(arch, ("whole",), CONT_MAX_LEN,
                                  FAMILY_PROMPTS, FAMILY_NEW, card, n_layers)
    counts, figures = _family_serve(
        "h2o_danube_3_4b", ("whole", DANUBE_P), DANUBE_MAX_LEN,
        DANUBE_PROMPTS, DANUBE_NEW, card, n_layers)
    ring = [g for g in figures[str(DANUBE_P)]["lane_graphs"] if "ring" in g]
    if not ring:
        fail(f"h2o_danube_3_4b: the ring lane never ran (lane graphs "
             f"{figures[str(DANUBE_P)]['lane_graphs']})")
    out["h2o_danube_3_4b"] = counts, figures
    return out


# phase 12: the paged KV cache at full width (Llama-3-8B at
# --serving-layers, Danube at full depth)
PAGED_SLOTS, PAGED_MAX_LEN, PAGED_PAGE, PAGED_P = 8, 2048, 32, 32
# a quarter of the dense arena's pages (8 slots x 64 pages) and the null
# page
PAGED_POOL_PAGES = PAGED_SLOTS * (PAGED_MAX_LEN // PAGED_PAGE) // 4 + 1
# uids 0-7: long prompts whose pages (17-18 each) overrun the quarter pool
# together, so admission waits on pages; 8-11: a 256-token shared prefix
# and a tail each (8 shared pages); 12-15 short prompts
PAGED_PROMPTS = (512, 500, 490, 480, 512, 470, 505, 495,
                 None, None, None, None, 32, 64, 128, 200)
PAGED_NEW = (64, 64, 48, 64, 56, 64, 40, 64, 32, 16, 24, 48, 16, 24, 32, 40)
PAGED_PREFIX, PAGED_TAILS = 256, (16, 48, 80, 128)
PAGED_DENSE_KV_UIDS = (12, 13, 14, 15)   # the dense-KV (kv_fmt None) serve
# Danube: a registrar and two claimants of one 4000-token prompt; the
# claimants' 160 new tokens wrap the 4096-row ring into the shared pages
PAGED_DANUBE_PROMPT, PAGED_DANUBE_NEW = 4000, (4, 160, 160)


def _paged_requests(cfg):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(12)
    prefix = rng.integers(0, cfg.vocab, (PAGED_PREFIX,))
    tails = iter(PAGED_TAILS)
    reqs = []
    for uid, (t, m) in enumerate(zip(PAGED_PROMPTS, PAGED_NEW)):
        toks = (np.concatenate([prefix, rng.integers(0, cfg.vocab,
                                                     (next(tails),))])
                if t is None else rng.integers(0, cfg.vocab, (t,)))
        reqs.append(Request(uid=uid, tokens=toks, max_new=m))
    return reqs


def _arena_bytes(cache) -> int:
    """KV bytes of a cache's layer buffers (pool or arena; not the
    table)."""
    return sum(buf.numel() * buf.element_size()
               for layer in cache["layers"] for name, buf in layer.items()
               if name != "block")


def _serve_checked(eng, reqs, want, what):
    """One serve; every stream must be ``want``'s bitwise. Returns
    (results, wall seconds)."""
    import numpy as np
    from repro_torch.serving import Status
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(results) != len(reqs):
        fail(f"{what}: {len(results)} results for {len(reqs)} requests")
    for r in results:
        if r.status != Status.OK or (want is not None and not np.array_equal(
                r.tokens, want[r.uid])):
            fail(f"{what}: uid {r.uid} ({r.status}) {r.tokens[:8].tolist()}"
                 f" ... differs from the dense engine's stream "
                 f"{want[r.uid][:8].tolist() if want else None} ...")
    return results, wall


def _chunk_ms(eng) -> float:
    """Median host-clock ms of the serve's decode chunks with every slot
    live (all chunks when none had)."""
    full = [s for live, s in eng.chunk_times if live == eng.n_slots]
    return round(statistics.median(full or [s for _, s in eng.chunk_times])
                 * 1e3, 3)


def _engine_run(make, reqs, want, what):
    """Build an engine and serve ``reqs`` once (the serve captures its
    graphs): (engine, results, wall, peak device bytes of the engine over
    construction and serve, above what was allocated before: the cycle
    collector runs first, else an earlier engine freed mid-serve hides
    part of the peak)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = make()
    results, wall = _serve_checked(eng, reqs, want, what)
    return eng, results, wall, torch.cuda.max_memory_allocated() - base


def phase_paged(card: str, timer, n_layers: int):
    """The paged KV cache (``PagedContinuousEngine``) at full width and
    depth, every stream held bitwise against the dense ``ContinuousEngine``
    in the same process: Llama-3-8B (nxfp4 weights and KV; 16 requests
    into 8 slots, max_len 2048, chunk 16, a pool of a quarter of the dense
    arena) whole and through the lane at P 32, the dense-KV cache (4 of
    the requests), and H2O-Danube3-4B's ring wrapping into shared pages
    (COW). The kernels' launches are counted over the paged serves only.
    Returns (launch counts, figures)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.models.kvcache import paged_layer_view
    from repro_torch.serving import (ContinuousEngine,
                                     PagedContinuousEngine)
    from repro_torch.serving.engine import load_params

    t0 = time.time()
    fig = {}

    def cast(arch, depth=None):
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        raw = init_params(cfg, seed=0, device="cuda")
        params = load_params(raw, QuantPolicy("nxfp4", None),
                             torch.device("cuda"))
        del raw
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return cfg, params

    cfg, params = cast("llama3_8b", n_layers)
    reqs = _paged_requests(cfg)
    dense_kv_reqs = [reqs[u] for u in PAGED_DENSE_KV_UIDS]
    packed, dense_kv = QuantPolicy(None, "nxfp4"), QuantPolicy(None, None)
    base_kw = dict(n_slots=PAGED_SLOTS, max_len=PAGED_MAX_LEN,
                   chunk=CONT_CHUNK, device="cuda")
    paged_kw = dict(base_kw, page_size=PAGED_PAGE,
                    n_pages=PAGED_POOL_PAGES)
    # the oracles: the dense engine's streams
    dense, res, wall, peak_dense = _engine_run(
        lambda: ContinuousEngine(cfg, params, packed, **base_kw), reqs, None,
        "dense engine")
    want = {r.uid: r.tokens for r in res}
    dense_bytes = _arena_bytes(dense.cache)
    eng_kv, res, _, _ = _engine_run(
        lambda: ContinuousEngine(cfg, params, dense_kv, **base_kw),
        dense_kv_reqs, None, "dense engine, dense KV")
    want_kv = {r.uid: r.tokens for r in res}
    del eng_kv
    dcfg, dparams = cast("h2o_danube_3_4b")
    dprompt = np.random.default_rng(13).integers(0, dcfg.vocab,
                                                 (PAGED_DANUBE_PROMPT,))
    from repro_torch.serving import Request
    dreqs = [Request(uid=i, tokens=dprompt.copy(), max_new=m)
             for i, m in enumerate(PAGED_DANUBE_NEW)]
    dkw = dict(n_slots=2, max_len=dcfg.sliding_window, chunk=CONT_CHUNK,
               device="cuda")
    eng_d, res, _, _ = _engine_run(
        lambda: ContinuousEngine(dcfg, dparams, packed, **dkw), dreqs, None,
        "Danube dense engine")
    want_d = {r.uid: r.tokens for r in res}
    del eng_d

    # the paged serves, counted
    reset_launch_counts()
    gate_log = []

    def gated(eng):
        gate = eng._admission_gate

        def spy(req, shard, resumable):
            ok = gate(req, shard, resumable)
            gate_log.append(ok)
            return ok
        eng._admission_gate = spy
        return eng

    paged, _, wall_p, peak_paged = _engine_run(
        lambda: gated(PagedContinuousEngine(cfg, params, packed,
                                            **paged_kw)),
        reqs, want, "paged engine (whole)")
    st = paged.pool_stats()[0]
    pool_bytes = _arena_bytes(paged.cache)
    if st["prefix_hits"] < 1:
        fail(f"paged engine: no prefix hit ({st})")
    if False not in gate_log:
        fail("paged engine: admission never waited on pages")
    if st["high_watermark"] > paged.pool.capacity:
        fail(f"paged engine: high watermark {st['high_watermark']} over "
             f"capacity {paged.pool.capacity}")
    paged.pool.assert_empty()
    if 4 * pool_bytes > dense_bytes + 4 * pool_bytes // PAGED_POOL_PAGES:
        fail(f"paged pool {pool_bytes} B is over a quarter of the dense "
             f"arena {dense_bytes} B (plus the null page)")
    fig["whole"] = dict(pool_stats=st, gate_refusals=gate_log.count(False))
    lane, _, wall_l, _ = _engine_run(
        lambda: PagedContinuousEngine(cfg, params, packed,
                                      prefill_mode="chunked",
                                      p_chunk=PAGED_P, **paged_kw),
        reqs, want, f"paged engine (lane, P {PAGED_P})")
    if lane.lane_replays == 0:
        fail("paged engine (lane): no lane graph replays")
    lane.pool.assert_empty()
    fig["lane"] = dict(pool_stats=lane.pool_stats()[0],
                       lane_chunks=lane.lane_chunks, seconds=round(wall_l, 3))
    del lane
    pkv, _, _, _ = _engine_run(
        lambda: PagedContinuousEngine(cfg, params, dense_kv, **paged_kw),
        dense_kv_reqs, want_kv, "paged engine (dense KV)")
    pkv.pool.assert_empty()
    del pkv
    dpaged, _, _, _ = _engine_run(
        lambda: PagedContinuousEngine(dcfg, dparams, packed,
                                      page_size=PAGED_PAGE, **dkw),
        dreqs, want_d, "Danube paged engine")
    dst = dpaged.pool_stats()[0]
    if dst["prefix_hits"] < 1 or dst["cow_breaks"] < 1:
        fail(f"Danube paged engine: no prefix hit or COW break ({dst})")
    dpaged.pool.assert_empty()
    fig["danube"] = dst
    del dpaged, dparams
    torch.cuda.synchronize()
    counts = launch_counts()
    for name in ("nxfp_quantize", "nxfp_matmul", "nxfp_attention",
                 "dense_attention"):
        if counts[name] <= 0:
            fail(f"paged path: kernel {name} was never launched")

    # C4: the two engines' later serves in turns (paged, dense, dense,
    # paged); ms a decode chunk with every slot live, host clock
    rounds = {"paged": [], "dense": []}
    for name, eng in (("paged", paged), ("dense", dense), ("dense", dense),
                      ("paged", paged)):
        res, wall = _serve_checked(eng, reqs, want, f"{name} (timed)")
        n_tok = sum(r.n_generated for r in res)
        rounds[name].append(dict(tok_s=round(n_tok / wall, 2),
                                 chunk_ms=_chunk_ms(eng),
                                 seconds=round(wall, 3)))
    paged.pool.assert_empty()
    # the gather's share of a decode step: every layer's views of 8 full
    # slots (every table entry a page), one layer alive at a time as in
    # the decode graph, replayed as a CUDA graph (device time, CUDA
    # events), against a paged decode step of the timed serves
    for slot in range(PAGED_SLOTS):
        paged._write_table(slot, list(range(1 + 16 * slot, 17 + 16 * slot))
                           * 4)
    layers = paged.cache["layers"]

    def gather_all():
        out = None
        for layer in layers:
            out = paged_layer_view(layer)
        return out

    from repro_torch.serving.engine import capture_graph
    graph, _ = capture_graph(gather_all, torch.device("cuda"))
    gather_ms = _replay_ms(graph)
    eager_ms = timer(gather_all, 5)
    del graph
    for slot in range(PAGED_SLOTS):
        paged._write_table(slot, [])
    step_ms = statistics.median(r["chunk_ms"] for r in rounds["paged"]) \
        / CONT_CHUNK
    fig.update(rounds=rounds, gather_ms=round(gather_ms, 4),
               gather_eager_ms=round(eager_ms, 4),
               gather_share=round(gather_ms / step_ms, 4),
               pool_bytes=pool_bytes, arena_bytes=dense_bytes,
               peak_paged=peak_paged, peak_dense=peak_dense,
               seconds=round(time.time() - t0, 1))
    log(f"paged KV ({card}): Llama-3-8B full width, {cfg.n_layers} layers, "
        f"nxfp4 weights"
        f" and KV, {PAGED_SLOTS} slots, chunk {CONT_CHUNK}, max_len "
        f"{PAGED_MAX_LEN}, page {PAGED_PAGE}, {PAGED_POOL_PAGES} pages; 16 "
        f"requests (prompts 32-512, max_new 16-64, uids 8-11 extending one "
        f"{PAGED_PREFIX}-token prefix): every stream equals the dense "
        f"engine's bitwise, whole and through the lane at P {PAGED_P}; "
        f"dense KV (uids {list(PAGED_DENSE_KV_UIDS)}) bitwise too; "
        f"H2O-Danube3-4B (24 layers) registrar + 2 claimants of a "
        f"{PAGED_DANUBE_PROMPT}-token prompt, ring wrapped into shared "
        f"pages: bitwise; every pool empty after its serve")
    log(f"  pool ({card}): {fig['whole']['pool_stats']}; admission refused "
        f"on pages {fig['whole']['gate_refusals']} times; lane "
        f"{fig['lane']}; Danube {fig['danube']}")
    log(f"  KV bytes: pool {pool_bytes} (paged) vs arena {dense_bytes} "
        f"(dense), {pool_bytes / dense_bytes:.4f}; peak device memory above"
        f" the weights ({card}), construction and first serve: paged "
        f"{peak_paged}, dense {peak_dense}")
    log(f"  second serves in turns ({card}): {rounds}")
    log(f"  the gather ({card}): {cfg.n_layers} layers' views of 8 slots x "
        f"{PAGED_MAX_LEN} rows, "
        f"{2 * PAGED_SLOTS * PAGED_MAX_LEN * 1152 * cfg.n_layers}"
        f" bytes read and written, {gather_ms:.4f} ms a step as a graph "
        f"replay ({eager_ms:.4f} ms eager, launches included), "
        f"{fig['gather_share']:.4f} of a paged decode step ({step_ms:.3f} "
        f"ms, the timed serves' median chunk / {CONT_CHUNK})")
    log(f"  launches on the paged path (the paged serves' first serves, "
        f"graph warm-ups and captures included): {counts}; phase 12 "
        f"{fig['seconds']} s")
    del paged, dense, params
    torch.cuda.empty_cache()
    return counts, fig


# phase 13: the SSM and hybrid families at full width and depth (nxfp4
# weights, random from seed 0; Hymba's KV nxfp4 in its 1024-row ring)
FALCON, HYMBA = "falcon_mamba_7b", "hymba_1_5b"
SSM_P = 256                  # the lane's width: ssm_chunk at full width
FALCON_MAX_LEN, HYMBA_MAX_LEN = 2048, 1280
# several lane chunks and ragged tails; Hymba's 2600 tokens wrap its ring,
# and its lane of 1280 rows (>= 1024 + 256) is a ring: the chunks from
# offset 1280 on run the ring lane
FALCON_PROMPTS, FALCON_NEW = (1000, 300, 64), (8, 16, 8)
HYMBA_PROMPTS, HYMBA_NEW = (2600, 300, 64), (8, 16, 8)
# the whole prefill's state against the lane's: two lane chunks with a
# ragged tail, and a prompt shorter than ssm_chunk
SSM_LANE_PROMPTS = (300, 64)
# Hymba's paged serve: four requests extending one 512-token prefix
HYMBA_PREFIX, HYMBA_TAILS, HYMBA_PAGED_NEW = 512, (40, 100, 180, 260), \
    (8, 16, 12, 8)
SSM_STEPS = 32               # ServeEngine: 4 x 128-token prompts, 32 new
SSM_ROWS = (128, 100, 64, 37)   # the decode step's rows (prompt lengths)
# the kernels at the families' shapes: the dequant GEMM's (K, N) pairs
# (Falcon's ssm_in_w, ssm_x_w (N 288), ssm_dt_w, ssm_out_w; Hymba's wq/wo,
# wk/wv, w1/w3, w2, ssm_in_w, ssm_x_w (N 132), ssm_dt_w (K 100, padded to
# 128), ssm_out_w) at a decode batch and a prefill, decode attention at
# Hymba's heads over its ring, the quantizer on two of the casts and on
# Hymba's K/V writes (head_dim 64: 2 blocks) into the ring
SSM_KN = ((4096, 16384), (8192, 288), (256, 8192), (8192, 4096),
          (1600, 1600), (1600, 320), (1600, 5504), (5504, 1600),
          (1600, 6400), (3200, 132), (100, 3200), (3200, 1600))
SSM_M = (4, 512)
SSM_ATTENTION = (((5, 5, 64), 1024, (1024, 700, 33, 1)),)
SSM_CASTS = {"nxfp_quantize falcon ssm_in_w": (4096, 16384),
             "nxfp_quantize hymba ssm_dt_w": (100, 3200)}
SSM_KV = {"decode hymba": (1, (1023, 0, 17, 700), 64, 1024, 5),
          "prefill hymba": (256, None, 64, 1024, 5)}


def check_ssm_kernels(timer, rows):
    """Every kernel at the SSM and hybrid families' new shapes, held and
    timed as the rows above are."""
    check_matmul(timer, rows, SSM_KN, SSM_M)
    check_attention(timer, rows, SSM_ATTENTION)
    for key, shape in SSM_CASTS.items():
        check_quantizer(timer, rows, shape, key)
    check_kv_write(timer, rows, SSM_KV)
    torch.cuda.empty_cache()


def _cast_family(arch, n_layers=None):
    """``arch`` at full width and depth (or ``n_layers``): random weights
    from seed 0, cast to nxfp4 on the card (``load_params``). Returns (cfg,
    params, seconds)."""
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving.engine import load_params
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.time()
    raw = init_params(cfg, seed=0, device="cuda")
    params = load_params(raw, QuantPolicy("nxfp4", None),
                         torch.device("cuda"))
    del raw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, params, time.time() - t0


def _solo_streams(cfg, params, reqs, max_len):
    """Each request served alone by ``ServeEngine``'s host loop."""
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, params, QuantPolicy(None, "nxfp4"),
                      max_len=max_len, device="cuda")
    return {r.uid: eng.generate({"tokens": r.tokens[None]},
                                max_new=r.max_new, loop="host").tokens[0]
            for r in reqs}


def _clone_cache(cache):
    return {"pos": cache["pos"].clone(),
            "layers": [{k: v.clone() for k, v in lc.items()}
                       for lc in cache["layers"]]}


def _ssm_invariance(cfg, params, what):
    """One decode step of rows prefilled alone (``SSM_ROWS`` tokens): each
    row's f32 logits and every layer's ``h``/``conv`` at B 4 against B 1,
    bitwise, and the step as a captured CUDA graph against the eager
    step (its warm-up puts the state back: no step integrated twice)."""
    import numpy as np
    from repro_torch.models import decode_step, prefill, recurrent_state
    from repro_torch.serving.engine import capture_graph
    rng = np.random.default_rng(21)
    rows = []
    for t in SSM_ROWS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, t)),
                               device="cuda")
        logits, cache = prefill(cfg, params, {"tokens": toks}, max_len=256,
                                kv_fmt="nxfp4")
        rows.append((logits.argmax(-1).to(torch.int32), cache))

    def batch(idx):
        cache = {"pos": torch.cat([rows[i][1]["pos"] for i in idx]),
                 "layers": [{k: torch.cat([rows[i][1]["layers"][li][k]
                                           for i in idx])
                             for k in rows[0][1]["layers"][li]}
                            for li in range(cfg.n_layers)]}
        return torch.cat([rows[i][0] for i in idx])[:, None], cache

    tok4, c4 = batch(range(4))
    static = _clone_cache(c4)
    l4, c4 = decode_step(cfg, params, tok4, c4, "nxfp4")
    moved = []
    for i in range(4):
        tok1, c1 = batch([i])
        l1, c1 = decode_step(cfg, params, tok1, c1, "nxfp4")
        if not torch.equal(l4[i], l1[0]):
            moved.append(f"row {i} logits")
        for li, (a, b) in enumerate(zip(c4["layers"], c1["layers"])):
            for name in ("h", "conv"):
                if not torch.equal(a[name][i:i + 1], b[name]):
                    moved.append(f"row {i} layer {li} {name}")
    if moved:
        fail(f"{what}: a decode row at B 4 differs from B 1: {moved[:8]}")
    graph, out = capture_graph(
        lambda: decode_step(cfg, params, tok4, static, "nxfp4")[0],
        torch.device("cuda"), keep=recurrent_state(static))
    graph.replay()
    if not torch.equal(out, l4) or not all(
            torch.equal(a[n], b[n]) for a, b in zip(static["layers"],
                                                    c4["layers"])
            for n in ("h", "conv")):
        fail(f"{what}: the decode step's graph replay differs from the "
             "eager step")
    # where a step's time goes: the step's replay against a replay of its
    # dequant GEMMs alone (every layer's, at B 4) and one of the head
    step_ms = _replay_ms(graph)
    from repro_torch.kernels.ops import qmatmul
    xs = {}

    def gemms():
        for lp in params["layers"]:
            for name, w in lp.items():
                if hasattr(w, "packed"):
                    k = w.shape[0]
                    if k not in xs:
                        xs[k] = torch.ones((4, k), dtype=torch.bfloat16,
                                           device="cuda")
                    qmatmul(xs[k], w)

    def head():
        qmatmul(torch.ones((4, cfg.d_model), dtype=torch.bfloat16,
                           device="cuda"), params["lm_head"])

    shares = {"step_ms": step_ms}
    for key, fn in (("gemm_ms", gemms), ("head_ms", head)):
        g, _ = capture_graph(fn, torch.device("cuda"))
        shares[key] = _replay_ms(g)
        del g
    shares["rest_share"] = round(
        1 - (shares["gemm_ms"] + shares["head_ms"]) / step_ms, 4)
    del graph, out, static
    return shares


def _lane_state_check(cfg, params, prompts, max_len, what):
    """Each prompt's whole prefill against the lane at ``SSM_P``: the final
    chunk's logits and the slot's ``h``/``conv`` in every layer, bitwise
    (a prompt shorter than ``ssm_chunk`` scans its length whole and
    ``SSM_P`` steps with an identity tail in the lane)."""
    import numpy as np
    from repro_torch.models import (init_cache, init_lane, prefill,
                                    prefill_chunk)
    rng = np.random.default_rng(22)
    lane = init_lane(cfg, max_len, SSM_P, device="cuda")
    for t in prompts:
        toks = rng.integers(0, cfg.vocab, (t,))
        want, whole = prefill(cfg, params, {"tokens": torch.as_tensor(
            toks[None], device="cuda")}, max_len, "nxfp4")
        cache = init_cache(cfg, 2, max_len, "nxfp4", device="cuda")
        for off in range(0, t, SSM_P):
            n = min(SSM_P, t - off)
            chunk = np.zeros((1, SSM_P), np.int64)
            chunk[0, :n] = toks[off:off + n]
            logits, cache, lane = prefill_chunk(
                cfg, params, torch.as_tensor(chunk, device="cuda"), cache,
                1, off, n, lane, "nxfp4", with_head=off + n >= t)
        bad = [f"layer {li} {name}"
               for li, (a, b) in enumerate(zip(cache["layers"],
                                               whole["layers"]))
               for name in ("h", "conv") if not torch.equal(a[name][1],
                                                            b[name][0])]
        if not torch.equal(logits, want) or bad:
            fail(f"{what}: a {t}-token prompt's lane (P {SSM_P}) differs "
                 f"from its whole prefill: logits "
                 f"{torch.equal(logits, want)}, state {bad[:6]}")
        del cache, whole
    del lane
    torch.cuda.empty_cache()


def _state_bytes(cfg) -> int:
    """A slot's Mamba state over all layers: h (f32) and the conv tail."""
    return cfg.n_layers * (cfg.dinner * cfg.ssm_state * 4
                           + (cfg.conv_width - 1) * cfg.dinner
                           * torch.finfo(cfg.dtype).bits // 8)


def _checked_serves(make, reqs, want, what):
    """Build an engine and serve ``reqs`` once (the serve captures the
    graphs), every stream ``want``'s bitwise. Returns (the engine, the
    serve's figures with ``peak``: device bytes of the engine over
    construction and serve, above what was allocated before)."""
    eng, results, wall, peak = _engine_run(make, reqs, want, what)
    return eng, dict(_serve_figures(eng, results, wall), peak=peak)


def _family_requests_of(cfg, prompts, news, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m) for i, (t, m) in enumerate(zip(prompts, news))]


def _counted(fn, into):
    """Run ``fn`` with every launch count set to 0 just before it; add the
    counts read just after it to ``into``. Returns ``fn()``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = fn()
    for k, v in launch_counts().items():
        into[k] = into.get(k, 0) + v
    return out


def _sum_counts(*parts):
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def phase_falcon(card, n_layers):
    """Falcon-Mamba-7B (attention-free) at full width and ``n_layers``
    deep (``--serving-layers``; its 64 until phase 18 came): the
    graph device loop against the host loop, the decode step's invariance
    and the lane's state, then ``ContinuousEngine`` whole and at P 256 and
    ``PagedContinuousEngine`` (no pages: no attention), every stream its
    solo host-loop stream. Launches are counted around the cast, the
    device loops and the engines' serves alone, never around an oracle.
    Returns (launch counts by path, figures)."""
    import numpy as np
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                     ServeEngine)
    t0 = time.time()
    # free what earlier phases left to the cycle collector: else it may
    # free it during the cast and the weights' bytes read too low
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts = {"cast": {}, "graph_loop": {}, "engines": {}}
    cfg, params, cast_s = _counted(lambda: _cast_family(FALCON, n_layers),
                                   counts["cast"])
    peak_cast = torch.cuda.max_memory_allocated() - base
    weights = torch.cuda.memory_allocated() - base
    policy = QuantPolicy(None, "nxfp4")          # the weights are cast
    fig = dict(cast_s=round(cast_s, 2))
    # ServeEngine: the graph device loop against the host loop
    eng = ServeEngine(cfg, params, policy, max_len=256, device="cuda")
    batch = {"tokens": np.random.default_rng(20).integers(
        0, cfg.vocab, (4, 128))}
    runs = _counted(lambda: [
        eng.generate(batch, max_new=SSM_STEPS, loop="device", chunk=16)
        for _ in range(3)], counts["graph_loop"])
    host = eng.generate(batch, max_new=SSM_STEPS, loop="host")
    for r in runs:
        if not np.array_equal(r.tokens, host.tokens) or not (
                r.n_generated == SSM_STEPS).all():
            fail("falcon: the graph device loop and the host loop disagree")
    graph_ms = statistics.median(r.decode_seconds for r in runs[1:]) \
        / SSM_STEPS * 1e3
    fig.update(graph_ms_step=round(graph_ms, 3),
               host_ms_step=round(host.decode_seconds / SSM_STEPS * 1e3, 3),
               tok_s=round(4e3 / graph_ms, 2),
               prefill_s=round(runs[-1].prefill_seconds, 4))
    logits, cache = prefill(cfg, params, {"tokens": torch.as_tensor(
        batch["tokens"], device="cuda")}, max_len=256, kv_fmt="nxfp4")
    fig["launches_per_step"] = {}
    _counted(lambda: decode_step(
        cfg, params, logits.argmax(-1).to(torch.int32)[:, None], cache,
        "nxfp4"), fig["launches_per_step"])
    if fig["launches_per_step"]["nxfp_matmul"] != 4 * cfg.n_layers:
        fail(f"falcon: {fig['launches_per_step']} launches a decode step, "
             f"expected 4 GEMMs a layer")
    del eng, cache, logits, runs, host
    fig["step_split"] = _ssm_invariance(cfg, params, "falcon")
    _lane_state_check(cfg, params, SSM_LANE_PROMPTS, FALCON_MAX_LEN,
                      "falcon")
    reqs = _family_requests_of(cfg, FALCON_PROMPTS, FALCON_NEW, 23)
    solos = _solo_streams(cfg, params, reqs, FALCON_MAX_LEN)
    kw = dict(n_slots=CONT_SLOTS, max_len=FALCON_MAX_LEN, chunk=CONT_CHUNK,
              device="cuda")
    serves = {}
    for mode, extra in (("whole", {}), (f"P {SSM_P}", dict(
            prefill_mode="chunked", p_chunk=SSM_P))):
        ceng, serves[mode] = _counted(lambda: _checked_serves(
            lambda: ContinuousEngine(cfg, params, policy, **kw, **extra),
            reqs, solos, f"falcon {mode}"), counts["engines"])
        if ceng.replays == 0 or (extra and ceng.lane_replays == 0):
            fail(f"falcon {mode}: no graph replays")
        del ceng
    peng, serves["paged"] = _counted(lambda: _checked_serves(
        lambda: PagedContinuousEngine(cfg, params, policy, **kw), reqs,
        solos, "falcon paged"), counts["engines"])
    if any("block" in lc or any(n.startswith("pool_") for n in lc)
           for lc in peng.cache["layers"]) or peng.pool is not None:
        fail("falcon paged: an attention-free cache holds pages")
    del peng
    # an attention-free model quantizes only in the cast (no K/V)
    for path, name in (("cast", "nxfp_quantize"),
                       ("graph_loop", "nxfp_matmul"),
                       ("engines", "nxfp_matmul")):
        if counts[path][name] <= 0:
            fail(f"falcon: kernel {name} was never launched ({path})")
    fig.update(serves=serves, peak_cast=peak_cast, weights=weights,
               base=base, state_bytes_slot=_state_bytes(cfg),
               seconds=round(time.time() - t0, 1))
    log(f"falcon_mamba_7b ({card}): full width, {cfg.n_layers} layers "
        f"(d_model {cfg.d_model}, d_inner {cfg.dinner}, ssm_state "
        f"{cfg.ssm_state}, dt_rank {cfg.dtrank}, vocab {cfg.vocab}), nxfp4 "
        f"weights (seed 0, init + cast {cast_s:.2f} s, peak {peak_cast} "
        f"bytes above the {base} bytes allocated before, {weights} bytes "
        f"kept); ServeEngine 4 x 128 tokens, {SSM_STEPS} new: graph device "
        f"loop == host loop; decode {fig['graph_ms_step']} ms/step (graph, "
        f"{fig['tok_s']} tok/s) vs host loop {fig['host_ms_step']} ms/step; "
        f"launches a decode step {fig['launches_per_step']}; a decode row "
        f"at B 4 == B 1 and graph replay == eager (logits and h/conv, "
        f"bitwise); whole prefill's state == the lane's at P {SSM_P} "
        f"({' and '.join(map(str, SSM_LANE_PROMPTS))} tokens); a B 4 "
        f"decode step as graph replays (CUDA events): {fig['step_split']} "
        f"(the step, its dequant GEMMs alone, the head alone, the rest's "
        f"share: the Mamba step's elementwise work and the norms)")
    log(f"  falcon serves ({card}; prompts {list(FALCON_PROMPTS)}, max_new "
        f"{list(FALCON_NEW)}, {CONT_SLOTS} slots, max_len "
        f"{FALCON_MAX_LEN}): whole, P {SSM_P} and paged (no pages) every "
        f"stream == its solo host-loop stream: {serves}; launches (each "
        f"path counted alone, oracles outside): {counts}; phase 13 falcon "
        f"{fig['seconds']} s")
    del params
    torch.cuda.empty_cache()
    return counts, fig


def phase_hymba(card, n_layers):
    """Hymba-1.5B (``n_layers`` deep, ``--serving-layers``: its 32 until
    phase 22 came; windowed attention and a Mamba head) at full
    width: the decode step's invariance and the lane's state, then
    ``ContinuousEngine`` whole and at P 256 (a prompt that wraps the ring
    and runs the ring lane), and ``PagedContinuousEngine`` at P 256 with
    four requests extending one prefix, every stream bitwise its oracle.
    Launches are counted around the cast and the engines' serves alone.
    Returns (launch counts by path, figures)."""
    import numpy as np
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                     Request)
    t0 = time.time()
    counts = {"cast": {}, "engines": {}}
    cfg, params, cast_s = _counted(lambda: _cast_family(HYMBA, n_layers),
                                   counts["cast"])
    policy = QuantPolicy(None, "nxfp4")
    step_split = _ssm_invariance(cfg, params, "hymba")
    _lane_state_check(cfg, params, SSM_LANE_PROMPTS, HYMBA_MAX_LEN, "hymba")
    reqs = _family_requests_of(cfg, HYMBA_PROMPTS, HYMBA_NEW, 24)
    solos = _solo_streams(cfg, params, reqs, HYMBA_MAX_LEN)
    kw = dict(n_slots=CONT_SLOTS, max_len=HYMBA_MAX_LEN, chunk=CONT_CHUNK,
              device="cuda")
    lane_kw = dict(prefill_mode="chunked", p_chunk=SSM_P)
    # the lane through p_chunk="auto": of the default candidates and 256
    # only 256 is a multiple of ssm_chunk, so the sweep times one width
    auto_kw = dict(prefill_mode="chunked", p_chunk="auto",
                   p_chunk_candidates=(16, 32, 64, 128, SSM_P))
    prefix = np.random.default_rng(25).integers(0, cfg.vocab, (HYMBA_PREFIX,))
    tails = np.random.default_rng(26)
    preqs = [Request(uid=i, tokens=np.concatenate(
        [prefix, tails.integers(0, cfg.vocab, (t,))]), max_new=m)
        for i, (t, m) in enumerate(zip(HYMBA_TAILS, HYMBA_PAGED_NEW))]
    serves = {}
    for mode, extra in (("whole", {}), (f"P {SSM_P} (auto)", auto_kw)):
        eng, serves[mode] = _counted(lambda: _checked_serves(
            lambda: ContinuousEngine(cfg, params, policy, **kw, **extra),
            reqs, solos, f"hymba {mode}"), counts["engines"])
        if extra and (eng.p_chunk != SSM_P
                      or sorted(eng.p_chunk_sweep) != [SSM_P]):
            fail(f"hymba: p_chunk='auto' swept {eng.p_chunk_sweep} and "
                 f"picked {eng.p_chunk}, expected {SSM_P} alone")
        if extra:
            graphs = sorted(map(str, eng._lane_graphs))
            serves[mode]["lane_graphs"] = graphs
            if not any("ring" in g for g in graphs):
                fail(f"hymba: the ring lane never ran (lane graphs "
                     f"{graphs})")
            # the paged serve's oracle (not counted): the dense engine at
            # the lane's P
            want = {r.uid: r.tokens for r in eng.serve(preqs)}
        if eng.replays == 0 or (extra and eng.lane_replays == 0):
            fail(f"hymba {mode}: no graph replays")
        arena = _arena_bytes(eng.cache)
        del eng
    peng, serves["paged"] = _counted(lambda: _checked_serves(
        lambda: PagedContinuousEngine(cfg, params, policy, **kw, **lane_kw),
        preqs, want, "hymba paged"), counts["engines"])
    st = peng.pool_stats()[0]
    if st["prefix_hits"] < 1:
        fail(f"hymba paged: no prefix hit ({st})")
    peng.pool.assert_empty()
    serves["paged"]["pool_stats"] = st
    del peng
    for name in ("nxfp_quantize", "nxfp_matmul", "nxfp_attention"):
        if counts["engines"][name] <= 0:
            fail(f"hymba: kernel {name} was never launched by the engines")
    kv_slot = arena // CONT_SLOTS - _state_bytes(cfg)
    fig = dict(cast_s=round(cast_s, 2), serves=serves, step_split=step_split,
               state_bytes_slot=_state_bytes(cfg), kv_bytes_slot=kv_slot,
               seconds=round(time.time() - t0, 1))
    log(f"hymba_1_5b ({card}): full width, {cfg.n_layers} layers (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
        f"head_dim {cfg.hd}, window {cfg.sliding_window}, d_ff {cfg.d_ff}, "
        f"d_inner {cfg.dinner}, vocab {cfg.vocab}), nxfp4 weights and KV "
        f"(seed 0, init + cast {cast_s:.2f} s); a decode row at B 4 == B 1 "
        f"and graph replay == eager (logits and h/conv, bitwise); whole "
        f"prefill's state == the lane's at P {SSM_P} "
        f"({' and '.join(map(str, SSM_LANE_PROMPTS))} tokens); a B 4 "
        f"decode step as graph replays: {step_split}")
    log(f"  hymba serves ({card}; prompts {list(HYMBA_PROMPTS)}, max_new "
        f"{list(HYMBA_NEW)}, {CONT_SLOTS} slots, max_len {HYMBA_MAX_LEN}; "
        f"paged: {len(preqs)} requests extending one {HYMBA_PREFIX}-token "
        f"prefix, P {SSM_P}, against the dense engine): every stream "
        f"bitwise its oracle: {serves}; launches (each path counted alone, "
        f"oracles outside): {counts}; phase 13 hymba {fig['seconds']} s")
    del params
    torch.cuda.empty_cache()
    return counts, fig


def phase_ssm_family(card, n_layers):
    """Phase 13: Falcon-Mamba-7B, then Hymba-1.5B, both ``n_layers``
    deep."""
    t0 = time.time()
    fcounts, ffig = phase_falcon(card, n_layers)
    hcounts, hfig = phase_hymba(card, n_layers)
    llama_kv = 2048 * 36864        # Llama-3-8B's nxfp4 KV, 36,864 B a token
    log(f"  state per slot ({card}): falcon {ffig['state_bytes_slot']} bytes"
        f" of h and conv (Llama-3-8B's nxfp4 KV at 2048 tokens: {llama_kv};"
        f" equal at {ffig['state_bytes_slot'] / 36864:.0f} tokens); hymba "
        f"{hfig['state_bytes_slot']} bytes of h and conv + "
        f"{hfig['kv_bytes_slot']} bytes of nxfp4 KV in its ring; phase 13 "
        f"seconds {time.time() - t0:.1f}")
    return {FALCON: (fcounts, ffig), HYMBA: (hcounts, hfig)}


# phase 14: self-speculative decoding at full width and --serving-layers
# (Llama-3-8B under two pairings, Hymba-1.5B, Falcon-Mamba-7B), every
# greedy stream bitwise the plain engine's
SPEC_K = 4
SPEC_MAX_LEN = 512
SPEC_PROMPTS = (32, 64, 128, 256, 32, 64, 128, 256)
SPEC_NEW = (32, 40, 48, 56, 64, 32, 40, 48)
SPEC_SAMPLED = (0.9, 31)            # one sampled request: temperature, seed
SPEC_FULL = 448                     # + 64 new == SPEC_MAX_LEN
SPEC_VERIFY_B, SPEC_VERIFY_Q, SPEC_VERIFY_T = 4, 5, 128
SPEC_RAGGED = (1, 2, 5, 3)
SPEC_ROUNDS = 1                     # timed serves: (spec, plain, plain, spec)
HYMBA_SPEC_PROMPTS, HYMBA_SPEC_NEW = (1000, 40, 64), (64, 16, 16)
FALCON_SPEC_PROMPTS, FALCON_SPEC_NEW = (300, 64, 32), (16, 16, 16)
# the kernels a speculative serve runs: the dequant GEMM (the verify's row
# groups, the format draft), decode attention Q times a layer (packed KV;
# the dense-row instance for dense KV), the quantizer on every packed K/V
# write
SPEC_KERNELS = {"llama nxfp4, recycled": ("nxfp_quantize", "nxfp_matmul",
                                          "nxfp_attention"),
                "llama bf16, nxfp4 draft": ("nxfp_matmul",
                                            "dense_attention"),
                "hymba": ("nxfp_quantize", "nxfp_matmul", "nxfp_attention"),
                "falcon": ("nxfp_matmul",)}


def _spec_verify_check(cfg, params, kv):
    """``verify_step`` at B 4, Q 5 against 5 sequential ``decode_step``
    calls from the same prefilled cache: logits bitwise, and the cache
    tree after a commit of n = 1, 3, 5 and ragged [1, 2, 5, 3] rows bitwise
    the one n sequential steps leave."""
    import numpy as np
    from repro_torch.models import (commit_verify, decode_step, prefill,
                                    verify_step)
    b, q = SPEC_VERIFY_B, SPEC_VERIFY_Q
    rng = np.random.default_rng(41)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, SPEC_VERIFY_T)),
                           device="cuda")
    cands = torch.as_tensor(rng.integers(0, cfg.vocab, (b, q)),
                            dtype=torch.int32, device="cuda")
    _, cache = prefill(cfg, params, {"tokens": toks}, 256, kv)
    seq, logits, after = _clone_cache(cache), [], {}
    for i in range(q):
        lg, seq = decode_step(cfg, params, cands[:, i:i + 1], seq, kv)
        logits.append(lg)
        after[i + 1] = _clone_cache(seq)
    del seq
    vlogits, pending = verify_step(cfg, params, cands, cache, kv)
    if not torch.equal(vlogits, torch.stack(logits, 1)):
        d = (vlogits - torch.stack(logits, 1)).abs()
        fail(f"speculative verify: logits differ from sequential decode in "
             f"{int((d > 0).sum())} of {d.numel()} (max {float(d.max())})")

    def same(got, n, rows=slice(None)):
        want = after[n]
        bad = [] if torch.equal(got["pos"][rows], want["pos"][rows]) \
            else ["pos"]
        bad += [f"layer {li} {name}"
                for li, (a, w) in enumerate(zip(got["layers"],
                                                want["layers"]))
                for name in a if not torch.equal(a[name][rows],
                                                 w[name][rows])]
        return bad

    bad = {}
    for n in (1, 3, q):
        got = commit_verify(cfg, _clone_cache(cache), pending,
                            torch.full((b,), n, device="cuda"), kv)
        bad[n] = same(got, n)
    got = commit_verify(cfg, _clone_cache(cache), pending,
                        torch.tensor(SPEC_RAGGED, device="cuda"), kv)
    bad["ragged"] = [f"slot {s}: {x}" for s, n in enumerate(SPEC_RAGGED)
                     for x in same(got, n, s)]
    if any(bad.values()):
        fail(f"speculative commit: the cache differs from sequential decode:"
             f" { {k: v[:4] for k, v in bad.items() if v} }")
    del cache, pending, after, got
    torch.cuda.empty_cache()


def _spec_requests(cfg, prompts, news, seed, arrivals=True):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, arrival_time=0.0 if i < 4 or not arrivals
                    else 0.05 * (i - 3))
            for i, (t, m) in enumerate(zip(prompts, news))]


def _spec_serve(cfg, params, policy, spec, reqs, what, counts, **kw):
    """The plain engine's streams (the oracle, not counted), then the
    speculative engine's first serve, its launches counted alone and every
    stream bitwise the plain one's. Returns (plain engine, speculative
    engine, oracle, figures)."""
    from repro_torch.serving import ContinuousEngine
    kw = dict(n_slots=CONT_SLOTS, chunk=CONT_CHUNK, device="cuda", **kw)
    plain, res, _, _ = _engine_run(
        lambda: ContinuousEngine(cfg, params, policy, **kw), reqs, None,
        f"{what} plain")
    want = {r.uid: r.tokens for r in res}
    eng, res, wall, peak = _counted(lambda: _engine_run(
        lambda: ContinuousEngine(cfg, params, policy, speculative=spec,
                                 **kw), reqs, want, f"{what} speculative"),
        counts)
    if eng.replays == 0 or not eng.spec_rounds:
        fail(f"{what}: no speculative graph replays")
    fig = dict(first_serve_s=round(wall, 3), peak=peak,
               graphs=sorted(str(k) for k in eng._graphs),
               accept_rate=round(eng.spec_stats()["accept_rate"], 4))
    return plain, eng, want, fig


def _spec_rounds_timed(plain, eng, reqs, want, what):
    """Second serves in turns, ``SPEC_ROUNDS`` rounds of (spec, plain,
    plain, spec): tok/s, the median host-clock ms of a chunk with every
    slot live and, for the speculative engine, of a round, the accept
    rate of its serves and the round shapes it ran."""
    out = {"spec": [], "plain": []}
    acc0 = (eng.spec_accepted, eng.spec_offered)
    for _ in range(SPEC_ROUNDS):
        for name, e in (("spec", eng), ("plain", plain), ("plain", plain),
                        ("spec", eng)):
            res, wall = _serve_checked(e, reqs, want, f"{what} {name} "
                                       "(timed)")
            n_tok = sum(r.n_generated for r in res)
            rec = dict(tok_s=round(n_tok / wall, 2), chunk_ms=_chunk_ms(e),
                       chunks=e.chunks)
            if name == "spec":
                rounds = statistics.median(n for _, n in e.spec_rounds)
                rec.update(round_ms=round(rec["chunk_ms"] / rounds, 3),
                           shapes=sorted(set(e.spec_rounds)))
            out[name].append(rec)
    acc = (eng.spec_accepted - acc0[0]) / max(eng.spec_offered - acc0[1], 1)
    med = {name: {key: statistics.median(r[key] for r in recs)
                  for key in ("tok_s", "chunk_ms")}
           for name, recs in out.items()}
    return dict(rounds=out, median=med, accept_rate=round(acc, 4),
                round_ms=round(statistics.median(r["round_ms"]
                                                 for r in out["spec"]), 3),
                tok_s_ratio=round(med["spec"]["tok_s"]
                                  / med["plain"]["tok_s"], 4))


def phase_speculative(card: str, serving_layers: int):
    """Phase 14: self-speculative decoding through ``ContinuousEngine``.
    At full width and ``serving_layers``: Llama-3-8B's ``verify_step`` +
    ``commit_verify`` bitwise sequential decode, then 8 staggered requests
    under two pairings (nxfp4 weights and KV with the recycled bf16 draft;
    bf16 weights and dense KV with an nxfp4 draft), a sampled request
    served twice, a request that fills ``max_len``; Hymba-1.5B (a
    1000-token prompt whose 64 new tokens wrap its 1024-row ring) whole
    and at P 256; Falcon-Mamba-7B. Every greedy stream bitwise the
    plain engine's; launches counted around the speculative serves alone.
    Returns (launch counts by path, figures)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousEngine, Request
    from repro_torch.serving import SpeculativeConfig as Spec
    from repro_torch.serving.engine import load_params
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    counts = {name: {} for name in SPEC_KERNELS}
    fig = {}
    cfg = dataclasses.replace(get_config("llama3_8b"),
                              n_layers=serving_layers)
    raw = init_params(cfg, seed=0, device="cuda")
    nx = load_params(raw, QuantPolicy("nxfp4", None), torch.device("cuda"))
    bf = load_params(raw, QuantPolicy(None, None), torch.device("cuda"))
    del raw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fig["cast_s"] = round(time.time() - t0, 2)
    t1 = time.time()
    _spec_verify_check(cfg, nx, "nxfp4")
    fig["verify_check_s"] = round(time.time() - t1, 2)
    reqs = _spec_requests(cfg, SPEC_PROMPTS, SPEC_NEW, 40)
    pairings = {"llama nxfp4, recycled": (nx, QuantPolicy("nxfp4", "nxfp4"),
                                          Spec(k=SPEC_K, draft="recycled")),
                "llama bf16, nxfp4 draft": (bf, QuantPolicy(None, None),
                                            Spec(k=SPEC_K, draft="nxfp4"))}
    for name, (params, policy, spec) in pairings.items():
        plain, eng, want, f = _spec_serve(cfg, params, policy, spec, reqs,
                                          name, counts[name],
                                          max_len=SPEC_MAX_LEN)
        f.update(_spec_rounds_timed(plain, eng, reqs, want, name))
        if name.startswith("llama nxfp4"):
            # a sampled request served twice equals itself; a request whose
            # prompt + max_new fills max_len equals the plain engine's
            rng = np.random.default_rng(42)
            samp = Request(uid=100, tokens=rng.integers(0, cfg.vocab, (64,)),
                           max_new=48, temperature=SPEC_SAMPLED[0],
                           seed=SPEC_SAMPLED[1])
            full = Request(uid=101, tokens=rng.integers(
                0, cfg.vocab, (SPEC_FULL,)), max_new=SPEC_MAX_LEN - SPEC_FULL)
            want_full = {r.uid: r.tokens for r in plain.serve([full])}
            first, _ = _serve_checked(eng, [samp, full], None, "sampled")
            again, _ = _serve_checked(eng, [samp, full], None, "sampled")
            a = {r.uid: r for r in first}
            b = {r.uid: r for r in again}
            if not np.array_equal(a[100].tokens, b[100].tokens) or \
                    a[100].n_generated != 48:
                fail("speculative: a seeded sampled request served twice "
                     "differs from itself")
            for r in (a[101], b[101]):
                if not np.array_equal(r.tokens, want_full[101]) or \
                        r.n_generated != SPEC_MAX_LEN - SPEC_FULL:
                    fail("speculative: the request filling max_len differs "
                         "from the plain engine's stream")
        fig[name] = f
        del plain, eng
        gc.collect()
        torch.cuda.empty_cache()
    del nx, bf
    gc.collect()
    torch.cuda.empty_cache()

    # Hymba-1.5B at serving_layers: the ring wraps mid-speculation
    t2 = time.time()
    hcfg, hparams, _ = _cast_family(HYMBA, serving_layers)
    hreqs = _spec_requests(hcfg, HYMBA_SPEC_PROMPTS, HYMBA_SPEC_NEW, 43,
                           arrivals=False)
    hpol = QuantPolicy("nxfp4", "nxfp4")
    for mode, extra in (("whole", {}), (f"P {SSM_P}", dict(
            prefill_mode="chunked", p_chunk=SSM_P))):
        plain, eng, want, f = _spec_serve(
            hcfg, hparams, hpol, Spec(k=SPEC_K), hreqs, f"hymba {mode}",
            counts["hymba"], max_len=HYMBA_MAX_LEN, **extra)
        f["accept_rate"] = round(eng.spec_stats()["accept_rate"], 4)
        fig[f"hymba {mode}"] = f
        del plain, eng
    del hparams
    gc.collect()
    torch.cuda.empty_cache()
    fig["hymba_s"] = round(time.time() - t2, 1)

    # Falcon-Mamba-7B at serving_layers
    t3 = time.time()
    fcfg = dataclasses.replace(get_config(FALCON), n_layers=serving_layers)
    raw = init_params(fcfg, seed=0, device="cuda")
    fparams = load_params(raw, QuantPolicy("nxfp4", None),
                          torch.device("cuda"))
    del raw
    freqs = _spec_requests(fcfg, FALCON_SPEC_PROMPTS, FALCON_SPEC_NEW, 44,
                           arrivals=False)
    plain, eng, want, f = _spec_serve(
        fcfg, fparams, QuantPolicy("nxfp4", None), Spec(k=SPEC_K), freqs,
        "falcon", counts["falcon"], max_len=FALCON_MAX_LEN)
    fig["falcon"] = f
    del plain, eng, fparams
    gc.collect()
    torch.cuda.empty_cache()
    fig["falcon_s"] = round(time.time() - t3, 1)

    for path, names in SPEC_KERNELS.items():
        for name in names:
            if counts[path].get(name, 0) <= 0:
                fail(f"speculative path ({path}): kernel {name} was never "
                     f"launched")
    fig["seconds"] = round(time.time() - t0, 1)
    for name in pairings:
        f = fig[name]
        log(f"speculative {name} ({card}): Llama-3-8B full width, "
            f"{serving_layers} layers, k {SPEC_K}, {CONT_SLOTS} slots, "
            f"chunk {CONT_CHUNK}, max_len {SPEC_MAX_LEN}; 8 requests "
            f"(prompts 32-256, max_new 32-64): every stream bitwise the "
            f"plain engine's; accept rate "
            f"{f['accept_rate']}; ms a speculative chunk "
            f"{f['median']['spec']['chunk_ms']} ({f['round_ms']} a round) "
            f"vs a plain chunk {f['median']['plain']['chunk_ms']}; tok/s "
            f"{f['median']['spec']['tok_s']} vs plain "
            f"{f['median']['plain']['tok_s']} ({f['tok_s_ratio']}x); "
            f"{SPEC_ROUNDS} rounds of (spec, plain, plain, spec): "
            f"{f['rounds']}; first serve {f['first_serve_s']} s, peak "
            f"{f['peak']} bytes above the weights, graphs {f['graphs']}")
    log(f"  speculative checks ({card}): verify_step at B {SPEC_VERIFY_B}, "
        f"Q {SPEC_VERIFY_Q} == {SPEC_VERIFY_Q} sequential decode steps "
        f"(logits; cache after n = 1, 3, 5, ragged {list(SPEC_RAGGED)}) "
        f"bitwise ({fig['verify_check_s']} s); a sampled request served "
        f"twice == itself; prompt {SPEC_FULL} + {SPEC_MAX_LEN - SPEC_FULL} "
        f"new == max_len bitwise the plain engine's; init + casts "
        f"{fig['cast_s']} s")
    for name in (f"hymba whole", f"hymba P {SSM_P}", "falcon"):
        log(f"  speculative {name} ({card}): every stream bitwise the plain "
            f"engine's: {fig[name]}")
    log(f"  launches on the speculative paths (the speculative serves "
        f"alone): {counts}; hymba {fig['hymba_s']} s, falcon "
        f"({serving_layers} layers) {fig['falcon_s']} s; phase 14 "
        f"{fig['seconds']} s")
    return counts, fig


# phase 15: the paged engine's speculative rounds (Llama-3-8B and
# Hymba-1.5B) and TieredContinuousEngine on the SSM and hybrid families
# (Hymba-1.5B and Falcon-Mamba-7B), all at --serving-layers
P15_K = 4
P15_MAX_LEN, P15_PAGE = 512, 32
# Llama-3-8B: four requests on one 96-token prefix (more than the GEMMs'
# 16-row regime: a whole prompt takes part in sharing) and two of their
# own. Every budget ends at least k - 1 rows short of its last page, so no
# live round reaches the null page and spec_stats() compares with the
# dense engine's (a round's rows past a reservation read the null page:
# the candidates it accepts there, past the budget, may differ)
P15_PREFIX, P15_TAILS = 96, (40, 8, 100, 60)
P15_OTHERS = (200, 64)
P15_NEW = (48, 40, 32, 56, 40, 24)
# Hymba-1.5B: a registrar of a 990-token prompt that never wraps its
# 1024-row ring and two claimants of its first 960 tokens (30 pages; one
# the whole prompt, one 3 tokens of its own after 985) whose 64 new tokens
# wrap the ring into the shared pages, and a short request; chunk 1 (one
# round a chunk, as at 4), so the round's k + 1 rows are the dispatch's
# write horizon: a COW at pos 1020-1023 is one the chunk's row alone
# would not have made
P15_HYMBA_PROMPT, P15_HYMBA_NEW, P15_HYMBA_CHUNK = 990, (8, 64, 64, 16), 1
# the tiered serves: six requests by uid % 3 over premium, standard and
# economy, whole and at P 256; the degrade rung on Hymba
P15_TIER_PROMPTS = (300, 64, 200, 400, 100, 48)
P15_TIER_NEW = (16, 24, 8, 16, 24, 8)
P15_REPACK_WATERMARK = 0.05
# the kernels at the shapes phase 15 adds: the qq GEMM at Hymba's
# attention and MLP (K, N) pairs (wq/wo, wk/wv, w1/w3, w2), at a lane
# chunk's M (P 256) and a prefill's; the quantizer's paged verify write
HYMBA_QQ_KN = ((1600, 1600), (1600, 320), (1600, 5504), (5504, 1600))
HYMBA_QQ_M = (SSM_P, 512)
PAGED_VERIFY = {"verify": (1, [301, 70, 480, 18], None, None)}
# the kernels each phase-15 path must launch
P15_KERNELS = {"llama paged speculative": ("nxfp_quantize", "nxfp_matmul",
                                           "nxfp_attention"),
               "hymba paged speculative": ("nxfp_quantize", "nxfp_matmul",
                                           "nxfp_attention"),
               "hymba tiers": ("nxfp_quantize", "nxfp_matmul",
                               "nxfp_attention", "dense_attention",
                               "nxfp_qq_matmul"),
               "falcon tiers": ("nxfp_matmul",)}


def check_phase15_kernels(timer, rows):
    """The kernels at the shapes phase 15 adds, held and timed as the rows
    above are: the quantizer's verify write of (4, 1) rows through a block
    table (slot 1's row on a null page) and the qq GEMM at Hymba's
    attention and MLP pairs."""
    check_paged_kv_write(timer, rows, PAGED_VERIFY)
    check_qq_matmul(timer, rows, HYMBA_QQ_KN, HYMBA_QQ_M)
    torch.cuda.empty_cache()


def _null_page_clean(eng) -> bool:
    """Page 0 of every pool buffer is all zeros."""
    from repro_torch.kernels.build import bit_view
    return all(not bool(bit_view(buf)[0].any())
               for layer in eng.cache["layers"]
               for name, buf in layer.items() if name.startswith("pool_"))


def _paged_spec_llama(card, counts, n_layers):
    """Llama-3-8B (``n_layers`` layers, nxfp4 weights and KV, recycled
    draft): the paged speculative engine against the dense speculative
    engine and the plain paged engine, then second serves in turns."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                     Request)
    from repro_torch.serving import SpeculativeConfig as Spec
    from repro_torch.serving.engine import load_params
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=n_layers)
    raw = init_params(cfg, seed=0, device="cuda")
    params = load_params(raw, QuantPolicy("nxfp4", None),
                         torch.device("cuda"))
    del raw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(50)
    prefix = rng.integers(0, cfg.vocab, (P15_PREFIX,))
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab, (t,))])
               for t in P15_TAILS]
    prompts += [rng.integers(0, cfg.vocab, (t,)) for t in P15_OTHERS]
    reqs = [Request(uid=i, tokens=p, max_new=m,
                    arrival_time=0.0 if i < 4 else 0.05 * (i - 3))
            for i, (p, m) in enumerate(zip(prompts, P15_NEW))]
    for r in reqs:
        end = len(r.tokens) + r.max_new
        if -(-end // P15_PAGE) * P15_PAGE - end < P15_K - 1:
            fail(f"paged speculative: uid {r.uid}'s budget ends within "
                 f"k - 1 rows of its last page")
    policy = QuantPolicy("nxfp4", "nxfp4")
    spec = Spec(k=P15_K, draft="recycled")
    kw = dict(n_slots=CONT_SLOTS, chunk=CONT_CHUNK, max_len=P15_MAX_LEN,
              device="cuda")
    dense, res, _, _ = _engine_run(
        lambda: ContinuousEngine(cfg, params, policy, speculative=spec,
                                 **kw), reqs, None,
        "llama dense speculative")
    want = {r.uid: r.tokens for r in res}
    dense_stats = dense.spec_stats()
    del dense
    plain, _, _, _ = _engine_run(
        lambda: PagedContinuousEngine(cfg, params, policy,
                                      page_size=P15_PAGE, **kw),
        reqs, want, "llama plain paged")
    eng, res, wall, peak = _counted(lambda: _engine_run(
        lambda: PagedContinuousEngine(cfg, params, policy, speculative=spec,
                                      page_size=P15_PAGE, **kw),
        reqs, want, "llama paged speculative"), counts)
    if eng.spec_stats() != dense_stats:
        fail(f"paged speculative: spec_stats {eng.spec_stats()} differ from "
             f"the dense speculative engine's {dense_stats}")
    st = eng.pool_stats()[0]
    if st["prefix_hits"] < 1 or eng.replays == 0 or not eng.spec_rounds:
        fail(f"paged speculative: no prefix hit or no graph replay ({st}, "
             f"{eng.replays} replays)")
    if not _null_page_clean(eng):
        fail("paged speculative: the null page was written")
    eng.pool.assert_empty()
    fig = dict(first_serve_s=round(wall, 3), peak=peak, pool_stats=st,
               spec_stats=eng.spec_stats(),
               graphs=sorted(str(k) for k in eng._graphs))
    fig.update(_spec_rounds_timed(plain, eng, reqs, want,
                                  "llama paged speculative"))
    if not _null_page_clean(eng):
        fail("paged speculative: the null page was written")
    log(f"paged speculative Llama-3-8B ({card}): full width, {cfg.n_layers} "
        f"layers, "
        f"nxfp4 weights and KV, recycled draft, k {P15_K}, {CONT_SLOTS} "
        f"slots, chunk {CONT_CHUNK}, max_len {P15_MAX_LEN}, pages of "
        f"{P15_PAGE} rows, prefix sharing; {len(reqs)} requests (4 on one "
        f"{P15_PREFIX}-token prefix): every stream bitwise the dense "
        f"speculative engine's and the plain paged engine's, spec_stats "
        f"equal ({dense_stats}), page 0 all zeros, the pool empty; accept "
        f"rate {fig['accept_rate']}; ms a chunk "
        f"{fig['median']['spec']['chunk_ms']} ({fig['round_ms']} a round) "
        f"vs the plain paged engine's {fig['median']['plain']['chunk_ms']};"
        f" tok/s {fig['median']['spec']['tok_s']} vs "
        f"{fig['median']['plain']['tok_s']} ({fig['tok_s_ratio']}x); "
        f"{fig}")
    del plain, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return fig


def _paged_spec_hymba(card, counts, n_layers):
    """Hymba-1.5B (``n_layers``, nxfp4): a registrar and two claimants of a
    990-token prompt whose rounds wrap the 1024-row ring into the shared
    pages, against the dense speculative engine."""
    import numpy as np
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                     Request)
    from repro_torch.serving import SpeculativeConfig as Spec
    cfg, params, _ = _cast_family(HYMBA, n_layers)
    rng = np.random.default_rng(51)
    prompt = rng.integers(0, cfg.vocab, (P15_HYMBA_PROMPT,))
    prompts = [prompt, prompt, np.concatenate(
        [prompt[:985], rng.integers(0, cfg.vocab, (3,))]),
        rng.integers(0, cfg.vocab, (64,))]
    reqs = [Request(uid=i, tokens=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, P15_HYMBA_NEW))]
    policy = QuantPolicy("nxfp4", "nxfp4")
    spec = Spec(k=P15_K, draft="recycled")
    kw = dict(n_slots=CONT_SLOTS, chunk=P15_HYMBA_CHUNK,
              max_len=HYMBA_MAX_LEN, device="cuda")
    dense, res, dwall, _ = _engine_run(
        lambda: ContinuousEngine(cfg, params, policy, speculative=spec,
                                 **kw), reqs, None,
        "hymba dense speculative")
    want = {r.uid: r.tokens for r in res}
    dense_fig = dict(_serve_figures(dense, res, dwall),
                     chunk_ms=_chunk_ms(dense))
    del dense
    plain, res, pwall, _ = _engine_run(
        lambda: PagedContinuousEngine(cfg, params, policy, **kw), reqs,
        want, "hymba plain paged")
    plain_fig = dict(_serve_figures(plain, res, pwall),
                     chunk_ms=_chunk_ms(plain))
    del plain
    journal = _Journal()
    n0 = len(journal.records)
    eng, res, wall, peak = _counted(lambda: _engine_run(
        lambda: PagedContinuousEngine(cfg, params, policy, speculative=spec,
                                      **kw), reqs, want,
        "hymba paged speculative"), counts)
    journal.log.removeHandler(journal)
    w, hz = cfg.sliding_window, eng._horizon_bound()
    breaks = [e for e in journal.records[n0:] if e["event"] == "cow-break"]
    st = eng.pool_stats()[0]
    if hz != P15_K + 1 or not breaks or st["prefix_hits"] < 1:
        fail(f"hymba paged speculative: horizon {hz}, cow-breaks {breaks}, "
             f"pool {st}")
    late = [e for e in breaks if not w - hz < e["pos"] <= w]
    round_only = [e for e in breaks if e["pos"] + P15_HYMBA_CHUNK <= w]
    if late or not round_only:
        fail(f"hymba paged speculative: COWs {breaks}: each must fire "
             f"within the round's horizon ({hz} rows), one where the "
             f"chunk's {P15_HYMBA_CHUNK} would not have")
    if not _null_page_clean(eng):
        fail("hymba paged speculative: the null page was written")
    eng.pool.assert_empty()
    fig = dict(_serve_figures(eng, res, wall), peak=peak, pool_stats=st,
               cow_breaks=[(e["slot"], e["pos"], e["pages"])
                           for e in breaks],
               round_horizon_only=len(round_only),
               accept_rate=round(eng.spec_stats()["accept_rate"], 4),
               chunk_ms=_chunk_ms(eng), dense=dense_fig,
               plain_paged=plain_fig)
    log(f"paged speculative Hymba-1.5B ({card}): full width, {cfg.n_layers} "
        f"layers, "
        f"nxfp4 KV in a {w}-row ring, k {P15_K}, chunk {P15_HYMBA_CHUNK} "
        f"(write horizon {hz} = k + 1), a registrar of {P15_HYMBA_PROMPT} "
        f"tokens and two claimants wrapping into its pages: every stream "
        f"bitwise the dense speculative engine's and the plain paged "
        f"engine's (first serves, {fig['tok_s']} tok/s against "
        f"{plain_fig['tok_s']}), COW at pos "
        f"{[e['pos'] for e in breaks]} (each > {w} - {hz}; "
        f"{len(round_only)} where the chunk's horizon alone would not have "
        f"broken), page 0 all zeros; {fig}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return fig


def _tier_requests(cfg, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, tier=TIER_OF[i % 3])
            for i, (t, m) in enumerate(zip(P15_TIER_PROMPTS, P15_TIER_NEW))]


def _tiers_family(card, cfg, what, counts, modes=("whole", f"P {SSM_P}")):
    """``TieredContinuousEngine(default_tiers())`` over ``cfg`` (a bf16
    model from seed 0): the mixed serve in ``modes`` (whole, at P 256)
    against each request's solo stream at its tier, qq launches around the
    economy prefill (7 a layer: attention's 4 and the MLP's 3; an MoE
    layer's experts keep dense activations, 4), the one-tier engine
    against the plain engine in ``modes``, and (with attention) the
    degrade rung's repack. Launches of the mixed serves are added to
    ``counts``."""
    import numpy as np
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params, read_cache_slot
    from repro_torch.serving import (ContinuousEngine, DegradeOverBudget,
                                     TieredContinuousEngine, default_tiers)
    from repro_torch.serving.engine import load_params
    t0 = time.time()
    raw = init_params(cfg, seed=0, device="cuda")
    model = load_params(raw, QuantPolicy(None, None), torch.device("cuda"))
    del raw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tiers = default_tiers()
    reqs = _tier_requests(cfg, 52)
    lane_kw = dict(prefill_mode="chunked", p_chunk=SSM_P)
    kw = dict(n_slots=CONT_SLOTS, max_len=P15_MAX_LEN, chunk=CONT_CHUNK,
              device="cuda")
    fig = {"cast_s": round(time.time() - t0, 2)}
    n_econ = sum(r.tier == "economy" for r in reqs)
    qq_layer = 0 if cfg.attn_free else 4 if cfg.family == "moe" else 7
    runs = [(m, x) for m, x in (("whole", {}), (f"P {SSM_P}", lane_kw))
            if m in modes]
    solos = None
    for mode, extra in runs:
        eng = TieredContinuousEngine(cfg, model, tiers, **kw, **extra)
        if solos is None:
            solo_of = {name: _TierSolo(cfg, eng._wparams[spec.weight_fmt],
                                       spec.kv_fmt, spec.act_fmt,
                                       P15_MAX_LEN)
                       for name, spec in tiers.items()}
            solos = {r.uid: solo_of[r.tier](r) for r in reqs}
        torch.cuda.synchronize()
        reset_launch_counts()
        res, wall = _serve_checked(eng, reqs, solos, f"{what} tiers {mode}")
        torch.cuda.synchronize()
        got = launch_counts()
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        qq = got["nxfp_qq_matmul"]
        want_qq = qq_layer * cfg.n_layers * n_econ
        if (mode == "whole" and qq != want_qq) or \
                (mode != "whole" and (qq > 0) == cfg.attn_free):
            fail(f"{what} tiers {mode}: {qq} qq GEMM launches around "
                 f"{n_econ} economy prefills (want {qq_layer} a layer: "
                 f"{want_qq})")
        if eng.replays != sum(eng.chunk_groups) or max(eng.chunk_groups) < 2:
            fail(f"{what} tiers {mode}: {eng.replays} replays for "
                 f"{sum(eng.chunk_groups)} group dispatches")
        res2, wall2 = _serve_checked(eng, reqs, solos,
                                     f"{what} tiers {mode} (second)")
        fig[mode] = dict(_serve_figures(eng, res2, wall2), qq=qq,
                         chunk_ms=_chunk_ms(eng),
                         group_dispatches=sum(eng.chunk_groups),
                         first_serve_s=round(wall, 3))
        if mode == "whole":
            whole = eng
        else:
            del eng
    # the tier engine restricted to one tier is the plain engine
    one_tier = "standard"
    spec = tiers[one_tier]
    untiered = [dataclasses.replace(r, tier=None) for r in reqs]
    for mode, extra in runs:
        one = TieredContinuousEngine(cfg, model, {one_tier: spec}, **kw,
                                     **extra)
        base = ContinuousEngine(cfg, one._wparams[spec.weight_fmt],
                                QuantPolicy(None, spec.kv_fmt), **kw,
                                **extra)
        b_res, b_wall = _serve_checked(base, untiered, None, f"{what} plain")
        want = {r.uid: r.tokens for r in b_res}
        o_res, o_wall = _serve_checked(one, untiered, want,
                                       f"{what} one tier ({mode})")
        fig[f"one tier {mode}"] = dict(
            tok_s=round(sum(r.n_generated for r in o_res) / o_wall, 2),
            chunk_ms=_chunk_ms(one),
            plain_tok_s=round(sum(r.n_generated for r in b_res) / b_wall, 2),
            plain_chunk_ms=_chunk_ms(base))
        del one, base
        gc.collect()
        torch.cuda.empty_cache()
    if not cfg.attn_free:
        # the degrade rung: a premium request over the watermark repacked
        # into the standard arena; its h/conv moved bit for bit
        repacked = []
        repack = whole._repack_slot

        def spy(sched, slot, dst):
            before = read_cache_slot(whole._slot_cache(slot), slot)
            repack(sched, slot, dst)
            repacked.append((before, read_cache_slot(whole._slot_cache(slot),
                                                     slot)))

        whole._repack_slot = spy
        whole.degrade_kv_to = "standard"
        whole.shedding = DegradeOverBudget(
            max_new_cap=None, pool_watermark=P15_REPACK_WATERMARK)
        # premium (400 tokens, decoding for 3 chunks), standard
        pair = [dataclasses.replace(reqs[3], max_new=3 * CONT_CHUNK), reqs[1]]
        rung = {r.uid: r for r in whole.serve(pair)}
        whole._repack_slot, whole.degrade_kv_to, whole.shedding = \
            repack, None, None
        if len(repacked) != 1 or not rung[3].degraded or \
                rung[1].degraded or not np.array_equal(rung[1].tokens,
                                                       solos[1]):
            fail(f"{what} degrade rung: {len(repacked)} repacks, results "
                 f"{[(r.uid, r.status, r.degraded) for r in rung.values()]}")
        pos, used, n_bytes = _check_repack(cfg, *repacked[0], P15_MAX_LEN,
                                           f"{what} degrade rung")
        fig["repack"] = dict(pos=pos, rows=used, kv_bytes=n_bytes,
                             state="bitwise")
    del whole, model
    gc.collect()
    torch.cuda.empty_cache()
    fig["seconds"] = round(time.time() - t0, 1)
    log(f"tiered serving {what} ({card}): full width, {cfg.n_layers} layers"
        f", default_tiers() over a bf16 model (seed 0), {CONT_SLOTS} slots, "
        f"chunk {CONT_CHUNK}, max_len {P15_MAX_LEN}; {len(reqs)} requests "
        f"by uid % 3 over {TIER_OF}, {' and '.join(modes)}: every stream "
        f"bitwise its solo stream at its tier; one-tier ({one_tier}) engines "
        f"bitwise the plain engine; {fig}")
    return fig


def phase_paged_spec_and_tiers(card: str, serving_layers: int):
    """Phase 15: the paged engine's speculative rounds (Llama-3-8B at
    ``serving_layers``, Hymba-1.5B too), then
    ``TieredContinuousEngine`` on Hymba-1.5B and Falcon-Mamba-7B at
    ``serving_layers``. Launches are counted around the
    engines under test alone. Returns (launch counts by path, figures)."""
    from repro_torch.configs import get_config
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    counts = {name: {} for name in P15_KERNELS}
    fig = {"llama paged speculative": _paged_spec_llama(
        card, counts["llama paged speculative"], serving_layers)}
    fig["hymba paged speculative"] = _paged_spec_hymba(
        card, counts["hymba paged speculative"], serving_layers)
    hcfg = dataclasses.replace(get_config(HYMBA), n_layers=serving_layers)
    fig["hymba tiers"] = _tiers_family(card, hcfg, "hymba",
                                       counts["hymba tiers"])
    fcfg = dataclasses.replace(get_config(FALCON), n_layers=serving_layers)
    fig["falcon tiers"] = _tiers_family(card, fcfg, "falcon",
                                        counts["falcon tiers"])
    for path, names in P15_KERNELS.items():
        for name in names:
            if counts[path].get(name, 0) <= 0:
                fail(f"phase 15 ({path}): kernel {name} was never launched")
    if counts["falcon tiers"].get("nxfp_qq_matmul", 0):
        fail("phase 15: Falcon's tiers launched the qq GEMM")
    fig["seconds"] = round(time.time() - t0, 1)
    log(f"  launches on phase 15's paths (the engines under test alone; "
        f"all at {serving_layers} layers): {counts}; phase 15 "
        f"{fig['seconds']} s")
    return counts, fig


# phase 16: suspension, preemption, slot snapshots and checkpoints
# Llama-3-8B at full width and --serving-layers (nxfp4 weights and KV, 4
# slots, chunk 16, max_len 512): four batch requests at priority 0, then two
# interactive ones at priority 1 arriving once the slots are full
P16_BATCH = ((32, 64), (96, 56), (160, 48), (256, 64))      # (prompt, new)
P16_INTERACTIVE = ((48, 24), (128, 32))
P16_ARRIVAL = 0.2                    # s: the interactive requests' arrival
P16_ROUNDS = 1                       # (uninterrupted, preempted) x 2 a round
# the suspend serve: a sampled request (uid 1) suspended after its first
# chunk resumes in another slot (uid 4 takes its own meanwhile)
P16_SUSPEND = ((64, 48), (128, 64), (32, 32), (200, 48), (96, 32))
P16_SAMPLED = (0.9, 31)
# Hymba-1.5B and Falcon-Mamba-7B (--serving-layers): a long
# request suspended after 2 chunks (Hymba's 1000-token prompt has wrapped
# its 1024-row ring by then) beside two short ones, in 4 slots
P16_HYMBA = ((1000, 64), (300, 32), (64, 48))
P16_FALCON = ((300, 48), (64, 32), (32, 16))
P16_SSM_AFTER = 32                   # tokens decoded before the suspension
# the tiers: Llama-3-8B at --serving-layers, default_tiers() over a bf16
# model, default tier standard, 2 slots; an economy request suspended
P16_TIERS = ((64, 48, "economy"), (96, 32, None), (48, 48, "economy"))
# the kernels each phase-16 path must launch through its wrappers. The
# preempted and suspended Llama serves and the tiered one replay the
# decode graphs their engine's uninterrupted serve captured (every decode
# chunk must be a replay), so their counters see the prefills' kernels
# only
P16_KERNELS = {"llama preemption": ("nxfp_quantize", "nxfp_matmul"),
               "llama suspend": ("nxfp_quantize", "nxfp_matmul"),
               "llama restore dense": ("nxfp_quantize", "nxfp_matmul",
                                       "nxfp_attention"),
               "llama restore paged": ("nxfp_quantize", "nxfp_matmul",
                                       "nxfp_attention"),
               "llama speculative": ("nxfp_quantize", "nxfp_matmul",
                                     "nxfp_attention"),
               "hymba": ("nxfp_quantize", "nxfp_matmul", "nxfp_attention"),
               "falcon": ("nxfp_matmul",),
               "tiers": ("nxfp_quantize", "nxfp_matmul", "nxfp_qq_matmul")}


class _Crash(Exception):
    """The simulated crash of phase 16's checkpoint case."""


def _p16_requests(cfg, spec, seed, **kw):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, **kw) for i, (t, m) in enumerate(spec)]


def _p16_events(fn):
    """``fn()`` with the serving journal captured: (its result, the event
    records)."""
    from repro_torch.serving import parse_event
    recs = []

    class Grab(logging.Handler):
        def emit(self, rec):
            e = parse_event(rec.getMessage())
            if e is not None:
                recs.append(e)

    h, log_ = Grab(), logging.getLogger("repro_torch.serving")
    level = log_.level
    log_.addHandler(h)
    log_.setLevel(logging.INFO)
    try:
        return fn(), recs
    finally:
        log_.removeHandler(h)
        log_.setLevel(level)


def _p16_spy(eng, times, box=None):
    """Time every suspend (``_suspend_slot``) and resume (``_resume``) of
    ``eng`` on the host clock, the device synchronised around each; with
    ``box``, keep each resume's slot and the slot's state read back right
    after the restore, before any chunk."""
    from repro_torch.models import read_cache_slot
    from repro_torch.serving import pack_device_state
    suspend, resume = eng._suspend_slot, eng._resume

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*a, **k)
            torch.cuda.synchronize()
            times.setdefault(key, []).append(time.perf_counter() - t0)
        return run

    def resumed(sched, state, slot, req, snap, clock, **kw):
        timed(resume, "resume")(sched, state, slot, req, snap, clock, **kw)
        if box is not None:
            box.setdefault("to", {})[req.uid] = slot
            box.setdefault("back", {})[req.uid] = pack_device_state(
                read_cache_slot(eng._slot_cache(slot), slot), snap.used_rows)

    eng._suspend_slot = timed(suspend, "suspend")
    eng._resume = resumed


def _p16_suspender(uid, after, box, clear_graphs=False):
    """A ``progress_cb`` that suspends ``uid`` once it has decoded
    ``after`` tokens, keeping its snapshot and slot in ``box``; with
    ``clear_graphs`` it also drops the decode graphs, so the chunk after
    the resume captures them afresh with the restored slot live."""
    from repro_torch.serving import DECODING

    def cb(engine, sched):
        slot = next((s for s, r in sched.active.items() if r.uid == uid),
                    None)
        if "snap" in box or slot is None or sched.phase[slot] != DECODING \
                or engine._host["n_gen"][slot] < after:
            return
        box["snap"], box["from"] = engine.snapshot_slot(slot), slot
        engine.suspend(uid)
        if clear_graphs:
            engine._graphs.clear()
    return cb


def _same_payload(a, b) -> bool:
    return torch.equal(a["pos"], b["pos"]) and all(
        set(x) == set(y) and all(torch.equal(x[n], y[n]) for n in x)
        for x, y in zip(a["layers"], b["layers"]))


def _p16_check(got, want, what):
    import numpy as np
    from repro_torch.serving import Status
    if set(got) != set(want):
        fail(f"{what}: results for {sorted(got)}, expected {sorted(want)}")
    for uid, r in got.items():
        if r.status != Status.OK or not np.array_equal(r.tokens, want[uid]):
            fail(f"{what}: uid {uid} ({r.status}) {r.tokens[:8].tolist()} "
                 f"... differs from the uninterrupted stream "
                 f"{want[uid][:8].tolist()} ...")


def _p16_llama(counts, tmp, n_layers):
    """Llama-3-8B (``n_layers``): preemption, a sampled request moved between
    slots, the snapshot bytes at nxfp4 and bf16 KV, speculative suspension
    with ``spec_k`` kept, then a checkpoint, a crash and restores on fresh
    dense and paged engines."""
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                     PriorityPreemption)
    from repro_torch.serving import SpeculativeConfig as Spec
    from repro_torch.serving.engine import load_params
    fig = {}
    t0 = time.time()
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=n_layers)
    raw = init_params(cfg, seed=0, device="cuda")
    nx = load_params(raw, QuantPolicy("nxfp4", None), torch.device("cuda"))
    del raw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fig["cast_s"] = round(time.time() - t0, 2)
    pol = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=CONT_SLOTS, chunk=CONT_CHUNK, max_len=CONT_MAX_LEN,
              device="cuda")
    eng = ContinuousEngine(cfg, nx, pol, **kw)
    times, box = {}, {}
    _p16_spy(eng, times, box)

    # preemption: the uninterrupted serve (the oracle, its graphs captured)
    # then (uninterrupted, preempted, preempted, uninterrupted) in turns
    reqs = (_p16_requests(cfg, P16_BATCH, 60)
            + _p16_requests(cfg, P16_INTERACTIVE, 61, priority=1,
                            arrival_time=P16_ARRIVAL))
    reqs = [dataclasses.replace(r, uid=i) for i, r in enumerate(reqs)]
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    runs = {"uninterrupted": [], "preempted": []}
    for _ in range(P16_ROUNDS):
        for name in ("uninterrupted", "preempted", "preempted",
                     "uninterrupted"):
            eng.preemption = PriorityPreemption() if name == "preempted" \
                else None
            torch.cuda.synchronize()
            replays = eng.replays
            t1 = time.perf_counter()
            res, evs = _p16_events(lambda: _counted(
                lambda: eng.serve(reqs), counts["llama preemption"])
                if name == "preempted" else eng.serve(reqs))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            _p16_check({r.uid: r for r in res}, want, f"llama {name}")
            if eng.replays - replays != eng.chunks:
                fail(f"llama {name}: a decode chunk was not a graph replay")
            kinds = [e["event"] for e in evs]
            if name == "preempted" and (kinds.count("preempt") < 1 or
                                        kinds.count("resume") < 1):
                fail(f"llama preemption: no preemption happened ({kinds})")
            runs[name].append(dict(
                tok_s=round(sum(r.n_generated for r in res) / wall, 2),
                preempts=kinds.count("preempt")))
    eng.preemption = None
    fig["preemption_s"] = round(time.time() - t0, 1)
    fig["preemption"] = dict(runs=runs, **{
        f"{k}_tok_s": statistics.median(r["tok_s"] for r in v)
        for k, v in runs.items()})

    # a sampled request suspended by suspend() resumes in another slot
    sreqs = _p16_requests(cfg, P16_SUSPEND, 62)
    sreqs[1] = dataclasses.replace(sreqs[1], temperature=P16_SAMPLED[0],
                                   seed=P16_SAMPLED[1])
    swant = {r.uid: r.tokens for r in eng.serve(sreqs)}
    box.clear()
    replays = eng.replays
    res = _counted(lambda: eng.serve(sreqs, progress_cb=_p16_suspender(
        1, CONT_CHUNK, box)), counts["llama suspend"])
    _p16_check({r.uid: r for r in res}, swant, "llama sampled suspend")
    if eng.replays - replays != eng.chunks:
        fail("llama sampled suspend: a decode chunk was not a graph replay")
    if box["to"][1] == box["from"]:
        fail("llama sampled suspend: the request resumed in its own slot")
    if not _same_payload(box["back"][1], box["snap"].device):
        fail("llama sampled suspend: the restored slot differs from its "
             "snapshot")
    snap = box["snap"]
    fig["snapshot_nxfp4"] = dict(nbytes=snap.nbytes, pos=snap.pos,
                                 rows=snap.used_rows,
                                 per_row_layer=_row_layer_bytes(snap, cfg))
    fig["suspend_ms"] = round(statistics.median(times["suspend"]) * 1e3, 3)
    fig["resume_ms"] = round(statistics.median(times["resume"]) * 1e3, 3)
    fig["moves"] = dict(suspends=len(times["suspend"]),
                        resumes=len(times["resume"]))

    # the same request's snapshot at bf16 KV, at the same boundary
    bf_eng = ContinuousEngine(cfg, nx, QuantPolicy("nxfp4", None), **kw)
    bbox = {}
    bf_eng.serve([dataclasses.replace(sreqs[1], temperature=0.0)],
                 progress_cb=_p16_suspender(1, CONT_CHUNK, bbox))
    bsnap = bbox["snap"]
    fig["snapshot_bf16"] = dict(nbytes=bsnap.nbytes, pos=bsnap.pos,
                                rows=bsnap.used_rows,
                                per_row_layer=_row_layer_bytes(bsnap, cfg))
    fig["bf16_over_nxfp4"] = round(
        fig["snapshot_bf16"]["per_row_layer"]
        / fig["snapshot_nxfp4"]["per_row_layer"], 4)
    del bf_eng

    fig["suspend_s"] = round(time.time() - t0, 1)
    # speculative (k 4, recycled draft): two slots suspended after the
    # second chunk, one's draft length set to 2 first; the streams are the
    # plain engine's (the preemption serve's), spec_k comes back
    spec = ContinuousEngine(cfg, nx, pol, speculative=Spec(
        k=SPEC_K, draft="recycled"), **kw)
    armed, seen = {}, {"n": 0}
    sresume = spec._resume

    def spec_resume(sched, state, slot, req, snap, clock, **k):
        sresume(sched, state, slot, req, snap, clock, **k)
        armed[req.uid] = (snap.spec_k, int(spec._adaptive.k[slot]))
    spec._resume = spec_resume

    def spec_cb(engine, sched):
        seen["n"] += 1
        if seen["n"] == 2:
            live = sorted(s for s in sched.active
                          if sched.phase[s] == "DECODING")[:2]
            engine._adaptive.k[live[0]] = 2
            for s in live:
                engine.suspend(sched.active[s].uid)
    res = _counted(lambda: spec.serve(reqs, progress_cb=spec_cb),
                   counts["llama speculative"])
    _p16_check({r.uid: r for r in res}, want, "llama speculative suspend")
    if len(armed) != 2 or sorted(a for a, _ in armed.values())[0] != 2 or \
            any(a != b for a, b in armed.values()):
        fail(f"llama speculative: spec_k did not come back: {armed}")
    fig["speculative"] = dict(spec_k=armed, replays=spec.replays,
                              accept_rate=round(
                                  spec.spec_stats()["accept_rate"], 4))
    del spec

    fig["speculative_s"] = round(time.time() - t0, 1)
    # a checkpoint mid-serve, a crash, restores on fresh engines
    path = os.path.join(tmp, "serve.ck")
    ck_fig = {}

    def crash(engine, sched):
        if engine.chunks == 2:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ck = engine.checkpoint(path)
            ck_fig.update(write_s=round(time.perf_counter() - t1, 4),
                          bytes=os.path.getsize(path),
                          live=len(ck["snapshots"]),
                          queued=len(ck["queued"]))
            raise _Crash
    try:
        eng.serve(sreqs, progress_cb=crash)
    except _Crash:
        pass
    else:
        fail("llama checkpoint: the serve ended before its crash")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    for name, cls, extra in (
            ("llama restore dense", ContinuousEngine, {}),
            ("llama restore paged", PagedContinuousEngine,
             dict(page_size=P15_PAGE))):
        fresh = cls(cfg, nx, pol, **kw, **extra)
        pending, prior = fresh.restore(path)
        got = {r.uid: r for r in prior}
        got.update({r.uid: r for r in _counted(lambda: fresh.serve(pending),
                                               counts[name])})
        _p16_check(got, swant, name)
        if cls is PagedContinuousEngine:
            fresh.pool.assert_empty()
        ck_fig[name] = dict(pending=len(pending), prior=len(prior),
                            replays=fresh.replays)
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
    fig["checkpoint"] = ck_fig
    del nx
    gc.collect()
    torch.cuda.empty_cache()
    fig["seconds"] = round(time.time() - t0, 1)
    return fig


def _row_layer_bytes(snap, cfg) -> float:
    """A snapshot's K/V bytes per row and layer (its payload less ``pos``
    and any Mamba state, over its rows and layers)."""
    kv = sum(int(leaf.nbytes) for layer in snap.device["layers"]
             for name, leaf in layer.items() if name not in ("h", "conv"))
    return round(kv / max(snap.used_rows, 1) / cfg.n_layers, 2)


def _p16_family(cfg, params, spec, what, counts, max_len):
    """A long request suspended after ``P16_SSM_AFTER`` tokens beside two
    short ones, whole and at P 256: the uninterrupted serve first, then
    the interrupted one with the decode graphs dropped at the suspension
    (the chunk after the resume captures them afresh with the restored
    slot live); the state read back after the restore (``h``, ``conv``,
    K/V rows) bitwise the snapshot's, every stream the uninterrupted
    one's."""
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.serving import ContinuousEngine
    reqs = _p16_requests(cfg, spec, 63)
    pol = QuantPolicy("nxfp4", None if cfg.attn_free else "nxfp4")
    out = {}
    for mode, extra in (("whole", {}), (f"P {SSM_P}", dict(
            prefill_mode="chunked", p_chunk=SSM_P))):
        eng = ContinuousEngine(cfg, params, pol, n_slots=CONT_SLOTS,
                               chunk=CONT_CHUNK, max_len=max_len,
                               device="cuda", **extra)
        want = {r.uid: r.tokens for r in eng.serve(reqs)}
        times, box = {}, {}
        _p16_spy(eng, times, box)
        res = _counted(lambda: eng.serve(reqs, progress_cb=_p16_suspender(
            0, P16_SSM_AFTER, box, clear_graphs=True)), counts)
        _p16_check({r.uid: r for r in res}, want, f"{what} {mode}")
        snap = box["snap"]
        if box["to"][0] == box["from"] or not eng._graphs:
            fail(f"{what} {mode}: the request resumed in its own slot, or "
                 f"no graph was captured after the resume")
        if not _same_payload(box["back"][0], snap.device):
            fail(f"{what} {mode}: h/conv or K/V rows differ across the "
                 f"round trip")
        w = cfg.sliding_window
        if w and not (snap.pos > w and snap.used_rows == w):
            fail(f"{what} {mode}: the ring had not wrapped at the suspension"
                 f" (pos {snap.pos}, rows {snap.used_rows})")
        state = sum(int(leaf.nbytes) for layer in snap.device["layers"]
                    for name, leaf in layer.items() if name in ("h", "conv"))
        out[mode] = dict(pos=snap.pos, rows=snap.used_rows,
                         nbytes=snap.nbytes, state_bytes=state,
                         state_per_layer=state // cfg.n_layers,
                         suspend_ms=round(times["suspend"][0] * 1e3, 3),
                         resume_ms=round(times["resume"][0] * 1e3, 3))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _p16_tiers(cfg, counts):
    """An economy request on ``TieredContinuousEngine(default_tiers())``
    (default tier standard, 2 slots) suspended after its first chunk: it
    resumes in the other slot, into the economy arena, and every stream is
    the same engine's uninterrupted one."""
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving import TieredContinuousEngine, default_tiers
    from repro_torch.serving.engine import load_params
    raw = init_params(cfg, seed=0, device="cuda")
    model = load_params(raw, QuantPolicy(None, None), torch.device("cuda"))
    del raw
    reqs = _p16_requests(cfg, [(t, m) for t, m, _ in P16_TIERS], 64)
    reqs = [dataclasses.replace(r, tier=tier)
            for r, (_, _, tier) in zip(reqs, P16_TIERS)]
    eng = TieredContinuousEngine(cfg, model, default_tiers(),
                                 default_tier="standard", n_slots=2,
                                 chunk=CONT_CHUNK, max_len=CONT_MAX_LEN,
                                 device="cuda")
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    times, box = {}, {}
    _p16_spy(eng, times, box)
    tiers = []
    resume = eng._resume

    def spy(sched, state, slot, req, snap, clock, **kw):
        resume(sched, state, slot, req, snap, clock, **kw)
        tiers.append(eng._slot_tier[slot])
    eng._resume = spy
    replays = eng.replays
    res = _counted(lambda: eng.serve(reqs, progress_cb=_p16_suspender(
        0, CONT_CHUNK, box)), counts)
    _p16_check({r.uid: r for r in res}, want, "tiers")
    if eng.replays - replays != sum(eng.chunk_groups):
        fail("tiers: a group's decode chunk was not a graph replay")
    if tiers != ["economy"] or box["to"][0] == box["from"] or \
            not _same_payload(box["back"][0], box["snap"].device):
        fail(f"tiers: the economy request did not come back into its arena "
             f"in another slot ({tiers}, {box.get('to')}, "
             f"{box.get('from')})")
    fig = dict(pos=box["snap"].pos, nbytes=box["snap"].nbytes,
               suspend_ms=round(times["suspend"][0] * 1e3, 3),
               resume_ms=round(times["resume"][0] * 1e3, 3))
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return fig


def phase_suspend_resume(card: str, serving_layers: int):
    """Phase 16: suspension, preemption, slot snapshots and checkpoints,
    every interrupted stream bitwise the same engine's uninterrupted
    stream, inside the captured graphs. Llama-3-8B at full width and
    ``serving_layers`` (``_p16_llama``), Hymba-1.5B and Falcon-Mamba-7B at
    ``serving_layers`` (``_p16_family``), the economy tier on Llama-3-8B at
    ``serving_layers`` (``_p16_tiers``). Launches are counted around the
    interrupted serves and the restored engines' serves alone. Returns
    (launch counts by path, figures)."""
    import tempfile
    from repro_torch.configs import get_config
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    counts = {name: {} for name in P16_KERNELS}
    fig = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        fig["llama"] = _p16_llama(counts, tmp, serving_layers)
    t1 = time.time()
    hcfg, hparams, _ = _cast_family(HYMBA, serving_layers)
    fig["hymba"] = _p16_family(hcfg, hparams, P16_HYMBA, "hymba",
                               counts["hymba"], HYMBA_MAX_LEN)
    del hparams
    gc.collect()
    torch.cuda.empty_cache()
    fig["hymba_s"] = round(time.time() - t1, 1)
    t2 = time.time()
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving.engine import load_params
    fcfg = dataclasses.replace(get_config(FALCON), n_layers=serving_layers)
    raw = init_params(fcfg, seed=0, device="cuda")
    fparams = load_params(raw, QuantPolicy("nxfp4", None),
                          torch.device("cuda"))
    del raw
    fig["falcon"] = _p16_family(fcfg, fparams, P16_FALCON, "falcon",
                                counts["falcon"], FALCON_MAX_LEN)
    del fparams
    gc.collect()
    torch.cuda.empty_cache()
    fig["falcon_s"] = round(time.time() - t2, 1)
    t3 = time.time()
    tcfg = dataclasses.replace(get_config("llama3_8b"),
                               n_layers=serving_layers)
    fig["tiers"] = _p16_tiers(tcfg, counts["tiers"])
    fig["tiers_s"] = round(time.time() - t3, 1)
    fig["seconds"] = round(time.time() - t0, 1)
    lf = fig["llama"]
    log(f"suspension ({card}): Llama-3-8B full width, {serving_layers} "
        f"layers, nxfp4 "
        f"weights and KV, {CONT_SLOTS} slots, chunk {CONT_CHUNK}, max_len "
        f"{CONT_MAX_LEN}: every preempted, suspended, speculative-suspended "
        f"and restored stream bitwise the uninterrupted one; preempted vs "
        f"uninterrupted tok/s {lf['preemption']['preempted_tok_s']} vs "
        f"{lf['preemption']['uninterrupted_tok_s']} (rounds in turns: "
        f"{lf['preemption']['runs']}); snapshot of the sampled request at "
        f"pos {lf['snapshot_nxfp4']['pos']}: nxfp4 {lf['snapshot_nxfp4']} "
        f"vs bf16 KV {lf['snapshot_bf16']} ({lf['bf16_over_nxfp4']}x the "
        f"bytes a row and layer); suspend {lf['suspend_ms']} ms, resume "
        f"{lf['resume_ms']} ms (medians of {lf['moves']}); checkpoint "
        f"{lf['checkpoint']}; speculative {lf['speculative']}; cast "
        f"{lf['cast_s']} s, {lf['seconds']} s")
    for name in ("hymba", "falcon"):
        log(f"  suspension {name} ({card}): state and K/V bitwise across the"
            f" round trip, a graph captured after the resume, streams "
            f"bitwise: {fig[name]}")
    log(f"  suspension tiers ({card}): the economy request back in its "
        f"arena in another slot, streams bitwise: {fig['tiers']}")
    log(f"  launches on phase 16's paths (the interrupted serves alone; "
        f"Llama, Falcon and the tiers at {serving_layers} layers): "
        f"{counts}; "
        f"hymba {fig['hymba_s']} s, falcon {fig['falcon_s']} s, tiers "
        f"{fig['tiers_s']} s; phase 16 {fig['seconds']} s")
    for path, names in P16_KERNELS.items():
        for name in names:
            if counts[path].get(name, 0) <= 0:
                fail(f"phase 16 ({path}): kernel {name} was never launched")
    if counts["falcon"].get("nxfp_quantize", 0):
        fail("phase 16: Falcon's serves launched the quantizer (no K/V)")
    return counts, fig


# ---------------------------------------------------------------------------
# phase 17: faults, quarantine and the KV/SSM canaries
# ---------------------------------------------------------------------------

P17_REQS = ((64, 48), (128, 64), (96, 48), (32, 40), (160, 32))  # (T, new)
P17_NAN_UID, P17_FLIP_UID = 1, 2   # uid 1 gets one retry, uid 2 none
P17_FLIP_BYTES = 2
P17_DELAY = 0.05                   # s
P17_ROUNDS = 2                     # timed serves: (off, on, on, off) x 2
                                   # (3 until phase 22 came)
P17_FOLDS = 20                     # timed folds (CUDA events, median)
P17_FALCON = ((300, 48), (64, 32), (32, 16))
P17_TIERS = ((64, 32, "economy"), (96, 32, None), (48, 32, "economy"))
P17_KERNELS = {"llama faulted": ("nxfp_quantize", "nxfp_matmul",
                                 "nxfp_attention"),
               "llama speculative": ("nxfp_quantize", "nxfp_matmul",
                                     "nxfp_attention"),
               "llama paged": ("nxfp_quantize", "nxfp_matmul",
                               "nxfp_attention"),
               "falcon": ("nxfp_matmul",),
               "tiers": ("nxfp_quantize", "nxfp_matmul", "nxfp_qq_matmul")}


def _p17_plan(*faults):
    from repro_torch.serving import Fault, FaultPlan
    return FaultPlan([Fault(**f) for f in faults], seed=17)


def _p17_nan(uid):
    return dict(kind="nan_logits", chunk=1, uid=uid)


def _p17_contained(got, want, victims, what, healed=None):
    """``victims`` (uids) ended FAILED with a prefix of their fault-free
    stream ``want``, the others OK and bitwise ``want``; ``healed`` (uid ->
    stream): those ended OK with that stream."""
    import numpy as np
    from repro_torch.serving import Status
    healed = healed or {}
    if set(got) != set(want):
        fail(f"{what}: results for {sorted(got)}, expected {sorted(want)}")
    for uid, r in got.items():
        if uid in victims:
            ok = r.status == Status.FAILED and r.n_generated < len(
                want[uid]) and np.array_equal(r.tokens,
                                              want[uid][:r.n_generated])
        else:
            ok = r.status == Status.OK and np.array_equal(
                r.tokens, healed.get(uid, want[uid]))
        if not ok:
            fail(f"{what}: uid {uid} ({r.status}, {r.n_generated} tokens) "
                 f"{r.tokens[:8].tolist()} ... against the fault-free "
                 f"{want[uid][:8].tolist()} ... (victims {sorted(victims)})")


def _p17_timed(eng, name, times):
    """Time every call of ``eng.<name>`` on the host clock, the device
    synchronised around it."""
    fn = getattr(eng, name)

    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    setattr(eng, name, run)


def _event_ms(fn, n=P17_FOLDS) -> float:
    """Median CUDA-event ms of ``fn()`` (one call first, not timed)."""
    fn()
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return round(statistics.median(out), 4)


def _p17_llama(cfg, counts):
    """Llama-3-8B: the containment serve under the plan (``kv_integrity``),
    the canaries' cost in turns, the speculative and paged engines under
    ``nan_logits``."""
    import numpy as np
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.models.kvcache import kv_slot_checksum
    from repro_torch.serving import ContinuousEngine, PagedContinuousEngine
    from repro_torch.serving import SpeculativeConfig as Spec
    from repro_torch.serving.engine import load_params
    fig = {}
    t0 = time.time()
    raw = init_params(cfg, seed=0, device="cuda")
    nx = load_params(raw, QuantPolicy("nxfp4", None), torch.device("cuda"))
    del raw
    torch.cuda.empty_cache()
    pol = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=CONT_SLOTS, chunk=CONT_CHUNK, max_len=CONT_MAX_LEN,
              device="cuda")
    reqs = _p16_requests(cfg, P17_REQS, 70)
    reqs[P17_NAN_UID] = dataclasses.replace(reqs[P17_NAN_UID], retries=1)
    solos = _solo_streams(cfg, nx, reqs, CONT_MAX_LEN)
    eng = ContinuousEngine(cfg, nx, pol, kv_integrity=True, **kw)
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    for uid, toks in want.items():
        if not np.array_equal(toks, solos[uid]):
            fail(f"phase 17: the fault-free uid {uid} differs from its solo "
                 f"stream")
    times, trips = {}, []
    _p17_timed(eng, "_quarantine", times)
    verify = eng._kv_verify

    def spy_verify():
        out = verify()
        trips.append(out.copy())
        return out
    eng._kv_verify = spy_verify
    eng._graphs.clear()     # the faulted serve captures its own graphs
    plan = _p17_plan(_p17_nan(P17_NAN_UID),
                     dict(kind="kv_flip", chunk=2, uid=P17_FLIP_UID,
                          n_bytes=P17_FLIP_BYTES),
                     dict(kind="delay", chunk=1, seconds=P17_DELAY, shard=0))
    replays = eng.replays
    t1 = time.perf_counter()
    res, evs = _p16_events(lambda: _counted(
        lambda: eng.serve(reqs, fault_plan=plan), counts["llama faulted"]))
    wall = time.perf_counter() - t1
    eng._kv_verify = verify
    got = {r.uid: r for r in res}
    _p17_contained(got, want, {P17_FLIP_UID}, "llama faulted",
                   healed={P17_NAN_UID: solos[P17_NAN_UID]})
    if eng.replays - replays != eng.chunks:
        fail("llama faulted: a decode chunk was not a graph replay")
    quar = [(e["uid"], e["cause"]) for e in evs if e["event"] == "quarantine"]
    if len(quar) != 2 or quar[0] != (P17_NAN_UID, "nan_logits") \
            or quar[1][0] != P17_FLIP_UID:
        fail(f"llama faulted: quarantines {quar}")
    if not any(t.any() for t in trips):
        fail("llama faulted: the K/V canary never tripped on the flip")
    if wall < P17_DELAY:
        fail("llama faulted: the delay did not delay")
    fig["quarantines"] = quar
    fig["statuses"] = {u: r.status for u, r in got.items()}
    fig["failed_prefix"] = got[P17_FLIP_UID].n_generated
    fig["quarantine_ms"] = [round(t * 1e3, 3) for t in times["_quarantine"]]
    fig["faulted_s"] = round(wall, 3)

    # the canaries' cost: the same serve with kv_integrity off and on in
    # turns (off, on, on, off), its wall a decode chunk (host clock), the
    # canary work inside it (two folds, two host syncs) and, once over all
    # serves, a chunk's dispatch (its one host copy included), which the
    # canaries do not touch
    runs, dispatch = {"off": [], "on": []}, []
    for _ in range(P17_ROUNDS):
        for mode in ("off", "on", "on", "off"):
            eng.kv_integrity = mode == "on"
            ctimes = {}
            for name in ("_kv_refresh", "_kv_verify", "_ssm_rearm"):
                _p17_timed(eng, name, ctimes)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = eng.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            for name in ("_kv_refresh", "_kv_verify", "_ssm_rearm"):
                eng.__dict__.pop(name)
            _p16_check({r.uid: r for r in res}, want, f"llama canary {mode}")
            dispatch += [t for _, t in eng.chunk_times]
            canary = sum(sum(v) for v in ctimes.values())
            runs[mode].append(dict(
                canary_ms_a_chunk=round(canary / eng.chunks * 1e3, 3),
                wall_ms_a_chunk=round(wall / eng.chunks * 1e3, 3)))
    eng.kv_integrity = True
    walls = {m: [r["wall_ms_a_chunk"] for r in runs[m]] for m in runs}
    cn = fig["canary"] = dict(
        runs=runs,
        wall_ms_a_chunk_off=round(statistics.median(walls["off"]), 4),
        wall_ms_a_chunk_on=round(statistics.median(walls["on"]), 4),
        resolved=min(walls["on"]) > max(walls["off"]),
        canary_ms_a_chunk=round(statistics.median(
            r["canary_ms_a_chunk"] for r in runs["on"]), 4),
        dispatch_ms=round(statistics.median(dispatch) * 1e3, 4))
    cn["share_of_dispatch"] = round(
        cn["canary_ms_a_chunk"] / cn["dispatch_ms"], 4)
    cn["share_of_wall"] = round(
        cn["canary_ms_a_chunk"] / cn["wall_ms_a_chunk_off"], 4)
    # one fold of every slot's rows at the cache's depth (CUDA events)
    upto = torch.full((CONT_SLOTS,), CONT_MAX_LEN - CONT_CHUNK,
                      dtype=torch.int64, device=eng.cache["pos"].device)
    fig["fold_ms"] = _event_ms(lambda: kv_slot_checksum(
        cfg, eng.cache, upto, CONT_CHUNK))
    fig["fold_bytes"] = sum(
        int(b.nbytes) for lc in eng.cache["layers"] for b in lc.values())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    fig["llama_s"] = round(time.time() - t0, 1)

    # the speculative engine (k 4, recycled draft) under nan_logits: its
    # verify logits poisoned, the victim failed, the others bitwise
    sreqs = [dataclasses.replace(r, retries=0) for r in reqs[:4]]
    spec = ContinuousEngine(cfg, nx, pol, speculative=Spec(
        k=SPEC_K, draft="recycled"), **kw)
    swant = {r.uid: r.tokens for r in spec.serve(sreqs)}
    spec._graphs.clear()
    res = _counted(lambda: spec.serve(sreqs, fault_plan=_p17_plan(
        _p17_nan(P17_NAN_UID))), counts["llama speculative"])
    _p17_contained({r.uid: r for r in res}, swant, {P17_NAN_UID},
                   "llama speculative")
    for uid in swant:
        if uid != P17_NAN_UID and not np.array_equal(swant[uid],
                                                     solos[uid]):
            fail(f"llama speculative: uid {uid} is not the plain stream")
    del spec
    gc.collect()
    torch.cuda.empty_cache()

    # the paged engine under nan_logits: the victim's pages come back
    paged = PagedContinuousEngine(cfg, nx, pol, page_size=P15_PAGE, **kw)
    pwant = {r.uid: r.tokens for r in paged.serve(sreqs)}
    free = paged.pool.free
    paged._graphs.clear()
    res = _counted(lambda: paged.serve(sreqs, fault_plan=_p17_plan(
        _p17_nan(P17_NAN_UID))), counts["llama paged"])
    _p17_contained({r.uid: r for r in res}, pwant, {P17_NAN_UID},
                   "llama paged")
    if paged.pool.free != free or any(
            not np.array_equal(pwant[u], want[u]) for u in pwant):
        fail(f"llama paged: free pages {paged.pool.free} after the faulted "
             f"serve, {free} after the fault-free one, or a stream is not "
             f"the dense engine's")
    paged.pool.assert_empty()
    del paged, nx
    gc.collect()
    torch.cuda.empty_cache()
    fig["seconds"] = round(time.time() - t0, 1)
    return fig


def _p17_falcon(cfg, params, counts):
    """Falcon-Mamba-7B with ``kv_integrity``: uid 0's ``h`` changed at rest
    (between two chunks, in place, from ``progress_cb``) is quarantined as
    ``ssm_integrity`` before the next chunk and healed by its retry, every
    stream bitwise the fault-free serve's."""
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models.kvcache import ssm_state_checksum
    from repro_torch.serving import ContinuousEngine
    reqs = _p16_requests(cfg, P17_FALCON, 71)
    reqs[0] = dataclasses.replace(reqs[0], retries=1)
    eng = ContinuousEngine(cfg, params, QuantPolicy("nxfp4", None),
                           n_slots=CONT_SLOTS, chunk=CONT_CHUNK,
                           max_len=FALCON_MAX_LEN, kv_integrity=True,
                           device="cuda")
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    seen = {"n": 0}

    def upset(engine, sched):
        seen["n"] += 1
        if seen["n"] == 2:
            slot = next(s for s, r in sched.active.items() if r.uid == 0)
            engine.cache["layers"][0]["h"][slot, 0, 0] += 1.0
    res, evs = _p16_events(lambda: _counted(
        lambda: eng.serve(reqs, progress_cb=upset), counts))
    _p16_check({r.uid: r for r in res}, want, "falcon ssm canary")
    quar = [(e["uid"], e["cause"]) for e in evs if e["event"] == "quarantine"]
    if quar != [(0, "ssm_integrity")]:
        fail(f"falcon ssm canary: quarantines {quar}")
    fold = _event_ms(lambda: ssm_state_checksum(cfg, eng.cache))
    state = sum(int(b.nbytes) for lc in eng.cache["layers"]
                for b in lc.values())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(quarantines=quar, fold_ms=fold, state_bytes=state)


def _p17_tiers(cfg, counts):
    """``TieredContinuousEngine(default_tiers())``: an economy request
    poisoned and healed by its retry, the other tier's stream and the
    other economy stream bitwise the fault-free serve's."""
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving import TieredContinuousEngine, default_tiers
    from repro_torch.serving.engine import load_params
    raw = init_params(cfg, seed=0, device="cuda")
    model = load_params(raw, QuantPolicy(None, None), torch.device("cuda"))
    del raw
    reqs = _p16_requests(cfg, [(t, m) for t, m, _ in P17_TIERS], 72)
    reqs = [dataclasses.replace(r, tier=tier)
            for r, (_, _, tier) in zip(reqs, P17_TIERS)]
    reqs[0] = dataclasses.replace(reqs[0], retries=1)
    eng = TieredContinuousEngine(cfg, model, default_tiers(),
                                 default_tier="standard", n_slots=2,
                                 chunk=CONT_CHUNK, max_len=CONT_MAX_LEN,
                                 device="cuda")
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    res, evs = _p16_events(lambda: _counted(lambda: eng.serve(
        reqs, fault_plan=_p17_plan(dict(kind="nan_logits", chunk=1,
                                        uid=0))), counts))
    _p16_check({r.uid: r for r in res}, want, "tiers faulted")
    quar = [(e["uid"], e["cause"]) for e in evs if e["event"] == "quarantine"]
    if quar != [(0, "nan_logits")]:
        fail(f"tiers faulted: quarantines {quar}")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(quarantines=quar)


def phase_faults(card: str, serving_layers: int):
    """Phase 17: seeded faults, quarantine and the KV/SSM canaries through
    the engines the port serves, at full width and ``serving_layers``:
    Llama-3-8B (nxfp4 weights and KV, 4 slots, chunk 16, max_len 512,
    ``kv_integrity``) under nan_logits (uid 1, one retry), kv_flip (uid 2,
    2 bytes) and a delay, the speculative and paged engines under
    nan_logits, Falcon-Mamba-7B's at-rest ``h`` upset (``ssm_integrity``),
    the economy tier under nan_logits. Every healthy stream bitwise its
    fault-free serve, every healed one its solo stream, every victim's
    output a prefix. Launches are counted around the faulted serves alone;
    the Llama engines' faulted serves capture their decode graphs afresh
    (a replay counts no launch). Returns (launch counts by path,
    figures)."""
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving.engine import load_params
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    counts = {name: {} for name in P17_KERNELS}
    cfg = dataclasses.replace(get_config("llama3_8b"),
                              n_layers=serving_layers)
    fig = {"llama": _p17_llama(cfg, counts)}
    t1 = time.time()
    fcfg = dataclasses.replace(get_config(FALCON), n_layers=serving_layers)
    raw = init_params(fcfg, seed=0, device="cuda")
    fparams = load_params(raw, QuantPolicy("nxfp4", None),
                          torch.device("cuda"))
    del raw
    fig["falcon"] = _p17_falcon(fcfg, fparams, counts["falcon"])
    del fparams
    gc.collect()
    torch.cuda.empty_cache()
    fig["falcon_s"] = round(time.time() - t1, 1)
    t2 = time.time()
    fig["tiers"] = _p17_tiers(cfg, counts["tiers"])
    fig["tiers_s"] = round(time.time() - t2, 1)
    fig["seconds"] = round(time.time() - t0, 1)
    lf = fig["llama"]
    cn = lf["canary"]
    log(f"faults ({card}): Llama-3-8B full width, {serving_layers} layers, "
        f"nxfp4 weights and KV, {CONT_SLOTS} slots, chunk {CONT_CHUNK}, "
        f"max_len {CONT_MAX_LEN}, kv_integrity: statuses {lf['statuses']}, "
        f"quarantines {lf['quarantines']}, uid {P17_FLIP_UID} failed after "
        f"{lf['failed_prefix']} tokens (its prefix bitwise), uid "
        f"{P17_NAN_UID} healed bitwise its solo stream, the others bitwise "
        f"their fault-free serve; speculative and paged engines contained "
        f"nan_logits; {lf['seconds']} s")
    log(f"  canary fold ({card}): {lf['fold_ms']} ms for {CONT_SLOTS} slots "
        f"x {CONT_MAX_LEN} rows x {serving_layers} layers "
        f"({lf['fold_bytes']} B of packed K/V), CUDA events, median of "
        f"{P17_FOLDS}")
    log(f"  canary chunk ({card}): canary work {cn['canary_ms_a_chunk']} ms "
        f"a chunk (two folds, two host syncs), {cn['share_of_dispatch']} of "
        f"a chunk's dispatch ({cn['dispatch_ms']} ms, every serve) and "
        f"{cn['share_of_wall']} of the serve wall a chunk; serve wall a "
        f"chunk {cn['wall_ms_a_chunk_off']} off vs {cn['wall_ms_a_chunk_on']}"
        f" on, {'resolved' if cn['resolved'] else 'unresolved'} (ranges of "
        f"{2 * P17_ROUNDS} serves a mode in turns: {cn['runs']})")
    log(f"  quarantine to requeue ({card}): {lf['quarantine_ms']} ms "
        f"(host clock, synchronised: the event, release, reset_slot, park, "
        f"requeue)")
    log(f"  faults falcon ({card}): {serving_layers} layers, at-rest h "
        f"upset quarantined and healed, streams bitwise: {fig['falcon']} "
        f"(fold: CUDA events); tiers: {fig['tiers']}")
    log(f"  launches on phase 17's paths (the faulted serves alone): "
        f"{counts}; falcon {fig['falcon_s']} s, tiers {fig['tiers_s']} s; "
        f"phase 17 {fig['seconds']} s")
    for path, names in P17_KERNELS.items():
        for name in names:
            if counts[path].get(name, 0) <= 0:
                fail(f"phase 17 ({path}): kernel {name} was never launched")
    if counts["falcon"].get("nxfp_quantize", 0):
        fail("phase 17: Falcon's serves launched the quantizer (no K/V)")
    return counts, fig


# ---------------------------------------------------------------------------
# phase 18: the weights built a layer at a time (A18), the MoE family
# ---------------------------------------------------------------------------

QWEN, PHI, DEEPSEEK = "qwen2_moe_a2_7b", "phi3_5_moe_42b", "deepseek_67b"
P18_SERVE = (4, 128)                  # ServeEngine: B 4 x 128 prompt tokens
P18_QWEN_NEW, P18_NEW = 32, 16        # new tokens: Qwen's, the others'
P18_MAX_LEN = 512
# ContinuousEngine on Qwen-MoE: (prompt, max_new, arrival s), 4 slots
P18_CONT = ((128, 24, 0.0), (64, 40, 0.0), (200, 16, 0.0), (96, 32, 0.0),
            (48, 24, 0.05), (160, 8, 0.1))
P18_LANE_P = 32
P18_PREFIX, P18_TAILS, P18_PAGED_NEW = 96, (40, 8, 60), 16
# the grouped instance at the MoE paths' shapes: (arch, tokens, K, N); R =
# tokens * k rows, k and E the arch's
P18_GROUPED = {"qwen decode w1/w3": (QWEN, 4, 2048, 1408),
               "qwen decode w2": (QWEN, 4, 1408, 2048),
               "qwen prefill w1/w3": (QWEN, 512, 2048, 1408),
               "phi decode w1/w3": (PHI, 4, 4096, 6400),
               "phi decode w2": (PHI, 4, 6400, 4096)}
P18_MAIN_ROW = "nxfp_matmul_grouped qwen decode w1/w3"
P18_KERNELS = {"qwen serve": ("nxfp_quantize", "nxfp_matmul",
                              "nxfp_attention", "nxfp_matmul_grouped"),
               "qwen continuous": ("nxfp_matmul_grouped",),
               "qwen chunked": ("nxfp_matmul_grouped",),
               "phi serve": ("nxfp_matmul_grouped",),
               "qwen paged": ("nxfp_matmul_grouped",),
               "qwen tiered": ("nxfp_matmul_grouped", "nxfp_qq_matmul"),
               "deepseek serve": ("nxfp_matmul", "nxfp_attention"),
               "llama layered cast": ("nxfp_quantize",)}


def _free():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _same_tree(a, b, what):
    """Every QTensor's packed bytes and meta and every other leaf bitwise."""
    from repro_torch.core.qtensor import QTensor, _leaves
    from repro_torch.kernels.build import bit_view
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        fail(f"{what}: {len(la)} leaves against {len(lb)}")
    n_q = 0
    for x, y in zip(la, lb):
        if isinstance(x, QTensor):
            n_q += 1
            if not (isinstance(y, QTensor) and x.shape == y.shape
                    and torch.equal(x.packed, y.packed)
                    and torch.equal(bit_view(x.meta), bit_view(y.meta))):
                fail(f"{what}: a QTensor differs")
        elif not (x.dtype == y.dtype and torch.equal(x, y)):
            fail(f"{what}: a dense leaf differs")
    return n_q


def _layer_f32_bytes(layer) -> int:
    """A layer's weights as f32 (what a layer-at-a-time build holds)."""
    from repro_torch.core.qtensor import _leaves
    return sum(4 * torch.Size(leaf.shape).numel() for leaf in _leaves(layer))


def _build_layered(cfg, counts=None):
    """``init_params(policy=)``: nxfp4, a layer at a time, on the card.
    Returns (params, figures: seconds, peak above what was allocated
    before, bytes kept, packed bytes, one layer's f32 bytes)."""
    from repro_torch.core.qtensor import QuantPolicy, tree_footprint_bytes
    from repro_torch.models import init_params
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()

    def build():
        p = init_params(cfg, seed=0, device="cuda",
                        policy=QuantPolicy("nxfp4", "nxfp4"))
        torch.cuda.synchronize()
        return p

    params = build() if counts is None else _counted(build, counts)
    fig = dict(seconds=round(time.time() - t0, 2),
               peak=torch.cuda.max_memory_allocated() - base,
               kept=torch.cuda.memory_allocated() - base,
               packed=tree_footprint_bytes(params),
               layer_f32=_layer_f32_bytes(params["layers"][0]))
    fig["bound"] = fig["packed"] + 2 * fig["layer_f32"]
    return params, fig


def _p18_llama(counts):
    """(a) Llama-3-8B at full width and depth: the whole f32 build and its
    cast (``load_params``) against the layer-at-a-time build, bitwise, and
    both peaks."""
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving.engine import load_params
    cfg = get_config("llama3_8b")
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    raw = init_params(cfg, seed=0, device="cuda")
    whole = load_params(raw, QuantPolicy("nxfp4", "nxfp4"),
                        torch.device("cuda"))
    del raw
    torch.cuda.synchronize()
    fig = {"whole": dict(seconds=round(time.time() - t0, 2),
                         peak=torch.cuda.max_memory_allocated() - base)}
    layered, fig["layered"] = _build_layered(cfg, counts)
    n_q = _same_tree(whole, layered, "llama3_8b layered build")
    lf = fig["layered"]
    if lf["peak"] > lf["bound"]:
        fail(f"llama3_8b layered build: peak {lf['peak']} bytes above the "
             f"packed bytes + 2 layers of f32 ({lf['bound']})")
    fig["qtensors"] = n_q
    del whole, layered
    _free()
    return fig


def _graph_vs_host(cfg, params, n_new, what, counts):
    """ServeEngine on B 4 x 128 prompt tokens: the graph device loop
    (twice; launches counted) bitwise the host loop. Returns figures."""
    import numpy as np
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                      max_len=P18_MAX_LEN, device="cuda")
    batch = {"tokens": np.random.default_rng(18).integers(
        0, cfg.vocab, P18_SERVE)}
    runs = _counted(lambda: [
        eng.generate(batch, max_new=n_new, loop="device", chunk=16)
        for _ in range(2)], counts)
    host = eng.generate(batch, max_new=n_new, loop="host")
    for r in runs:
        if not np.array_equal(r.tokens, host.tokens) or not (
                r.n_generated == n_new).all():
            fail(f"{what}: the graph device loop and the host loop disagree")
    ms = runs[-1].decode_seconds / n_new * 1e3
    return dict(graph_ms_step=round(ms, 3),
                host_ms_step=round(host.decode_seconds / n_new * 1e3, 3),
                tok_s=round(P18_SERVE[0] * 1e3 / ms, 2),
                prefill_s=round(runs[-1].prefill_seconds, 4))


def _p18_serve(arch, n_new, counts):
    """(b), (d): ``arch`` at full size, built a layer at a time, through
    ServeEngine's graph loop against its host loop."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    params, fig = _build_layered(cfg)
    fig.update(_graph_vs_host(cfg, params, n_new, arch, counts))
    del params
    _free()
    return fig


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _p18_qwen(counts):
    """(c) Qwen1.5-MoE-A2.7B at full size: ServeEngine graph == host;
    ContinuousEngine under whole admission, every stream bitwise its solo
    host-loop stream; chunked admission (P 32) warns and serves."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.serving import ContinuousEngine, Request, Status
    cfg = get_config(QWEN)
    params, fig = _build_layered(cfg)
    fig.update(_graph_vs_host(cfg, params, P18_QWEN_NEW, QWEN,
                              counts["qwen serve"]))
    rng = np.random.default_rng(28)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, arrival_time=a)
            for i, (t, m, a) in enumerate(P18_CONT)]
    solos = _solo_streams(cfg, params, reqs, P18_MAX_LEN)
    policy = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=CONT_SLOTS, max_len=P18_MAX_LEN, chunk=CONT_CHUNK,
              device="cuda")
    eng, fig["continuous"] = _counted(lambda: _checked_serves(
        lambda: ContinuousEngine(cfg, params, policy, **kw), reqs, solos,
        "qwen continuous whole"), counts["qwen continuous"])
    if eng.replays == 0:
        fail("qwen continuous: no graph replays")
    del eng
    _free()
    catch = _Warnings()
    log_ = logging.getLogger("repro_torch.serving")
    log_.addHandler(catch)
    try:
        eng = ContinuousEngine(cfg, params, policy, prefill_mode="chunked",
                               p_chunk=P18_LANE_P, **kw)
    finally:
        log_.removeHandler(catch)
    if not any("chunk-local" in m and "moe" in m for m in catch.messages):
        fail(f"qwen chunked: no chunk-local warning ({catch.messages})")
    res = _counted(lambda: eng.serve(reqs), counts["qwen chunked"])
    if any(r.status != Status.OK for r in res) or any(
            r.n_generated != reqs[r.uid].max_new for r in res):
        fail(f"qwen chunked: {[(r.uid, r.status, r.n_generated) for r in res]}")
    fig["chunked"] = dict(statuses=sorted({r.status for r in res}),
                          lane_chunks=eng.lane_chunks,
                          same_as_whole=sum(np.array_equal(
                              r.tokens, solos[r.uid]) for r in res))
    del eng, params
    _free()
    return fig


def _p18_qwen_engines(card, serving_layers, counts):
    """(e) Qwen-MoE at ``serving_layers``: PagedContinuousEngine (no shared
    prefix: bitwise the solos; a shared prefix: statuses and prefix hits),
    the tiered engine over its three tiers (whole admission: the MoE lane
    is outside the bitwise contract), ``speculative=`` refused."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                     Request, SpeculativeConfig, Status)
    cfg = dataclasses.replace(get_config(QWEN), n_layers=serving_layers)
    params, _ = _build_layered(cfg)
    policy = QuantPolicy("nxfp4", "nxfp4")
    rng = np.random.default_rng(38)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, arrival_time=a)
            for i, (t, m, a) in enumerate(P18_CONT[:4])]
    solos = _solo_streams(cfg, params, reqs, P18_MAX_LEN)
    kw = dict(n_slots=CONT_SLOTS, max_len=P18_MAX_LEN, chunk=CONT_CHUNK,
              device="cuda")
    fig = {}
    eng, fig["paged"] = _counted(lambda: _checked_serves(
        lambda: PagedContinuousEngine(cfg, params, policy, page_size=32,
                                      **kw), reqs, solos, "qwen paged"),
        counts["qwen paged"])
    prefix = rng.integers(0, cfg.vocab, (P18_PREFIX,))
    shared = [Request(uid=i, tokens=np.concatenate(
        [prefix, rng.integers(0, cfg.vocab, (t,))]), max_new=P18_PAGED_NEW)
        for i, t in enumerate(P18_TAILS)]
    hits = eng.pool.prefix_hits
    res = _counted(lambda: eng.serve(shared), counts["qwen paged"])
    if any(r.status != Status.OK for r in res):
        fail(f"qwen paged shared prefix: {[(r.uid, r.status) for r in res]}")
    eng.pool.assert_empty()
    fig["paged_shared"] = dict(statuses=sorted({r.status for r in res}),
                               prefix_hits=eng.pool.prefix_hits - hits)
    del eng
    try:
        ContinuousEngine(cfg, params, policy, speculative=SpeculativeConfig(
            k=4), **kw)
        fail("qwen: speculative= was not refused")
    except ValueError as e:
        if "family" not in str(e):
            raise
        fig["speculative"] = str(e)
    del params
    _free()
    fig["tiers"] = _tiers_family(card, cfg, "qwen-moe", counts["qwen tiered"],
                                 modes=("whole",))
    return fig


def _grouped_case(name, arch, tokens, k_dim, n_dim, timer, rows):
    """The grouped instance at one shape: random weights (E, K, N) cast to
    nxfp4, the routing of random router logits (top-k, the capacity of
    ``tokens`` tokens when more than one decode batch), x (R, K) bf16."""
    from repro_torch.configs import get_config
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import nxfp_matmul as nm
    from repro_torch.kernels import nxfp_matmul_grouped as ng
    from repro_torch.kernels.ops import expert_matmul, qmatmul
    from repro_torch.kernels.ops import quantize_qtensor
    from repro_torch.models import moe
    cfg = get_config(arch)
    e, k = cfg.n_experts, cfg.n_experts_active
    fmt = get_format("nxfp4")
    gen = torch.Generator(device="cuda").manual_seed(18)
    w = torch.randn((e, k_dim, n_dim), generator=gen, device="cuda") * 0.02
    wq = quantize_qtensor(w, fmt, axis=-2, device="cuda")
    del w
    logits = torch.randn((tokens, e), generator=gen, device="cuda")
    idx = torch.topk(logits, k, dim=-1).indices
    cap = moe.capacity(cfg, tokens) if tokens > 16 else tokens
    expert, _ = moe.dispatch(cfg, idx, cap)
    r = tokens * k
    x = torch.randn((r, k_dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    y = expert_matmul(x, expert, wq)
    again = expert_matmul(x, expert, wq)
    if not torch.equal(y, again):
        fail(f"grouped {name}: a second launch gave other bits")
    plain = ng.nxfp_matmul_grouped_plain(x, expert, wq.packed, wq.meta, fmt)
    ex = expert.cpu()
    routed = sorted(set(ex.tolist()) - {-1})
    deq = {i: nm.dequant_weight_bf16(wq.packed[i], wq.meta[i], fmt).T
           .contiguous() for i in routed}                      # (K, N)
    sel = {i: torch.nonzero(ex == i).flatten().to("cuda") for i in routed}
    mag = torch.zeros_like(plain)
    for i in routed:
        mag[sel[i]] = x[sel[i]].float().abs() @ deq[i].float().abs()
    err = float((y - plain).abs().max())
    rel = float(((y - plain).abs() / mag.clamp(min=1e-30)).max())
    if not rel <= 1e-5:
        fail(f"grouped {name}: error {rel:.3g} of sum|x||w| exceeds 1e-5")
    if bool(y[ex == -1].any()):
        fail(f"grouped {name}: a dropped row is not zero")
    # each row's bits: ops.qmatmul of its expert's rows, up to 16 at once
    for i in routed:
        wi = QTensor(wq.packed[i], wq.meta[i], wq.fmt_name, wq.shape[1:],
                     wq.axis, wq.orig_len)
        for g0 in range(0, len(sel[i]), 16):
            rr = sel[i][g0:g0 + 16]
            if not torch.equal(y[rr], qmatmul(x[rr], wi)):
                fail(f"grouped {name}: expert {i}'s rows differ from "
                     f"ops.qmatmul's at M {len(rr)}")
    ms = timer(lambda: expert_matmul(x, expert, wq))
    plain_ms = timer(lambda: ng.nxfp_matmul_grouped_plain(
        x, expert, wq.packed, wq.meta, fmt), 5)

    def library():
        for i in routed:
            torch.matmul(x[sel[i]], deq[i])
    lib_ms = timer(library)
    kept = int((ex >= 0).sum())
    n_bytes = (sum(wq.packed[i].numel() + wq.meta[i].numel() * 2
                   for i in routed) + r * k_dim * 2 + r * n_dim * 4 + r * 4)
    b_ms, b_by = bound(n_bytes, 2.0 * kept * k_dim * n_dim, PEAK_BF16)
    log(f"grouped {name}: R {r} (kept {kept}, {len(routed)} of {e} experts "
        f"routed) K {k_dim} N {n_dim}: max err {err:.3g} ({rel:.3g} of "
        f"sum|x||w|), bitwise on a second launch and row for row "
        f"ops.qmatmul's; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.matmul of each routed expert's rows (bf16, dequantized) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows[f"nxfp_matmul_grouped {name}"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms,
        shape=f"x ({r}, {k_dim}) bf16 @ nxfp4 W ({e}, {k_dim}, {n_dim}), "
              f"{len(routed)} experts routed, {kept} rows kept")
    del wq, deq, x, y, again, plain, mag
    _free()


def phase_moe(card: str, serving_layers: int, rows):
    """Phase 18: the weights built and cast a layer at a time, then the MoE
    family through the engines, at full width: (a) Llama-3-8B's layered
    build bitwise the whole build's cast, both peaks; (b) DeepSeek-67B (95
    layers) and (d) Phi-3.5-MoE (32 layers) built a layer at a time,
    ServeEngine's graph loop bitwise its host loop; (c) Qwen1.5-MoE-A2.7B
    (24 layers): the same, ContinuousEngine under whole admission bitwise
    the solos, chunked admission warned and served; (e) Qwen-MoE at
    ``serving_layers`` through the paged and the tiered engines, the
    speculative refusal; (f) the grouped instance against its plain
    version, ``ops.qmatmul``'s rows and ``torch.matmul``. Launches are
    counted around each path alone. Returns (counts by path, figures)."""
    t0 = time.time()
    counts = {path: {} for path in P18_KERNELS}
    fig = {"llama": _p18_llama(counts["llama layered cast"])}
    fig["deepseek"] = _p18_serve(DEEPSEEK, P18_NEW, counts["deepseek serve"])
    fig["qwen"] = _p18_qwen(counts)
    fig["phi"] = _p18_serve(PHI, P18_NEW, counts["phi serve"])
    fig["qwen engines"] = _p18_qwen_engines(card, serving_layers, counts)
    timer = Timer("cuda")
    for name, case in P18_GROUPED.items():
        _grouped_case(name, *case, timer, rows)
    del timer
    _free()
    fig["seconds"] = round(time.time() - t0, 1)
    la, ll = fig["llama"]["whole"], fig["llama"]["layered"]
    log(f"layered build ({card}): Llama-3-8B full width, 32 layers, nxfp4: "
        f"the layer-at-a-time build bitwise the whole build's cast "
        f"({fig['llama']['qtensors']} QTensors); peak above what was "
        f"allocated before: whole f32 build + cast {la['peak']} bytes "
        f"({la['seconds']} s), layer at a time {ll['peak']} bytes "
        f"({ll['seconds']} s) against packed {ll['packed']} + 2 x one "
        f"layer's f32 {ll['layer_f32']} = {ll['bound']} bytes")
    for arch in ("deepseek", "qwen", "phi"):
        f = fig[arch]
        log(f"  {arch} ({card}): full size, built a layer at a time in "
            f"{f['seconds']} s, peak {f['peak']} bytes against packed "
            f"{f['packed']} + 2 x {f['layer_f32']} = {f['bound']}; weights "
            f"kept {f['kept']} bytes; ServeEngine {P18_SERVE[0]} x "
            f"{P18_SERVE[1]} tokens: graph loop == host loop, decode "
            f"{f['graph_ms_step']} ms/step ({f['tok_s']} tok/s) vs host "
            f"loop {f['host_ms_step']} ms/step, prefill {f['prefill_s']} s")
    q = fig["qwen"]
    log(f"  qwen ContinuousEngine ({card}): {len(P18_CONT)} requests "
        f"{list(P18_CONT)} over {CONT_SLOTS} slots, chunk {CONT_CHUNK}, "
        f"whole admission, every stream bitwise its solo host-loop stream: "
        f"{q['continuous']}; chunked P {P18_LANE_P}: warned, {q['chunked']}")
    log(f"  qwen engines at {serving_layers} layers ({card}): "
        f"{fig['qwen engines']}")
    log(f"  launches on phase 18's paths: {counts}; phase 18 "
        f"{fig['seconds']} s")
    for path, names in P18_KERNELS.items():
        for name in names:
            if counts[path].get(name, 0) <= 0:
                fail(f"phase 18 ({path}): kernel {name} was never launched")
    return counts, fig


# ---------------------------------------------------------------------------
# phase 19: the vision and audio families and the quantized-KV simulation
# ---------------------------------------------------------------------------

VISION, WHISPER = "llama_3_2_vision_90b", "whisper_tiny"
P19_SERVE = (4, 128)                  # ServeEngine: B 4 x 128 prompt tokens
P19_NEW, P19_CHUNK, P19_MAX_LEN = 32, 16, 256
P19_SOLOS = (1, 3)                    # rows of the batch served alone at B 1
# the dequant GEMM at the families' (K, N) pairs, at a decode batch and a
# prefill: Vision-90B's wq/wo, wk/wv (and cross_wk/wv), w1/w3, w2; its
# memory projection (cross_wk/wv over 4 x 1601 patches); Whisper-tiny's
# wq/wk/wv/wo, w1/w3, w2, also at the encoder's and the memory
# projection's M (4 x 1500 frames)
P19_VISION_KN = ((8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192))
P19_WHISPER_KN = ((384, 384), (384, 1536), (1536, 384))
P19_M = (4, 512)
P19_VISION_MEM_M = 4 * 1601
P19_WHISPER_ENC_M = 4 * 1500
# the dense-row instance over each family's memory, every row valid (as
# cross decode reads it; check_dense_attention adds 4 ragged rows), and
# packed decode attention and the K/V write at Whisper's heads
P19_MEMORY = (((8, 8, 128), 1601, (1601,) * 4),
              ((6, 1, 64), 1500, (1500,) * 4))
P19_ATTENTION = (((6, 1, 64), 512, (512, 300, 131, 17)),)
P19_KV = {"decode whisper": (1, (128, 200, 17, 255), 64, 256, 6),
          "prefill whisper": (128, None, 64, 256, 6)}
P19_CASTS = {"nxfp_quantize vision mlp_w1": (8192, 28672),
             "nxfp_quantize whisper mlp_w1": (384, 1536)}
P19_KV_SIM = (4, 128, 8, 128)         # a Llama-3-8B prefill's K, bf16
P19_MAIN_ROWS = ("nxfp_matmul M=4 K=8192 N=28672",
                 "dense_decode_attention KVH=8 G=8 D=128 S=1601")
_SERVED = ("nxfp_quantize", "nxfp_matmul", "nxfp_attention",
           "dense_attention")
P19_KERNELS = {"vision serve": _SERVED, "whisper serve": _SERVED,
               "vision build": ("nxfp_quantize",),
               "whisper build": ("nxfp_quantize",),
               "kv_sim prefill": ("nxfp_quantize", "nxfp_matmul")}


def _memory_name(cfg) -> str:
    return "vision" if cfg.family == "vlm" else "frames"


def _memory_rows(cfg) -> int:
    return cfg.n_vision_tokens or cfg.n_audio_frames


def _fake_quant_diff(x, got, what, fname="nxfp4"):
    """Blocks (along the last axis, padded as the codec pads them) where
    ``got``, the kv_sim route's output for ``x`` on the card under
    ``fname``, differs from the plain ``fake_quant`` of the same tensor;
    fails unless each is a candidate near-tie. Returns (differing blocks,
    blocks)."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.quantize import (fake_quant, near_tie_blocks,
                                           to_blocks)
    fmt = get_format(fname)
    bs = fmt.block_size
    ne = (got != fake_quant(x, fmt, axis=-1)).to(torch.float32)
    diff = to_blocks(ne, bs, -1)[0].reshape(-1, bs).any(-1)
    if diff.any():
        xb = to_blocks(x.float(), bs, -1)[0].reshape(-1, bs)
        if not bool(near_tie_blocks(xb[diff], fmt, table=True).all()):
            fail(f"{what}: the card's fake-quantized blocks differ from the "
                 "plain fake_quant beyond a candidate near-tie")
    return int(diff.sum()), diff.numel()


def _p19_small():
    """(a) The smoke vision and audio models through the kernels on the
    card against the plain path on the CPU, from the same weights and
    inputs (the memory drawn on the card): prefill and 4 teacher-forced
    decode steps, logits within phase 4's 1e-2. Then the smoke Llama with
    ``kv_sim_fmt="nxfp4"`` and a dense cache: every K/V the simulation
    fake-quantizes on the card equal to the plain codec's ``fake_quant``
    of the same tensor (but for counted candidate near-tie blocks), its
    logits within 1e-2 of the CPU's and not the unsimulated ones."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import attention, decode_step, init_params
    from repro_torch.models import prefill
    from repro_torch.serving import ServeEngine
    fig, devs = {}, ("cpu", "cuda")
    pol = QuantPolicy("nxfp4", "nxfp4")
    for arch in (VISION, WHISPER):
        cfg = get_smoke_config(arch)
        params = init_params(cfg, seed=0, device="cpu")
        eng = {dev: ServeEngine(cfg, params, pol, max_len=32, device=dev)
               for dev in devs}
        gen = torch.Generator(device="cuda").manual_seed(19)
        mem = torch.randn((2, _memory_rows(cfg), cfg.d_model), generator=gen,
                          device="cuda")
        toks = torch.from_numpy(np.random.default_rng(19).integers(
            0, cfg.vocab, (2, 9)))
        out = {dev: prefill(cfg, e.params, {"tokens": toks.to(dev),
                                            _memory_name(cfg): mem.to(dev)},
                            max_len=32, kv_fmt="nxfp4")
               for dev, e in eng.items()}
        worst = 0.0
        for step in range(5):
            lc, lg = out["cpu"][0], out["cuda"][0].cpu()
            if not torch.isfinite(lg).all():
                fail(f"{arch} smoke: non-finite logits on the card")
            worst = max(worst, float((lc - lg).abs().max()))
            if step == 4:
                break
            tok = torch.argmax(lc, dim=-1)
            for dev, e in eng.items():
                out[dev] = decode_step(cfg, e.params, tok.to(dev)[:, None],
                                       out[dev][1], "nxfp4")
        if worst > 1e-2:
            fail(f"{arch} smoke: card vs CPU logits differ by {worst:.3g} "
                 "> 1e-2")
        fig[arch] = worst
        del eng, out
    cfg = dataclasses.replace(get_smoke_config("llama3_8b"),
                              kv_sim_fmt="nxfp4")
    params = init_params(cfg, seed=0, device="cpu")
    pol = QuantPolicy("nxfp4", None)
    eng = {dev: ServeEngine(cfg, params, pol, max_len=32, device=dev)
           for dev in devs}
    toks = torch.from_numpy(np.random.default_rng(20).integers(
        0, cfg.vocab, (2, 9)))
    real, seen = attention.fake_quant_rows, []

    def spy(x, fmt):
        y = real(x, fmt)
        if x.is_cuda:
            seen.append((x, y))
        return y

    counts = {}
    attention.fake_quant_rows = spy
    try:
        logits = {dev: prefill(cfg, e.params, {"tokens": toks.to(dev)},
                               max_len=32, kv_fmt=None)[0].cpu()
                  for dev, e in eng.items() if dev == "cpu"}
        logits["cuda"] = _counted(lambda: prefill(
            cfg, eng["cuda"].params, {"tokens": toks.cuda()}, max_len=32,
            kv_fmt=None)[0].cpu(), counts)
    finally:
        attention.fake_quant_rows = real
    if len(seen) != 2 * cfg.n_layers:
        fail(f"kv_sim: {len(seen)} fake-quantized K/V on the card, "
             f"{2 * cfg.n_layers} expected")
    n_diff, n_blocks = 0, 0
    for x, y in seen:
        d, n = _fake_quant_diff(x, y, "kv_sim smoke")
        n_diff, n_blocks = n_diff + d, n_blocks + n
    err = float((logits["cpu"] - logits["cuda"]).abs().max())
    if err > 1e-2:
        fail(f"kv_sim smoke: card vs CPU logits differ by {err:.3g} > 1e-2")
    plain = prefill(dataclasses.replace(cfg, kv_sim_fmt=None),
                    eng["cuda"].params, {"tokens": toks.cuda()}, max_len=32,
                    kv_fmt=None)[0].cpu()
    if torch.equal(plain, logits["cuda"]):
        fail("kv_sim smoke: the simulated prefill gave the plain logits")
    fig["kv_sim"] = dict(logit_err=err, tensors=len(seen), blocks=n_blocks,
                         near_ties=n_diff)
    log(f"phase 19 (a): smoke vision and audio models through the kernels "
        f"vs the plain CPU path, prefill + 4 teacher-forced steps: max logit "
        f"difference {fig[VISION]:.3g} / {fig[WHISPER]:.3g} (tolerance 1e-2); "
        f"smoke Llama kv_sim_fmt=nxfp4, dense cache: {len(seen)} K/V tensors "
        f"fake-quantized on the card, {n_blocks} blocks, bitwise the plain "
        f"fake_quant but {n_diff} near-tie blocks; logits {err:.3g} from the "
        f"CPU's, not the unsimulated ones")
    return counts, fig


def _p19_serve(arch, counts):
    """(b), (c): ``arch`` at full width and depth, built a layer at a time
    (nxfp4), its memory drawn on the card: ServeEngine on 4 x 128 prompt
    tokens, 32 greedy tokens, the graph device loop (chunk 16, one graph,
    twice) bitwise the host loop, the dense-row instance and the quantizer
    launched as many times a decode step as there are cross and self
    layers; two rows served alone at B 1 bitwise their rows of the batch.
    For the audio family the encoder's seconds and peak memory."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import lm
    from repro_torch.serving import ServeEngine
    cfg = get_config(arch)
    what = "vision" if cfg.family == "vlm" else "whisper"
    params, fig = _build_layered(cfg, counts[f"{what} build"])
    # the embedding and the head are drawn in f32 before their bf16 store:
    # where one outweighs a layer (Whisper-tiny: 79.7 MB of f32 against
    # 11.8) the build peaks on that draw, which phase 18's bound (packed +
    # 2 layers of f32) does not count
    fig["layer_bound"] = fig["bound"]
    fig["bound"] = fig["packed"] + 2 * max(fig["layer_f32"],
                                           4 * cfg.vocab * cfg.d_model)
    if fig["peak"] > fig["bound"]:
        fail(f"{arch} layered build: peak {fig['peak']} bytes above the "
             f"packed bytes + 2 x the largest f32 draw ({fig['bound']})")
    if cfg.family == "vlm" and fig["peak"] > fig["layer_bound"]:
        fail(f"{arch} layered build: peak {fig['peak']} bytes above the "
             f"packed bytes + 2 layers of f32 ({fig['layer_bound']})")
    b, t = P19_SERVE
    gen = torch.Generator(device="cuda").manual_seed(19)
    mem = torch.randn((b, _memory_rows(cfg), cfg.d_model), generator=gen,
                      device="cuda")
    toks = np.random.default_rng(19).integers(0, cfg.vocab, (b, t))
    name = _memory_name(cfg)
    batch = {"tokens": toks, name: mem}
    eng = ServeEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                      max_len=P19_MAX_LEN, device="cuda")
    del params
    if cfg.family == "audio":
        _free()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        enc = lm._encode_audio(cfg, eng.params, mem)
        torch.cuda.synchronize()
        fig["encoder_s"] = round(time.time() - t0, 4)
        fig["encoder_peak"] = torch.cuda.max_memory_allocated() - base
        del enc
    serve = counts[f"{what} serve"]
    runs = _counted(lambda: [
        eng.generate(batch, max_new=P19_NEW, loop="device", chunk=P19_CHUNK)
        for _ in range(2)], serve)
    step = {}
    host = _counted(lambda: eng.generate(batch, max_new=P19_NEW,
                                         loop="host"), step)
    for k, v in step.items():
        serve[k] = serve.get(k, 0) + v
    for r in runs:
        if not np.array_equal(r.tokens, host.tokens) or not (
                r.n_generated == P19_NEW).all():
            fail(f"{arch}: the graph device loop and the host loop disagree")
    if _device_loop_of(eng).replays < 2 * (P19_NEW // P19_CHUNK):
        fail(f"{arch}: the device loop did not replay its graph")
    kinds = lm.layer_kinds(cfg)
    n_cross = sum(k in ("cross", "encdec") for k in kinds)
    n_self = sum(k != "cross" for k in kinds)
    # the host loop: a prefill (a K/V write a self layer) and 32 steps
    if step.get("dense_attention") != n_cross * P19_NEW or step.get(
            "nxfp_quantize") != n_self * (P19_NEW + 1):
        fail(f"{arch}: the host loop's launches {step} are not "
             f"{n_cross} dense-row attentions and {n_self} K/V writes a "
             f"step")
    for i in P19_SOLOS:
        solo = eng.generate({"tokens": toks[i:i + 1], name: mem[i:i + 1]},
                            max_new=P19_NEW, loop="device", chunk=P19_CHUNK)
        if not np.array_equal(solo.tokens[0], host.tokens[i]):
            fail(f"{arch}: row {i} served alone at B 1 is not its row of "
                 f"the B {b} stream")
    ms = runs[-1].decode_seconds / P19_NEW * 1e3
    fig.update(graph_ms_step=round(ms, 3),
               host_ms_step=round(host.decode_seconds / P19_NEW * 1e3, 3),
               tok_s=round(b * 1e3 / ms, 2),
               prefill_s=round(runs[-1].prefill_seconds, 4),
               per_step={"dense_attention": n_cross, "nxfp_quantize": n_self},
               weights=eng.weights_footprint_bytes())
    del eng
    _free()
    return fig


def _memory_guard(heads, s):
    """The dense-row instance over a memory of ``s`` rows whose next slot
    is NaN: the output stays finite (the kernel reads no row at or past
    ``s``; its last 32-row tile is partial)."""
    from repro_torch.kernels import dense_attention as da
    kvh, g, d = heads
    gen = torch.Generator(device="cuda").manual_seed(29)
    kv = torch.randn((2, 5, s, kvh, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv[:, 4] = float("nan")
    q = torch.randn((4, kvh, g, d), generator=gen, device="cuda") * d ** -0.5
    lens = torch.full((4,), s, dtype=torch.int32, device="cuda")
    out = da.dense_decode_attention(q, kv[0, :4], kv[1, :4], lens)
    if not torch.isfinite(out).all():
        fail(f"dense decode attention S={s}: a row at or past S was read")


def _kv_sim_row(timer, rows, fname="nxfp4", key="nxfp_quantize kv_sim"):
    """The kv_sim route's kernel at a Llama-3-8B prefill's K (4, 128, 8,
    128) bf16 under ``fname``: the quantizer under the table-driven rules
    on its 16384 blocks against its plain version (bitwise but near
    ties), and ``fake_quant_rows`` against the plain ``fake_quant``."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.quantize import near_tie_blocks
    from repro_torch.core.pack import unpack_codes
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.decode_lib import decode_block_values
    from repro_torch.kernels.ops import fake_quant_rows
    fmt = get_format(fname)
    gen = torch.Generator(device="cuda").manual_seed(21)
    k = torch.randn(P19_KV_SIM, generator=gen, device="cuda").to(
        torch.bfloat16)
    flat = k.reshape(-1, fmt.block_size)
    kp, km = nq.nxfp_quantize_pack(flat, fmt, table=True)
    pp, pm = nq.nxfp_quantize_pack_plain(flat, fmt, table=True)
    diff = (kp != pp).any(-1) | (km.to(torch.int32) != pm.to(torch.int32))
    route, _ = _fake_quant_diff(k, fake_quant_rows(k, fname), "kv_sim",
                                fname)
    err = float((decode_block_values(unpack_codes(kp, fmt.bits, 32), km, fmt)
                 - decode_block_values(unpack_codes(pp, fmt.bits, 32), pm,
                                       fmt)).abs().max())
    if diff.any() and not bool(near_tie_blocks(flat[diff].float(), fmt,
                                               table=True).all()):
        fail(f"kv_sim quantizer ({fname}): blocks differ from the plain "
             "codec beyond a candidate near-tie")
    n = flat.shape[0]
    ms = timer(lambda: nq.nxfp_quantize_pack(flat, fmt, table=True))
    plain_ms = timer(lambda: nq.nxfp_quantize_pack_plain(flat, fmt, True), 5)
    route_ms = timer(lambda: fake_quant_rows(k, fname))
    n_cands = int(nq.evaluated_candidates(flat, fmt).sum())
    b_ms, b_by = bound(n * 32 * 2 + n * (fmt.bytes_per_block + 2),
                       n_cands * 32 * QUANT_OPS, PEAK_F32)
    log(f"kv_sim quantizer (K {P19_KV_SIM} bf16, {fname}, {n} blocks): "
        f"bitwise but {int(diff.sum())} near-tie blocks (the route: "
        f"{route}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the whole "
        f"route (kernel + decode) {route_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    rows[key] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        near_ties=int(diff.sum()), route_ms=route_ms,
        shape=f"K {P19_KV_SIM} bf16 (kv_sim_fmt {fname}), {n} blocks")


def check_phase19_kernels(timer, rows):
    """(d) The kernels at the shapes phase 19's paths give them, each
    against its plain version as phase 3 holds it and timed beside its
    bound and a library call."""
    check_matmul(timer, rows, P19_VISION_KN, P19_M)
    check_matmul(timer, rows, ((8192, 1024),), (P19_VISION_MEM_M,))
    check_matmul(timer, rows, P19_WHISPER_KN, P19_M + (P19_WHISPER_ENC_M,))
    check_dense_attention(timer, rows, P19_MEMORY)
    for heads, s, _ in P19_MEMORY:
        _memory_guard(heads, s)
    check_attention(timer, rows, P19_ATTENTION)
    check_kv_write(timer, rows, P19_KV)
    for key, shape in P19_CASTS.items():
        check_quantizer(timer, rows, shape, key)
    _kv_sim_row(timer, rows)


def phase_vlm_audio(card: str, rows):
    """Phase 19: (a) the smoke vision and audio models and the kv_sim
    route against the CPU; (b) Llama-3.2-Vision-90B and (c) Whisper-tiny
    at full width and depth through ServeEngine; (d) the kernels at their
    shapes. Launches are counted around each path alone. Returns (counts
    by path, figures)."""
    t0 = time.time()
    counts = {path: {} for path in P19_KERNELS}
    counts["kv_sim prefill"], fig = _p19_small()
    fig["vision"] = _p19_serve(VISION, counts)
    fig["whisper"] = _p19_serve(WHISPER, counts)
    timer = Timer("cuda")
    check_phase19_kernels(timer, rows)
    del timer
    _free()
    fig["seconds"] = round(time.time() - t0, 1)
    for arch in ("vision", "whisper"):
        f = fig[arch]
        enc = (f", encoder {f['encoder_s']} s (peak {f['encoder_peak']} "
               "bytes above the weights)" if "encoder_s" in f else "")
        log(f"  {arch} ({card}): full width and depth, built a layer at a "
            f"time in {f['seconds']} s, peak {f['peak']} bytes against packed "
            f"{f['packed']} + 2 x one layer's f32 {f['layer_f32']} = "
            f"{f['layer_bound']} (+ 2 x the largest f32 draw: {f['bound']}); "
            f"weights "
            f"{f['weights']} bytes; ServeEngine {P19_SERVE[0]} x "
            f"{P19_SERVE[1]} tokens: graph loop == host loop, rows "
            f"{list(P19_SOLOS)} alone == their batch rows, decode "
            f"{f['graph_ms_step']} ms/step ({f['tok_s']} tok/s) vs host loop "
            f"{f['host_ms_step']} ms/step, prefill {f['prefill_s']} s{enc}; "
            f"launches a decode step {f['per_step']}")
    log(f"  launches on phase 19's paths: {counts}; phase 19 "
        f"{fig['seconds']} s")
    for path, names in P19_KERNELS.items():
        for name in names:
            if counts[path].get(name, 0) <= 0:
                fail(f"phase 19 ({path}): kernel {name} was never launched")
    return counts, fig


P20_STEPS = 20                        # (b) training steps (30 until
                                      # phase 22 came)
P20_BATCH, P20_SEQ, P20_MICRO = 4, 256, 2
P20_LR = 1e-3                         # the cosine schedule's peak
P20_CKPT_EVERY = 10
P20_RESUME = 10                       # the crash comes after this checkpoint
P20_SMALL = (4, 32)                   # (a) the smoke Llama's batch
P20_HEAD_TILE = (4, 4)                # (a) B x T rows on the 16-row head tile
P20_GRAD_TOL = 2e-2                   # (a) |g_card - g_cpu| / |g_cpu|
P20_LOSS_TOL = 1e-4                   # (a) |loss_card - loss_cpu|
P20_LOGIT_TOL = 1e-5                  # (a) of max|logit|, off the head tile
P20_EVAL_TOL = 2e-3                   # (c) |loss(cast) - loss(dense_like)|
P20_CASTS = ("nxfp4", "mxfp4")
P20_SERVE = (4, 32, 16)               # (c) B, prompt tokens, new tokens
P20_GRAD_CASTS = {"nxfp_quantize grad tok_embed": (128256, 4096),
                  "nxfp_quantize grad lm_head": (4096, 128256)}
P20_MAIN_ROWS = ("nxfp_quantize grad tok_embed",
                 "nxfp_matmul M=1024 K=4096 N=14336")
P20_KERNELS = {"smoke gradient cast": ("nxfp_quantize",),
               "train": ("nxfp_quantize",),
               "direct-cast eval": ("nxfp_quantize", "nxfp_matmul"),
               "serve": ("nxfp_quantize", "nxfp_matmul", "nxfp_attention")}
# the predictions written before phase 20's first run (PERF.md §6) at
# 4 layers: the peak above what was allocated before training, and a
# step's parts
P20_PREDICTED = {"peak_gb": (38, 46), "step_ms": (200, 600), "layers": 4}


def _p20_grads(cfg, params, batch):
    """(loss, gradient leaves) of ``loss_fn`` over ``params``' leaves."""
    from repro_torch.models import loss_fn
    from repro_torch.tree import tree_leaves, tree_unflatten
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = loss_fn(cfg, tree_unflatten(params, live), batch)
    return loss.detach(), torch.autograd.grad(loss, live)


def _cast_diff(got, want, leaves, fmt):
    """Blocks where the kernel's gradient cast (``got``) and the plain
    codec's (``want``) decode to other values; fails unless each is a
    candidate near-tie. Returns their count."""
    from repro_torch.core.quantize import near_tie_blocks
    n_diff = 0
    for g, w, x in zip(got, want, leaves):
        d = g.cpu() != w
        if not d.any():
            continue
        n = x.shape[-1]
        pad = (-n) % fmt.block_size
        xb = torch.nn.functional.pad(x.cpu().float(), (0, pad)).reshape(
            *x.shape[:-1], -1, fmt.block_size)
        db = torch.nn.functional.pad(d, (0, pad)).reshape(
            *x.shape[:-1], -1, fmt.block_size).any(-1)
        if not bool(near_tie_blocks(xb[db], fmt).all()):
            fail("phase 20: the gradient cast on the kernel differs from "
                 "the plain codec beyond a candidate near-tie")
        n_diff += int(db.sum())
    return n_diff


def _p20_small(counts):
    """(a) The smoke Llama, card against CPU from the same f32 weights:
    the loss and every gradient leaf; the gradient cast on the quantizer
    kernel against the plain codec; ``forward_train``'s last row against
    ``prefill``'s logits; the forward with grad on against off."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.formats import get_format
    from repro_torch.data import SyntheticLM, make_data_iter
    from repro_torch.models import forward_train, init_params, prefill
    from repro_torch.train import compress
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device="cpu", train=True)
    batch = next(make_data_iter(SyntheticLM(vocab=cfg.vocab), *P20_SMALL))
    got = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        got[dev] = (p, b) + _p20_grads(cfg, p, b)
    (_, _, l_cpu, g_cpu), (p_gpu, b_gpu, l_gpu, g_gpu) = (got["cpu"],
                                                          got["cuda"])
    if not abs(float(l_cpu) - float(l_gpu)) <= P20_LOSS_TOL:
        fail(f"phase 20: smoke loss {float(l_gpu)} on the card against "
             f"{float(l_cpu)} on the CPU")
    worst = max(float((a.cpu() - b).norm() / b.norm().clamp(min=1e-30))
                for a, b in zip(g_gpu, g_cpu))
    if not worst <= P20_GRAD_TOL:
        fail(f"phase 20: a gradient leaf is {worst:.3g} of its norm off "
             "the CPU's")
    fmt = get_format("nxfp8")
    on_card = _counted(lambda: compress.simulate_compress(
        list(g_gpu), "nxfp8"), counts["smoke gradient cast"])
    plain = compress.simulate_compress([g.cpu() for g in g_gpu], "nxfp8")
    near = _cast_diff(on_card, plain, g_gpu, fmt)
    n_cast = sum(g.numel() >= compress._MIN_COMPRESS for g in g_gpu)
    if counts["smoke gradient cast"].get("nxfp_quantize") != n_cast:
        fail("phase 20: the smoke gradient cast did not launch the "
             "quantizer once a leaf of at least 4096 values")
    with torch.no_grad():
        off, _ = forward_train(cfg, p_gpu, b_gpu)
    live = tree_map(lambda t: t.detach().requires_grad_(), p_gpu)
    on, _ = forward_train(cfg, live, b_gpu)
    if not torch.equal(on.detach(), off):
        fail("phase 20: the forward's values with grad on are not those "
             "with grad off")
    del on, live
    heads = {}
    for what, (bb, tt) in (("head tile", P20_HEAD_TILE),
                           ("128-row tile", P20_SMALL)):
        toks = b_gpu["tokens"][:bb, :tt]
        with torch.no_grad():
            full, _ = forward_train(cfg, p_gpu, {"tokens": toks})
            last, _ = prefill(cfg, p_gpu, {"tokens": toks}, max_len=tt + 1,
                              kv_fmt=None)
        err = float((full[:, -1] - last).abs().max())
        heads[what] = err
        if what == "head tile" and err != 0.0:
            fail("phase 20: forward_train's last row is not prefill's "
                 "logits on the same head tile")
        if err > P20_LOGIT_TOL * float(last.abs().max()):
            fail(f"phase 20: forward_train's last row {err:.3g} off "
                 "prefill's logits")
    log(f"  (a) smoke Llama, card vs CPU from the same f32 weights: loss "
        f"{float(l_gpu):.6f} vs {float(l_cpu):.6f}, worst gradient leaf "
        f"{worst:.3g} of its norm (held <= {P20_GRAD_TOL}); the NxFP8 "
        f"gradient cast on the quantizer kernel ({n_cast} leaves) equal to "
        f"the plain codec but in {near} near-tie blocks; forward with grad "
        f"on == off, bitwise; forward_train's last row vs prefill's logits: "
        f"bitwise at B x T {P20_HEAD_TILE} (both heads on the 16-row "
        f"tile), {heads['128-row tile']:.3g} at {P20_SMALL} (128-row tile "
        f"against the 16-row one; held <= {P20_LOGIT_TOL} of max|logit|)")
    return dict(loss_gpu=float(l_gpu), loss_cpu=float(l_cpu),
                worst_grad=worst, near_ties=near, head_err=heads)


class _CrashAfter:
    """A data source that raises on its ``n``-th draw: a crash between two
    steps, after the checkpoint of the last one."""

    def __init__(self, source, n):
        self.source, self.left = source, n

    def sample(self, *args):
        if self.left == 0:
            raise RuntimeError("crash")
        self.left -= 1
        return self.source.sample(*args)


def _bits_sum(t) -> int:
    """The exact sum of a tensor's 32-bit patterns as int64 (chunked): a
    checksum two bitwise-equal tensors share."""
    v = t.reshape(-1).view(torch.int32)
    return sum(int(v[i:i + (1 << 26)].to(torch.int64).sum())
               for i in range(0, v.numel(), 1 << 26))


def _p20_train(cfg, counts, tmp):
    """(b) Llama-3-8B at full width and ``cfg.n_layers`` depth trained in
    f32: the uninterrupted run (its figures), then a run that crashes
    after step 10's checkpoint and one resumed from it. Returns (the
    trained weights, figures)."""
    import numpy as np
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import train_loop
    from repro_torch.train import compress
    from repro_torch.tree import tree_leaves
    t0 = time.time()
    src = SyntheticLM(vocab=cfg.vocab, seed=0)
    src_s = time.time() - t0
    kw = dict(steps=P20_STEPS, batch=P20_BATCH, seq=P20_SEQ, lr=P20_LR,
              n_micro=P20_MICRO, grad_compress="nxfp8", device="cuda",
              log_every=P20_CKPT_EVERY)
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    t0 = time.time()
    state, losses = _counted(lambda: train_loop(
        cfg, source=src, history=hist, time_parts=True, **kw),
        counts["train"])
    torch.cuda.synchronize()
    train_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    n_cast = sum(p.numel() >= compress._MIN_COMPRESS
                 for p in tree_leaves(state.params))
    if counts["train"].get("nxfp_quantize", 0) != n_cast * P20_STEPS:
        fail(f"phase 20: {counts['train'].get('nxfp_quantize')} quantizer "
             f"launches, not one a compressed leaf ({n_cast}) a step "
             f"({P20_STEPS})")
    if not all(np.isfinite(losses)) or not (
            np.mean(losses[-5:]) < losses[0]):
        fail(f"phase 20: losses {losses} are not finite or do not fall")
    # what the resumed run must reach: the weights (kept on the card) and
    # the moments' checksums; the rest of the state is dropped first
    keep = tree_leaves(state.params)
    sums = [_bits_sum(t) for t in tree_leaves((state.opt.mu, state.opt.nu))]
    del state
    _free()
    # the crash after step 10's checkpoint, then the resumed run
    t0 = time.time()
    try:
        train_loop(cfg, source=_CrashAfter(src, P20_RESUME), ckpt_dir=tmp,
                   ckpt_every=P20_CKPT_EVERY, ckpt_keep=1, **kw)
        fail("phase 20: the crashing run did not crash")
    except RuntimeError as e:
        if str(e) != "crash":
            raise
    crash_s = time.time() - t0
    _free()
    t0 = time.time()
    resumed, tail = train_loop(cfg, source=src, ckpt_dir=tmp,
                               ckpt_every=P20_CKPT_EVERY, ckpt_keep=1, **kw)
    resume_s = time.time() - t0
    if tail != losses[P20_RESUME:]:
        fail(f"phase 20: the resumed run's losses {tail} are not the "
             f"uninterrupted run's {losses[P20_RESUME:]}")
    if not all(torch.equal(a, b)
               for a, b in zip(tree_leaves(resumed.params), keep)):
        fail("phase 20: the resumed run's weights are not the "
             "uninterrupted run's")
    if [_bits_sum(t) for t in tree_leaves((resumed.opt.mu,
                                           resumed.opt.nu))] != sums:
        fail("phase 20: the resumed run's moments are not the "
             "uninterrupted run's")
    ckpt_bytes = sum(f.stat().st_size for f in tmp.rglob("*") if f.is_file())
    del keep
    parts = {k: statistics.median(h["ms"][k] for h in hist[1:])
             for k in ("fwd_bwd", "cast", "opt")}
    fig = dict(params=n_params, peak=peak, losses=losses,
               step_ms=statistics.median(h["step_ms"] for h in hist[1:]),
               first_step_ms=hist[0]["step_ms"], parts_ms=parts,
               data_ms=statistics.median(h["data_ms"] for h in hist),
               source_s=src_s, train_s=train_s, crash_s=crash_s,
               resume_s=resume_s, ckpt_bytes=ckpt_bytes, compressed=n_cast)
    fig["tok_s"] = P20_BATCH * P20_SEQ * 1e3 / fig["step_ms"]
    return resumed.params, fig


def _p20_cast_eval_serve(cfg, params, counts):
    """(c) The trained weights direct-cast (nxfp4, mxfp4) with
    ``load_params``: ``loss_fn`` over each cast tree (the dequant GEMM at
    M 1024) against its ``dense_like`` and against the f32 weights; then
    ``ServeEngine`` on the nxfp4 tree, the graph loop against the host
    loop."""
    import numpy as np
    from repro_torch.core.qtensor import QuantPolicy, dense_like
    from repro_torch.data import SyntheticLM, make_data_iter
    from repro_torch.models import loss_fn
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.engine import load_params
    held = next(make_data_iter(SyntheticLM(vocab=cfg.vocab, seed=0),
                               P20_BATCH, P20_SEQ, seed=1))
    held = {"tokens": torch.as_tensor(held["tokens"]).to("cuda")}
    with torch.no_grad():
        f32 = float(loss_fn(cfg, params, held)[0])
    fig = {"f32": f32}
    cast = {}
    for fmt in P20_CASTS:
        cast[fmt] = _counted(lambda: load_params(
            params, QuantPolicy(fmt, None), torch.device("cuda")),
            counts["direct-cast eval"])
        with torch.no_grad():
            lq = float(_counted(lambda: loss_fn(cfg, cast[fmt], held)[0],
                                counts["direct-cast eval"]))
            ld = float(loss_fn(cfg, dense_like(cast[fmt]), held)[0])
        if not abs(lq - ld) <= P20_EVAL_TOL:
            fail(f"phase 20: {fmt} eval loss {lq} through the dequant GEMM "
                 f"against {ld} over its dense_like")
        fig[fmt] = dict(loss=lq, dense_like=ld, delta=lq - f32)
    del cast["mxfp4"]
    b, t, n_new = P20_SERVE
    eng = ServeEngine(cfg, cast["nxfp4"], QuantPolicy("nxfp4", "nxfp4"),
                      max_len=t + n_new, device="cuda")
    prompts = {"tokens": np.random.default_rng(20).integers(
        0, cfg.vocab, (b, t)).astype(np.int32)}
    graph = _counted(lambda: eng.generate(prompts, max_new=n_new,
                                          loop="device", chunk=n_new),
                     counts["serve"])
    host = _counted(lambda: eng.generate(prompts, max_new=n_new,
                                         loop="host"), counts["serve"])
    if not np.array_equal(graph.tokens, host.tokens):
        fail("phase 20: the trained model's graph loop and host loop "
             "disagree")
    del eng, cast
    _free()
    return fig


def _grad_cast_row(timer, rows, key, shape):
    """The quantizer at a gradient cast's shape: (R, C) f32 -> NxFP8
    blocks along C, against its plain version (run a chunk of rows at a
    time), bitwise up to counted candidate near-ties; timed beside its
    bound (no library call casts to a block format)."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.pack import unpack_codes
    from repro_torch.core.quantize import near_tie_blocks
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.decode_lib import decode_block_values
    fmt = get_format("nxfp8")
    gen = torch.Generator(device="cuda").manual_seed(20)
    flat = (torch.randn(shape, generator=gen, device="cuda") * 1e-4).reshape(
        -1, fmt.block_size)
    step = 1 << 20

    def plain():
        out = [nq.nxfp_quantize_pack_plain(flat[i:i + step], fmt)
               for i in range(0, flat.shape[0], step)]
        return (torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]))

    kp, km = nq.nxfp_quantize_pack(flat, fmt)
    pp, pm = plain()
    diff = (kp != pp).any(-1) | (km.to(torch.int32) != pm.to(torch.int32))
    n_diff = int(diff.sum())
    if n_diff and not bool(near_tie_blocks(flat[diff], fmt).all()):
        fail(f"{key}: blocks differ from the plain codec beyond a near-tie")
    err = 0.0
    if n_diff:
        def deq(p, m):
            return decode_block_values(unpack_codes(p, fmt.bits, 32), m, fmt)
        err = float((deq(kp[diff], km[diff])
                     - deq(pp[diff], pm[diff])).abs().max())
    del pp, pm
    t = flat.shape[0]
    n_cands, regime = _quantizer_traits(nq, flat, fmt)
    ms = timer(lambda: nq.nxfp_quantize_pack(flat, fmt))
    plain_ms = timer(plain, 3)
    b_ms, b_by = bound(t * 32 * 4 + t * (fmt.bytes_per_block + 2),
                       n_cands * 32 * QUANT_OPS, PEAK_F32)
    log(f"{key} ({shape[0]}x{shape[1]} f32 gradient, {t} blocks, {regime} "
        f"regime): bitwise but {n_diff} near-tie blocks; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows[key] = dict(max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, near_ties=n_diff,
                     shape=f"{tuple(shape)} f32 gradient, {t} blocks of 32, "
                           "nxfp8 along the last axis")


def check_phase20_kernels(timer, rows):
    """(e) The quantizer at the gradient casts' widest shapes and the
    dequant GEMM at the direct-cast evaluation's M (B x T = 1024) for
    Llama-3-8B's four (K, N) pairs."""
    for key, shape in P20_GRAD_CASTS.items():
        _grad_cast_row(timer, rows, key, shape)
    check_matmul(timer, rows, MATMUL_KN, (P20_BATCH * P20_SEQ,))


def phase_train(card: str, train_layers: int, rows):
    """Phase 20: training (A15). (a) the smoke Llama card against CPU;
    (b) Llama-3-8B at full width trained in f32 through ``train_loop``,
    crash and resume; (c) the trained weights direct-cast, evaluated and
    served; (d) the launch counts; (e) the kernel rows. Returns (counts by
    path, figures)."""
    import dataclasses
    import tempfile
    from pathlib import Path
    from repro_torch.configs import get_config
    t0 = time.time()
    counts = {path: {} for path in P20_KERNELS}
    fig = {"small": _p20_small(counts)}
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=train_layers)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        params, fig["train"] = _p20_train(cfg, counts, Path(tmp))
    fig["eval"] = _p20_cast_eval_serve(cfg, params, counts)
    # phase 22 reads Table 1's W4 row off these weights
    fig["trained"] = (cfg, params)
    del params
    _free()
    timer = Timer("cuda")
    check_phase20_kernels(timer, rows)
    del timer
    _free()
    fig["seconds"] = round(time.time() - t0, 1)
    tr, ev = fig["train"], fig["eval"]
    lo, hi = P20_PREDICTED["peak_gb"]
    log(f"  (b) Llama-3-8B full width, {train_layers} layers, "
        f"{tr['params']} parameters in f32 ({card}): {P20_STEPS} steps of "
        f"B {P20_BATCH} x T {P20_SEQ}, {P20_MICRO} microbatches, remat, "
        f"AdamW (cosine, peak {P20_LR}), NxFP8 gradient cast on "
        f"{tr['compressed']} leaves a step; losses "
        f"{[round(x, 4) for x in tr['losses']]}; a step "
        f"{tr['step_ms']:.1f} ms median (first {tr['first_step_ms']:.1f}), "
        f"of it forward+backward {tr['parts_ms']['fwd_bwd']:.1f} ms, cast "
        f"{tr['parts_ms']['cast']:.1f} ms, optimizer "
        f"{tr['parts_ms']['opt']:.1f} ms (CUDA events, medians); "
        f"{tr['tok_s']:.1f} tok/s; data draw {tr['data_ms']:.2f} ms a batch "
        f"(source built in {tr['source_s']:.2f} s); peak "
        f"{tr['peak']} bytes above the weights' start ({tr['peak'] / 1e9:.2f}"
        f" GB, predicted {lo}-{hi} GB at {P20_PREDICTED['layers']} layers); "
        f"run {tr['train_s']:.1f} s; crash "
        f"run (a checkpoint every {P20_CKPT_EVERY} steps, the crash after "
        f"step {P20_RESUME}'s) "
        f"{tr['crash_s']:.1f} s, resumed run {tr['resume_s']:.1f} s, "
        f"checkpoint {tr['ckpt_bytes']} bytes; resumed == uninterrupted "
        f"(losses, weights bitwise; moments by their bits' sums)")
    log(f"  (c) direct-cast eval ({card}), held-out batch: f32 loss "
        f"{ev['f32']:.5f}; " + "; ".join(
            f"{f} {ev[f]['loss']:.5f} (dense_like {ev[f]['dense_like']:.5f},"
            f" delta vs f32 {ev[f]['delta']:+.5f})" for f in P20_CASTS)
        + f"; ServeEngine on the nxfp4 tree {P20_SERVE[0]} x {P20_SERVE[1]}"
        f" + {P20_SERVE[2]} new: graph loop == host loop")
    log(f"  launches on phase 20's paths: {counts}; phase 20 "
        f"{fig['seconds']} s")
    for path, names in P20_KERNELS.items():
        for name in names:
            if counts[path].get(name, 0) <= 0:
                fail(f"phase 20 ({path}): kernel {name} was never launched")
    return counts, fig


# ---------------------------------------------------------------------------
# phase 21: slot-sharded serving (A3), two shards on the one card
# ---------------------------------------------------------------------------

P21_SLOTS = 8                      # 4 a shard at 2 shards, 2 at 4
P21_SHARDS = (2, 4)
P21_PROMPTS = (32, 64, 96, 128) * 3    # 12 requests: more than the slots
P21_NEW = (8, 16, 24, 32, 40, 48, 56, 64, 24, 16, 40, 32)
P21_SAMPLED = {2: (0.8, 17), 9: (1.3, 23)}     # uid: (temperature, seed)
P21_ROUNDS = 1                     # (unsharded, sharded, sharded, unsharded)
P21_DRAIN = ((64, 48), (96, 56), (64, 40), (128, 48), (64, 32), (96, 24))
P21_VICTIM = 1
P21_SPEC_K = 4
P21_SPEC_REQS = 8                  # the speculative serves take the first 8
P21_KERNELS = ("nxfp_quantize", "nxfp_matmul", "nxfp_attention")


def _p21_requests(cfg, prompts=P21_PROMPTS, news=P21_NEW, sampled=None,
                  spread=0.05):
    """Requests from seed 21: the first four at once, the rest ``spread``
    s apart after them."""
    import numpy as np
    from repro_torch.serving import Request
    sampled = P21_SAMPLED if sampled is None else sampled
    rng = np.random.default_rng(21)
    return [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, temperature=sampled.get(i, (0.0, 0))[0],
                    seed=sampled.get(i, (0.0, 0))[1],
                    arrival_time=0.0 if i < 4 else spread * (i - 3))
            for i, (t, m) in enumerate(zip(prompts, news))]


def _p21_same(got, want, what):
    """Every stream and status of ``got`` equal to ``want``'s."""
    import numpy as np
    g = {r.uid: r for r in got}
    w = {r.uid: r for r in want}
    if g.keys() != w.keys():
        fail(f"phase 21 ({what}): results for {sorted(g)}, expected "
             f"{sorted(w)}")
    for uid, r in w.items():
        if g[uid].status != r.status or not np.array_equal(g[uid].tokens,
                                                           r.tokens):
            fail(f"phase 21 ({what}): uid {uid} {g[uid].status} "
                 f"{g[uid].tokens[:8].tolist()} ... against the unsharded "
                 f"{r.status} {r.tokens[:8].tolist()} ...")


def _p21_serve(eng, reqs, **kw):
    """(results, figures) of one serve: tok/s and seconds (host clock, the
    card synchronised), ms a decode chunk (median of the host-clock
    ``chunk_times``, the fold's host copy included) and its live slots."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.serve(reqs, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    times = [t for _, t in eng.chunk_times]
    return res, dict(
        seconds=round(wall, 4),
        tok_s=round(sum(r.n_generated for r in res) / wall, 2),
        chunks=eng.chunks, lane_chunks=eng.lane_chunks,
        chunk_ms=round(1e3 * statistics.median(times), 3),
        live=statistics.median(n for n, _ in eng.chunk_times))


def _p21_oracle(cfg, params, counts, fig):
    """(a): 2 and 4 shards against the unsharded engine, the timed turns
    and one shard's chunk counted eagerly."""
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import ContinuousEngine, ShardedContinuousEngine
    policy = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=P21_SLOTS, chunk=CONT_CHUNK, max_len=CONT_MAX_LEN,
              prefill_mode="chunked", p_chunk=LANE_P)
    plain = ContinuousEngine(cfg, params, policy, device="cuda", **kw)
    want, _ = _p21_serve(plain, _p21_requests(cfg))
    engines = {}
    for n in P21_SHARDS:
        eng = ShardedContinuousEngine(cfg, params, policy, make_serving_mesh(
            n, ["cuda:0"] * n), **kw)
        got, first = _counted(lambda: _p21_serve(eng, _p21_requests(cfg)),
                              counts.setdefault(f"oracle S{n}", {}))
        _p21_same(got, want, f"{n} shards")
        fig[f"S{n} first"] = first
        engines[n] = eng
    runs = {"unsharded": [], "sharded": []}
    for _ in range(P21_ROUNDS):
        for name in ("unsharded", "sharded", "sharded", "unsharded"):
            eng = plain if name == "unsharded" else engines[2]
            got, f = _p21_serve(eng, _p21_requests(cfg))
            _p21_same(got, want, f"turn, {name}")
            runs[name].append(f)
    fig["turns"] = runs
    for name, rs in runs.items():
        fig[f"{name} tok_s"] = statistics.median(r["tok_s"] for r in rs)
        fig[f"{name} chunk_ms"] = statistics.median(r["chunk_ms"]
                                                    for r in rs)
    fig["chunk_ratio"] = round(fig["sharded chunk_ms"]
                               / fig["unsharded chunk_ms"], 3)
    import numpy as np
    per_chunk = {}
    shard = engines[2].shards[0]
    shard._upload(dict(shard._host, poison=np.zeros(
        (shard.n_slots,), bool)))     # every slot parked: nothing written
    _counted(lambda: shard._chunk_fn(True)(), per_chunk)
    torch.cuda.synchronize()
    fig["launches_a_shard_chunk"] = per_chunk
    fig["graphs"] = {n: [len(sh._graphs) + len(sh._lane_graphs)
                         for sh in eng.shards] for n, eng in engines.items()}


def _p21_drain(cfg, params, counts, fig):
    """(b): a shard_down fault at chunk 1 against the no-drain serve."""
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import (ContinuousEngine, Fault, FaultPlan,
                                     ShardedContinuousEngine)
    policy = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=P21_SLOTS, chunk=CONT_CHUNK, max_len=CONT_MAX_LEN)
    prompts, news = zip(*P21_DRAIN)

    def reqs():
        return _p21_requests(cfg, prompts, news, sampled={1: (0.8, 5)},
                             spread=0.02)

    want = ContinuousEngine(cfg, params, policy, device="cuda",
                            **kw).serve(reqs())
    eng = ShardedContinuousEngine(cfg, params, policy, make_serving_mesh(
        2, ["cuda:0"] * 2), **kw)
    plan = FaultPlan([Fault(kind="shard_down", chunk=1, shard=P21_VICTIM)])
    got, evs = _counted(lambda: _p16_events(lambda: eng.serve(
        reqs(), fault_plan=plan)), counts.setdefault("drain", {}))
    _p21_same(got, want, "drain")
    kinds = [e["event"] for e in evs]
    if "drain" not in kinds or "migrate" not in kinds:
        fail(f"phase 21 (drain): events {sorted(set(kinds))} lack drain or "
             "migrate")
    d = kinds.index("drain")
    late = [e for e in evs[d + 1:] if e["event"] in (
        "admit", "prefill-start", "resume", "migrate")
        and e.get("shard") == P21_VICTIM]
    if late:
        fail(f"phase 21 (drain): shard {P21_VICTIM} took {late} after its "
             "drain")
    try:
        eng.drain_shard(1 - P21_VICTIM)
    except ValueError as exc:
        refused = str(exc)
    else:
        fail("phase 21 (drain): draining the last healthy shard was not "
             "refused")
    fig["drain"] = dict(
        live=evs[d]["live"], migrations=[(e["uid"], e["slot"], e["n_gen"])
                                         for e in evs if e["event"] ==
                                         "migrate"],
        suspended=kinds.count("suspend"), resumed=kinds.count("resume"),
        migrate_ms=[round(1e3 * t, 3) for t in eng.migrate_seconds],
        refused=refused)


def _p21_paged(cfg, params, counts, fig):
    """(c): the sharded paged engine against the unsharded paged one."""
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import (PagedContinuousEngine,
                                     ShardedPagedContinuousEngine)
    policy = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=P21_SLOTS, chunk=CONT_CHUNK, max_len=CONT_MAX_LEN,
              prefill_mode="chunked", p_chunk=LANE_P)
    want = PagedContinuousEngine(cfg, params, policy, device="cuda",
                                 prefix_sharing=False, **kw).serve(
        _p21_requests(cfg))
    eng = ShardedPagedContinuousEngine(cfg, params, policy, make_serving_mesh(
        2, ["cuda:0"] * 2), **kw)
    got, f = _counted(lambda: _p21_serve(eng, _p21_requests(cfg)),
                      counts.setdefault("paged", {}))
    _p21_same(got, want, "paged")
    for pool in eng.pools:
        if pool.used:
            fail(f"phase 21 (paged): {pool.used} pages still held")
    fig["paged"] = dict(f, pools=[{k: st[k] for k in (
        "shard", "n_pages", "high_watermark")} for st in eng.pool_stats()])


def _p21_speculative(cfg, params, counts, fig):
    """(d): the sharded speculative engine against the unsharded one."""
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import (ContinuousEngine,
                                     ShardedContinuousEngine,
                                     SpeculativeConfig)
    policy = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=P21_SLOTS, chunk=CONT_CHUNK, max_len=CONT_MAX_LEN,
              prefill_mode="chunked", p_chunk=LANE_P,
              speculative=SpeculativeConfig(k=P21_SPEC_K))
    plain = ContinuousEngine(cfg, params, policy, device="cuda", **kw)
    want = plain.serve(_p21_requests(cfg)[:P21_SPEC_REQS])
    eng = ShardedContinuousEngine(cfg, params, policy, make_serving_mesh(
        2, ["cuda:0"] * 2), **kw)
    got, f = _counted(lambda: _p21_serve(
        eng, _p21_requests(cfg)[:P21_SPEC_REQS]),
        counts.setdefault("speculative", {}))
    _p21_same(got, want, "speculative")
    per = eng.spec_shard_stats()
    if sum(d["accepted"] for d in per) != eng.spec_stats()["accepted"]:
        fail(f"phase 21 (speculative): per-shard stats {per} do not sum to "
             f"{eng.spec_stats()}")
    fig["speculative"] = dict(f, spec_shard_stats=per,
                              unsharded=plain.spec_stats())


def phase_sharded(card: str, serving_layers: int):
    """Phase 21: slot-sharded serving on the one card (the module
    docstring's item 21). Returns (launch counts by path, figures)."""
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("llama3_8b"),
                              n_layers=serving_layers)
    params = init_params(cfg, seed=0, device="cuda",
                         policy=QuantPolicy("nxfp4", None))
    counts, fig = {}, {}
    steps = (("oracle", _p21_oracle), ("drain", _p21_drain),
             ("paged", _p21_paged), ("speculative", _p21_speculative))
    for name, step in steps:
        t1 = time.time()
        step(cfg, params, counts, fig)
        fig[f"{name}_s"] = round(time.time() - t1, 1)
        gc.collect()
        torch.cuda.empty_cache()
    fig["peak"] = torch.cuda.max_memory_allocated()
    fig["seconds"] = round(time.time() - t0, 1)
    where = {f"S{n}": f"cuda:0 {n} times (one card)" for n in P21_SHARDS}
    log(f"sharded serving ({card}): Llama-3-8B full width, {serving_layers} "
        f"layers, nxfp4 weights and KV, {P21_SLOTS} slots, chunk "
        f"{CONT_CHUNK}, max_len {CONT_MAX_LEN}, lane P {LANE_P}; shards on "
        f"{where}; {len(P21_PROMPTS)} staggered requests (two sampled): "
        f"every stream and status equal to the unsharded engine's at 2 and "
        f"4 shards; {fig['oracle_s']} s")
    log(f"  first serves ({card}; captures included): S2 {fig['S2 first']}; "
        f"S4 {fig['S4 first']}; graphs a shard {fig['graphs']}")
    log(f"  turns ({card}; second serves, {P21_ROUNDS} rounds of "
        f"(unsharded, sharded, sharded, unsharded), host clock): tok/s "
        f"unsharded {fig['unsharded tok_s']} vs 2 shards "
        f"{fig['sharded tok_s']}; ms a decode chunk {fig['unsharded chunk_ms']}"
        f" vs {fig['sharded chunk_ms']} (ratio {fig['chunk_ratio']}); "
        f"every serve {fig['turns']}")
    log(f"  one shard's decode chunk, counted eagerly (a chunk replays one "
        f"such graph a shard, in shard order): {fig['launches_a_shard_chunk']}")
    log(f"  drain ({card}): shard {P21_VICTIM} down at chunk 1, every stream "
        f"OK and bitwise the no-drain unsharded serve's, nothing admitted to "
        f"shard {P21_VICTIM} after the drain; {fig['drain']}; "
        f"{fig['drain_s']} s")
    log(f"  paged ({card}): every stream bitwise the unsharded paged "
        f"engine's, every pool empty after; {fig['paged']}; "
        f"{fig['paged_s']} s")
    log(f"  speculative ({card}): k {P21_SPEC_K}, recycled draft, every "
        f"stream bitwise the unsharded speculative engine's; "
        f"{fig['speculative']}; {fig['speculative_s']} s")
    log(f"  launches on phase 21's paths (each sharded serve alone, first "
        f"serves): {counts}; peak {fig['peak']} bytes ({card}); phase 21 "
        f"{fig['seconds']} s")
    for path, n in counts.items():
        for name in P21_KERNELS:
            if n.get(name, 0) <= 0:
                fail(f"phase 21 ({path}): kernel {name} was never launched")
    return counts, fig


# ---------------------------------------------------------------------------
# phase 22: the paper's figures (A2) on the card
# ---------------------------------------------------------------------------

P22_W1 = (4096, 14336)             # (a) Llama-3-8B's w1, cast along K
P22_ROW_STRIDE = 64                # (a) the plain version's rows of it
P22_KV_FMTS = ("mxfp4", "bfp4")    # (a) the kv_sim route at P19_KV_SIM
# (a) the casts whose rows join the kernel table: the table instance
# without CR (mxfp4), with it (nxfp4), at block size 128 (bfp4_bs128)
P22_TABLE_ROWS = ("mxfp4", "nxfp4", "bfp4_bs128")
P22_MAIN_ROWS = ("nxfp_quantize table mxfp4 w1",)
P22_KERNELS = {"figures": ("nxfp_quantize",),
               "examples": ("nxfp_quantize", "nxfp_matmul",
                            "nxfp_attention"),
               "full-width W4": ("nxfp_quantize",)}
# the predictions written before phase 22's first run (PERF.md §6, PR 33)
P22_PREDICTED = {"seconds": (45, 75), "train_s": (15, 35),
                 "table_vs_serving": (0.9, 1.3)}


def _p22_formats():
    """Every format the figures cast: Table 1's 16, Fig. 12's block sizes,
    Fig. 10's 3-bit ones, then Fig. 11's recycle points."""
    from repro_torch.core.formats import get_format
    from repro_torch.figures import fig10_accuracy as f10
    from repro_torch.figures import fig11_remap_sweep as f11
    from repro_torch.figures import fig12_blocksize as f12
    from repro_torch.figures import table1_perplexity as t1
    names = [f for row in t1.ROWS.values() for f in row]
    names += [f12.fmt_name(fam, bs) for bs in f12.BS for fam in f12.FAMILIES]
    names += f10.FMTS
    return ([get_format(n) for n in dict.fromkeys(names)]
            + [f11._fmt_with_recycle(base, float(v))
               for base, elem in f11.BASES for v in f11.sweep_points(elem)])


def _p22_table_cast(timer, w, fmt, rows, serving_ms=None):
    """(a) ``w`` (K, N) f32 cast along K by the quantizer under the
    table-driven rules (``table=True``), held against the plain
    ``quantize_blocks`` on every ``P22_ROW_STRIDE``-th row of the blocked
    weight (its N axis), bitwise but counted candidate near-ties, and
    timed beside its bound. Formats in ``P22_TABLE_ROWS`` also time the
    plain version on those rows and join the kernel table. Returns (ms,
    bound ms, what bounds it, near ties, blocks compared)."""
    from repro_torch.core.pack import unpack_codes
    from repro_torch.core.quantize import (meta_int32, near_tie_blocks,
                                           to_blocks)
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.decode_lib import decode_block_values
    bs = fmt.block_size
    xb, _ = to_blocks(w, bs, -2)                      # (N, K / bs, bs)
    flat = xb.reshape(-1, bs)
    kp, km = nq.nxfp_quantize_pack(flat, fmt, table=True)
    sample = xb[::P22_ROW_STRIDE].reshape(-1, bs).contiguous()
    pp, pm = nq.nxfp_quantize_pack_plain(sample, fmt, table=True)
    ks = kp.reshape(*xb.shape[:2], -1)[::P22_ROW_STRIDE].reshape(
        -1, kp.shape[-1])
    kms = km.reshape(xb.shape[:2])[::P22_ROW_STRIDE].reshape(-1)
    diff = (ks != pp).any(-1) | (meta_int32(kms) != meta_int32(pm))
    n_diff = int(diff.sum())
    if n_diff and not bool(near_tie_blocks(sample[diff], fmt,
                                           table=True).all()):
        fail(f"phase 22: the table cast of {fmt.name} differs from the "
             "plain quantize_blocks beyond a candidate near-tie")
    t = flat.shape[0]
    ms = timer(lambda: nq.nxfp_quantize_pack(flat, fmt, table=True))
    n_cands = int(nq.evaluated_candidates(flat, fmt).sum())
    b_ms, b_by = bound(t * bs * 4 + t * (fmt.bytes_per_block + 2),
                       n_cands * bs * QUANT_OPS, PEAK_F32)
    if fmt.name in P22_TABLE_ROWS:
        def deq(p, m):
            return decode_block_values(unpack_codes(p, fmt.bits, bs), m, fmt)
        err = 0.0 if not n_diff else float(
            (deq(ks[diff], kms[diff]) - deq(pp[diff], pm[diff])).abs().max())
        plain_ms = timer(lambda: nq.nxfp_quantize_pack_plain(
            sample, fmt, True), 3)
        rows[f"nxfp_quantize table {fmt.name} w1"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, near_ties=n_diff,
            serving_ms=serving_ms, candidates_per_block=n_cands / t,
            shape=f"{P22_W1} f32 weight along K, {t} blocks of {bs}, "
                  f"{fmt.name} under the table-driven rules "
                  f"(KIND_{'CRT' if fmt.cr else 'TAB'}); plain_ms on "
                  f"every {P22_ROW_STRIDE}th row ({sample.shape[0]} "
                  "blocks)")
    return ms, b_ms, b_by, n_diff, sample.shape[0]


def check_phase22_kernels(timer, rows):
    """(a) The quantizer's table instances at full width: Llama-3-8B's w1
    (4096 x 14336 f32, seeded) under every format the figures cast, each
    against the plain version on a fixed sample of rows; the nxfp4 table
    instance against the serving (arithmetic) instance on the same
    weight; then the kv_sim route at a prefill's K under mxfp4 and
    bfp4."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.quantize import to_blocks
    from repro_torch.kernels import nxfp_quantize as nq
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(22)
    w = torch.randn(P22_W1, generator=gen, device="cuda") * 0.02
    nx4 = get_format("nxfp4")
    flat = to_blocks(w, 32, -2)[0].reshape(-1, 32)
    serving_ms = timer(lambda: nq.nxfp_quantize_pack(flat, nx4))
    del flat
    casts, ties, n_blocks = {}, 0, 0
    for fmt in _p22_formats():
        ms, b_ms, b_by, n_diff, n = _p22_table_cast(
            timer, w, fmt, rows, serving_ms if fmt.name == "nxfp4" else None)
        casts[fmt.name] = (round(ms, 4), round(b_ms, 4), b_by[0])
        ties += n_diff
        n_blocks += n
    del w
    for fname in P22_KV_FMTS:
        _kv_sim_row(timer, rows, fname, f"nxfp_quantize kv_sim {fname}")
    ratio = casts["nxfp4"][0] / serving_ms
    log(f"  (a) table instances ({len(casts)} formats, w1 {P22_W1} f32 "
        f"along K, plain on every {P22_ROW_STRIDE}th row: {n_blocks} "
        f"blocks compared, bitwise but {ties} near-tie blocks): nxfp4 "
        f"table {casts['nxfp4'][0]} ms against the serving instance "
        f"{serving_ms:.4f} ms (ratio {ratio:.3f}, predicted "
        f"{P22_PREDICTED['table_vs_serving']}); (ms, bound ms, bound by) "
        f"by format {casts}; {time.time() - t0:.1f} s")
    return dict(casts=casts, near_ties=ties, serving_ms=serving_ms,
                ratio=ratio)


class _CastCheck:
    """While active, every quantizer call of ``kernels.ops`` (the casts
    and ``fake_quant_rows``) is followed by the plain version on the same
    blocks under the same rules, codes and meta compared (bitwise but
    counted candidate near-ties, else the phase fails). The plain version
    launches no kernel, so the launch counts read only the path's."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.real = ops, ops.nxfp_quantize_pack
        self.calls = self.blocks = self.near_ties = 0

    def __call__(self, xb, fmt, plan=None, table=False):
        from repro_torch.core.quantize import meta_int32, near_tie_blocks
        from repro_torch.kernels import nxfp_quantize as nq
        kp, km = self.real(xb, fmt, plan, table)
        pp, pm = nq.nxfp_quantize_pack_plain(xb, fmt, table)
        diff = (kp != pp).any(-1) | (meta_int32(km) != meta_int32(pm))
        n = int(diff.sum())
        if n and not bool(near_tie_blocks(xb[diff].float(), fmt,
                                          table=table).all()):
            fail(f"phase 22: a figure's cast ({fmt.name}, {xb.shape[0]} "
                 "blocks) differs from the plain version beyond a "
                 "candidate near-tie")
        self.calls += 1
        self.blocks += xb.shape[0]
        self.near_ties += n
        return kp, km

    def __enter__(self):
        self.ops.nxfp_quantize_pack = self
        return self

    def __exit__(self, *exc):
        self.ops.nxfp_quantize_pack = self.real


def _p22_figures(counts):
    """(b) ``trained_model`` (600 steps of 24 x 128 into a temporary
    directory), then Table 1 and Figs. 3 and 8-12 on it, every cast held
    against the plain version (``_CastCheck``). Returns (figures, the
    orderings' verdicts by figure, the CSV rows)."""
    import tempfile
    from pathlib import Path
    from repro_torch.figures import (common, fig3_profile, fig8_quant_error,
                                     fig9_tradeoff, fig10_accuracy,
                                     fig11_remap_sweep, fig12_blocksize,
                                     table1_perplexity)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        model = common.trained_model(device="cuda", cache=Path(tmp))
    torch.cuda.synchronize()
    fig = {"train_s": round(time.time() - t0, 1), "seconds": {}}
    csv, verdicts = common.Csv(), {}
    with _CastCheck() as chk:
        for mod in (table1_perplexity, fig3_profile, fig8_quant_error,
                    fig9_tradeoff, fig10_accuracy, fig11_remap_sweep,
                    fig12_blocksize):
            name = mod.__name__.rsplit(".", 1)[-1]
            t0 = time.time()
            r = _counted(lambda: mod.compute(csv, model=model,
                                             device="cuda"),
                         counts["figures"])
            torch.cuda.synchronize()
            fig["seconds"][name] = round(time.time() - t0, 1)
            verdicts[name] = mod.orderings(r)
            if name == "table1_perplexity":
                fig["base_ppl"] = r["base"]
    if not fig["base_ppl"] < common.BENCH_CFG.vocab / 2:
        fail(f"phase 22: the trained bench model's ppl {fig['base_ppl']} "
             "shows no training")
    fig.update(casts=chk.calls, cast_blocks=chk.blocks,
               cast_near_ties=chk.near_ties)
    return fig, verdicts, csv.rows


def _p22_examples(counts):
    """(c) Both example twins run to completion on the card (the
    train-then-serve one's checkpoints in a temporary directory)."""
    import importlib.util
    import tempfile

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        tts = _counted(lambda: load("train_then_serve_quantized_torch").main(
            "cuda", ckpt_dir=tmp), counts["examples"])
    t1 = time.time()
    lc = _counted(lambda: load("longcontext_ssm_serving_torch").main("cuda"),
                  counts["examples"])
    import numpy as np
    if not np.isfinite(tts["base_ppl"]) or tts["tokens"].shape != (8, 32):
        fail("phase 22: the train-then-serve example's results are off")
    return dict(train_then_serve_s=round(t1 - t0, 1),
                longcontext_s=round(time.time() - t1, 1),
                state_bytes={a: v["state_bytes"] for a, v in lc.items()})


def _p22_full_width(trained, counts):
    """(d) Table 1's W4 row through the table cast on phase 20's trained
    full-width Llama-3-8B: the ppl of the held-out batch (phase 20's)
    over each cast's ``dense_like`` and over the f32 weights. Printed,
    not held: 30 steps from random weights cannot show the ordering."""
    import math
    from repro_torch.core.qtensor import dense_like
    from repro_torch.data import SyntheticLM, make_data_iter
    from repro_torch.figures import common
    from repro_torch.figures.table1_perplexity import ROWS
    from repro_torch.models import loss_fn
    cfg, params = trained
    held = next(make_data_iter(SyntheticLM(vocab=cfg.vocab, seed=0),
                               P20_BATCH, P20_SEQ, seed=1))
    held = {"tokens": torch.as_tensor(held["tokens"]).to("cuda")}
    t0 = time.time()
    with torch.no_grad():
        out = {"f32": math.exp(float(loss_fn(cfg, params, held)[0]))}
        for fmt in ROWS[4]:
            qp = _counted(lambda: common.cast_tree(params, fmt),
                          counts["full-width W4"])
            out[fmt] = math.exp(float(loss_fn(cfg, dense_like(qp), held)[0]))
            del qp
    _free()
    return dict(ppl=out, seconds=round(time.time() - t0, 1))


def phase_figures(card: str, rows, trained=None):
    """Phase 22: the paper's figures (A2). (a) the quantizer's table
    instances at full width and the kv_sim route; (b) the figure suite
    on a bench model trained on the card; (c) both example twins; (d)
    Table 1's W4 row on phase 20's trained Llama-3-8B (skipped when
    ``trained`` is None). Launches are counted around (b), (c) and (d)
    alone. Returns (counts by path, figures)."""
    t_phase = time.time()
    counts = {path: {} for path in P22_KERNELS}
    timer = Timer("cuda")
    fig = {"kernels": check_phase22_kernels(timer, rows)}
    del timer
    _free()
    fig["figures"], verdicts, csv_rows = _p22_figures(counts)
    _free()
    fig["examples"] = _p22_examples(counts)
    _free()
    if trained is not None:
        fig["full_width"] = _p22_full_width(trained, counts)
    fig["seconds"] = round(time.time() - t_phase, 1)
    f = fig["figures"]
    log(f"  (b) figure suite ({card}; PYTHONHASHSEED "
        f"{os.environ.get('PYTHONHASHSEED', 'unset')}): trained_model 600 "
        f"steps of 24 x 128 in {f['train_s']} s (predicted "
        f"{P22_PREDICTED['train_s']}), fp32 ppl {f['base_ppl']:.4f}; "
        f"{f['casts']} casts ({f['cast_blocks']} blocks) on the quantizer's "
        f"table instances, each equal to the plain version but in "
        f"{f['cast_near_ties']} near-tie blocks; seconds by figure "
        f"{f['seconds']}")
    for name, rule in verdicts.items():
        for what, ok in rule:
            log(f"  ordering {name}: {what}: {'holds' if ok else 'FAILS'}")
    log("  CSV rows: " + json.dumps([r[:3] for r in csv_rows]))
    e = fig["examples"]
    log(f"  (c) examples ({card}): train_then_serve_quantized_torch "
        f"{e['train_then_serve_s']} s, longcontext_ssm_serving_torch "
        f"{e['longcontext_s']} s (state bytes {e['state_bytes']})")
    if "full_width" in fig:
        fw = fig["full_width"]
        log(f"  (d) Table 1's W4 row on phase 20's trained Llama-3-8B "
            f"({card}; held-out B {P20_BATCH} x T {P20_SEQ}, table cast, "
            f"dense_like): ppl {json.dumps(fw['ppl'])}; {fw['seconds']} s "
            "(printed, not held)")
    lo, hi = P22_PREDICTED["seconds"]
    log(f"  launches on phase 22's paths: {counts}; phase 22 "
        f"{fig['seconds']} s (predicted {lo}-{hi})")
    for path, names in P22_KERNELS.items():
        if path == "full-width W4" and trained is None:
            continue
        for name in names:
            if counts[path].get(name, 0) <= 0:
                fail(f"phase 22 ({path}): kernel {name} was never launched")
    return counts, fig


def kernel_formats(kname, rows, wide_counts):
    """The formats ``kname`` ran in this run: its main-path formats, its
    phase-3 wide rows and the formats phase 7 served through it."""
    main = {"nxfp_quantize": ["nxfp4", "amxfp4"],
            "nxfp_matmul": ["nxfp4"], "nxfp_decode_attention": ["nxfp4"],
            "nxfp_qq_matmul": ["amxfp4 x nxfp4"],
            "dense_decode_attention": ["bf16"]}[kname]
    wide = [r["fmt"] for k, r in rows.items()
            if "fmt" in r and k.split(" ")[0] == kname]
    if kname == "nxfp_qq_matmul":
        wide = [k.split(" ", 1)[1].rsplit(" M=", 1)[0] for k, r in rows.items()
                if "fmt" in r and k.split(" ")[0] == kname]
    served = [f"{f} (served)" for f, c in wide_counts.items()
              if c[COUNTERS[kname]] > 0]
    return list(dict.fromkeys(main + wide + served))


# each kernel's sources (the first holds the code its table row runs: the
# dequant GEMM's row is M 4, its decode regime; the qq GEMM's row is M 512,
# its decode pass then the dequant GEMM's prefill regime) and the TPU
# kernel it replaces
KERNELS = {
    "nxfp_quantize": (["src/repro_torch/csrc/nxfp_quantize_kernels.cuh",
                       "src/repro_torch/csrc/nxfp_quantize.cuh",
                       "src/repro_torch/csrc/nxfp_quantize.cu",
                       "src/repro_torch/csrc/nxfp_quantize_b4.cu",
                       "src/repro_torch/csrc/nxfp_quantize_b5.cu",
                       "src/repro_torch/csrc/nxfp_quantize_b6.cu",
                       "src/repro_torch/csrc/nxfp_quantize_b8.cu",
                       "src/repro_torch/csrc/nxfp_quantize_b3.cu",
                       "src/repro_torch/csrc/nxfp_quantize_b27.cu",
                       "src/repro_torch/csrc/nxfp_quantize_bs8.cu",
                       "src/repro_torch/csrc/nxfp_quantize_bs64.cu",
                       "src/repro_torch/csrc/nxfp_quantize_bs128.cu",
                       "src/repro_torch/csrc/nxfp_quantize_crt.cu",
                       "src/repro_torch/csrc/nxfp_quantize_tab.cu",
                       "src/repro_torch/csrc/nxfp_quantize_tabw.cu",
                       "src/repro_torch/csrc/nxfp_quantize_tab237.cu"],
                      "src/repro/kernels/nxfp_quantize.py:92"),
    "nxfp_matmul": (["src/repro_torch/csrc/nxfp_matmul_decode.cu",
                     "src/repro_torch/csrc/nxfp_matmul_prefill.cu",
                     "src/repro_torch/csrc/nxfp_matmul.cu",
                     "src/repro_torch/csrc/nxfp_matmul.cuh"],
                    "src/repro/kernels/nxfp_matmul.py:73"),
    "nxfp_decode_attention": (["src/repro_torch/csrc/nxfp_attention.cu"],
                              "src/repro/kernels/nxfp_attention.py:86"),
    # the kernel's dense-row instance: on the card it takes the place of
    # the reference's dense-cache einsum (XLA, no Pallas kernel)
    "dense_decode_attention": (["src/repro_torch/csrc/nxfp_attention.cu"],
                               "src/repro/models/kvcache.py:460"),
    "nxfp_qq_matmul": (["src/repro_torch/csrc/nxfp_qq_matmul.cu",
                        "src/repro_torch/csrc/nxfp_matmul.cu",
                        "src/repro_torch/csrc/nxfp_matmul_prefill.cu",
                        "src/repro_torch/csrc/nxfp_matmul_decode.cu",
                        "src/repro_torch/csrc/nxfp_matmul.cuh"],
                       "src/repro/kernels/nxfp_qq_matmul.py:77"),
}
# the module whose counter each kernel bumps, and the row that stands for
# it in the table (the GEMM's decode shape, mlp_w1/w3; the qq GEMM's
# prefill shape, mlp_w1/w3)
COUNTERS = {"nxfp_quantize": "nxfp_quantize", "nxfp_matmul": "nxfp_matmul",
            "nxfp_decode_attention": "nxfp_attention",
            "nxfp_qq_matmul": "nxfp_qq_matmul",
            "dense_decode_attention": "dense_attention"}
MAIN_ROW = {"nxfp_quantize": "nxfp_quantize",
            "nxfp_matmul": "nxfp_matmul M=4 K=4096 N=14336",
            "nxfp_decode_attention": "nxfp_decode_attention",
            "nxfp_qq_matmul": "nxfp_qq_matmul M=512 K=4096 N=14336",
            "dense_decode_attention": "dense_decode_attention S=512"}
# the path whose launches stand for each kernel: the serving main path
# (phase 5), the qq prefill path (phase 6) for the qq GEMM, the tiered
# path's premium tier (phase 10) for the dense-row attention
QQ_PATH = ("nxfp_qq_matmul",)
TIER_PATH = ("dense_decode_attention",)
# phases 7-10, 12, 14-17 and 21 serve Llama-3-8B at this depth (the main
# path, phase 5, at --layers), phase 11 its dense family, phase 13
# Falcon-Mamba-7B and Hymba-1.5B and phase 18 Qwen-MoE's paged and tiered
# engines: the script's clock keeps full depth for phase 18's and 19's
# models
SERVING_LAYERS = 8
# phase 20 trains Llama-3-8B at full width and this depth (4 until phase
# 21 came)
TRAIN_LAYERS = 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="Llama-3-8B depth for the main path (default 32)")
    ap.add_argument("--serving-layers", type=int, default=SERVING_LAYERS,
                    help="Llama-3-8B depth for phases 7-10, 12, 14-17 "
                         "and 21, the dense family's for phase 11, "
                         "Falcon-Mamba-7B's and Hymba-1.5B's for phases "
                         "13-17 and "
                         "Qwen-MoE's for phase 18's paged and tiered "
                         f"engines (default {SERVING_LAYERS}, at most "
                         "--layers)")
    ap.add_argument("--train-layers", type=int, default=TRAIN_LAYERS,
                    help="Llama-3-8B depth for phase 20's training "
                         f"(default {TRAIN_LAYERS})")
    args = ap.parse_args()
    late = min(args.layers, args.serving_layers)
    name, count, smi_line = phase_device()
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (pins the TF32 flags)

    t_start = time.time()
    phase_build()
    timer = Timer("cuda")
    rows = {}
    check_quantizer(timer, rows)
    check_act_quantizer(timer, rows)
    check_kv_write(timer, rows)
    check_lane_kv_write(timer, rows)
    check_paged_kv_write(timer, rows)
    check_matmul(timer, rows)
    check_matmul(timer, rows, FAMILY_KN, FAMILY_M)
    check_attention(timer, rows)
    check_dense_attention(timer, rows)
    check_dense_gemm(timer, rows)
    check_qq_matmul(timer, rows)
    check_wide_formats(timer, rows)
    ssm_rows = set(rows)
    check_ssm_kernels(timer, rows)
    ssm_rows = [k for k in rows if k not in ssm_rows]
    p15_rows = set(rows)
    check_phase15_kernels(timer, rows)
    p15_rows = [k for k in rows if k not in p15_rows]
    del timer
    torch.cuda.empty_cache()
    phase_reference()
    counts, per_step, cfg, engine, prompts, loops = phase_main(args.layers)
    act_counts = phase_act(cfg, engine, prompts)
    del engine
    torch.cuda.empty_cache()
    t7 = time.time()
    if late != args.layers:
        log(f"phases 7-10 and 12: Llama-3-8B depth cut to {late} layers")
    wide_counts = phase_wide_serving(late, prompts)
    phase_invariance()
    cont_counts, cast, reqs, solos = phase_continuous(
        late, loops["graph"], smi_line)
    phase_chunked_invariance()
    lane_counts = phase_lane(late, cast, reqs, solos, smi_line)
    t10 = time.time()
    auto_counts, _ = phase_auto_and_overload(late, cast, reqs, solos,
                                             smi_line)
    del cast
    torch.cuda.empty_cache()
    tier_counts, _ = phase_tiers(late, smi_line)
    log(f"phases 7-9 seconds: {t10 - t7:.1f}; phase 10 seconds: "
        f"{time.time() - t10:.1f}")
    t11 = time.time()
    family = phase_dense_family(smi_line, late)
    log(f"phase 11 seconds: {time.time() - t11:.1f}")
    t12 = time.time()
    paged_counts, _ = phase_paged(smi_line, Timer("cuda"), late)
    log(f"phase 12 seconds: {time.time() - t12:.1f}")
    t13 = time.time()
    ssm = phase_ssm_family(smi_line, late)
    log(f"phase 13 seconds: {time.time() - t13:.1f}")
    t14 = time.time()
    spec_counts, _ = phase_speculative(smi_line, late)
    log(f"phase 14 seconds: {time.time() - t14:.1f}")
    t15 = time.time()
    p15_counts, _ = phase_paged_spec_and_tiers(smi_line, late)
    log(f"phase 15 seconds: {time.time() - t15:.1f}")
    t16 = time.time()
    p16_counts, _ = phase_suspend_resume(smi_line, late)
    log(f"phase 16 seconds: {time.time() - t16:.1f}")
    t17 = time.time()
    p17_counts, _ = phase_faults(smi_line, late)
    log(f"phase 17 seconds: {time.time() - t17:.1f}")
    t18 = time.time()
    p18_rows = set(rows)
    p18_counts, _ = phase_moe(smi_line, late, rows)
    p18_rows = [k for k in rows if k not in p18_rows]
    log(f"phase 18 seconds: {time.time() - t18:.1f}")
    t19 = time.time()
    p19_rows = set(rows)
    p19_counts, _ = phase_vlm_audio(smi_line, rows)
    p19_rows = [k for k in rows if k not in p19_rows]
    log(f"phase 19 seconds: {time.time() - t19:.1f}")
    t20 = time.time()
    p20_rows = set(rows)
    p20_counts, p20_fig = phase_train(smi_line, args.train_layers, rows)
    trained = p20_fig.pop("trained")
    p20_rows = [k for k in rows if k not in p20_rows]
    log(f"phase 20 seconds: {time.time() - t20:.1f}")
    t21 = time.time()
    phase_sharded(smi_line, late)
    log(f"phase 21 seconds: {time.time() - t21:.1f}")
    t22 = time.time()
    p22_rows = set(rows)
    p22_counts, _ = phase_figures(smi_line, rows, trained)
    p22_rows = [k for k in rows if k not in p22_rows]
    del trained
    log(f"phase 22 seconds: {time.time() - t22:.1f}")

    table = []
    for kname, (sources, replaces) in KERNELS.items():
        row = rows[MAIN_ROW[kname]]
        c = COUNTERS[kname]
        path = (act_counts if kname in QQ_PATH else tier_counts
                if kname in TIER_PATH else counts)
        table.append(dict(
            name=kname, route="cuda", source=sources[0], sources=sources,
            replaces=replaces,
            launches=path[c],
            launches_main_path=counts[c],
            launches_qq_prefill_path=act_counts[c],
            launches_per_decode_step=per_step[c],
            launches_continuous_path=cont_counts[c],
            launches_chunked_path=lane_counts[c],
            launches_auto_path=auto_counts[c],
            launches_tiered_path=tier_counts[c],
            launches_dense_family={a: v[0][c] for a, v in family.items()},
            launches_paged_path=paged_counts[c],
            launches_ssm_family={a: {path: n[c] for path, n in v[0].items()}
                                 for a, v in ssm.items()},
            launches_speculative_path={path: n.get(c, 0)
                                       for path, n in spec_counts.items()},
            launches_phase15_path={path: n.get(c, 0)
                                   for path, n in p15_counts.items()},
            launches_phase16_path={path: n.get(c, 0)
                                   for path, n in p16_counts.items()},
            launches_phase17_path={path: n.get(c, 0)
                                   for path, n in p17_counts.items()},
            launches_phase18_path={path: n.get(c, 0)
                                   for path, n in p18_counts.items()},
            launches_phase19_path={path: n.get(c, 0)
                                   for path, n in p19_counts.items()},
            launches_phase20_path={path: n.get(c, 0)
                                   for path, n in p20_counts.items()},
            launches_phase22_path={path: n.get(c, 0)
                                   for path, n in p22_counts.items()},
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            formats=kernel_formats(kname, rows, wide_counts),
            shape=row["shape"]))
    # the rows at the SSM and hybrid families' shapes (phase 13), each
    # with its kernel's launches on those families' paths (the cast, the
    # graph device loop, the engines' serves), summed and by path
    ssm_paths = {a: _sum_counts(*v[0].values()) for a, v in ssm.items()}
    for key in ssm_rows:
        kname = next(k for k in KERNELS if key.split(" ")[0] in (
            k, COUNTERS[k]))
        sources, replaces = KERNELS[kname]
        r = rows[key]
        table.append(dict(
            name=key, kernel=kname, route="cuda", source=sources[0],
            replaces=replaces,
            launches=sum(ssm_paths[a][COUNTERS[kname]] for a in ssm),
            launches_ssm_family={a: {path: n[COUNTERS[kname]]
                                     for path, n in v[0].items()}
                                 for a, v in ssm.items()},
            **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "shape")}))
    # the rows at the shapes phase 15 adds (the qq GEMM at Hymba's pairs,
    # the paged verify write), each with its kernel's launches on phase
    # 15's paths
    for key in p15_rows:
        kname = ("nxfp_qq_matmul" if key.startswith("nxfp_qq_matmul")
                 else "nxfp_quantize")
        sources, replaces = KERNELS[kname]
        r = rows[key]
        by_path = {path: n.get(COUNTERS[kname], 0)
                   for path, n in p15_counts.items()}
        table.append(dict(
            name=key, kernel=kname, route="cuda", source=sources[0],
            replaces=replaces, launches=sum(by_path.values()),
            launches_phase15_path=by_path,
            **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "shape")}))
    # the dequant GEMM's grouped instance (the MoE experts' rows), each
    # shape phase 18 holds, with its launches on phase 18's paths
    by_path = {path: n.get("nxfp_matmul_grouped", 0)
               for path, n in p18_counts.items()}
    sources, replaces = KERNELS["nxfp_matmul"]
    for key in sorted(p18_rows, key=lambda k: k != P18_MAIN_ROW):
        r = rows[key]
        table.append(dict(
            name=key, kernel="nxfp_matmul", route="cuda",
            source="src/repro_torch/csrc/nxfp_matmul_decode.cu",
            replaces=replaces, launches=sum(by_path.values()),
            launches_phase18_path=by_path,
            **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "shape")}))
    # the rows at the vision and audio families' shapes (phase 19), each
    # with its kernel's launches on phase 19's paths (the builds, the
    # serves, the kv_sim prefill)
    for key in sorted(p19_rows, key=lambda k: k not in P19_MAIN_ROWS):
        kname = next(k for k in KERNELS if key.split(" ")[0] in (
            k, COUNTERS[k]))
        sources, replaces = KERNELS[kname]
        by_path = {path: n.get(COUNTERS[kname], 0)
                   for path, n in p19_counts.items()}
        r = rows[key]
        table.append(dict(
            name=key, kernel=kname, route="cuda", source=sources[0],
            replaces=replaces, launches=sum(by_path.values()),
            launches_phase19_path=by_path,
            **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "shape")}))
    # the rows at phase 20's shapes (the gradient casts, the direct-cast
    # evaluation's GEMM at M 1024), each with its kernel's launches on
    # phase 20's paths (the smoke cast, training, the eval, the serve)
    for key in sorted(p20_rows, key=lambda k: k not in P20_MAIN_ROWS):
        kname = next(k for k in KERNELS if key.split(" ")[0] in (
            k, COUNTERS[k]))
        sources, replaces = KERNELS[kname]
        by_path = {path: n.get(COUNTERS[kname], 0)
                   for path, n in p20_counts.items()}
        r = rows[key]
        table.append(dict(
            name=key, kernel=kname, route="cuda", source=sources[0],
            replaces=replaces, launches=sum(by_path.values()),
            launches_phase20_path=by_path,
            **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "shape")}))
    # the rows at phase 22's shapes (the table instances at w1, the kv_sim
    # route under mxfp4 and bfp4), each with the quantizer's launches on
    # phase 22's paths (the figure suite, the examples, the full-width W4
    # casts)
    for key in sorted(p22_rows, key=lambda k: k not in P22_MAIN_ROWS):
        sources, replaces = KERNELS["nxfp_quantize"]
        by_path = {path: n.get("nxfp_quantize", 0)
                   for path, n in p22_counts.items()}
        r = rows[key]
        table.append(dict(
            name=key, kernel="nxfp_quantize", route="cuda",
            source=sources[0], replaces=replaces,
            launches=sum(by_path.values()), launches_phase22_path=by_path,
            **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "shape")}))
    extra = [dict(name=k, **{f: v for f, v in r.items()})
             for k, r in rows.items()
             if k not in MAIN_ROW.values() and k not in ssm_rows
             and k not in p15_rows and k not in p18_rows
             and k not in p19_rows and k not in p20_rows
             and k not in p22_rows]
    log(f"other shapes: {json.dumps(extra)}")
    log(f"total seconds: {time.time() - t_start:.1f}")
    print(json.dumps({"kernels": table}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
