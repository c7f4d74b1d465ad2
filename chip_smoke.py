#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (the lag twin, the fleet layer, the
packers' sweep, the optimizer, the adversarial search and trace replay,
LLM serving of a dense model, of RWKV-6, of a mixture of experts and of
the hybrid Mamba family, the paper's own system with
an autoscaled fleet of LLM replicas, training of a dense LLM and of
RWKV-6, serving and training of the encoder-decoder family, serving of
the VLM and of a dense model through the tailed decode, training of the
MoE and hybrid Mamba families, the lag twin's six examples, and the
one-card dry run against the card) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--paths L0,L1]

Run from a checkout of the repository on a machine with a CUDA card and
``nvcc``.  Phases, each of which fails the script if it fails:

1. the card's name and power limit, torch and CUDA versions;
2. building the CUDA kernels from ``src/repro_torch/kernels/csrc``; the
   built library's SASS (``cuobjdump -sass``) must show the bfloat16
   flash-attention kernel on ``wgmma`` (``HGMMA``) with its K/V loaded by
   TMA (``UTMALDG``) at every head dim, and the float32 one without
   ``HGMMA``; the same for the bfloat16 flash backward's two kernels
   (``csrc/flash_attention_bwd_bf16.cu``, head dims 64 and 128) and the
   float32 backward (``csrc/flash_attention_bwd.cu``); the build's
   ``-Xptxas -v`` report must show every ``loop_fused`` instantiation (n
   = 1..14) with a 0-byte stack frame and no spills (its state in
   registers), and every ``rwkv6_wkv`` and ``rwkv6_wkv_bwd`` head size
   (16, 32, 64, 128) and every instantiation of the bfloat16 backward's
   kernels with no spills;
3. every kernel against its plain PyTorch version on the card
   (integers exact, floats ``rtol = atol = 1e-5``; the attention
   kernels at ``2e-5`` in float32 and ``2e-2`` in bfloat16; the WKV
   kernel within ``1e-4`` of the largest magnitude of its plain result),
   at stress shapes and at the shapes the paths give it (the drain
   ``lag_update`` in the lag twin's dtypes -- bool masks, int64 ``assign``
   -- and in int32, the same bits; decode attention
   also at fills on either side of a split boundary, and captured once in
   a CUDA graph and replayed at other fills set in place on the card; the
   packing kernel ``pack_rows`` for all 12 packers, masked and unmasked,
   at n = 6, 7, 32 and 256, with ties, oversized items and out-of-range
   previous names, exact and ``loads`` bit for bit; the annealer's step
   ``anneal_step`` against ``anneal_step_reference`` over 48 steps at
   path C1's, C2's and I1's shapes, masked and unmasked, every state
   tensor bit for bit; ``pack_rows`` (BFD, exact) and ``lag_update``
   (within ``1e-5``) also on path J1's own row of 30 partitions in bytes,
   and decode attention at path J2's 16-position cache, 1-4 filled; the
   flash forward at 64 query heads over 8 KV heads, the decode kernel at
   8 query rows a KV head and the decode kernel's tailed entry at 4 and 8
   rows, eager at fills with an empty main cache, a full tail, an empty
   tail, mid-way and last, and replayed from a CUDA graph across flushes:
   ``check_new_calls``, run also by a ``--paths`` run that names P or Q);
4. path A: ``repro_torch.api.simulate`` with the 8 heuristic packers
   through the ``loop_fused`` kernel (``fused_steps=8, fused_kernel=True``)
   over 4096 consumer groups x 2880 steps (one day at a 30 s monitor
   window) x 14 partitions, a mix of diurnal, bursty and masked
   topic-lifecycle traffic made on the card from ``--seed``, each rate
   clipped to one consumer's capacity (the paper's Sec. II feasibility
   assumption: one consumer can drain any single partition);
5. path B: ``api.simulate`` with MWF, MBF, MWFP, MBFP, KEDA_LAG,
   RATE_THRESHOLD and BFD through the per-step loop with
   ``use_kernel=True`` over 1024 groups x 480 steps x 32 partitions:
   exactly one ``pack_rows`` launch a packing policy a step (2400), no
   ``select_slot_grid`` launch, 3360 ``lag_update`` launches; then the
   torch ops a step of each policy, with the packing kernel and with the
   plain packers swapped in, and the 7 policies' total beside the
   ``lag_update`` launches;
6. path C1: ``api.simulate`` with the annealer policies ANNEAL and
   ANNEAL_STICKY (6 chains, 48 anneal steps a decision) over path B's
   traffic, every anneal step one ``anneal_step`` launch (exactly 46,080,
   and no ``move_delta_batch`` launch); the first 16 groups x 48 steps run
   once more on the CPU with the card's draws injected and must give the
   same integers; then the torch ops an anneal step, with the kernel
   (fewer than 10) and with the plain step;
7. path C2: ``api.optimize`` on one 256-partition topic (a diurnal step,
   ``prev`` from 32 steps of BFD): the 7-lambda x 4-restart frontier over
   250 anneal steps, all 12 packers scored against it (exactly 250
   ``anneal_step``, 12 ``pack_rows`` and no ``move_delta_batch``
   launches); the same instance and seed with the plain anneal step on
   the card must give the same frontier;
8. path F, a ragged fleet through ``FleetRunner.simulate``: 4096
   consumer groups, 512 of each of the 8 registered scenario families at
   their default knobs (churn, topic_lifecycle and adversarial masked),
   drawn on the card at 960 steps x 64 partitions from ``--seed`` and
   clipped to one consumer's capacity, each cut to its own T_i in {240,
   480, 720, 960} steps and N_i in 4..64 partitions (numpy, from
   ``--seed``), bucketed into (480, 960) x (8, 16, 32, 64); BFD, MBF,
   MWFP and KEDA_LAG through the per-step loop with ``use_kernel=True``
   and a replica cap of 64: exactly 8 bucket groups, 3 x sum(T_b) =
   17,280 ``pack_rows`` and 4 x sum(T_b) = 23,040 ``lag_update``
   launches, no ``select_slot_grid``; the same call after ``reset()``
   hits all 8 cache entries (no miss, no eviction); 8 groups of each
   bucket that share a shape, run at that shape through ``sweep_lag``,
   equal the padded run (integers exact, lag within ``1e-5``);
9. path G: ``api.sweep`` of the 12 packers over path B's traffic
   (exactly 12 x 480 ``pack_rows`` launches, none of ``select_slot_grid``),
   its first 16 streams x 48 steps once more on the CPU (bins and
   migrations exact, R-scores within ``1e-5``); ``api.evaluate()`` at the
   paper's defaults (12 x 120 launches) equal to the CPU's (CBS and
   Pareto lists exact, average R-score within ``1e-5``); ``api.pack`` of
   one 256-partition instance for each of the 12 packers equal to the
   CPU's; G4: ``api.pack(backend="py")`` (the pure-Python packers, the
   facade's default) for the 12 packers on that instance, its speeds
   quantized to k/1024, equal to ``backend="torch"`` on the card
   (assignment, ``n_bins``, loads);
10. path H, the scalers as deployed, observed in the loop: H1 is
   ``api.simulate`` over path B's traffic with ``use_kernel=True`` and
   in-loop telemetry (per-step frames, the default sketch, the four
   default alert rules): (a) KEDA_LAG_REAL and CLOUD_RUN_CPU_LAG at their
   registry defaults, (b) MBF, BFD and KEDA_LAG behind
   ``control_plane=ControlPlaneConfig(polling_interval=1,
   observation_delay=1, actuation_delay=1, cooldown_period=10,
   max_replicas=16, warmup_steps=2)``: exactly policies x 480
   ``lag_update`` and packers x 480 ``pack_rows`` launches; the SLO
   metrics, incidents per policy and rule and a lint-clean Prometheus
   exposition; the first 16 groups x 48 steps once more on the card and
   on the CPU (the plain versions): integers, sketch counts and
   histograms and incident tables exact, floats within ``1e-5``; then
   the torch ops a policy-step with the telemetry and the control plane
   on, each alone and both off.  H2 is path A's heuristics at [1024, 480,
   14] under ``fused_steps=8, fused_kernel=True`` with a sketch and
   alerts on: no ``loop_fused`` launch (the kernel carries no
   telemetry), trajectories equal to the kernel's with telemetry off bit
   for bit.  H3 is a ragged fleet of 256 of path F's groups of at most 480
   steps with BFD, MBF
   and KEDA_LAG_REAL through ``FleetRunner.simulate``, a sketch and
   alerts on: exact launch counts, and 16 groups at their own shapes with
   equal sketches and incident tables;
11. path I, adversarial search and trace replay, every fitness step
   through the drain and packing kernels (``use_kernel=True``): I1 is
   ``api.attack`` of each registry family's representative (NF, MWF,
   KEDA_LAG, ANNEAL) at the reference's own search budget
   (``benchmarks/adversarial_bench.py``: pop 8, 6 generations, 96 steps x
   6 partitions, ``incident_weight=0.05``, the four default alert rules
   in the loop), the random baseline on: exactly 96 ``lag_update``
   launches a generation of the search and of the baseline, as many
   ``pack_rows`` for NF and MWF, none for KEDA_LAG, 48 ``anneal_step``
   a step for ANNEAL; NF's search once more, bit for bit; for each
   policy, one fitness batch of the oracle's rows at I1's shape through
   the loop on the card against the CPU run of the same rows (plain
   versions; ANNEAL with the card's draws injected), integers and
   incident tables exact, lag within ``1e-5``.  I2 is
   ``api.attack("MBF")`` at a capacity planner's size (pop 32 x 4
   scenarios of 960 steps x 32 partitions a fitness call, 4
   generations) through a fresh ``FleetRunner``: exactly 960 x 2 x
   ``generations_run`` launches of each kernel, one cache miss and
   ``2 x generations_run - 1`` hits, the oracle's batch at its shape
   (the kept genome and 31 random ones, [128, 960, 32]) against the CPU
   transform of the same draws, masks exact; its witness saved as
   ``.npz`` and ``.json`` (equal once loaded) and replayed through
   ``api.replay`` (MBF, BFD, KEDA_LAG; as recorded, and resampled to 480
   steps), each equal to a direct ``api.simulate`` of the same arrays
   bit for bit;
12. path D, dense-LLM serving: qwen3-8b at full width and depth (36
   layers) in bfloat16 with bfloat16 weights drawn on the card from
   ``--seed``; D1 is ``make_prefill_step`` on 8 requests x 1024 prompt
   tokens (36 flash-attention launches), D2 is ``SharedModel.generate``
   on the same requests with a 1152-token cache: their first 128 tokens
   teacher-forced and 128 greedy ones (36 x 256 decode-attention
   launches); one decode step at the cache's last fill replayed as a CUDA
   graph (its device time, torch ops, bytes and their bound) and one
   eager step under ``torch.profiler`` (device ms by operator);
13. the agreement check of the LLM kernels: qwen3-8b at full width with 4
   layers in float32, prefill and 48 + 16 decode steps once with the
   kernels and once with their plain versions on the card: logits within
   1e-4, the same tokens; the decode logits at every prompt position
   equal to the full-sequence logits within 2e-2 (the reference's own
   property); the same prefill on the CPU, printed;
14. path E, RWKV-6 serving: rwkv6-3b at full width and depth (32 layers)
   in bfloat16 with bfloat16 weights drawn on the card from ``--seed``;
   E1 is ``make_prefill_step`` on 8 requests x 1024 prompt tokens (32
   WKV launches), E2 is ``SharedModel.generate`` on the same requests,
   128 teacher-forced steps and 128 greedy ones (32 x 256 WKV launches,
   each writing its layer's state in place), its step as D2's;
15. the RWKV agreement check: rwkv6-3b at full width with 4 layers in
   float32 (bonus and decay perturbed from their init constants), prefill
   and 48 + 16 decode steps once with the WKV kernel and once with its
   plain version on the card, with the same checks as phase 13;
16. path M, MoE serving: qwen2-moe-a2.7b at full width and depth (24
   layers, each of 16 attention heads of 128 over 16 KV heads and a
   mixture of 60 experts of d_ff 1408, top-4, with 4 shared) in bfloat16
   with bfloat16 weights (the routers float32) drawn on the card from
   ``--seed``: M1 prefills 8 x 1024 tokens (24 flash-attention launches;
   the expert dispatch at a capacity of 128 a row), M2 generates 128
   teacher-forced + 128 greedy tokens through ``SharedModel.generate``
   (24 x 256 decode-attention launches, one query head a KV head; the 8
   decode rows one dispatch group, a capacity of 1), its step as D2's;
   then the agreement check of phase 13 at 4
   layers in float32, the smallest top-4 routing margin printed, and
   decode against prefill at the capacity factor where nothing drops (15);
17. path N, hybrid serving: jamba-v0.1-52b at full width cut to one
   period (8 of its 32 layers: 1 attention, 7 Mamba, 4 mixtures of 16
   experts of d_ff 14336, top-2, 4 MLPs), as path M: N1 1 flash launch,
   N2 1 x 256 decode launches; then the agreement check at those 8
   layers in float32 (~53 GB, its peak printed), decode against prefill
   at capacity factor 8;
18. path J, the paper's system (broker, monitor, controller, replicas;
   host code) with the port's kernels behind it: J1 runs the object world
   ``AutoscaleSimulation`` at the paper's 30 partitions (constant rates
   of whole 16 KiB records, ``k_i`` in [14, 126] from ``--seed``, BFD, a
   consumer capacity of 140 records a second, 2,293,760 B/s), synchronized
   for 8 ticks and then run 600 more on the host, and the lag twin
   ``simulate_lag(policy="BFD", use_kernel=True)`` from the world's
   backlog on the card: consumer counts equal at every step, no
   migration on either side, lag within ``4 x 16384 x 30`` B, exactly
   600 ``pack_rows`` and 600 ``lag_update`` launches.  J2 is the serving
   example's world (``repro_torch.examples.autoscale_serve``: 6 request
   streams, 64 KiB request records, MBFP, a replica capacity of 0.25 MB/s)
   over 60 ticks with a x4 spike on streams 0-2 at 20-40 s, every
   replica an ``LLMReplica`` on one ``SharedModel(max_len=16,
   max_batch=8)`` of qwen3-8b at full width and depth in bfloat16
   (weights drawn on the card from ``--seed``): exactly 36
   ``decode_attention`` launches a serve step, the byte-level world equal
   integer for integer to the same world with byte replicas on the host,
   and the first generate call once more giving the same tokens;
19. path K, training: K0 holds the flash-attention backward (dq, dk and
   dv: ``csrc/flash_attention_bwd_bf16.cu`` on ``wgmma`` for bfloat16 at
   head dims 64 and 128, ``csrc/flash_attention_bwd.cu`` on the CUDA
   cores for float32) against its plain version (the explicit formula,
   fed the forward kernel's lse, which must agree with the plain lse
   within 1e-5) at olmo-1b's heads (q [4, 16, 2048, 128], path K1's
   call), qwen3-8b's grouped heads (q [4, 32, 1024, 128] over 8 KV
   heads, causal and full), grouped heads at hd 64 and a ragged causal
   case (q [2, 16, 1000, 128] over k/v [2, 4, 777, 128]) in bfloat16,
   at q [2, 32, 512, 128] in float32, and over a single key (bfloat16 at
   hd 128, float32 at hd 256), under two checks: ``2e-2`` and
   ``2e-5`` with the absolute part scaled by the plain result's largest
   gradient, and the relative norm of the error, whole and in every
   block of 64 rows of one head (``BWD_REL_TOL``), which each of three
   controls (the last key block zeroed, D dropped, a head left out) must
   fail; two calls bit-equal in every case; timed beside its bound, its
   plain version and the backward of ``scaled_dot_product_attention``
   (its forward run before), both as CUDA-graph replays and eager;
   then ``FlashAttention`` on the card against the plain versions'
   Function, one backward each, every gradient nonzero.  K1 trains
   olmo-1b at full width and depth (f32 parameters, bf16 compute, remat)
   for 6 AdamW steps of 4 x 2048 tokens from ``TokenPipeline`` through
   ``make_train_step``: finite losses, exactly 32 forward (16 of them
   remat's recomputation) and 16 backward flash launches a step, a
   nonzero gradient in every layer's wq, wk and wv (the first moment
   after step 1), each step's wall and the peak memory.  K2 takes one
   step of a 2-layer full-width olmo-1b (2 x 2048 tokens) with the
   kernels and with their plain versions swapped in: losses within
   2e-2, every parameter's update within 5e-2 of its largest (AdamW eps
   1e-3, so that the first update follows its gradient).  K3 runs
   ``repro_torch.examples.elastic_train`` at TINY (200 steps, preempted
   at 100 and resumed from its checkpoint; the loss must fall), then
   writes a TINY state with the port's store in the reference's layout
   (layers stacked), reads it back through ``convert`` and resumes on
   the card: equal state, the same next step;
20. path L, RWKV-6 training: L0 holds the training forward (the forward
   kernel's checkpoint variant: out and the last state bit-equal to the
   forward without checkpoints, its checkpoints within ``1e-4`` of the
   plain forward's) and the WKV recurrence's backward
   (dr, dk, dv, dw, du and ds0: ``csrc/rwkv6_wkv_bwd.cu``, fed the plain
   forward's checkpoints) against its
   plain version (the explicit reverse sweep) at path L1's call (r [4,
   2048, 40, 64]), at hd 16, 32 and 128, at a T no checkpoint stride
   divides (r [2, 1000, 8, 64]) and at T = 1, every case with nonzero s0
   and ds_last and decays exp(-exp(wlog)) for wlog uniform on [-8, 6]
   (exact zeros and values near 1), under two checks: within ``1e-4`` of
   each gradient's largest magnitude, and the relative norm of the
   error, whole and in every block of 64 steps of one (batch row, head)
   (``WKV_BWD_REL_TOL``), which each of three controls (the carried state
   gradient zeroed at each chunk boundary, dw zeroed at each chunk's
   first step, a head left out) must fail; two calls bit-equal in every
   case; timed at L1's call beside its bound and its plain version (CUDA
   graph replays), with the forward with and without checkpoints, the
   launch's blocks, shared memory and waves, and one cluster alone;
   then ``WKV`` on the card against the plain pair's
   Function, one backward each.  L1 trains rwkv6-3b at full width and
   depth (f32 parameters, bf16 compute, remat) for 6 AdamW steps of 4 x
   2048 tokens from ``TokenPipeline`` through ``make_train_step``
   (parameters and state donated, updated in place): finite losses,
   exactly 64 forward (32 of them remat's recomputation) and 32 backward
   WKV launches a step, a nonzero gradient in every layer's tm.w_k,
   tm.decay_w1 and tm.bonus_u, each step's wall and the peak memory; then
   one more step under ``torch.profiler`` (the card's busy share, device
   time by kernel).  L2 takes a 2-layer full-width rwkv6-3b (2 x 2048
   tokens) with the WKV kernels and with their plain versions swapped
   in, in float32 and in bfloat16 compute: losses within 2e-2, every
   gradient within 5e-2 of its largest, every update of one AdamW step
   (lr 1e-3, eps 1e-3) within ``L2_UPDATE_REL_TOL`` by its relative norm
   by leaf, and in float32 within 5e-2 of its largest (see
   ``run_path_l2``);
21. path O, whisper-large-v3 (32 encoder + 32 decoder layers, d_model
   1280, 20 heads of 64, T_enc 1500, random weights from ``--seed``): O0
   holds the attention kernels at whisper's calls against their plain
   versions and times them beside SDPA and their bounds (the flash
   forward without the mask at the encoder's q = k = v [8, 20, 1500, 64]
   and the prefill's cross call q [8, 20, 32, 64] over k/v [8, 20, 1500,
   64]; the flash backward without the mask at O3's encoder and cross
   calls, under ``bwd_case``'s checks and controls; the decode kernel
   over a [8, 20, 1500, 64] cross cache at fill 1499); O1 prefills 8
   requests of 1500 frames and a 32-token prompt in bf16 (exactly 96
   flash launches); O2 encodes once, precomputes the cross K/V and runs
   32 teacher-forced + 224 greedy decode steps in a 256-position cache
   (exactly 64 decode launches a step), then one step as a graph replay,
   its torch ops, one step under ``torch.profiler`` and its bytes; then
   the f32 agreement at 4 + 4 layers (prefill and 16 greedy steps
   against the plain versions within 1e-4, tokens equal; decode against
   the teacher-forced decoder within 2e-2); O3 trains at full width and
   depth (f32 parameters, bf16 compute, remat, donated): a warm-up, then
   4 steps of 4 x (1500 frames + 448 tokens), exactly 192 forward and 96
   backward flash launches a step, the watched gradients nonzero; then
   2 steps at 4 + 4 layers against the plain versions, f32 and bf16,
   held by ``update_verdict``;
22. path P, the VLM: qwen2-vl-72b at full width (64 heads over 8 KV
   heads of 128, d_ff 29568, M-RoPE sections (16, 24, 24)) cut to 16 of
   its 80 layers, bf16 weights from ``--seed``: P1 prefills 8 requests of
   1024 standard-normal embeddings through the (d, d) adapter, laid out
   as Qwen2-VL lays out 64 text positions, one 24 x 32 image (t fixed, h
   the row, w the column) and 192 text positions resuming at 96 (exactly
   16 flash launches); P2 runs 128 teacher-forced decode steps of (B, 1,
   d) embeddings at text positions from 288 (exactly 16 decode launches
   a step, G = 8), one step replayed as a CUDA graph at the cache's last
   fill beside its bytes; then the f32 agreement at 4 layers (prefill
   with 3-stream positions, the prompt through the decode path and 16
   more steps, kernels against plain within 1e-4, decode against
   prefill within 2e-2);
23. path Q, the tailed decode: deepseek-67b at full width (64 heads over
   8 KV heads, d_ff 22016) cut to 16 of its 95 layers, bf16, with
   ``decode_tail_window = 256``: Q1 prefills 8 x 1024 tokens (16 flash
   launches); Q2 decodes 256 teacher-forced + 128 greedy tokens through
   the tailed state, flushing at 256 (exactly 16 tailed decode launches
   a step), then the same steps untailed (16 decode launches a step):
   teacher-forced logits within 5e-2; both steps and the flush replayed
   as CUDA graphs; then the f32 agreement at 4 layers and window 16
   (prefill, then 48 + 16 steps across 4 flushes: tailed kernels against
   tailed plain versions and against the untailed kernels, logits within
   1e-4, tokens equal; tailed decode against prefill within 2e-2);
24. path R, training the MoE and hybrid families: R1 trains
   qwen2-moe-a2.7b at full width (60 experts top-4 and 4 shared, 16
   heads of 128) cut to 4 of its 24 layers, f32 parameters, bf16
   compute, remat, donated: 4 AdamW steps of 4 x 2048 tokens, exactly 8
   forward and 4 backward flash launches a step, finite loss, ce and
   aux > 0, a nonzero gradient in every layer's router, wq/wk/wv and
   shared expert and in every expert that took a token; one step under
   the profiler, split by part (the flash kernels, the expert einsums,
   the dispatch's gathers and their scatter-add backwards, the f32 loss,
   the other matmuls, AdamW); the flash forward with its lse at R1's
   call, timed; R2 the step at 2 layers in float32 with the kernels and
   with their plain versions, losses within 1e-5 and every leaf's update
   by its relative norm (``update_verdict``), the smallest top-k margin
   printed; R3 the same for 3 steps of jamba-smoke (the period layout,
   Mamba layers) and llama4-scout-smoke (top-1 routing);
25. path S, the lag twin's six examples (``repro_torch.examples``:
   quickstart, scenario_sweep, lag_slo_sweep ``--smoke --use-kernel``,
   pareto_frontier, live_dashboard ``--smoke``, adversarial_report
   ``--attack MWF``) on the card, each held to running through and to
   launching the kernels its route reaches (``pack_rows``;
   ``lag_update``; ``anneal_step``);
26. path T, the one-card dry run (``repro_torch.launch.dryrun``) against
   the card: qwen3-8b decode_32k (T1) and prefill_32k (T2) and olmo-1b
   train_4k (T3) walked at full width and depth under fake tensors (in
   spawned processes started before the build), then each run for real
   at the batch its record names after a warm-up, the peak allocated
   since the cell began held within 15% of the record's live bytes, the
   step beside the roofline (T1 also as a graph replay), the capacity
   bridge's tokens/s from the record; then the decode kernel at T1's
   call and the flash forward at T2's (its last rows against the plain
   version over the whole K/V), 32,768 positions each;
27. each kernel's time at its path's shapes beside its bound, its plain
   version's time and, for the attention kernels, the time of PyTorch's
   ``scaled_dot_product_attention`` on the same inputs (``library_ms``,
   a yardstick the port never calls; for the flash backward, the
   backward of that call at K1's shape, replayed from a CUDA graph like
   the kernel, and eager as ``library_eager_ms`` beside ``wrapper_ms``;
   the flash row also in float32 at
   D1's shape, and in bfloat16 with its lse stored (training's call, at
   D1's shape and at R1's); no
   PyTorch call computes the WKV recurrence; ``pack_rows`` at path B's
   Modified Any Fit call, MBF over [1024, 32]; ``anneal_step``
   at C1's and C2's shapes; the move plane ``move_eval``, which no path
   launches any more, at C1's); ``loop_fused`` and its plain version also
   run path A's whole input once more, assignments recorded, and their
   outputs must be equal bit for bit.

Kernel times (``ms``) and plain times (``plain_ms``) are device time per
call: ``loop_fused`` is one long launch timed with CUDA events, and the
small per-step kernels are timed as a CUDA graph of back-to-back calls,
so that no host work is counted.  ``wrapper_ms`` is the time per eager
call of the kernel's Python wrapper, which is what the per-step loop
pays.

``--paths`` runs phases 1-2 and then only the named paths (a letter
takes all its parts), and prints the kernel rows they make whole (the
WKV backward's, after L0; the three attention kernels' at whisper's
calls, after O0; the tailed decode's, after Q; the flash forward's at
R1's call, after R1; the flash forward's and the decode kernel's at T's
calls, after T) and the last line.

Kernel launch counts are zeroed just before each path and read just
after it; a path that launched none of its kernels fails.  The line
before the last is a JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``; the card's name and power limit are
printed first and again just before them.  Without a CUDA card, or
outside a checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))
try:            # the card's roofline peaks, which the dry run's records use
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32
except ImportError:         # outside a checkout: main says so and exits 2
    HBM_BW = PEAK_FLOPS_BF16 = PEAK_FLOPS_F32 = None

HEURISTICS = ("NF", "NFD", "FF", "FFD", "BF", "BFD", "WF", "WFD")
PATH_B = ("MWF", "MBF", "MWFP", "MBFP", "KEDA_LAG", "RATE_THRESHOLD", "BFD")
PATH_C1 = ("ANNEAL", "ANNEAL_STICKY")
TOL = 1e-5
CAPACITY = 1.0                # a consumer's drain rate (LagSimConfig's default)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LLM = "qwen3-8b"
D_BATCH, D_PROMPT, D_GEN = 8, 1024, 128  # paths D, E, M, N: requests, tokens
#: the teacher-forced prompt of the generate phases (D2, E2, M2, N2, P2):
#: the first D_FORCED tokens of each request (1024 until paths M and N
#: came, 256 until paths P and Q: the phases are host-bound, and the
#: whole script must stay inside its time limit on a slow host); the
#: cache keeps D_PROMPT + D_GEN positions
D_FORCED = 128
RWKV = "rwkv6-3b"
MOE = "qwen2-moe-a2.7b"
HYBRID, HYBRID_LAYERS = "jamba-v0.1-52b", 8   # one period of jamba's 4
#: the agreement check's host prefill copies the weights to the CPU only
#: below this many bytes (path N's 8 float32 layers hold ~53 GB)
HOST_CHECK_BYTES = 16e9
WKV_TOL = 1e-4                # of the plain result's largest magnitude


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int, warmup: int = 1):
    """``(mean milliseconds per call on the card, the last call's result)``
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


_SIDE_STREAM = []


def side_stream():
    """One side stream for every warm-up and capture: cuBLAS keeps a 32 MiB
    workspace for each stream it has run on, never freed, so a new stream
    a capture would hold memory across the paths."""
    import torch

    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    return _SIDE_STREAM[0]


def graph_ms(fn, calls: int, prepare=None) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` back-to-back calls
    captured in one CUDA graph, replayed and timed with CUDA events, so
    that the host's per-call work is not counted.  ``prepare``, if given,
    runs once before, uncaptured, on the stream that then captures (an
    autograd forward, whose backward runs on its forward's stream)."""
    import torch

    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        if prepare is not None:
            prepare()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=None if prepare is None else side):
        for _ in range(calls):
            fn()
    graph.replay()                         # first replay uploads the graph
    ms, _ = cuda_ms(graph.replay, 3, warmup=0)
    return ms / calls


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = PEAK_FLOPS_F32):
    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def traffic_mix(batch: int, iters: int, n: int, seed: int, dev):
    """Diurnal, bursty and masked topic-lifecycle groups, in thirds, each
    rate clipped to ``CAPACITY``: at the families' default knobs a few
    percent of partition-steps exceed one consumer's drain rate, and such
    a partition's backlog grows under every policy."""
    import torch

    from repro_torch.core import scenarios

    sizes = (batch - 2 * (batch // 3), batch // 3, batch // 3)
    rates, masks = [], []
    for i, (fam, b) in enumerate(zip(("diurnal", "bursty", "topic_lifecycle"),
                                     sizes)):
        sp, act = scenarios.generate_masked_scenario(fam, seed + i, b, iters,
                                                     n, device=dev)
        rates.append(torch.clamp(sp, max=CAPACITY))
        masks.append(act)
    return torch.cat(rates), torch.cat(masks)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _close(got, want, what: str) -> float:
    import torch

    err = _max_err(got, want)
    _require(torch.allclose(got, want, rtol=TOL, atol=TOL),
             f"{what}: kernel disagrees with its plain version "
             f"(max abs err {err})")
    return err


def _exact(got, want, what: str) -> None:
    import torch

    _require(torch.equal(got, want),
             f"{what}: kernel integers differ from its plain version")


def check_lag_update(dev, gen, b, n, m, names):
    """Kernel against plain at ``[b, n]`` partitions and ``m`` bins, with
    bin names drawn below ``names``: masked and unmasked, with the lag
    twin's dtypes (bool masks, ``active`` one step of a [B, 2, N] mask,
    int64 ``assign``) and with int32 ones; both dtypes give the same
    bits."""
    import torch

    from repro_torch.kernels import lag_update as lu

    worst = 0.0
    for masked in (False, True):
        lag = torch.rand((b, n), generator=gen, device=dev) * 2
        produced = torch.rand((b, n), generator=gen, device=dev)
        assign = torch.randint(-1, names, (b, n), generator=gen, device=dev)
        readable = torch.rand((b, n), generator=gen, device=dev) > 0.2
        cap = torch.rand((b, m), generator=gen, device=dev) * 4
        act = (torch.rand((b, 2, n), generator=gen, device=dev) > 0.1
               if masked else None)
        i32 = lambda x: x.to(torch.int32)  # noqa: E731
        got = lu.lag_update_batch(lag, produced, assign, readable, cap,
                                  active=None if act is None else act[:, 1])
        got32 = lu.lag_update_batch(
            lag, produced, i32(assign), i32(readable), cap,
            active=None if act is None else i32(act[:, 1]))
        want = lu.lag_update_reference(
            lag, produced, assign, readable, cap, m=m,
            active=None if act is None else act[:, 1])
        torch.cuda.synchronize()
        _require(torch.equal(got.view(torch.int32), got32.view(torch.int32)),
                 f"lag_update masked={masked}: bool/int64 and int32 inputs "
                 f"give different bits")
        worst = max(worst, _close(got, want, f"lag_update masked={masked}"))
    print(f"check lag_update B={b} N={n} M={m} names<{names} masked and "
          f"unmasked, bool/int64 and int32 inputs (the same bits): "
          f"max_abs_err={worst!r}")
    return worst


def check_select_slot(dev, gen, b, n, m):
    """Kernel against plain at ``[b, n, m]``, every strategy, masked and
    not (the packers pass no mask)."""
    import torch

    from repro_torch.kernels import binpack_select as bs

    for strategy in ("first", "best", "worst"):
        for masked in (False, True):
            # loads on a coarse grid so that ties are common
            loads = torch.randint(0, 9, (b, n, m), generator=gen,
                                  device=dev).float() / 8
            w = torch.randint(0, 5, (b, n), generator=gen,
                              device=dev).float() / 8
            k = torch.randint(0, m + 1, (b, n), generator=gen, device=dev)
            cap = torch.ones((b, n), device=dev)
            act = (torch.rand((b, n), generator=gen, device=dev) > 0.2
                   if masked else None)
            got = bs.select_slot_grid(loads, w, k, cap, strategy=strategy,
                                      active=act)
            want = bs.select_slot_plain(loads, w, k, cap, strategy=strategy,
                                        active=act)
            torch.cuda.synchronize()
            _exact(got, want, f"select_slot_grid [{b},{n},{m}] {strategy} "
                              f"masked={masked}")
    print(f"check select_slot_grid B={b} N={n} M={m} first/best/worst "
          f"masked and unmasked: exact")
    return 0.0


PACKERS = HEURISTICS + ("MWF", "MBF", "MWFP", "MBFP")


def plain_packer(name):
    """The registered packer's plain version (the per-insert walk of torch
    ops, launching nothing)."""
    from repro_torch.core.pack import modified_any_fit_plain, pack_plain
    from repro_torch.registry import get_spec

    hyper = get_spec(name).hyperparams
    if "fit" in hyper:
        return lambda *a, **k: modified_any_fit_plain(
            *a, fit=hyper["fit"], sort_key=hyper["sort_key"], **k)
    return lambda *a, **k: pack_plain(
        *a, strategy=hyper["strategy"], decreasing=hyper["decreasing"], **k)


def _pack_instances(dev, gen, rows, n, masked):
    """Rows with tied speeds (a coarse grid on even rows), oversized items
    (w > C), a few large consumers, and ``prev`` holding -1, lower
    negatives and names past the 2n + 2 of the name range."""
    import torch

    speeds = torch.rand((rows, n), generator=gen, device=dev)
    speeds[::2] = torch.round(speeds[::2] * 4) / 4
    speeds[1::3, 0] = 1.3 * CAPACITY
    prev = torch.randint(-3, 2 * n + 5, (rows, n), generator=gen, device=dev)
    prev[3::4] = torch.randint(0, 3, prev[3::4].shape, generator=gen,
                               device=dev)
    act = (torch.rand((rows, n), generator=gen, device=dev) > 0.3
           if masked else None)
    return speeds, prev, act


def check_pack_rows(dev, gen, rows, n):
    """The packing kernel against the plain packers at ``[rows, n]``: all
    12 packers, masked and unmasked; ``bin_of``, ``names`` and ``n_bins``
    equal, ``loads`` bit for bit."""
    import torch

    from repro_torch.registry import get_spec

    for masked in (False, True):
        speeds, prev, act = _pack_instances(dev, gen, rows, n, masked)
        for name in PACKERS:
            got = get_spec(name).packer(speeds, prev, CAPACITY, active=act)
            want = plain_packer(name)(speeds, prev, CAPACITY, active=act)
            torch.cuda.synchronize()
            what = f"pack_rows {name} [{rows}, {n}] masked={masked}"
            for f in ("bin_of", "names", "n_bins"):
                _exact(getattr(got, f), getattr(want, f), f"{what} {f}")
            _require(torch.equal(got.loads.view(torch.int32),
                                 want.loads.view(torch.int32)),
                     f"{what}: loads differ from the plain version's bits "
                     f"(max abs err {_max_err(got.loads, want.loads)})")
    print(f"check pack_rows R={rows} N={n} all 12 packers masked and "
          f"unmasked, ties, oversized items, prev -1 / negative / out of "
          f"range: exact, loads bit for bit")
    return 0.0


def _anneal_state(dev, gen, k, n, masked):
    """Random chain states over ``m = 2n + 2`` names: loads and counts
    from the assignment (inactive items excluded), some unassigned items
    (prev = -1), some oversized ones (w > C), lambda 0 or 4 per chain."""
    import torch

    m = 2 * n + 2
    speeds = torch.rand((k, n), generator=gen, device=dev) * 1.3 * CAPACITY
    assign = torch.randint(0, m, (k, n), generator=gen, device=dev)
    prev = torch.randint(-1, m, (k, n), generator=gen, device=dev)
    act = (torch.rand((k, n), generator=gen, device=dev) > 0.1 if masked
           else torch.ones((k, n), dtype=torch.bool, device=dev))
    w = torch.where(act, speeds, 0.0)
    loads = torch.zeros((k, m), device=dev).scatter_add_(1, assign, w)
    counts = torch.zeros((k, m), dtype=torch.int32, device=dev).scatter_add_(
        1, assign, act.to(torch.int32))
    lam = (torch.rand(k, generator=gen, device=dev) > 0.5).float() * 4.0
    cap = torch.full((k,), CAPACITY, device=dev)
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    return ((loads, counts, i32(assign), speeds, i32(prev), lam, cap),
            i32(act) if masked else None)


def check_move_eval(dev, gen, k, n):
    """Kernel against plain at ``[k, n, 2n + 2]``, bit for bit, masked and
    unmasked."""
    import torch

    from repro_torch.kernels import move_eval as me

    for masked in (False, True):
        args, act = _anneal_state(dev, gen, k, n, masked)
        got = me.move_delta_batch(*args, active=act)
        want = me.move_delta_reference(*args, active=act)
        torch.cuda.synchronize()
        _require(torch.equal(got, want),
                 f"move_eval [{k},{n},{2 * n + 2}] masked={masked}: kernel "
                 f"differs from its plain version (max abs err "
                 f"{_max_err(got, want)})")
        blocked = want >= me.MOVE_BLOCKED / 2
        _require(bool(blocked.any()) and bool((~blocked).any()),
                 "move_eval check instance has no blocked or no open move")
        del got, want
    print(f"check move_eval K={k} N={n} M={2 * n + 2} masked and unmasked, "
          f"prev=-1, oversized items, empty bins: bit-exact")
    return 0.0


def _step_inputs(dev, gen, rows, k, n, masked):
    """An anneal step's inputs over ``rows * k`` chains in random states
    (``_anneal_state``'s), a cost and best cost of their own, the step's
    Gumbel draws and a temperature schedule of 48 steps."""
    import torch

    from repro_torch.kernels import move_eval as me

    c, m = rows * k, 2 * n + 2
    (loads, counts, assign, speeds, prev, lam, cap), act = _anneal_state(
        dev, gen, c, n, masked)
    cost = torch.rand(c, generator=gen, device=dev) * n
    state = me.ChainState(assign, loads.contiguous(), counts, cost,
                          cost + 0.5, assign.clone())
    u = torch.rand((k, n * m + 1), generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-30)))
    temps = torch.logspace(0, -2, 48, device=dev)
    return state, (speeds, prev, lam, cap), act, gumbel, temps


def check_anneal_step(dev, gen, rows, k, n, steps=48):
    """The anneal step's kernel against its plain version over ``steps``
    steps from the same random states of ``rows * k`` chains, masked and
    unmasked (the masked run's draws on a coarse grid, so that moves tie
    in z and the "stay" draw ties the best move): every state tensor bit
    for bit after each step."""
    import torch

    from repro_torch.kernels import move_eval as me

    for masked in (False, True):
        got, args, act, _, temps = _step_inputs(dev, gen, rows, k, n, masked)
        want = me.ChainState(*(x.clone() for x in got))
        start = got.assign.clone()
        for t in range(steps):
            u = torch.rand((k, n * (2 * n + 2) + 1), generator=gen,
                           device=dev)
            g = -torch.log(-torch.log(u.clamp_(min=1e-30)))
            if masked:
                g = torch.round(g * 2) / 2
            me.anneal_step(got, *args, g, temps, t, active=act)
            me.anneal_step_reference(want, *args, g, temps, t, active=act)
            for name, a, b in zip(me.ChainState._fields, got, want):
                _require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                         f"anneal_step rows={rows} K={k} N={n} masked="
                         f"{masked} step {t}: {name} differs from the plain "
                         f"version's bits")
        torch.cuda.synchronize()
        _require(not torch.equal(got.assign, start),
                 "anneal_step check made no move")
    print(f"check anneal_step rows={rows} K={k} N={n} ({rows * k} chains) "
          f"{steps} steps masked (coarse draws) and unmasked: every state "
          f"tensor bit for bit")
    return 0.0


def _attn_close(got, want, dtype, what: str, tol=None) -> float:
    """The largest error of ``got`` against ``want``, held at ``tol`` (by
    default ATTN_TOL[dtype]) as both absolute and relative tolerance."""
    import torch

    err = _max_err(got, want)
    tol = ATTN_TOL[dtype] if tol is None else tol
    _require(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
             f"{what}: kernel disagrees with its plain version (max abs err "
             f"{err})")
    return err


def _normal(gen, shape, dtype, dev):
    import torch

    return torch.randn(shape, generator=gen, device=dev).to(
        getattr(torch, dtype))


def check_flash(dev, gen, b, h, kv, sq, skv, hd, causal=True):
    """Kernel against plain at q [b, h, sq, hd] over k/v [b, kv, skv, hd],
    float32 and bfloat16."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        q = _normal(gen, (b, h, sq, hd), dtype, dev)
        k = _normal(gen, (b, kv, skv, hd), dtype, dev)
        v = _normal(gen, (b, kv, skv, hd), dtype, dev)
        got = fa.flash_attention_fwd(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = _attn_close(got, want, dtype,
                          f"flash_attention q={[b, h, sq, hd]} kv={kv} "
                          f"skv={skv} causal={causal} {dtype}")
        print(f"check flash_attention q=[{b}, {h}, {sq}, {hd}] kv_heads={kv} "
              f"skv={skv} causal={causal} {dtype}: max_abs_err={err!r}")
        worst = max(worst, err)
        del q, k, v, got, want
    return worst


def check_decode(dev, gen, b, kv, g, s, hd, fills):
    """Kernel against plain at q [b, kv, g, hd] over caches [b, kv, s, hd]
    for each fill, float32 and bfloat16."""
    import torch

    from repro_torch.kernels import decode_attention as da

    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        q = _normal(gen, (b, kv, g, hd), dtype, dev)
        k = _normal(gen, (b, kv, s, hd), dtype, dev)
        v = _normal(gen, (b, kv, s, hd), dtype, dev)
        for fill in fills:
            clen = torch.tensor(fill, dtype=torch.int32, device=dev)
            got = da.decode_attention_fwd(q, k, v, clen)
            want = da.decode_attention_plain(q, k, v, clen)
            torch.cuda.synchronize()
            err = _attn_close(got, want, dtype, f"decode_attention q="
                              f"{[b, kv, g, hd]} S={s} fill={fill} {dtype}")
            print(f"check decode_attention q=[{b}, {kv}, {g}, {hd}] S={s} "
                  f"fill={fill} {dtype}: max_abs_err={err!r}")
            worst = max(worst, err)
        del q, k, v
    return worst


def check_decode_graph(dev, gen, b, kv, g, s, hd, fills):
    """One decode call at q [b, kv, g, hd] over caches [b, kv, s, hd],
    captured once in a CUDA graph and replayed after ``cache_len`` is set
    in place on the card to each fill: equal to the plain version each
    time, in float32 and bfloat16 (the split plan never reads the host's
    fill)."""
    import torch

    from repro_torch.kernels import decode_attention as da

    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        q = _normal(gen, (b, kv, g, hd), dtype, dev)
        k = _normal(gen, (b, kv, s, hd), dtype, dev)
        v = _normal(gen, (b, kv, s, hd), dtype, dev)
        clen = torch.tensor(fills[0], dtype=torch.int32, device=dev)
        side = side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            da.decode_attention_fwd(q, k, v, clen)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = da.decode_attention_fwd(q, k, v, clen)
        for fill in fills:
            clen.fill_(fill)
            graph.replay()
            torch.cuda.synchronize()
            err = _attn_close(got, da.decode_attention_plain(q, k, v, clen),
                              dtype, f"decode_attention graph replay at "
                              f"fill={fill} {dtype}")
            worst = max(worst, err)
        del q, k, v, got, graph
    print(f"check decode_attention q=[{b}, {kv}, {g}, {hd}] S={s}: one call "
          f"captured in a CUDA graph, replayed at fills {list(fills)} set on "
          f"the card, float32 and bfloat16: max_abs_err={worst!r}; "
          f"{da.decode_splits(b, kv, s)} splits a (batch row, kv head)")
    return worst


def _tailed_inputs(gen, b, kv, g, s, w, hd, dtype, dev):
    """q [b, kv, g, hd], main caches [b, kv, s, hd] and tails [b, kv, w,
    hd], standard normal."""
    return (_normal(gen, (b, kv, g, hd), dtype, dev),
            _normal(gen, (b, kv, s, hd), dtype, dev),
            _normal(gen, (b, kv, s, hd), dtype, dev),
            _normal(gen, (b, kv, w, hd), dtype, dev),
            _normal(gen, (b, kv, w, hd), dtype, dev))


def check_decode_tailed(dev, gen, b, kv, g, s, w, hd, fills):
    """The decode kernel's tailed entry against its plain version (the
    reference's two-part merge) at q [b, kv, g, hd] over main caches [b,
    kv, s, hd] and tails [b, kv, w, hd] for each fill (``main_len = 0``
    below w, ``tail_len = 0`` at multiples of w), float32 and bfloat16."""
    import torch

    from repro_torch.kernels import decode_attention as da

    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        q, km, vm, kt, vt = _tailed_inputs(gen, b, kv, g, s, w, hd, dtype,
                                           dev)
        for fill in fills:
            clen = torch.tensor(fill, dtype=torch.int32, device=dev)
            got = da.decode_attention_tailed_fwd(q, km, vm, kt, vt, clen, w)
            want = da.decode_attention_tailed_plain(q, km, vm, kt, vt, clen,
                                                    w)
            torch.cuda.synchronize()
            err = _attn_close(got, want, dtype, f"decode_attention_tailed "
                              f"q={[b, kv, g, hd]} S={s} W={w} fill={fill} "
                              f"{dtype}")
            print(f"check decode_attention_tailed q=[{b}, {kv}, {g}, {hd}] "
                  f"S={s} W={w} fill={fill} (main {fill // w * w}, tail "
                  f"{fill % w + 1}) {dtype}: max_abs_err={err!r}")
            worst = max(worst, err)
        del q, km, vm, kt, vt
    return worst


def check_decode_tailed_graph(dev, gen, b, kv, g, s, w, hd, fills):
    """One tailed decode call captured in a CUDA graph and replayed at
    each fill set in place on the card, the tail flushed into the main
    cache (``models.flush_kv_tail``, in place) and refilled with new rows
    whenever a fill reaches a multiple of w: equal to the plain version at
    every replay, float32 and bfloat16."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import flush_kv_tail

    cfg = dataclasses.replace(configs.get(TAILED), decode_tail_window=w)
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        q, km, vm, kt, vt = _tailed_inputs(gen, b, kv, g, s, w, hd, dtype,
                                           dev)
        clen = torch.tensor(fills[0], dtype=torch.int32, device=dev)
        state = {"cache_len": clen, "kv": {"k": km[None], "v": vm[None]},
                 "tail": {"k": kt[None], "v": vt[None]}}
        call = lambda: da.decode_attention_tailed_fwd(  # noqa: E731
            q, km, vm, kt, vt, clen, w)
        side = side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = call()
        for fill in fills:
            clen.fill_(fill)
            if fill and fill % w == 0:
                flush_kv_tail(cfg, state)
                _require(not bool(kt.any()), "flush_kv_tail left the tail")
                kt.copy_(_normal(gen, kt.shape, dtype, dev))
                vt.copy_(_normal(gen, vt.shape, dtype, dev))
            graph.replay()
            torch.cuda.synchronize()
            err = _attn_close(got, da.decode_attention_tailed_plain(
                q, km, vm, kt, vt, clen, w), dtype, f"decode_attention_tailed"
                f" graph replay at fill={fill} {dtype}")
            worst = max(worst, err)
        del q, km, vm, kt, vt, got, graph, state
    print(f"check decode_attention_tailed q=[{b}, {kv}, {g}, {hd}] S={s} "
          f"W={w}: one call captured in a CUDA graph, replayed at fills "
          f"{list(fills)} set on the card, the tail flushed and refilled at "
          f"{[f for f in fills if f and f % w == 0]}, float32 and bfloat16: "
          f"max_abs_err={worst!r}")
    return worst


def check_new_calls(dev, gen) -> dict:
    """The calls paths P and Q add, each kernel against its plain version:
    the flash forward at 64 query heads over 8 KV heads (P1, Q1), the
    decode kernel at G = 8 query rows a KV head (P2, Q2's control), eager
    at several fills and replayed from a graph, and the tailed entry at G
    = 4 and G = 8 (Q2's call) at fills with ``main_len = 0``, ``cache_len
    = W - 1``, ``W`` (``tail_len = 0``), one mid-way and the last, eager
    and replayed across flushes, and at a window that does not divide the
    cache.  Returns the largest error by kernel wrapper."""
    s, w = D_PROMPT + D_GEN, Q_WINDOW
    fills = (0, 100, w - 1, w, 700, s - 1)
    return {
        "flash_attention_fwd": check_flash(dev, gen, D_BATCH, 64, 8,
                                           D_PROMPT, D_PROMPT, 128),
        "decode_attention_fwd": max(
            check_decode(dev, gen, D_BATCH, 8, 8, s, 128, fills),
            check_decode_graph(dev, gen, D_BATCH, 8, 8, s, 128,
                               (17, 700, s - 1))),
        "decode_attention_tailed_fwd": max(
            check_decode_tailed(dev, gen, D_BATCH, 8, 8, s, w, 128, fills),
            check_decode_tailed(dev, gen, D_BATCH, 8, 4, s, w, 128, fills),
            check_decode_tailed(dev, gen, 2, 8, 8, s, 100, 128,
                                (99, 100, 1099, 1100, s - 1)),
            check_decode_tailed(dev, gen, 2, 8, 8, 64, Q_AGREE_WINDOW, 128,
                                (0, 15, 16, 33, 63)),          # agreement
            check_decode_tailed_graph(dev, gen, D_BATCH, 8, 8, s, w, 128,
                                      (100, w - 1, w, w + 5, 2 * w - 1,
                                       2 * w, s - 1)),
            check_decode_tailed_graph(dev, gen, D_BATCH, 8, 4, s, w, 128,
                                      (0, w - 1, w, 700)))}


def check_sass(lib) -> None:
    """``HGMMA`` (wgmma) and ``UTMALDG`` (TMA tile loads) in every
    instantiation of the bfloat16 flash kernel and of the bfloat16
    backward's two kernels, and no ``HGMMA`` in the float32 forward or
    backward, read from the built library's SASS."""
    import shutil

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    counts = {}
    for name, lines in funcs.items():
        if "flash_attention_bf16_kernel" in name:
            body = "\n".join(lines)
            counts[name] = (body.count("HGMMA"), body.count("UTMALDG"))
    _require(len(counts) == len(HEAD_DIMS),
             f"sass: {len(counts)} flash_attention_bf16 kernels in {lib}, "
             f"want one for each head dim of {HEAD_DIMS}")
    _require(all(h and t for h, t in counts.values()),
             f"sass: a flash_attention_bf16 kernel lacks HGMMA or UTMALDG: "
             f"{counts}")
    f32 = [n for n in funcs if "flash_attention_kernel" in n]
    _require(f32 and not any("HGMMA" in "\n".join(funcs[n]) for n in f32),
             "sass: the float32 flash kernel is missing or runs HGMMA")
    print(f"check sass: {len(counts)} flash_attention_bf16 kernels, (HGMMA, "
          f"UTMALDG) instructions each: {sorted(counts.values())}; "
          f"{len(f32)} float32 flash kernels without HGMMA")
    # the backward: both bf16 kernels at every head dim they are built
    # for on wgmma and TMA; the float32 CUDA-core kernels without HGMMA
    bwd = {n: ("\n".join(funcs[n]).count("HGMMA"),
               "\n".join(funcs[n]).count("UTMALDG"))
           for n in funcs if "_wgmma_kernel" in n and "flash_bwd_" in n}
    want = 2 * len(fa.WGMMA_BWD_HEAD_DIMS)
    _require(len(bwd) == want and all(h and t for h, t in bwd.values()),
             f"sass: want {want} bf16 flash backward kernels with HGMMA and "
             f"UTMALDG; got {bwd}")
    f32_bwd = [n for n in funcs if "flash_bwd_dq_kernelIf" in n
               or "flash_bwd_dkv_kernelIf" in n]
    _require(len(f32_bwd) == 2 * len(HEAD_DIMS)
             and not any("HGMMA" in "\n".join(funcs[n]) for n in f32_bwd),
             f"sass: want {2 * len(HEAD_DIMS)} float32 flash backward "
             f"kernels without HGMMA; got {len(f32_bwd)}")
    print(f"check sass: {len(bwd)} bf16 flash backward kernels, (HGMMA, "
          f"UTMALDG) each: {sorted(bwd.values())}; {len(f32_bwd)} float32 "
          f"flash backward kernels without HGMMA")


def check_ptxas() -> None:
    """Every ``loop_fused`` instantiation (n = 1..14) in the build's
    ``-Xptxas -v`` report with a 0-byte stack frame and no spill: its
    rows' state lives in registers; every ``rwkv6_wkv`` head size (16, 32,
    64, 128), serving's kernel and training's checkpoint variant, with no
    spill (32 state registers a thread); the bfloat16 flash backward's dq
    and dkv kernels at hd 64 and 128 with no spill; every
    ``rwkv6_wkv_bwd`` head size with no spill (its rows of G and S in
    registers)."""
    import re

    from repro_torch.kernels import _build

    report = _build.ptxas_report().read_text()
    found = {}
    for name, stack, st, ld, regs in re.findall(
            r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
            r"(\d+) registers", report):
        m = re.search(r"loop_fused_kernelILi(\d+)E", name)
        if m:
            found[int(m.group(1))] = (int(stack), int(st), int(ld),
                                      int(regs))
    _require(sorted(found) == list(range(1, 15)),
             f"ptxas: loop_fused instantiations {sorted(found)}, want 1..14")
    bad = {n: v for n, v in found.items() if v[:3] != (0, 0, 0)}
    _require(not bad, f"ptxas: loop_fused with a stack frame or spills "
                      f"(n: stack, spill stores, spill loads, registers): "
                      f"{bad}")
    print(f"check ptxas: loop_fused n = 1..14, 0-byte stack frame and no "
          f"spill each; registers {[found[n][3] for n in range(1, 15)]}")
    wkv = {}
    for name, stack, st, ld, regs in re.findall(
            r"Function properties for (\S+rwkv6_wkv_kernelILi(?:\d+)E\S*)\n"
            r"\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads\n.*?Used (\d+) registers", report):
        m = re.search(r"rwkv6_wkv_kernelILi(\d+)ELb([01])E", name)
        key = f"hd {m.group(1)}" + (" ckpt" if m.group(2) == "1" else "")
        wkv[key] = (int(stack), int(st), int(ld), int(regs))
    want = sorted(f"hd {hd}{c}" for hd in (16, 32, 64, 128)
                  for c in ("", " ckpt"))
    _require(sorted(wkv) == want,
             f"ptxas: rwkv6_wkv instantiations {sorted(wkv)}, want {want}")
    bad = {k: v for k, v in wkv.items() if v[1:3] != (0, 0)}
    _require(not bad, f"ptxas: rwkv6_wkv spills (stack, spill stores, "
                      f"spill loads, registers): {bad}")
    print(f"check ptxas: rwkv6_wkv hd = 16, 32, 64, 128, serving's kernel "
          f"and the checkpoint variant (stack frame, spill stores, spill "
          f"loads, registers): {dict(sorted(wkv.items()))}")
    bwd = {}
    for name, stack, st, ld, regs in re.findall(
            r"Function properties for (\S+flash_bwd_d(?:q|kv)_wgmma_kernel"
            r"ILi(?:\d+)E\S*)\n\s*(\d+) bytes stack frame, (\d+) bytes spill "
            r"stores, (\d+) bytes spill loads\n.*?Used (\d+) registers",
            report):
        m = re.search(r"flash_bwd_(d(?:q|kv))_wgmma_kernelILi(\d+)E", name)
        bwd[f"{m.group(1)} hd {m.group(2)}"] = (int(stack), int(st), int(ld),
                                                int(regs))
    _require(len(bwd) == 4, f"ptxas: flash backward wgmma kernels {bwd}, "
                            f"want dq and dkv at hd 64 and 128")
    bad = {k: v for k, v in bwd.items() if v[1:3] != (0, 0)}
    _require(not bad, f"ptxas: the bf16 flash backward spills (stack, spill "
                      f"stores, spill loads, registers): {bad}")
    print(f"check ptxas: bf16 flash backward (stack frame, spill stores, "
          f"spill loads, registers): {dict(sorted(bwd.items()))}")
    wkv_bwd = {}
    for name, stack, st, ld, regs in re.findall(
            r"Function properties for (\S+rwkv6_wkv_bwd_kernelILi(?:\d+)E"
            r"\S*)\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads\n.*?Used (\d+) registers", report):
        hd = int(re.search(r"rwkv6_wkv_bwd_kernelILi(\d+)E", name).group(1))
        wkv_bwd[hd] = (int(stack), int(st), int(ld), int(regs))
    _require(sorted(wkv_bwd) == [16, 32, 64, 128],
             f"ptxas: rwkv6_wkv_bwd instantiations {sorted(wkv_bwd)}, want "
             f"16..128")
    bad = {hd: v for hd, v in wkv_bwd.items() if v[1:3] != (0, 0)}
    _require(not bad, f"ptxas: rwkv6_wkv_bwd spills (its rows of G and S "
                      f"live in registers; hd: stack, spill stores, spill "
                      f"loads, registers): {bad}")
    print(f"check ptxas: rwkv6_wkv_bwd hd = 16, 32, 64, 128 (hd: stack "
          f"frame, spill stores, spill loads, registers): "
          f"{dict(sorted(wkv_bwd.items()))}")


#: the serving paths' kernel wrappers: each phase of a serving path
#: launches its own kernel and none of the others
SERVING_KERNELS = ("flash_attention_fwd", "decode_attention_fwd",
                   "decode_attention_tailed_fwd", "rwkv6_wkv_fwd")


def _heads(cfg) -> str:
    if cfg.rwkv:
        return (f"heads={cfg.d_model // cfg.rwkv_head_size}x"
                f"{cfg.rwkv_head_size}")
    out = f"heads={cfg.n_heads}/{cfg.n_kv_heads}"
    if cfg.moe:
        out += (f" experts={cfg.n_experts} top-{cfg.experts_per_token} "
                f"expert_ff={cfg.expert_ff} shared={cfg.n_shared_experts}"
                f" moe_every={cfg.moe_every}")
    if cfg.attn_layer_period:
        out += (f" attention 1 in {cfg.attn_layer_period} (offset "
                f"{cfg.attn_layer_offset}), the rest Mamba")
    return out


def _kernel_layers(cfg) -> int:
    """The layers that launch a serving kernel: every RWKV layer (the WKV
    kernel), else the attention layers (one a period of a hybrid
    model)."""
    from repro_torch.models.transformer import attention_layers

    return cfg.n_layers if cfg.rwkv else len(attention_layers(cfg))


def step_bytes(cfg, params, state, fill: int) -> dict:
    """The bytes one decode step at ``fill`` must move: every weight but
    the embedding table, of which only the batch's rows are read (an
    embeddings model's adapter is read whole; a MoE layer at decode
    computes every expert's capacity slot, so all its experts are read);
    the filled KV cache read once (a tailed state's main rows and tail
    rows, as many); a recurrent state (Mamba, RWKV) read and written
    once."""
    from repro_torch.models import param_bytes

    table = params["embedding"].get("table")
    weights = param_bytes(params)
    if table is not None and not cfg.tie_embeddings:
        weights -= param_bytes(table)
    kv = state.get("kv")
    kv_read = 0 if kv is None else 2 * param_bytes(kv["k"]) * (fill + 1) \
        // kv["k"].shape[3]
    recurrent = 2 * param_bytes(state.get("mamba") or state.get("rwkv")
                                or [])
    return {"weights": weights, "kv": kv_read, "state": recurrent,
            "bound_ms": (weights + kv_read + recurrent)
            / HBM_BW * 1e3}


def _launched(kernel: str, want: int, what: str) -> int:
    """The launches of ``kernel`` since the counts were zeroed; fails
    unless they are ``want`` and no other serving kernel launched."""
    from repro_torch.kernels import _build

    counts = _build.launch_counts()
    _require(counts[kernel] == want,
             f"{what}: {kernel} launched {counts[kernel]} times, want {want}")
    others = {k: counts[k] for k in SERVING_KERNELS
              if k != kernel and counts[k]}
    _require(not others, f"{what} launched {others}")
    return counts[kernel]


def run_serving_path(dev, seed, tag, name, prefill_kernel, decode_kernel,
                     layers=None):
    """``name`` serving at full width in bfloat16 (full depth, or
    ``layers`` layers): ``tag``1 prefills D_BATCH x D_PROMPT tokens (one
    ``prefill_kernel`` launch a kernel layer: every layer of a dense,
    MoE or RWKV model, the attention layers of a hybrid one), ``tag``2 is
    greedy generation of D_GEN tokens after the first D_FORCED of them
    through ``SharedModel.generate`` (one ``decode_kernel`` launch a
    kernel layer a step).  Returns the two phases' launch counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_decode_state, param_bytes
    from repro_torch.serving import SharedModel

    print(f"path {tag}: {name} serving")
    cfg, params = _bf16_model(name, layers, dev, seed)
    per_step = _kernel_layers(cfg)
    gen = torch.Generator(dev).manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (D_BATCH, D_PROMPT),
                            generator=gen, device=dev)
    n, prefill = _timed_prefill(f"{tag}1", cfg, params, {"inputs": prompts},
                                dev, prefill_kernel)
    launches = {f"{tag}1": n}

    # greedy generation through the decode path, from the first D_FORCED
    # tokens, in a cache of D_PROMPT + D_GEN positions
    cache = D_PROMPT + D_GEN
    first = prefill(params, {"inputs": prompts[:, :D_FORCED]}).argmax(-1)
    model = SharedModel(cfg, max_len=cache, max_batch=D_BATCH, device=dev,
                        params=params)
    host_prompts = prompts[:, :D_FORCED].cpu().tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = model.generate(host_prompts, D_GEN)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = D_FORCED + D_GEN
    launches[f"{tag}2"] = _launched(decode_kernel, per_step * steps,
                                    f"path {tag}2")
    _require(out.shape == (D_BATCH, D_GEN) and (out >= 0).all()
             and (out < cfg.vocab_size).all(),
             f"path {tag}2: generated tokens {out.shape} out of range")
    agree = int((out[:, 0] == first.cpu().numpy()).sum())
    del model
    state = init_decode_state(cfg, D_BATCH, cache, dev)
    print(f"path {tag}2 (generate): {D_BATCH} requests x ({D_FORCED} "
          f"teacher-forced + {D_GEN} greedy) steps in a {cache}-position "
          f"cache, decode state "
          f"{param_bytes(state)} bytes: wall_s={wall!r} "
          f"ms_per_decode_step={wall / steps * 1e3!r} "
          f"decode_tokens_per_s={D_BATCH * steps / wall!r} "
          f"generated_tokens_per_s={D_BATCH * D_GEN / wall!r} "
          f"peak_mem_bytes={peak} "
          f"launches={{'{decode_kernel}': {launches[tag + '2']}}}")
    print(f"  first generated token equals the argmax of a prefill of the "
          f"same {D_FORCED} tokens in {agree} of {D_BATCH} requests (bf16, "
          f"prefill and decode paths: printed, not required)")
    print(f"  tokens[0, :16]={np.asarray(out[0, :16]).tolist()}")

    # one decode step at the cache's last fill: its device time replayed
    # as a CUDA graph (no host work in it) and the torch ops it dispatches
    state["cache_len"].fill_(cache - 1)
    step = make_serve_step(cfg, dev)
    tok = prompts[:, 0]
    _step_report(f"{tag}2", cfg, params, state,
                 lambda: step(params, state, {"inputs": tok}), cache - 1,
                 wall / steps * 1e3)
    return launches


def _op_counter():
    """A dispatch mode whose ``n`` counts the torch operators dispatched
    inside its block."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return OpCount()


@contextlib.contextmanager
def _swapped(plain):
    """Within the block, each ``(module, attribute, plain version)`` of
    ``plain`` has the module's kernel attribute replaced by its plain
    version (on the card)."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in plain]
    for mod, attr, fn in plain:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def _topk_margins(margins: list):
    """Within the block, every MoE routing call appends to ``margins`` the
    smallest gap between a token's k-th and (k+1)-th expert probability (a
    device scalar: no sync).  A gap near a float32 ulp lets a last-bit
    difference upstream flip an expert choice, which tells such a flip
    from a fault."""
    from repro_torch.models import moe

    route = moe.route

    def recorded(p, cfg, x):
        probs, gate, eidx = route(p, cfg, x)
        top = probs.sort(dim=-1, descending=True).values
        k = cfg.experts_per_token
        margins.append((top[..., k - 1] - top[..., k]).min())
        return probs, gate, eidx

    with _swapped([(moe, "route", recorded)]):
        yield


def no_drop(cfg):
    """``cfg`` with the capacity factor at which no routed entry is ever
    dropped, prefill or decode: n_experts / experts_per_token (an expert
    then holds a slot for every token of its group; 8 for jamba, 15 for
    qwen2-moe, whose decode groups of 2 tokens get 1 slot an expert at
    8).  The reference's decode-against-prefill property is defined only
    there (``tests/test_jamba_consistency.py``)."""
    import dataclasses

    if not cfg.moe:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)


def agreement(dev, seed, name, plain, layers=4, batch=2, prompt=48,
              steps=16):
    """``name`` at full width with ``layers`` layers in float32: prefill
    and ``prompt`` teacher-forced + ``steps`` greedy decode steps with the
    kernels, then with their plain versions on the card (``plain`` as
    :func:`_swapped` takes it): logits within 1e-4, the same tokens (a MoE
    model at its own capacity factor, drops included; the smallest top-k
    margin of its routing is printed).  Then the reference's own property
    (``tests/test_arch_smoke.py``): decoding token by token gives the
    full-sequence logits at every prompt position, within 2e-2 (a MoE
    model at :func:`no_drop`'s capacity factor).  RWKV's bonus and decay
    are perturbed from their init constants (u = 0 would leave the bonus
    term out).  The peak memory is printed; the same prefill on the CPU
    only where the weights are below ``HOST_CHECK_BYTES``."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state, init_params, param_bytes
    from repro_torch.models.layers import embed_inputs, logits_fn
    from repro_torch.models.transformer import backbone

    cfg = dataclasses.replace(configs.get(name), n_layers=layers,
                              dtype="float32", param_dtype="float32")
    # cuBLAS keeps a workspace for each stream it has run on (graph_ms
    # captures on a new stream at each call): free them, and count what
    # earlier paths still hold besides
    held = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        torch.cuda.empty_cache()
    workspaces = held - torch.cuda.memory_allocated()
    held -= workspaces
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=seed + 1, device=dev)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    if cfg.rwkv:
        for lp in params["layers"]:
            tm = lp["tm"]
            tm["bonus_u"] = torch.randn(tm["bonus_u"].shape, generator=gen,
                                        device=dev) * 0.5
            tm["decay_w0"] = torch.rand(tm["decay_w0"].shape, generator=gen,
                                        device=dev) * 4.5 - 4.0
    toks = torch.randint(1, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)

    def run(cfg):
        logits = [make_prefill_step(cfg, dev)(params, {"inputs": toks})]
        step = make_serve_step(cfg, dev)
        state = init_decode_state(cfg, batch, prompt + steps, dev)
        forced = []
        for t in range(prompt):
            out, state = step(params, state, {"inputs": toks[:, t]})
            forced.append(out)
        cur, chosen = out.argmax(-1), []
        logits.append(out)
        for _ in range(steps - 1):
            chosen.append(cur)
            out, state = step(params, state, {"inputs": cur})
            logits.append(out)
            cur = out.argmax(-1)
        chosen.append(cur)
        torch.cuda.synchronize()
        return (torch.stack(logits), torch.stack(chosen, 1),
                torch.stack(forced, 1))

    margins = []
    with _topk_margins(margins):
        got, got_tok, forced = run(cfg)
        with _swapped(plain):
            want, want_tok, _ = run(cfg)
    err = _max_err(got, want)
    margin = (f"; smallest top-{cfg.experts_per_token} routing margin "
              f"{float(torch.stack(margins).min())!r}" if margins else "")
    _require(torch.equal(got_tok, want_tok),
             f"{cfg.name} agreement: greedy tokens differ between the "
             f"kernels and their plain versions{margin}")
    _require(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
             f"{cfg.name} agreement: logits differ by {err} (> 1e-4)"
             f"{margin}")
    print(f"agreement {cfg.name} d_model={cfg.d_model} {layers} layers "
          f"float32, prefill {batch} x {prompt} then {prompt} teacher-forced "
          f"+ {steps} greedy decode steps: kernels vs plain versions on the "
          f"card max_abs_err={err!r} (logits absmax "
          f"{float(want.abs().max())!r}), tokens equal{margin}")
    whole = no_drop(cfg)
    if whole is not cfg:
        forced = run(whole)[2]
    positions = torch.arange(prompt, device=dev).expand(batch, prompt)
    with torch.no_grad():
        x = embed_inputs(params["embedding"], whole, toks)
        full = logits_fn(params, whole,
                         backbone(params, whole, x, positions))
    drift = _max_err(forced, full)
    _require(torch.allclose(forced, full, rtol=2e-2, atol=2e-2),
             f"{cfg.name} decode vs prefill: logits differ by {drift} "
             f"(> 2e-2)")
    print(f"  decode vs prefill at all {prompt} positions (kernels"
          f"{f', capacity_factor {whole.capacity_factor}' if cfg.moe else ''}"
          f"): max_abs_diff={drift!r} (within 2e-2)")
    weights = param_bytes(params)
    print(f"  float32 weights {weights} bytes; peak_mem_bytes="
          f"{torch.cuda.max_memory_allocated()} ({held} held before, after "
          f"{workspaces} bytes of cuBLAS workspaces were freed)")
    if weights > HOST_CHECK_BYTES:
        print(f"  card vs CPU prefill: skipped ({weights} bytes of weights "
              f"> {HOST_CHECK_BYTES:.3g})")
        return
    # the same prefill on the host's CPU (plain versions): how far the
    # card's float32 (norms, products, kernels) drifts from it
    host = make_prefill_step(cfg, "cpu")(_tree_to(params, "cpu"),
                                         {"inputs": toks.cpu()})
    drift = _max_err(got[0].cpu(), host)
    same = int((got[0].argmax(-1).cpu() == host.argmax(-1)).sum())
    print(f"  card vs CPU, float32 prefill logits: max_abs_diff={drift!r}, "
          f"argmax equal in {same} of {batch} (printed, not required)")


def _tree_to(tree, device):
    """A copy of a parameter tree (dicts, lists, tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def attention_rows(dev, seed, launches, errs):
    """Kernel rows of flash_attention (path D1's call; M1's 16 heads of
    16 KV heads too) and decode_attention (D2's call at its cache's last
    fill, as D2's replayed step makes it; M2's one query head a KV head
    and J2's short cache too), with the launches of paths D, M and N
    (``launches`` by phase)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(dev).manual_seed(seed)
    b, h, kv, s, hd = D_BATCH, 32, 8, D_PROMPT, 128
    q = _normal(gen, (b, h, s, hd), "bfloat16", dev)
    k = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    v = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    kern = lambda: fa.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(  # noqa: E731
        q, k, v, causal=True)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    bnd, by = bound_ms(2 * (q.numel() + k.numel() + v.numel() + q.numel()),
                       4 * b * h * s * s * hd / 2, PEAK_FLOPS_BF16)
    rows = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
        replaces="src/repro/kernels/flash_attention.py:73",
        launches=sum(launches[p] for p in ("D1", "M1", "N1", "P1", "Q1")),
        launches_by_path={p: launches[p]
                          for p in ("D1", "M1", "N1", "P1", "Q1")},
        max_abs_err=errs["flash_attention_fwd"], ms=graph_ms(kern, 10),
        plain_ms=graph_ms(plain, 3), bound_ms=bnd, bound_by=by,
        library_ms=graph_ms(lib, 10), wrapper_ms=cuda_ms(kern, 10)[0],
        calls=[])]
    # the same call with its lse stored (training's forward): the same
    # output bits, its time beside the serving call's
    with_lse = lambda: fa.flash_attention_fwd(  # noqa: E731
        q, k, v, causal=True, return_lse=True)
    _require(torch.equal(with_lse()[0], kern()),
             "flash_attention: the output with lse stored differs")
    rows[0]["calls"].append(dict(
        at="D1's shape with its lse stored (training's call)",
        ms=graph_ms(with_lse, 10), wrapper_ms=cuda_ms(with_lse, 10)[0]))
    del q, k, v
    # the float32 kernel (csrc/flash_attention.cu, on the CUDA cores) at
    # the same shape, against the float32 peak outside the tensor cores
    q = _normal(gen, (b, h, s, hd), "float32", dev)
    k = _normal(gen, (b, kv, s, hd), "float32", dev)
    v = _normal(gen, (b, kv, s, hd), "float32", dev)
    _attn_close(kern(), plain(), "float32", "flash_attention float32 at "
                                            "D1's shape")
    bnd, by = bound_ms(4 * (q.numel() + k.numel() + v.numel() + q.numel()),
                       4 * b * h * s * s * hd / 2)
    rows[0]["calls"].append(dict(
        at="D1's shape in float32", ms=graph_ms(kern, 5),
        plain_ms=graph_ms(plain, 2), bound_ms=bnd, bound_by=by,
        library_ms=graph_ms(lib, 5), wrapper_ms=cuda_ms(kern, 5)[0],
        source="src/repro_torch/kernels/csrc/flash_attention.cu"))
    del q, k, v
    # path M1's call: 16 query heads over 16 KV heads (no grouping)
    q = _normal(gen, (b, 16, s, hd), "bfloat16", dev)
    k = _normal(gen, (b, 16, s, hd), "bfloat16", dev)
    v = _normal(gen, (b, 16, s, hd), "bfloat16", dev)
    bnd, by = bound_ms(2 * (q.numel() + k.numel() + v.numel() + q.numel()),
                       4 * b * 16 * s * s * hd / 2, PEAK_FLOPS_BF16)
    rows[0]["calls"].append(dict(
        at="path M1's call (16 over 16 heads)", ms=graph_ms(kern, 10),
        plain_ms=graph_ms(plain, 3), bound_ms=bnd, bound_by=by,
        library_ms=graph_ms(lib, 10), wrapper_ms=cuda_ms(kern, 10)[0]))
    del q, k, v
    # paths P1's and Q1's call: 64 query heads over 8 KV heads
    q = _normal(gen, (b, 64, s, hd), "bfloat16", dev)
    k = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    v = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    bnd, by = bound_ms(2 * (q.numel() + k.numel() + v.numel() + q.numel()),
                       4 * b * 64 * s * s * hd / 2, PEAK_FLOPS_BF16)
    rows[0]["calls"].append(dict(
        at="paths P1's and Q1's call (64 over 8 heads)",
        ms=graph_ms(kern, 10), plain_ms=graph_ms(plain, 3), bound_ms=bnd,
        bound_by=by, library_ms=graph_ms(lib, 10),
        wrapper_ms=cuda_ms(kern, 10)[0]))
    del q, k, v

    g, smax = h // kv, D_PROMPT + D_GEN
    fill = smax - 1
    q = _normal(gen, (b, kv, g, hd), "bfloat16", dev)
    kc = _normal(gen, (b, kv, smax, hd), "bfloat16", dev)
    vc = _normal(gen, (b, kv, smax, hd), "bfloat16", dev)
    clen = torch.tensor(fill, dtype=torch.int32, device=dev)
    q4 = q.reshape(b, h, 1, hd)
    kern = lambda: da.decode_attention_fwd(q, kc, vc, clen)  # noqa: E731
    plain = lambda: da.decode_attention_plain(q, kc, vc, clen)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, kc[:, :, :fill + 1], vc[:, :, :fill + 1], enable_gqa=True)
    _require(torch.allclose(lib().reshape(q.shape).float(), kern().float(),
                            rtol=2e-2, atol=2e-2),
             "decode_attention and scaled_dot_product_attention disagree")
    bnd, by = bound_ms(2 * (2 * q.numel() + 2 * b * kv * (fill + 1) * hd),
                       4 * b * h * (fill + 1) * hd, PEAK_FLOPS_BF16)
    rows.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:65",
        launches=sum(launches[p] for p in ("D2", "M2", "N2", "J2", "P2",
                                            "Q2_control")),
        launches_by_path={p: launches[p] for p in ("D2", "M2", "N2", "J2",
                                                   "P2", "Q2_control")},
        max_abs_err=errs["decode_attention_fwd"], ms=graph_ms(kern, 200),
        plain_ms=graph_ms(plain, 50), bound_ms=bnd, bound_by=by,
        library_ms=graph_ms(lib, 200), wrapper_ms=cuda_ms(kern, 200)[0],
        calls=[]))
    del q, kc, vc, q4

    # path M2's call: one query head over each of 16 KV heads
    q = _normal(gen, (b, 16, 1, hd), "bfloat16", dev)
    kc = _normal(gen, (b, 16, smax, hd), "bfloat16", dev)
    vc = _normal(gen, (b, 16, smax, hd), "bfloat16", dev)
    q4 = q.reshape(b, 16, 1, hd)
    _require(torch.allclose(lib().reshape(q.shape).float(), kern().float(),
                            rtol=2e-2, atol=2e-2),
             "decode_attention and scaled_dot_product_attention disagree "
             "at path M2's call")
    bnd, by = bound_ms(2 * (2 * q.numel() + 2 * b * 16 * (fill + 1) * hd),
                       4 * b * 16 * (fill + 1) * hd, PEAK_FLOPS_BF16)
    rows[-1]["calls"].append(dict(
        at="path M2's call (1 query head over each of 16 KV heads)",
        ms=graph_ms(kern, 200), plain_ms=graph_ms(plain, 50), bound_ms=bnd,
        bound_by=by, library_ms=graph_ms(lib, 200),
        wrapper_ms=cuda_ms(kern, 200)[0]))
    del q, kc, vc, q4

    # paths P2's and Q2's control call: 8 query heads over each of 8 KV
    # heads (the kernel's 8-row group)
    q = _normal(gen, (b, kv, 8, hd), "bfloat16", dev)
    kc = _normal(gen, (b, kv, smax, hd), "bfloat16", dev)
    vc = _normal(gen, (b, kv, smax, hd), "bfloat16", dev)
    q4 = q.reshape(b, kv * 8, 1, hd)
    _require(torch.allclose(lib().reshape(q.shape).float(), kern().float(),
                            rtol=2e-2, atol=2e-2),
             "decode_attention and scaled_dot_product_attention disagree "
             "at path P2's call")
    bnd, by = bound_ms(2 * (2 * q.numel() + 2 * b * kv * (fill + 1) * hd),
                       4 * b * kv * 8 * (fill + 1) * hd, PEAK_FLOPS_BF16)
    rows[-1]["calls"].append(dict(
        at=f"paths P2's and Q2's control call (8 query heads over "
           f"each of 8 KV heads, fill {fill})",
        ms=graph_ms(kern, 200), plain_ms=graph_ms(plain, 50), bound_ms=bnd,
        bound_by=by, library_ms=graph_ms(lib, 200),
        wrapper_ms=cuda_ms(kern, 200)[0]))
    del q, kc, vc, q4

    # path J2's call: SharedModel(max_len=16) at its last serve step of a
    # generate call (cache_len 3: 4 of 16 positions filled)
    smax, fill = 16, 3
    q = _normal(gen, (b, kv, g, hd), "bfloat16", dev)
    kc = _normal(gen, (b, kv, smax, hd), "bfloat16", dev)
    vc = _normal(gen, (b, kv, smax, hd), "bfloat16", dev)
    clen = torch.tensor(fill, dtype=torch.int32, device=dev)
    q4 = q.reshape(b, h, 1, hd)
    bnd, by = bound_ms(2 * (2 * q.numel() + 2 * b * kv * (fill + 1) * hd),
                       4 * b * h * (fill + 1) * hd, PEAK_FLOPS_BF16)
    rows[-1]["calls"].append(dict(
        at="path J2's call (cache 16, 4 filled)",
        ms=graph_ms(kern, 200), plain_ms=graph_ms(plain, 50), bound_ms=bnd,
        bound_by=by, library_ms=graph_ms(lib, 200),
        wrapper_ms=cuda_ms(kern, 200)[0]))
    return rows


def tailed_row(dev, seed, launches, err) -> dict:
    """The tailed decode call's row at path Q2's call at the cache's last
    fill (q [8, 8, 8, 128], main [8, 8, 1152, 128], tail [8, 8, 256, 128];
    main_len 1024, 128 tail rows): the kernel against its plain version,
    timed beside SDPA over the same rows laid out contiguously (the
    ``cat`` not timed) and beside the untailed kernel over that contiguous
    cache; ``launches`` path Q's by part, ``err`` the largest error of the
    kernel checks."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da

    gen = torch.Generator(dev).manual_seed(seed)
    b, kv, g, hd, w = D_BATCH, 8, 8, 128, Q_WINDOW
    s = D_PROMPT + D_GEN
    fill = s - 1
    q, km, vm, kt, vt = _tailed_inputs(gen, b, kv, g, s, w, hd, "bfloat16",
                                       dev)
    clen = torch.tensor(fill, dtype=torch.int32, device=dev)
    main_len, n = fill // w * w, fill + 1
    kc = torch.cat([km[:, :, :main_len], kt[:, :, :n - main_len]], 2)
    vc = torch.cat([vm[:, :, :main_len], vt[:, :, :n - main_len]], 2)
    q4 = q.reshape(b, kv * g, 1, hd)
    kern = lambda: da.decode_attention_tailed_fwd(  # noqa: E731
        q, km, vm, kt, vt, clen, w)
    plain = lambda: da.decode_attention_tailed_plain(  # noqa: E731
        q, km, vm, kt, vt, clen, w)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, kc, vc, enable_gqa=True)
    clen_joined = torch.tensor(n - 1, dtype=torch.int32, device=dev)
    untailed = lambda: da.decode_attention_fwd(  # noqa: E731
        q, kc, vc, clen_joined)
    err = max(err, _attn_close(kern(), plain(), "bfloat16",
                               "decode_attention_tailed at path Q2's call"))
    _require(torch.allclose(lib().reshape(q.shape).float(), kern().float(),
                            rtol=2e-2, atol=2e-2),
             "decode_attention_tailed and scaled_dot_product_attention "
             "disagree at path Q2's call")
    bnd, by = bound_ms(2 * (2 * q.numel() + 2 * b * kv * n * hd),
                       4 * b * kv * g * n * hd, PEAK_FLOPS_BF16)
    return dict(
        name="decode_attention_tailed", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/models/attention.py:185",
        replaces_note="the reference's jnp decode_attention_tailed (no "
        "Pallas kernel), run on the decode kernel's tailed entry points "
        "decode_attention_tailed_{f32,bf16}",
        launches=launches["Q2"], launches_by_path={"Q2": launches["Q2"]},
        max_abs_err=err, ms=graph_ms(kern, 200),
        plain_ms=graph_ms(plain, 50), bound_ms=bnd, bound_by=by,
        library_ms=graph_ms(lib, 200), wrapper_ms=cuda_ms(kern, 200)[0],
        calls=[dict(at="the untailed kernel over the same rows as one cache",
                    ms=graph_ms(untailed, 200))],
        design="the splits take equal shares of the joined main_len + "
        "tail_len + 1 rows, each row read from the main cache below "
        "main_len and from the tail above; main_len and tail_len from "
        "cache_len on the card")


def _wkv_inputs(gen, b, t, h, hd, dev):
    """r, k, v, w, u, s0 as ``tests/test_kernels.py`` draws them: w in
    (0.45, 0.95), non-zero u and s0."""
    import torch

    n = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return [n(b, t, h, hd), n(b, t, h, hd) * 0.3, n(b, t, h, hd),
            torch.sigmoid(n(b, t, h, hd)) * 0.5 + 0.45, n(h, hd) * 0.1,
            n(b, h, hd, hd) * 0.1]


def _wkv_close(got, want, what: str):
    """``(max abs err, max abs err / the plain result's largest
    magnitude)``; fails above ``WKV_TOL`` of that magnitude."""
    err, scale = _max_err(got, want), float(want.abs().max())
    _require(err <= WKV_TOL * scale,
             f"{what}: kernel disagrees with its plain version (max abs err "
             f"{err}, {WKV_TOL} x max |plain| = {WKV_TOL * scale})")
    return err, err / scale


def _worst(*errs):
    """The largest (abs, rel) error of each kind."""
    return tuple(max(e) for e in zip(*errs))


def check_wkv(dev, gen, b, t, h, hd, chunk=None):
    """Kernel against plain at r [b, t, h, hd], with a new ``s_last`` and
    in place (``s_last`` = s0); with ``chunk``, the chunked entry point
    against the one-launch call too.  Returns the worst (abs, rel) error."""
    import torch

    from repro_torch.kernels import rwkv6_scan as ws

    xs = _wkv_inputs(gen, b, t, h, hd, dev)
    want, s_want = ws.rwkv6_wkv_plain(*xs)
    worst = (0.0, 0.0)
    for in_place in (False, True):
        s0 = xs[5].clone()
        got, s_got = ws.rwkv6_wkv_fwd(*xs[:5], s0,
                                      s_last=s0 if in_place else None)
        torch.cuda.synchronize()
        _require((s_got is s0) == in_place, "rwkv6_wkv: s_last not honoured")
        tag = f"rwkv6_wkv r={[b, t, h, hd]} in_place={in_place}"
        worst = _worst(worst, _wkv_close(got, want, tag + " out"),
                       _wkv_close(s_got, s_want, tag + " s_last"))
    msg = ""
    if chunk is not None:
        got_c, s_c = ws.rwkv6_wkv(*xs, chunk=chunk)
        torch.cuda.synchronize()
        tag = f"rwkv6_wkv r={[b, t, h, hd]} chunk={chunk} vs one launch"
        c_err = _worst(_wkv_close(got_c, got, tag + " out"),
                       _wkv_close(s_c, s_got, tag + " s_last"))
        msg = f"; chunk={chunk} vs one launch max_abs_err={c_err[0]!r}"
    print(f"check rwkv6_wkv r=[{b}, {t}, {h}, {hd}] new s_last and in place: "
          f"max_abs_err={worst[0]!r} (relative {worst[1]!r}){msg}")
    return worst


def wkv_row(dev, seed, launches, errs):
    """Kernel row of rwkv6_wkv: E1's call (8 x 1024 tokens, a new state)
    and E2's (one token, each layer's state in place in turn)."""
    import torch

    from repro_torch.kernels import rwkv6_scan as ws

    gen = torch.Generator(dev).manual_seed(seed)
    h, hd, n_layers = 40, 64, 32               # rwkv6-3b's

    def bound(b, t):
        # o_t = r_t S + (sum_i r_i u_i k_i) v_t and S = w S + k^T v: 5 hd^2
        # + 5 hd operations a (b, t, h); the streams, u and the state's
        # read and write in bytes
        return bound_ms(4 * (5 * b * t * h * hd + 2 * b * h * hd * hd
                             + h * hd), b * t * h * (5 * hd * hd + 5 * hd))

    xs = _wkv_inputs(gen, D_BATCH, D_PROMPT, h, hd, dev)
    kern = lambda: ws.rwkv6_wkv_fwd(*xs)  # noqa: E731
    plain = lambda: ws.rwkv6_wkv_plain(*xs)  # noqa: E731
    bnd, by = bound(D_BATCH, D_PROMPT)
    row = dict(
        name="rwkv6_wkv", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:47",
        launches=sum(launches.values()),
        launches_by_path=launches, max_abs_err=errs["rwkv6_wkv_fwd"][0],
        max_rel_err=errs["rwkv6_wkv_fwd"][1], ms=graph_ms(kern, 10),
        plain_ms=graph_ms(plain, 1), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 10)[0],
        design="state split over lanes (8 rows x 4 columns, 32 registers, "
        "float4 loads and stores) and 4 independent column blocks a head; "
        "partial outputs reduce-scattered by shuffles; r, k, v, w step "
        "rows through a 3-stage ring of bulk copies (TMA) on mbarriers")
    del xs
    # E2's call on every layer's state in turn, as a decode step makes it:
    # the 32 states (168 MB) do not fit the 50 MB L2, so each call reads
    # its state from HBM; times are per call
    layers = [_wkv_inputs(gen, D_BATCH, 1, h, hd, dev)
              for _ in range(n_layers)]

    def each(fn):
        def calls():
            for xs in layers:
                fn(*xs[:5], xs[5], s_last=xs[5])
        return calls

    kern, plain = each(ws.rwkv6_wkv_fwd), each(ws.rwkv6_wkv_plain)
    bnd, by = bound(D_BATCH, 1)
    # a yardstick, used nowhere in the port: copying the same state bytes
    # (read once, written once) in the same replay
    spare = [torch.empty_like(xs[5]) for xs in layers]

    def copies():
        for xs, dst in zip(layers, spare):
            dst.copy_(xs[5])

    row["calls"] = [dict(
        at="one decode step (path E2's call, a layer's state)",
        ms=graph_ms(kern, 10) / n_layers,
        plain_ms=graph_ms(plain, 5) / n_layers, bound_ms=bnd, bound_by=by,
        wrapper_ms=cuda_ms(kern, 10)[0] / n_layers,
        state_copy_ms=graph_ms(copies, 10) / n_layers)]
    return row


def anneal_step_row(dev, gen, launches_c1, launches_c2, launches_i,
                    launches_s, errs):
    """Kernel row of anneal_step: one step of path C1's 1024 rows x 6
    chains at N = 32 (the warp layout), and of C2's 28 chains at N = 256
    (the cluster layout), each beside its plain step.  Bound: the state
    read and written once, the step's inputs and its Gumbel block read
    once (bytes), against about ten float32 operations a move."""
    from repro_torch.kernels import move_eval as me

    def timed(rows, k, n):
        state, args, act, gumbel, temps = _step_inputs(dev, gen, rows, k, n,
                                                       masked=True)
        c, m = rows * k, 2 * n + 2
        kern = lambda: me.anneal_step(  # noqa: E731
            state, *args, gumbel, temps, 0, active=act)
        plain = lambda: me.anneal_step_reference(  # noqa: E731
            state, *args, gumbel, temps, 0, active=act)
        # the annealer's loop launches through a launcher that checks the
        # state once: its call is what a step pays on the host
        step = me.anneal_step_launcher(state, *args, temps, k, active=act)
        state_bytes = 4 * (2 * c * n + 2 * c * m + 2 * c)
        inputs = 4 * (3 * c * n + 2 * c + k * (n * m + 1) + 1)
        bnd, by = bound_ms(2 * state_bytes + inputs, 10 * c * n * m)
        return dict(ms=graph_ms(kern, 50), plain_ms=graph_ms(plain, 10),
                    bound_ms=bnd, bound_by=by,
                    wrapper_ms=cuda_ms(lambda: step(gumbel, 0), 50)[0])

    c1, c2 = timed(1024, 6, 32), timed(1, 28, 256)
    return dict(
        name="anneal_step", route="cuda",
        source="src/repro_torch/kernels/csrc/move_eval.cu",
        replaces="src/repro/kernels/move_eval.py:135",
        replaces_note="the move plane with the reference annealer's step "
        "around it (src/repro/opt/anneal.py:147-186, chain_update and "
        "body): one launch an anneal step, the plane never written",
        launches=launches_c1["anneal_step"] + launches_c2["anneal_step"]
        + launches_i["anneal_step"] + launches_s["anneal_step"],
        launches_by_path={"C1": launches_c1["anneal_step"],
                          "C2": launches_c2["anneal_step"],
                          "I": launches_i["anneal_step"],
                          "S": launches_s["anneal_step"]},
        max_abs_err=errs["anneal_step"], library_ms=None, **c1,
        calls=[dict(c2, at="path C2's call (28 chains of N = 256, the "
                           "cluster layout)")])


def heuristic_kwargs():
    from repro_torch.registry import get_spec

    hyper = [get_spec(p).hyperparams for p in HEURISTICS]
    return dict(strategies=[h["strategy"] for h in hyper],
                decreasing=[h["decreasing"] for h in hyper],
                capacity=CAPACITY, dt=1.0, migration_steps=2)


def compare_loop_fused(got, want, tag: str) -> float:
    """Every output equal bit for bit (lag total and max too)."""
    import torch

    torch.cuda.synchronize()
    worst = max(_max_err(got[i], want[i]) for i in (0, 1))
    for i in range(len(want)):
        _require(torch.equal(got[i].view(torch.int32),
                             want[i].view(torch.int32)),
                 f"{tag}: output {i} differs from the plain version's bits "
                 f"(max abs err {worst})")
    return worst


def check_loop_fused(dev, seed, b=512, t=480, n=14):
    import torch

    from repro_torch.kernels import loop_fused as lf

    kw = dict(heuristic_kwargs(), record_assign=True)
    rates, act = traffic_mix(b, t, n, seed, dev)
    lag0 = torch.rand((b, n), generator=torch.Generator(dev).manual_seed(
        seed), device=dev)
    worst = 0.0
    for mask in (None, act):
        want = lf.loop_fused_reference(rates, active=mask, initial_lag=lag0,
                                       **kw)
        got = lf.loop_fused(rates, active=mask, initial_lag=lag0, **kw)
        worst = max(worst, compare_loop_fused(
            got, want, f"loop_fused masked={mask is not None}"))
    print(f"check loop_fused 8 heuristics B={b} T={t} N={n} masked and "
          f"unmasked, with initial lag: bit for bit")
    return worst


FAMILIES = ("diurnal", "bursty", "topic_lifecycle")


def _family_slices(batch: int):
    """The rows of each family in ``traffic_mix``'s output."""
    first = batch - 2 * (batch // 3)
    return dict(zip(FAMILIES, (slice(0, first),
                               slice(first, first + batch // 3),
                               slice(first + batch // 3, batch))))


def _print_metrics(out) -> None:
    """Per policy: the SLO metrics over all groups, the share of steps
    with no backlog at all (every bin drained empty), and violation_frac
    per traffic family."""
    fams = _family_slices(out.lag_total.shape[1])
    for p, name in enumerate(out.policies):
        row = {k: float(v[p].mean()) for k, v in out.metrics.items()}
        row["zero_backlog_frac"] = float((out.lag_total[p] == 0).mean())
        for fam, rows in fams.items():
            row[f"violation_frac_{fam}"] = float(
                out.metrics["violation_frac"][p, rows].mean())
        print(f"  {name:>15s} " + " ".join(f"{k}={v!r}"
                                           for k, v in row.items()))


def _check_outcome(out, shape) -> None:
    import numpy as np

    _require(out.lag_total.shape == shape, f"lag_total shape "
             f"{out.lag_total.shape}, want {shape}")
    for name in ("lag_total", "consumers", "migrations"):
        _require(np.isfinite(getattr(out, name)).all(),
                 f"{name} holds non-finite values")
    _require((out.lag_total >= 0).all(), "negative backlog")
    _require((out.consumers >= 0).all() and (out.migrations >= 0).all(),
             "negative consumer or migration count")


def _agree(small, big, streams: int, steps: int, what: str) -> None:
    """Path outputs on a slice against an independent run of the slice."""
    import numpy as np

    lt = big.lag_total[:, :streams, :steps]
    _require(np.allclose(lt, small.lag_total, rtol=TOL, atol=TOL),
             f"{what}: lag_total differs on the cross-check slice "
             f"(max {np.abs(lt - small.lag_total).max()!r})")
    for name in ("consumers", "migrations"):
        _require(np.array_equal(getattr(big, name)[:, :streams, :steps],
                                getattr(small, name)),
                 f"{what}: {name} differ on the cross-check slice")


class _Host:
    """A ``sweep_lag`` result as numpy fields, for ``_agree``."""

    def __init__(self, res):
        for f in ("lag_total", "consumers", "migrations"):
            setattr(self, f, getattr(res, f).cpu().numpy())


def path_c1_agreement(out, rates, act, streams: int = 16, steps: int = 48):
    """The first ``streams`` groups x ``steps`` steps of path C1 once more
    on the CPU, with the draws the card's generators made injected."""
    import torch

    from repro_torch.lagsim import LagSimConfig, sweep_lag
    from repro_torch.opt import AnnealNoise
    from repro_torch.registry import builtin

    gen = torch.Generator(device=rates.device).manual_seed(
        builtin.ANNEAL_SEED)
    noise = []
    for _ in range(steps):
        nz = AnnealNoise.draw(builtin.ANNEAL_STEPS, builtin.ANNEAL_CHAINS,
                              rates.shape[2], generator=gen)
        noise.append(AnnealNoise(nz.gumbel.cpu(), nz.temps.cpu()))
    t0 = time.perf_counter()
    small = sweep_lag(PATH_C1, rates[:streams, :steps].cpu(), LagSimConfig(),
                      active=act[:streams, :steps].cpu(), device="cpu",
                      policy_options={p: {"noise": noise} for p in PATH_C1})
    _agree(_Host(small), out, streams, steps,
           "path C1 against the CPU run with the same draws")
    print(f"path C1 agreement: {streams} groups x {steps} steps on the CPU "
          f"with the card's draws injected: integers exact, lag within "
          f"{TOL} (cpu_s={time.perf_counter() - t0!r})")


def run_path_c2(dev, seed):
    """``api.optimize`` on one 256-partition topic; the same instance and
    seed once more with the plain move evaluation must agree."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.opt import anneal_frontier, incumbent_assignment

    rates, _ = traffic_mix(3, 33, 256, seed + 20, dev)   # row 0: diurnal
    trace = rates[0].cpu().numpy()
    prev = incumbent_assignment(trace[:32], CAPACITY, 32, "BFD", device=dev)
    speeds = trace[32]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.optimize(speeds, prev, capacity=CAPACITY, seed=seed,
                       device=dev)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    # one anneal_step a step, 12 packers scored, no move plane written
    launches = {"anneal_step": 250, "pack_rows": 12, "move_delta_batch": 0}
    for k, want in launches.items():
        _require(counts[k] == want, f"path C2: {k} launched {counts[k]} "
                 f"times, want {want}")
    _require(len(out.heuristics) == 12 and out.hypervolume > 0
             and all(b >= 1 for b, _ in out.front),
             "path C2: malformed frontier")
    print(f"path C2: optimize N={speeds.shape[0]} sum(speeds)="
          f"{float(speeds.sum())!r} 7 lambdas x 4 restarts x 250 steps: "
          f"wall_s={wall!r} launches={launches}")
    print(f"  per_lambda={out.per_lambda}")
    print(f"  front={out.front} hypervolume={out.hypervolume!r}")
    print("  hv_ratio " + " ".join(
        f"{k}={v['hv_ratio']!r}{'(dominated)' if v['dominated'] else ''}"
        for k, v in out.heuristics.items()))
    plain = anneal_frontier(speeds, prev, CAPACITY, seed=seed,
                            use_kernel=False, device=dev)
    _require((plain.per_lambda, plain.front, plain.hypervolume)
             == (out.per_lambda, out.front, out.hypervolume),
             "path C2: the plain anneal step gives another frontier")
    print("path C2 agreement: the plain anneal step on the card gives the "
          "same per_lambda, front and hypervolume")
    # the scoring's 12 packing calls once more, timed alone (eager, CUDA
    # events): their share of the wall above
    from repro_torch.registry import packer_for

    sp = torch.tensor(speeds[None], dtype=torch.float32, device=dev)
    pv = torch.tensor(prev[None], dtype=torch.long, device=dev)
    packers = [packer_for(name) for name in PACKERS]
    ms, _ = cuda_ms(lambda: [f(sp, pv, CAPACITY) for f in packers], 5)
    print(f"  the 12 packing calls of the scoring at N={speeds.shape[0]}: "
          f"{ms!r} ms together")
    return launches


FAMILIES_F = ("random_walk", "diurnal", "ramp", "bursty", "churn",
              "heavy_tail", "topic_lifecycle", "adversarial")
PATH_F = ("BFD", "MBF", "MWFP", "KEDA_LAG")      # 3 of the 4 pack
F_GROUPS, F_T, F_N = 4096, 960, 64
F_STEPS = (240, 480, 720, 960)                    # 2-8 h at 30 s a step
F_T_BUCKETS, F_N_BUCKETS = (480, 960), (8, 16, 32, 64)


def fleet_traffic(seed, dev):
    """Path F's fleet: 512 groups of each registered family at its
    default knobs (churn, topic_lifecycle and adversarial masked), drawn
    on the card at 960 steps x 64 partitions, rates clipped to one
    consumer's capacity; group i is then cut to its own T_i steps and N_i
    partitions (numpy, from ``seed``).  Returns the [4096, 960, 64] rates
    and masks and the cuts."""
    import numpy as np
    import torch

    from repro_torch.core import scenarios

    per = F_GROUPS // len(FAMILIES_F)
    rates, masks = [], []
    for i, fam in enumerate(FAMILIES_F):
        sp, act = scenarios.generate_masked_scenario(
            fam, seed + 30 + i, per, F_T, F_N, device=dev)
        rates.append(torch.clamp(sp, max=CAPACITY))
        masks.append(act)
        del sp, act
    t_i, n_i = fleet_cuts(seed)
    return torch.cat(rates), torch.cat(masks), t_i, n_i


def fleet_cuts(seed):
    """Path F's cuts, from ``seed`` with numpy: each group's T_i steps
    and N_i partitions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t_i = rng.choice(F_STEPS, size=F_GROUPS)
    n_i = rng.integers(4, F_N + 1, size=F_GROUPS)
    return t_i, n_i


def fleet_groups(seed):
    """Path F's bucket groups as ``{(T_b, N_b): scenarios}``: each group
    is one batch of that many rows of width N_b for ``pack_rows`` and
    ``lag_update``."""
    groups = {}
    for t, n in zip(*fleet_cuts(seed)):
        key = (_bucket(int(t), F_T_BUCKETS), _bucket(int(n), F_N_BUCKETS))
        groups[key] = groups.get(key, 0) + 1
    return dict(sorted(groups.items()))


def _bucket(x, buckets):
    return next(b for b in buckets if b >= x)


def run_path_f(dev, seed):
    """A ragged fleet through ``FleetRunner.simulate``: 4096 groups of the
    8 families, each at its own (T_i, N_i), in (480, 960) x (8, 16, 32,
    64) buckets; the per-step loop with ``use_kernel=True``.  The same
    call again after ``reset()`` hits every entry; 8 groups of each
    bucket at their own shapes through ``sweep_lag`` equal the padded
    run."""
    import numpy as np
    import torch

    from repro_torch.fleet import FleetConfig, FleetRunner
    from repro_torch.kernels import _build
    from repro_torch.lagsim import LagSimConfig, sweep_lag
    from repro_torch.telemetry import default_tracer

    t0 = time.perf_counter()
    rates, masks, t_i, n_i = fleet_traffic(seed, dev)
    torch.cuda.synchronize()
    print(f"path F data: {len(FAMILIES_F)} families x "
          f"{F_GROUPS // len(FAMILIES_F)} groups drawn at {F_T} x {F_N} "
          f"({rates.numel() * 4 / 1e9!r} GB of rates), "
          f"setup_s={time.perf_counter() - t0!r}")
    pairs = [(rates[i, :t, :n], masks[i, :t, :n])
             for i, (t, n) in enumerate(zip(t_i.tolist(), n_i.tolist()))]
    # a fleet-wide replica cap (KEDA's maxReplicaCount): with the default
    # (each group's own N) every distinct N would be a group of its own
    cfg = LagSimConfig(use_kernel=True, max_consumers=F_N)
    runner = FleetRunner(FleetConfig(t_buckets=F_T_BUCKETS,
                                     n_buckets=F_N_BUCKETS))
    tb = np.array([_bucket(t, F_T_BUCKETS) for t in t_i])
    nb = np.array([_bucket(n, F_N_BUCKETS) for n in n_i])
    # each bucket group runs T_b steps of its per-step loop
    sum_tb = sum(t for t, _ in set(zip(tb.tolist(), nb.tolist())))
    torch.cuda.synchronize()
    default_tracer().reset()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = runner.simulate(PATH_F, pairs, cfg, device=dev)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = runner.stats()
    spans = {name: [r.dur_us / 1e3 for r in default_tracer().records(name)]
             for name in ("fleet.simulate", "fleet.dispatch", "fleet.build")}
    _require(len(stats["buckets"]) == 8, f"path F: {stats['buckets']}, "
             f"want 8 bucket groups")
    launches = {"pack_rows": 3 * sum_tb, "lag_update_batch": 4 * sum_tb,
                "select_slot_grid": 0}
    for k, want in launches.items():
        _require(counts[k] == want, f"path F: {k} launched {counts[k]} "
                 f"times, want {want}")
    true_steps = int(t_i.sum())
    padded = float((tb * nb).sum()) / float((t_i * n_i).sum())
    print(f"path F: FleetRunner.simulate {PATH_F} over {F_GROUPS} groups "
          f"(T_i in {F_STEPS}, N_i in 4..{F_N}), buckets {F_T_BUCKETS} x "
          f"{F_N_BUCKETS}, use_kernel=True: wall_s={wall!r} "
          f"policy_stream_steps_per_s={len(PATH_F) * true_steps / wall!r} "
          f"padded_share={padded!r} launches={launches}")
    print(f"  stats={stats}")
    # the fleet's own host time: the call less its groups' runs (each
    # run's dispatch span holds its per-step loop and its D2H copies);
    # then each group's padding and D2H alone, timed again at its shapes
    outside = spans["fleet.simulate"][0] - sum(spans["fleet.dispatch"])
    print(f"  fleet spans (ms): dispatch per group "
          f"{[round(d, 1) for d in spans['fleet.dispatch']]}, build "
          f"{sum(spans['fleet.build'])!r} in all; outside the runs "
          f"(normalise, group, pad, slice) {outside!r} in all, "
          f"{outside / len(spans['fleet.dispatch'])!r} a group")
    members = {}
    for i in range(F_GROUPS):
        members.setdefault((int(tb[i]), int(nb[i])), []).append(
            (i, *pairs[i]))
    pad_ms, d2h_ms = [], []
    for (bt, bn), group in sorted(members.items()):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner._pad_and_stack(group, bt, bn, True, (dev,))
        torch.cuda.synchronize()
        pad_ms.append((time.perf_counter() - t1) * 1e3)
        fields = [torch.zeros((len(PATH_F), len(group), bt), device=dev)
                  for _ in range(5)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        [x.cpu().numpy() for x in fields]
        d2h_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"  per group (sorted by bucket): pad+stack ms "
          f"{[round(x, 2) for x in pad_ms]}, D2H of its 5 trajectory "
          f"fields ms {[round(x, 2) for x in d2h_ms]}")
    for name in ("lag_total", "consumers", "migrations"):
        _require(all(np.isfinite(x).all() and x.shape == (len(PATH_F), t)
                     for x, t in zip(getattr(res, name), t_i)),
                 f"path F: {name} malformed")
    _require(all((c >= 0).all() for c in res.consumers),
             "path F: negative consumer count")

    # pack_rows at F's widest rows: MBF over the 960x64 bucket's groups
    # at step 8, with steps 0-7's assignment as prev
    from repro_torch.core.pack import modified_any_fit

    rows = np.flatnonzero((tb == 960) & (nb == F_N))
    width = (torch.arange(F_N, device=dev)
             < torch.as_tensor(n_i[rows], device=dev)[:, None])
    prev = torch.full((len(rows), F_N), -1, dtype=torch.long, device=dev)
    for step in range(9):
        sp8, act8 = rates[rows, step], masks[rows, step] & width
        if step < 8:
            prev = modified_any_fit(sp8, prev, CAPACITY, active=act8).bin_of
    ms = graph_ms(lambda: modified_any_fit(sp8, prev, CAPACITY,
                                           active=act8), 20)
    got = modified_any_fit(sp8, prev, CAPACITY, active=act8)
    want = plain_packer("MBF")(sp8, prev, CAPACITY, active=act8)
    for f in ("bin_of", "names", "n_bins"):
        _exact(getattr(got, f), getattr(want, f),
               f"pack_rows MBF on path F's 960x{F_N} group {f}")
    _require(torch.equal(got.loads.view(torch.int32),
                         want.loads.view(torch.int32)),
             "pack_rows MBF on path F's group: loads differ from the plain "
             "version's bits")
    print(f"  pack_rows (MBF) on the 960x{F_N} group at step 8, "
          f"[{len(rows)}, {F_N}]: ms={ms!r} (the kernel table times it at "
          f"path B's [1024, 32]); equal to the plain packer, loads bit for "
          f"bit")

    # the same call once more: every group hits its warm entry
    runner.reset()
    t0 = time.perf_counter()
    again = runner.simulate(PATH_F, pairs, cfg, device=dev)
    wall2 = time.perf_counter() - t0
    st = runner.stats()
    _require((st["cache_hits"], st["cache_misses"], st["cache_evictions"])
             == (8, 0, 0), f"path F repeat: stats {st}, want 8 hits, 0 "
             f"misses, 0 evictions")
    _require(all(np.array_equal(a, b) for f in ("consumers", "migrations")
                 for a, b in zip(getattr(res, f), getattr(again, f))),
             "path F repeat: integers differ from the first call")
    print(f"path F repeat after reset(): wall_s={wall2!r} hits="
          f"{st['cache_hits']} misses={st['cache_misses']} evictions="
          f"{st['cache_evictions']}")
    del again

    # padded equals direct: in each bucket, 8 groups that share one
    # padded shape, run at that shape (unpadded) through sweep_lag
    t0 = time.perf_counter()
    bit_equal, worst, worst_rel, checked = True, 0.0, 0.0, 0
    for bt in F_T_BUCKETS:
        for bn in F_N_BUCKETS:
            shapes = {}
            for i in np.flatnonzero((tb == bt) & (nb == bn)):
                if (t_i[i], n_i[i]) != (bt, bn):
                    shapes.setdefault((int(t_i[i]), int(n_i[i])),
                                      []).append(int(i))
            (t, n), idx = max(shapes.items(), key=lambda kv: len(kv[1]))
            idx = idx[:8]
            _require(len(idx) == 8, f"path F: only {len(idx)} groups of "
                     f"shape {(t, n)} in bucket {bt}x{bn}")
            solo = sweep_lag(PATH_F, rates[idx, :t, :n], cfg,
                             active=masks[idx, :t, :n], device=dev)
            for j, i in enumerate(idx):
                for f in ("consumers", "migrations", "unreadable"):
                    _require(np.array_equal(
                        getattr(res, f)[i],
                        getattr(solo, f)[:, j].cpu().numpy()),
                        f"path F: {f} of group {i} ({t}x{n} in {bt}x{bn}) "
                        f"differ from its direct run")
                for f in ("lag_total", "lag_max"):
                    want = getattr(solo, f)[:, j].cpu().numpy()
                    got = getattr(res, f)[i]
                    _require(np.allclose(got, want, rtol=TOL, atol=TOL),
                             f"path F: {f} of group {i} differs from its "
                             f"direct run by {np.abs(got - want).max()!r}")
                    err = np.abs(got.astype(np.float64) - want)
                    worst = max(worst, float(err.max()))
                    worst_rel = max(worst_rel, float(
                        (err / np.maximum(np.abs(want), 1.0)).max()))
                    bit_equal &= got.tobytes() == want.tobytes()
            checked += len(idx)
    print(f"path F padded equals direct: {checked} groups (8 a bucket, at "
          f"their own shapes through sweep_lag on the card): integers "
          f"exact, lag within rtol = atol = {TOL} (max abs err {worst!r}, "
          f"max err over max(|lag|, 1) {worst_rel!r}), bit for bit: "
          f"{bit_equal} (direct_s={time.perf_counter() - t0!r})")
    return launches


def run_path_g(dev, seed, rates, act):
    """``api.sweep`` of the 12 packers over path B's traffic (one
    ``pack_rows`` launch an algorithm a step), its first 16 streams x 48
    steps once more on the CPU; ``api.evaluate()`` at the paper's
    defaults and ``api.pack`` of a 256-partition instance for each packer,
    on the card against the CPU."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build

    b, t, n = rates.shape
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.sweep(rates, CAPACITY, active=act, device=dev)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    launches = {"pack_rows": len(PACKERS) * t, "select_slot_grid": 0}
    for k, want in launches.items():
        _require(counts[k] == want, f"path G: {k} launched {counts[k]} "
                 f"times, want {want}")
    _require(out.bins.shape == (len(PACKERS), b, t)
             and out.algorithms == PACKERS, "path G: malformed sweep")
    print(f"path G: api.sweep of the {len(PACKERS)} packers over B={b} x "
          f"T={t} x N={n} (path B's traffic): wall_s={wall!r} "
          f"algorithm_stream_steps_per_s={len(PACKERS) * b * t / wall!r} "
          f"launches={launches}")
    print("  mean bins " + " ".join(
        f"{a}={float(out.bins[i].mean())!r}" for i, a in enumerate(PACKERS)))
    print("  mean rscore " + " ".join(
        f"{a}={float(out.rscores[i].mean())!r}"
        for i, a in enumerate(PACKERS)))
    small = api.sweep(rates[:16, :48].cpu(), CAPACITY,
                      active=act[:16, :48].cpu(), device="cpu")
    for f in ("bins", "migrations"):
        _require(np.array_equal(getattr(out, f)[:, :16, :48],
                                getattr(small, f)),
                 f"path G: sweep {f} differ from the CPU's")
    err = float(np.abs(out.rscores[:, :16, :48] - small.rscores).max())
    _require(err <= TOL, f"path G: sweep rscores differ from the CPU's by "
             f"{err!r}")
    print(f"path G agreement: 16 streams x 48 steps on the CPU: bins and "
          f"migrations exact, rscores max abs err {err!r}")

    _build.reset_launches()
    t0 = time.perf_counter()
    ev = api.evaluate(device=dev)
    wall_ev = time.perf_counter() - t0
    ev_launches = _build.launch_counts()["pack_rows"]
    _require(ev_launches == len(PACKERS) * 120, f"path G: evaluate "
             f"launched pack_rows {ev_launches} times, want "
             f"{len(PACKERS) * 120}")
    ref = api.evaluate(device="cpu")
    _require((ev.cbs, ev.pareto) == (ref.cbs, ref.pareto),
             "path G: evaluate's CBS or Pareto lists differ from the CPU's")
    err_ev = max(abs(ev.avg_rscore[d][a] - ref.avg_rscore[d][a])
                 for d in ev.deltas for a in ev.algorithms)
    _require(err_ev <= TOL, f"path G: evaluate avg_rscore differs by "
             f"{err_ev!r}")
    print(f"path G: api.evaluate() (deltas {ev.deltas}, 30 partitions, 120 "
          f"measurements) on the card: wall_s={wall_ev!r}, pack_rows "
          f"launches={ev_launches}; CBS and Pareto equal the CPU's, "
          f"avg_rscore max abs err {err_ev!r}; pareto={ev.pareto}")

    rng = np.random.default_rng(seed)
    sp0 = rng.uniform(0.01, 0.25, 256)
    first = api.pack(sp0, CAPACITY, algorithm="BFD", backend="torch",
                     device="cpu")
    prev = np.array([first.assignment[j] for j in range(256)], np.int32)
    prev[::17] = -1
    speeds = np.clip(sp0 + rng.uniform(-0.05, 0.05, 256), 0.001, None)
    _build.reset_launches()
    t0 = time.perf_counter()
    on_card = [api.pack(speeds, CAPACITY, algorithm=a, prev=prev,
                        backend="torch", device=dev) for a in PACKERS]
    wall_pack = time.perf_counter() - t0
    pack_launches = _build.launch_counts()["pack_rows"]
    _require(pack_launches == len(PACKERS), f"path G: api.pack launched "
             f"pack_rows {pack_launches} times, want {len(PACKERS)}")
    for a, got in zip(PACKERS, on_card):
        want = api.pack(speeds, CAPACITY, algorithm=a, prev=prev,
                        backend="torch", device="cpu")
        _require(got == want, f"path G: api.pack {a} differs from the CPU")
    print(f"path G: api.pack of one 256-partition instance for each of the "
          f"{len(PACKERS)} packers equals the CPU (outcomes equal field for "
          f"field): wall_s={wall_pack!r} n_bins=" + " ".join(
              f"{a}:{o.n_bins}" for a, o in zip(PACKERS, on_card)))

    # G4: the pure-Python packers (api.pack's default backend) on the same
    # instance, its speeds quantized to k/1024 so that every load sum is
    # exact in float32 (the reference's cross-backend property), against
    # backend="torch" on the card
    quant = np.round(speeds * 1024) / 1024
    _build.reset_launches()
    torch_q = [api.pack(quant, CAPACITY, algorithm=a, prev=prev,
                        backend="torch", device=dev) for a in PACKERS]
    q_launches = _build.launch_counts()["pack_rows"]
    _require(q_launches == len(PACKERS), f"path G4: api.pack(backend="
             f"'torch') launched pack_rows {q_launches} times")
    mapping = {j: float(w) for j, w in enumerate(quant)}
    prev_map = {j: int(c) for j, c in enumerate(prev) if c >= 0}
    t0 = time.perf_counter()
    py = [api.pack(mapping, CAPACITY, algorithm=a, prev=prev_map)
          for a in PACKERS]
    wall_py = time.perf_counter() - t0
    for a, got, want in zip(PACKERS, py, torch_q):
        _require(got.backend == "py" and got.n_bins == want.n_bins
                 and got.assignment == want.assignment
                 and {c: float(np.float32(v)) for c, v in got.loads.items()}
                 == want.loads,
                 f"path G4: api.pack {a} backend='py' differs from "
                 f"backend='torch'")
    print(f"path G4: api.pack(backend='py') of the same instance (speeds "
          f"quantized to k/1024) for each of the {len(PACKERS)} packers "
          f"equals backend='torch' on the card (assignment, n_bins, loads): "
          f"wall_s={wall_py!r} (the torch backend's 12 calls: "
          f"pack_rows launches={q_launches})")
    return {"pack_rows": launches["pack_rows"] + ev_launches + pack_launches
            + q_launches,
            "select_slot_grid": launches["select_slot_grid"]}


# path I: the adversarial search's own budget (the reference's
# benchmarks/adversarial_bench.py:53), and a search a capacity planner runs
I1_SEARCH = dict(pop_size=8, generations=6, iters=96, n=6,
                 incident_weight=0.05)
I2_SEARCH = dict(pop_size=32, scenarios_per_genome=4, generations=4,
                 iters=960, n=32)
PATH_I_REPLAY = ("MBF", "BFD", "KEDA_LAG")


def _search_launches(tag, counts, family, steps):
    """A search's exact launches: one ``lag_update`` a policy-step, one
    ``pack_rows`` a step for a packer, ``ANNEAL_STEPS`` ``anneal_step``
    launches a step for an annealer, nothing else."""
    from repro_torch.registry import PACKER_FAMILIES
    from repro_torch.registry.builtin import ANNEAL_STEPS

    want = {"lag_update_batch": steps,
            "pack_rows": steps if family in PACKER_FAMILIES else 0,
            "anneal_step": steps * ANNEAL_STEPS if family == "optimizer"
            else 0,
            "select_slot_grid": 0, "move_delta_batch": 0, "loop_fused": 0}
    for k, n in want.items():
        _require(counts[k] == n, f"path {tag}: {k} launched {counts[k]} "
                 f"times, want {n}")
    return {k: want[k] for k in ("lag_update_batch", "pack_rows",
                                 "anneal_step")}


def path_i1_agreement(dev, seed, pol, cfg, sim):
    """One fitness batch of ``pol`` at I1's shape (the oracle's rows of a
    population of ``cfg.pop_size`` genomes) through the loop on the card,
    against the same rows on the CPU (plain versions; an annealer gets
    the draws the card's generator made): integers and incident tables
    exact, lag within ``TOL``."""
    import torch

    from repro_torch.core.scenarios import family_spec
    from repro_torch.lagsim import sweep_lag
    from repro_torch.opt import AnnealNoise
    from repro_torch.registry import builtin, get_spec
    from repro_torch.scenarios import random_population
    from repro_torch.scenarios import search as ts
    from repro_torch.telemetry.alerts import incident_matrix

    spec = family_spec("adversarial")
    draws = ts._Draws(None, seed, dev, len(spec.knobs), cfg)
    rates, act = ts._scenario_oracle(spec, cfg, draws)(
        random_population(spec, seed, cfg.pop_size, device=dev))
    opts = None
    if get_spec(pol).family == "optimizer":
        gen = torch.Generator(device=dev).manual_seed(builtin.ANNEAL_SEED)
        noise = []
        for _ in range(cfg.iters):
            nz = AnnealNoise.draw(builtin.ANNEAL_STEPS, builtin.ANNEAL_CHAINS,
                                  cfg.n, generator=gen)
            noise.append(AnnealNoise(nz.gumbel.cpu(), nz.temps.cpu()))
        opts = {pol: {"noise": noise}}
    t0 = time.perf_counter()
    card = sweep_lag((pol,), rates, sim, active=act, device=dev)
    host = sweep_lag((pol,), rates.cpu(), sim, active=act.cpu(),
                     device="cpu", policy_options=opts)
    rows, steps = rates.shape[:2]
    _agree(_Host(host), _Host(card), rows, steps,
           f"path I1: {pol}'s fitness batch against the CPU run")
    _require(
        (incident_matrix(card.incidents) == incident_matrix(host.incidents))
        .all(), f"path I1: {pol}'s incident table differs from the CPU run's")
    print(f"path I1 agreement: {pol}'s fitness batch ({rows} streams x "
          f"{steps} steps x {cfg.n}) on the CPU (plain versions"
          f"{', the card' + chr(39) + 's draws injected' if opts else ''}): "
          f"integers and incident tables exact, lag within {TOL} "
          f"(s={time.perf_counter() - t0!r})")


def run_path_i1(dev, seed):
    """``api.attack`` of each family's representative at the reference's
    own search budget, alerts on, the baseline on; NF's search twice,
    bit for bit."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.lagsim import LagSimConfig
    from repro_torch.registry import get_spec
    from repro_torch.scenarios import SearchConfig, family_representatives
    from repro_torch.telemetry import (AlertConfig, TelemetryConfig,
                                       default_rules)

    cfg = SearchConfig(**I1_SEARCH)
    sim = LagSimConfig(use_kernel=True, telemetry=TelemetryConfig(
        record_frames=False, alerts=AlertConfig(rules=default_rules())))
    total = {"lag_update_batch": 0, "pack_rows": 0, "anneal_step": 0}
    first = None
    reps = family_representatives()
    for fam, pol in [*reps.items(), ("heuristic", reps["heuristic"])]:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = api.attack(pol, config=cfg, sim=sim, seed=seed, device=dev)
        wall = time.perf_counter() - t0
        gens = out.generations_run + out.baseline.generations_run
        _require(out.baseline.evals == out.evals, f"path I1: {pol}'s "
                 f"baseline spent {out.baseline.evals} evals, want "
                 f"{out.evals}")
        _require(get_spec(pol).family == fam and np.isfinite(
            out.best_fitness) and len(out.history) == out.generations_run,
            f"path I1: {pol}: malformed outcome")
        launches = _search_launches(f"I1 {pol}", _build.launch_counts(),
                                    fam, cfg.iters * gens)
        evals = out.evals + out.baseline.evals
        for k in total:
            total[k] += launches[k]
        print(f"path I1: api.attack({pol!r}) ({fam}; pop {cfg.pop_size}, "
              f"{cfg.generations} generations, {cfg.iters} x {cfg.n}, "
              f"incident_weight {cfg.incident_weight}): best_fitness="
              f"{out.best_fitness!r} baseline_fitness="
              f"{out.baseline_fitness!r} beats_baseline="
              f"{out.beats_baseline} evals={out.evals} generations_run="
              f"{out.generations_run} history={out.history} wall_s={wall!r} "
              f"evals_per_s={evals / wall!r} launches={launches}")
        if pol == reps["heuristic"] and first is not None:
            _require(out.history == first.history
                     and out.witness_genome == first.witness_genome
                     and out.baseline_fitness == first.baseline_fitness,
                     f"path I1: {pol}'s second search differs from its "
                     f"first")
            print(f"path I1: {pol}'s search once more with seed {seed}: "
                  f"history, witness genome and baseline bit for bit")
        else:
            if pol == reps["heuristic"]:
                first = out
            path_i1_agreement(dev, seed, pol, cfg, sim)
    return total


def run_path_i2(dev, seed):
    """``api.attack("MBF")`` at a capacity planner's size through a fresh
    runner: 32 genomes x 4 scenarios of 960 steps (8 h at 30 s) over 32
    partitions a fitness call; then the witness saved, loaded and
    replayed, equal to direct runs."""
    import tempfile

    import torch

    from repro_torch import api
    from repro_torch.core.scenarios import (adversarial_draws,
                                            adversarial_masked, family_spec)
    from repro_torch.kernels import _build
    from repro_torch.lagsim import LagSimConfig
    from repro_torch.scenarios import (SearchConfig, genome_knobs,
                                       load_trace, random_population,
                                       repair_genome, resample_trace,
                                       save_trace)
    from repro_torch.scenarios import search as ts

    cfg = SearchConfig(**I2_SEARCH)
    runner = api.FleetRunner()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.attack("MBF", config=cfg, sim=LagSimConfig(use_kernel=True),
                     seed=seed, fleet=runner, device=dev)
    wall = time.perf_counter() - t0
    g = out.generations_run
    _require(out.baseline.generations_run == g, "path I2: the baseline ran "
             f"{out.baseline.generations_run} generations, want {g}")
    launches = _search_launches("I2", _build.launch_counts(), "sticky",
                                cfg.iters * 2 * g)
    st = runner.stats()
    _require((st["cache_misses"], st["cache_hits"]) == (1, 2 * g - 1),
             f"path I2: fleet cache {st}, want 1 miss and {2 * g - 1} hits")
    rows = cfg.pop_size * cfg.scenarios_per_genome
    print(f"path I2: api.attack('MBF') pop {cfg.pop_size} x "
          f"{cfg.scenarios_per_genome} scenarios x {cfg.iters} steps x "
          f"{cfg.n} partitions ({rows} streams a fitness call): "
          f"best_fitness={out.best_fitness!r} baseline_fitness="
          f"{out.baseline_fitness!r} beats_baseline={out.beats_baseline} "
          f"evals={out.evals} generations_run={g} history={out.history} "
          f"wall_s={wall!r} evals_per_s={2 * out.evals / wall!r} "
          f"policy_stream_steps_per_s="
          f"{2 * g * rows * cfg.iters / wall!r} launches={launches} "
          f"fleet={ {k: st[k] for k in ('cache_hits', 'cache_misses')} }")
    # the oracle's batch at I2's shape, the kept genome first: each
    # genome's rows on the card against the CPU transform of the same
    # draws (the card's generator under the search's scenario seed)
    spec = family_spec("adversarial")
    draws = ts._Draws(None, seed, dev, len(spec.knobs), cfg)
    oracle = ts._scenario_oracle(spec, cfg, draws)
    pop = random_population(spec, seed, cfg.pop_size, device=dev)
    pop[0] = torch.tensor(out.search.best_genome, device=dev)
    t0 = time.perf_counter()
    sp, ac = oracle(pop)
    s = cfg.scenarios_per_genome
    worst = 0.0
    for i, genome in enumerate(repair_genome(spec, pop).cpu().numpy()):
        knobs = genome_knobs(spec, genome)
        gen = torch.Generator(device=dev).manual_seed(draws.scenario_seed)
        raw = adversarial_draws(gen, s, cfg.iters, cfg.n,
                                churn_p=knobs.pop("churn_p"))
        w_sp, w_ac = adversarial_masked({k: v.cpu() for k, v in raw.items()},
                                        capacity=cfg.capacity, **knobs)
        rows_i = slice(s * i, s * i + s)
        _require(torch.equal(ac[rows_i].cpu(), w_ac), f"path I2: genome "
                 f"{i}'s active rows differ from the CPU transform's")
        worst = max(worst, _close(sp[rows_i].cpu(), w_sp,
                                  f"path I2: genome {i}'s oracle rates"))
    print(f"path I2: the oracle's batch {tuple(sp.shape)} (the kept genome "
          f"and {cfg.pop_size - 1} random ones) on the card against the "
          f"CPU transform of the same draws: masks exact, rates "
          f"max_abs_err={worst!r} (s={time.perf_counter() - t0!r})")
    # the search's own layer a generation, timed alone: the oracle's
    # batch (a host copy of the genomes, then 32 generator calls) and one
    # evolution step, against the generation's share of the wall
    fit = torch.rand(cfg.pop_size, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        oracle(pop)
    torch.cuda.synchronize()
    oracle_ms = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    for g_ in range(1, 4):
        ts._evolve(spec, cfg, pop, fit, *draws.evolve(g_))
    torch.cuda.synchronize()
    evolve_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"path I2: a generation's oracle batch ({rows} streams) "
          f"oracle_ms={oracle_ms!r}, one evolution step evolve_ms="
          f"{evolve_ms!r}; a generation's share of the search's wall "
          f"{wall / (2 * g) * 1e3!r} ms")

    # the witness: saved in both formats, loaded, replayed = direct
    tr = out.search.witness_trace(cfg, seed=seed, batch=4, device=dev)
    total = {"lag_update_batch": launches["lag_update_batch"],
             "pack_rows": launches["pack_rows"]}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [save_trace(tr, str(Path(tmp) / f"witness.{ext}"))
                 for ext in ("npz", "json")]
        a, b = (load_trace(p) for p in paths)
        _require(a.rates.tobytes() == b.rates.tobytes() == tr.rates.tobytes()
                 and a.active.tobytes() == b.active.tobytes()
                 and a.meta == b.meta, "path I2: the witness's .npz and "
                 ".json differ")
        for path, iters in ((paths[0], None), (paths[1], None),
                            (paths[0], cfg.iters // 2)):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            rp = api.replay(path, policies=PATH_I_REPLAY, iters=iters,
                            method="linear", use_kernel=True, device=dev)
            wall_rp = time.perf_counter() - t0
            counts = _build.launch_counts()
            want = tr if iters is None else resample_trace(tr, iters,
                                                           "linear")
            direct = api.simulate(want.rates, policies=PATH_I_REPLAY,
                                  active=want.active,
                                  capacity=want.capacity, use_kernel=True,
                                  device=dev)
            steps = want.iters
            _require(counts["lag_update_batch"] == 3 * steps
                     and counts["pack_rows"] == 2 * steps,
                     f"path I2 replay: launches {counts}, want "
                     f"{3 * steps} lag_update and {2 * steps} pack_rows")
            for f in ("lag_total", "consumers", "migrations"):
                _require(getattr(rp.result, f).tobytes()
                         == getattr(direct, f).tobytes(),
                         f"path I2: replay of {Path(path).name} differs "
                         f"from the direct run in {f}")
            total["lag_update_batch"] += counts["lag_update_batch"]
            total["pack_rows"] += counts["pack_rows"]
            print(f"path I2 replay: {Path(path).name} "
                  f"{'as recorded' if iters is None else f'resampled to {iters} steps (linear)'}"
                  f" through {PATH_I_REPLAY}: shape={rp.shape} "
                  f"wall_s={wall_rp!r} violation_frac="
                  f"{rp.metrics['violation_frac'].mean(axis=1).tolist()} "
                  f"equal to a direct api.simulate of the same arrays bit "
                  f"for bit")
    return total


# path J: the paper's own system (broker, monitor, controller, replicas)
J1_N, J1_TICKS, J1_SYNC = 30, 600, 8   # the paper's 30 partitions, 10 min
J1_REC = 16384                # Kafka's producer batch.size default (bytes)
# the paper's measured 2.3 MB/s consumer, in whole records: with
# batch_bytes = C * dt a replica fetches whole records, so at C = 2.3e6 it
# drains 140 records (2,293,760 B) a tick and a bin packed to 140 records
# never drains in the world while the twin drains it at 6,240 B/s
J1_C = 140 * J1_REC
#: J2's world: 60 ticks, a quarter of the example's 240 (120 before the
#: dry run's path T came), cut for the time limit; the x4 spike over ticks
#: 20-40, replicas printed at the marks
J2_TICKS, J2_SPIKE, J2_MARKS = 60, (20, 40), (15, 35, 57)


def j1_world(n: int, seed: int):
    """The object world of path J1 after ``J1_SYNC`` ticks: ``n``
    partitions at constant rates ``k_i * J1_REC`` B/s (``k_i`` numpy
    integers in [14, 126], 0.1-0.9 C, from ``seed``), BFD, a 1 s monitor
    interval and ``batch_bytes`` clamped to ``C * dt``.  Returns ``(sim,
    rates, backlog f32[n])``."""
    import numpy as np

    from repro_torch.broker import TopicPartition
    from repro_torch.serving import AutoscaleSimulation

    k = np.random.default_rng(seed).integers(14, 127, n)
    rates = [float(x) * J1_REC for x in k]
    sim = AutoscaleSimulation(
        n_partitions=n, rate_fn=AutoscaleSimulation.constant_rates(rates),
        capacity=J1_C, algorithm="BFD", record_bytes=J1_REC,
        monitor_interval=1.0)
    sim.replica_cfg.batch_bytes = int(J1_C)
    sim.manager.config.batch_bytes = int(J1_C)
    sim.run(seconds=J1_SYNC, dt=1.0)
    lag0 = np.array([sim.broker.lag("autoscaler", TopicPartition(sim.topic, i))
                     for i in range(n)], np.float32)
    return sim, rates, lag0


def check_j1_kernels(dev, seed):
    """``pack_rows`` (BFD) and ``lag_update`` on path J1's own inputs, one
    row of ``J1_N`` partitions in bytes: the rates ``k_i * J1_REC``, ``prev``
    unassigned and then BFD's own answer, and the world's backlog at the
    sync drained under that assignment with ``J1_C`` a bin.  Packing
    exact (``loads`` bit for bit), the drain within ``rtol = atol =
    1e-5``.  Returns the drain's max abs error."""
    import torch

    from repro_torch.kernels import lag_update as lu
    from repro_torch.registry import get_spec

    _, rates, lag0 = j1_world(J1_N, seed)
    n, m = J1_N, 2 * J1_N + 2
    speeds = torch.tensor([rates], dtype=torch.float32, device=dev)
    prev = torch.full((1, n), -1, dtype=torch.long, device=dev)
    for what in ("unassigned", "BFD's own answer"):
        got = get_spec("BFD").packer(speeds, prev, J1_C)
        want = plain_packer("BFD")(speeds, prev, J1_C)
        torch.cuda.synchronize()
        for f in ("bin_of", "names", "n_bins"):
            _exact(getattr(got, f), getattr(want, f),
                   f"pack_rows BFD at path J1's [1, {n}], prev {what}: {f}")
        _require(torch.equal(got.loads.view(torch.int32),
                             want.loads.view(torch.int32)),
                 f"pack_rows BFD at path J1's [1, {n}], prev {what}: loads "
                 f"differ")
        prev, bins = got.bin_of, int(got.n_bins.reshape(-1)[0])
    lag = torch.tensor(lag0, device=dev)[None]
    readable = torch.ones((1, n), dtype=torch.bool, device=dev)
    cap = torch.full((1, m), float(J1_C), device=dev)
    got = lu.lag_update_batch(lag, speeds, prev, readable, cap)
    want = lu.lag_update_reference(lag, speeds, prev, readable, cap, m=m)
    torch.cuda.synchronize()
    err = _close(got, want, f"lag_update at path J1's [1, {n}] in bytes")
    print(f"check pack_rows BFD at path J1's [1, {n}] (rates k_i x {J1_REC} "
          f"B/s, C={J1_C}), prev unassigned and its own answer: exact, "
          f"{bins} bins; lag_update there on "
          f"the world's backlog: max_abs_err={err!r} B")
    return err

def run_path_j1(dev, seed, n: int = J1_N, ticks: int = J1_TICKS):
    """The lag twin against the paper's system: the object world of
    ``j1_world`` runs ``ticks`` more ticks on the host, and
    ``simulate_lag(policy="BFD", use_kernel=True)`` runs the same rates
    from the world's backlog on ``dev``.  Consumer counts equal at every
    step, no migration on either side, lag within ``4 * J1_REC * n``; on
    the card exactly one ``pack_rows`` and one ``lag_update`` launch a
    step.  Returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.lagsim import LagSimConfig, simulate_lag

    sim, rates, lag0 = j1_world(n, seed)
    speeds = [sim.controller.speeds[tp] for tp in sorted(sim.controller.speeds)]
    _require(speeds == rates, "path J1: the monitor's speeds differ from the "
                              "producer's rates")
    mig0 = len(sim.controller.migrations)
    t0 = time.perf_counter()
    m = sim.run(seconds=ticks, dt=1.0)
    host_s = time.perf_counter() - t0
    held = sum(len(p._log) for p in sim.broker.topics[sim.topic].partitions)
    world_n = np.asarray(m.n_replicas)[J1_SYNC:]
    world_lag = np.asarray(m.lag_bytes, np.float64)[J1_SYNC:]
    reassigns = sim.controller.migrations[mig0:]
    world_moved = sum(len(r.moved) for r in reassigns)

    trace = torch.tensor(rates, dtype=torch.float32, device=dev).repeat(
        ticks, 1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    r = simulate_lag(trace, policy="BFD",
                     cfg=LagSimConfig(capacity=J1_C, dt=1.0, use_kernel=True),
                     initial_lag=lag0, device=dev)
    twin_n = r.consumers.cpu().numpy()
    twin_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    launches = {k: counts[k] for k in ("pack_rows", "lag_update_batch",
                                       "select_slot_grid")}
    if dev.type == "cuda":
        want = {"pack_rows": ticks, "lag_update_batch": ticks,
                "select_slot_grid": 0}
        _require(launches == want, f"path J1: launches {launches}, want "
                                   f"{want}")
    twin_lag = r.lag_total.double().cpu().numpy()
    twin_moved = int(r.migrations.sum())
    bad = np.flatnonzero(world_n != twin_n)
    _require(bad.size == 0, f"path J1: consumer counts differ at "
                            f"{bad.size} steps, first at step "
                            f"{bad[:1].tolist()}: world "
                            f"{world_n[bad[:1]].tolist()} twin "
                            f"{twin_n[bad[:1]].tolist()}")
    _require(world_moved == 0 and twin_moved == 0,
             f"path J1: migrations under constant load: world {world_moved} "
             f"({len(reassigns)} reassignments), twin {twin_moved}")
    tol = 4 * J1_REC * n
    diff = float(np.abs(world_lag - twin_lag).max())
    _require(diff <= tol, f"path J1: lag differs by {diff} B > {tol} B")
    print(f"path J1: {n} partitions at k_i x {J1_REC} B/s (k_i in "
          f"{min(rates) / J1_REC:.0f}..{max(rates) / J1_REC:.0f}, "
          f"{sum(rates)!r} B/s in all), C={J1_C} B/s, BFD, "
          f"{ticks} ticks after {J1_SYNC}: consumers "
          f"{int(world_n[0])}..{int(world_n.max())} equal at every step; "
          f"migrations world {world_moved} twin {twin_moved}; backlog at "
          f"sync {float(lag0.sum())!r} B; max lag difference {diff!r} B "
          f"(tolerance {tol} B)")
    print(f"path J1: object world on the host {ticks / host_s!r} ticks/s "
          f"(host_s={host_s!r}), {held} records held; twin on {dev.type} "
          f"wall_s={twin_s!r} launches={launches}")
    return launches


def _metadata_rows(sim):
    """Every record of ``consumer.metadata``: (partition, offset,
    timestamp, message, nbytes).  A heartbeat's stats lose ``tokens``
    (an LLM replica's) and ``capacity`` (a byte replica's), and its nbytes
    with them; everything else is kept as sent."""
    import json

    rows = []
    topic = sim.broker.topics["consumer.metadata"]
    for i, part in enumerate(topic.partitions):
        for rec in part._log:
            msg, nbytes = json.loads(rec.value), rec.nbytes
            if msg["type"] == "heartbeat":
                msg["stats"] = {k: v for k, v in msg["stats"].items()
                                if k not in ("tokens", "capacity")}
                nbytes = None
            rows.append((i, rec.offset, rec.timestamp, msg, nbytes))
    return rows


def _same_byte_world(a, b, what: str) -> None:
    """World ``a`` equals world ``b`` integer for integer: the metrics
    (replicas, lag, produced and consumed bytes a tick), every
    ``MigrationRecord``, the metadata topic (see ``_metadata_rows``), the
    monitor's measurements, the log sizes of the data and monitor topics,
    the committed offsets, the final assignment and the replicas created
    and deleted."""
    import numpy as np

    ma, mb = a.metrics.as_arrays(), b.metrics.as_arrays()
    for k in ma:
        _require(np.array_equal(ma[k], mb[k]), f"{what}: metrics {k} differ")
    mig = lambda s: [(r.iteration, r.started_at, r.rscore,  # noqa: E731
                      sorted(r.moved), r.n_bins, r.finished_at)
                     for r in s.controller.migrations]
    _require(mig(a) == mig(b), f"{what}: migration records differ")
    _require(_metadata_rows(a) == _metadata_rows(b),
             f"{what}: the metadata topic differs")
    for f in (lambda s: s.broker.describe_log_dirs(
                  [s.topic, "monitor.writeSpeed"]),
              lambda s: [(r.offset, r.timestamp, r.value) for r in
                         s.broker.topics["monitor.writeSpeed"].partitions[0]._log],
              lambda s: s.broker._offsets,
              lambda s: s.controller.assignment,
              lambda s: (s.produced_bytes, s.manager.created_total,
                         s.manager.deleted_total)):
        _require(f(a) == f(b), f"{what}: log sizes, measurements, offsets, "
                               f"assignment or replica counts differ")


def run_path_j2(dev, seed, cfg=None, ticks: int = J2_TICKS, spike=J2_SPIKE,
                marks=J2_MARKS):
    """An autoscaled fleet of ``LLMReplica``s (``SharedModel(max_len=16,
    max_batch=8)`` of ``cfg``, default qwen3-8b at full width and depth in
    bfloat16, weights drawn on ``dev`` from ``seed``) under the serving
    example's traffic over ``ticks`` ticks, the x4 spike on streams 0-2 at
    ``spike``.  The same world with byte replicas on the host must be
    equal integer for integer; on the card every serve step launches
    ``decode_attention`` once a layer; the first generate call once more
    gives the same tokens.  Returns the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.examples.autoscale_serve import make_world
    from repro_torch.kernels import _build
    from repro_torch.serving import SharedModel

    if cfg is None:
        cfg = dataclasses.replace(configs.get(LLM), dtype="bfloat16",
                                  param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = SharedModel(cfg, max_len=16, max_batch=8, seed=seed, device=dev)
    draw_s = time.perf_counter() - t0
    generate = model.generate
    calls = []                # (prompts, gen, tokens) of every call
    gen_s = [0.0]

    def recorded(prompts, gen):
        t = time.perf_counter()
        out = generate(prompts, gen)
        gen_s[0] += time.perf_counter() - t
        calls.append((prompts, gen, out))
        return out

    model.generate = recorded   # taken back below: it would hold a cycle
    sim = make_world(cfg.vocab_size, model, spike=spike, seed=seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    _build.reset_launches()
    seen = {}
    t0 = time.perf_counter()
    for _ in range(ticks):
        sim.tick(1.0)
        t = int(sim.clock.now())
        seen[t] = sim.manager.n_alive()
        if t in marks:
            tokens = sum(int(c[2].size) for c in calls)
            print(f"path J2 t={t:4d}s replicas={seen[t]} lag="
                  f"{sim.broker.total_lag('autoscaler', sim.topic)} B "
                  f"tokens_generated={tokens}")
    wall = time.perf_counter() - t0
    steps = sum(max(len(p) for p in ps) + g for ps, g, _ in calls)
    _require(calls and steps > 0, "path J2: no request was generated")
    launches = {"decode_attention_fwd": (
        _launched("decode_attention_fwd", cfg.n_layers * steps, "path J2")
        if dev.type == "cuda" else 0)}
    served = sum(len(ps) for ps, _, _ in calls)
    tokens = sum(int(out.size) for _, _, out in calls)
    for ps, g, out in calls:
        _require(out.shape == (len(ps), g) and (out >= 0).all()
                 and (out < cfg.vocab_size).all(),
                 f"path J2: generated tokens {out.shape} out of range")
    during = max(seen[t] for t in range(spike[0] + 1, spike[1] + 1))
    _require(during > seen[marks[0]],
             f"path J2: the fleet did not grow under the spike "
             f"({seen[marks[0]]} replicas at t={marks[0]}, at most {during} "
             f"during it)")

    host = make_world(cfg.vocab_size, None, spike=spike, seed=seed)
    for _ in range(ticks):
        host.tick(1.0)
    _same_byte_world(sim, host, "path J2: LLM replicas against byte "
                                "replicas")
    del model.generate        # the recorder's closure refers to the model
    prompts, gen, out = calls[0]
    again = generate(prompts, gen)
    _require(np.array_equal(again, out), "path J2: the first chunk generated "
                                         "again gives other tokens")
    migs = sim.controller.migrations
    print(f"path J2: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
          f"{cfg.dtype} on {dev.type} (drawn in {draw_s!r} s), {ticks} "
          f"ticks, spike x4 on streams 0-2 over {list(spike)}: replicas "
          f"{min(seen.values())}..{max(seen.values())}; reassignments "
          f"{len(migs)}, stream migrations {sum(len(r.moved) for r in migs)}, "
          f"mean Rscore {float(np.mean([r.rscore for r in migs])) if migs else 0.0!r}")
    print(f"path J2: requests_served={served} generated_tokens={tokens} "
          f"generate_calls={len(calls)} serve_steps={steps} "
          f"ms_per_serve_step={gen_s[0] / steps * 1e3!r} "
          f"generate_s={gen_s[0]!r} wall_s={wall!r} launches={launches}; "
          f"the byte-level world equals the byte replicas' integer for "
          f"integer; the first chunk ({len(prompts)} requests) generated "
          f"again: the same tokens")
    return launches


PATH_H_REAL = ("KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG")
PATH_H_CP = ("MBF", "BFD", "KEDA_LAG")      # 2 of the 3 pack
# KEDA's documented ScaledObject defaults (pollingInterval 30 s,
# cooldownPeriod 300 s) at a 30 s step, a replica cap of half of path B's
# 32 partitions (so that the fold runs), one step of metric delay and of
# rebalance latency, a two-step warm-up storm
H_CP = dict(polling_interval=1, observation_delay=1, actuation_delay=1,
            cooldown_period=10, min_replicas=1, max_replicas=16,
            warmup_steps=2)
PATH_H3 = ("BFD", "MBF", "KEDA_LAG_REAL")
#: H3's fleet: H3_GROUPS of path F's groups, those of at most H3_MAX_T
#: steps (a host-bound fleet's time goes with its bucket groups' steps,
#: not their rows: the 960-step buckets would double it)
H3_GROUPS, H3_MAX_T = 256, 480


def h_telemetry(frames: bool = True, hist_max=None):
    """Path H's in-loop telemetry: the default sketch (its histogram over
    ``[0, hist_max]``; ``None``: the engine's default for each group's
    N) and the four default alert rules, with per-step frames or
    without."""
    from repro_torch.telemetry import (AlertConfig, SketchConfig,
                                       TelemetryConfig, default_rules)

    return TelemetryConfig(record_frames=frames,
                           sketch=SketchConfig(hist_max=hist_max),
                           alerts=AlertConfig(rules=default_rules()))


def _packers(policies):
    from repro_torch.registry import PACKER_FAMILIES, get_spec

    return sum(get_spec(p).family in PACKER_FAMILIES for p in policies)


def _incident_table(out):
    """Incidents per policy and rule of an ``api.simulate`` outcome."""
    table = {p: {} for p in out.policies}
    for per_stream in out.incidents:
        for inc in per_stream:
            row = table[out.policies[inc.index[0]]]
            row[inc.rule] = row.get(inc.rule, 0) + 1
    return table


def _same_telemetry(got, want, what: str) -> None:
    """Two ``api.simulate`` outcomes' sketches and incidents: counts,
    histograms and incident tables exact, floats within ``TOL``."""
    import numpy as np

    for gs, ws in zip(got.sketches, want.sketches):
        for g, w in zip(gs, ws):
            _require(g.count == w.count and np.array_equal(g.hist, w.hist),
                     f"{what}: sketch counts or histograms differ")
            for f in ("mean", "m2", "vmin", "vmax"):
                a, b = getattr(g, f), getattr(w, f)
                _require(np.allclose(a, b, rtol=TOL, atol=TOL),
                         f"{what}: sketch {f} differs by "
                         f"{np.abs(a - b).max()!r}")
    for gi, wi in zip(got.incidents, want.incidents):
        _require(len(gi) == len(wi), f"{what}: incident counts differ")
        for a, b in zip(gi, wi):
            a, b = a.as_dict(), b.as_dict()
            pa, pb = a.pop("peak"), b.pop("peak")
            _require(a == b and abs(pa - pb) <= TOL * max(1.0, abs(pb)),
                     f"{what}: incident {a} differs from {b}")


def run_path_h1(tag, policies, rates, act, **over):
    """``api.simulate`` of ``policies`` over path B's traffic with the
    drain kernel and path H's telemetry on: exactly one ``lag_update`` a
    policy a step and one ``pack_rows`` a packing policy a step.  Prints
    the SLO metrics, the incidents per policy and rule, and the line count
    of a lint-clean Prometheus exposition of the merged sketch and every
    incident; then the first 16 groups x 48 steps on the card and on the
    CPU (the plain versions) must agree."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.telemetry import (EventStream, merge_summaries,
                                       prometheus_exposition,
                                       validate_exposition)

    p, (b, t, n) = len(policies), rates.shape
    tele = h_telemetry()
    torch.cuda.synchronize()
    api.default_fleet().reset()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.simulate(rates, policies=policies, active=act,
                       device=rates.device, use_kernel=True, telemetry=tele,
                       **over)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    want = {"lag_update_batch": p * t, "pack_rows": _packers(policies) * t,
            "select_slot_grid": 0, "loop_fused": 0}
    for k, v in want.items():
        _require(counts[k] == v, f"path {tag}: {k} launched {counts[k]} "
                 f"times, want {v}")
    _check_outcome(out, (p, b, t))
    _require(len(out.sketches) == b and len(out.incidents) == b
             and len(out.telemetry) == b, f"path {tag}: telemetry missing")
    print(f"path {tag}: {p} policies {policies} x B={b} x T={t} x N={n} "
          f"use_kernel=True, sketch + 4 alert rules + frames on {over}: "
          f"wall_s={wall!r} policy_stream_steps_per_s={p * b * t / wall!r} "
          f"launches={want}")
    _print_metrics(out)
    for name, row in _incident_table(out).items():
        print(f"  {name:>17s} incidents by rule: {row}")
    applied = int((out.consumers[:, :, 1:] != out.consumers[:, :, :-1]
                   ).sum())
    print(f"  consumer-count changes (applied scale decisions) over all "
          f"groups: {applied}; events of group 0 (policy 0's frame): "
          f"{EventStream.from_frame(out.telemetry[0]).counts()}")
    merged = merge_summaries([s for per in out.sketches for s in per])
    text = prometheus_exposition(
        sketch=merged, incidents=[i for per in out.incidents for i in per],
        labels={"path": tag})
    validate_exposition(text)
    print(f"  merged sketch: count={merged.count!r} lag_total p50="
          f"{merged.quantile(0.5)!r} p99={merged.quantile(0.99)!r}; "
          f"Prometheus exposition lint-clean, "
          f"{len(text.splitlines())} lines")
    # agreement: the first 16 groups x 48 steps on the card and on the CPU
    streams, steps = 16, 48
    kw = dict(policies=policies, use_kernel=True, telemetry=tele, **over)
    t0 = time.perf_counter()
    cpu = api.simulate(rates[:streams, :steps].cpu(),
                       active=act[:streams, :steps].cpu(), device="cpu", **kw)
    card = api.simulate(rates[:streams, :steps],
                        active=act[:streams, :steps], device=rates.device,
                        **kw)
    _agree(cpu, out, streams, steps, f"path {tag} against the CPU")
    _agree(cpu, card, streams, steps, f"path {tag} (slice) against the CPU")
    _same_telemetry(card, cpu, f"path {tag} (slice) against the CPU")
    print(f"path {tag} agreement: {streams} groups x {steps} steps on the "
          f"CPU (plain versions): integers, sketch counts and histograms "
          f"and incident tables exact, floats within {TOL} "
          f"(cpu_s={time.perf_counter() - t0!r})")
    return out, {k: counts[k] for k in ("lag_update_batch", "pack_rows")}


def path_h_ops(rates, act):
    """Torch ops a policy-step of path H's policies (an 8-step run's ops
    less a 4-step run's, over 4, as ``path_b_ops`` counts them), with the
    telemetry and the control plane on, each alone, and both off (the
    REAL scalers carry their own control plane in every run)."""
    import dataclasses

    from repro_torch import api
    from repro_torch.lagsim import ControlPlaneConfig

    cp = ControlPlaneConfig(**H_CP)
    tele = h_telemetry()

    def per_step(policy, **kw):
        n = []
        for t in (4, 8):
            with _op_counter() as ops:
                api.simulate(rates[:, :t], policies=(policy,),
                             active=act[:, :t], device=rates.device,
                             use_kernel=True, **kw)
            n.append(ops.n)
        return (n[1] - n[0]) // 4

    rows = {}
    for policy in PATH_H_REAL + PATH_H_CP:
        own = policy in PATH_H_REAL
        rows[policy] = {
            "both": per_step(policy, telemetry=tele,
                             **({} if own else {"control_plane": cp})),
            "telemetry": per_step(policy, telemetry=tele),
            "control_plane": (None if own
                              else per_step(policy, control_plane=cp)),
            "off": per_step(policy)}
    no_frames = per_step("KEDA_LAG", telemetry=dataclasses.replace(
        tele, record_frames=False))
    for policy, row in rows.items():
        print(f"path H torch ops a policy-step, {policy}: {row}")
    print(f"  KEDA_LAG with the sketch and alerts but no frames: "
          f"{no_frames}; the REAL scalers' 'off' and 'telemetry' runs "
          f"carry their registered control plane")
    return rows


#: H2's steps (cut from 960 for the script's time limit)
H2_STEPS = 480


def run_path_h2(dev, seed):
    """Path A's heuristics at [1024, H2_STEPS, 14] under ``fused_steps=8,
    fused_kernel=True`` with a sketch and alerts on: the reference's
    routing sends them to ``_fused_wide`` (``loop_fused`` carries no
    telemetry), so ``loop_fused`` launches 0 times; the trajectories must
    equal the kernel's own output with telemetry off, bit for bit."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels import loop_fused as lf

    rates, act = traffic_mix(1024, H2_STEPS, 14, seed + 20, dev)
    p, (b, t, n) = len(HEURISTICS), rates.shape
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.simulate(rates, policies=HEURISTICS, active=act, device=dev,
                       fused_steps=8, fused_kernel=True,
                       telemetry=h_telemetry(frames=False))
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    _require(counts["loop_fused"] == 0, f"path H2: loop_fused launched "
             f"{counts['loop_fused']} times with a sketch and alerts on")
    _check_outcome(out, (p, b, t))
    _require(len(out.sketches) == b and out.telemetry is None,
             "path H2: sketches missing or frames recorded")
    kern = lf.loop_fused(rates, active=act, **heuristic_kwargs())
    for i, f in ((0, "lag_total"), (2, "consumers"), (3, "migrations")):
        _require(np.asarray(getattr(out, f)).tobytes()
                 == kern[i].cpu().numpy().tobytes(),
                 f"path H2: {f} differs from loop_fused's output bits")
    print(f"path H2: {p} heuristics x B={b} x T={t} x N={n} fused_steps=8 "
          f"fused_kernel=True, sketch + 4 alert rules on: wall_s={wall!r} "
          f"policy_stream_steps_per_s={p * b * t / wall!r}; loop_fused "
          f"launches=0 (the kernel carries no telemetry: with a sketch or "
          f"alerts on the fused path runs _fused_wide, as the reference "
          f"routes them); lag_total, consumers and migrations equal "
          f"loop_fused's output with telemetry off, bit for bit")
    for name, row in _incident_table(out).items():
        print(f"  {name:>4s} incidents by rule: {row}")
    del out, kern, rates, act
    torch.cuda.empty_cache()


def h3_rows(seed):
    """Path H3's H3_GROUPS of path F's 4096 groups, of at most H3_MAX_T
    steps, and the 16 of them held against their direct runs: 8 of each
    of the two commonest shapes that a bucket pads (so that two batched
    direct runs cover them), then the first groups of each family up to
    H3_GROUPS."""
    import numpy as np

    t_i, n_i = fleet_cuts(seed)
    shapes = {}
    for i, (t, n) in enumerate(zip(t_i.tolist(), n_i.tolist())):
        if t <= H3_MAX_T and (t, n) != (_bucket(t, F_T_BUCKETS),
                                        _bucket(n, F_N_BUCKETS)):
            shapes.setdefault((t, n), []).append(i)
    best = sorted(shapes.items(), key=lambda kv: (-len(kv[1]), kv[0]))[:2]
    checked = [i for _, idx in best for i in idx[:8]]
    per = F_GROUPS // len(FAMILIES_F)
    rest = [i for j in range(per) for i in range(j, F_GROUPS, per)
            if i not in checked and t_i[i] <= H3_MAX_T]
    rows = np.array(sorted(checked + rest[:H3_GROUPS - len(checked)]))
    return rows, [(s, [int(np.flatnonzero(rows == i)[0])
                       for i in idx[:8]]) for s, idx in best]


def run_path_h3(dev, seed):
    """A ragged fleet of H3_GROUPS of path F's groups (``h3_rows``, path F's
    cuts) with BFD, MBF and KEDA_LAG_REAL through ``FleetRunner.simulate``,
    a sketch and alerts on: exact launch counts; 16 groups (8 of each of
    two shapes) run at their own shapes through ``sweep_lag`` must have
    equal sketches (counts and histograms exact, floats within ``TOL``)
    and incident tables."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.fleet import FleetConfig, FleetRunner
    from repro_torch.kernels import _build
    from repro_torch.lagsim import LagSimConfig, sweep_lag

    rates, masks, t_i, n_i = fleet_traffic(seed, dev)
    rows, best = h3_rows(seed)
    rates, masks = rates[rows], masks[rows]
    t_i, n_i = t_i[rows], n_i[rows]
    pairs = [(rates[i, :t, :n], masks[i, :t, :n])
             for i, (t, n) in enumerate(zip(t_i.tolist(), n_i.tolist()))]
    # fleet-wide replica cap and histogram range: the config resolves at
    # each group's true N and is part of its bucket group's key, so a
    # range that followed N (the default, 8 consumer-steps a partition)
    # would split the 8 buckets into one group an N; one range also lets
    # every group's sketch summary merge with the others'
    cfg = LagSimConfig(use_kernel=True, max_consumers=F_N,
                       telemetry=h_telemetry(frames=False,
                                             hist_max=8.0 * CAPACITY * F_N))
    runner = FleetRunner(FleetConfig(t_buckets=F_T_BUCKETS,
                                     n_buckets=F_N_BUCKETS))
    tb = np.array([_bucket(int(t), F_T_BUCKETS) for t in t_i])
    nb = np.array([_bucket(int(n), F_N_BUCKETS) for n in n_i])
    sum_tb = sum(t for t, _ in set(zip(tb.tolist(), nb.tolist())))
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = runner.simulate(PATH_H3, pairs, cfg, device=dev)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    n_groups = len(set(zip(tb.tolist(), nb.tolist())))
    _require(runner.stats()["cache_misses"] == n_groups, f"path H3: "
             f"{runner.stats()['cache_misses']} groups, want {n_groups} "
             f"(one a bucket)")
    launches = {"pack_rows": _packers(PATH_H3) * sum_tb,
                "lag_update_batch": len(PATH_H3) * sum_tb,
                "select_slot_grid": 0}
    for k, want in launches.items():
        _require(counts[k] == want, f"path H3: {k} launched {counts[k]} "
                 f"times, want {want}")
    _require(res.sketch is not None and res.incidents is not None
             and res.telemetry is None, "path H3: telemetry missing")
    true_steps = int(t_i.sum())
    print(f"path H3: FleetRunner.simulate {PATH_H3} over {len(pairs)} "
          f"groups of path F ({len(set(zip(tb, nb)))} bucket groups), "
          f"sketch + 4 alert rules: wall_s={wall!r} "
          f"policy_stream_steps_per_s={len(PATH_H3) * true_steps / wall!r} "
          f"launches={launches}")
    totals = {}
    for i in range(len(pairs)):
        for inc in res.scenario_incidents(i):
            totals[inc.rule] = totals.get(inc.rule, 0) + 1
    print(f"  incidents over the fleet by rule: {totals}")
    # padded equals direct: 8 groups of each of the two commonest padded
    # shapes, at their own shape through sweep_lag on the card
    t0 = time.perf_counter()
    checked = 0
    for (t, n), idx in best:
        solo = sweep_lag(PATH_H3, rates[idx, :t, :n], cfg,
                         active=masks[idx, :t, :n], device=dev)
        for j, i in enumerate(idx):
            for f in ("count", "hist"):
                _require(np.array_equal(
                    getattr(res.sketch[i], f),
                    getattr(solo.sketch, f)[:, j].cpu().numpy()),
                    f"path H3: sketch {f} of group {i} differs from its "
                    f"direct run")
            for f in ("mean", "m2", "vmin", "vmax", "ewma", "ewma_w"):
                a = getattr(res.sketch[i], f)
                w = getattr(solo.sketch, f)[:, j].cpu().numpy()
                _require(np.allclose(a, w, rtol=TOL, atol=TOL),
                         f"path H3: sketch {f} of group {i} differs by "
                         f"{np.abs(a - w).max()!r}")
            for f in ("tick", "count", "active", "open_step", "close_step",
                      "consec", "cur_start"):
                _require(np.array_equal(
                    getattr(res.incidents[i], f),
                    getattr(solo.incidents, f)[:, j].cpu().numpy()),
                    f"path H3: alert {f} of group {i} differs from its "
                    f"direct run")
        checked += len(idx)
    print(f"path H3 padded equals direct: {checked} groups of shapes "
          f"{[s for s, _ in best]} at their own shapes: sketch counts and "
          f"histograms and incident tables exact, floats within {TOL} "
          f"(direct_s={time.perf_counter() - t0!r})")
    del res, rates, masks, pairs
    torch.cuda.empty_cache()
    return launches


def run_path(name, policies, rates, act, kernels, exact=None, **over):
    """``api.simulate`` over the path's input; every kernel of ``kernels``
    must launch, each of ``exact`` exactly as many times as it gives."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build

    p, (b, t, n) = len(policies), rates.shape
    torch.cuda.synchronize()
    api.default_fleet().reset()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.simulate(rates, policies=policies, active=act,
                       device=rates.device, **over)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    for k in kernels:
        _require(counts[k] > 0, f"path {name}: kernel {k} was not launched")
    for k, want in (exact or {}).items():
        _require(counts[k] == want, f"path {name}: {k} launched {counts[k]} "
                 f"times, want {want}")
    _check_outcome(out, (p, b, t))
    launches = {k: counts[k] for k in (*kernels, *(exact or {}))}
    print(f"path {name}: {p} policies x B={b} x T={t} x N={n} {over}: "
          f"wall_s={wall!r} policy_stream_steps_per_s={p * b * t / wall!r} "
          f"launches={launches}")
    print(f"  through api.default_fleet() (the uniform fast path): "
          f"{api.default_fleet().stats()}")
    _print_metrics(out)
    return out, launches


def path_b_ops(rates, act):
    """Torch ops a path-B step dispatches, per policy (an 8-step run's ops
    less a 4-step run's, over 4): with the packing kernel, then with the
    plain packers swapped in on the card (the per-insert walk of torch
    ops that the kernel replaces).  Returns the two totals."""
    from repro_torch import api
    from repro_torch.core.pack import modified_any_fit_plain, pack_plain
    from repro_torch.registry import builtin

    def per_step(policy):
        n = []
        for t in (4, 8):
            with _op_counter() as ops:
                api.simulate(rates[:, :t], policies=(policy,),
                             active=act[:, :t], device=rates.device,
                             use_kernel=True)
            n.append(ops.n)
        return (n[1] - n[0]) // 4

    kern = {p: per_step(p) for p in PATH_B}
    with _swapped([(builtin, "pack", pack_plain),
                   (builtin, "modified_any_fit", modified_any_fit_plain)]):
        plain = {p: per_step(p) for p in PATH_B}
    print(f"path B torch ops a step, packers on pack_rows: {kern} "
          f"total={sum(kern.values())}")
    print(f"  with the plain packers on the card (the per-insert walk): "
          f"{plain} total={sum(plain.values())}")
    return sum(kern.values()), sum(plain.values())


def path_c1_ops(rates, act):
    """Torch ops an anneal step dispatches at path C1's shape (one
    decision of ANNEAL over path B's first step: an 8-step anneal's ops
    less a 4-step one's, over 4), with the kernel and with the plain
    step.  Returns the two."""
    import torch

    from repro_torch.opt import anneal_chains
    from repro_torch.registry import builtin

    speeds, a = rates[:, 0], act[:, 0]
    prev = torch.full(speeds.shape, -1, dtype=torch.int32, device=rates.device)
    lam = torch.zeros(builtin.ANNEAL_CHAINS, device=rates.device)

    def per_step(**kw):
        n = []
        for steps in (4, 8):
            with _op_counter() as ops:
                anneal_chains(speeds, prev, CAPACITY, lam, steps=steps,
                              active=a, device=rates.device, **kw)
            n.append(ops.n)
        return (n[1] - n[0]) / 4

    kern, plain = per_step(), per_step(use_kernel=False)
    _require(kern < 10, f"path C1: {kern} torch ops an anneal step, want "
                        f"fewer than 10")
    print(f"path C1 torch ops an anneal step ({speeds.shape[0]} rows x "
          f"{builtin.ANNEAL_CHAINS} chains, N={speeds.shape[1]}): "
          f"{kern!r} with anneal_step, {plain!r} with the plain step")
    # an anneal step's device time, the Gumbel draw included (CUDA graph
    # replay, the default generator), with the kernel and the plain step
    from repro_torch.kernels import move_eval as me
    from repro_torch.opt.anneal import _gumbel

    gen = torch.Generator(rates.device).manual_seed(0)
    state, args, act, gumbel, temps = _step_inputs(
        rates.device, gen, speeds.shape[0], builtin.ANNEAL_CHAINS,
        speeds.shape[1], masked=True)
    step = me.anneal_step_launcher(state, *args, temps, gumbel.shape[0],
                                   active=act)
    draw = lambda: _gumbel(gumbel.shape, None, rates.device)  # noqa: E731
    dev_kern = graph_ms(lambda: step(draw(), 0), 50)
    dev_plain = graph_ms(lambda: me.anneal_step_reference(
        state, *args, draw(), temps, 0, active=act), 10)
    print(f"  device ms an anneal step, the draw included (graph replay): "
          f"{dev_kern!r} with anneal_step, {dev_plain!r} with the plain step")
    return kern, plain


# path K: training (olmo-1b at full width), the flash backward kernel
TRAIN = "olmo-1b"
K1_BATCH, K1_SEQ, K1_STEPS = 4, 2048, 6
K2_LAYERS, K2_BATCH = 2, 2
#: K2's optimizer: eps = 1e-3 keeps the first AdamW step linear in the
#: small gradients (|g| << eps), so that an update's error follows its
#: gradient's; at 1e-8 the first step is lr * sign(g) and a last-bit
#: difference flips the update of a near-zero gradient
K2_EPS = 1e-3
K2_TOL = 5e-2                 # of each parameter's largest update (bf16)


#: the backward's second check: ||g - w|| / ||w|| of each gradient whole,
#: and of every block of BWD_BLOCK rows of one (batch row, head) -- dq's
#: query rows, dk's and dv's keys -- so that a fault confined to a block
#: or a head whose gradients are small against the largest one (causal
#: dK and dV fall as 1/sqrt(key position)) shows.  Limits from the
#: readings of sound runs and of the controls in ``bwd_case`` (PERF.md)
BWD_BLOCK = 64
BWD_REL_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
#: whatever a block's size, its error may reach BWD_ABS a element (rms):
#: a gradient that cancels to rounding noise (one key: dS = P (dP - D)
#: with D = dP; K0's single-key cases) is not held to relative bits.
#: Inputs are unit normal, and K1's smallest blocks (the last keys' dK)
#: are about 1e-3 a element
BWD_ABS = 1e-5


def bwd_rel_errs(got, want, dtype) -> dict:
    """``{"dq"|"dk"|"dv": (whole, worst block)}``: the norm of ``got -
    want`` over the norm of ``want`` for each gradient whole and the
    largest over its blocks of ``BWD_BLOCK`` rows of one (batch row,
    head), each norm of ``want`` taken as at least ``BWD_ABS /
    BWD_REL_TOL[dtype]`` a element."""
    import torch
    import torch.nn.functional as F

    least = BWD_ABS / BWD_REL_TOL[dtype]
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        e, w = g.float() - w.float(), w.float()
        b, h, s, hd = w.shape
        pad = -s % BWD_BLOCK
        rows = torch.full(((s + pad) // BWD_BLOCK,), float(BWD_BLOCK),
                          device=w.device)
        rows[-1] -= pad
        en, wn = (F.pad(x, (0, 0, 0, pad)).reshape(b, h, -1, BWD_BLOCK * hd)
                  .norm(dim=-1) for x in (e, w))
        whole = float(e.norm() / max(float(w.norm()),
                                     least * w.numel() ** 0.5))
        out[name] = (whole, float(
            (en / torch.maximum(wn, least * (rows * hd).sqrt())).max()))
    return out


def bwd_verdict(got, want, dtype) -> dict:
    """Both checks of a backward against its plain version, without
    raising: for each gradient its largest absolute error, its scale (the
    plain result's largest magnitude, at least 1), whether it is within
    the attention tolerance (``rtol``; ``atol`` x scale), and its relative
    norms (``bwd_rel_errs``) and whether they are within
    ``BWD_REL_TOL``."""
    import torch

    tol, rel_tol = ATTN_TOL[dtype], BWD_REL_TOL[dtype]
    rels = bwd_rel_errs(got, want, dtype)
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = max(float(w.float().abs().max()), 1.0)
        out[name] = dict(
            err=_max_err(g, w), scale=scale, rel=rels[name][0],
            rel_block=rels[name][1],
            close=bool(g.dtype == w.dtype and g.shape == w.shape
                       and torch.allclose(g.float(), w.float(), rtol=tol,
                                          atol=tol * scale)),
            rel_ok=max(rels[name]) <= rel_tol)
    return out


def _bwd_close(got, want, dtype, what: str):
    """The backward kernel's outputs against its plain version's: both
    checks of ``bwd_verdict`` must hold.  Returns the largest absolute
    error and the verdict."""
    verdict = bwd_verdict(got, want, dtype)
    for name, v in verdict.items():
        _require(v["close"] and v["rel_ok"],
                 f"{what} {name}: kernel disagrees with its plain version "
                 f"(max abs err {v['err']}, largest {v['scale']}; relative "
                 f"norm {v['rel']}, worst {BWD_BLOCK}-row block "
                 f"{v['rel_block']}, limit {BWD_REL_TOL[dtype]})")
    return max(v["err"] for v in verdict.values()), verdict


def _fmt_verdict(verdict) -> str:
    return " ".join(
        f"{n}: err={v['err']!r} scale={v['scale']!r} rel={v['rel']:.3e} "
        f"block={v['rel_block']:.3e}" for n, v in verdict.items())


def bwd_controls(q, k, v, o, do, lse, got, causal):
    """Faults the backward's checks must see, made from the kernel's
    output ``got`` or from the plain version: dK and dV's last block of
    keys zeroed (the ragged tail where Skv is not a multiple of
    ``BWD_BLOCK``); D dropped (the plain version fed O = 0); the last
    query head left out of its group's dK and dV (its dO zeroed, dQ
    kept)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    skv = k.shape[2]
    tail = skv - (skv - 1) // BWD_BLOCK * BWD_BLOCK
    dk, dv = got[1].clone(), got[2].clone()
    dk[:, :, skv - tail:] = 0
    dv[:, :, skv - tail:] = 0
    do_cut = do.clone()
    do_cut[:, -1] = 0
    left = fa.flash_attention_bwd_plain(q, k, v, o, do_cut, lse,
                                        causal=causal)
    return {"last key block zeroed": (got[0], dk, dv),
            "D dropped": fa.flash_attention_bwd_plain(
                q, k, v, torch.zeros_like(o), do, lse, causal=causal),
            "last head left out": (got[0], left[1], left[2])}


def bwd_case(dev, gen, b, h, kv, s, hd, dtype, causal, reps=5, skv=None):
    """K0: the backward kernel against its plain version at q [b, h, s,
    hd] over k/v [b, kv, skv (default s), hd], both fed the forward
    kernel's output and lse (held against the plain lse within 1e-5):
    both checks of ``bwd_verdict``, two calls bit-equal, and each of
    ``bwd_controls`` failing the relative check.  Returns its error and
    times: the kernel and the plain version as CUDA-graph replays, the
    wrapper eager, and the backward of ``scaled_dot_product_attention``
    on the same inputs and output gradient, its forward run before
    (``library_ms`` a CUDA-graph replay, ``library_eager_ms`` eager, the
    like of ``wrapper_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun

    skv = s if skv is None else skv
    q = _normal(gen, (b, h, s, hd), dtype, dev)
    k = _normal(gen, (b, kv, skv, hd), dtype, dev)
    v = _normal(gen, (b, kv, skv, hd), dtype, dev)
    do = _normal(gen, (b, h, s, hd), dtype, dev)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    _, lse_plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)
    what = (f"flash_attention_bwd q=[{b}, {h}, {s}, {hd}] kv=[{b}, {kv}, "
            f"{skv}, {hd}] causal={causal} {dtype}")
    lse_err = _max_err(lse, lse_plain)
    _require(torch.allclose(lse, lse_plain, rtol=1e-5, atol=1e-5),
             f"{what}: the forward kernel's lse disagrees with the plain "
             f"lse (max abs err {lse_err})")
    del lse_plain
    kern = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, v, o, do, lse, causal=causal)
    plain = lambda: fa.flash_attention_bwd_plain(  # noqa: E731
        q, k, v, o, do, lse, causal=causal)
    got, want = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    err, verdict = _bwd_close(got, want, dtype, what)
    _require(all(torch.equal(x, y) for x, y in zip(got, again)),
             f"{what}: two calls on the same inputs differ")
    controls = {}
    for name, bad in bwd_controls(q, k, v, o, do, lse, got, causal).items():
        cv = bwd_verdict(bad, want, dtype)
        controls[name] = dict(
            old_tolerance_passes=all(c["close"] for c in cv.values()),
            rel=max(max(c["rel"], c["rel_block"]) for c in cv.values()))
        _require(not all(c["rel_ok"] for c in cv.values()),
                 f"{what}: the control '{name}' passes the relative check "
                 f"({_fmt_verdict(cv)})")
    row = dict(entry=fa.bwd_entry(q.dtype, hd), lse_max_abs_err=lse_err,
               scale=max(c["scale"] for c in verdict.values()),
               rel={n: [c["rel"], c["rel_block"]]
                    for n, c in verdict.items()},
               controls=controls)
    del got, want, again
    # SDPA eager, then as a graph: fresh leaves for each, since a leaf's
    # gradient accumulator keeps the stream of its first forward
    sdpa = lambda leaves: F.scaled_dot_product_attention(  # noqa: E731
        *leaves, is_causal=causal, enable_gqa=kv != h)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = sdpa(leaves)
    library_eager_ms = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), reps)[0]
    del out
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    held = {}

    def sdpa_fwd():
        held["out"] = sdpa(leaves)

    lib = lambda: torch.autograd.grad(  # noqa: E731
        held["out"], leaves, do, retain_graph=True)
    esize = 2 if dtype == "bfloat16" else 4
    n_bytes = (esize * (3 * q.numel() + 2 * k.numel()     # q, o, do; k, v
                        + q.numel() + 2 * k.numel())      # dq; dk, dv
               + 4 * lse.numel())                         # lse
    n_ops = 5 * 2 * hd * b * h * dryrun.causal_pairs(s, skv, causal)
    bnd, by = bound_ms(n_bytes, n_ops, PEAK_FLOPS_BF16 if dtype == "bfloat16"
                       else PEAK_FLOPS_F32)
    row.update(max_abs_err=err, ms=graph_ms(kern, reps),
               plain_ms=graph_ms(plain, 2), bound_ms=bnd, bound_by=by,
               library_ms=graph_ms(lib, reps, prepare=sdpa_fwd),
               library_eager_ms=library_eager_ms,
               wrapper_ms=cuda_ms(kern, reps)[0])
    print(f"check {what} ({row['entry']}): max_abs_err={err!r} (tolerance "
          f"{ATTN_TOL[dtype]} of the largest gradient) "
          f"{_fmt_verdict(verdict)} (relative limit {BWD_REL_TOL[dtype]}); "
          f"two calls bit-equal; lse_max_abs_err={lse_err!r}")
    for name, c in controls.items():
        print(f"check {what} control '{name}': relative "
              f"{c['rel']:.3e} fails the relative check; the old tolerance "
              f"alone {'PASSES' if c['old_tolerance_passes'] else 'fails'}")
    print(f"time {what}: ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
          f"bound_ms={bnd!r} ({by}, {bnd / row['ms']:.1%} of it) "
          f"sdpa_bwd_graph_ms={row['library_ms']!r} "
          f"wrapper_ms={row['wrapper_ms']!r} "
          f"sdpa_bwd_eager_ms={row['library_eager_ms']!r}")
    del q, k, v, o, do, lse, leaves, held
    return row


def run_path_k0(dev, seed):
    """K0: the flash backward kernels against their plain version at
    olmo-1b's heads (path K1's call), qwen3-8b's grouped heads causal and
    full, grouped heads at hd 64, a ragged causal case (Sq != Skv, neither
    a multiple of 64), in float32, and over a single key (bf16 at hd 128,
    f32 at hd 256); then ``FlashAttention`` on the card
    against the plain versions' Function, one backward each.  Returns the
    rows of each case."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(dev).manual_seed(seed + 23)
    rows = {"olmo": bwd_case(dev, gen, K1_BATCH, 16, 16, K1_SEQ, 128,
                             "bfloat16", True),
            "qwen3_causal": bwd_case(dev, gen, 4, 32, 8, 1024, 128,
                                     "bfloat16", True),
            "qwen3_full": bwd_case(dev, gen, 4, 32, 8, 1024, 128,
                                   "bfloat16", False),
            "hd64_gqa": bwd_case(dev, gen, 4, 32, 8, 1024, 64, "bfloat16",
                                 True),
            "ragged": bwd_case(dev, gen, 2, 16, 4, 1000, 128, "bfloat16",
                               True, skv=777),
            "f32": bwd_case(dev, gen, 2, 32, 8, 512, 128, "float32", True),
            # one key: dQ and dK cancel to rounding noise (BWD_ABS)
            "single_key": bwd_case(dev, gen, 2, 8, 2, 1, 128, "bfloat16",
                                   True),
            "single_key_f32": bwd_case(dev, gen, 2, 8, 2, 1, 256, "float32",
                                       True)}
    for dtype in ("bfloat16", "float32"):
        q, k, v, do = (_normal(gen, shape, dtype, dev) for shape in (
            (2, 16, 512, 128), (2, 4, 512, 128), (2, 4, 512, 128),
            (2, 16, 512, 128)))
        grads = []
        for fwd, bwd in ((fa.flash_attention_fwd, fa.flash_attention_bwd),
                         (fa.flash_attention_plain,
                          fa.flash_attention_bwd_plain)):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            fa.flash_attention(*leaves, causal=True, fwd=fwd,
                               bwd=bwd).backward(do)
            grads.append(tuple(x.grad for x in leaves))
        torch.cuda.synchronize()
        _require(all(float(g.float().abs().max()) > 0 for g in grads[0]),
                 f"FlashAttention on the card: a zero gradient ({dtype})")
        err, _ = _bwd_close(grads[0], grads[1], dtype,
                            f"FlashAttention autograd {dtype}")
        print(f"check FlashAttention through autograd on the card, q=[2, 16, "
              f"512, 128] kv_heads=4 causal {dtype}: kernels against the "
              f"plain versions' Function, one backward each: "
              f"max_abs_err={err!r}, every gradient nonzero")
        rows["f32" if dtype == "float32" else "olmo"]["max_abs_err"] = max(
            rows["f32" if dtype == "float32" else "olmo"]["max_abs_err"],
            err)
    return rows


def _olmo_train_cfg(**over):
    """olmo-1b as published: f32 parameters, bf16 compute, ``remat``."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get(TRAIN)
    _require(cfg.param_dtype == "float32" and cfg.dtype == "bfloat16"
             and cfg.remat, f"{TRAIN}: not the published training config")
    return dataclasses.replace(cfg, **over)


def run_path_k1(dev, seed):
    """K1: olmo-1b at full width and depth, K1_STEPS AdamW steps of
    K1_BATCH x K1_SEQ tokens from ``TokenPipeline``.  Exactly 32 forward
    and 16 backward flash launches a step (remat recomputes each layer's
    forward), finite losses, and a nonzero gradient in every layer's wq,
    wk and wv (the first moment after step 1 is 0.1 x the clipped
    gradient).  Returns the launch counts."""
    import gc
    import math

    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_bytes
    from repro_torch.optim import AdamWConfig, adamw_init

    gc.collect()               # a guard: J2's world frees its model when dropped
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = _olmo_train_cfg()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    opt_state = adamw_init(params)
    torch.cuda.synchronize()
    print(f"path K1: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
          f"{_heads(cfg)} d_ff={cfg.d_ff} vocab={cfg.vocab_size} f32 "
          f"parameters, bf16 compute, remat={cfg.remat}: {cfg.n_params()} "
          f"parameters, {param_bytes(params)} bytes and "
          f"{param_bytes(opt_state)} bytes of AdamW state on the card, drawn "
          f"in {time.perf_counter() - t0!r} s")
    step = make_train_step(cfg, AdamWConfig(warmup_steps=2,
                                            total_steps=K1_STEPS), dev)
    pipe = TokenPipeline(K1_BATCH, K1_SEQ, cfg.vocab_size, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    walls = []
    for i in range(K1_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, pipe.next_batch())
        loss = float(m["loss"])            # syncs: the step's wall is whole
        walls.append(time.perf_counter() - t0)
        _require(math.isfinite(loss), f"path K1 step {i + 1}: loss {loss}")
        if i == 0:
            dead = [f"layers.{j}.attn.{w}"
                    for j, lp in enumerate(opt_state["mu"]["layers"])
                    for w in ("wq", "wk", "wv")
                    if not float(lp["attn"][w].abs().max()) > 0]
            _require(not dead, f"path K1: zero gradients in {dead}")
        print(f"path K1 step {i + 1}: loss={loss!r} lr={float(m['lr'])!r} "
              f"grad_norm={float(m['grad_norm'])!r} wall_s={walls[-1]!r}")
    peak = torch.cuda.max_memory_allocated()
    counts = _build.launch_counts()
    launches = {k: counts[k] for k in ("flash_attention_fwd",
                                       "flash_attention_bwd")}
    want = {"flash_attention_fwd": 2 * cfg.n_layers * K1_STEPS,
            "flash_attention_bwd": cfg.n_layers * K1_STEPS}
    _require(launches == want, f"path K1: launches {launches}, want {want}")
    others = {k: n for k, n in counts.items() if n and k not in launches}
    _require(not others, f"path K1 launched {others}")
    tokens = K1_BATCH * K1_SEQ
    steady = walls[1:]
    print(f"path K1: {K1_STEPS} steps of {K1_BATCH} x {K1_SEQ} tokens: "
          f"wall_s={sum(walls)!r} first step {walls[0]!r} s, steps 2-"
          f"{K1_STEPS} mean {sum(steady) / len(steady)!r} s "
          f"({tokens * len(steady) / sum(steady)!r} tokens/s); "
          f"peak_mem_bytes={peak} (of which {held} held by earlier paths "
          f"before K1) launches={launches} (a step: "
          f"{2 * cfg.n_layers} forward, {cfg.n_layers} of them recomputed by "
          f"remat, and {cfg.n_layers} backward); every layer's wq, wk, wv "
          f"gradient nonzero")
    del params, opt_state
    return launches


def run_path_k2(dev, seed):
    """K2: olmo-1b at full width with K2_LAYERS layers, one train step of
    K2_BATCH x K1_SEQ tokens with the flash kernels, then with their plain
    versions swapped in (forward and backward) from the same state: the
    loss within 2e-2 and every parameter's update within K2_TOL of its
    largest update."""
    import torch

    from repro_torch import _tree
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import attention, init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = _olmo_train_cfg(n_layers=K2_LAYERS)
    params = init_params(cfg, seed=seed + 2, device=dev)
    state = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(eps=K2_EPS), dev)
    batch = TokenPipeline(K2_BATCH, K1_SEQ, cfg.vocab_size,
                          seed=seed + 2).next_batch()
    _build.reset_launches()
    got_p, _, got_m = step(params, state, batch)
    torch.cuda.synchronize()
    _require(_build.launch_counts()["flash_attention_bwd"] == K2_LAYERS,
             "path K2: the kernel step did not launch the backward kernel")
    with _swapped([(attention, "flash_attention_fwd", fa.flash_attention_plain),
                   (attention, "flash_attention_bwd",
                    fa.flash_attention_bwd_plain)]):
        _build.reset_launches()
        want_p, _, want_m = step(params, state, batch)
        torch.cuda.synchronize()
        _require(not any(_build.launch_counts().values()),
                 "path K2: the plain step launched a kernel")
    dloss = abs(float(got_m["loss"]) - float(want_m["loss"]))
    _require(dloss <= 2e-2, f"path K2: losses {float(got_m['loss'])} and "
                            f"{float(want_m['loss'])} differ by {dloss}")
    worst, where = 0.0, None
    for (name, old), new, ref in zip(_tree.items(params),
                                     _tree.leaves(got_p),
                                     _tree.leaves(want_p)):
        upd, ref_upd = new.float() - old.float(), ref.float() - old.float()
        scale = float(ref_upd.abs().max())
        err = float((upd - ref_upd).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, where = err, name
    _require(worst <= K2_TOL, f"path K2: {where}'s update differs by "
                              f"{worst:.3g} of its largest (> {K2_TOL})")
    print(f"path K2: {cfg.name} d_model={cfg.d_model} {K2_LAYERS} layers "
          f"bf16, one train step of {K2_BATCH} x {K1_SEQ} tokens (AdamW eps "
          f"{K2_EPS}), kernels against plain versions on the card: loss "
          f"{float(got_m['loss'])!r} vs {float(want_m['loss'])!r} "
          f"(|diff| {dloss!r}, within 2e-2); every parameter's update within "
          f"{worst!r} of its largest (worst {where}; tolerance {K2_TOL}); "
          f"grad_norm {float(got_m['grad_norm'])!r} vs "
          f"{float(want_m['grad_norm'])!r}")


def _stacked(tree):
    """A port tree (``layers`` a list of per-layer dicts) as numpy in the
    reference's layout: each layer leaf stacked on a leading dim."""
    import numpy as np

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([lp[k] for lp in layers]) for k in first}
        return np.stack([t.detach().float().cpu().numpy() for t in layers])

    out = {}
    for k, v in tree.items():
        if k == "layers":
            out[k] = stack(v)
        elif isinstance(v, dict):
            out[k] = _stacked(v)
        else:
            out[k] = v.detach().cpu().numpy()
    return out


def run_path_k3(dev, seed):
    """K3: ``repro_torch.examples.elastic_train`` at TINY on the card
    (preempted half-way, resumed from its checkpoint, the loss must fall);
    then a TINY run of 5 steps whose state the port's store writes in the
    reference's layout (layers stacked; the pipeline's cursor in
    ``extra``), read back as numpy and carried onto the card by
    ``params_from_numpy`` and ``opt_state_from_numpy``: equal to the state
    it came from, and one more step from each gives the same loss and
    parameters."""
    import tempfile

    import torch

    from repro_torch import _tree
    from repro_torch.checkpoint import (load_manifest, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.convert import opt_state_from_numpy, params_from_numpy
    from repro_torch.data import TokenPipeline
    from repro_torch.examples import elastic_train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    t0 = time.perf_counter()
    l0, l1 = elastic_train.main(["--device", str(dev)])
    _require(l1 < l0, f"path K3: loss {l0} -> {l1} did not fall")
    print(f"path K3: elastic_train TINY (200 steps, preempted at 100, "
          f"resumed from its checkpoint) on the card: loss {l0!r} -> {l1!r} "
          f"wall_s={time.perf_counter() - t0!r}")

    cfg = elastic_train.TINY
    step = make_train_step(cfg, AdamWConfig(warmup_steps=2, total_steps=10),
                           dev)
    params = init_params(cfg, seed=seed, device=dev)
    state = adamw_init(params)
    pipe = TokenPipeline(8, 64, cfg.vocab_size, seed=seed)
    for _ in range(5):
        params, state, _ = step(params, state, pipe.next_batch())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_k3_") as d:
        save_checkpoint(d, 5, {"params": _stacked(params),
                               "opt": {"mu": _stacked(state["mu"]),
                                       "nu": _stacked(state["nu"]),
                                       "step": state["step"].cpu().numpy()}},
                        extra={"pipeline": pipe.state()})
        tree = restore_checkpoint(d, 5)
        cursor = load_manifest(d, 5)["extra"]["pipeline"]
        keys = sorted(load_manifest(d, 5)["leaves"])
    _require("params/layers/attn/wq" in keys and not any(
        "layers/0" in k for k in keys), f"path K3: not the reference's "
                                        f"layout: {keys[:6]}")
    params2 = params_from_numpy(tree["params"], cfg, device=dev)
    state2 = opt_state_from_numpy(tree["opt"], cfg, device=dev)
    for (name, a), b in zip(_tree.items({"p": params, "s": state}),
                            _tree.leaves({"p": params2, "s": state2})):
        _require(a.dtype == b.dtype and torch.equal(a, b),
                 f"path K3: {name} differs after the round trip")
    pipe2 = TokenPipeline(8, 64, cfg.vocab_size, seed=seed)
    pipe2.load_state(cursor)
    batch, batch2 = pipe.next_batch(), pipe2.next_batch()
    _require(all((batch[k] == batch2[k]).all() for k in batch),
             "path K3: the resumed pipeline gives another batch")
    a = step(params, state, batch)
    b = step(params2, state2, batch)
    dl = abs(float(a[2]["loss"]) - float(b[2]["loss"]))
    dp = max(float((x - y).abs().max()) for x, y in zip(
        _tree.leaves(a[0]), _tree.leaves(b[0])))
    _require(dl <= 1e-6 and dp <= 1e-6, f"path K3: the resumed step differs "
                                        f"(loss {dl}, parameters {dp})")
    print(f"path K3: TINY state after 5 steps written by the port's store in "
          f"the reference's layout ({len(keys)} leaves, layers stacked), read "
          f"back and carried onto the card: equal leaf for leaf; one more "
          f"step from each: |loss diff| {dl!r}, parameters within {dp!r}")


# path L: RWKV-6 training (rwkv6-3b at full width), the WKV backward kernel
L1_BATCH, L1_SEQ, L1_STEPS = 4, 2048, 6
L2_LAYERS, L2_BATCH = 2, 2
#: L2's first step runs at lr 1e-3 (AdamW eps K2_EPS, as K2): at the
#: default schedule's first lr, 3e-6, ``decay_w0`` (-6 at init, a float32
#: ulp of 4.8e-7) moves by ~4 ulps, so one ulp of the parameter's
#: rounding is a quarter of its update and the check would read the
#: parameter's rounding, not the gradient
L2_LR = 1e-3
#: L2's check of the bf16 updates, as ``bwd_rel_errs`` makes one for the
#: flash backward: ||u_kernel - u_plain|| / ||u_plain|| of each leaf's
#: update, ||u_plain|| taken as at least L2_UPDATE_ABS a element.  The
#: largest-magnitude measure reads 0.149-0.197 at ``bonus_u`` in bf16 on
#: an H100 80GB HBM3 at 700 W (PERF.md §6): single elements whose
#: gradient is near 0, where AdamW at eps 1e-3 turns a bf16 rounding flip
#: into a large part of the update; a norm over the leaf weighs them by
#: their size
L2_UPDATE_REL_TOL = 5e-2
L2_UPDATE_ABS = 1e-6


def update_rel_errs(leaves) -> dict:
    """``{leaf: ||got - want|| / ||want||}`` over ``leaves``, an iterable
    of ``(name, got update, want update)``, each ||want|| taken as at
    least L2_UPDATE_ABS a element."""
    out = {}
    for name, g, w in leaves:
        g, w = g.float(), w.float()
        floor = L2_UPDATE_ABS * w.numel() ** 0.5
        out[name] = float((g - w).norm()) / max(float(w.norm()), floor)
    return out


def update_verdict(leaves, tol: float = L2_UPDATE_REL_TOL) -> dict:
    """L2's update checks, without raising: the largest of max |got -
    want| / max |want| over the leaves and its leaf (printed; held to
    K2_TOL in float32), and the largest relative norm of
    :func:`update_rel_errs` and its leaf, held to ``tol`` (L2's
    L2_UPDATE_REL_TOL in both dtypes; the float32 training agreements'
    F32_UPDATE_REL_TOL)."""
    leaves = list(leaves)
    worst, at = _worst_leaf(leaves)
    rels = update_rel_errs(leaves)
    rel_at = max(rels, key=rels.get)
    return dict(max_rel=worst, max_rel_at=at, rel_norm=rels[rel_at],
                rel_norm_at=rel_at, rel_ok=rels[rel_at] <= tol)


#: the WKV backward's second check, as ``bwd_rel_errs`` makes it for the
#: flash backward: ||g - w|| / ||w|| of each gradient whole and of every
#: block of WKV_BWD_BLOCK steps of one (batch row, head) (ds0: of each
#: (batch row, head)), a block's ||w|| taken as at least WKV_BWD_ABS /
#: WKV_BWD_REL_TOL a element.  float32 throughout: sound runs read ~1e-7
WKV_BWD_BLOCK = 64
WKV_BWD_REL_TOL = 1e-4
WKV_BWD_ABS = 1e-6
#: clusters a launch of the WKV backward is timed at beside L1's call
#: (``wkv_bwd_occupancy``): one alone, a quarter and a half of the SMs
WKV_BWD_LADDER = (1, 33, 66)
WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")


def wkv_bwd_inputs(gen, b, t, h, hd, dev):
    """r, k, v, w, u, s0, do, ds_last: unit normals (k halved, u and s0
    scaled), w = exp(-exp(wlog)) with wlog uniform on [-8, 6], so that w
    holds exact zeros (wlog above ~4.65) and values within 3.4e-4 of 1;
    nonzero s0 and ds_last."""
    import torch

    n = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    wlog = torch.rand((b, t, h, hd), generator=gen, device=dev) * 14 - 8
    return [n(b, t, h, hd), n(b, t, h, hd) * 0.5, n(b, t, h, hd),
            torch.exp(-torch.exp(wlog)), n(h, hd) * 0.5,
            n(b, h, hd, hd) * 0.3, n(b, t, h, hd), n(b, h, hd, hd)]


def wkv_bwd_rel_errs(got, want) -> dict:
    """``{gradient: (whole, worst block)}`` of ||g - w|| / ||w||: dr, dk,
    dv, dw by blocks of WKV_BWD_BLOCK steps of one (batch row, head), ds0
    by (batch row, head), du whole; each norm of ``want`` taken as at
    least WKV_BWD_ABS / WKV_BWD_REL_TOL a element."""
    import torch
    import torch.nn.functional as F

    least = WKV_BWD_ABS / WKV_BWD_REL_TOL
    out = {}
    for name, g, w in zip(WKV_GRADS, got, want):
        e, w = g.float() - w.float(), w.float()
        whole = float(e.norm() / max(float(w.norm()),
                                     least * w.numel() ** 0.5))
        if w.dim() == 4 and name != "ds0":      # (B, T, H, hd)
            b, t, h, hd = w.shape
            pad = -t % WKV_BWD_BLOCK
            steps = torch.full(((t + pad) // WKV_BWD_BLOCK,),
                               float(WKV_BWD_BLOCK), device=w.device)
            steps[-1] -= pad
            en, wn = (F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(
                b, -1, WKV_BWD_BLOCK, h, hd).transpose(2, 3).reshape(
                    b, -1, h, WKV_BWD_BLOCK * hd).norm(dim=-1)
                for x in (e, w))
            floor = least * (steps[None, :, None] * hd).sqrt()
        elif name == "ds0":                     # (B, H, hd, hd)
            en, wn = (x.flatten(2).norm(dim=-1) for x in (e, w))
            floor = least * w.shape[-1]
        else:
            en, wn, floor = e.norm(), w.norm(), least * w.numel() ** 0.5
        out[name] = (whole, float((en / torch.maximum(
            wn, torch.as_tensor(floor, device=w.device))).max()))
    return out


def wkv_bwd_verdict(got, want) -> dict:
    """Both checks of a WKV backward against its plain version, without
    raising: for each gradient its largest absolute error, its scale (the
    plain result's largest magnitude), whether the error is within
    ``WKV_TOL`` of the scale, and its relative norms and whether they are
    within ``WKV_BWD_REL_TOL``."""
    rels = wkv_bwd_rel_errs(got, want)
    out = {}
    for name, g, w in zip(WKV_GRADS, got, want):
        scale = float(w.abs().max())
        err = _max_err(g, w)
        out[name] = dict(err=err, scale=scale, rel=rels[name][0],
                         rel_block=rels[name][1],
                         close=bool(g.shape == w.shape
                                    and err <= WKV_TOL * scale),
                         rel_ok=max(rels[name]) <= WKV_BWD_REL_TOL)
    return out


def wkv_ckpt_rel_err(got, want) -> float:
    """The worst ||g - w|| / ||w|| of a forward's checkpoints (B, H, C,
    hd, hd) against the plain forward's, by (batch row, head, checkpoint),
    each norm of ``want`` taken as at least WKV_BWD_ABS / WKV_BWD_REL_TOL
    an element (as ``wkv_bwd_rel_errs`` takes the gradients'): a fault in
    one small state fails it where the largest-magnitude check passes."""
    import torch

    e = (got.float() - want.float()).flatten(3).norm(dim=-1)
    w = want.float().flatten(3).norm(dim=-1)
    floor = WKV_BWD_ABS / WKV_BWD_REL_TOL * want.shape[-1]
    return float((e / torch.clamp(w, min=floor)).max())


def wkv_bwd_row(l0, launches):
    """The WKV backward's kernel row from L0's cases (timed at L1's call)
    and L1's launches (None where L1 did not run)."""
    return dict(
        name="rwkv6_wkv_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6_wkv_bwd.cu",
        replaces="src/repro/models/rwkv6.py:88",
        replaces_note="autodiff of the reference's lax.scan _wkv_scan "
        "(called at :146); its Pallas WKV kernel has no backward",
        launches=launches, launches_by_path={"L1": launches},
        **{**l0["l1"],
           "max_abs_err": max(c["max_abs_err"] for c in l0.values())},
        cases={k: v for k, v in l0.items() if k != "l1"},
        design="one reverse sweep from the training forward's checkpoints "
        "(every 8 steps at hd 64); a head's rows over a cluster of hd / 16 "
        "blocks of 16 rows; a producer warp feeds a two-stage ring by bulk "
        "copies; row warps (4 lanes a row, hd / 4 columns of S and G in "
        "registers) recompute a chunk's states into shared memory and form "
        "dr, dk, dw and dot by one reduce-scatter of 2 shuffle levels; "
        "column warps run G again to form dv's block partial in-thread; "
        "one cluster barrier a chunk, then dv summed over the cluster's "
        "partials in rank order through distributed shared memory; du's "
        "batch partials summed in order by a second kernel (no atomics)")


def wkv_plain_grads(xs):
    """The plain pair on xs (r, k, v, w, u, s0, do, ds_last): the forward
    with checkpoints every ``BWD_CHUNK[hd]`` steps, then the backward that
    reads them."""
    from repro_torch.kernels import rwkv6_scan as ws

    *_, ckpt = ws.rwkv6_wkv_plain(*xs[:6], checkpoints=True)
    return ws.rwkv6_wkv_bwd_plain(*xs[:5], ckpt, *xs[6:])


def wkv_bwd_controls(xs, got, chunk):
    """Faults the WKV backward's checks must see: the carried state
    gradient zeroed at each chunk boundary (the plain backward run a
    chunk at a time, each chunk's ds_last 0 but the last's, from the
    chunk's start state); dw zeroed at the first step of each chunk; the
    last head left out (its gradients zeroed)."""
    import torch

    from repro_torch.kernels import rwkv6_scan as ws

    r, k, v, w, u, s0, do, ds_last = xs
    t = r.shape[1]
    parts, s = [], s0
    for t0 in range(0, t, chunk):
        cut = [x[:, t0:t0 + chunk].contiguous() for x in (r, k, v, w, do)]
        last = t0 + chunk >= t
        parts.append(wkv_plain_grads(
            [*cut[:4], u, s, cut[4],
             ds_last if last else torch.zeros_like(ds_last)]))
        if not last:
            _, s = ws.rwkv6_wkv_plain(*cut[:4], u, s)
    cut = tuple(torch.cat([p[i] for p in parts], 1) for i in range(4)) + (
        sum(p[4] for p in parts), parts[0][5])
    no_dw = list(got)
    no_dw[3] = got[3].clone()
    no_dw[3][:, ::chunk] = 0
    no_head = [x.clone() for x in got]
    for i in range(4):
        no_head[i][:, :, -1] = 0
    no_head[4][-1] = 0
    no_head[5][:, -1] = 0
    return {"state gradient zeroed at each chunk boundary": cut,
            "dw zeroed at each chunk's first step": tuple(no_dw),
            "last head left out": tuple(no_head)}


def _fmt_wkv_verdict(verdict) -> str:
    return " ".join(f"{n}: err={v['err']!r} scale={v['scale']!r} "
                    f"rel={v['rel']:.3e} block={v['rel_block']:.3e}"
                    for n, v in verdict.items())


def wkv_bwd_case(dev, gen, b, t, h, hd, controls=False, timed=False):
    """L0 on r [b, t, h, hd]: the training forward (the forward kernel's
    checkpoint variant) gives out and the last state bit-equal to the
    forward without checkpoints, and checkpoints within ``WKV_TOL`` of
    the plain forward's; the WKV backward kernel, fed the plain forward's
    checkpoints, against its plain version: both checks of
    ``wkv_bwd_verdict``, two calls bit-equal and, with ``controls``, each
    of ``wkv_bwd_controls`` failing the relative check.  With ``timed``,
    the backward kernel and its plain version as CUDA-graph replays and
    the wrapper eager, beside the bound, and the forward kernel with and
    without checkpoints.  Returns the case's row."""
    import torch

    from repro_torch.kernels import rwkv6_scan as ws

    xs = wkv_bwd_inputs(gen, b, t, h, hd, dev)
    fin = xs[:6]
    what = (f"rwkv6_wkv_bwd r=[{b}, {t}, {h}, {hd}] (checkpoint every "
            f"{ws.BWD_CHUNK[hd]} steps, {int((xs[3] == 0).sum())} exact "
            f"zeros in w)")
    out, s_last = ws.rwkv6_wkv_fwd(*fin)
    out_c, s_c, ckpt_k = ws.rwkv6_wkv_fwd(*fin, checkpoints=True)
    *_, ckpt = ws.rwkv6_wkv_plain(*fin, checkpoints=True)
    torch.cuda.synchronize()
    _require(torch.equal(out_c, out) and torch.equal(s_c, s_last),
             f"{what}: the forward with checkpoints gives other out or "
             f"s_last bits than the forward without")
    _require(ckpt_k.shape == ckpt.shape,
             f"{what}: checkpoints {tuple(ckpt_k.shape)}, want "
             f"{tuple(ckpt.shape)}")
    ck_err, ck_scale = _max_err(ckpt_k, ckpt), float(ckpt.abs().max())
    ck_rel = wkv_ckpt_rel_err(ckpt_k, ckpt)
    _require(ck_err <= WKV_TOL * ck_scale and ck_rel <= WKV_BWD_REL_TOL,
             f"{what}: the forward kernel's checkpoints differ from the "
             f"plain forward's by {ck_err} (largest {ck_scale}), relative "
             f"{ck_rel} in the worst (batch row, head, checkpoint)")
    print(f"check {what}: the forward with checkpoints bit-equal in out "
          f"and s_last to the forward without; its {ckpt.shape[2]} "
          f"checkpoints within {ck_err!r} of the plain forward's (largest "
          f"{ck_scale!r}, tolerance {WKV_TOL} of it) and {ck_rel:.3e} "
          f"relative in the worst (batch row, head, checkpoint) (limit "
          f"{WKV_BWD_REL_TOL})")
    del out, s_last, out_c, s_c, ckpt_k
    bx = [*xs[:5], ckpt, *xs[6:]]
    kern = lambda: ws.rwkv6_wkv_bwd(*bx)  # noqa: E731
    plain = lambda: ws.rwkv6_wkv_bwd_plain(*bx)  # noqa: E731
    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    verdict = wkv_bwd_verdict(got, want)
    for name, c in verdict.items():
        _require(c["close"] and c["rel_ok"],
                 f"{what} {name}: kernel disagrees with its plain version "
                 f"(max abs err {c['err']}, largest {c['scale']}; relative "
                 f"norm {c['rel']}, worst block {c['rel_block']}, limit "
                 f"{WKV_BWD_REL_TOL})")
    _require(all(torch.equal(x, y) for x, y in zip(got, again)),
             f"{what}: two calls on the same inputs differ")
    row = dict(max_abs_err=max(c["err"] for c in verdict.values()),
               max_rel_err=max(c["err"] / c["scale"]
                               for c in verdict.values()),
               rel={n: [c["rel"], c["rel_block"]]
                    for n, c in verdict.items()},
               ckpt_max_abs_err=ck_err, ckpt_rel_err=ck_rel)
    print(f"check {what}: within {WKV_TOL} of each gradient's largest and "
          f"{WKV_BWD_REL_TOL} relative (whole and by {WKV_BWD_BLOCK}-step "
          f"blocks): {_fmt_wkv_verdict(verdict)}; two calls bit-equal")
    if controls:
        row["controls"] = {}
        for name, bad in wkv_bwd_controls(xs, got,
                                          ws.BWD_CHUNK[hd]).items():
            cv = wkv_bwd_verdict(bad, want)
            rel = max(max(c["rel"], c["rel_block"]) for c in cv.values())
            row["controls"][name] = rel
            _require(not all(c["rel_ok"] for c in cv.values()),
                     f"{what}: the control '{name}' passes the relative "
                     f"check ({_fmt_wkv_verdict(cv)})")
            alone = all(c["close"] for c in cv.values())
            print(f"check {what} control '{name}': relative {rel:.3e} "
                  f"fails the relative check; the scaled tolerance alone "
                  f"{'PASSES' if alone else 'fails'}")
    del got, again, want
    if timed:
        # operations a (b, t, h): the recomputed state (3 hd^2), the state
        # gradient (3 hd^2), four products with a state (2 hd^2 each), and
        # the per-step vectors (dot, a_t, the bonus terms: 16 hd); bytes:
        # nine streams, s0, ds_last, ds0, u and du (the function's; the
        # kernel also reads the checkpoints, counted apart)
        n_bytes = 4 * (9 * b * t * h * hd + 3 * b * h * hd * hd + 2 * h * hd)
        n_ops = b * t * h * (14 * hd * hd + 16 * hd)
        bnd, by = bound_ms(n_bytes, n_ops)
        row.update(ms=graph_ms(kern, 5), plain_ms=graph_ms(plain, 1),
                   bound_ms=bnd, bound_by=by, library_ms=None,
                   wrapper_ms=cuda_ms(kern, 5)[0],
                   ckpt_bytes=ckpt.numel() * 4,
                   fwd_ms=graph_ms(lambda: ws.rwkv6_wkv_fwd(*fin), 5),
                   fwd_ckpt_ms=graph_ms(
                       lambda: ws.rwkv6_wkv_fwd(*fin, checkpoints=True), 5),
                   **wkv_bwd_occupancy(dev, gen, b, t, h, hd))
        print(f"time {what}: ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
              f"bound_ms={bnd!r} ({by}, {bnd / row['ms']:.1%} of it) "
              f"wrapper_ms={row['wrapper_ms']!r}; it also reads "
              f"{row['ckpt_bytes']} bytes of checkpoints "
              f"({row['ckpt_bytes'] / HBM_BW * 1e3!r} ms at the "
              f"memory rate); the forward kernel on the same inputs "
              f"{row['fwd_ms']!r} ms without checkpoints, "
              f"{row['fwd_ckpt_ms']!r} ms with them (training's call); "
              f"{row['blocks']} blocks of {row['threads']} threads and "
              f"{row['smem_bytes']} bytes of shared memory, "
              f"{row['resident_blocks']} resident at once "
              f"({row['resident_clusters']} clusters): {row['waves']!r} "
              f"waves; one cluster alone (r=[1, {t}, 1, {hd}], a block an "
              f"SM) {row['ms_one_cluster']!r} ms, one full round "
              f"(r=[1, {t}, {row['resident_clusters']}, {hd}], no tail) "
              f"{row['ms_one_round']!r} ms; by clusters (r=[1, {t}, c, "
              f"{hd}]) {row['ms_by_clusters']}")
    del xs, bx, ckpt
    return row


def wkv_bwd_occupancy(dev, gen, b, t, h, hd) -> dict:
    """The WKV backward's launch on r [b, t, h, hd]: its blocks, threads
    and shared memory a block, how many blocks the card holds at once (its
    clusters, by the occupancy API) and so its waves; and the time of a
    launch of c clusters (r [1, t, c, hd]) for c in WKV_BWD_LADDER and
    the clusters the card holds at once: one cluster alone (a block an
    SM) to one full round with no tail, so that the call's time splits
    into the slowdown of blocks that share an SM and its tail wave."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_scan as ws

    n, threads, smem = (ctypes.c_int() for _ in range(3))
    _build.launch("rwkv6_wkv_bwd_occupancy", hd, *(
        ctypes.addressof(x) for x in (n, threads, smem)))
    rb = hd // ws.BWD_ROWS
    ladder = {}
    for c in sorted({*WKV_BWD_LADDER, n.value}):
        xs = wkv_bwd_inputs(gen, 1, t, c, hd, dev)
        *_, ckpt = ws.rwkv6_wkv_fwd(*xs[:6], checkpoints=True)
        bx = [*xs[:5], ckpt, *xs[6:]]
        ladder[c] = graph_ms(lambda: ws.rwkv6_wkv_bwd(*bx), 5)
        del xs, ckpt, bx
    return dict(blocks=b * h * rb, threads=threads.value,
                smem_bytes=smem.value, resident_clusters=n.value,
                resident_blocks=n.value * rb,
                waves=b * h * rb / max(n.value * rb, 1),
                ms_one_cluster=ladder[1], ms_one_round=ladder[n.value],
                ms_by_clusters=ladder)


def run_path_l0(dev, seed):
    """L0: the WKV backward kernel against its plain version at L1's call,
    at hd 16, 32 and 128, at a T no checkpoint stride divides, and at T =
    1; the controls at L1's call and at the ragged T; then ``WKV`` on the
    card against the plain pair's Function, one backward each.  Returns
    the rows by case."""
    import torch

    from repro_torch.kernels import rwkv6_scan as ws

    gen = torch.Generator(dev).manual_seed(seed + 25)
    rows = {"l1": wkv_bwd_case(dev, gen, L1_BATCH, L1_SEQ, 40, 64,
                               controls=True, timed=True),
            "ragged": wkv_bwd_case(dev, gen, 2, 1000, 8, 64, controls=True),
            "t1": wkv_bwd_case(dev, gen, 3, 1, 8, 64)}
    for hd in (16, 32, 128):
        rows[f"hd{hd}"] = wkv_bwd_case(dev, gen, 2, 100, 4, hd,
                                       controls=True)
    xs = wkv_bwd_inputs(gen, 2, 300, 8, 64, dev)
    grads = []
    for fwd, bwd in ((ws.rwkv6_wkv_fwd, ws.rwkv6_wkv_bwd),
                     (ws.rwkv6_wkv_plain, ws.rwkv6_wkv_bwd_plain)):
        leaves = [x.clone().requires_grad_(True) for x in xs[:6]]
        out, s_last = ws.WKV.apply(*leaves, fwd, bwd)
        ((out * xs[6]).sum() + (s_last * xs[7]).sum()).backward()
        grads.append(tuple(x.grad for x in leaves))
    torch.cuda.synchronize()
    _require(all(float(g.abs().max()) > 0 for g in grads[0]),
             "WKV on the card: a zero gradient")
    verdict = wkv_bwd_verdict(*grads)
    _require(all(c["close"] and c["rel_ok"] for c in verdict.values()),
             f"WKV through autograd on the card: kernels against the plain "
             f"pair: {_fmt_wkv_verdict(verdict)}")
    print(f"check WKV through autograd on the card, r=[2, 300, 8, 64]: "
          f"kernels against the plain pair's Function, one backward each: "
          f"{_fmt_wkv_verdict(verdict)}; every gradient nonzero")
    return rows


def _rwkv_train_cfg(**over):
    """rwkv6-3b as the repo configures it for training: f32 parameters,
    bf16 compute, ``remat``."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get(RWKV)
    _require(cfg.param_dtype == "float32" and cfg.dtype == "bfloat16"
             and cfg.remat, f"{RWKV}: not the training config")
    return dataclasses.replace(cfg, **over)


def run_path_l1(dev, seed):
    """L1: rwkv6-3b at full width and depth, L1_STEPS AdamW steps of
    L1_BATCH x L1_SEQ tokens from ``TokenPipeline`` through
    ``make_train_step`` (parameters and state donated, as the training
    driver does).  Exactly 64 forward WKV launches a step (32, and 32
    more in remat's recompute) and 32 backward, finite losses, and a
    nonzero gradient in every layer's tm.w_k, tm.decay_w1 and tm.bonus_u
    (the first moment after step 1).  Returns the launch counts."""
    import gc
    import math

    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_bytes
    from repro_torch.optim import AdamWConfig, adamw_init

    gc.collect()               # a guard: J2's world frees its model when dropped
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = _rwkv_train_cfg()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    opt_state = adamw_init(params)
    torch.cuda.synchronize()
    print(f"path L1: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
          f"{_heads(cfg)} d_ff={cfg.d_ff} vocab={cfg.vocab_size} f32 "
          f"parameters, bf16 compute, remat={cfg.remat}: {cfg.n_params()} "
          f"parameters, {param_bytes(params)} bytes and "
          f"{param_bytes(opt_state)} bytes of AdamW state on the card, drawn "
          f"in {time.perf_counter() - t0!r} s")
    step = make_train_step(cfg, AdamWConfig(warmup_steps=2,
                                            total_steps=L1_STEPS), dev,
                           donate=True)
    pipe = TokenPipeline(L1_BATCH, L1_SEQ, cfg.vocab_size, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    walls = []
    for i in range(L1_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, pipe.next_batch())
        loss = float(m["loss"])            # syncs: the step's wall is whole
        walls.append(time.perf_counter() - t0)
        _require(math.isfinite(loss), f"path L1 step {i + 1}: loss {loss}")
        if i == 0:
            dead = [f"layers.{j}.tm.{w}"
                    for j, lp in enumerate(opt_state["mu"]["layers"])
                    for w in ("w_k", "decay_w1", "bonus_u")
                    if not float(lp["tm"][w].abs().max()) > 0]
            _require(not dead, f"path L1: zero gradients in {dead}")
        print(f"path L1 step {i + 1}: loss={loss!r} lr={float(m['lr'])!r} "
              f"grad_norm={float(m['grad_norm'])!r} wall_s={walls[-1]!r}")
    peak = torch.cuda.max_memory_allocated()
    counts = _build.launch_counts()
    launches = {k: counts[k] for k in ("rwkv6_wkv_fwd", "rwkv6_wkv_bwd")}
    want = {"rwkv6_wkv_fwd": 2 * cfg.n_layers * L1_STEPS,
            "rwkv6_wkv_bwd": cfg.n_layers * L1_STEPS}
    _require(launches == want, f"path L1: launches {launches}, want {want}")
    others = {k: n for k, n in counts.items() if n and k not in launches}
    _require(not others, f"path L1 launched {others}")
    tokens = L1_BATCH * L1_SEQ
    steady = walls[1:]
    print(f"path L1: {L1_STEPS} steps of {L1_BATCH} x {L1_SEQ} tokens: "
          f"wall_s={sum(walls)!r} first step {walls[0]!r} s, steps 2-"
          f"{L1_STEPS} mean {sum(steady) / len(steady)!r} s "
          f"({tokens * len(steady) / sum(steady)!r} tokens/s); "
          f"peak_mem_bytes={peak} (of which {held} held by earlier paths "
          f"before L1) launches={launches} (a step: {2 * cfg.n_layers} "
          f"forward, {cfg.n_layers} of them recomputed by remat, and "
          f"{cfg.n_layers} backward); every layer's tm.w_k, tm.decay_w1 and "
          f"tm.bonus_u gradient nonzero")
    profile_train_step(lambda: step(params, opt_state, pipe.next_batch()),
                       "path L1")
    del params, opt_state
    return launches


def _profiled(run, **opts):
    """``(the profiler, wall seconds)`` of one call of ``run`` (which
    syncs) under ``torch.profiler`` (``opts`` its options, e.g.
    ``record_shapes``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], **opts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    return prof, wall


def _device_time(prof):
    """``(kernel intervals, device ms by kernel name, busy ms)``: busy is
    the union of the kernels' intervals.  A ``record_function`` range's
    own span on the device (a user annotation, not a kernel) is left
    out."""
    from collections import defaultdict

    spans, by_name = [], defaultdict(float)
    for e in prof.events():
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False)
                and e.time_range.end > e.time_range.start):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    busy, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy = (busy + (0 if cur is None else cur[1] - cur[0])) / 1e3
    return spans, by_name, busy


def _op_device_ms(prof) -> dict:
    """Self device ms by operator (``aten::bmm``, ``aten::mm``, ...)."""
    return {e.key: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) / 1e3
            for e in prof.key_averages()}


def profile_decode_step(run, what: str, label: str = "one decode step"
                        ) -> None:
    """One eager decode step (``run``; or the call ``label`` names) under
    ``torch.profiler``: its wall, the card's busy time and idle share,
    and the device ms of the operators that took the most
    (``aten::bmm`` is the MoE experts' batched products, ``aten::mm``
    every other projection)."""
    import torch

    prof, wall = _profiled(lambda: (run(), torch.cuda.synchronize()))
    spans, by_name, busy = _device_time(prof)
    ops = sorted(((k, v) for k, v in _op_device_ms(prof).items()
                  if k.startswith("aten::") and v > 0),
                 key=lambda kv: -kv[1])[:8]
    ours = sum(v for k, v in by_name.items()
               if any(n in k for n in ("decode_split", "decode_merge",
                                       "flash_attention", "rwkv6_wkv")))
    print(f"  {what} {label} under torch.profiler: wall_ms="
          f"{wall * 1e3!r} device_busy_ms={busy!r} (idle "
          f"{1 - busy / (wall * 1e3):.1%}) kernels={len(spans)}; the "
          f"port's own kernels {ours!r} ms; device ms by operator: "
          + "; ".join(f"{k} {v!r}" for k, v in ops))


#: the kernels ``profile_train_step`` reports by name: the WKV kernels'
#: backward and forward (path L1) by default
WKV_KERNELS = (("rwkv6_wkv_bwd", "rwkv6_wkv_bwd"),
               ("rwkv6_wkv", "rwkv6_wkv_kernel"))


def profile_train_step(run, what: str, kernels=WKV_KERNELS,
                       parts=None) -> None:
    """One more call of ``run`` (a train step, donated) under
    ``torch.profiler``: its wall, the card's busy time (the union of its
    kernels' intervals) and share of the wall, the device time of the
    matmuls (``aten::mm``), of each of ``kernels`` (``(label, substring
    of the kernel's name)`` pairs) and of everything else, and the five
    kernels that took the most.  With ``parts`` (a function of the
    profile and the device ms by kernel name that gives ``{label: device
    ms}``, e.g. :func:`moe_step_parts`), the profile records every
    operator's input shapes, and a line follows for each part and for
    the rest."""
    prof, wall = _profiled(lambda: float(run()[2]["loss"]),
                           record_shapes=parts is not None)
    spans, by_name, busy = _device_time(prof)
    mm = _op_device_ms(prof).get("aten::mm", 0.0)
    ours = {label: sum(v for k, v in by_name.items() if sub in k)
            for label, sub in kernels}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    total = sum(by_name.values())
    print(f"{what} profile (one more step under torch.profiler): "
          f"wall_ms={wall * 1e3!r} device_busy_ms={busy!r} "
          f"({busy / (wall * 1e3):.1%} of the wall; idle "
          f"{1 - busy / (wall * 1e3):.1%}) kernels={len(spans)} "
          f"kernel_ms={total!r}: aten::mm {mm!r}, "
          + "".join(f"{k} {v!r}, " for k, v in ours.items())
          + f"the rest {total - mm - sum(ours.values())!r}"
          f"; the five kernels that took the most (ms): "
          + "; ".join(f"{k[:60]} {v!r}" for k, v in top))
    if parts is not None:
        split = parts(prof, by_name)
        for k, v in split.items():
            print(f"  {what} {k}: {v!r} ms ({v / max(total, 1e-9):.1%})")
        print(f"  {what} the rest: {total - sum(split.values())!r} ms")


def _l2_grads(params, cfg, batch, pair):
    """The loss and every parameter's gradient of one forward and backward
    with the WKV pair ``pair`` (as :func:`_swapped` takes it) on the
    parameters' device."""
    import torch

    from repro_torch import _tree
    from repro_torch.models import forward

    dev = params["embedding"]["table"].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with _swapped(pair):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in _tree.items(params)}
        loss, _ = forward(_tree.unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def _worst_leaf(leaves):
    """The largest of max |got - want| / max |want| over ``leaves``, an
    iterable of ``(name, got, want)``, and its leaf's name."""
    worst, where = 0.0, None
    for name, g, w in leaves:
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, where = err, name
    return worst, where


def run_path_l2(dev, seed):
    """L2: rwkv6-3b at full width with L2_LAYERS layers and L2_BATCH x
    L1_SEQ tokens, the WKV kernels against their plain versions swapped
    in (forward and backward), from the same weights and batch, in
    float32 and in bfloat16 compute (L1's): one ``make_train_step`` step
    each (AdamW eps K2_EPS, as K2, at lr L2_LR) and one forward and
    backward each.  The loss within 2e-2 and every parameter's gradient
    within K2_TOL of its largest, and in float32 every parameter's update
    within K2_TOL of its largest update.  In bfloat16 the f32
    recurrences' last-bit differences flip bf16 roundings downstream and
    the raw gradients part by ~1%, which AdamW at eps 1e-3 turns into up
    to ~15% of an update where a gradient is near 0: that largest gap is
    printed, and every leaf's update is held, in both dtypes, by its
    relative norm (:func:`update_verdict`, L2_UPDATE_REL_TOL)."""
    import torch

    from repro_torch import _tree
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_scan as ws
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, rwkv6
    from repro_torch.optim import AdamWConfig, adamw_init

    kernels = [(rwkv6, "rwkv6_wkv_fwd", ws.rwkv6_wkv_fwd),
               (rwkv6, "rwkv6_wkv_bwd", ws.rwkv6_wkv_bwd)]
    plain = [(rwkv6, "rwkv6_wkv_fwd", ws.rwkv6_wkv_plain),
             (rwkv6, "rwkv6_wkv_bwd", ws.rwkv6_wkv_bwd_plain)]
    opt = AdamWConfig(lr=L2_LR, warmup_steps=1, eps=K2_EPS)
    want_launches = {"rwkv6_wkv_fwd": 2 * L2_LAYERS,
                     "rwkv6_wkv_bwd": L2_LAYERS}
    for dtype in ("float32", "bfloat16"):
        cfg = _rwkv_train_cfg(n_layers=L2_LAYERS, dtype=dtype)
        params = init_params(cfg, seed=seed + 3, device=dev)
        batch = TokenPipeline(L2_BATCH, L1_SEQ, cfg.vocab_size,
                              seed=seed + 3).next_batch()
        step = make_train_step(cfg, opt, dev)
        out = []
        for pair in (kernels, plain):
            with _swapped(pair):
                _build.reset_launches()
                out.append(step(params, adamw_init(params), batch))
                torch.cuda.synchronize()
                counts = {k: _build.launch_counts()[k]
                          for k in want_launches}
            _require(counts == (want_launches if pair is kernels
                                else dict.fromkeys(counts, 0)),
                     f"path L2 {dtype}: launches {counts}")
        (got_p, _, got_m), (want_p, _, want_m) = out
        dloss = abs(float(got_m["loss"]) - float(want_m["loss"]))
        _require(dloss <= 2e-2, f"path L2 {dtype}: losses "
                                f"{float(got_m['loss'])} and "
                                f"{float(want_m['loss'])} differ by {dloss}")
        uv = update_verdict(
            (name, new.float() - old.float(), ref.float() - old.float())
            for (name, old), new, ref in zip(_tree.items(params),
                                             _tree.leaves(got_p),
                                             _tree.leaves(want_p)))
        upd, upd_at = uv["max_rel"], uv["max_rel_at"]
        del out, got_p, want_p
        (_, got_g), (_, want_g) = (_l2_grads(params, cfg, batch, pair)
                                   for pair in (kernels, plain))
        grad, grad_at = _worst_leaf((name, g, want_g[name])
                                    for name, g in got_g.items())
        del params, got_g, want_g
        print(f"path L2: {cfg.name} d_model={cfg.d_model} {L2_LAYERS} "
              f"layers {dtype}, {L2_BATCH} x {L1_SEQ} tokens, WKV kernels "
              f"against their plain versions on the card: loss "
              f"{float(got_m['loss'])!r} vs {float(want_m['loss'])!r} "
              f"(|diff| {dloss!r}, within 2e-2); one step (AdamW lr "
              f"{L2_LR}, eps {K2_EPS}): updates within {upd!r} of the "
              f"largest (worst {upd_at}), relative norm by leaf "
              f"{uv['rel_norm']!r} (worst {uv['rel_norm_at']}, held to "
              f"{L2_UPDATE_REL_TOL}); gradients within {grad!r} of the "
              f"largest (worst {grad_at}); held to {K2_TOL}: the gradients"
              + (" and the updates" if dtype == "float32" else
                 " (AdamW's eps turns bf16 rounding near g = 0 into update "
                 "gaps of single elements: held by the relative norm)"))
        _require(grad <= K2_TOL, f"path L2 {dtype}: {grad_at}'s gradient "
                                 f"differs by {grad:.3g} of its largest "
                                 f"(> {K2_TOL})")
        _require(dtype != "float32" or upd <= K2_TOL,
                 f"path L2 {dtype}: {upd_at}'s update differs by "
                 f"{upd:.3g} of its largest (> {K2_TOL})")
        _require(uv["rel_ok"], f"path L2 {dtype}: {uv['rel_norm_at']}'s "
                               f"update differs by a relative norm of "
                               f"{uv['rel_norm']:.3g} (> {L2_UPDATE_REL_TOL})")


def path_a_traffic(dev, seed):
    """Path A's traffic: 4096 groups x 2880 steps x 14 partitions."""
    rates, act = traffic_mix(4096, 2880, 14, seed, dev)
    print(f"path A data: rates {tuple(rates.shape)} "
          f"{rates.numel() * 4 / 1e6!r} MB on the card")
    return rates, act


def path_b_traffic(dev, seed):
    """Paths B, C1, G and H1's traffic: 1024 groups x 480 steps x 32."""
    return traffic_mix(1024, 480, 32, seed + 10, dev)


def run_path_a(rates_a, act_a):
    """Path A: the heuristic packers through the ``loop_fused`` kernel,
    then its first 32 groups x 480 steps on the wide fused path.  Returns
    the launch counts."""
    from repro_torch import api

    out_a, launches_a = run_path("A", HEURISTICS, rates_a, act_a,
                                 ("loop_fused",), fused_steps=8,
                                 fused_kernel=True)
    small = api.simulate(rates_a[:32, :480], policies=HEURISTICS,
                         active=act_a[:32, :480], device="cuda",
                         fused_steps=8)
    _agree(small, out_a, 32, 480, "path A against the wide fused path")
    return launches_a


def run_path_b(rates_b, act_b):
    """Path B: the per-step loop, the drain and every packing call through
    kernels; its first 16 groups x 48 steps on the CPU; the torch ops a
    step.  Returns the launch counts."""
    from repro_torch import api

    steps_b = rates_b.shape[1]
    out_b, launches_b = run_path(
        "B", PATH_B, rates_b, act_b, ("lag_update_batch", "pack_rows"),
        exact={"pack_rows": 5 * steps_b, "select_slot_grid": 0,
               "lag_update_batch": len(PATH_B) * steps_b}, use_kernel=True)
    small = api.simulate(rates_b[:16, :48].cpu(), policies=PATH_B,
                         active=act_b[:16, :48].cpu(), device="cpu",
                         use_kernel=True)
    _agree(small, out_b, 16, 48, "path B against the CPU plain versions")
    del small, out_b
    ops_b, _ = path_b_ops(rates_b, act_b)
    print(f"path B: lag_update launches={launches_b['lag_update_batch']} "
          f"(one a policy a step, {len(PATH_B)} x {steps_b}); torch ops a "
          f"step, the {len(PATH_B)} policies together: {ops_b}")
    return launches_b


def run_path_c1(rates_b, act_b):
    """Path C1: the annealer policies over path B's traffic, every anneal
    step one ``anneal_step`` launch.  Returns the launch counts."""
    out_c1, launches_c1 = run_path(
        "C1", PATH_C1, rates_b, act_b, ("anneal_step",),
        exact={"anneal_step": len(PATH_C1) * rates_b.shape[1] * 48,
               "move_delta_batch": 0})
    path_c1_agreement(out_c1, rates_b, act_b)
    del out_c1
    path_c1_ops(rates_b, act_b)
    return launches_c1


def run_path_h(dev, seed, rates_b, act_b):
    """Path H: H1a and H1b over path B's traffic, their torch ops, H2 and
    H3.  Returns the launch counts summed over H1a, H1b and H3."""
    from repro_torch.lagsim import ControlPlaneConfig

    _, launches_h1a = run_path_h1("H1a", PATH_H_REAL, rates_b, act_b)
    _, launches_h1b = run_path_h1("H1b", PATH_H_CP, rates_b, act_b,
                                  control_plane=ControlPlaneConfig(**H_CP))
    path_h_ops(rates_b, act_b)
    run_path_h2(dev, seed)
    launches_h3 = run_path_h3(dev, seed)
    launches_h = {k: launches_h1a[k] + launches_h1b[k] + launches_h3[k]
                  for k in ("lag_update_batch", "pack_rows")}
    print(f"path H launches: H1a {launches_h1a}, H1b {launches_h1b}, H3 "
          f"{launches_h3}; in all {launches_h}")
    return launches_h


def run_path_i(dev, seed):
    """Path I: I1 and I2.  Returns the launch counts of both."""
    t0 = time.perf_counter()
    launches_i1 = run_path_i1(dev, seed)
    launches_i2 = run_path_i2(dev, seed)
    launches_i = {k: launches_i1[k] + launches_i2.get(k, 0)
                  for k in launches_i1}
    print(f"path I: wall_s={time.perf_counter() - t0!r} launches: I1 "
          f"{launches_i1}, I2 with its replays {launches_i2}; in all "
          f"{launches_i}")
    return launches_i


def run_path_d(dev, seed):
    """Path D: qwen3-8b serving, then the 4-layer agreement check of the
    attention kernels.  Returns the launch counts."""
    import torch

    launches_d = run_serving_path(dev, seed, "D", LLM,
                                  "flash_attention_fwd",
                                  "decode_attention_fwd")
    torch.cuda.empty_cache()
    agreement(dev, seed, LLM, _attention_plain())
    torch.cuda.empty_cache()
    return launches_d


def _attention_plain():
    """The attention kernels' plain versions, as :func:`_swapped` takes
    them."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    return [(attention, "flash_attention_fwd", fa.flash_attention_plain),
            (attention, "decode_attention_fwd", da.decode_attention_plain),
            (attention, "decode_attention_tailed_fwd",
             da.decode_attention_tailed_plain)]


def run_path_e(dev, seed):
    """Path E: rwkv6-3b serving, then the 4-layer agreement check of the
    WKV kernel.  Returns the launch counts."""
    import torch

    from repro_torch.kernels import rwkv6_scan as ws
    from repro_torch.models import rwkv6

    launches_e = run_serving_path(dev, seed, "E", RWKV,
                                  "rwkv6_wkv_fwd", "rwkv6_wkv_fwd")
    torch.cuda.empty_cache()
    agreement(dev, seed, RWKV,
              [(rwkv6, "rwkv6_wkv_fwd", ws.rwkv6_wkv_plain)])
    torch.cuda.empty_cache()
    return launches_e


def run_path_m(dev, seed):
    """Path M: qwen2-moe-a2.7b serving at full width and depth (24 MoE
    layers of 60 experts, top-4, and 4 shared), then the 4-layer agreement
    check of the attention kernels with the expert dispatch between them.
    Returns the launch counts."""
    import torch

    launches = run_serving_path(dev, seed, "M", MOE, "flash_attention_fwd",
                                "decode_attention_fwd")
    torch.cuda.empty_cache()
    agreement(dev, seed, MOE, _attention_plain())
    torch.cuda.empty_cache()
    return launches


def run_path_n(dev, seed):
    """Path N: jamba-v0.1-52b at full width, cut to one period of its 4
    (HYBRID_LAYERS = 8 layers: 1 attention, 7 Mamba, 4 MoE of 16 experts,
    top-2), serving, then the agreement check at those 8 layers in
    float32 (~53 GB).  Returns the launch counts."""
    import torch

    launches = run_serving_path(dev, seed, "N", HYBRID,
                                "flash_attention_fwd",
                                "decode_attention_fwd",
                                layers=HYBRID_LAYERS)
    torch.cuda.empty_cache()
    agreement(dev, seed, HYBRID, _attention_plain(), layers=HYBRID_LAYERS)
    torch.cuda.empty_cache()
    return launches


#: path O: whisper-large-v3, the encoder-decoder family
WHISPER = "whisper-large-v3"
#: O1 and O2: requests (30 s of audio, 1500 frames, each), the decoder
#: prompt, and O2's greedy steps after it (a 256-position cache, under
#: the 448 learned positions)
O_BATCH, O_PROMPT, O_GEN = 8, 32, 224
#: O3: batch, decoder tokens (all 448 learned positions), timed steps
#: after one warm-up step
O_TRAIN_BATCH, O_TRAIN_SEQ, O_TRAIN_STEPS = 4, 448, 4
#: the agreement checks: encoder and decoder layers each, at full width
O_AGREE_LAYERS = 4


def _whisper_cfg(**over):
    """whisper-large-v3 as published (f32 parameters, bf16 compute,
    remat), with ``over`` replaced."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get(WHISPER)
    _require(cfg.encoder_decoder and cfg.param_dtype == "float32"
             and cfg.dtype == "bfloat16" and cfg.remat,
             f"{WHISPER}: not the published config")
    return dataclasses.replace(cfg, **over)


def _whisper_header(tag, cfg, params) -> str:
    from repro_torch.models import param_bytes

    return (f"path {tag}: {cfg.name} {cfg.n_encoder_layers} encoder + "
            f"{cfg.n_layers} decoder layers d_model={cfg.d_model} "
            f"heads={cfg.n_heads}x{cfg.head_dim} (kv {cfg.n_kv_heads}) "
            f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} T_enc="
            f"{cfg.encoder_seq_len} params {cfg.param_dtype} compute "
            f"{cfg.dtype}: {cfg.n_params()} parameters, "
            f"{param_bytes(params)} bytes on the card")


def _whisper_inputs(cfg, dev, seed, batch, seq):
    """Frame embeddings (batch, T_enc, d) float32 and decoder tokens
    (batch, seq), drawn on the card from ``seed``."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    frames = torch.randn((batch, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (batch, seq), generator=gen,
                         device=dev)
    return frames, toks


def whisper_step_bytes(cfg, params, state, fill: int) -> dict:
    """The bytes one whisper decode step at ``fill`` must move: the
    decoder's weights but the cross-attention's wk and wv (read only by
    ``precompute_cross_kv``), the final norm and the head (of the token
    and position tables one row each, counted as nothing); the filled
    self-attention K/V; every layer's cross K/V, read whole."""
    from repro_torch.models import param_bytes

    layers = params["layers"]
    weights = (param_bytes(layers) + param_bytes(params["final_norm"])
               + param_bytes(params["lm_head"])
               - sum(param_bytes([lp["cross_attn"]["wk"],
                                  lp["cross_attn"]["wv"]]) for lp in layers))
    kv = state["kv"]
    kv_read = 2 * param_bytes(kv["k"]) * (fill + 1) // kv["k"].shape[3]
    cross = param_bytes(state["cross_k"]) + param_bytes(state["cross_v"])
    return {"weights": weights, "kv": kv_read, "cross_kv": cross,
            "bound_ms": (weights + kv_read + cross) / HBM_BW * 1e3}


def _flash_call(dev, gen, b, h, kv, sq, skv, hd, causal, what):
    """The flash forward at q [b, h, sq, hd] over k/v [b, kv, skv, hd]:
    held against its plain version in float32 and bfloat16
    (``check_flash``), then timed in bfloat16 as CUDA-graph replays beside
    its plain version, SDPA and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun

    err = check_flash(dev, gen, b, h, kv, sq, skv, hd, causal=causal)
    q = _normal(gen, (b, h, sq, hd), "bfloat16", dev)
    k = _normal(gen, (b, kv, skv, hd), "bfloat16", dev)
    v = _normal(gen, (b, kv, skv, hd), "bfloat16", dev)
    kern = lambda: fa.flash_attention_fwd(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(  # noqa: E731
        q, k, v, causal=causal)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal, enable_gqa=kv != h)
    bnd, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                       4 * b * h * hd * dryrun.causal_pairs(sq, skv, causal),
                       PEAK_FLOPS_BF16)
    row = dict(max_abs_err=err, ms=graph_ms(kern, 10),
               plain_ms=graph_ms(plain, 2), bound_ms=bnd, bound_by=by,
               library_ms=graph_ms(lib, 10), wrapper_ms=cuda_ms(kern, 10)[0])
    print(f"time {what}: flash_attention q=[{b}, {h}, {sq}, {hd}] over k/v "
          f"[{b}, {kv}, {skv}, {hd}] causal={causal} bf16: ms={row['ms']!r} "
          f"plain_ms={row['plain_ms']!r} bound_ms={bnd!r} ({by}, "
          f"{bnd / row['ms']:.1%} of it) sdpa_ms={row['library_ms']!r} "
          f"wrapper_ms={row['wrapper_ms']!r}")
    return row


def _decode_call(dev, gen, b, kv, g, s, fill, hd, what):
    """The bfloat16 decode kernel at q [b, kv, g, hd] over caches [b, kv,
    s, hd] at ``fill``, timed as CUDA-graph replays beside its plain
    version, SDPA over the filled positions and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da

    q = _normal(gen, (b, kv, g, hd), "bfloat16", dev)
    kc = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    vc = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    clen = torch.tensor(fill, dtype=torch.int32, device=dev)
    q4 = q.reshape(b, kv * g, 1, hd)
    kern = lambda: da.decode_attention_fwd(q, kc, vc, clen)  # noqa: E731
    plain = lambda: da.decode_attention_plain(q, kc, vc, clen)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, kc[:, :, :fill + 1], vc[:, :, :fill + 1], enable_gqa=g > 1)
    _require(torch.allclose(lib().reshape(q.shape).float(), kern().float(),
                            rtol=2e-2, atol=2e-2),
             f"{what}: decode_attention and SDPA disagree")
    bnd, by = bound_ms(2 * (2 * q.numel() + 2 * b * kv * (fill + 1) * hd),
                       4 * b * kv * g * (fill + 1) * hd, PEAK_FLOPS_BF16)
    row = dict(ms=graph_ms(kern, 200), plain_ms=graph_ms(plain, 50),
               bound_ms=bnd, bound_by=by, library_ms=graph_ms(lib, 200),
               wrapper_ms=cuda_ms(kern, 200)[0])
    print(f"time {what}: decode_attention q=[{b}, {kv}, {g}, {hd}] cache "
          f"{s} at fill {fill} bf16: ms={row['ms']!r} "
          f"plain_ms={row['plain_ms']!r} bound_ms={bnd!r} ({by}, "
          f"{bnd / row['ms']:.1%} of it) sdpa_ms={row['library_ms']!r} "
          f"wrapper_ms={row['wrapper_ms']!r}")
    return row


def run_path_o0(dev, seed):
    """O0: the attention kernels at whisper's calls, each against its
    plain version with the tolerances and relative checks of the other
    paths, timed as CUDA-graph replays beside SDPA (and SDPA's backward)
    and its bound: the flash forward without the mask at O1's encoder
    call (q = k = v [8, 20, 1500, 64]) and cross call (q [8, 20, 32, 64]
    over k/v [8, 20, 1500, 64]), and causal at its decoder self call; the
    flash backward without the mask at O3's encoder call ([4, 20, 1500,
    64]) and cross call (q [4, 20, 448, 64] over k/v [4, 20, 1500, 64]),
    and causal at its self call; the decode kernel at O2's cross call (q
    [8, 20, 1, 64] over a [8, 20, 1500, 64] cache at fill 1499) and self
    call (a 256-position cache), also at split-boundary fills and
    replayed from a CUDA graph.  Returns the cases by name."""
    import torch

    from repro_torch.kernels import decode_attention as da

    cfg = _whisper_cfg()
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t, g = cfg.encoder_seq_len, cfg.n_heads // cfg.n_kv_heads
    gen = torch.Generator(dev).manual_seed(seed + 31)
    out = {
        "fwd_encoder": _flash_call(dev, gen, O_BATCH, h, kv, t, t, hd, False,
                                   "path O1's encoder call"),
        "fwd_cross": _flash_call(dev, gen, O_BATCH, h, kv, O_PROMPT, t, hd,
                                 False, "path O1's cross call"),
        "fwd_self": _flash_call(dev, gen, O_BATCH, h, kv, O_PROMPT,
                                O_PROMPT, hd, True,
                                "path O1's decoder self call"),
        "bwd_encoder": bwd_case(dev, gen, O_TRAIN_BATCH, h, kv, t, hd,
                                "bfloat16", False),
        "bwd_cross": bwd_case(dev, gen, O_TRAIN_BATCH, h, kv, O_TRAIN_SEQ,
                              hd, "bfloat16", False, skv=t),
        "bwd_self": bwd_case(dev, gen, O_TRAIN_BATCH, h, kv, O_TRAIN_SEQ, hd,
                             "bfloat16", True)}
    cache = O_PROMPT + O_GEN
    split = da.decode_splits(O_BATCH, kv, cache)
    split_x = da.decode_splits(O_BATCH, kv, t)
    err = max(
        check_decode(dev, gen, O_BATCH, kv, g, t, hd,
                     (0, 4 * split_x - 1, t // split_x, t - 2, t - 1)),
        check_decode_graph(dev, gen, O_BATCH, kv, g, t, hd, (17, t - 1)),
        check_decode(dev, gen, O_BATCH, kv, g, cache, hd,
                     (0, 4 * split - 2, 4 * split - 1, cache - 1)),
        check_decode_graph(dev, gen, O_BATCH, kv, g, cache, hd,
                           (31, cache - 1)))
    out["decode_cross"] = dict(
        _decode_call(dev, gen, O_BATCH, kv, g, t, t - 1, hd,
                     "path O2's cross call"), max_abs_err=err)
    out["decode_self"] = dict(
        _decode_call(dev, gen, O_BATCH, kv, g, cache, cache - 1, hd,
                     "path O2's self call at the cache's last fill"),
        max_abs_err=err)
    return out


def run_path_o1(dev, seed):
    """O1: whisper-large-v3 prefill at full width and depth in bfloat16
    (3.21 GB of weights): O_BATCH requests of 1500 frames and an
    O_PROMPT-token decoder prompt through ``make_prefill_step``, exactly
    3 x 32 flash launches (32 encoder and 32 cross without the mask, 32
    decoder self causal).  Returns the launch counts."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = _whisper_cfg(param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    print(f"{_whisper_header('O1', cfg, params)}, drawn in "
          f"{time.perf_counter() - t0!r} s")
    frames, prompts = _whisper_inputs(cfg, dev, seed, O_BATCH, O_PROMPT)
    prefill = make_prefill_step(cfg, dev)
    prefill(params, {"inputs": frames[:1], "decoder_tokens":
                     prompts[:1, :4]})                  # cuBLAS warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, {"inputs": frames, "decoder_tokens": prompts})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _launched("flash_attention_fwd", 3 * cfg.n_layers, "path O1")
    # the same call again: the first one at these shapes also pays
    # cuBLAS's first choice of its kernels
    t0 = time.perf_counter()
    prefill(params, {"inputs": frames, "decoder_tokens": prompts})
    torch.cuda.synchronize()
    again = time.perf_counter() - t0
    profile_decode_step(lambda: prefill(params, {
        "inputs": frames, "decoder_tokens": prompts}), "path O1",
        "one prefill call")
    _require(tuple(logits.shape) == (O_BATCH, cfg.vocab_size)
             and bool(torch.isfinite(logits).all()),
             f"path O1: logits {tuple(logits.shape)} not finite of shape "
             f"[{O_BATCH}, {cfg.vocab_size}]")
    print(f"path O1 (prefill): {O_BATCH} requests x ({cfg.encoder_seq_len} "
          f"frames + {O_PROMPT} decoder tokens) wall_s={wall!r} "
          f"frames_per_s={O_BATCH * cfg.encoder_seq_len / wall!r} "
          f"(a second call {again!r} s) "
          f"launches={{'flash_attention_fwd': {n}}} (a layer pair: encoder "
          f"and cross without the mask, decoder self causal) "
          f"logits_absmax={float(logits.float().abs().max())!r}")
    return {"O1": n}


def run_path_o2(dev, seed):
    """O2: whisper-large-v3 generation at full width and depth in
    bfloat16: ``encode`` (32 flash launches) and ``precompute_cross_kv``
    once, then O_PROMPT + O_GEN steps of ``make_serve_step`` in a
    256-position cache (the prompt teacher-forced, then each step fed the
    argmax of the one before, on the card: no host sync), exactly 64
    decode launches a step (32 self, 32 cross).  Then one step's device
    time as a CUDA-graph replay, its torch ops, one step under
    ``torch.profiler``, and the bytes a step must move; then the
    serving agreement (:func:`whisper_serving_agreement`).  Returns the
    launch counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_decode_state, init_params, param_bytes
    from repro_torch.models.whisper import encode, precompute_cross_kv

    cfg = _whisper_cfg(param_dtype="bfloat16")
    params = init_params(cfg, seed=seed, device=dev)
    print(_whisper_header("O2", cfg, params))
    frames, prompts = _whisper_inputs(cfg, dev, seed, O_BATCH, O_PROMPT)
    cache = O_PROMPT + O_GEN
    step = make_serve_step(cfg, dev)
    with torch.no_grad():                              # cuBLAS warm-up
        warm = init_decode_state(cfg, 1, 4, dev)
        warm["cross_k"], warm["cross_v"] = precompute_cross_kv(
            params, cfg, encode(params, cfg, frames[:1]))
        step(params, warm, {"inputs": prompts[:1, 0]})
    del warm
    state = init_decode_state(cfg, O_BATCH, cache, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        state["cross_k"], state["cross_v"] = precompute_cross_kv(
            params, cfg, encode(params, cfg, frames))
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    launches = {"O2_encode": _launched("flash_attention_fwd", cfg.n_layers,
                                       "path O2's encode")}
    _build.reset_launches()
    t0 = time.perf_counter()
    cur, out = None, []
    for t in range(cache):
        tok = prompts[:, t] if t < O_PROMPT else cur
        logits, state = step(params, state, {"inputs": tok})
        cur = logits.argmax(-1)
        if t >= O_PROMPT - 1:
            out.append(cur)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches["O2"] = _launched("decode_attention_fwd",
                               2 * cfg.n_layers * cache, "path O2")
    gen_toks = torch.stack(out, 1).cpu()
    _require(int(state["cache_len"]) == cache
             and bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()),
             "path O2: cache_len or generated tokens out of range")
    print(f"path O2 (generate): encode + precompute_cross_kv of {O_BATCH} x "
          f"{cfg.encoder_seq_len} frames {enc_s!r} s; {O_BATCH} requests x "
          f"({O_PROMPT} teacher-forced + {O_GEN} greedy) steps in a {cache}"
          f"-position cache, decode state {param_bytes(state)} bytes: "
          f"wall_s={wall!r} ms_per_decode_step={wall / cache * 1e3!r} "
          f"decode_tokens_per_s={O_BATCH * cache / wall!r} "
          f"peak_mem_bytes={peak} launches={launches} (a step: "
          f"{cfg.n_layers} self + {cfg.n_layers} cross decode launches)")
    print(f"  tokens[0, :16]={np.asarray(gen_toks[0, :16]).tolist()}")

    # one decode step at the cache's last fill: its device time replayed
    # as a CUDA graph (no host work in it) and the torch ops it dispatches
    state["cache_len"].fill_(cache - 1)
    tok = prompts[:, 0]
    step_ms = graph_ms(lambda: step(params, state, {"inputs": tok}), 1)
    with _op_counter() as ops:
        step(params, state, {"inputs": tok})
    profile_decode_step(lambda: step(params, state, {"inputs": tok}),
                        "path O2")
    print(f"  one decode step at fill {cache - 1}: device_ms={step_ms!r} "
          f"(CUDA graph replay) torch_ops={ops.n} "
          f"({ops.n / cfg.n_layers!r} a layer) against "
          f"{wall / cache * 1e3!r} ms a step in O2")
    moved = whisper_step_bytes(cfg, params, state, cache - 1)
    print(f"  bytes a decode step must move: weights={moved['weights']} "
          f"self_kv={moved['kv']} cross_kv={moved['cross_kv']}; "
          f"bound_ms={moved['bound_ms']!r} at {HBM_BW:.3g} B/s "
          f"({moved['bound_ms'] / step_ms:.1%} of the replayed step)")
    del params, state
    torch.cuda.empty_cache()
    whisper_serving_agreement(dev, seed)
    return launches


def whisper_serving_agreement(dev, seed, batch=2, prompt=8, steps=16):
    """whisper-large-v3 at full width with O_AGREE_LAYERS encoder and
    decoder layers in float32: the prefill, then ``encode``,
    ``precompute_cross_kv`` and ``prompt`` teacher-forced + ``steps``
    greedy decode steps, with the kernels and then with their plain
    versions on the card: logits within 1e-4, the same tokens.  Then the
    reference's own property: the decode logits of every step equal the
    teacher-forced decoder's logits of the same tokens within 2e-2."""
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state, init_params
    from repro_torch.models.layers import logits_fn
    from repro_torch.models.whisper import (decoder, encode,
                                            precompute_cross_kv)

    cfg = _whisper_cfg(n_layers=O_AGREE_LAYERS,
                       n_encoder_layers=O_AGREE_LAYERS, dtype="float32")
    params = init_params(cfg, seed=seed + 1, device=dev)
    frames, toks = _whisper_inputs(cfg, dev, seed + 1, batch, prompt)

    def run():
        logits = [make_prefill_step(cfg, dev)(
            params, {"inputs": frames, "decoder_tokens": toks})]
        step = make_serve_step(cfg, dev)
        state = init_decode_state(cfg, batch, prompt + steps, dev)
        with torch.no_grad():
            state["cross_k"], state["cross_v"] = precompute_cross_kv(
                params, cfg, encode(params, cfg, frames))
        fed, every, cur = [], [], None
        for t in range(prompt + steps):
            tok = toks[:, t] if t < prompt else cur
            out, state = step(params, state, {"inputs": tok})
            fed.append(tok)
            every.append(out)
            cur = out.argmax(-1)
            if t >= prompt - 1:
                logits.append(out)
        torch.cuda.synchronize()
        return (torch.stack(logits), torch.stack(fed, 1),
                torch.stack(every, 1))

    got, got_fed, every = run()
    with _swapped(_attention_plain()):
        want, want_fed, _ = run()
    err = _max_err(got, want)
    _require(torch.equal(got_fed, want_fed),
             f"{cfg.name} agreement: greedy tokens differ between the "
             f"kernels and their plain versions")
    _require(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
             f"{cfg.name} agreement: logits differ by {err} (> 1e-4)")
    with torch.no_grad():
        full = logits_fn(params, cfg, decoder(
            params, cfg, encode(params, cfg, frames), got_fed))
    drift = _max_err(every, full)
    _require(torch.allclose(every, full, rtol=2e-2, atol=2e-2),
             f"{cfg.name} decode vs teacher-forced: logits differ by "
             f"{drift} (> 2e-2)")
    print(f"agreement {cfg.name} d_model={cfg.d_model} {O_AGREE_LAYERS} + "
          f"{O_AGREE_LAYERS} layers float32, prefill {batch} x "
          f"({cfg.encoder_seq_len} frames + {prompt} tokens), then {prompt} "
          f"teacher-forced + {steps} greedy decode steps: kernels vs plain "
          f"versions on the card max_abs_err={err!r} (logits absmax "
          f"{float(want.abs().max())!r}), tokens equal; decode vs the "
          f"teacher-forced decoder at all {prompt + steps} positions "
          f"max_abs_diff={drift!r} (within 2e-2)")


def run_path_o3(dev, seed):
    """O3: whisper-large-v3 training at full width and depth (f32
    parameters, bf16 compute, remat) through ``make_train_step(...,
    donate=True)``: one warm-up step, then O_TRAIN_STEPS AdamW steps of
    O_TRAIN_BATCH x (1500 frames + O_TRAIN_SEQ decoder tokens), exactly
    192 forward (96, and 96 recomputed by remat) and 96 backward flash
    launches a step, finite losses, nonzero gradients at the adapter, one
    encoder wq, one cross wk and the head; then the training agreement
    (:func:`whisper_train_agreement`).  Returns the launch counts."""
    import math

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_bytes
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = _whisper_cfg()
    held = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=seed, device=dev)
    opt_state = adamw_init(params)
    torch.cuda.synchronize()
    print(f"{_whisper_header('O3', cfg, params)}, "
          f"{param_bytes(opt_state)} bytes of AdamW state, remat="
          f"{cfg.remat}")
    step = make_train_step(cfg, AdamWConfig(warmup_steps=2,
                                            total_steps=O_TRAIN_STEPS + 1),
                           dev, donate=True)

    def batch(i):
        frames, toks = _whisper_inputs(cfg, dev, seed + 100 + i,
                                       O_TRAIN_BATCH, O_TRAIN_SEQ + 1)
        return {"inputs": frames, "decoder_tokens": toks[:, :-1],
                "labels": toks[:, 1:]}

    t0 = time.perf_counter()
    params, opt_state, m = step(params, opt_state, batch(0))
    warm = float(m["loss"])
    warm_s = time.perf_counter() - t0
    # the first moment after one step is 0.1 x the clipped gradient
    mu = opt_state["mu"]
    watched = {"embedding.adapter": mu["embedding"]["adapter"],
               "enc_layers.0.attn.wq": mu["enc_layers"][0]["attn"]["wq"],
               "layers.0.cross_attn.wk": mu["layers"][0]["cross_attn"]["wk"],
               "lm_head.w": mu["lm_head"]["w"]}
    dead = [k for k, x in watched.items() if not float(x.abs().max()) > 0]
    _require(math.isfinite(warm) and not dead,
             f"path O3 warm-up: loss {warm}, zero gradients in {dead}")
    del mu, watched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    walls = []
    for i in range(O_TRAIN_STEPS):
        b = batch(i + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        loss = float(m["loss"])            # syncs: the step's wall is whole
        walls.append(time.perf_counter() - t0)
        _require(math.isfinite(loss), f"path O3 step {i + 1}: loss {loss}")
        print(f"path O3 step {i + 1}: loss={loss!r} lr={float(m['lr'])!r} "
              f"grad_norm={float(m['grad_norm'])!r} wall_s={walls[-1]!r}")
    peak = torch.cuda.max_memory_allocated()
    counts = _build.launch_counts()
    launches = {k: counts[k] for k in ("flash_attention_fwd",
                                       "flash_attention_bwd")}
    calls = cfg.n_encoder_layers + 2 * cfg.n_layers  # encoder, self, cross
    want = {"flash_attention_fwd": 2 * calls * O_TRAIN_STEPS,
            "flash_attention_bwd": calls * O_TRAIN_STEPS}
    _require(launches == want, f"path O3: launches {launches}, want {want}")
    others = {k: n for k, n in counts.items() if n and k not in launches}
    _require(not others, f"path O3 launched {others}")
    mean = sum(walls) / len(walls)
    profile_train_step(lambda: step(params, opt_state, batch(9)),
                       "path O3", (("flash_attention_bwd", "flash_bwd"),
                                   ("flash_attention", "flash_attention")))
    print(f"path O3: warm-up step {warm_s!r} s (loss {warm!r}), then "
          f"{O_TRAIN_STEPS} steps of {O_TRAIN_BATCH} x "
          f"({cfg.encoder_seq_len} frames + {O_TRAIN_SEQ} decoder tokens): "
          f"mean {mean!r} s a step, decoder_tokens_per_s="
          f"{O_TRAIN_BATCH * O_TRAIN_SEQ / mean!r} frames_per_s="
          f"{O_TRAIN_BATCH * cfg.encoder_seq_len / mean!r}; "
          f"peak_mem_bytes={peak} (of which {held} held before O3) "
          f"launches={launches} (a step: {2 * calls} forward, {calls} of "
          f"them recomputed by remat, and {calls} backward); nonzero "
          f"gradients at the adapter, enc_layers.0.attn.wq, "
          f"layers.0.cross_attn.wk and lm_head.w")
    del params, opt_state
    torch.cuda.empty_cache()
    whisper_train_agreement(dev, seed)
    return launches


def whisper_train_agreement(dev, seed, batch=2, seq=64):
    """whisper-large-v3 at full width with O_AGREE_LAYERS encoder and
    decoder layers (remat), two steps of ``batch`` x (1500 frames + ``seq``
    decoder tokens) (AdamW lr L2_LR, eps K2_EPS, as L2), in float32 and
    in bfloat16 compute: :func:`train_agreement` from weights of seed
    ``seed + 3``, three flash calls a layer pair, the losses within
    R_LOSS_TOL in float32 and 2e-2 in bfloat16."""
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig

    opt = AdamWConfig(lr=L2_LR, warmup_steps=1, eps=K2_EPS)
    for dtype in ("float32", "bfloat16"):
        cfg = _whisper_cfg(n_layers=O_AGREE_LAYERS,
                           n_encoder_layers=O_AGREE_LAYERS, dtype=dtype)
        batches = []
        for i in range(2):
            frames, toks = _whisper_inputs(cfg, dev, seed + 3 + i, batch,
                                           seq + 1)
            batches.append({"inputs": frames,
                            "decoder_tokens": toks[:, :-1],
                            "labels": toks[:, 1:]})
        train_agreement(dev, cfg, batches, opt, f"path O3 agreement {dtype}",
                        params=init_params(cfg, seed=seed + 3, device=dev),
                        calls=3 * O_AGREE_LAYERS,
                        loss_tol=R_LOSS_TOL if dtype == "float32" else 2e-2)


def whisper_rows(o0, launches) -> list:
    """The attention kernels' rows at whisper's calls (O0's cases), with
    the launches of O1-O3 (``launches`` by part; a part that did not run
    counts none): the forward at O1's encoder call, the backward at O3's
    encoder call, the decode kernel at O2's cross call, each with all its
    whisper calls under ``calls``."""
    def fields(case):
        return {k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "wrapper_ms")}

    def calls(*cases):
        return [dict(fields(o0[k]), at=f"whisper's {k} call (path O)")
                for k in cases]

    def count(part, key):
        return (launches.get(part) or {}).get(key, 0)

    fwd = {"O1": count("O1", "O1"), "O2": count("O2", "O2_encode"),
           "O3": count("O3", "flash_attention_fwd")}
    bwd = {"O3": count("O3", "flash_attention_bwd")}
    dec = {"O2": count("O2", "O2")}
    return [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
             replaces="src/repro/kernels/flash_attention.py:73",
             launches=sum(fwd.values()), launches_by_path=fwd,
             **fields(o0["fwd_encoder"]),
             calls=calls("fwd_encoder", "fwd_cross", "fwd_self")),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
             replaces="src/repro/kernels/ops.py:48",
             launches=sum(bwd.values()), launches_by_path=bwd,
             **fields(o0["bwd_encoder"]),
             calls=calls("bwd_encoder", "bwd_cross", "bwd_self")),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:65",
             launches=sum(dec.values()), launches_by_path=dec,
             **fields(o0["decode_cross"]),
             calls=calls("decode_cross", "decode_self"))]


#: path P: qwen2-vl-72b at full width, its depth cut to P_LAYERS of 80
VLM, P_LAYERS = "qwen2-vl-72b", 16
#: P1's request layout, as Qwen2-VL's ``get_rope_index`` lays out a text
#: prefix, one image of 1 x 24 x 32 merged patches and a text suffix
#: (D_PROMPT = 64 + 768 + 192 positions)
P_PREFIX, P_GRID, P_SUFFIX = 64, (24, 32), 192
#: path Q: deepseek-67b at full width, its depth cut to Q_LAYERS of 95,
#: decoding through a tail of Q_WINDOW rows (the reference's ``tail256``
#: dry-run rules)
TAILED, Q_LAYERS, Q_WINDOW = "deepseek-67b", 16, 256
#: Q2's teacher-forced steps: a whole window, so that its D_GEN greedy
#: steps attend the flushed rows
Q_FORCED = Q_WINDOW
#: the tailed agreement check's window: 64 decode steps cross 4 flushes
Q_AGREE_WINDOW = 16


def mrope_positions(batch: int, prefix: int, grid, suffix: int):
    """(3, B, S) int64 numpy M-RoPE positions (t, h, w) of ``batch``
    requests laid out as Qwen2-VL's ``get_rope_index`` lays out text and
    one image: ``prefix`` text positions with t = h = w = 0..prefix-1;
    the image's ``grid = (rows, cols)`` patches with t = prefix, h =
    prefix + row, w = prefix + col; then ``suffix`` text positions
    resuming after the image's largest stream, at prefix + max(rows,
    cols)."""
    import numpy as np

    rows, cols = grid
    r, c = np.divmod(np.arange(rows * cols), cols)
    text = np.arange(prefix)
    after = prefix + max(rows, cols) + np.arange(suffix)
    streams = [np.concatenate([text, prefix + img, after])
               for img in (np.zeros_like(r), r, c)]
    return np.ascontiguousarray(np.broadcast_to(
        np.stack(streams)[:, None], (3, batch, prefix + rows * cols + suffix)))


def text_positions(start: int, batch: int, dev):
    """(3, B, 1) int64 positions t = h = w = ``start`` on ``dev``: a
    decode step's text position continuing an M-RoPE layout."""
    import torch

    return torch.full((3, batch, 1), start, dtype=torch.long, device=dev)


def _bf16_model(name, layers, dev, seed, **over):
    """``name`` at full width with ``layers`` layers (``None``: all),
    bf16 weights drawn on ``dev`` from ``seed``: ``(cfg, params)``,
    printed with its size."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import init_params, param_bytes

    cfg = configs.get(name)
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                              dtype="bfloat16", param_dtype="bfloat16",
                              **over)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    print(f"  {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
          f"{_heads(cfg)} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"input_mode={cfg.input_mode} mrope_sections="
          f"{cfg.mrope_sections} decode_tail_window={cfg.decode_tail_window}"
          f" bf16: {cfg.n_params()} parameters, {param_bytes(params)} bytes "
          f"on the card, drawn in {time.perf_counter() - t0!r} s")
    return cfg, params


def _timed_prefill(tag, cfg, params, batch, dev,
                   kernel="flash_attention_fwd"):
    """``make_prefill_step`` on ``batch`` (D_BATCH x D_PROMPT), after a
    short warm-up: exactly one ``kernel`` launch a kernel layer; finite
    logits.  Returns the launches and the prefill step."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_prefill_step

    prefill = make_prefill_step(cfg, dev)
    warm = {k: v[..., :1, :16] if k == "positions" else v[:1, :16]
            for k, v in batch.items()}
    prefill(params, warm)                              # cuBLAS warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _launched(kernel, _kernel_layers(cfg), f"path {tag}")
    _require(tuple(logits.shape) == (D_BATCH, cfg.vocab_size)
             and bool(torch.isfinite(logits).all()),
             f"path {tag}: logits {tuple(logits.shape)} not finite of shape "
             f"[{D_BATCH}, {cfg.vocab_size}]")
    print(f"path {tag} (prefill): {D_BATCH} x {D_PROMPT} wall_s={wall!r} "
          f"prefill_tokens_per_s={D_BATCH * D_PROMPT / wall!r} "
          f"launches={{'{kernel}': {n}}} "
          f"logits_absmax={float(logits.float().abs().max())!r}")
    return n, prefill


def _step_report(tag, cfg, params, state, run, fill, wall_ms) -> float:
    """One decode step ``run`` at ``fill`` (already set in ``state``): its
    device ms replayed as a CUDA graph, its torch ops, one eager step under
    ``torch.profiler``, and the bytes it must move against that time.
    Returns the device ms."""
    step_ms = graph_ms(run, 1)
    with _op_counter() as ops:
        run()
    profile_decode_step(run, f"path {tag}")
    moved = step_bytes(cfg, params, state, fill)
    print(f"  {tag} one decode step at fill {fill}: device_ms={step_ms!r} "
          f"(CUDA graph replay) torch_ops={ops.n} "
          f"({ops.n / cfg.n_layers!r} a layer) against {wall_ms!r} ms a "
          f"step in the run; bytes it must move: weights="
          f"{moved['weights']} kv_cache={moved['kv']} recurrent_state="
          f"{moved['state']}; bound_ms="
          f"{moved['bound_ms']!r} at {HBM_BW:.3g} B/s "
          f"({moved['bound_ms'] / step_ms:.1%} of the replayed step)")
    return step_ms


def run_path_p(dev, seed):
    """Path P: qwen2-vl-72b at full width (d_model 8192, 64 heads over 8
    KV heads of 128, d_ff 29568, vocab 152064, M-RoPE sections (16, 24,
    24)), depth cut to P_LAYERS, bf16.  P1 prefills D_BATCH requests of
    standard-normal patch and text embeddings laid out by
    :func:`mrope_positions` (exactly one flash launch a layer); P2 runs
    D_FORCED teacher-forced decode steps of (B, 1, d) embeddings at text
    positions continuing each request's (one decode launch a layer a
    step; no greedy phase: an embeddings model has no token table), then
    one step replayed as a CUDA graph at the cache's last fill.  Then the
    float32 agreement at 4 layers.  Returns the launches by part."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_decode_state, param_bytes

    print("path P: qwen2-vl-72b, the embeddings front end and M-RoPE")
    cfg, params = _bf16_model(VLM, P_LAYERS, dev, seed)
    gen = torch.Generator(dev).manual_seed(seed)
    pos = torch.as_tensor(mrope_positions(D_BATCH, P_PREFIX, P_GRID,
                                          P_SUFFIX), device=dev)
    x = torch.randn((D_BATCH, D_PROMPT, cfg.d_model), generator=gen,
                    device=dev)
    launches = {"P1": _timed_prefill("P1", cfg, params,
                                     {"inputs": x, "positions": pos}, dev)[0]}
    del x

    cache = D_PROMPT + D_GEN
    start = int(pos[0, 0, -1]) + 1             # the text stream's next
    feed = torch.randn((D_BATCH, D_FORCED, cfg.d_model), generator=gen,
                       device=dev)
    where = [text_positions(start + t, D_BATCH, dev) for t in range(D_FORCED)]
    step = make_serve_step(cfg, dev)
    state = init_decode_state(cfg, D_BATCH, cache, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    for t in range(D_FORCED):
        out, state = step(params, state, {"inputs": feed[:, t:t + 1],
                                          "positions": where[t]})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["P2"] = _launched("decode_attention_fwd", P_LAYERS * D_FORCED,
                               "path P2")
    _require(tuple(out.shape) == (D_BATCH, cfg.vocab_size)
             and bool(torch.isfinite(out).all()),
             f"path P2: logits {tuple(out.shape)} not finite")
    print(f"path P2 (teacher-forced decode): {D_BATCH} requests x "
          f"{D_FORCED} steps of (B, 1, d) embeddings at text positions "
          f"{start}.. in a {cache}-position cache, decode state "
          f"{param_bytes(state)} bytes: wall_s={wall!r} ms_per_decode_step="
          f"{wall / D_FORCED * 1e3!r} decode_tokens_per_s="
          f"{D_BATCH * D_FORCED / wall!r} peak_mem_bytes="
          f"{torch.cuda.max_memory_allocated()} launches="
          f"{{'decode_attention_fwd': {launches['P2']}}}")
    state["cache_len"].fill_(cache - 1)
    one = {"inputs": feed[:, :1], "positions": where[-1]}
    _step_report("P2", cfg, params, state, lambda: step(params, state, one),
                 cache - 1, wall / D_FORCED * 1e3)
    del params, state, feed, where
    torch.cuda.empty_cache()
    vlm_agreement(dev, seed)
    torch.cuda.empty_cache()
    return launches


def vlm_agreement(dev, seed, layers=4, batch=2, steps=16):
    """qwen2-vl-72b at full width with ``layers`` layers in float32: a
    prefill of 48 embeddings laid out by :func:`mrope_positions` (8 text,
    a 4 x 6 image, 16 text), the same 48 teacher-forced through the
    decode path with their 3-stream positions, then ``steps`` more at
    text positions, with the kernels and with their plain versions on the
    card: logits within 1e-4, the same argmax (the smallest top-2 margin
    printed); and the decode path's logits at every prompt position equal
    to the full-sequence logits within 2e-2 (M-RoPE in decode as in
    prefill)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state, init_params
    from repro_torch.models.layers import embed_inputs, logits_fn
    from repro_torch.models.transformer import backbone

    cfg = dataclasses.replace(configs.get(VLM), n_layers=layers,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, seed=seed + 1, device=dev)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    pos = torch.as_tensor(mrope_positions(batch, 8, (4, 6), 16), device=dev)
    prompt = pos.shape[-1]
    start = int(pos[0, 0, -1]) + 1
    x = torch.randn((batch, prompt, cfg.d_model), generator=gen, device=dev)
    feed = torch.randn((batch, steps, cfg.d_model), generator=gen,
                       device=dev)

    def run():
        logits = [make_prefill_step(cfg, dev)(
            params, {"inputs": x, "positions": pos})]
        step = make_serve_step(cfg, dev)
        state = init_decode_state(cfg, batch, prompt + steps, dev)
        forced = []
        for t in range(prompt):
            out, state = step(params, state, {
                "inputs": x[:, t:t + 1], "positions": pos[:, :, t:t + 1]})
            forced.append(out)
        for t in range(steps):
            out, state = step(params, state, {
                "inputs": feed[:, t:t + 1],
                "positions": text_positions(start + t, batch, dev)})
            logits.append(out)
        torch.cuda.synchronize()
        return torch.stack(logits), torch.stack(forced, 1)

    got, forced = run()
    with _swapped(_attention_plain()):
        want, _ = run()
    err = _max_err(got, want)
    top = want.topk(2, dim=-1).values
    margin = float((top[..., 0] - top[..., 1]).min())
    _require(torch.equal(got.argmax(-1), want.argmax(-1)),
             f"{cfg.name} agreement: argmax differs between the kernels and "
             f"their plain versions (smallest top-2 margin {margin!r})")
    _require(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
             f"{cfg.name} agreement: logits differ by {err} (> 1e-4)")
    print(f"agreement {cfg.name} d_model={cfg.d_model} {layers} layers "
          f"float32, prefill {batch} x {prompt} embeddings (3-stream "
          f"positions: 8 text, a 4 x 6 image, 16 text) then {prompt} "
          f"teacher-forced + {steps} decode steps: kernels vs plain versions "
          f"on the card max_abs_err={err!r} (logits absmax "
          f"{float(want.abs().max())!r}), argmax equal; smallest top-2 "
          f"margin {margin!r}")
    with torch.no_grad():
        full = logits_fn(params, cfg, backbone(
            params, cfg, embed_inputs(params["embedding"], cfg, x), pos))
    drift = _max_err(forced, full)
    _require(torch.allclose(forced, full, rtol=2e-2, atol=2e-2),
             f"{cfg.name} decode vs prefill: logits differ by {drift} "
             f"(> 2e-2)")
    print(f"  decode (3-stream positions a step) vs prefill at all {prompt} "
          f"positions: max_abs_diff={drift!r} (within 2e-2)")


def _tailed_generate(tag, cfg, params, toks, kernel, dev):
    """Q_FORCED teacher-forced tokens of ``toks`` and D_GEN greedy ones
    through ``make_serve_step`` in a D_PROMPT + D_GEN cache, flushing the
    tail whenever ``cache_len`` reaches a multiple of the window (known on
    the host: no sync): exactly one ``kernel`` launch a layer a step.
    Returns the teacher-forced logits, the greedy tokens, ms a step, the
    launches, the state and the step."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import flush_kv_tail, init_decode_state

    w = cfg.decode_tail_window
    step = make_serve_step(cfg, dev)
    state = init_decode_state(cfg, D_BATCH, D_PROMPT + D_GEN, dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    forced, chosen, flushes = [], [], 0
    cur = None
    for t in range(Q_FORCED + D_GEN):
        if t >= Q_FORCED:
            chosen.append(cur)
        out, state = step(params, state, {
            "inputs": toks[:, t] if t < Q_FORCED else cur})
        if w and (t + 1) % w == 0:
            state = flush_kv_tail(cfg, state)
            flushes += 1
        if t < Q_FORCED:
            forced.append(out)
        cur = out.argmax(-1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (Q_FORCED + D_GEN) * 1e3
    n = _launched(kernel, cfg.n_layers * (Q_FORCED + D_GEN), f"path {tag}")
    print(f"path {tag}: {D_BATCH} requests x ({Q_FORCED} teacher-forced + "
          f"{D_GEN} greedy) steps, window {w}, {flushes} flushes: "
          f"ms_per_decode_step={ms!r} launches={{'{kernel}': {n}}}")
    return torch.stack(forced, 1), torch.stack(chosen, 1), ms, n, state, step


def run_path_q(dev, seed):
    """Path Q: deepseek-67b at full width (d_model 8192, 64 heads over 8
    KV heads, d_ff 22016, vocab 102400), depth cut to Q_LAYERS, bf16,
    with ``decode_tail_window = Q_WINDOW``.  Q1 prefills D_BATCH x
    D_PROMPT tokens (one flash launch a layer); Q2 decodes Q_FORCED
    teacher-forced and D_GEN greedy tokens through the tailed state,
    flushing at ``cache_len = Q_WINDOW`` (one tailed decode launch a layer
    a step), then the same steps untailed as the control (one decode
    launch a layer a step): teacher-forced logits within 5e-2; each run's
    step replayed as a CUDA graph at the cache's last fill, and the
    flush's device ms.  Then the float32 agreement of the tailed decode
    at 4 layers and window Q_AGREE_WINDOW.  Returns the launches by
    part."""
    import dataclasses

    import torch

    from repro_torch.models import flush_kv_tail, param_bytes

    print(f"path Q: {TAILED}, the tailed decode")
    cfg, params = _bf16_model(TAILED, Q_LAYERS, dev, seed,
                              decode_tail_window=Q_WINDOW)
    gen = torch.Generator(dev).manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (D_BATCH, D_PROMPT),
                            generator=gen, device=dev)
    launches = {"Q1": _timed_prefill("Q1", cfg, params, {"inputs": prompts},
                                     dev)[0]}
    toks = prompts[:, :Q_FORCED]
    plain = dataclasses.replace(cfg, decode_tail_window=0)
    forced, chosen, ms, launches["Q2"], state, step = _tailed_generate(
        "Q2", cfg, params, toks, "decode_attention_tailed_fwd", dev)
    forced_c, chosen_c, ms_c, launches["Q2_control"], state_c, step_c = \
        _tailed_generate("Q2 control (untailed)", plain, params, toks,
                         "decode_attention_fwd", dev)
    diff = _max_err(forced, forced_c)
    _require(torch.allclose(forced.float(), forced_c.float(), rtol=5e-2,
                            atol=5e-2),
             f"path Q2: tailed and untailed teacher-forced logits differ by "
             f"{diff} (> 5e-2)")
    _require(bool(torch.isfinite(forced).all()),
             "path Q2: logits not finite")
    same = int((chosen == chosen_c).all(1).sum())
    print(f"  Q2 tailed vs untailed: teacher-forced logits max_abs_diff="
          f"{diff!r} (bit-equal: {torch.equal(forced, forced_c)}; within "
          f"5e-2 required); greedy tokens equal in {same} of {D_BATCH} "
          f"requests (printed)")
    fill = D_PROMPT + D_GEN - 1
    tok = prompts[:, 0]
    for tag, st, stp, c, wall_ms in (("Q2", state, step, cfg, ms),
                                     ("Q2 control", state_c, step_c, plain,
                                      ms_c)):
        st["cache_len"].fill_(fill)
        _step_report(tag, c, params, st,
                     lambda st=st, stp=stp: stp(params, st, {"inputs": tok}),
                     fill, wall_ms)
    flush_ms = graph_ms(lambda: flush_kv_tail(cfg, state), 1)
    moved = 3 * param_bytes(state["tail"])
    print(f"  Q2 one flush_kv_tail ({Q_LAYERS} layers' tails of "
          f"{Q_WINDOW} rows into the main cache, then zeroed): device_ms="
          f"{flush_ms!r} (CUDA graph replay), {moved} bytes read and "
          f"written: bound_ms={moved / HBM_BW * 1e3!r}; a "
          f"flush every {Q_WINDOW} steps adds {flush_ms / Q_WINDOW!r} ms a "
          f"step")
    del params, state, state_c
    torch.cuda.empty_cache()
    tailed_agreement(dev, seed)
    torch.cuda.empty_cache()
    return launches


def tailed_agreement(dev, seed, layers=4, batch=2, prompt=48, steps=16,
                     window=Q_AGREE_WINDOW):
    """deepseek-67b at full width with ``layers`` layers in float32 and
    ``decode_tail_window = window``: a prefill with the kernels and with
    their plain versions (logits within 1e-4), then ``prompt``
    teacher-forced + ``steps`` greedy decode steps flushing every
    ``window`` (4 flushes at 16, 32, 48 and 64): tailed with the kernels,
    tailed with the plain versions and untailed with the kernels, logits
    within 1e-4 of each other and the same tokens (the smallest top-2
    margin printed); and the tailed decode's logits at every prompt
    position equal to the full-sequence logits within 2e-2."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import (flush_kv_tail, init_decode_state,
                                    init_params)
    from repro_torch.models.layers import embed_inputs, logits_fn
    from repro_torch.models.transformer import backbone

    cfg = dataclasses.replace(configs.get(TAILED), n_layers=layers,
                              dtype="float32", param_dtype="float32",
                              decode_tail_window=window)
    params = init_params(cfg, seed=seed + 1, device=dev)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    toks = torch.randint(1, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    prefill = make_prefill_step(cfg, dev)
    got_p = prefill(params, {"inputs": toks})
    with _swapped(_attention_plain()):
        want_p = prefill(params, {"inputs": toks})
    err_p = _max_err(got_p, want_p)
    _require(torch.allclose(got_p, want_p, rtol=1e-4, atol=1e-4),
             f"{cfg.name} agreement: prefill logits differ by {err_p}")

    def run(c):
        step = make_serve_step(c, dev)
        state = init_decode_state(c, batch, prompt + steps, dev)
        logits, chosen, flushes = [], [], 0
        cur = None
        for t in range(prompt + steps):
            if t >= prompt:
                chosen.append(cur)
            out, state = step(params, state, {
                "inputs": toks[:, t] if t < prompt else cur})
            if c.decode_tail_window and (t + 1) % window == 0:
                state = flush_kv_tail(c, state)
                flushes += 1
            logits.append(out)
            cur = out.argmax(-1)
        torch.cuda.synchronize()
        return torch.stack(logits, 1), torch.stack(chosen, 1), flushes

    got, got_tok, flushes = run(cfg)
    with _swapped(_attention_plain()):
        want, want_tok, _ = run(cfg)
    ctrl, ctrl_tok, _ = run(dataclasses.replace(cfg, decode_tail_window=0))
    top = want.topk(2, dim=-1).values
    margin = float((top[..., 0] - top[..., 1]).min())
    errs = {"kernels vs plain": _max_err(got, want),
            "tailed vs untailed": _max_err(got, ctrl)}
    for what, other, other_tok in (("kernels vs plain", want, want_tok),
                                   ("tailed vs untailed", ctrl, ctrl_tok)):
        _require(torch.equal(got_tok, other_tok),
                 f"{cfg.name} tailed agreement ({what}): greedy tokens "
                 f"differ (smallest top-2 margin {margin!r})")
        _require(torch.allclose(got, other, rtol=1e-4, atol=1e-4),
                 f"{cfg.name} tailed agreement ({what}): logits differ by "
                 f"{errs[what]} (> 1e-4)")
    print(f"agreement {cfg.name} d_model={cfg.d_model} {layers} layers "
          f"float32 window {window}: prefill {batch} x {prompt} kernels vs "
          f"plain max_abs_err={err_p!r}; {prompt} teacher-forced + {steps} "
          f"greedy tailed steps, {flushes} flushes: max_abs_err "
          + ", ".join(f"{k} {v!r}" for k, v in errs.items())
          + f" (logits absmax {float(want.abs().max())!r}), tokens equal; "
          f"smallest top-2 margin {margin!r}")
    positions = torch.arange(prompt, device=dev).expand(batch, prompt)
    with torch.no_grad():
        full = logits_fn(params, cfg, backbone(
            params, cfg, embed_inputs(params["embedding"], cfg, toks),
            positions))
    drift = _max_err(got[:, :prompt], full)
    _require(torch.allclose(got[:, :prompt], full, rtol=2e-2, atol=2e-2),
             f"{cfg.name} tailed decode vs prefill: logits differ by "
             f"{drift} (> 2e-2)")
    print(f"  tailed decode vs prefill at all {prompt} positions: "
          f"max_abs_diff={drift!r} (within 2e-2)")


#: path R: training the MoE and hybrid Mamba families.  R1: qwen2-moe-
#: a2.7b at full width cut to R1_LAYERS of its 24 layers (f32 parameters
#: and AdamW at ~16 B a parameter: 4 layers and the 151936 x 2048 embedding
#: and head are ~2.90e9 parameters, ~46.5 GB; 24 layers, 14.3e9, do not
#: fit one card); R2: the agreement at R2_LAYERS in float32; R3: SMOKE
#: jamba (its one period of 8 full-width layers is 13.3e9 parameters,
#: ~213 GB) and llama4-scout (one full-width layer with its embedding and
#: head, ~4e9, is ~68 GB before its logits)
R1_LAYERS, R1_BATCH, R1_SEQ, R1_STEPS = 4, 4, 2048, 4
R2_LAYERS, R2_BATCH, R2_SEQ = 2, 2, 512
R3_ARCHS, R3_BATCH, R3_SEQ, R3_STEPS = (
    ("jamba-v0.1-52b", "llama4-scout-17b-a16e"), 2, 64, 3)
#: the agreements' loss check: float32 throughout (the kernels and their
#: plain versions sum in other orders)
R_LOSS_TOL = 1e-5
#: the float32 training agreements' update check (:func:`update_verdict`'s
#: relative norm by leaf; L2_UPDATE_REL_TOL is bf16's).  Sound runs read
#: 8.2e-6 to 3.9e-5 on an H100 80GB HBM3 at 700 W (R2, R3 and O3's float32
#: agreement; PERF.md §6): the kernels' summation order and the float
#: atomics of the dispatch gather's backward.  The control of
#: :func:`agreement_controls`, a backward in bfloat16, must read above it
F32_UPDATE_REL_TOL = 1e-4


def _moe_train_cfg(**over):
    """qwen2-moe-a2.7b as published for training: f32 parameters, bf16
    compute, ``remat``."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get(MOE)
    _require(cfg.param_dtype == "float32" and cfg.dtype == "bfloat16"
             and cfg.remat, f"{MOE}: not the published training config")
    return dataclasses.replace(cfg, **over)


@contextlib.contextmanager
def _routed_experts(seen: list):
    """Within the block, every MoE routing call appends its expert choices
    (B, S, k) to ``seen`` (no sync)."""
    from repro_torch.models import moe

    route = moe.route

    def recorded(p, cfg, x):
        probs, gate, eidx = route(p, cfg, x)
        seen.append(eidx.detach())
        return probs, gate, eidx

    with _swapped([(moe, "route", recorded)]):
        yield


def dead_moe_leaves(mu, routed) -> list:
    """The leaves of a routed model's first moment after one step (0.1 x
    the clipped gradient) that are zero where they must not be: every
    layer's router, ``wq``/``wk``/``wv`` and shared expert, and the
    ``wi``/``wg``/``wo`` of every expert that ``routed`` (the layer's
    (B, S, k) choices, one a layer) says took a token."""
    dead = []
    for i, (lp, eidx) in enumerate(zip(mu["layers"], routed)):
        ffn = lp["ffn"]
        watched = {"ffn.router": ffn["router"],
                   **{f"attn.{w}": lp["attn"][w] for w in ("wq", "wk", "wv")},
                   **{f"ffn.shared.{w}": x
                      for w, x in ffn.get("shared", {}).items()}}
        dead += [f"layers.{i}.{k}" for k, x in watched.items()
                 if not float(x.abs().max()) > 0]
        took = experts_taken(eidx)
        for w in ("wi", "wg", "wo"):
            live = ffn[w].flatten(1).abs().amax(1) > 0
            dead += [f"layers.{i}.ffn.{w}[{e}]" for e in took
                     if not bool(live[e])]
    return dead


def experts_taken(eidx) -> list:
    """The experts a layer's choices name, sorted."""
    return sorted(int(e) for e in eidx.unique().tolist())


def _ranged(module, name: str):
    """A ``_swapped`` entry that runs ``module.name`` inside a
    ``record_function`` range of that name."""
    from torch.profiler import record_function

    fn = getattr(module, name)

    def ranged(*a, **k):
        with record_function(name):
            return fn(*a, **k)

    return module, name, ranged


def moe_step_parts(vocab: int):
    """:func:`profile_train_step`'s split of a MoE train step into its
    parts' device ms: the flash kernels (forward and backward, by kernel
    name), then each operator once, by the first of: AdamW (an operator
    under the ``adamw_update`` range that :func:`_ranged` puts around the
    update, its CPU parent; the card's profiler records no Python stacks;
    none found fails the path), the expert einsums
    (``aten::bmm``), the other matmuls (``aten::mm``, ``aten::addmm``),
    the f32 loss (an operator on a (.., vocab) tensor), the dispatch's
    gathers (``aten::gather``) and the scatter-adds that are their
    backward."""
    def parts(prof, by_name):
        out = {"flash_attention forward kernel": sum(
                   v for k, v in by_name.items()
                   if "flash_attention" in k and "bwd" not in k),
               "flash_attention backward kernels": sum(
                   v for k, v in by_name.items() if "flash_bwd" in k),
               "AdamW": 0.0,
               "expert einsums (aten::bmm)": 0.0,
               "other matmuls (aten::mm, aten::addmm)": 0.0,
               "f32 loss (ops on (.., vocab) tensors)": 0.0,
               "dispatch gathers (aten::gather)": 0.0,
               "their backward (aten::scatter_add)": 0.0}
        events = prof.events()
        adamw = {id(e) for e in events if e.name == "adamw_update"
                 and not str(getattr(e, "device_type", "")).endswith("CUDA")}
        todo = [e for e in events if id(e) in adamw]
        while todo:
            for c in todo.pop().cpu_children:
                if id(c) not in adamw:
                    adamw.add(id(c))
                    todo.append(c)
        _require(adamw, "moe_step_parts: no operator under adamw_update in "
                        "the profile")
        for e in events:
            ms = (e.self_device_time_total
                  if hasattr(e, "self_device_time_total")
                  else e.self_cuda_time_total) / 1e3
            if not ms or str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            shapes = [x for x in (e.input_shapes or []) if x]
            if id(e) in adamw:
                out["AdamW"] += ms
            elif e.name == "aten::bmm":
                out["expert einsums (aten::bmm)"] += ms
            elif e.name in ("aten::mm", "aten::addmm"):
                out["other matmuls (aten::mm, aten::addmm)"] += ms
            elif any(x[-1] == vocab for x in shapes):
                out["f32 loss (ops on (.., vocab) tensors)"] += ms
            elif e.name == "aten::gather":
                out["dispatch gathers (aten::gather)"] += ms
            elif e.name in ("aten::scatter_add_", "aten::scatter_add"):
                out["their backward (aten::scatter_add)"] += ms
        return out

    return parts


def run_path_r1(dev, seed):
    """R1: qwen2-moe-a2.7b at full width cut to R1_LAYERS layers (60
    experts top-4 and 4 shared a layer, 16 heads of 128), f32 parameters,
    bf16 compute, remat, R1_STEPS AdamW steps of R1_BATCH x R1_SEQ tokens
    from ``TokenPipeline`` through ``make_train_step(..., donate=True)``.
    Exactly 2 x R1_LAYERS forward (remat recomputes each layer) and
    R1_LAYERS backward flash launches a step, finite loss, ce and aux
    with aux > 0, and a nonzero gradient (the first moment after step 1)
    in every layer's router, wq/wk/wv and shared expert, and in the
    wi/wg/wo of every expert that took a token.  Then one step under the
    profiler (:func:`profile_train_step`, split by :func:`moe_step_parts`) and the flash forward with
    its lse at R1's call, timed.  Returns the launch counts and that
    call's figures."""
    import gc
    import math

    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.models import init_params, param_bytes
    from repro_torch.optim import AdamWConfig, adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = _moe_train_cfg(n_layers=R1_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    opt_state = adamw_init(params)
    torch.cuda.synchronize()
    print(f"path R1: {cfg.name} at full width, {cfg.n_layers} of its 24 "
          f"layers d_model={cfg.d_model} {_heads(cfg)} "
          f"vocab={cfg.vocab_size}, f32 "
          f"parameters, bf16 compute, remat={cfg.remat}: {cfg.n_params()} "
          f"parameters, {param_bytes(params)} bytes and "
          f"{param_bytes(opt_state)} bytes of AdamW state on the card, drawn "
          f"in {time.perf_counter() - t0!r} s")
    step = steps.make_train_step(cfg, AdamWConfig(warmup_steps=2,
                                                  total_steps=R1_STEPS),
                                 dev, donate=True)
    pipe = TokenPipeline(R1_BATCH, R1_SEQ, cfg.vocab_size, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    walls = []
    for i in range(R1_STEPS):
        seen = []
        t0 = time.perf_counter()
        with _routed_experts(seen) if i == 0 else contextlib.nullcontext():
            params, opt_state, m = step(params, opt_state, pipe.next_batch())
            loss = float(m["loss"])        # syncs: the step's wall is whole
        walls.append(time.perf_counter() - t0)
        ce, aux = float(m["ce"]), float(m["aux"])
        _require(all(map(math.isfinite, (loss, ce, aux))) and aux > 0,
                 f"path R1 step {i + 1}: loss {loss}, ce {ce}, aux {aux}")
        if i == 0:
            # the forward routes each layer once, then remat's recompute
            _require(len(seen) == 2 * cfg.n_layers,
                     f"path R1: {len(seen)} routing calls in a step")
            dead = dead_moe_leaves(opt_state["mu"], seen[:cfg.n_layers])
            _require(not dead, f"path R1: zero gradients in {dead}")
            took = [len(experts_taken(e)) for e in seen[:cfg.n_layers]]
        print(f"path R1 step {i + 1}: loss={loss!r} ce={ce!r} aux={aux!r} "
              f"lr={float(m['lr'])!r} grad_norm={float(m['grad_norm'])!r} "
              f"wall_s={walls[-1]!r}")
    peak = torch.cuda.max_memory_allocated()
    counts = _build.launch_counts()
    launches = {k: counts[k] for k in ("flash_attention_fwd",
                                       "flash_attention_bwd")}
    want = {"flash_attention_fwd": 2 * cfg.n_layers * R1_STEPS,
            "flash_attention_bwd": cfg.n_layers * R1_STEPS}
    _require(launches == want, f"path R1: launches {launches}, want {want}")
    others = {k: n for k, n in counts.items() if n and k not in launches}
    _require(not others, f"path R1 launched {others}")
    tokens = R1_BATCH * R1_SEQ
    steady = walls[1:]
    print(f"path R1: {R1_STEPS} steps of {R1_BATCH} x {R1_SEQ} tokens: "
          f"wall_s={sum(walls)!r} first step {walls[0]!r} s, steps 2-"
          f"{R1_STEPS} mean {sum(steady) / len(steady)!r} s "
          f"({tokens * len(steady) / sum(steady)!r} tokens/s); "
          f"peak_mem_bytes={peak} (of which {held} held by earlier paths "
          f"before R1) launches={launches} (a step: {2 * cfg.n_layers} "
          f"forward, {cfg.n_layers} of them recomputed by remat, and "
          f"{cfg.n_layers} backward); experts that took a token in step 1, "
          f"by layer: {took} of {cfg.n_experts}; every layer's router, wq, "
          f"wk, wv, shared expert and every such expert's wi, wg, wo "
          f"gradient nonzero")
    with _swapped([_ranged(steps, "adamw_update")]):
        profile_train_step(
            lambda: step(params, opt_state, pipe.next_batch()), "path R1",
            (("flash_attention_bwd", "flash_bwd"),
             ("flash_attention", "flash_attention")),
            parts=moe_step_parts(cfg.vocab_size))
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches, call=r1_attention_call(dev, seed, cfg))


def r1_attention_call(dev, seed, cfg) -> dict:
    """The flash forward with its lse stored (training's call) at R1's
    shape, [R1_BATCH, heads, R1_SEQ, head_dim] causal bf16 (K1's shape),
    against its plain version and SDPA: ``ms`` (graph replays),
    ``wrapper_ms`` (eager), ``plain_ms``, ``library_ms``, its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(dev).manual_seed(seed + 7)
    b, h, kv, s, hd = (R1_BATCH, cfg.n_heads, cfg.n_kv_heads, R1_SEQ,
                       cfg.head_dim)
    q = _normal(gen, (b, h, s, hd), "bfloat16", dev)
    k = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    v = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    kern = lambda: fa.flash_attention_fwd(  # noqa: E731
        q, k, v, causal=True, return_lse=True)
    plain = lambda: fa.flash_attention_plain(  # noqa: E731
        q, k, v, causal=True, return_lse=True)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    (o, lse), (o_p, lse_p) = kern(), plain()
    err = _attn_close(o, o_p, "bfloat16", "flash_attention with lse at "
                                          "path R1's call")
    lse_err = _max_err(lse, lse_p)
    _require(lse_err <= 1e-5 * max(1.0, float(lse_p.abs().max())),
             f"flash_attention at path R1's call: lse differs by {lse_err}")
    # bytes: q, k, v in, o out (bf16), lse out (f32); operations: the
    # causal half of QK^T and PV
    bnd, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel())
                       + 4 * b * h * s, 4 * b * h * s * s * hd / 2,
                       PEAK_FLOPS_BF16)
    out = dict(shape=[b, h, kv, s, hd], ms=graph_ms(kern, 10),
               wrapper_ms=cuda_ms(kern, 10)[0], plain_ms=graph_ms(plain, 3),
               library_ms=graph_ms(lib, 10), bound_ms=bnd, bound_by=by,
               max_abs_err=err, lse_max_abs_err=lse_err)
    print(f"path R1's attention call, the flash forward with lse "
          f"[{b}, {h} over {kv}, {s}, {hd}] causal bf16: ms={out['ms']!r} "
          f"wrapper_ms={out['wrapper_ms']!r} plain_ms={out['plain_ms']!r} "
          f"library_ms={out['library_ms']!r} (SDPA, no lse) "
          f"bound_ms={bnd!r} ({by}, {bnd / out['ms']:.1%} of it) "
          f"max_abs_err={err!r} lse_max_abs_err={lse_err!r}")
    return out


def agreement_controls() -> tuple:
    """The fault the float32 training agreement must reject, as ``(name,
    swaps)`` pairs: the flash backward computed in bfloat16 where
    ``models.attention`` reads it (its inputs and gradients rounded to
    bf16; on the card the bf16 kernel at head dims 64 and 128, the
    CUDA-core one at 16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    def bf16(q, k, v, o, do, lse, *, causal=True):
        return tuple(g.float() for g in fa.flash_attention_bwd(
            *(x.bfloat16() for x in (q, k, v, o, do)), lse, causal=causal))

    return (("the backward in bfloat16",
             [(attention, "flash_attention_bwd", bf16)]),)


def train_agreement(dev, cfg, batches, opt, tag: str, *, params=None,
                    calls=None, loss_tol: float = R_LOSS_TOL,
                    controls=()) -> dict:
    """``make_train_step`` steps of ``cfg`` over ``batches`` from the same
    weights (``params``, or drawn from ``cfg``'s seed 5), on the card:
    with the flash kernels' plain versions swapped in where
    ``models.attention`` reads them (forward and backward), then with the
    kernels, then under each of ``controls`` (``(name, swaps)`` pairs,
    :func:`agreement_controls`).  Held: every loss within ``loss_tol``;
    every leaf's update over the steps by its relative norm
    (:func:`update_verdict`), within F32_UPDATE_REL_TOL in float32 (and
    every update within K2_TOL of its leaf's largest) and within
    L2_UPDATE_REL_TOL in bfloat16; every control's updates outside that
    limit; the kernels launched 2 (remat) or 1 forward and 1 backward a
    step and attention call (``calls`` a forward; by default one an
    attention layer), the plain steps none.  Prints and returns the
    losses, the verdict, the controls' readings and the smallest top-k
    routing margin (None without routing; a margin near a float32 ulp
    tells a routing flip from a fault)."""
    import torch

    from repro_torch import _tree
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import attention, init_params
    from repro_torch.models.transformer import attention_layers
    from repro_torch.optim import adamw_init

    f32 = cfg.dtype == "float32"
    tol = F32_UPDATE_REL_TOL if f32 else L2_UPDATE_REL_TOL
    plain = [(attention, "flash_attention_fwd", fa.flash_attention_plain),
             (attention, "flash_attention_bwd", fa.flash_attention_bwd_plain)]
    if params is None:
        params = init_params(cfg, seed=5, device=dev)
    calls = len(attention_layers(cfg)) if calls is None else calls
    step = make_train_step(cfg, opt, dev)
    margins = []

    def run(swap):
        with _swapped(swap), _topk_margins(margins):
            _build.reset_launches()
            p, st, losses = params, adamw_init(params), []
            for b in batches:
                p, st, m = step(p, st, b)
                losses.append(float(m["loss"]))
            counts = {k: _build.launch_counts()[k] for k in (
                "flash_attention_fwd", "flash_attention_bwd")}
        return p, losses, counts

    def verdict(got_p):
        return update_verdict(
            ((name, new.float() - old.float(), ref.float() - old.float())
             for (name, old), new, ref in zip(_tree.items(params),
                                              _tree.leaves(got_p),
                                              _tree.leaves(want_p))), tol)

    want_p, want_l, counts = run(plain)
    _require(not any(counts.values()),
             f"{tag}: the plain steps launched {counts}")
    got_p, got_l, launches = run([])
    want = {"flash_attention_fwd": (1 + cfg.remat) * calls * len(batches),
            "flash_attention_bwd": calls * len(batches)}
    _require(launches == want, f"{tag}: launches {launches}, want {want}")
    uv = verdict(got_p)
    del got_p
    readings = {}
    for name, swap in controls:
        p, _, _ = run(swap)
        readings[name] = verdict(p)
        del p
    del want_p
    margin = (float(torch.stack([m.detach() for m in margins]).min())
              if margins else None)
    dloss = max(abs(a - b) for a, b in zip(got_l, want_l))
    routed = ("" if margin is None else f"; smallest "
              f"top-{cfg.experts_per_token} routing margin {margin!r}")
    print(f"{tag}: {cfg.name} d_model={cfg.d_model} {cfg.n_layers} layers "
          f"{cfg.dtype}, {len(batches)} step(s) of inputs "
          f"{' + '.join(str(tuple(b['inputs'].shape)) for b in batches)} "
          f"(AdamW lr {opt.lr}, eps {opt.eps}), flash kernels against "
          f"their plain versions on the card: losses {got_l!r} vs {want_l!r} "
          f"(|diff| {dloss!r}, held to {loss_tol}); updates within "
          f"{uv['max_rel']!r} of the largest (worst {uv['max_rel_at']}"
          f"{f', held to {K2_TOL}' if f32 else ''}), relative norm by leaf "
          f"{uv['rel_norm']!r} (worst {uv['rel_norm_at']}, held to "
          f"{tol}){routed}; kernel launches {launches} ({1 + cfg.remat} "
          f"forward and 1 backward a step and attention call), none in the "
          f"plain steps")
    for name, cv in readings.items():
        print(f"{tag} control, {name}: relative norm by leaf "
              f"{cv['rel_norm']!r} (worst {cv['rel_norm_at']}; must exceed "
              f"{tol}), updates within {cv['max_rel']!r} of the largest")
    _require(dloss <= loss_tol, f"{tag}: losses {got_l} and {want_l} differ "
                                f"by {dloss}{routed}")
    _require(uv["rel_ok"], f"{tag}: {uv['rel_norm_at']}'s update differs by "
                           f"a relative norm of {uv['rel_norm']:.3g} (> "
                           f"{tol}){routed}")
    _require(not f32 or uv["max_rel"] <= K2_TOL,
             f"{tag}: {uv['max_rel_at']}'s update differs by "
             f"{uv['max_rel']:.3g} of its largest (> {K2_TOL}){routed}")
    for name, cv in readings.items():
        _require(not cv["rel_ok"], f"{tag}: the control {name!r} passed "
                                   f"(relative norm {cv['rel_norm']:.3g} <= "
                                   f"{tol})")
    return dict(launches, losses=(got_l, want_l), verdict=uv, margin=margin,
                controls={k: v["rel_norm"] for k, v in readings.items()})


def run_path_r2(dev, seed):
    """R2: qwen2-moe-a2.7b at full width, R2_LAYERS layers in float32,
    one step of R2_BATCH x R2_SEQ tokens (AdamW lr L2_LR, eps K2_EPS, as
    L2): :func:`train_agreement`, with :func:`agreement_controls`."""
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.optim import AdamWConfig

    cfg = _moe_train_cfg(n_layers=R2_LAYERS, dtype="float32")
    batch = TokenPipeline(R2_BATCH, R2_SEQ, cfg.vocab_size,
                          seed=seed + 4).next_batch()
    torch.cuda.reset_peak_memory_stats()
    out = train_agreement(dev, cfg, [batch],
                          AdamWConfig(lr=L2_LR, warmup_steps=1, eps=K2_EPS),
                          "path R2", controls=agreement_controls())
    print(f"path R2: peak_mem_bytes={torch.cuda.max_memory_allocated()}")
    torch.cuda.empty_cache()
    return out


def run_path_r3(dev, seed):
    """R3: jamba-smoke (the hybrid's period layout: Mamba layers, one
    attention layer a period, MoE every second layer, top-2) and
    llama4-scout-smoke (top-1 routing and a shared expert), float32 with
    remat, R3_STEPS steps of R3_BATCH x R3_SEQ tokens each:
    :func:`train_agreement`, with :func:`agreement_controls`."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import AdamWConfig

    keys = ("flash_attention_fwd", "flash_attention_bwd")
    out = dict.fromkeys(keys, 0)
    for arch in R3_ARCHS:
        cfg = dataclasses.replace(configs.get(arch, smoke=True),
                                  dtype="float32", remat=True)
        pipe = TokenPipeline(R3_BATCH, R3_SEQ, cfg.vocab_size, seed=seed + 5)
        got = train_agreement(
            dev, cfg, [pipe.next_batch() for _ in range(R3_STEPS)],
            AdamWConfig(lr=L2_LR, warmup_steps=1, eps=K2_EPS),
            f"path R3 {cfg.name}", controls=agreement_controls())
        out.update({k: out[k] + got[k] for k in keys}, **{arch: got})
    return out


#: path S: the six lag-twin examples on the card, ``main`` at their
#: ``--smoke`` sizes where they have one and their defaults otherwise,
#: and the kernels each must launch (any of them; quickstart's
#: ``api.pack`` runs the host packer, so it is held to running through;
#: lag_slo_sweep's ``--use-kernel`` drains on ``lag_update``, and its
#: packers run ``pack_rows`` either way)
S_EXAMPLES = (("quickstart", (), ()),
              ("scenario_sweep", (), ("pack_rows",)),
              ("lag_slo_sweep", ("--smoke", "--use-kernel"),
               ("lag_update_batch",)),
              ("pareto_frontier", (), ("anneal_step",)),
              ("live_dashboard", ("--smoke",),
               ("pack_rows", "lag_update_batch")),
              ("adversarial_report", ("--attack", "MWF"), ("pack_rows",)))
#: the kernel calls path S makes, as :func:`_kernel_calls` records them
#: and the check helpers take them: ``pack_rows`` (rows, N) at
#: quickstart's evaluation (3 deltas x 30 partitions), scenario_sweep's
#: sweep (5 families x 3 streams, 16 partitions), lag_slo_sweep's and
#: live_dashboard's smoke fleets (2 streams x 6 partitions, masked) and
#: pareto_frontier's heuristic points (one row of 8) and
#: adversarial_report's ``--attack MWF`` (its search's population of 8
#: genomes x 6 partitions); ``lag_update_batch``
#: (B, N, M bins) at lag_slo_sweep's drain; ``anneal_step`` (rows, K
#: chains a row, N) at pareto_frontier's 4 restarts x 7 lambdas
S_CALLS = {"pack_rows": ((3, 30), (15, 16), (2, 6), (1, 8), (8, 6)),
           "lag_update_batch": ((2, 6, 14),),
           "anneal_step": ((1, 28, 8),)}


@contextlib.contextmanager
def _kernel_calls(seen: dict):
    """Within the block, every call of ``pack_rows``, ``lag_update_batch``
    and ``anneal_step_launcher`` (a run of anneal steps over one state)
    adds one to ``seen[(kernel, shape)]``, the shape as S_CALLS gives it.
    The functions are swapped where the port's other modules hold them;
    their own modules keep them, for there the launch counters live."""
    import sys

    from repro_torch.kernels import binpack_select as bs
    from repro_torch.kernels import lag_update as lu
    from repro_torch.kernels import move_eval as me

    def spy(kernel, fn, shape):
        def called(*a, **k):
            key = (kernel, shape(*a, **k))
            seen[key] = seen.get(key, 0) + 1
            return fn(*a, **k)
        return called

    spies = {id(fn): spy(kernel, fn, shape) for kernel, fn, shape in (
        ("pack_rows", bs.pack_rows, lambda sp, *a, **k: tuple(sp.shape)),
        ("lag_update_batch", lu.lag_update_batch,
         lambda lag, p, a, r, cap, **k: (*lag.shape, cap.shape[-1])),
        ("anneal_step", me.anneal_step_launcher,
         lambda st, sp, pv, lam, cap, temps, draws, **k: (
             st.assign.shape[0] // draws, draws, st.assign.shape[1])))}
    swaps = [(mod, attr, spies[id(v)])
             for mod in list(sys.modules.values())
             if getattr(mod, "__name__", "").startswith("repro_torch")
             and mod not in (bs, lu, me)
             for attr, v in list(vars(mod).items()) if id(v) in spies]
    with _swapped(swaps):
        yield


def run_path_s(dev, seed):
    """Path S: each example's ``main([..., "--device", "cuda"])``, its
    launch counts zeroed before and read after and its kernel calls
    recorded (:func:`_kernel_calls`); an example that raises, that
    launched none of the kernels its route reaches, or whose launches
    its recorded calls do not account for, fails the path, as does a
    call at a shape outside S_CALLS (the shapes :func:`check_s_calls`
    holds).  Each example's output is kept, and its line count and last
    line printed.  Returns the launch counts by example."""
    import importlib
    import io

    import torch

    from repro_torch.kernels import _build

    out, shapes = {}, set()
    for name, argv, kernels in S_EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf, seen = io.StringIO(), {}
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), _kernel_calls(seen):
            mod.main(list(argv) + ["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in _build.launch_counts().items() if n}
        _require(not kernels or any(counts.get(k) for k in kernels),
                 f"path S {name}: launched {counts}, none of {kernels}")
        calls = {k: sum(n for (kern, _), n in seen.items() if kern == k)
                 for k in S_CALLS}
        _require(not set(counts) - set(S_CALLS)
                 and all(counts.get(k, 0) == calls[k]
                         for k in ("pack_rows", "lag_update_batch"))
                 and bool(counts.get("anneal_step")) == bool(
                     calls["anneal_step"]),
                 f"path S {name}: launches {counts}, recorded calls {calls}")
        shapes |= set(seen)
        lines = buf.getvalue().splitlines()
        print(f"path S {name} {' '.join(argv)}: wall_s={wall!r} launches="
              f"{counts} (held: {' or '.join(kernels) or 'none'}) at "
              f"{sorted(seen)}; {len(lines)} lines printed, the last: "
              f"{lines[-1]!r}")
        out[name] = counts
    extra = sorted((k, s) for k, s in shapes if s not in S_CALLS[k])
    _require(not extra, f"path S: kernel calls at {extra}, outside S_CALLS")
    return out


def check_s_calls(dev, gen) -> dict:
    """Each kernel against its plain version at path S's calls (S_CALLS);
    the largest error by kernel."""
    return {"pack_rows": max(check_pack_rows(dev, gen, rows, n)
                             for rows, n in S_CALLS["pack_rows"]),
            "lag_update_batch": max(
                check_lag_update(dev, gen, b, n, m, names=m)
                for b, n, m in S_CALLS["lag_update_batch"]),
            "anneal_step": max(check_anneal_step(dev, gen, rows, k, n)
                               for rows, k, n in S_CALLS["anneal_step"])}


#: path T: the one-card dry run's cells at full width and depth, each also
#: run for real at the batch its record names: (part, arch, shape)
T_CELLS = (("T1", LLM, "decode_32k"), ("T2", LLM, "prefill_32k"),
           ("T3", TRAIN, "train_4k"))
#: a measured peak's largest distance from the dry run's live bytes
T_PEAK_TOL = 0.15
#: T2's flash call is held against its plain version on its last rows over
#: the whole K/V (the full f32 score matrix would not fit the card)
T_FLASH_ROWS = 512
#: T2's flash tolerance (absolute and relative), scaled to what it compares:
#: over ~12k causal keys of N(0, 1) rows an output element is ~N(0, 0.009)
#: and the largest ~0.05, whose bfloat16 step is 2.44e-4 (the reading at
#: this call); ATTN_TOL's 2e-2 would pass an element off by twice a typical
#: value, 2e-3 passes none off by more than a quarter of one
T_FLASH_TOL = 2e-3
#: the kernels each part must launch, a step: (kernel, launches a layer)
T_KERNELS = {"T1": (("decode_attention_fwd", 1),),
             "T2": (("flash_attention_fwd", 1),),
             "T3": (("flash_attention_fwd", 2), ("flash_attention_bwd", 1))}


class TWalks:
    """The dry run of T_CELLS (``repro_torch.launch.dryrun.lower_cell``,
    the baseline rules), one spawned process a cell, all at once: started
    when made (``main`` makes it before the build, so that the walks, host
    work alone, overlap the build and the paths before T), read by
    :meth:`records`, its processes stopped by :meth:`close`."""

    def __init__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        from repro_torch.launch import dryrun

        self.t0 = time.perf_counter()
        self.pool = ProcessPoolExecutor(
            len(T_CELLS), mp_context=multiprocessing.get_context("spawn"))
        self.futs = {tag: self.pool.submit(dryrun.lower_cell, arch, shape,
                                           "baseline")
                     for tag, arch, shape in T_CELLS}

    def records(self, out_path) -> dict:
        """The records by part, each also written to ``out_path`` (for
        ``derived_replica_capacity``), once all are done."""
        recs = {tag: f.result() for tag, f in self.futs.items()}
        print(f"path T: dry run of {len(recs)} cells done "
              f"{time.perf_counter() - self.t0!r} s after it began")
        with open(out_path, "w") as f:
            for tag, _, _ in T_CELLS:
                f.write(json.dumps(recs[tag]) + "\n")
        self.close()
        return recs

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


#: the walks of path T, started by ``main`` before the build
T_WALKS = None


def _t_flash_rows_plain(q, k, v, start):
    """The flash forward's plain version on query rows ``start ..`` of a
    causal call (q holds those rows): the full-softmax formula of
    ``ref.attention_ref`` with the mask at the rows' absolute positions."""
    import torch

    from repro_torch.kernels.ref import NEG_INF, attention_scores

    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    s = attention_scores(q, k, causal=False)         # (B, KV, G*Sq, Skv)
    q_pos = start + torch.arange(sq, device=q.device).repeat(h // kvh)
    mask = q_pos[:, None] >= torch.arange(skv, device=q.device)[None, :]
    s = torch.where(mask, s, NEG_INF)
    return (torch.softmax(s, dim=-1) @ v.float()).reshape(b, h, sq, hd).to(
        q.dtype)


def t_kernel_calls(dev, gen, recs) -> dict:
    """The decode kernel at T1's call ([b, 8, 4, 128] over a 32,768-position
    cache, float32 and bfloat16, full and half filled) and the flash
    forward at T2's ([b, 32, 32,768, 128] over 8 KV heads, bfloat16, its
    last T_FLASH_ROWS rows against the plain version over the whole K/V),
    each timed beside its plain version, bound and SDPA.  Returns
    ``{kernel: (worst error, the call's row figures)}``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.shapes import SHAPES

    out = {}
    s = SHAPES["decode_32k"].seq_len
    b = recs["T1"]["batch_per_device"]
    err = check_decode(dev, gen, b, 8, 4, s, 128, (s - 1, s // 2))
    q = _normal(gen, (b, 8, 4, 128), "bfloat16", dev)
    kc = _normal(gen, (b, 8, s, 128), "bfloat16", dev)
    vc = _normal(gen, (b, 8, s, 128), "bfloat16", dev)
    clen = torch.tensor(s - 1, dtype=torch.int32, device=dev)
    kern = lambda: da.decode_attention_fwd(q, kc, vc, clen)  # noqa: E731
    plain = lambda: da.decode_attention_plain(q, kc, vc, clen)  # noqa: E731
    q4 = q.reshape(b, 32, 1, 128)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, kc, vc, enable_gqa=True)
    _require(torch.allclose(lib().reshape(q.shape).float(), kern().float(),
                            rtol=2e-2, atol=2e-2),
             "decode_attention and scaled_dot_product_attention disagree at "
             "path T1's call")
    bnd, by = bound_ms(2 * (2 * q.numel() + 2 * b * 8 * s * 128),
                       4 * b * 32 * s * 128, PEAK_FLOPS_BF16)
    out["decode_attention"] = (err, dict(
        at=f"path T1's call [{b}, 8, 4, 128] over {s} positions, full",
        max_abs_err=err, ms=graph_ms(kern, 20), plain_ms=graph_ms(plain, 3),
        bound_ms=bnd, bound_by=by, library_ms=graph_ms(lib, 20),
        wrapper_ms=cuda_ms(kern, 20)[0]))
    del q, kc, vc, q4

    s = SHAPES["prefill_32k"].seq_len
    b = recs["T2"]["batch_per_device"]
    q = _normal(gen, (b, 32, s, 128), "bfloat16", dev)
    k = _normal(gen, (b, 8, s, 128), "bfloat16", dev)
    v = _normal(gen, (b, 8, s, 128), "bfloat16", dev)
    kern = lambda: fa.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
    start = s - T_FLASH_ROWS
    rows = lambda: _t_flash_rows_plain(q[:, :, start:], k, v,  # noqa: E731
                                       start)
    got, want = kern()[:, :, start:], rows()
    err = _attn_close(got, want, "bfloat16", f"flash_attention at path "
                      f"T2's call [{b}, 32, {s}, 128], rows {start}..",
                      tol=T_FLASH_TOL)
    print(f"check flash_attention q=[{b}, 32, {s}, 128] kv_heads=8 causal "
          f"bfloat16, its last {T_FLASH_ROWS} rows: max_abs_err={err!r} "
          f"(tolerance {T_FLASH_TOL}; the plain rows' largest "
          f"{want.float().abs().max().item()!r}, their rms "
          f"{want.float().pow(2).mean().sqrt().item()!r})")
    del got, want
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    bnd, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                       4 * b * 32 * 128 * s * (s + 1) / 2, PEAK_FLOPS_BF16)
    out["flash_attention"] = (err, dict(
        at=f"path T2's call [{b}, 32, {s}, 128] over 8 KV heads (plain_ms: "
           f"its last {T_FLASH_ROWS} rows over the whole K/V)",
        max_abs_err=err, ms=graph_ms(kern, 2), plain_ms=graph_ms(rows, 1),
        bound_ms=bnd, bound_by=by, library_ms=graph_ms(lib, 2),
        wrapper_ms=cuda_ms(kern, 2)[0]))
    return out


def _t_cell(dev, seed, tag, rec, cap):
    """One cell of path T run for real at ``rec``'s batch: its inputs drawn
    on the card from ``seed``, a warm-up step at batch 1 (T1: the same
    step), then one step with the launch counts zeroed before and read
    after; the peak allocated since the cell began against the record's
    live bytes (within T_PEAK_TOL), the step's wall against the roofline.
    Returns the part's figures."""
    import gc

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import init_decode_state, init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    shape = SHAPES[rec["shape"]]
    cfg = dryrun.cell_config(rec["arch"], shape)
    b = rec["batch_per_device"]
    gen = torch.Generator(dev).manual_seed(seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def batch(n):
        return {k: (torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                  device=dev) if not t.is_floating_point()
                    else torch.randn(t.shape, generator=gen, device=dev
                                     ).to(t.dtype))
                for k, t in input_specs(cfg, shape, batch=n).items()}

    params = init_params(cfg, seed=seed, device=dev)
    if shape.kind == "decode":
        state = init_decode_state(cfg, b, shape.seq_len, dev)
        for name in ("k", "v"):           # a full cache, drawn from the seed
            for layer in state["kv"][name]:
                layer.normal_(generator=gen)
        state["cache_len"].fill_(shape.seq_len - 1)  # attend all of it
        step = make_serve_step(cfg, dev)
        warm = run = (lambda bt=batch(b): step(params, state, bt))
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, dev)
        warm = (lambda bt=batch(1): step(params, bt))
        run = (lambda bt=batch(b): step(params, bt))
    else:
        opt = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(), dev, donate=True)
        warm = (lambda bt=batch(1): step(params, opt, bt))
        run = (lambda bt=batch(b): step(params, opt, bt))
    warm()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    counts = _build.launch_counts()
    del res
    want = {k: n * cfg.n_layers for k, n in T_KERNELS[tag]}
    got = {k: counts[k] for k in want}
    _require(got == want, f"path {tag}: launches {got}, want {want}")
    others = {k: n for k, n in counts.items() if n and k not in want}
    _require(not others, f"path {tag} launched {others}")
    pred = rec["memory"]["live_bytes_per_device"]
    rl = rec["roofline"]
    roof = max(rl["t_compute_s"], rl["t_memory_s"])
    tokens = b * (1 if shape.kind == "decode" else shape.seq_len)
    print(f"{card_line()}: path {tag} {cfg.name} {rec['shape']} at "
          f"batch_per_device={b} (global {shape.global_batch}): peak "
          f"{peak} bytes allocated since the cell began (held before: "
          f"{before}) against the dry run's {pred} live bytes "
          f"({peak / pred - 1:+.2%}; within {T_PEAK_TOL:.0%} required)")
    print(f"{card_line()}: path {tag}: step wall_s={wall!r} against the "
          f"roofline's {roof!r} s ({rl['bottleneck']}-bound: compute "
          f"{rl['t_compute_s']!r}, memory {rl['t_memory_s']!r}), "
          f"{tokens / wall!r} tokens/s measured; the capacity bridge "
          f"(derived_replica_capacity) gives "
          f"{cap['tokens_per_s'] * tokens / b!r} tokens/s from the record "
          f"({cap['step_seconds']!r} s a step); "
          f"launches {got}")
    part = dict(peak=peak, predicted=pred, held_before=before, wall_s=wall,
                roofline_s=roof, batch=b, launches=got)
    if shape.kind == "decode":
        part["graph_ms"] = graph_ms(run, 1)
        print(f"{card_line()}: path {tag}: one step replayed as a CUDA "
              f"graph {part['graph_ms']!r} ms (roofline {roof * 1e3!r} ms)")
    _require(abs(peak / pred - 1) <= T_PEAK_TOL,
             f"path {tag}: peak {peak} bytes is not within {T_PEAK_TOL:.0%} "
             f"of the dry run's {pred}")
    del params, run, warm, step
    return part


def run_path_t(dev, seed):
    """Path T: the one-card dry run (``repro_torch.launch.dryrun``) of
    T_CELLS at full width and depth -- qwen3-8b decode_32k (T1) and
    prefill_32k (T2), olmo-1b train_4k (T3) -- then each cell's own step
    for real on the card at the record's ``batch_per_device`` (T1 also as
    a graph replay), its peak held within T_PEAK_TOL of the record's live
    bytes and its kernels' launches counted; then the decode and flash
    kernels at T1's and T2's calls against their plain versions.  Returns
    the parts' figures, the launches by part and the calls' rows."""
    import torch

    from repro_torch.launch.mesh import MESH_NAME
    from repro_torch.serving.capacity import derived_replica_capacity

    global T_WALKS
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    path = build / "dryrun_path_t.jsonl"
    walks, T_WALKS = T_WALKS or TWalks(), None
    recs = walks.records(path)
    for tag, rec in recs.items():
        print(f"path T {tag} record: " + json.dumps(
            {k: rec[k] for k in ("arch", "shape", "mesh", "batch_per_device",
                                 "flops_per_device", "bytes_per_device",
                                 "roofline", "memory", "walk_s")}))
    out = {"records": recs}
    for tag, rec in recs.items():
        cap = derived_replica_capacity(rec["arch"], rec["shape"],
                                       mesh=MESH_NAME, results_path=str(path))
        out[tag] = _t_cell(dev, seed, tag, rec, cap)
    gen = torch.Generator(dev).manual_seed(seed)
    out["calls"] = t_kernel_calls(dev, gen, recs)
    return out


def t_rows(out) -> list:
    """Path T's launches and calls as rows for :func:`merge_rows`: the flash
    forward (T2, T3), its backward (T3) and the decode kernel (T1), the
    calls at T1's and T2's shapes joining rows 7 and 6."""
    def launches(kernel):
        return {tag: out[tag]["launches"].get(kernel, 0)
                for tag in ("T1", "T2", "T3") if tag in out}

    def row(name, kernel, source, replaces, call=None):
        by = launches(kernel)
        r = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=sum(by.values()), launches_by_path=by,
                 max_abs_err=0.0, calls=[])
        if call is not None:
            err, fig = out["calls"][call]
            r.update(fig, max_abs_err=err, calls=[fig])
            r.pop("at")
        return r

    return [row("flash_attention", "flash_attention_fwd",
                "src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
                "src/repro/kernels/flash_attention.py:73", "flash_attention"),
            row("flash_attention_bwd", "flash_attention_bwd",
                "src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
                "src/repro/kernels/ops.py:48"),
            row("decode_attention", "decode_attention_fwd",
                "src/repro_torch/kernels/csrc/decode_attention.cu",
                "src/repro/kernels/decode_attention.py:65",
                "decode_attention")]


#: ``--paths``' names in the order of the full run: a letter names the
#: path with all its parts, C1, C2, J1, J2, K0-K3, L0-L2, O0-O3 and R1-R3
#: one part
PATH_NAMES = ("A", "B", "C1", "C2", "F", "G", "H", "I", "D", "E", "M", "N",
              "J1", "J2", "K0", "K1", "K2", "K3", "L0", "L1", "L2", "O0",
              "O1", "O2", "O3", "P", "Q", "R1", "R2", "R3", "S", "T")


def select_paths(spec: str):
    """The parts of PATH_NAMES that ``spec`` (comma-separated names, e.g.
    ``L0,L1`` or ``K,L``) names, in the full run's order; raises
    ValueError on a name that is not a path."""
    want = [x.strip().upper() for x in spec.split(",") if x.strip()]
    bad = [x for x in want if x not in PATH_NAMES
           and not any(p.startswith(x) for p in PATH_NAMES)]
    if bad or not want:
        raise ValueError(f"--paths {spec!r}: not paths {bad}; name some of "
                         f"{', '.join(PATH_NAMES)} or a letter A-T")
    return [p for p in PATH_NAMES
            if any(p == x or (len(x) == 1 and p.startswith(x))
                   for x in want)]


def run_named_paths(dev, seed, names) -> dict:
    """The paths ``names`` (parts of PATH_NAMES, in its order; all of
    them in the full run), each with the data the full run gives it and
    its checks held, launch counts zeroed before and read after each.
    Returns each path's result by name.  Paths A's and B's traffic are
    made once, for the paths that read them (TRAFFIC_READERS), and
    dropped after the last of those: the kernel rows make them again.
    After each path the bytes still allocated are printed."""
    import gc

    import torch

    out = {}

    def traffic(key, make):
        if key not in out:
            out[key] = make(dev, seed)
        return out[key]

    a_traffic = lambda: traffic("traffic_a", path_a_traffic)  # noqa: E731
    b_traffic = lambda: traffic("traffic_b", path_b_traffic)  # noqa: E731
    steps = {
        "A": lambda: run_path_a(*a_traffic()),
        "B": lambda: run_path_b(*b_traffic()),
        "C1": lambda: run_path_c1(*b_traffic()),
        "C2": lambda: run_path_c2(dev, seed),
        "F": lambda: run_path_f(dev, seed),
        "G": lambda: run_path_g(dev, seed, *b_traffic()),
        "H": lambda: run_path_h(dev, seed, *b_traffic()),
        "I": lambda: run_path_i(dev, seed),
        "D": lambda: run_path_d(dev, seed),
        "E": lambda: run_path_e(dev, seed),
        "M": lambda: run_path_m(dev, seed),
        "N": lambda: run_path_n(dev, seed),
        "J1": lambda: run_path_j1(dev, seed),
        "J2": lambda: run_path_j2(dev, seed),
        "K0": lambda: run_path_k0(dev, seed),
        "K1": lambda: run_path_k1(dev, seed),
        "K2": lambda: run_path_k2(dev, seed),
        "K3": lambda: run_path_k3(dev, seed),
        "L0": lambda: run_path_l0(dev, seed),
        "L1": lambda: run_path_l1(dev, seed),
        "L2": lambda: run_path_l2(dev, seed),
        "O0": lambda: run_path_o0(dev, seed),
        "O1": lambda: run_path_o1(dev, seed),
        "O2": lambda: run_path_o2(dev, seed),
        "O3": lambda: run_path_o3(dev, seed),
        "P": lambda: run_path_p(dev, seed),
        "Q": lambda: run_path_q(dev, seed),
        "R1": lambda: run_path_r1(dev, seed),
        "R2": lambda: run_path_r2(dev, seed),
        "R3": lambda: run_path_r3(dev, seed),
        "S": lambda: run_path_s(dev, seed),
        "T": lambda: run_path_t(dev, seed),
    }
    for i, name in enumerate(names):
        t0 = time.perf_counter()
        out[name] = steps[name]()
        for key, readers in TRAFFIC_READERS.items():
            if key in out and not set(readers) & set(names[i + 1:]):
                del out[key]
        gc.collect()            # tensors a path left in reference cycles
        torch.cuda.empty_cache()
        print(f"path {name}: wall_s={time.perf_counter() - t0!r} "
              f"held_bytes={torch.cuda.memory_allocated()}")
    return out


#: the paths that read paths A's and B's traffic
TRAFFIC_READERS = {"traffic_a": ("A",), "traffic_b": ("B", "C1", "G", "H")}
def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def check_kernels(dev, seed) -> dict:
    """Every kernel against its plain version at stress shapes and at the
    shapes paths A, B, C2, F, G, I, J, D-E, P, Q and S give it (the full
    run only).  Returns the largest error by kernel."""
    import torch

    from repro_torch.kernels import decode_attention as da

    gen = torch.Generator(dev).manual_seed(seed)
    # path D2's (and N2's) split count: fills 4 * split - 2 and - 1 put
    # the last filled position one short of and at a split boundary; path
    # M2's 16 KV heads of one query head each split their own way
    split = da.decode_splits(D_BATCH, 8, D_PROMPT + D_GEN)
    split_m = da.decode_splits(D_BATCH, 16, D_PROMPT + D_GEN)
    # path F's bucket groups: rows x N_b for pack_rows and lag_update
    f_groups = fleet_groups(seed)
    print(f"path F's bucket groups (T_b, N_b): scenarios {f_groups}")
    # stress shapes, then the shapes paths A, B, C2, F, G and I give each
    # kernel
    errs = {
        "lag_update_batch": max(
            check_lag_update(dev, gen, 4096, 256, 514, names=64),
            check_lag_update(dev, gen, 1024, 32, 66, names=66),
            *(check_lag_update(dev, gen, rows, nb, 2 * nb + 2,     # path F
                               names=2 * nb + 2)
              for (_, nb), rows in f_groups.items()),
            check_lag_update(dev, gen, 8, 6, 14, names=14),      # path I1
            check_lag_update(dev, gen, 128, 32, 66, names=66),   # path I2
            check_lag_update(dev, gen, 4, 32, 66, names=66),     # replays
            check_lag_update(dev, gen, 1, J1_N, 2 * J1_N + 2,    # path J1
                             names=2 * J1_N + 2)),
        "select_slot_grid": max(
            check_select_slot(dev, gen, 1024, 32, 65),
            check_select_slot(dev, gen, 1024, 1, 65),    # Modified Any Fit
            check_select_slot(dev, gen, 1024, 1, 33)),   # BFD's n + 1 slots
        "pack_rows": max(
            check_pack_rows(dev, gen, 1024, 7),
            check_pack_rows(dev, gen, 1024, 32),         # paths B, G
            check_pack_rows(dev, gen, 16, 256),          # path C2
            check_pack_rows(dev, gen, 3, 30),            # G's evaluate
            check_pack_rows(dev, gen, 1, 256),           # G's pack
            *(check_pack_rows(dev, gen, rows, nb)        # path F
              for (_, nb), rows in f_groups.items()),
            check_pack_rows(dev, gen, 8, 6),             # path I1
            check_pack_rows(dev, gen, 128, 32),          # path I2
            check_pack_rows(dev, gen, 4, 32),            # I2's replays
            check_pack_rows(dev, gen, 1, J1_N)),         # path J1
        "loop_fused": check_loop_fused(dev, seed),
        "move_delta_batch": max(
            check_move_eval(dev, gen, 6144, 32),       # path C1's shape
            check_move_eval(dev, gen, 28, 256),        # path C2's
            check_move_eval(dev, gen, 1024, 301)),     # stress, split chains
        "anneal_step": max(
            check_anneal_step(dev, gen, 1024, 6, 32),  # path C1: warp layout
            check_anneal_step(dev, gen, 1, 28, 256),   # path C2: clusters
            check_anneal_step(dev, gen, 8, 6, 6)),     # path I1: N = 6
        "flash_attention_fwd": max(
            check_flash(dev, gen, D_BATCH, 32, 8, D_PROMPT, D_PROMPT, 128),
            check_flash(dev, gen, D_BATCH, 16, 16, D_PROMPT, D_PROMPT,
                        128),                                  # path M1
            check_flash(dev, gen, 1, 32, 8, 8192, 8192, 128),   # stress
            check_flash(dev, gen, 2, 32, 8, 1000, 1000, 128),   # odd length
            check_flash(dev, gen, 2, 32, 8, 333, 1000, 128, causal=False)),
        "decode_attention_fwd": max(
            check_decode(dev, gen, D_BATCH, 8, 4, D_PROMPT + D_GEN, 128,
                         (0, 7, 4 * split - 2, 4 * split - 1,
                          D_PROMPT + D_GEN - 1)),        # paths D2, N2
            check_decode(dev, gen, D_BATCH, 16, 1, D_PROMPT + D_GEN, 128,
                         (0, 7, 4 * split_m - 2, 4 * split_m - 1,
                          D_PROMPT + D_GEN - 1)),        # path M2
            check_decode_graph(dev, gen, D_BATCH, 16, 1, D_PROMPT + D_GEN,
                               128, (17, 700, D_PROMPT + D_GEN - 1)),
            check_decode(dev, gen, D_BATCH, 8, 4, 32768, 128, (32767,)),
            check_decode_graph(dev, gen, D_BATCH, 8, 4, D_PROMPT + D_GEN,
                               128, (17, 700, D_PROMPT + D_GEN - 1)),
            check_decode(dev, gen, 8, 8, 4, 16, 128, (0, 1, 2, 3))),  # J2
        "lag_update_j1_bytes": check_j1_kernels(dev, seed),
        "rwkv6_wkv_fwd": _worst(
            check_wkv(dev, gen, D_BATCH, D_PROMPT, 40, 64),       # path E1
            check_wkv(dev, gen, D_BATCH, 1, 40, 64),              # path E2
            check_wkv(dev, gen, 1, 16384, 40, 64, chunk=4096),    # long
            check_wkv(dev, gen, 2, 1000, 40, 64),                 # ragged T
            check_wkv(dev, gen, 1, 16, 2, 16),   # the reference's tests
            check_wkv(dev, gen, 2, 64, 4, 32),
            check_wkv(dev, gen, 1, 13, 5, 64),   # T not a multiple of 8
            check_wkv(dev, gen, 3, 1, 5, 128),   # 4-warp blocks, T = 1
            check_wkv(dev, gen, 2, 77, 4, 128))}
    for k, err in check_new_calls(dev, gen).items():     # paths P and Q
        errs[k] = max(errs.get(k, 0.0), err)
    for k, err in check_s_calls(dev, gen).items():       # path S
        errs[k] = max(errs[k], err)
    return errs


def kernel_rows(dev, seed, out, errs) -> list:
    """Every kernel's row, from the full run's paths (``out``, by path
    name, with paths A's and B's traffic) and the errors of
    :func:`check_kernels`: each kernel timed at its paths' shapes
    against its plain version and its bound, with its launches."""
    import torch

    from repro_torch.kernels import binpack_select as bs
    from repro_torch.kernels import lag_update as lu
    from repro_torch.kernels import loop_fused as lf
    from repro_torch.kernels import move_eval as me

    rates_a, act_a = out.get("traffic_a") or path_a_traffic(dev, seed)
    rates_b, act_b = out.get("traffic_b") or path_b_traffic(dev, seed)
    (launches_a, launches_b, launches_c1, launches_c2, launches_f,
     launches_g, launches_h, launches_i, launches_d, launches_e,
     launches_j1, launches_k, launches_l) = (out[p] for p in (
        "A", "B", "C1", "C2", "F", "G", "H", "I", "D", "E", "J1", "K1",
        "L1"))
    launches_d = dict(launches_d, **out["M"], **out["N"], **out["P"],
                      **out["Q"], J2=out["J2"]["decode_attention_fwd"])
    k0 = out["K0"]
    # path S's launches, over its examples
    launches_s = {k: sum(c.get(k, 0) for c in out["S"].values())
                  for k in ("loop_fused", "lag_update_batch", "pack_rows",
                            "anneal_step")}

    kernels = []
    kw = dict(heuristic_kwargs(), active=act_a)
    b, t, n = rates_a.shape
    p = len(HEURISTICS)
    ms, _ = cuda_ms(lambda: lf.loop_fused(rates_a, **kw), 3)
    # path A's whole input once more, assignments recorded, against the
    # plain version (whose one run is also its time)
    got = lf.loop_fused(rates_a, record_assign=True, **kw)
    plain, want = cuda_ms(
        lambda: lf.loop_fused_reference(rates_a, record_assign=True, **kw),
        1, warmup=0)
    err = compare_loop_fused(got, want, "loop_fused at path A's shape")
    print(f"check loop_fused 8 heuristics B={b} T={t} N={n} masked (path "
          f"A's input), assignments recorded: bit for bit")
    errs["loop_fused"] = max(errs["loop_fused"], err)
    del got, want
    m = n + 1
    per_row_step = {"next": 3 * n, "first": 3 * n * m, "best": 3 * n * m,
                    "worst": 3 * n * m}
    ops = b * t * sum(per_row_step[s]
                      + (2 * n * n if d else 0)
                      + n * (n + 12) + 10 * n
                      for s, d in zip(kw["strategies"], kw["decreasing"]))
    byts = b * t * n * (4 + 4) + p * b * t * 4 * 5
    bnd, by = bound_ms(byts, ops)
    kernels.append(dict(
        name="loop_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/loop_fused.cu",
        replaces="src/repro/kernels/loop_fused.py:220",
        launches=launches_a["loop_fused"] + launches_s["loop_fused"],
        launches_by_path={"A": launches_a["loop_fused"],
                          "S": launches_s["loop_fused"]},
        max_abs_err=errs["loop_fused"],
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
        wrapper_ms=ms))
    print(f"loop_fused at path A's shape: ms={ms!r} against its bound "
          f"{bnd!r} ms ({by}); the one-thread-a-row kernel this design "
          f"replaced took 141.3 ms at this shape (PERF.md's kernel table, "
          f"H100 80GB HBM3, 700 W)")

    b, n = 1024, 32
    m = 2 * n + 2
    g = torch.Generator(dev).manual_seed(seed)
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    # the drain at path B's shape in the lag twin's own dtypes (f32 lag,
    # produced and cap, int64 assign, bool readable and active, active one
    # step of path B's [B, T, N] mask), so the timed calls convert nothing
    lag = torch.rand((b, n), generator=g, device=dev)
    produced = torch.rand((b, n), generator=g, device=dev)
    assign = torch.randint(-1, n, (b, n), generator=g, device=dev)
    readable = torch.rand((b, n), generator=g, device=dev) > 0.1
    cap = torch.ones((b, m), device=dev)
    act = act_b[:, 0]
    kern = lambda: lu.lag_update_batch(  # noqa: E731
        lag, produced, assign, readable, cap, active=act)
    ref = lambda: lu.lag_update_reference(  # noqa: E731
        lag, produced, assign, readable, cap, m=m, active=act)
    # bytes: lag, produced (f32), assign (int64), readable, active (bool)
    # in and out (f32) a partition, and the cap of each live bin a row
    # reads (the kernel reads cap only there)
    live = readable & act & (assign >= 0)
    live_bins = int(torch.unique(
        (torch.arange(b, device=dev)[:, None] * m + assign)[live]).numel())
    bnd, by = bound_ms(b * n * (4 + 4 + 8 + 1 + 1 + 4) + live_bins * 4,
                       b * n * 8)
    kernels.append(dict(
        name="lag_update", route="cuda",
        source="src/repro_torch/kernels/csrc/lag_update.cu",
        replaces="src/repro/kernels/lag_update.py:125",
        launches=launches_b["lag_update_batch"]
        + launches_f["lag_update_batch"] + launches_h["lag_update_batch"]
        + launches_i["lag_update_batch"] + launches_j1["lag_update_batch"]
        + launches_s["lag_update_batch"],
        launches_by_path={"B": launches_b["lag_update_batch"],
                          "F": launches_f["lag_update_batch"],
                          "H": launches_h["lag_update_batch"],
                          "I": launches_i["lag_update_batch"],
                          "J1": launches_j1["lag_update_batch"],
                          "S": launches_s["lag_update_batch"]},
        max_abs_err=errs["lag_update_batch"],
        max_abs_err_j1_bytes=errs["lag_update_j1_bytes"],
        ms=graph_ms(kern, 200),
        plain_ms=graph_ms(ref, 200), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 200)[0],
        # what a wrapper that cast the engine's tensors to int32 added a
        # call: three cast launches (host time, eager)
        casts_ms=cuda_ms(lambda: (assign.to(torch.int32),
                                  readable.to(torch.int32),
                                  act.to(torch.int32)), 200)[0],
        design="a warp a row, 8 rows a block; N <= 32: a lane a partition, "
        "each bin summed over the lanes __match_any_sync finds, in index "
        "order; inputs read in their own dtypes and row strides (no casts)"))

    m = 2 * n + 1                  # Modified Any Fit's slots, [R, 1, M]
    loads = torch.rand((b, 1, m), generator=g, device=dev)
    w = torch.rand((b, 1), generator=g, device=dev)
    k = i32(torch.randint(0, m + 1, (b, 1), generator=g, device=dev))
    capw = torch.ones((b, 1), device=dev)
    kern = lambda: bs.select_slot_grid(  # noqa: E731
        loads, w, k, capw, strategy="best")
    ref = lambda: bs.select_slot_plain(  # noqa: E731
        loads, w, k, capw, strategy="best")
    bnd, by = bound_ms(b * m * 4 + b * 4 * 4, b * m * 3)
    kernels.append(dict(
        name="binpack_select", route="cuda",
        source="src/repro_torch/kernels/csrc/binpack_select.cu",
        replaces="src/repro/kernels/binpack_select.py:76",
        launches=launches_b["select_slot_grid"]
        + launches_f["select_slot_grid"] + launches_g["select_slot_grid"]
        + launches_j1["select_slot_grid"],
        launches_note="no path launches the grid kernel: the packers run "
        "its selection code (select_slot_warp) inside pack_rows",
        max_abs_err=errs["select_slot_grid"], ms=graph_ms(kern, 200),
        plain_ms=graph_ms(ref, 200), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 200)[0]))

    # pack_rows at path B's Modified Any Fit call: MBF on step 8's speeds
    # with the assignment of steps 0-7 as prev
    from repro_torch.core.pack import modified_any_fit

    prev = torch.full((b, n), -1, dtype=torch.long, device=dev)
    for t in range(8):
        prev = modified_any_fit(rates_b[:, t], prev, CAPACITY,
                                active=act_b[:, t]).bin_of
    sp8, act8 = rates_b[:, 8].contiguous(), act_b[:, 8].contiguous()
    kern = lambda: modified_any_fit(  # noqa: E731
        sp8, prev, CAPACITY, active=act8)
    ref = lambda: plain_packer("MBF")(  # noqa: E731
        sp8, prev, CAPACITY, active=act8)
    got, want = kern(), ref()
    torch.cuda.synchronize()
    for f in ("bin_of", "names", "n_bins"):
        _exact(getattr(got, f), getattr(want, f), f"pack_rows MBF at path "
                                                  f"B's step 8: {f}")
    _require(torch.equal(got.loads.view(torch.int32),
                         want.loads.view(torch.int32)),
             "pack_rows MBF at path B's step 8: loads differ")
    # bytes: speeds, prev (int64) and active in; bin_of, loads, names and
    # n_bins out; operations: one fit compare a slot for each active
    # item's insert
    m = 2 * n + 1
    bnd, by = bound_ms(b * n * (4 + 8 + 1 + 8) + b * m * (4 + 8) + b * 8,
                       int(act8.sum()) * m)
    kernels.append(dict(
        name="pack_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/binpack_select.cu",
        replaces="src/repro/kernels/binpack_select.py:76",
        replaces_note="the selection kernel with the reference's scans "
        "around it (src/repro/core/jaxpack.py pack_jax and "
        "modified_any_fit_jax): one launch a packing call",
        launches=launches_b["pack_rows"] + launches_c2["pack_rows"]
        + launches_f["pack_rows"] + launches_g["pack_rows"]
        + launches_h["pack_rows"] + launches_i["pack_rows"]
        + launches_j1["pack_rows"] + launches_s["pack_rows"],
        launches_by_path={"B": launches_b["pack_rows"],
                          "C2": launches_c2["pack_rows"],
                          "F": launches_f["pack_rows"],
                          "G": launches_g["pack_rows"],
                          "H": launches_h["pack_rows"],
                          "I": launches_i["pack_rows"],
                          "J1": launches_j1["pack_rows"],
                          "S": launches_s["pack_rows"]},
        max_abs_err=errs["pack_rows"], ms=graph_ms(kern, 50),
        plain_ms=graph_ms(ref, 1), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 50)[0]))
    del prev, got, want

    k, n = 6144, 32                # path C1's chains and partitions
    m = 2 * n + 2
    margs, mact = _anneal_state(dev, g, k, n, masked=True)
    kern = lambda: me.move_delta_batch(*margs, active=mact)  # noqa: E731
    ref = lambda: me.move_delta_reference(*margs, active=mact)  # noqa: E731
    bnd, by = bound_ms(k * n * m * 4 + k * m * 8 + k * n * 16 + k * 8,
                       k * n * m * 4)
    kernels.append(dict(
        name="move_eval", route="cuda",
        source="src/repro_torch/kernels/csrc/move_eval.cu",
        replaces="src/repro/kernels/move_eval.py:135",
        launches=launches_c1["move_delta_batch"]
        + launches_c2["move_delta_batch"],
        launches_note="no path writes the move plane: the annealer runs "
        "anneal_step, which consumes each delta where it is computed",
        max_abs_err=errs["move_delta_batch"], ms=graph_ms(kern, 50),
        plain_ms=graph_ms(ref, 20), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 50)[0]))
    del margs, mact
    kernels.append(anneal_step_row(dev, g, launches_c1, launches_c2,
                                   launches_i, launches_s, errs))

    # lag_update_single: the same kernel at batch 1 ([1, 32], 66 bins);
    # no path calls it (the per-step loop drains every stream at once),
    # and it has no counter of its own (its launches count under
    # lag_update_batch), so no run measures its launches: null
    kern = lambda: lu.lag_update_single(  # noqa: E731
        lag[0], produced[0], assign[0], readable[0], cap[0], active=act[0])
    ref = lambda: lu.lag_update_reference(  # noqa: E731
        lag[0], produced[0], assign[0], readable[0], cap[0], m=m,
        active=act[0])
    bnd, by = bound_ms(n * (4 + 4 + 8 + 1 + 1 + 4)
                       + int(torch.unique(assign[0][live[0]]).numel()) * 4,
                       n * 8)
    got, want = kern(), ref()
    kernels.append(dict(
        name="lag_update_single", route="cuda",
        source="src/repro_torch/kernels/csrc/lag_update.cu",
        replaces="src/repro/kernels/lag_update.py:170", launches=None,
        launches_note="no path calls the rank-1 entry; it launches the "
        "lag_update kernel at batch 1, counted under lag_update",
        max_abs_err=_close(got, want, "lag_update_single"),
        ms=graph_ms(kern, 200), plain_ms=graph_ms(ref, 200), bound_ms=bnd,
        bound_by=by, library_ms=None, wrapper_ms=cuda_ms(kern, 200)[0],
        design="the lag_update kernel at batch 1: one warp"))

    kernels += attention_rows(dev, seed, launches_d, errs)
    fwd_row = kernels[-2]
    fwd_row["launches_by_path"]["K1"] = launches_k["flash_attention_fwd"]
    fwd_row["launches"] += launches_k["flash_attention_fwd"]
    merge_rows(kernels, [r_row(out)])
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
        source_cuda_cores=(
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"),
        routes="bfloat16 at hd 64 and 128 (K1, every served model): "
        "flash_attention_bwd_bf16.cu on wgmma; float32 at every head dim "
        "and bfloat16 at hd 16, 32 and 256: flash_attention_bwd.cu on the "
        "CUDA cores",
        replaces="src/repro/kernels/ops.py:48",
        replaces_note="the backward rule of the flash_attention custom_vjp "
        "(:29-60), which recomputes through the jnp online softmax; the "
        "reference has no Pallas backward kernel",
        launches=launches_k["flash_attention_bwd"]
        + sum(out[p]["flash_attention_bwd"] for p in ("R1", "R2", "R3")),
        launches_by_path={"K1": launches_k["flash_attention_bwd"],
                          **{p: out[p]["flash_attention_bwd"]
                             for p in ("R1", "R2", "R3")}},
        **{k: v for k, v in k0["olmo"].items()},
        max_abs_err_f32=max(k0[c]["max_abs_err"]
                            for c in ("f32", "single_key_f32")),
        cases={"qwen3_gqa_causal_bf16_4x32x1024": k0["qwen3_causal"],
               "qwen3_gqa_full_bf16_4x32x1024": k0["qwen3_full"],
               "gqa_causal_bf16_hd64_4x32x1024": k0["hd64_gqa"],
               "ragged_causal_bf16_2x16x1000_over_777": k0["ragged"],
               "qwen3_gqa_causal_f32_2x32x512": k0["f32"],
               "single_key_bf16_2x8x1": k0["single_key"],
               "single_key_f32_hd256_2x8x1": k0["single_key_f32"]},
        design="bf16 at hd 64/128: two wgmma kernels fed by TMA, f32 sums, "
        "the forward's lse; a block per 128 query rows computes D, writes "
        "D and lse to scratch and sums dQ = dS K (dS in registers); a block "
        "per 128 keys loops over the group's heads and q tiles of 64 and "
        "sums dV = P^T dO and dK = dS^T Q (P^T, dS^T in registers); 7 "
        "products a tile pair, no atomics, causal tiles skipped. f32 and "
        "the other bf16 head dims: the two CUDA-core kernels of "
        "flash_attention_bwd.cu"))
    kernels[-1]["max_abs_err"] = max(
        kernels[-1]["max_abs_err"],
        *(k0[c]["max_abs_err"] for c in ("qwen3_causal", "qwen3_full",
                                         "hd64_gqa", "ragged",
                                         "single_key")))
    kernels.append(wkv_row(dev, seed, dict(
        launches_e, L1=launches_l["rwkv6_wkv_fwd"]), errs))
    kernels.append(wkv_bwd_row(out["L0"], launches_l["rwkv6_wkv_bwd"]))
    merge_rows(kernels, whisper_rows(out["O0"], out))
    kernels.append(tailed_row(dev, seed, out["Q"],
                              errs["decode_attention_tailed_fwd"]))
    merge_rows(kernels, t_rows(out["T"]))
    return kernels


def r_row(out) -> dict:
    """The flash forward's row from path R: the launches of R1-R3 (the
    parts that ran), and R1's call (the forward with its lse, timed by
    :func:`r1_attention_call`) as the row's own figures and as one of its
    ``calls``; :func:`merge_rows` adds it to the full run's row."""
    call = out["R1"]["call"]
    parts = {p: out[p]["flash_attention_fwd"] for p in ("R1", "R2", "R3")
             if p in out}
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
                replaces="src/repro/kernels/flash_attention.py:73",
                launches=sum(parts.values()), launches_by_path=parts,
                **call, calls=[dict(
                    call, at="path R1's call with its lse (training's "
                             "forward, K1's shape)")])


def merge_rows(kernels, rows) -> None:
    """A path's rows (:func:`whisper_rows`, :func:`r_row`) into the full
    run's: each row's launches grow by the path's, its error by the
    path's worst, and the path's ``calls`` join its own."""
    by_name = {k["name"]: k for k in kernels}
    for row in rows:
        kern = by_name[row["name"]]
        kern["launches"] += row["launches"]
        kern.setdefault("launches_by_path", {}).update(
            row["launches_by_path"])
        kern["max_abs_err"] = max(kern["max_abs_err"], row["max_abs_err"])
        kern.setdefault("calls", []).extend(row.get("calls", []))


def print_rows(kernels) -> None:
    """Each kernel row's times, launches (by path where the row has them)
    and notes, a line each, then a line for each of its other ``calls``
    (``at`` names the call; its figures as measured)."""
    for kern in kernels:
        print(f"kernel {kern['name']}: ms={kern['ms']!r} "
              f"plain_ms={kern['plain_ms']!r} bound_ms={kern['bound_ms']!r} "
              f"({kern['bound_by']}, {kern['bound_ms'] / kern['ms']:.1%} of "
              f"it) library_ms={kern['library_ms']!r} "
              f"wrapper_ms={kern['wrapper_ms']!r} "
              f"launches={kern['launches']} "
              f"{kern.get('launches_by_path', '')}")
        if "design" in kern:
            print(f"kernel {kern['name']} design: {kern['design']}")
        if "casts_ms" in kern:
            print(f"kernel {kern['name']}: the engine's int64 assign and "
                  f"bool masks go in uncast; casting them to int32 would "
                  f"add {kern['casts_ms']!r} ms a call (eager)")
        if "routes" in kern:
            print(f"kernel {kern['name']} routes: {kern['routes']}")
        for c in kern.get("calls", []):
            share = (f" ({c['bound_ms'] / c['ms']:.1%} of the bound)"
                     if "bound_ms" in c else "")
            print(f"kernel {kern['name']} at {c['at']}: "
                  + " ".join(f"{k}={v!r}" for k, v in c.items() if k != "at")
                  + share)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", default=None,
                    help="run only these paths, comma-separated (e.g. "
                         "L0,L1 or K,L; a letter takes all its parts): "
                         "the build and its checks, the named paths, the "
                         "kernel rows they make whole, and a last line "
                         "that names them; default: every path A-T, "
                         "every kernel checked and every kernel row")
    args = ap.parse_args(argv)
    try:
        names = (list(PATH_NAMES) if args.paths is None
                 else select_paths(args.paths))
    except ValueError as e:
        ap.error(str(e))
    full = tuple(names) == PATH_NAMES

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    global T_WALKS
    if "T" in names:
        T_WALKS = TWalks()          # path T's walks, while the rest runs
    try:
        return _main(args, names, full, dev=torch.device("cuda"))
    finally:
        if T_WALKS is not None:
            T_WALKS.close()


def _main(args, names, full, dev) -> int:
    """``main`` after its checks: the build, the checks, the paths, the
    kernel rows and the last line."""
    import torch

    from repro_torch.kernels import _build

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    # full float32 products: the plain versions are the yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    print(f"build_s={time.perf_counter() - t0!r}")
    check_sass(lib)
    check_ptxas()
    if full:
        errs = check_kernels(dev, args.seed)
    else:
        gen = torch.Generator(dev).manual_seed(args.seed)
        errs = dict(check_new_calls(dev, gen) if {"P", "Q"} & set(names)
                    else {})
        if "S" in names:
            errs.update(check_s_calls(dev, gen))
    out = run_named_paths(dev, args.seed, names)
    if full:
        kernels = kernel_rows(dev, args.seed, out, errs)
    else:
        kernels = []
        if "L0" in out:
            kernels.append(wkv_bwd_row(out["L0"], out["L1"]["rwkv6_wkv_bwd"]
                                       if "L1" in out else None))
        if "O0" in out:
            kernels += whisper_rows(out["O0"], out)
        if "Q" in out:
            kernels.append(tailed_row(dev, args.seed, out["Q"],
                                      errs["decode_attention_tailed_fwd"]))
        if "R1" in out:
            kernels.append(r_row(out))
        if "T" in out:
            kernels += [r for r in t_rows(out["T"]) if "ms" in r]
    print_rows(kernels)
    if full:
        z = torch.zeros(1, device=dev)
        print(f"floor of one replayed graph node (a one-element add_): "
              f"{graph_ms(lambda: z.add_(1), 200)!r} ms")
    print(f"total_s={time.perf_counter() - t_start!r}")
    return finish(kernels, None if full else names)


def finish(kernels, paths=None) -> int:
    """The card's name and power limit again, so that they stand in the
    output's tail beside the numbers (the build's register report above
    is long), the kernel rows and the last line; a run of only some
    ``paths`` names them in its last line."""
    import torch

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    last = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if paths is not None:
        last["paths"] = list(paths)
    print(json.dumps(last))
    return 0


if __name__ == "__main__":
    sys.exit(main())
