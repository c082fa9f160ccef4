#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``horovod_tpu_torch``) on one NVIDIA
card, end to end, and check what comes out.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name, and its name and power limit as nvidia-smi
   reports them.
2. build   — compiles the hand-written kernels from ``csrc/`` with nvcc.
3. kernels — each rule of K1 (the flat fused optimizer update) against
   its plain PyTorch version on the same seeded inputs, over 3 steps, at
   ResNet-50's 25,557,032 parameters and at a ragged 1,000,003, and adam
   also at GPT-2 small's 124,439,808; then each rule's time (CUDA events,
   median of 25) at the size of its main path (GPT-2 small's for adam,
   ResNet-50's for the others) beside the plain version's,
   ``torch.optim``'s fused step on the same buffers (timed only, the port
   never calls it) and the bound from the bytes it must move.  The same
   for bf16 groups: each rule bit for bit against its plain version over
   3 steps (main-path and ragged lengths, and one element off 16-byte
   alignment), then timed beside ``torch.optim``'s fused step on bf16
   parameters.  K1 counts its launches by rule and group type, so each
   rule's entry in the kernels line gives its main path's float32
   launches and its ``bf16`` block that path's bf16 launches.  Adam reads
   its bias corrections from a device buffer filled from the device step
   count, and its plain version reads the same buffer.
4. flash_kernels — K2, K3 and K4 (flash attention forward, dq, dk/dv)
   against their plain versions on the same seeded inputs, each launch
   on the mainloop ``kernels.flash_plan`` names (checked by its counts:
   TMA + wgmma for bf16 at head dim 64, mma.sync for other bf16
   operands, the scalar kernels for float32) and the plain forward at
   the plan's kv tile: GPT-2 small's shape (b 4, h 12, s 1024, d 64) in
   bf16, causal, in the model's [b, s, h, d] layout; in float32 and in
   bf16, ragged lengths 136 and 192, causal and not, head dims 16, 32
   and 128, unnormalized at nonzero offsets including a kv shard wholly
   in the future (l and dq exactly 0, o finite), and operands off
   16-byte alignment; float32 outputs elementwise, bf16 ones row by row
   in norm (``FLASH_BF16_ROW_LIMIT``, ``FLASH_BF16_MEAN_LIMIT``).  Then
   each kernel's time at GPT-2 small's shape and layout on both bf16
   mainloops beside its plain version's, its bound, and
   ``F.scaled_dot_product_attention``'s forward (for K2) and backward
   (for K3 and K4 together), timed only.
5. parity  — a narrow ResNet-18 at 64×64 trained 2 steps in float32 from
   the same seeded weights on the card (K1) and on the CPU (plain), with
   TF32 off for convolutions and matmuls; losses, parameters and
   BatchNorm statistics compared.
6. gpt_parity — a float32 GPT of gpt_tiny's shape (2 layers, hidden 64,
   4 heads, vocab 256, seq 136) trained 2 fused-Adam steps on the card
   (K1-K4) and on the CPU (plain), TF32 off, from three seeds; losses and
   parameters.  Then gpt_bf16 — a bf16 GPT with GPT-2 small's head dim
   64 (2 layers, hidden 128, seq 320), one forward and backward on the
   card through K2-K4 and through their plain versions
   (``plain_flash_attention``) from the same weights and ids, three
   seeds: the loss and every parameter's gradient.
   graph_parity — the compiled step (a CUDA graph from its second call)
   against ``step.eager`` on the card: narrow ResNet-18s (fused momentum,
   all three kernel options, the per-leaf update) and the float32 GPT
   (fused Adam), 3 calls of 1 and of 3 steps each, at the parity limits
   above, the graphed warm-up and capture issuing the launches of the
   first two eager calls and the replay none; a foreign state raises; a graphed
   remat-full GPT step against the graphed step.  collectives — every
   collective on CUDA tensors at world size 1 over NCCL against its
   plain result, and an allreduce and an allgatherv inside a captured
   graph.
7. main path — ``examples.synthetic_benchmark.run``: ResNet-50, 224×224,
   batch 128, bf16, ``--fused-optimizer``, world size 1 over NCCL, the
   step graphed (the warm-up's first call eager, its second the capture,
   every timed call a replay, checked).  Checks a finite loss, one K1
   launch issued per eager and per captured step, and one gradient
   ``all_reduce`` per fusion bucket (plus one for the loss) per eager
   and per captured step; after the timed window, 2 more calls traced
   by torch.profiler must be replays that no wrapper counted, and the
   trace must hold one K1 launch for each of their steps; reports img/s
   and MFU, then the same run through ``step.eager``: its img/s.
8. profile — ResNet-50 steps graphed: the host's time to issue a call
   (5 replays), then 3 replays under torch.profiler: device time per
   step by kind of kernel, the device's idle share, and the port's
   kernels counted by name in the trace, which must be a step's count
   for each step.
9. elementwise_kernels — K6, K6' and K7 (the ResNet joins), on the loops
   ``kernels.elementwise_plan`` gives them and on the one-pack
   ``flat_binary`` loop they ran before, against their plain versions,
   bit for bit, in bf16 and float32 at ResNet-50's largest joins, a
   ragged row count, C = 36, an operand off 16-byte alignment and the
   expanded gradient of the final mean, and in bf16 at K6's eight and
   K7's four path shapes at batch 128, 32 and 1; K6's backward at the
   same cases (batch 128): dx bit for bit, dscale and dbias relative
   (``EW_SUM_RTOL``), two calls bit-identical, and with one row of its
   block sums dropped (planted) over the limit.  Then K6 and its
   backward at their eight shapes and K7 at its four, bf16, batch 128,
   each beside its old loop (the backward: beside the K6' and torch-op
   tail it replaced), its plain version and its bound, with the sums of
   launches x ms a step; K6' at K7's largest beside
   ``threshold_backward`` (timed only) and flat_binary.
10. conv_kernels — K8, K9 and K10 (the fused 3x3 conv's three epilogues)
   against their plain versions at ResNet-50's four stride-1 3x3 shapes
   in bf16 (row by row in norm, ``CONV_BF16_*``) on the TMA + wgmma
   mainloop and on mma.sync, and in float32, then at small float32,
   rectangular, odd-size, C = 24, 3-channel and misaligned cases; K9's
   sums relative (``CONV_SUM_RTOL``); each case's launches must name the
   mainloop ``kernels.conv3x3_plan`` gives it.  Then each kernel's time
   at the four shapes on both bf16 mainloops beside its plain version's,
   its bound and ``F.conv2d``'s on channels-last bf16 (the conv alone,
   timed only).
11. variants_parity — narrow ResNet-18 and ResNet-50 with
   ``norm_act``, ``residual_join`` and ``conv_bn`` set to "pallas",
   trained 2 steps in float32 on the card (K6-K10, K1) and on the CPU
   (plain), TF32 off; losses, parameters, statistics, then the eval
   forward's logits (K8); launches counted against the models' modules.
12. variants_main_path — the synthetic benchmark with the three options:
   ResNet-50, 224x224, batch 128, bf16, fused momentum.  Checks a finite
   loss, per step K6 20, K6's backward 20 (and its second pass 20), K6'
   16, K7 16, K9 13, K10 13, K8 0, K1 momentum 1, no flash launch and
   one gradient ``all_reduce`` per fusion bucket,
   both as issued and in the trace of 2 more replays, as the main path,
   every K9 and K10 launch on the TMA + wgmma mainloop; reports img/s,
   MFU and peak memory beside the default path's img/s, graphed as the
   main path and then through ``step.eager``; then one eval forward of a
   batch: K8 13 (all on TMA + wgmma), K9 0, finite logits.
13. variants_profile — those steps graphed, as in profile, by kind
   (``K6-K7`` and ``K8-K10`` for the port's kernels).
14. rules   — the same trainer 3 steps each with fused SGD and fused Adam
   (eager, capture, a traced replay), so every K1 rule runs on a
   training path.
15. gpt_main_path — ``examples.gpt_synthetic_benchmark.run`` at its
   defaults: GPT-2 small, batch 4, seq 1024, bf16, flash attention,
   fused Adam, world size 1 over NCCL.  Checks a finite loss, K2, K3 and
   K4 each launched 12 times a step, K1 adam once a step, one gradient
   ``all_reduce`` per fusion bucket per step, as issued and in the trace
   of 2 more replays, K2, K3 and K4 on TMA + wgmma; graphed as the main
   path, then through ``step.eager``; reports
   seq/s of both and MFU.
16. gpt_profile — GPT-2 small steps graphed, as in profile, by kind
   (``flash`` for K2-K4, ``matmul`` for the projections).
17. bert_main_path — ``examples.bert_synthetic_benchmark.run`` with
   ``--attn pallas`` at its defaults: BERT-base, batch 8, seq 512, bf16,
   non-causal flash attention, AdamW leaf by leaf (optax's order), the
   fixed float32 MLM head; checks as gpt_main_path (K2, K3, K4 12 a step
   each on TMA + wgmma, no K1), then ``step.eager`` and ``--attn xla``
   graphed: their rates, and the head's float32 product timed alone.
18. registry_main_path — ``examples.synthetic_benchmark.run`` on VGG-16
   (224x224), Inception V3 (299x299) and ViT-B/16 (224x224), batch 64,
   bf16, fused momentum: a finite loss, K1 momentum once a step and one
   gradient all_reduce per bucket, as issued and traced; the graphed and
   eager rates, peak memory, and MFU over ``FlopCounterMode``'s count of
   one forward and backward on the card.

19. wire — the wire tier at world size 1 over NCCL on tensors shaped
   like ResNet-50's 161 gradient leaves: what the card's torch and NCCL
   do with a float8 SUM (the route), then for bf16, int8, fp8 e4m3 and
   fp8 e5m2 (where the card reduces them) error feedback through
   ``fused_allreduce`` eagerly and inside one captured graph, bit for
   bit against the port's CPU result on the same seeded inputs (q, the
   output, the new residual), one MAX all-reduce a call for a
   quantizer's scales; Adasum and ``hierarchical`` give their input and
   ``two_level`` counts its trivial-topology fallback.  Nothing across
   cards is shown (run after collectives).
20. ef_main_path — the main path with ``--compression int8`` (error
   feedback), and fp8 e4m3 where the card reduces it: the main path's
   checks, per step one all_reduce per bucket, one MAX and one for the
   loss, a residual of one finite, nonzero leaf a parameter, one guard
   read every EF_GUARD_STEPS calls; img/s beside the main path's (run
   after main path).
21. frontend_main_path — a narrow ResNet-18 of the reference's
   plain-torch bench model in float64, 2 steps through
   ``horovod_tpu_torch.torch.DistributedOptimizer`` on the card against
   plain ``torch.optim.SGD`` on the CPU (frontend_parity); then
   ``examples.pytorch_synthetic_benchmark.run`` at the reference's
   defaults (ResNet-50, batch 32, float32, eager) plain and with
   ``--fp16-allreduce``: one gradient all_reduce a parameter a step, a
   finite loss, img/s, 2 more steps traced (run after ef_main_path).
22. bert_adasum — BERT-base, ``--attn pallas --adasum``, graphed, the
   warm-up, the capture and 2 replays: K2-K4 12 a step, the loss's
   all_reduce alone, and the final loss bit-equal to the same run
   without ``--adasum`` (run after bert_main_path).

23. ring_kernels — K5, the flash ring's hops (K2 unnormalized at global
   offsets, K3 and K4 against the ring's global lse), on the card: the
   ring of 4 virtual ranks driven in lockstep through the ring's own hop
   functions (``parallel/ring_attention.ring_lockstep``: where the
   distributed ring sends, the held shards and their dk/dv roll) at
   GPT-2 small's attention (b 4, h 12, s 1024, d 64, bf16, shards of
   256) causal and not, and in float32 at shards of 136; every virtual
   rank's output and dq/dk/dv against the same hops through the plain
   versions at the plan's kv tile (``FLASH_BF16_*``, float32
   elementwise) and against ``flash_attention`` over the whole sequence
   (``RING_FULL_*``); 16 launches of each of K2-K4 a ring on the
   mainloop ``flash_plan`` names; every causal hop on a wholly future
   shard alone: l and dq exactly 0, o finite; the ring with a hop-local
   lse, and again with a dropped hop, planted in its hop calls must miss
   the whole-sequence limits.  Then one hop of each timed at the shard
   shape and the whole ring's forward and backward
   beside flash_attention's (timed only).
24. model_parallel — ``ParallelMLP`` through ``shard_tp_params``, the
   pipeline (S = 1, 4 microbatches) and ``moe_apply`` (ep = 1, 4
   experts), one SGD step each on the card with groups of one against
   the same on the CPU, float32, TF32 off, at the parity limits.
25. gpt_sp_main_path — the GPT bench at its defaults with
   ``--seq-parallel ring`` (K2 unnormalized, K3, K4: 12 each a step, on
   TMA + wgmma, issued and traced) and ``--seq-parallel ulysses`` (K2
   normalized), world size 1 over NCCL, graphed, as gpt_main_path; the
   final losses against that run's within ``GPT_BF16_LOSS_RTOL``, the
   seq/s beside its (run after gpt_main_path).
26. bert_sp_main_path — BERT-base with ``--attn pallas --seq-parallel
   ring``, cut as bert_adasum, full depth: the same checks, non-causal,
   the loss against bert_adasum's run without either (run after it).

27. trace_plane — the GPT bench at its defaults (as gpt_main_path,
   graphed) with the trace plane on: ``HVD_TRACE_DIR`` set with a window
   of calls 3-5 (after the capture), ``HVD_PROFILE=1`` over the same
   window, ``HVD_PROFILE_XLA=1``, the metrics registry on.  Checks: (1)
   ``comm.json`` is valid JSON from the native writer with one STEP span
   a call of the window and the writer closed after it; (2)
   ``compute.json`` holds forward / backward / grad_allreduce /
   optimizer_update once a profiled step each, K1-K4 issued in them
   (counted, all on TMA + wgmma), the forward's FLOPs within 5% of the
   analytic count's third (``transformer_train_flops_per_seq`` × batch ÷
   3), a finite MFU and host gap; (3) ``metrics.json`` (dumped when the
   end step closed the timeline): ``hvd_steps_total`` the calls so far ×
   ``in_graph_steps``, the traced all-reduce inventory the reference's
   (the loss's, once a recorded program), ``hvd_train_loss`` the last
   loss; (4) ``dag.gml`` of the step, traced on the card with make_fx,
   has one node per launch of K1-K4 (``hvd.*`` ops) with edges from
   their inputs; (5) the window's CUPTI trace (``cuda_trace/``) holds
   K1-K4 by name and one range per gradient bucket named after its
   tensors; (6) the run's final loss within GPT_BF16_LOSS_RTOL of
   gpt_main_path's; (7) the graphed seq/s outside the window (iterations
   2 and 3) within 2% of the same bench's with the trace plane off: the
   mean of four runs each, in turns (off, the checked run, on, off, off,
   on, on, off), as one run settles at one of two rates 2.4% apart by
   chance, with the trace plane on or off.  Then ``examples.pytorch_synthetic_benchmark.run``
   at its defaults with ``HVD_TIMELINE`` set, in turns with it unset
   (off, on, on, off): one ``MESH_ALLREDUCE`` span a step for each of
   ResNet-50's 161 parameters, named as its ``gradient_name_list.json``
   names them, and the img/s of both; the profiled window again without
   the capture (its segments' ms a step); and the host µs of a K2 launch
   through its wrapper, as the training path calls it and through the
   op ``hvd::flash_fwd`` (run after gpt_main_path).
28. autotune — the tuners through the train step's rebuild seam (a
   rebuild is a new CUDA-graph capture).  (a) GPT-2 small (b 4, s 1024,
   bf16, flash K2-K4, K1 Adam) through ``make_train_step(autotune=True)``
   (``HVD_AUTOTUNE_COMPUTE`` unset; AUTOTUNE_ENV: one warm-up sample,
   then a sample every AUTOTUNE_SPS calls), each call synced, until the
   GP has scored AUTOTUNE_SCORED distinct fusion thresholds.  Checks:
   one capture for each knob signature built, each build's calls eager,
   capture, then replays; each captured graph's 2 traced replays launch
   K1 once a step and K2-K4 12 times a step; launches issued by the
   eager and captured calls alone; the memory allocated after the last
   capture within AUTOTUNE_MEMORY_SHARE of after the first (each rebuild
   releases the old graph and its pool); the losses equal, call by call,
   those of the same run with autotune off (a difference is reported
   with its knobs and held to GPT_LOSS_RTOL, the graphed-vs-eager
   limit).  Prints the thresholds visited and the GP's scores, each
   build's host ms (eager call plus capture), and the synced seq/s of
   the first and the last build.  (b) ResNet-50 (b 128, bf16,
   ``fused_sgd`` momentum with ``fused_optimizer=False``), its host
   batches from a seeded numpy generator through ``prefetch_to_device``,
   with ``HVD_TRACE_DIR``, ``HVD_PROFILE=1`` (calls PG_PROFILE) and
   ``HVD_AUTOTUNE_PROFILE_GUIDED=1`` (windows of PG_WINDOW calls), cuDNN
   deterministic: the tuner measures its baseline, takes the profiler's
   anatomy, applies the ``fused_optimizer`` plan through the rebuild and
   verifies it or rolls it back.  Checks: the plan equals
   ``compute_plans_from_anatomy``'s for the measured anatomy; K1 0 a step
   in the first graph's traced replays and 1 in the plan's (issued: 0
   and 1 by each build's eager and capture calls); the losses finite and
   within the parity limits of the same run on the per-leaf path alone;
   the first batches prefetched equal the host batches, copied on the
   prefetcher's own stream; ``analyze(trace_dir, last_steps=1)`` on the
   card's trace.  Prints the tuner's history (predicted against realized
   speedup), the critical path's split of the step and the simulator's
   ranked scenarios (run after trace_plane).

29. launcher — ``python -m horovod_tpu_torch.run -np 1`` starts the GPT
   bench at its defaults (as gpt_main_path) with ``--cuda-trace``,
   pointed at a rendezvous server this script runs (the external-server
   path, every scope journaled), ``HVD_TRACE_DIR`` with the launcher's
   ``--trace-start-step 3 --trace-end-step 5``, ``HVD_PROFILE=1`` over
   calls 8-9 and a 1 s push interval.  Checks: the launcher exits 0
   and its worker ran on ``cuda:0``; signed ``GET /metrics`` holds rank
   0's families with ``hvd_steps_total`` 17 and a finite
   ``hvd_train_loss``, and at least 2 snapshots landed; ``GET /profile``
   holds rank 0's anatomy of 2 steps; ``GET /events`` the bench's
   ``bench.result``; ``GET /health`` no lease (world 1 runs no
   heartbeat) and no abort; the journal replays to the server's store,
   its ``metrics`` scope included; ``comm.json`` holds the window's 3
   ``STEP`` spans and ``clock_sync.json``'s offset maps them inside the
   launch, to within half its round trip; the worker issued K1 Adam and
   K2-K4 (on ``wgmma``) as gpt_main_path's and the profiled window's
   calls account for, and the window's trace shows K1 1 and K2-K4 12
   each a step in its 3 graphed replays; iteration 3's rate (calls
   13-17, replays only) within LAUNCH_RATE_SHARE of gpt_main_path's.
   Prints that share, the seconds from the launch to the first step and
   the phase's wall time.
30. elastic — the state plane and the native host planes, on the
   headline cell (ResNet-50, 224x224, batch 128, bf16 over float32
   parameters, K1 momentum, graphed, cuDNN deterministic); run last,
   since its reinit releases every step built before it.
   (a) ``ElasticState`` with ``HVD_SNAPSHOT=1`` over a fixture of three
   peer managers on loopback (this process's and two peers, one
   rendezvous server): 20 calls, a save every 5 (the first also writes
   the storage tier); then a fresh model (another seed) and a fresh step
   ``resume()`` from the peers and make 5 more calls.  Checks:
   ``restore.source`` is ``peer``; the restored tensors equal, bit for
   bit, the state an uninterrupted run of the same calls held at the
   restored generation; the 5 resumed losses and the 20 of the snapshot
   run equal that run's; K1 issued one launch a step the host ran.
   Prints each snapshot's host stall (µs) and its device copy (µs, CUDA
   events), the rate of calls 6-20 with and without snapshots, the
   seconds the snapshotter still needed after call 20, the newest
   generation committed at that point (the steps a crash then would
   lose), and the restore's ms (5 fresh restores).  (b) ``reinit()``
   after call 10 of 20: the next call builds the step again (one eager
   call, one new capture), the allocated memory after the new capture
   within 1% of before, the losses equal an unbroken run's.  (c)
   ``python -m horovod_tpu_torch.run -np 1 --restarts 1`` on
   ``scripts/torch_elastic_tasks.py restart`` (16 steps, a checkpoint
   every 5) with ``HVD_FAULT_SPEC`` ending attempt 0 at step 12: attempt
   1 resumes from ``step_10`` and its loss at step 15 equals the same
   task's run here, unbroken; prints the seconds from the kill to the
   first resumed step.  (d) ``-np 2 --controller native`` on
   ``scripts/torch_elastic_tasks.py allreduce``: two CPU workers sum
   ResNet-50's 25,557,032 float32 gradients 3 times over the peer ring
   and once over the coordinator star (the path ``HVD_RING=0`` takes),
   equal to numpy's sum; prints GB/s of each (the native core built here
   first, its seconds printed).
31. serving — the serving plane on ResNet-50 with the three kernel
   options (K6, K7, K8 in its eval forward), bf16 compute over float32
   parameters, channels-last, 224x224x3 float32 requests; its state
   after one train-mode forward (BatchNorm statistics moved) written
   with ``save_checkpoint`` and read back with ``load_params``; replicas
   hold int8 weights at rest; buckets 1-32, a 5 ms flush; cuDNN
   deterministic, TF32 off; run before elastic.  (a) K8 at batch 1 and
   32 on the four CONV_SHAPES against its plain version (CONV_BF16_*,
   on wgmma) and K6, K7 bit-equal at [1 and 32, 56, 56, 256], each
   timed beside its plain version, its bound and (K8) ``F.conv2d``.
   (b) ``LocalServingPlane(replicas=1)``: warm-up captures 6 graphs
   (counts set to 0 before it: K6 20, K7 16, K8 13 a forward, 12
   forwards, K8 on wgmma), each bucket's replay bit-equal to the eager
   forward of its batch, one traced bucket-32 replay runs K6 20, K7 16,
   K8 13; then the capacity (closed loop, full buckets), bucket 1's
   latency at low load and the bench fixture's bursty trace at 20% /
   100% of the capacity, every served row within SERVE_ROW_LIMIT of its
   request's float32 forward with the same decompressed weights and
   nearer to it than to any other request's, 6 graphs at the end, no
   request failed, rejected, duplicated or requeued; prints p50, p99,
   goodput, goodput_under_burst (latencies from each request's
   scheduled arrival), batch fill, the generator's lateness, the
   interpreter's collections, the int8 ratio and one batch's host
   split.  Each trace runs with the heap built before it frozen out of
   the collector and fails if a request was sent more than
   SERVE_LATE_SHARE of the SLO late.  (c) elastic, one spare, the
   admission cap lifted to the trace's length: a burst at 150% of the
   capacity grows one epoch, replica 1 captures while replica 0
   replays, a drained shrink follows; no drop, duplicate or requeue,
   one drain, the rows as (b).  (d) ``python -m
   horovod_tpu_torch.run -np 1 --serve --serve-max-batch 1`` on
   ``scripts/torch_serve_tasks.py serve`` (the same checkpoint): 8
   signed ``post_infer`` requests, each row bit-equal to (b)'s bucket-1
   graph, ``GET /serving`` counting them.  (e) the headline cell graphed
   with the dormant profiler (``profile=None``) against
   ``profile=False`` in turns; then ``python -m horovod_tpu_torch.run
   -np 1`` on ``scripts/torch_serve_tasks.py watch`` with the watchdog
   on by default and the step seam slowed 30 ms from call 41 (the task
   polls the launcher only from there, so that no poll lands in the
   clean cadence): a ``step_time_regression`` alert naming rank 0
   fires within WATCH_FIRE_WITHIN steps of the slowdown, its arm
   record opens the dormant profiler's window, and ``GET /profile``
   holds its anatomy.  The result counts the ticks on the clean
   cadence that could have fired (``pre_slow_ticks_that_could_fire``).

Phase 6 also holds registry_parity: a narrow VGG with BatchNorm,
Inception V3 at 107x107 and a 2-layer ViT trained 2 fused-momentum steps
on the card and on the CPU as in parity, and bert_tiny (flash attention
at seq 136) with the BERT bench's masked loss and AdamW as in
gpt_parity.  Phase 3 times K1 momentum at VGG-16's 138,357,544
parameters too, phase 4 checks and times K2-K4 at BERT-base's shape
(b 8, h 12, s 512, d 64, non-causal), and every main path's traced
replays give its device time by kind and idle share.

Every kernel count is set to 0 just before each main path and read just
after it.  A wrapper counts the launches the host issues; a graph's
replay runs the captured kernels without it, so what the replays ran
is read from the profiler's trace, and the kernels line's ``launches``
are the trace's counts (``LAUNCHES_NOTE``).  Then the
``{"kernels": [...]}`` line, the nvidia-smi line
and, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before the last line.

``--flash-only`` runs the device, build and flash_kernels phases alone
and prints no last line: the quick check of a change to K2-K4.
``--variants-only`` runs the device and build phases and phases 9-13,
then a kernels line of K6-K10, and prints no last line.
``--model-parallel-only`` runs the device and build phases, phases 23
and 24, gpt_main_path, 25, bert_adasum and 26, then a kernels line of
K5, and prints no last line.  ``--trace-plane-only`` runs the device and
build phases, gpt_main_path and trace_plane (without the frontend's
untraced rate), and prints no last line.  ``--autotune-only`` runs the
device, build, gpt_main_path and autotune phases, and prints no last
line.  ``--launcher-only`` runs the device, build, gpt_main_path and
launcher phases, and prints no last line.  ``--elastic-only`` runs the
device, build and elastic phases, and prints no last line.
``--serving-only`` runs the device, build and serving phases, and prints
no last line.
"""

import contextlib
import copy
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

PARAMS_RESNET50 = 25_557_032
#: GPT-2 small's parameters: one flat float32 buffer on the GPT main path
PARAMS_GPT2_SMALL = 124_439_808
#: VGG-16's (224x224, 1000 classes): K1 momentum's largest main path
PARAMS_VGG16 = 138_357_544
RAGGED = 1_000_003
TIMED_RUNS = 25
#: about 2 ms of the card's clock: longer than the host takes to queue any
#: timed call, so the card is still busy when the call's launches arrive
SLEEP_CYCLES = 4_000_000

#: K1 agrees with its plain version to the reference's own pinned
#: tolerance (tests/test_fused_update.py:65).  Built with --fmad=false,
#: each kernel rounds like the plain version, so the error is expected 0.
K1_RTOL, K1_ATOL = 2e-6, 1e-7

#: card-vs-CPU training parity: float32 on both sides with TF32 off; the
#: cuDNN and CPU convolutions sum in different orders, so the two agree
#: to float32 accumulation error, not bit for bit
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5

#: per rule: (kernel body it replaces, bytes and flops per element)
RULES = {
    "sgd": ("horovod_tpu/optim/fused_update.py:139", 3 * 4, 2),
    "momentum": ("horovod_tpu/optim/fused_update.py:143", 5 * 4, 4),
    "adam": ("horovod_tpu/optim/fused_update.py:149", 7 * 4, 14),
}


#: GPT-2 small's attention on the main path: batch 4, 12 heads, seq 1024,
#: head dim 64
GPT_ATTN_SHAPE = (4, 12, 1024, 64)
#: BERT-base's on the BERT main path (--attn pallas, non-causal): batch 8,
#: 12 heads, seq 512, head dim 64
BERT_ATTN_SHAPE = (8, 12, 512, 64)

#: K2-K4 against their plain versions in float32, elementwise (rtol,
#: atol): both sum in float32 in other orders, and the JAX tests' own
#: tolerance against a dense oracle is 2e-4.
FLASH_TOL = {torch.float32: (2e-4, 2e-4)}
#: ... and in bfloat16, each output row (its last dim) in norm: the row
#: error ||got - plain|| / (||plain|| + FLASH_ROW_FLOOR * the mean row
#: norm).  The plain forward rounds p to bf16 per kv tile against the
#: running max, as the kernel does, so what is left is float32 summation
#: order and, where that tips a rounding, one bf16 ulp (2^-7 relative) of
#: an element of o or of one p or ds term of a sum: the largest row error
#: of o, dq, dk and dv is held to that ulp (sound runs read up to 2^-8, a
#: row dominated by one flipped term), of the float32 m and l to 1e-5
#: (read: up to 1.8e-6).  A fault that moves every row a little (p
#: truncated, not rounded: 6.7e-3 at most in a row) stays under the ulp,
#: so the mean row error is held too, to FLASH_BF16_MEAN_LIMIT, about 9x
#: the sound runs' worst mean (1.1e-5, o) and 40x below that fault's
#: (4.2e-3): in a sound run few rows hold a flipped rounding.  The floor
#: keeps rows far below the typical one (a fully masked row, an m near 0)
#: from asking for exactness.
FLASH_BF16_ROW_LIMIT = {"o": 2 ** -7, "m": 1e-5, "l": 1e-5,
                        "dq": 2 ** -7, "dk": 2 ** -7, "dv": 2 ** -7}
FLASH_BF16_MEAN_LIMIT = 1e-4
FLASH_ROW_FLOOR = 1e-2

#: GPT card-vs-CPU parity (float32, TF32 off).  Losses agree to float32
#: summation-order error.  Adam's first steps move each parameter by about
#: lr * sign(g): where a gradient is within rounding of 0 the two devices
#: may step it opposite ways, so a few parameters may differ by up to
#: 2 * lr per step; all others agree to float32 rounding of the update.
#: The share of parameters beyond GPT_PARAM_ATOL is about 3x the worst of
#: three seeds' readings (14, 4 and 1 of 149,120, key bias apart).
GPT_LOSS_RTOL = 1e-5
GPT_PARAM_ATOL = 1e-6
GPT_FLIP_BOUND = 2.0
GPT_FLIP_SHARE = 3e-4
#: the attention's key bias has an exact gradient of 0 (adding q.b to
#: every score of a row leaves the softmax unchanged), so Adam steps it on
#: rounding noise on both devices: exempt by name, bounded by
#: GPT_FLIP_BOUND * lr * steps alone, its gradient reported
KEY_BIAS = "key/bias"
GPT_PARITY_SEEDS = (3, 13, 23)

#: a bf16 GPT's step through K2-K4 against the same through their plain
#: versions: the loss, and each parameter's gradient in norm
#: (||g_kernels - g_plain|| / ||g_plain||), about 4-6x the worst of three
#: seeds' readings (loss 1.7e-5; gradients 8.5e-3, the position table's:
#: one-ulp differences of o carried through the bf16 layers)
GPT_BF16_LOSS_RTOL = 1e-4
GPT_BF16_GRAD_RTOL = 2 ** -5

#: the counter keys of K2, K3 and K4 on a GPT's path: float32 takes the
#: scalar kernels; bf16 at head dim 64 (GPT-2's) all three TMA + wgmma
GPT_F32_FLASH = ("fwd.f32", "bwd_dq.f32", "bwd_dkv.f32")
GPT_BF16_FLASH = ("fwd.wgmma", "bwd_dq.wgmma", "bwd_dkv.wgmma")

#: per kernel: (name, the Pallas body it replaces)
FLASH_KERNELS = {
    "K2": ("flash_fwd", "horovod_tpu/ops/flash_attention.py:120"),
    "K3": ("flash_bwd_dq", "horovod_tpu/ops/flash_attention.py:235"),
    "K4": ("flash_bwd_dkv", "horovod_tpu/ops/flash_attention.py:290"),
}
#: the outputs of each
FLASH_OUTPUTS = {"K2": ("o", "m", "l"), "K3": ("dq",), "K4": ("dk", "dv")}


#: the three ResNet options whose kernels are K6-K10
VARIANTS = {"norm_act": "pallas", "residual_join": "pallas",
            "conv_bn": "pallas"}
#: per kernel: (name, the Pallas body it replaces)
EW_KERNELS = {
    "K6": ("scale_bias_relu", "horovod_tpu/ops/elementwise.py:105"),
    "K6_bwd": ("scale_bias_relu_bwd", "horovod_tpu/ops/elementwise.py:159"),
    "K6'": ("relu_grad", "horovod_tpu/ops/elementwise.py:39"),
    "K7": ("residual_relu", "horovod_tpu/ops/elementwise.py:35"),
}
CONV_KERNELS = {
    "K8": ("conv3x3_bn_relu", "horovod_tpu/ops/conv_bn.py:52"),
    "K9": ("conv3x3_stats", "horovod_tpu/ops/conv_bn.py:61"),
    "K10": ("conv3x3_plain", "horovod_tpu/ops/conv_bn.py:79"),
}
#: the largest residual join of ResNet-50 at batch 128
EW_SHAPE = (128, 56, 56, 256)
#: ResNet-50's BatchNormReLU joins (K6, and its backward in training):
#: (spatial size, channels, launches a step) at batch 128 with all three
#: options: bn_init, each block's first norm, the 3 stride-2 3x3 norms
K6_PATH_SHAPES = ((112, 64, 1), (56, 64, 3), (56, 128, 1), (28, 128, 4),
                  (28, 256, 1), (14, 256, 6), (14, 512, 1), (7, 512, 3))
#: ResNet-50's residual joins (K7; K6' its backward): the 16 blocks'
#: outputs
K7_PATH_SHAPES = ((56, 256, 3), (28, 512, 4), (14, 1024, 6), (7, 2048, 3))
#: the batches K6 and K7 are checked at: the train step's, then the
#: serving buckets' largest and smallest (the backward at the first)
EW_BATCHES = (128, 32, 1)
#: K6, K6', K7 and K6's backward bit for bit (and in sums) in bf16 and
#: float32: the largest joins, a ragged row count and C = 36
EW_CHECK_SHAPES = [EW_SHAPE, (128, 112, 112, 64), (128, 7, 7, 2048),
                   (3, 5, 7, 64), (2, 5, 5, 36)]
#: ResNet-50's stride-1 3x3 convs at batch 128: (spatial size, channels,
#: launches of each a step: the 3, 3, 5 and 2 stride-1 blocks of a stage)
CONV_SHAPES = ((56, 64, 3), (28, 128, 3), (14, 256, 5), (7, 512, 2))
#: launches a ResNet-50 train step with all three options makes: K6 in
#: bn_init, each block's first norm and the 3 stride-2 3x3 norms, and
#: K6's backward (with its second pass) in the backward of each; K7 in
#: each of the 16 blocks and K6' in the backward of each; K9 and K10 in
#: the 13 stride-1 blocks' fused 3x3 (K8 runs in eval only)
VARIANT_STEP_LAUNCHES = {"scale_bias_relu": 20, "scale_bias_relu_bwd": 20,
                         "relu_grad": 16, "residual_relu": 16, "stats": 13,
                         "plain": 13}

#: K6, K6' and K7 against their plain versions: bit-equal.  The kernels
#: round where the plain versions round (built with --fmad=false), so
#: there is no summation order to differ in.
#: K8-K10 against their plain versions (the nine-tap matmuls in float32):
#: both sum the same float32 products in other orders.  float32 outputs
#: elementwise, rtol CONV_F32_RTOL plus CONV_F32_ATOL of the largest
#: output (the JAX tests' own 1e-4 against XLA's conv).  bf16 outputs row
#: by row in norm (``row_rel_err`` over Cout): a summation-order
#: difference of ~1e-6 flips the bf16 rounding of a few elements by one
#: ulp (2^-8 relative to a typical row), so the largest row error is
#: held to one ulp, 2^-7, and the mean row error to CONV_BF16_MEAN_LIMIT;
#: Sound runs read at most 4.3e-3 (largest) and 6.5e-5 (mean); planted
#: faults fail: the centre tap skipped reads 0.86 / 0.32, a truncating
#: bf16 cast (no rounding) 6.9e-3 / 3.9e-3, caught by the mean.
CONV_F32_RTOL, CONV_F32_ATOL = 1e-4, 1e-5
CONV_BF16_ROW_LIMIT = 2 ** -7
CONV_BF16_MEAN_LIMIT = 5e-4
#: K9's sums against the plain version's: |sum - plain| over the column's
#: sum of |y| and |sumsq - plain| over the plain sumsq.  The tensor cores'
#: float32 accumulation truncates in its alignment step, so each acc sits
#: a little toward zero and sumsq carries a one-sided bias that grows with
#: K = 9 Cin: sound runs read up to 1.4e-6 (Cin 64) to 8.0e-6 (Cin 512)
#: for sumsq, 2.4e-7 for sum; the limit is about 6x the worst.  A conv
#: missing a tap is off by ~0.1 or more.
CONV_SUM_RTOL = 5e-5
#: K6's backward's dscale and dbias against the plain version's: per
#: channel, |got - plain| over the channel's sum of |gm x| (dscale) or of
#: |gm| (dbias) (``ew_sum_err``).  Both add the same float32 terms in
#: other orders, so they differ by float32 rounding of partial sums:
#: sound runs read up to 1.7e-7 (every case of elementwise_kernels, bf16
#: and float32, both routes) and 3.6e-8 (every block of the sweep at the
#: path's shapes); the limit is about 6x the worst.  A second pass that
#: misses one block's row of the scratch reads 4.3e-4 at the largest
#: shape (128 x 112 x 112 x 64, 264 blocks) and up to 2.6e-2.
EW_SUM_RTOL = 1e-6


#: when the script started (time.perf_counter)
T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gives the script's seconds so
    far (``at_s``), from which each phase's time follows."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3,
            sleep: int = SLEEP_CYCLES) -> float:
    """Median device time of ``fn`` over ``runs`` calls, each between two
    CUDA events.  The card is held busy (``sleep`` cycles) while the host
    queues the events and the call, so the host's time to launch the call
    (a wrapper's checks, its ctypes arguments) is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for convolutions and matmuls while inside."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
def phase_kernels(fu, flops_mod):
    """K1 against its plain version, then timed.  Returns the per-rule
    measurements; the launches of the training paths are added later."""
    opts = {"sgd": fu.fused_sgd(0.01), "momentum": fu.fused_sgd(0.01, 0.9),
            "adam": fu.fused_adam(1e-3)}
    results = {}
    for rule, opt in opts.items():
        # each rule at the size of its main path: GPT-2 small's for adam
        n_main = PARAMS_GPT2_SMALL if rule == "adam" else PARAMS_RESNET50
        sizes = {PARAMS_RESNET50, RAGGED, n_main}
        if rule == "momentum":
            sizes.add(PARAMS_VGG16)
        max_abs = max_rel = 0.0
        for n in sorted(sizes):
            gen = torch.Generator(device="cuda").manual_seed(n)
            p = torch.randn(n, device="cuda", generator=gen)
            ours = {"p": p, "mu": torch.zeros_like(p),
                    "nu": torch.zeros_like(p)}
            plain = {k: v.clone() for k, v in ours.items()}
            for step in range(1, 4):
                g = torch.randn(n, device="cuda", generator=gen)
                s = k1_scalars(opt, step)
                fu.flat_update_(rule, ours["p"], g, ours["mu"], ours["nu"],
                                **s)
                if rule == "sgd":
                    fu.plain_sgd_(plain["p"], g, **s)
                elif rule == "momentum":
                    fu.plain_momentum_(plain["p"], g, plain["mu"], **s)
                else:
                    fu.plain_adam_(plain["p"], g, plain["mu"], plain["nu"],
                                   **s)
            torch.cuda.synchronize()
            for k in ours:
                d = (ours[k] - plain[k]).abs()
                max_abs = max(max_abs, d.max().item())
                max_rel = max(max_rel, (d / plain[k].abs().clamp_min(
                    1e-30)).max().item())
                if not torch.allclose(ours[k], plain[k], rtol=K1_RTOL,
                                      atol=K1_ATOL):
                    fail(f"K1 {rule} disagrees with its plain version at "
                         f"n={n} ({k}): max abs {d.max().item()}")

        # bf16(0.999) is 1.0, which zeroes 1 - b2 and keeps nu at 0: the
        # bf16 check of adam takes b2 = 0.99, whose moments move
        bf16_opt = fu.fused_adam(1e-3, b2=0.99) if rule == "adam" else opt
        bf16_bad, bf16_abs = _k1_bf16_mismatches(fu, rule, bf16_opt, n_main)
        if bf16_bad:
            fail(f"K1 {rule} on bf16 groups is not bit-equal to its plain "
                 f"version: {bf16_bad}")

        n = n_main
        replaces, bytes_per, flops_per = RULES[rule]
        timed = {dtype: _k1_times(fu, rule, opt, n, dtype)
                 for dtype in (torch.float32, torch.bfloat16)}
        kernel_ms, plain_ms, library_ms = timed[torch.float32]
        bytes_ms = bytes_per * n / flops_mod.hbm_bytes_per_sec() * 1e3
        ops_ms = flops_per * n / flops_mod.H100_FP32_FLOPS * 1e3
        results[rule] = {
            "name": f"fused_update_{rule}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/fused_update.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": max_abs,
            "max_rel_err": max_rel,
            "tolerance": {"rtol": K1_RTOL, "atol": K1_ATOL},
            "n": n,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "library_call": ("torch.optim.Adam(fused=True).step"
                             if rule == "adam" else
                             "torch.optim.SGD(fused=True).step"),
            # the same rule on a bf16 group of the same length: bit-equal
            # to its plain version (checked above), half the bytes;
            # launches are the rule's main path's on bf16 groups
            "bf16": {"ms": timed[torch.bfloat16][0],
                     "plain_ms": timed[torch.bfloat16][1],
                     "library_ms": timed[torch.bfloat16][2],
                     "bound_ms": bytes_ms / 2, "bound_by": "bytes",
                     "max_abs_err": bf16_abs,
                     "tolerance": "bit-equal (torch.equal)",
                     "launches": None},
        }
        if rule == "momentum":
            # VGG-16's 138.4M parameters, the registry path's largest
            ms, plain, lib = _k1_times(fu, rule, opt, PARAMS_VGG16,
                                       torch.float32)
            results[rule]["vgg16"] = {
                "n": PARAMS_VGG16, "ms": ms, "plain_ms": plain,
                "library_ms": lib, "bound_by": "bytes",
                "bound_ms": bytes_per * PARAMS_VGG16
                / flops_mod.hbm_bytes_per_sec() * 1e3, "launches": None}
    emit({"phase": "kernels", "rules": {
        r: {**{k: v[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                 "plain_ms", "library_ms", "bound_ms")},
            **{k: v[k] for k in ("bf16", "vgg16") if k in v}}
        for r, v in results.items()}})
    return results


def k1_scalars(opt, step: int, dtype=torch.float32) -> dict:
    """The scalars a train step hands K1 at ``step`` for a group of
    ``dtype``: the optimizer's, from an int32 count on the card."""
    return opt._step_scalars(
        torch.tensor(step, dtype=torch.int32, device="cuda"), dtype)


def _k1_bf16_mismatches(fu, rule, opt, n_main) -> list:
    """K1's ``rule`` on bf16 groups against its plain version over 3
    steps, at the rule's main-path length, a ragged length and one
    element off 16-byte alignment (the scalar loop): the buffers that
    differ in any bit, and the largest absolute difference."""
    bad, max_abs = [], 0.0
    for n, off in sorted({(n_main, 0), (RAGGED, 0), (4099, 1)}):
        gen = torch.Generator(device="cuda").manual_seed(n + off)
        buf = torch.randn(n + off, device="cuda", generator=gen).bfloat16()
        ours = {"p": buf[off:], "mu": torch.zeros_like(buf[off:]),
                "nu": torch.zeros_like(buf[off:])}
        plain = {k: v.clone() for k, v in ours.items()}
        for step in range(1, 4):
            g = torch.randn(n, device="cuda", generator=gen).bfloat16()
            s = k1_scalars(opt, step, torch.bfloat16)
            fu.flat_update_(rule, ours["p"], g, ours["mu"], ours["nu"], **s)
            args = {"sgd": (plain["p"], g),
                    "momentum": (plain["p"], g, plain["mu"]),
                    "adam": (plain["p"], g, plain["mu"], plain["nu"])}[rule]
            getattr(fu, f"plain_{rule}_")(*args, **s)
        torch.cuda.synchronize()
        bad += [(n, off, k) for k in ours
                if not torch.equal(ours[k], plain[k])]
        max_abs = max([max_abs] + [
            (ours[k].float() - plain[k].float()).abs().max().item()
            for k in ours])
    return bad, max_abs


def _k1_times(fu, rule, opt, n, dtype):
    """(kernel, plain, library) ms of ``rule`` over one group of ``n``
    parameters of ``dtype``; the library is torch.optim's fused step on
    a parameter of that dtype (timed only, the port never calls it)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    p = torch.randn(n, device="cuda", generator=gen).to(dtype)
    g = torch.randn(n, device="cuda", generator=gen).to(dtype)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    s = k1_scalars(opt, 1, dtype)
    plain_fn = {"sgd": lambda: fu.plain_sgd_(p, g, **s),
                "momentum": lambda: fu.plain_momentum_(p, g, mu, **s),
                "adam": lambda: fu.plain_adam_(p, g, mu, nu, **s)}[rule]
    kernel_ms = cuda_ms(lambda: fu.flat_update_(rule, p, g, mu, nu, **s))
    plain_ms = cuda_ms(plain_fn)
    w = torch.nn.Parameter(p.clone())
    w.grad = g.clone()
    lib = torch.optim.Adam([w], lr=1e-3, fused=True) if rule == "adam" \
        else torch.optim.SGD([w], lr=0.01, momentum=opt.momentum,
                             fused=True)
    return kernel_ms, plain_ms, cuda_ms(lib.step)


def _flash_inputs(b, h, sq, sk, d, dtype, seed, layout="bhsd"):
    """Seeded q, k, v, do as [b, h, s, d] tensors: contiguous ("bhsd"),
    views of [b, s, h, d] storage as the model passes them ("bshd"), or
    contiguous one element past an aligned address ("offset")."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        if layout == "bshd":
            return x.transpose(1, 2).contiguous().transpose(1, 2)
        if layout == "offset":
            buf = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)
            return buf[1:].view(shape).copy_(x)
        return x

    return rnd(b, h, sq, d), rnd(b, h, sk, d), rnd(b, h, sk, d), \
        rnd(b, h, sq, d)


def _causal_pairs(sq, sk, q_off, kv_off, causal) -> int:
    """(query, key) pairs the mask leaves visible, per (batch, head)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, q_off + i - kv_off + 1)) for i in range(sq))


def row_rel_err(got, want) -> Tuple[float, float]:
    """The largest and the mean ||got - want|| / (||want|| +
    FLASH_ROW_FLOOR * the mean row norm) over the rows of the last dim."""
    got, want = got.float(), want.float()
    dn, wn = (got - want).norm(dim=-1), want.norm(dim=-1)
    err = dn / (wn + FLASH_ROW_FLOOR * wn.mean()).clamp_min(1e-30)
    return err.max().item(), err.mean().item()


def _on_card(what: str, fn):
    """fn() synchronized with the card: a kernel that faults fails the
    phase, naming the kernel and the case, instead of surfacing at a
    later call."""
    try:
        out = fn()
        torch.cuda.synchronize()
    except RuntimeError as err:
        fail(f"{what} failed on the card: {err}")
    return out


def _flash_case(kernels, fa, q, k, v, do, *, causal, q_off, kv_off,
                normalize):
    """K2, K3 and K4 against their plain versions on the same inputs, the
    plain forward at the kv tile of K2's plan; K3 and K4 take lse and
    delta from the plain normalized forward.  Per output, the max abs
    error and, in bf16, the row error held to FLASH_BF16_ROW_LIMIT; and
    the pairs (kernel's, plain version's) by output name."""
    kw = dict(causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
              q_offset=q_off, kv_offset=kv_off)
    kv_tile = kernels.flash_plan_for("fwd", q, k, v).kv_tile
    case = (f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
            f"causal={causal} offsets=({q_off},{kv_off})")
    got = _on_card(f"flash_kernels: K2 at {case}",
                   lambda: fa._mha_fwd(q, k, v, normalize=normalize, **kw))
    want = fa.plain_mha_fwd(q, k, v, normalize=normalize, kv_tile=kv_tile,
                            **kw)
    pairs = dict(zip(("o", "m", "l"), zip(got, want)))
    o, m, l = want if normalize else fa.plain_mha_fwd(
        q, k, v, kv_tile=kv_tile, **kw)
    lse = m + torch.log(l.clamp_min(1e-30))
    delta = (do.float() * o.float()).sum(-1, keepdim=True).contiguous()
    pairs["dq"] = (_on_card(f"flash_kernels: K3 at {case}",
                            lambda: fa._mha_bwd_dq(q, k, v, do, lse, delta,
                                                   **kw)),
                   fa.plain_mha_bwd_dq(q, k, v, do, lse, delta, **kw))
    dkv = _on_card(f"flash_kernels: K4 at {case}",
                   lambda: fa._mha_bwd_dkv(q, k, v, do, lse, delta, **kw))
    for name, g, w in zip(("dk", "dv"), dkv,
                          fa.plain_mha_bwd_dkv(q, k, v, do, lse, delta,
                                               **kw)):
        pairs[name] = (g, w)
    torch.cuda.synchronize()
    errs, row_errs = {}, {}
    for name, (g, w) in pairs.items():
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            fail(f"flash_kernels: non-finite {name} {tuple(q.shape)}")
        errs[name] = (g - w).abs().max().item()
        if q.dtype == torch.bfloat16:
            row_errs[name] = row_rel_err(g, w)
            ok = row_errs[name][0] <= FLASH_BF16_ROW_LIMIT[name] and \
                row_errs[name][1] <= FLASH_BF16_MEAN_LIMIT
        else:
            rtol, atol = FLASH_TOL[q.dtype]
            ok = torch.allclose(g, w, rtol=rtol, atol=atol)
        if not ok:
            fail(f"flash_kernels: {name} disagrees with its plain version "
                 f"at {case}: max abs "
                 f"{errs[name]}, row error (max, mean) {row_errs.get(name)} "
                 f"(limits {FLASH_BF16_ROW_LIMIT.get(name)}, "
                 f"{FLASH_BF16_MEAN_LIMIT})")
    return errs, row_errs, pairs


def _flash_loops(dtype, d, layout) -> dict:
    """The mainloop each of K2, K3 and K4 must run on for a case: the
    rule of kernels.flash_plan, written out here so that a wrong plan
    fails the phase."""
    if dtype == torch.float32:
        return {"fwd": "f32", "bwd_dq": "f32", "bwd_dkv": "f32"}
    wg = "wgmma" if d == 64 and layout != "offset" else "mma_sync"
    return {"fwd": wg, "bwd_dq": wg, "bwd_dkv": wg}


def phase_flash_kernels(kernels, fa, flops_mod):
    """K2, K3 and K4 against their plain versions on the card: (a) the main
    path's shape in bf16, (b) float32 and bf16 at ragged lengths and every
    head dim, (c) unnormalized at nonzero offsets, with a kv shard wholly
    in the future of every row, (d) operands off 16-byte alignment, (e)
    BERT-base's shape, non-causal; each launch on the mainloop
    _flash_loops names.  Then each kernel timed at shapes (a) and (e) on
    both bf16 mainloops."""
    b, h, s, d = GPT_ATTN_SHAPE
    # (tag, (b, h, sq, sk, d), dtype, causal, q_off, kv_off, normalize,
    # layout); bfloat16 runs the tensor-core kernels, float32 the scalar
    bb_, hb, sb_, db = BERT_ATTN_SHAPE
    cases = [("a", (b, h, s, s, d), torch.bfloat16, True, 0, 0, True,
              "bshd"),
             ("e", (bb_, hb, sb_, sb_, db), torch.bfloat16, False, 0, 0,
              True, "bshd")]
    for dtype in (torch.float32, torch.bfloat16):
        for sq, sk in ((136, 136), (192, 192), (136, 192)):
            for causal in (True, False):
                cases.append(("b", (2, 3, sq, sk, 64), dtype, causal, 0, 0,
                              True, "bhsd"))
        for hd in (16, 32, 128):
            cases.append(("b", (1, 2, 136, 136, hd), dtype, True, 0, 0,
                          True, "bhsd"))
        for q_off, kv_off in ((128, 64), (64, 200), (0, 136)):
            cases.append(("c", (2, 3, 136, 72, 64), dtype, True, q_off,
                          kv_off, False, "bhsd"))
        cases.append(("d", (2, 3, 136, 136, 64), dtype, True, 0, 0, True,
                      "offset"))
    cases.append(("c", (1, 2, 200, 136, 64), torch.bfloat16, True, 300, 0,
                  False, "bhsd"))
    per_kernel = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    worst_row = {name: 0.0 for name in FLASH_BF16_ROW_LIMIT}
    worst_mean = dict(worst_row)
    rows = []
    before = dict(kernels.flash_launches)
    for i, (tag, (bb, hh, sq, sk, dd), dtype, causal, q_off, kv_off,
            normalize, layout) in enumerate(cases):
        q, k, v, do = _flash_inputs(bb, hh, sq, sk, dd, dtype, 100 + i,
                                    layout)
        counted = dict(kernels.flash_launches)
        errs, row_errs, pairs = _flash_case(kernels, fa, q, k, v, do,
                                            causal=causal, q_off=q_off,
                                            kv_off=kv_off,
                                            normalize=normalize)
        took = {key: n - counted[key] for key, n in
                kernels.flash_launches.items() if n != counted[key]}
        loops = _flash_loops(dtype, dd, layout)
        if took != {f"{kind}.{loop}": 1 for kind, loop in loops.items()}:
            fail(f"flash_kernels: case {tag} {(bb, hh, sq, sk, dd)} {dtype} "
                 f"{layout} ran {took}, want {loops}")
        if causal and q_off + sq - 1 < kv_off:
            # every key is in the future of every row: l and dq must be
            # exactly 0 and o finite (tests/test_flash_attention.py:88-99)
            if pairs["l"][0].abs().max().item() != 0.0:
                fail("flash_kernels: a fully masked shard gave l != 0")
            if pairs["dq"][0].abs().max().item() != 0.0:
                fail("flash_kernels: a fully masked shard gave dq != 0")
        for name, err in errs.items():
            key = {"o": "K2", "m": "K2", "l": "K2", "dq": "K3"}.get(name,
                                                                   "K4")
            per_kernel[key] = max(per_kernel[key], err)
        for name, (top, mean) in row_errs.items():
            worst_row[name] = max(worst_row[name], top)
            worst_mean[name] = max(worst_mean[name], mean)
        rows.append({"case": tag, "shape_bhqkd": [bb, hh, sq, sk, dd],
                     "dtype": str(dtype).rsplit(".", 1)[-1],
                     "layout": layout, "causal": causal,
                     "offsets": [q_off, kv_off], "normalize": normalize,
                     "mainloops": loops,
                     "max_abs_err": errs, "row_rel_err": row_errs})
    by_loop = {key: n - before[key]
               for key, n in kernels.flash_launches.items()}

    results = {}
    for key, timing in _flash_timing(kernels, fa, flops_mod, GPT_ATTN_SHAPE,
                                     True).items():
        name, replaces = FLASH_KERNELS[key]
        results[key] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": per_kernel[key],
            "max_bf16_row_rel_err": {n: worst_row[n]
                                     for n in FLASH_OUTPUTS[key]},
            "max_bf16_mean_row_rel_err": {n: worst_mean[n]
                                          for n in FLASH_OUTPUTS[key]},
            "tolerance": {
                "float32": dict(zip(("rtol", "atol"),
                                    FLASH_TOL[torch.float32])),
                "bfloat16_row": {n: FLASH_BF16_ROW_LIMIT[n]
                                 for n in FLASH_OUTPUTS[key]},
                "bfloat16_mean_row": FLASH_BF16_MEAN_LIMIT,
                "bfloat16_row_floor": FLASH_ROW_FLOOR},
            **timing}
    # BERT-base's attention (--attn pallas), non-causal, timed apart
    for key, timing in _flash_timing(kernels, fa, flops_mod, BERT_ATTN_SHAPE,
                                     False).items():
        results[key]["bert"] = timing
    timed = ("mainloop", "ms", "old_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    emit({"phase": "flash_kernels", "cases": rows,
          "launches_by_mainloop": by_loop,
          "max_bf16_row_rel_err": worst_row,
          "max_bf16_mean_row_rel_err": worst_mean,
          "timing": {k: {f: v[f] for f in timed} for k, v in results.items()},
          "timing_bert": {k: {f: v["bert"][f] for f in timed}
                          for k, v in results.items()}})
    return results


def _flash_timing(kernels, fa, flops_mod, shape, causal: bool) -> dict:
    """K2, K3 and K4 timed at ``shape`` (b, h, s, d) in bf16 and the
    model's [b, s, h, d] layout, on the mainloop of their plan and on
    mma.sync, beside their plain versions, their bounds and
    ``F.scaled_dot_product_attention``'s forward (for K2) and backward
    (K3 and K4's work together), timed only."""
    import torch.nn.functional as F

    b, h, s, d = shape
    q, k, v, do = _flash_inputs(b, h, s, s, d, torch.bfloat16, 7, "bshd")
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d), q_offset=0,
              kv_offset=0)
    plans = {key: kernels.flash_plan_for(kind, q, k, v, do)
             for key, kind in (("K2", "fwd"), ("K3", "bwd_dq"),
                               ("K4", "bwd_dkv"))}
    kv_tile = plans["K2"].kv_tile
    o, m, l = fa.plain_mha_fwd(q, k, v, kv_tile=kv_tile, **kw)
    lse = m + torch.log(l.clamp_min(1e-30))
    delta = (do.float() * o.float()).sum(-1, keepdim=True).contiguous()
    bwd = (q, k, v, do, lse, delta)
    timed = {  # key: (kernel, the mma.sync mainloop, plain)
        "K2": (lambda: fa._mha_fwd(q, k, v, **kw),
               lambda: kernels.launch_flash_fwd(q, k, v, **kw,
                                                mainloop="mma_sync"),
               lambda: fa.plain_mha_fwd(q, k, v, kv_tile=kv_tile, **kw)),
        "K3": (lambda: fa._mha_bwd_dq(*bwd, **kw),
               lambda: kernels.launch_flash_bwd_dq(*bwd, **kw,
                                                   mainloop="mma_sync"),
               lambda: fa.plain_mha_bwd_dq(*bwd, **kw)),
        "K4": (lambda: fa._mha_bwd_dkv(*bwd, **kw),
               lambda: kernels.launch_flash_bwd_dkv(*bwd, **kw,
                                                    mainloop="mma_sync"),
               lambda: fa.plain_mha_bwd_dkv(*bwd, **kw)),
    }
    # the library's fused attention, timed beside the kernels only
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    library = {
        "K2": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)),
        "K3+K4": cuda_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do, retain_graph=True)),
    }
    pairs = b * h * _causal_pairs(s, s, 0, 0, causal)
    elems = b * h * s * d
    rows_f32 = b * h * s * 4
    # (flops, bytes): each input read once, each output written once
    work = {"K2": (4 * d * pairs, 4 * elems * 2 + 2 * rows_f32),
            "K3": (6 * d * pairs, 4 * elems * 2 + 2 * rows_f32 + elems * 4),
            "K4": (8 * d * pairs, 4 * elems * 2 + 2 * rows_f32
                   + 2 * elems * 4)}
    sdpa = f"F.scaled_dot_product_attention(is_causal={causal})"
    results = {}
    for key, (kernel_fn, old_fn, plain_fn) in timed.items():
        flops, nbytes = work[key]
        bound_ms, bound_by = _bound(flops_mod, flops, nbytes,
                                    flops_mod.H100_PEAK_FLOPS)
        results[key] = {
            "mainloop": plans[key].mainloop,
            "tiles_q_kv": [plans[key].q_tile, plans[key].kv_tile],
            "shape_bhsd": [b, h, s, d], "dtype": "bfloat16",
            "causal": causal, "flops": flops, "bytes": nbytes,
            "ms": cuda_ms(kernel_fn),
            "old_ms": cuda_ms(old_fn), "old_mainloop": "mma_sync",
            "plain_ms": cuda_ms(plain_fn),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library["K2"] if key == "K2"
            else library["K3+K4"],
            "library_call": (
                f"{sdpa} forward" if key == "K2" else
                f"backward of {sdpa}, dq, dk and dv together (K3+K4's "
                "work)"),
        }
    return results


# ---------------------------------------------------------------------------
# K6, K6', K7 and K8-K10: the ResNet kernel variants
# ---------------------------------------------------------------------------
def _bound(flops_mod, flops: float, nbytes: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over ``peak``."""
    bytes_ms = nbytes / flops_mod.hbm_bytes_per_sec() * 1e3
    ops_ms = flops / peak * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def _seeded(shape, dtype, seed, scale=1.0, offset=False):
    """Seeded normal values on the card; ``offset``: contiguous one
    element past an aligned address (the kernels' scalar paths)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, device="cuda", generator=gen) * scale).to(dtype)
    if not offset:
        return x
    buf = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)
    return buf[1:].view(shape).copy_(x)


def k6_old_tail(ew, x, scale, out, g):
    """K6's backward as the port ran it before its kernel, from the public
    pieces: K6' (on the card), then six torch ops (the float32 cast, dx's
    product and cast, dscale's cast, product and sum, dbias's sum)."""
    gm32 = ew._relu_grad(out, g).float()
    axes = tuple(range(x.dim() - 1))
    return ((gm32 * scale).to(x.dtype), (gm32 * x.float()).sum(dim=axes),
            gm32.sum(dim=axes))


def ew_sum_err(got, want, terms) -> float:
    """K6's backward's sum ``got`` against ``want`` (``[C]``): the largest
    over channels of |got - want| over the channel's sum of |terms|
    (``[rows, C]``), in float64."""
    den = terms.abs().double().sum(0).clamp_min(1e-30)
    return ((got.double() - want.double()).abs() / den).max().item()


def _k6_bwd_err(ew, x, out, g, sums, want) -> float:
    """The larger of dscale's and dbias's ew_sum_err."""
    c = x.shape[-1]
    gm = ew.plain_relu_grad(out, g).float().reshape(-1, c)
    return max(ew_sum_err(sums[0], want[0], gm * x.float().reshape(-1, c)),
               ew_sum_err(sums[1], want[1], gm))


def _k6_bwd_check(ew, x, scale, out, g, what: str) -> float:
    """K6's backward against its plain version on the same inputs: dx bit
    for bit, dscale and dbias within EW_SUM_RTOL (ew_sum_err), and a second
    call bit-identical to the first.  Returns the sums' error."""
    dx, ds, db = ew._scale_bias_relu_bwd(x, scale, out, g)
    again = ew._scale_bias_relu_bwd(x, scale, out, g)
    pdx, pds, pdb = ew.plain_scale_bias_relu_bwd(x, scale, out, g)
    torch.cuda.synchronize()
    err = _k6_bwd_err(ew, x, out, g, (ds, db), (pds, pdb))
    same = all(same_bits(a, b) for a, b in zip((dx, ds, db), again))
    if not torch.equal(dx, pdx) or not err <= EW_SUM_RTOL or not same:
        fail(f"elementwise_kernels: K6's backward at {what}: dx bit-equal "
             f"{torch.equal(dx, pdx)}, sum error {err} (limit "
             f"{EW_SUM_RTOL}), two calls bit-identical {same}")
    return err


def _k6_bwd_dropped_row(kernels, ew, x, scale, out, g) -> float:
    """The planted fault: K6's backward whose second pass misses one row
    of the [2, G, C] scratch.  Block 0 of the plan's channel loop takes
    rounds 0, G, 2G, ... of ``EW_BWD_THREADS x EW_BWD_PACKS`` packs,
    whole rows of x; with g zeroed on those rows the kernel's own sums
    lack exactly block 0's row.  Returns their error against the plain sums of the whole g."""
    c = x.shape[-1]
    plan = kernels.elementwise_plan(
        "scale_bias_relu_bwd", x.dtype, tuple(x.shape), (0,),
        kernels.card_sms(x.device.index))
    if plan.loop != "channel":
        fail(f"elementwise_kernels: K6's backward plan {plan} at "
             f"{list(x.shape)} is not the channel loop")
    rows_a_round = kernels.EW_BWD_THREADS * kernels.EW_BWD_PACKS * \
        (16 // x.element_size()) // c
    rows = torch.arange(x.numel() // c, device=x.device)
    dropped = g.reshape(-1, c).clone()
    dropped[(rows // rows_a_round) % plan.blocks == 0] = 0
    _, ds, db = ew._scale_bias_relu_bwd(x, scale, out,
                                        dropped.view(g.shape))
    _, pds, pdb = ew.plain_scale_bias_relu_bwd(x, scale, out, g)
    return _k6_bwd_err(ew, x, out, g, (ds, db), (pds, pdb))


def _ew_check(kernels, ew, x, y, g, scale, bias, what: str,
              backward: bool = True) -> float:
    """K7, K6' and K6 on the loops their plans give and on flat_binary,
    bit for bit against their plain versions, and (``backward``) K6's
    backward (_k6_bwd_check).  Returns the backward's sum error."""
    out = ew._residual_relu(x, y)
    k6 = ew.plain_scale_bias_relu(x, scale, bias)
    pairs = {
        "K7": (out, ew.plain_residual_relu(x, y)),
        "K7 flat_binary": (kernels.launch_residual_relu(
            x, y, loop="flat_binary"), ew.plain_residual_relu(x, y)),
        "K6'": (ew._relu_grad(out, g), ew.plain_relu_grad(out, g)),
        "K6' flat_binary": (kernels.launch_relu_grad(
            out, g, loop="flat_binary"), ew.plain_relu_grad(out, g)),
        "K6": (ew._scale_bias_relu(x, scale, bias), k6),
        "K6 flat_binary": (kernels.launch_scale_bias_relu(
            x, scale, bias, loop="flat_binary"), k6),
    }
    torch.cuda.synchronize()
    for key, (got, want) in pairs.items():
        if got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"elementwise_kernels: {key} differs from its plain "
                 f"version at {what}: max abs "
                 f"{(got.float() - want.float()).abs().max()}")
    return _k6_bwd_check(ew, x, scale, k6, g, what) if backward else 0.0


def _ew_inputs(shape, dtype, seed, offset=False):
    """x (``offset``: off 16-byte alignment), y, g, scale and bias."""
    c = shape[-1]
    return (_seeded(shape, dtype, seed, offset=offset),
            _seeded(shape, dtype, seed + 1000),
            _seeded(shape, dtype, seed + 2000),
            _seeded((c,), torch.float32, seed + 3000).abs() + 0.5,
            _seeded((c,), torch.float32, seed + 4000))


def phase_elementwise_kernels(kernels, ew, flops_mod):
    """K6, K6', K7 and K6's backward against their plain versions on
    seeded inputs, K6 and K7 on their plans' loops and on flat_binary:
    bit for bit in bf16 and float32 at ResNet-50's join shapes, a ragged
    row count, C = 36, an operand off 16-byte alignment and the expanded
    (stride-0) gradient that the last block's mean hands back; in bf16 at
    K6's eight path shapes (its backward too, with a planted fault) and
    K7's four, each at batch 128 and at the serving buckets' 1 and 32.
    The backward's dx bit for bit, its sums within EW_SUM_RTOL, two calls
    bit-identical.  Then each kernel timed at its path shapes beside its
    old loop (K6's backward: beside the tail it replaced), its plain
    version and its bound, and the sums of launches x ms a step."""
    before = dict(kernels.elementwise_launches)
    cases = []
    worst = 0.0
    seed = 500
    for dtype in (torch.bfloat16, torch.float32):
        for shape in EW_CHECK_SHAPES + [("offset", (2, 5, 7, 64))]:
            offset = shape[0] == "offset"
            shape = shape[1] if offset else shape
            seed += 1
            worst = max(worst, _ew_check(
                kernels, ew, *_ew_inputs(shape, dtype, seed, offset),
                f"{shape} {dtype} offset={offset}"))
            cases.append({"shape": list(shape), "offset": offset,
                          "dtype": str(dtype).rsplit(".", 1)[-1]})
        # the expanded gradient of x.mean((1, 2)), through both Functions
        b, h, w, c = 4, 7, 7, 64
        x = _seeded((b, h, w, c), dtype, 90).requires_grad_()
        y = _seeded((b, h, w, c), dtype, 91).requires_grad_()
        scale = (_seeded((c,), torch.float32, 92).abs() + 0.5) \
            .requires_grad_()
        bias = _seeded((c,), torch.float32, 93).requires_grad_()
        gm = _seeded((b, 1, 1, c), dtype, 94).expand(b, h, w, c)
        out = ew.residual_relu(x, y)
        out.backward(gm)
        want = ew.plain_relu_grad(out.detach(), gm)
        ok = torch.equal(x.grad, want) and torch.equal(y.grad, want)
        x.grad = None
        out = ew.scale_bias_relu(x, scale, bias)
        out.backward(gm)
        pdx, pds, pdb = ew.plain_scale_bias_relu_bwd(
            x.detach(), scale.detach(), out.detach(), gm)
        err = _k6_bwd_err(ew, x.detach(), out.detach(), gm,
                          (scale.grad, bias.grad), (pds, pdb))
        worst = max(worst, err)
        if not (ok and torch.equal(x.grad, pdx) and err <= EW_SUM_RTOL):
            fail(f"elementwise_kernels: the expanded gradient ({dtype}) "
                 f"differs from the plain versions (sum error {err})")
        cases.append({"shape": [b, h, w, c], "expanded_gradient": True,
                      "dtype": str(dtype).rsplit(".", 1)[-1]})

    # bf16 at the path's shapes and the serving buckets'
    sms = kernels.card_sms(torch.cuda.current_device())
    faults = {}
    for batch in EW_BATCHES:
        for (s, c, _), (s7, c7, _) in itertools.zip_longest(
                K6_PATH_SHAPES, K7_PATH_SHAPES, fillvalue=(None,) * 3):
            seed += 1
            shape = (batch, s, s, c)
            x, y, g, scale, bias = _ew_inputs(shape, torch.bfloat16, seed)
            for kind in ("scale_bias_relu", "scale_bias_relu_bwd"):
                plan = kernels.elementwise_plan(kind, torch.bfloat16, shape,
                                                (0,), sms)
                if plan.loop != "channel":
                    fail(f"elementwise_kernels: {kind} at {list(shape)} "
                         f"planned {plan}, not the channel loop")
            worst = max(worst, _ew_check(kernels, ew, x, y, g, scale, bias,
                                         f"{list(shape)} bf16",
                                         backward=batch == EW_BATCHES[0]))
            if batch == EW_BATCHES[0]:
                out = ew.plain_scale_bias_relu(x, scale, bias)
                faults["x".join(map(str, shape))] = _k6_bwd_dropped_row(
                    kernels, ew, x, scale, out, g)
            cases.append({"shape": list(shape), "dtype": "bfloat16",
                          "path": "K6"})
            if s7 is not None:
                shape = (batch, s7, s7, c7)
                x, y, g, scale, bias = _ew_inputs(shape, torch.bfloat16,
                                                  seed + 50)
                _ew_check(kernels, ew, x, y, g, scale, bias,
                          f"{list(shape)} bf16", backward=False)
                cases.append({"shape": list(shape), "dtype": "bfloat16",
                              "path": "K7"})
    if not min(faults.values()) > EW_SUM_RTOL:
        fail(f"elementwise_kernels: K6's backward with a scratch row "
             f"dropped reads {faults}, not over {EW_SUM_RTOL}")
    launched = {k: kernels.elementwise_launches[k] - before[k]
                for k in before}
    if not all(launched.values()):
        fail(f"elementwise_kernels: launches {launched}")

    # timing at the path's shapes, bf16, batch 128
    peak = flops_mod.H100_FP32_FLOPS

    def entry(kernel_fn, plain_fn, flops, nbytes, **extra):
        bound_ms, bound_by = _bound(flops_mod, flops, nbytes, peak)
        return {"ms": cuda_ms(kernel_fn), "plain_ms": cuda_ms(plain_fn),
                "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
                "bytes": nbytes, **extra}

    timing = {"K6": {}, "K6_bwd": {}, "K7": {}}
    for s, c, k in K6_PATH_SHAPES:
        shape = (EW_BATCHES[0], s, s, c)
        n = math.prod(shape)
        x, _, g, scale, bias = _ew_inputs(shape, torch.bfloat16, s + c)
        out = ew._scale_bias_relu(x, scale, bias)
        key = f"{s}x{s}x{c}"
        timing["K6"][key] = entry(
            lambda: ew._scale_bias_relu(x, scale, bias),
            lambda: ew.plain_scale_bias_relu(x, scale, bias), 3 * n,
            2 * 2 * n + 2 * 4 * c, launches_a_step=k,
            old_ms=cuda_ms(lambda: kernels.launch_scale_bias_relu(
                x, scale, bias, loop="flat_binary")),
            plan=list(kernels.elementwise_plan(
                "scale_bias_relu", x.dtype, shape, (0,), sms)))
        got = ew._scale_bias_relu_bwd(x, scale, out, g)[1:]
        want = ew.plain_scale_bias_relu_bwd(x, scale, out, g)[1:]
        timing["K6_bwd"][key] = entry(
            lambda: ew._scale_bias_relu_bwd(x, scale, out, g),
            lambda: ew.plain_scale_bias_relu_bwd(x, scale, out, g), 5 * n,
            4 * 2 * n + 3 * 4 * c, launches_a_step=k,
            old_ms=cuda_ms(lambda: k6_old_tail(ew, x, scale, out, g)),
            max_abs_err=max((a - b).abs().max().item()
                            for a, b in zip(got, want)),
            sum_err=_k6_bwd_err(ew, x, out, g, got, want),
            plan=list(kernels.elementwise_plan(
                "scale_bias_relu_bwd", x.dtype, shape, (0,), sms)))
    for s, c, k in K7_PATH_SHAPES:
        shape = (EW_BATCHES[0], s, s, c)
        n = math.prod(shape)
        x, y, _, _, _ = _ew_inputs(shape, torch.bfloat16, s + c)
        timing["K7"][f"{s}x{s}x{c}"] = entry(
            lambda: ew._residual_relu(x, y),
            lambda: ew.plain_residual_relu(x, y), 2 * n, 3 * 2 * n,
            launches_a_step=k,
            old_ms=cuda_ms(lambda: kernels.launch_residual_relu(
                x, y, loop="flat_binary")),
            plan=list(kernels.elementwise_plan(
                "residual_relu", x.dtype, shape, (0,), sms)))
    step = {key: {f: sum(e[f] * e["launches_a_step"] for e in t.values())
                  for f in ("ms", "old_ms", "bound_ms")}
            for key, t in timing.items()}
    # K6' (K7's backward) at K7's largest shape, beside
    # aten.threshold_backward and its flat_binary loop
    s, c, _ = K7_PATH_SHAPES[0]
    shape = (EW_BATCHES[0], s, s, c)
    n = math.prod(shape)
    x, y, g, _, _ = _ew_inputs(shape, torch.bfloat16, 1)
    out = ew._residual_relu(x, y)
    timing["K6'"] = {f"{s}x{s}x{c}": entry(
        lambda: ew._relu_grad(out, g), lambda: ew.plain_relu_grad(out, g),
        n, 3 * 2 * n, old_ms=cuda_ms(lambda: kernels.launch_relu_grad(
            out, g, loop="flat_binary")),
        library_ms=cuda_ms(lambda: torch.ops.aten.threshold_backward(
            g, out, 0.0)))}

    # the kernels line's entries: K6 and its backward at their largest
    # shape, K6' and K7 at K7's
    k6_head, k7_head = next(iter(timing["K6"])), next(iter(timing["K6'"]))
    heads = {"K6": k6_head, "K6_bwd": k6_head, "K6'": k7_head,
             "K7": k7_head}
    loops = {
        "K6": "channel: a thread's packs at one channel offset, its scale "
              "and bias in registers (flat_binary for other C)",
        "K6_bwd": "channel: one pass over x, out and g into [2, G, C] "
                  "block sums, then a second pass in a fixed order",
        "K6'": "stream: 2 packs of 16 B a thread loaded before use, a "
               "block for each round",
        "K7": "stream: as K6', at 128 threads"}
    results = {}
    for key, head in heads.items():
        name, replaces = EW_KERNELS[key]
        e = timing[key][head]
        results[key] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/elementwise.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": e.get("max_abs_err", 0.0),
            "tolerance": ({"dx": "bit-equal (torch.equal)",
                           "sums": f"EW_SUM_RTOL {EW_SUM_RTOL} of each "
                                   "channel's sum of |terms|"}
                          if key == "K6_bwd" else "bit-equal (torch.equal)"),
            "shape": [EW_BATCHES[0], *map(int, head.split("x"))],
            "dtype": "bfloat16",
            **{f: e[f] for f in ("ms", "old_ms", "plain_ms", "bound_ms",
                                 "bound_by", "flops", "bytes")},
            "library_ms": e.get("library_ms"),
            "library_call": "torch.ops.aten.threshold_backward(g, out, 0)"
            if key == "K6'" else None,
            "loop": loops[key], "by_shape": timing[key],
            **({"step": step[key]} if key in step else {}),
        }
    results["K6_bwd"]["old"] = "K6' then six torch ops (k6_old_tail)"
    emit({"phase": "elementwise_kernels", "cases": len(cases),
          "launches": launched, "sum_error_max": worst,
          "sum_error_limit": EW_SUM_RTOL, "dropped_row_errors": faults,
          "timing": {k: {sh: {f: v[f] for f in ("ms", "old_ms", "plain_ms",
                                                "bound_ms", "library_ms",
                                                "sum_err")
                              if f in v} for sh, v in t.items()}
                     for k, t in timing.items()},
          "step": step})
    return results


def _conv_case(cb, x, w, scale, bias, mainloop=None):
    """K8, K9 and K10 against their plain versions on the same inputs:
    per output, the max abs error and, in bf16, the row error; K9's sums
    relative to the column's sum of |acc| (sum) and sum of acc^2
    (sumsq).  ``mainloop="mma_sync"`` runs bf16 on that mainloop instead
    of the plan's."""
    if mainloop is None:
        got = {"K8": cb.conv3x3_bn_relu(x, w, scale, bias),
               "K9": cb.conv3x3_stats(x, w), "K10": cb.conv3x3_plain(x, w)}
    else:
        from horovod_tpu_torch import kernels

        got = {"K8": kernels.launch_conv3x3("bn_relu", x, w, scale, bias,
                                            mainloop=mainloop),
               "K9": kernels.launch_conv3x3("stats", x, w,
                                            mainloop=mainloop),
               "K10": kernels.launch_conv3x3("plain", x, w,
                                             mainloop=mainloop)}
    want = {"K8": cb.plain_conv3x3_bn_relu(x, w, scale, bias),
            "K9": cb.plain_conv3x3_stats(x, w),
            "K10": cb.plain_conv3x3_plain(x, w)}
    torch.cuda.synchronize()
    errs, row_errs, sum_errs = {}, {}, {}
    for key in got:
        g = got[key][0] if key == "K9" else got[key]
        p = want[key][0] if key == "K9" else want[key]
        g, p = g.float(), p.float()
        if not torch.isfinite(g).all():
            fail(f"conv_kernels: non-finite {key} at {tuple(x.shape)}")
        errs[key] = (g - p).abs().max().item()
        if x.dtype == torch.bfloat16:
            row_errs[key] = row_rel_err(g, p)
            ok = row_errs[key][0] <= CONV_BF16_ROW_LIMIT and \
                row_errs[key][1] <= CONV_BF16_MEAN_LIMIT
        else:
            ok = torch.allclose(g, p, rtol=CONV_F32_RTOL,
                                atol=CONV_F32_ATOL * p.abs().max().item())
        if not ok:
            fail(f"conv_kernels: {key} disagrees with its plain version at "
                 f"x {tuple(x.shape)} w {tuple(w.shape)} {x.dtype}: max abs "
                 f"{errs[key]}, row error (max, mean) {row_errs.get(key)}")
    y_abs = want["K9"][0].float().abs().sum(dim=(0, 1, 2))
    for i, (name, norm) in enumerate((("sum", y_abs),
                                      ("sumsq", want["K9"][2]))):
        rel = ((got["K9"][i + 1] - want["K9"][i + 1]).abs()
               / norm.clamp_min(1e-30)).max().item()
        sum_errs[name] = rel
        if not rel <= CONV_SUM_RTOL:
            fail(f"conv_kernels: K9 {name} off its plain version by {rel} "
                 f"at x {tuple(x.shape)} {x.dtype}")
    return errs, row_errs, sum_errs


def phase_conv_kernels(kernels, cb, flops_mod):
    """K8, K9 and K10 against their plain versions: ResNet-50's four
    stride-1 3x3 shapes in bf16 on the mainloop the plan names (TMA +
    wgmma, checked by its counts) and on mma.sync, and in float32; then
    small float32, rectangular, odd-H/W, C = 24, 3-channel and misaligned
    cases (the last two take mma.sync).  Then each kernel timed at the
    four shapes on both bf16 mainloops, beside its plain version, its
    bound and the library's conv (``F.conv2d`` on channels-last bf16: the
    conv alone)."""
    import torch.nn.functional as F

    before = dict(kernels.conv_bn_launches)
    # (x shape, cout, dtype, offset, mainloop forced, mainloop expected)
    resnet = [((128, s, s, c), c) for s, c, _ in CONV_SHAPES]
    cases = [(shape, c, torch.bfloat16, False, None, "wgmma")
             for shape, c in resnet]
    cases += [(shape, c, torch.bfloat16, False, "mma_sync", "mma_sync")
              for shape, c in resnet]
    cases += [(shape, c, torch.float32, False, None, "f32")
              for shape, c in resnet]
    cases += [((2, 16, 16, 64), 64, torch.float32, False, None, "f32"),
              ((3, 8, 8, 8), 24, torch.float32, False, None, "f32"),
              ((3, 8, 8, 8), 24, torch.bfloat16, False, None, "wgmma"),
              ((2, 9, 7, 24), 24, torch.float32, False, None, "f32"),
              ((2, 9, 7, 24), 24, torch.bfloat16, False, None, "wgmma"),
              ((2, 6, 10, 24), 40, torch.bfloat16, False, None, "wgmma"),
              ((2, 5, 7, 3), 16, torch.bfloat16, False, None, "mma_sync"),
              ((2, 5, 7, 16), 16, torch.bfloat16, True, None, "mma_sync")]
    rows, worst = [], {"K8": 0.0, "K9": 0.0, "K10": 0.0}
    worst_row = {"K8": [0.0, 0.0], "K9": [0.0, 0.0], "K10": [0.0, 0.0]}
    worst_sum = {"sum": 0.0, "sumsq": 0.0}
    for i, (shape, cout, dtype, offset, forced, loop) in enumerate(cases):
        cin = shape[3]
        x = _seeded(shape, dtype, 700 + i, offset=offset)
        w = _seeded((3, 3, cin, cout), dtype, 800 + i,
                    scale=(9 * cin) ** -0.5, offset=offset)
        scale = torch.rand(cout, device="cuda") + 0.5
        bias = torch.randn(cout, device="cuda") * 0.1
        counted = dict(kernels.conv_bn_launches)
        errs, row_errs, sum_errs = _conv_case(cb, x, w, scale, bias, forced)
        took = {k: v - counted[k] for k, v in
                kernels.conv_bn_launches.items() if v != counted[k]}
        if took != {f"{e}.{loop}": 1 for e in ("bn_relu", "stats", "plain")}:
            fail(f"conv_kernels: x {shape} -> {cout} {dtype} ran {took}, "
                 f"want the {loop} mainloop")
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
        for k, (top, mean) in row_errs.items():
            worst_row[k] = [max(worst_row[k][0], top),
                            max(worst_row[k][1], mean)]
        for k, v in sum_errs.items():
            worst_sum[k] = max(worst_sum[k], v)
        rows.append({"x": list(shape), "cout": cout, "offset": offset,
                     "dtype": str(dtype).rsplit(".", 1)[-1],
                     "mainloop": loop,
                     "max_abs_err": errs, "row_rel_err": row_errs,
                     "k9_sum_rel_err": sum_errs})
        del x, w
    by_loop = {k: v - before[k] for k, v in kernels.conv_bn_launches.items()}
    launched = kernels.launch_totals(by_loop)
    if not all(launched.values()):
        fail(f"conv_kernels: launches {launched}")

    timing = {"K8": {}, "K9": {}, "K10": {}}
    for s, c, _ in CONV_SHAPES:
        x = _seeded((128, s, s, c), torch.bfloat16, 1)
        w = _seeded((3, 3, c, c), torch.bfloat16, 2, scale=(9 * c) ** -0.5)
        scale = torch.rand(c, device="cuda") + 0.5
        bias = torch.randn(c, device="cuda") * 0.1
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        library_ms = cuda_ms(lambda: F.conv2d(xl, wl, padding=1))
        m = 128 * s * s
        flops = 2 * m * c * 9 * c
        io = 2 * m * c * 2 + 9 * c * c * 2  # x and y bf16, w
        plan = kernels.conv3x3_plan(tuple(x.shape), c, x.dtype,
                                    x.data_ptr(), w.data_ptr(),
                                    *kernels.wgmma_card(x.device.index))
        fns = {"K8": ("bn_relu", (scale, bias),
                      lambda: cb.plain_conv3x3_bn_relu(x, w, scale, bias),
                      io + 2 * 4 * c),
               "K9": ("stats", (), lambda: cb.plain_conv3x3_stats(x, w),
                      io + 2 * 4 * c),
               "K10": ("plain", (), lambda: cb.plain_conv3x3_plain(x, w),
                       io)}
        for key, (kind, vecs, plain_fn, nbytes) in fns.items():
            bound_ms, bound_by = _bound(flops_mod, flops, nbytes,
                                        flops_mod.H100_PEAK_FLOPS)
            timing[key][f"{s}x{s}x{c}"] = {
                "ms": cuda_ms(lambda: kernels.launch_conv3x3(
                    kind, x, w, *vecs)),
                "mma_sync_ms": cuda_ms(lambda: kernels.launch_conv3x3(
                    kind, x, w, *vecs, mainloop="mma_sync")),
                "plain_ms": cuda_ms(plain_fn),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "flops": flops, "bytes": nbytes,
                "mainloop": plan.mainloop, "tile_n": plan.tile_n,
                "blocks": plan.blocks}
    results = {}
    head = f"{CONV_SHAPES[0][0]}x{CONV_SHAPES[0][0]}x{CONV_SHAPES[0][1]}"
    for key, (name, replaces) in CONV_KERNELS.items():
        t = timing[key]
        results[key] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/conv_bn.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": worst[key],
            "max_bf16_row_rel_err": worst_row[key],
            **({"max_k9_sum_rel_err": worst_sum} if key == "K9" else {}),
            "tolerance": {"bfloat16_row": CONV_BF16_ROW_LIMIT,
                          "bfloat16_mean_row": CONV_BF16_MEAN_LIMIT,
                          "float32": {"rtol": CONV_F32_RTOL,
                                      "atol_of_max": CONV_F32_ATOL},
                          **({"sums_rtol": CONV_SUM_RTOL}
                             if key == "K9" else {})},
            "shape": f"[128, 56, 56, 64] -> 64 bf16 ({head})",
            **{f: t[head][f] for f in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "mma_sync_ms")},
            "library_call": "F.conv2d on channels-last bf16 (the conv "
                            "alone, no epilogue)",
            "by_shape": t,
            "ms_per_resnet50_step": sum(t[f"{s}x{s}x{c}"]["ms"] * n
                                        for s, c, n in CONV_SHAPES),
            "mma_sync_ms_per_resnet50_step": sum(
                t[f"{s}x{s}x{c}"]["mma_sync_ms"] * n
                for s, c, n in CONV_SHAPES),
        }
    emit({"phase": "conv_kernels", "cases": rows, "launches": launched,
          "launches_by_mainloop": by_loop, "timing": timing})
    return results


def _variant_counts(model) -> dict:
    """Launches of K6, its backward, K6', K7, K9 and K10 one train step of
    ``model`` makes, and of K8 one eval forward makes, from its
    modules."""
    from horovod_tpu_torch.models.resnet import (
        BatchNormReLU, PallasConvBN3x3, _Block)

    mods = list(model.modules())
    bnr = sum(isinstance(m, BatchNormReLU) for m in mods)
    fused = sum(isinstance(m, PallasConvBN3x3) for m in mods)
    blocks = sum(isinstance(m, _Block) for m in mods)
    return {"scale_bias_relu": bnr, "scale_bias_relu_bwd": bnr,
            "relu_grad": blocks, "residual_relu": blocks, "stats": fused,
            "plain": fused, "bn_relu": fused}


def _counts(kernels) -> dict:
    return {**kernels.elementwise_launches,
            **kernels.launch_totals(kernels.conv_bn_launches)}


def _loops(kernels) -> dict:
    """The K8-K10 launches by mainloop that were made (``"stats.wgmma"``
    ...)."""
    return {k: v for k, v in kernels.conv_bn_launches.items() if v}


def _k1(kernels, rule: str) -> dict:
    """K1's launches of ``rule`` by parameter-group type."""
    return {d: kernels.fused_update_launches[f"{rule}.{d}"]
            for d in kernels.K1_DTYPES}


class AllReduceCounter:
    """Counts ``dist.all_reduce`` calls while active, apart: those made
    eagerly and those recorded into a CUDA graph's capture, in all
    (``eager``, ``captured``) and by op (``counts``: ``"sum.eager"``,
    ``"max.captured"``, ...)."""

    def __enter__(self):
        import torch.distributed as dist

        self.counts = {}
        self._dist, self._call = dist, dist.all_reduce

        def counting(tensor, op=dist.ReduceOp.SUM, *args, **kwargs):
            kind = "max" if op == dist.ReduceOp.MAX else (
                "sum" if op == dist.ReduceOp.SUM else str(op))
            where = "captured" if torch.cuda.is_current_stream_capturing() \
                else "eager"
            key = f"{kind}.{where}"
            self.counts[key] = self.counts.get(key, 0) + 1
            return self._call(tensor, op, *args, **kwargs)

        dist.all_reduce = counting
        return self

    def __exit__(self, *exc):
        self._dist.all_reduce = self._call

    def _total(self, where: str) -> int:
        return sum(n for k, n in self.counts.items()
                   if k.endswith("." + where))

    @property
    def eager(self) -> int:
        return self._total("eager")

    @property
    def captured(self) -> int:
        return self._total("captured")

    def check(self, what: str, calls: dict, per_step: int,
              k: int = 1) -> dict:
        """Fails unless each eager step and each captured step of a
        step's ``calls`` (its ``step.calls``, ``k`` steps a call) called
        all_reduce ``per_step`` times.  A replay calls none: it runs
        what the capture recorded, and at world size 1 NCCL launches no
        kernel a trace could count.  Returns the calls counted."""
        got = {"eager": self.eager, "captured": self.captured}
        want = {"eager": per_step * k * calls["eager"],
                "captured": per_step * k * calls["capture"]}
        if got != want:
            fail(f"{what}: all_reduce calls {got} over {calls}, want "
                 f"{want} ({per_step} a step)")
        return got

    def check_ops(self, what: str, calls: dict, per_step: dict) -> dict:
        """As :meth:`check`, by op: ``per_step`` is ``{"sum": n, "max":
        m}``."""
        want = {}
        for kind, n in per_step.items():
            for where, c in (("eager", calls["eager"]),
                             ("captured", calls["capture"])):
                if n * c:
                    want[f"{kind}.{where}"] = n * c
        if self.counts != want:
            fail(f"{what}: all_reduce calls {self.counts} over {calls}, "
                 f"want {want} ({per_step} a step)")
        return dict(self.counts)


def issued_steps(calls: dict, k: int = 1) -> int:
    """The steps whose launches the wrappers issued over a step's
    ``calls``: the eager ones and the captured ones (a replay issues
    none)."""
    return k * (calls["eager"] + calls["capture"])


def check_graphed(what: str, calls: dict, steps: int) -> None:
    """The step ran graphed: the first warm-up call eager, the second the
    capture, and every timed call a replay."""
    want = {"eager": 1, "capture": 1, "replay": steps - 2}
    if calls != want:
        fail(f"{what}: step calls {calls}, want {want} (the timed window "
             "must hold only replays)")


def eager_rate(what: str, bench, args, key: str, steps: int) -> float:
    """The same benchmark through ``step.eager``: its rate."""
    result = bench.run(args, eager=True)
    if result["step_calls"] != {"eager": steps, "capture": 0, "replay": 0}:
        fail(f"{what}: the eager run's calls {result['step_calls']}")
    if not math.isfinite(result["final_loss"]):
        fail(f"{what}: the eager run's final loss {result['final_loss']}")
    return result[key]


def phase_variants_parity(htt, kernels):
    """A narrow ResNet-18 and ResNet-50 with all three options, trained 2
    steps in float32 from the same weights on the card (K6-K10, K1) and on
    the CPU (their plain versions), TF32 off; then one eval forward (K8)
    of each, the logits compared."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet18, ResNet50

    models = []
    with no_tf32():
        for name, cls in (("ResNet18", ResNet18), ("ResNet50", ResNet50)):
            base = cls(num_classes=10, num_filters=8, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(1),
                       **VARIANTS)
            gen = torch.Generator().manual_seed(2)
            x = torch.rand((8, 64, 64, 3), generator=gen)
            y = torch.randint(0, 10, (8,), generator=gen)
            runs = {}
            for dev in ("cuda", "cpu"):
                model = copy.deepcopy(base)
                opt = htt.fused_sgd(0.01, momentum=0.9)
                step = htt.make_train_step(
                    apply_fn=model, loss_fn=F.cross_entropy, optimizer=opt,
                    has_batch_stats=True, loss_fetch_steps=0)
                state = htt.init_train_state(model, opt, has_batch_stats=True,
                                             device=dev)
                reset_counts(kernels)
                losses = []
                for _ in range(2):
                    state, loss = step(state, x.to(dev), y.to(dev))
                    losses.append(loss.item())
                train_counts = _counts(kernels)
                model.eval()
                reset_counts(kernels)
                with torch.no_grad():
                    logits = model(x.to(dev)).cpu()
                runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                                      {**state.params,
                                       **state.model_state}.items()},
                             logits, train_counts, _counts(kernels))
            (l_gpu, t_gpu, z_gpu, n_train, n_eval), (l_cpu, t_cpu, z_cpu,
                                                      n_cpu, _) = \
                runs["cuda"], runs["cpu"]
            want = _variant_counts(base)
            want_train = {k: (0 if k == "bn_relu" else 2 * v)
                          for k, v in want.items()}
            want_eval = {k: (0 if k in ("stats", "plain", "relu_grad",
                                        "scale_bias_relu_bwd") else v)
                         for k, v in want.items()}
            if n_train != want_train or n_eval != want_eval or \
                    any(n_cpu.values()):
                fail(f"variants_parity: {name} launches train {n_train} "
                     f"(want {want_train}), eval {n_eval} (want "
                     f"{want_eval}), CPU {n_cpu}")
            worst = max((t_gpu[k] - t_cpu[k]).abs().max().item()
                        for k in t_cpu)
            if not all(math.isfinite(v) for v in l_gpu) or any(
                    abs(a - b) > PARITY_RTOL * abs(b) + PARITY_ATOL
                    for a, b in zip(l_gpu, l_cpu)):
                fail(f"variants_parity: {name} losses differ, card {l_gpu} "
                     f"vs CPU {l_cpu}")
            for k in t_cpu:
                if not torch.allclose(t_gpu[k], t_cpu[k], rtol=PARITY_RTOL,
                                      atol=PARITY_ATOL):
                    fail(f"variants_parity: {name} {k} differs by "
                         f"{(t_gpu[k] - t_cpu[k]).abs().max().item()}")
            if not torch.allclose(z_gpu, z_cpu, rtol=PARITY_RTOL,
                                  atol=PARITY_ATOL):
                fail(f"variants_parity: {name} eval logits differ by "
                     f"{(z_gpu - z_cpu).abs().max().item()}")
            models.append({
                "model": f"{name}(num_filters=8, all options) 64x64 b8",
                "steps": 2, "loss_card": l_gpu, "loss_cpu": l_cpu,
                "max_state_abs_err": worst,
                "max_eval_logit_abs_err": (z_gpu - z_cpu).abs().max().item(),
                "card_launches_train": n_train, "card_launches_eval": n_eval})
    emit({"phase": "variants_parity", "options": VARIANTS, "models": models,
          "tolerance": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL},
          "tf32": False})


def phase_variants_main_path(kernels, flops_mod, card, default_img_sec):
    """``examples.synthetic_benchmark.run`` with all three options:
    ResNet-50, 224x224, batch 128, bf16, fused momentum, world size 1 over
    NCCL.  Checks a finite loss, the kernels' launches per step, one K1
    launch per step and one gradient all_reduce per fusion bucket per
    step; then one eval forward of a batch (K8).  Returns the launches."""
    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops.fusion import FusionPlan

    argv = ["--model", "ResNet50", "--image-size", "224", "--batch-size",
            "128", "--dtype", "bfloat16", "--fused-optimizer",
            "--num-warmup-batches", "2", "--num-batches-per-iter", "5",
            "--num-iters", "3", "--norm-act", "pallas", "--residual-join",
            "pallas", "--conv-bn", "pallas"]
    steps = 2 + 5 * 3
    with torch.device("meta"):
        meta = ResNet50(**VARIANTS)
        buckets = FusionPlan(list(canonical_params(meta).values())
                             ).num_buckets()
        structural = _variant_counts(meta)
    if {k: structural[k] for k in VARIANT_STEP_LAUNCHES} != \
            VARIANT_STEP_LAUNCHES:
        fail(f"variants_main_path: the model has {structural}, want "
             f"{VARIANT_STEP_LAUNCHES} a step")
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    with AllReduceCounter() as calls:
        t0 = time.perf_counter()
        result = sb.run(sb.parse_args(argv), then=main_path_trace(
            "variants_main_path", kernels,
            step_trace(variants=VARIANT_STEP_LAUNCHES)))
        wall = time.perf_counter() - t0
    k1 = kernels.launch_totals(kernels.fused_update_launches)
    issued = {**_counts(kernels), "K1_momentum": k1["momentum"],
              "K1_other": k1["sgd"] + k1["adam"],
              "flash": sum(kernels.flash_launches.values())}
    by_loop = _loops(kernels)
    if not math.isfinite(result["final_loss"]):
        fail(f"variants_main_path: final loss {result['final_loss']}")
    check_graphed("variants_main_path", result["step_calls"], steps)
    host_steps = issued_steps(result["step_calls"])
    want = {**{k: v * host_steps for k, v in VARIANT_STEP_LAUNCHES.items()},
            "bn_relu": 0, "K1_momentum": host_steps, "K1_other": 0,
            "flash": 0}
    if issued != want:
        fail(f"variants_main_path: launches issued {issued} over "
             f"{host_steps} steps, want {want}")
    # every K9 and K10 launch of the step on the TMA + wgmma mainloop
    want_loop = {"stats.wgmma": want["stats"], "plain.wgmma": want["plain"]}
    if by_loop != want_loop:
        fail(f"variants_main_path: K8-K10 mainloops {by_loop}, want "
             f"{want_loop}")
    allreduce = calls.check("variants_main_path", result["step_calls"],
                            buckets + 1)
    traced = result["then"]
    peak = torch.cuda.max_memory_allocated()
    eager_img_sec = eager_rate("variants_main_path", sb, sb.parse_args(argv),
                               "img_sec_per_chip", steps)

    # the eval forward of one batch: K8 in every fused block
    device = torch.device("cuda", torch.cuda.current_device())
    model = on_card(ResNet50, **VARIANTS).to(
        memory_format=torch.channels_last).eval()
    x = torch.rand((128, 224, 224, 3), device=device,
                   generator=torch.Generator(device=device).manual_seed(42))
    reset_counts(kernels)
    with torch.no_grad():
        logits, _, spans = profiled(lambda: model(x))
    eval_launches = _counts(kernels)
    eval_by_loop = _loops(kernels)
    eval_traced = trace_launches(spans)
    want_eval = {"scale_bias_relu": VARIANT_STEP_LAUNCHES["scale_bias_relu"],
                 "scale_bias_relu_bwd": 0, "relu_grad": 0,
                 "residual_relu": VARIANT_STEP_LAUNCHES["residual_relu"],
                 "bn_relu": structural["bn_relu"], "stats": 0, "plain": 0}
    want_eval_trace = {**step_trace(k1=0), "K6": want_eval["scale_bias_relu"],
                       "K7": want_eval["residual_relu"],
                       "K8-K10": want_eval["bn_relu"]}
    if eval_launches != want_eval or eval_traced != want_eval_trace or \
            tuple(logits.shape) != (128, 1000) or \
            not torch.isfinite(logits).all() or \
            eval_by_loop != {"bn_relu.wgmma": want_eval["bn_relu"]}:
        fail(f"variants_main_path: eval forward launches {eval_launches} "
             f"(want {want_eval}) on {eval_by_loop}, traced {eval_traced} "
             f"(want {want_eval_trace}), logits {tuple(logits.shape)} "
             f"finite={bool(torch.isfinite(logits).all())}")
    del model, logits
    emit({"phase": "variants_main_path", "model": "ResNet50", "options":
          VARIANTS, "image_size": 224, "batch_per_chip": 128,
          "dtype": "bfloat16", "optimizer": "fused momentum (K1)",
          "world_size": result["size"], "steps": steps,
          "launches_issued": issued, "trace": traced,
          "conv_launches_issued_by_mainloop": by_loop,
          "eval_forward_launches": eval_launches,
          "eval_forward_trace": eval_traced,
          "eval_conv_launches_by_mainloop": eval_by_loop,
          "fusion_buckets": buckets, "allreduce_calls": allreduce,
          "img_sec_per_chip": result["img_sec_per_chip"],
          "img_sec_conf": result["conf"],
          "eager_img_sec_per_chip": eager_img_sec,
          "step_calls": result["step_calls"],
          "default_path_img_sec_per_chip": default_img_sec,
          "mfu": flops_mod.image_model_mfu(result["img_sec_per_chip"]),
          "final_loss": result["final_loss"],
          "max_memory_allocated_bytes": peak, "wall_s": wall, "card": card})
    ran = traced["launches"]
    return {"scale_bias_relu": ran["K6"],
            "scale_bias_relu_bwd": ran["K6_bwd"], "relu_grad": ran["K6'"],
            "residual_relu": ran["K7"], "stats": ran["K9_reduce"],
            "plain": ran["K8-K10"] - ran["K9_reduce"],
            "bn_relu": eval_traced["K8-K10"]}, {**by_loop, **eval_by_loop}


def phase_variants_profile(htt, kernels):
    """3 graphed variants main-path steps (ResNet-50 with all three
    options, 224x224, batch 128, bf16, fused momentum) under
    torch.profiler: device time per step by kind (``K6-K7``, ``K8-K10``
    for the port's kernels), the device's idle share, the host's time to
    issue a call, and the port's kernels counted by name in the trace."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50

    device = htt.device()
    gen = torch.Generator(device=device).manual_seed(42)
    x = torch.rand((128, 224, 224, 3), generator=gen, device=device)
    y = torch.randint(0, 1000, (128,), generator=gen, device=device)
    model = on_card(ResNet50, **VARIANTS).to(
        memory_format=torch.channels_last)
    opt = htt.fused_sgd(0.01, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, has_batch_stats=True,
                               loss_fetch_steps=0)
    state = htt.init_train_state(model, opt, has_batch_stats=True)
    steps = 3
    wall_ms, spans, loss, graphed = _profile_steps(
        "variants_profile", kernels, step, state, (x, y),
        step_trace(variants=VARIANT_STEP_LAUNCHES), steps)
    ported = {}
    for start, end, name in spans:
        kind = _kernel_kind(name)
        if kind in ("K6-K7", "K8-K10"):
            n, ms = ported.get(name, (0, 0.0))
            ported[name] = (n + 1, ms + (end - start) / 1e3)
    breakdown = device_breakdown(spans, steps)
    emit({"phase": "variants_profile", "model": "ResNet50", "options":
          VARIANTS, "steps": steps, "wall_ms_per_step": wall_ms, **graphed,
          **breakdown,
          "ported_kernels": {n[:80]: {"launches_per_step": k / steps,
                                      "ms_per_launch": ms / k}
                             for n, (k, ms) in ported.items()},
          "final_loss": loss})
    del model, state, step


def phase_parity(htt):
    """A narrow ResNet-18 trained 2 steps on the card and on the CPU from
    the same weights and batch."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet18

    with no_tf32():
        base = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(2)
        x = torch.rand((8, 64, 64, 3), generator=gen)
        y = torch.randint(0, 10, (8,), generator=gen)
        runs = _card_cpu_runs(htt, base, x, y,
                              lambda: htt.fused_sgd(0.01, momentum=0.9),
                              F.cross_entropy, has_batch_stats=True)
    emit({"phase": "parity", "model": "ResNet18(num_filters=8) 64x64 b8",
          "steps": 2, **check_card_cpu("parity", runs),
          "tolerance": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL},
          "tf32": False})


def phase_main_path(kernels, flops_mod, card):
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    from horovod_tpu_torch.models import ResNet50

    argv = ["--model", "ResNet50", "--image-size", "224", "--batch-size",
            "128", "--dtype", "bfloat16", "--fused-optimizer",
            "--num-warmup-batches", "2", "--num-batches-per-iter", "5",
            "--num-iters", "3"]
    steps = 2 + 5 * 3
    buckets = fusion_buckets(ResNet50)
    counted = counted_train_flops(on_card(ResNet50), 224, 128)

    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    with AllReduceCounter() as calls:
        t0 = time.perf_counter()
        result = sb.run(sb.parse_args(argv), then=main_path_trace(
            "main path", kernels, step_trace()))
        wall = time.perf_counter() - t0
    issued = kernels.launch_totals(kernels.fused_update_launches)
    k1_issued = _k1(kernels, "momentum")
    peak = torch.cuda.max_memory_allocated()

    if not math.isfinite(result["final_loss"]):
        fail(f"main path: final loss {result['final_loss']}")
    check_graphed("main path", result["step_calls"], steps)
    host_steps = issued_steps(result["step_calls"])
    if issued != {"sgd": 0, "momentum": host_steps, "adam": 0}:
        fail(f"main path: K1 launches issued {kernels.fused_update_launches}"
             f", want {host_steps} momentum")
    if any(kernels.flash_launches.values()):
        fail(f"main path: ResNet-50 launched {kernels.flash_launches}")
    # one all_reduce per gradient bucket, plus one for the reported loss
    allreduce = calls.check("main path", result["step_calls"], buckets + 1)
    traced = result["then"]
    eager_img_sec = eager_rate("main path", sb, sb.parse_args(argv),
                               "img_sec_per_chip", steps)
    emit({"phase": "main_path", "model": "ResNet50", "image_size": 224,
          "batch_per_chip": 128, "dtype": "bfloat16", "optimizer":
          "fused momentum (K1)", "world_size": result["size"],
          "steps": steps, "k1_launches_issued": k1_issued,
          "trace": traced, "fusion_buckets": buckets,
          "allreduce_calls": allreduce,
          "img_sec_per_chip": result["img_sec_per_chip"],
          "img_sec_conf": result["conf"],
          "eager_img_sec_per_chip": eager_img_sec,
          "step_calls": result["step_calls"],
          "mfu": flops_mod.image_model_mfu(result["img_sec_per_chip"]),
          # the same rate over FlopCounterMode's count (a multiply-add
          # counts 2), where the constant above counts it once
          "flop_counter_train_flops_per_img": counted,
          "mfu_flop_counter": flops_mod.image_model_mfu(
              result["img_sec_per_chip"], counted),
          "peak_flops": flops_mod.peak_flops(),
          "final_loss": result["final_loss"],
          "max_memory_allocated_bytes": peak, "wall_s": wall, "card": card})
    return traced["k1"]["momentum"], result["img_sec_per_chip"]


def _kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name, for the step breakdown:
    the port's kernels (K1; K2-K4 as ``flash``, the attention core;
    K6-K7, the elementwise joins; K8-K10, the fused 3x3 conv, whose names
    would otherwise read as the library's conv or BatchNorm), then the
    library's convolutions apart from its matrix products (the QKV,
    output, MLP and head projections on the GPT path)."""
    low = name.lower()
    if "hvd_conv" in low:  # hvd_conv3x3_*_kernel, hvd_conv_stats_reduce_*
        return "K8-K10"
    if any(k in low for k in ("hvd_residual_relu", "hvd_relu_grad",
                              "hvd_scale_bias_relu")):
        return "K6-K7"
    if any(k in low for k in ("momentum_kernel", "sgd_kernel",
                              "adam_kernel")):
        return "K1"
    if "hvdflashargs" in low:  # K2-K4 all take the one argument block
        return "flash"
    if "nccl" in low:
        return "nccl"
    if "bn_" in low or "batch_norm" in low or "batchnorm" in low:
        return "batchnorm"
    if any(k in low for k in ("conv", "wgrad", "dgrad", "fprop",
                              "nchwtonhwc", "nhwctonchw")):
        return "conv"
    if any(k in low for k in ("xmma", "gemm", "gemv", "cutlass", "nvjet")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    if "embedding" in low or "index" in low:
        return "embedding_index"
    if any(k in low for k in ("memcpy", "memset", "copy", "catarray")):
        return "copy"
    if "reduce" in low:
        return "reduction"
    return "elementwise_other"


def device_breakdown(spans, steps: int) -> dict:
    """Per-step device time from kernel ``(start_us, end_us, name)``
    spans: by kind, the busiest kernels, and the idle share of the span
    from the first kernel's start to the last one's end (kernels that
    overlap on two streams count once)."""
    spans = sorted(spans)
    by_kind, by_name = {}, {}
    busy_us = 0.0
    cur_start, cur_end = spans[0][0], spans[0][1]
    for start, end, name in spans:
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + end - start
        by_name[name] = by_name.get(name, 0.0) + end - start
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    span_us = max(end for _, end, _ in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_span_ms_per_step": span_us / 1e3 / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "idle_share": 1.0 - busy_us / span_us,
            "kernels_per_step": len(spans) / steps,
            "ms_per_step_by_kind": {
                k: v / 1e3 / steps
                for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [[n[:100], v / 1e3 / steps]
                                        for n, v in top]}


def flash_counts(kernels, keys, n: int) -> dict:
    """kernels.flash_launches as it must read when each of ``keys``
    (``"fwd.wgmma"``, ...) was launched ``n`` times and nothing else."""
    return {key: n if key in keys else 0 for key in kernels.flash_launches}


def reset_counts(kernels) -> None:
    """Every kernel's launch count to 0."""
    for counts in kernels.LAUNCH_COUNTERS:
        for k in counts:
            counts[k] = 0


def _gpt_parity_run(htt, kernels, seed, lr, steps):
    """One seed of gpt_parity: card and CPU runs, the differences and the
    key bias's gradient on the card at the initial weights."""
    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.models import gpt_tiny, next_token_loss

    base = gpt_tiny(vocab_size=256, hidden_dim=64, num_layers=2,
                    num_heads=4, dtype=torch.float32,
                    generator=torch.Generator().manual_seed(seed))
    ids = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 256, size=(2, 136)))
    model = copy.deepcopy(base).cuda()
    next_token_loss(model(ids.cuda()), ids.cuda()).backward()
    grads = {k: t.grad.abs().max().item()
             for k, t in canonical_params(model).items()}
    runs = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base)
        opt = htt.fused_adam(lr)
        step = htt.make_train_step(apply_fn=model, loss_fn=next_token_loss,
                                   optimizer=opt, loss_fetch_steps=0)
        state = htt.init_train_state(model, opt, device=dev)
        reset_counts(kernels)
        losses = []
        for _ in range(steps):
            state, loss = step(state, ids.to(dev), ids.to(dev))
            losses.append(loss.item())
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                              state.params.items()},
                     dict(kernels.flash_launches),
                     kernels.launch_totals(
                         kernels.fused_update_launches)["adam"])
    (l_gpu, p_gpu, flash, adam), (l_cpu, p_cpu, _, _) = runs["cuda"], \
        runs["cpu"]
    if flash != flash_counts(kernels, GPT_F32_FLASH, 2 * steps) or \
            adam != steps:
        fail(f"gpt_parity: card launches K2-K4 {flash}, K1 adam {adam}")
    if not all(math.isfinite(v) for v in l_gpu) or any(
            abs(a - b) > GPT_LOSS_RTOL * abs(b) for a, b in zip(l_gpu, l_cpu)):
        fail(f"gpt_parity: seed {seed}: losses differ, card {l_gpu} vs CPU "
             f"{l_cpu}")
    keyb = [k for k in p_cpu if k.endswith(KEY_BIAS)]
    diff = {part: torch.cat([(p_gpu[k] - p_cpu[k]).abs().reshape(-1)
                             for k in p_cpu if (k in keyb) == (part == "key")])
            for part in ("key", "other")}
    return {"seed": seed, "loss_card": l_gpu, "loss_cpu": l_cpu,
            "max_loss_rel_err": max(abs(a - b) / abs(b)
                                    for a, b in zip(l_gpu, l_cpu)),
            "max_param_abs_err": diff["other"].max().item(),
            "params_beyond_atol": int((diff["other"] > GPT_PARAM_ATOL)
                                      .sum().item()),
            "n_params": len(diff["other"]),
            "key_bias_max_abs_err": diff["key"].max().item(),
            "n_key_bias": len(diff["key"]),
            "key_bias_grad_max": max(grads[k] for k in keyb),
            "other_grad_max": max(v for k, v in grads.items()
                                  if k not in keyb),
            "card_launches": {**{k: v for k, v in flash.items() if v},
                              "adam": adam}}


def phase_gpt_parity(htt, kernels):
    """A float32 GPT of gpt_tiny's shape (2 layers, hidden 64, 4 heads,
    vocab 256, seq 136) trained 2 steps with fused Adam from the same
    weights and ids on the card (K1-K4) and on the CPU (plain), from each
    of GPT_PARITY_SEEDS."""
    lr, steps = 1e-3, 2
    bound = GPT_FLIP_BOUND * lr * steps
    with no_tf32():
        seeds = [_gpt_parity_run(htt, kernels, seed, lr, steps)
                 for seed in GPT_PARITY_SEEDS]
    for r in seeds:
        if r["max_param_abs_err"] > bound or r["key_bias_max_abs_err"] > \
                bound or r["params_beyond_atol"] > GPT_FLIP_SHARE * \
                r["n_params"]:
            fail(f"gpt_parity: seed {r['seed']}: parameters differ by up to "
                 f"{r['max_param_abs_err']} (key bias "
                 f"{r['key_bias_max_abs_err']}), {r['params_beyond_atol']} "
                 f"of {r['n_params']} beyond {GPT_PARAM_ATOL}")
    emit({"phase": "gpt_parity", "model": "GPT(vocab 256, hidden 64, 2 "
          "layers, 4 heads, mlp 256) float32, b2 s136, fused_adam(1e-3)",
          "steps": steps, "seeds": seeds,
          "tolerance": {"loss_rtol": GPT_LOSS_RTOL,
                        "param_atol": GPT_PARAM_ATOL,
                        "share_beyond_atol": GPT_FLIP_SHARE,
                        "param_bound": bound,
                        "exempt_from_atol": f"*/{KEY_BIAS}"},
          "tf32": False})


def phase_gpt_bf16(kernels, fa):
    """A bf16 GPT with GPT-2 small's head dim (2 layers, hidden 128, 2
    heads, vocab 1024, b2 s320: five kv tiles, the last ragged), one
    forward and backward on the card through K2-K4 and through their
    plain versions from the same weights and ids: the loss and each
    parameter's gradient, in norm, from each of GPT_PARITY_SEEDS."""
    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.models import gpt_tiny, next_token_loss

    def plain_fn(q, k, v, mask):
        # the plain forward's online softmax at the kv tile of K2's plan
        tile = kernels.flash_plan_for(
            "fwd", *(t.transpose(1, 2) for t in (q, k, v))).kv_tile
        return fa.plain_flash_attention(q, k, v, causal=True, kv_tile=tile)

    cfg = dict(vocab_size=1024, hidden_dim=128, num_layers=2, num_heads=2,
               mlp_dim=256, max_len=512, dtype=torch.bfloat16)
    seeds = []
    for seed in GPT_PARITY_SEEDS:
        ids = torch.from_numpy(np.random.default_rng(seed + 1).integers(
            0, 1024, size=(2, 320))).cuda()
        out = {}
        for name, attn in (("kernels", None), ("plain", plain_fn)):
            model = gpt_tiny(attention_fn=attn, generator=torch.Generator()
                             .manual_seed(seed), **cfg).cuda()
            reset_counts(kernels)
            loss = next_token_loss(model(ids), ids)
            loss.backward()
            torch.cuda.synchronize()
            out[name] = (loss.item(), {k: t.grad for k, t in
                                       canonical_params(model).items()},
                         dict(kernels.flash_launches))
        (l_k, g_k, n_k), (l_p, g_p, n_p) = out["kernels"], out["plain"]
        if n_k != flash_counts(kernels, GPT_BF16_FLASH, 2) or \
                any(n_p.values()):
            fail(f"gpt_bf16: launches {n_k} through the kernels, {n_p} "
                 "through the plain versions")
        rel = {k: ((g_k[k].float() - g_p[k].float()).norm()
                   / g_p[k].float().norm().clamp_min(1e-30)).item()
               for k in g_p if not k.endswith(KEY_BIAS)}
        worst = max(rel, key=rel.get)
        seeds.append({
            "seed": seed, "loss_kernels": l_k, "loss_plain": l_p,
            "loss_rel_err": abs(l_k - l_p) / abs(l_p),
            "max_grad_rel_err": rel[worst], "worst_param": worst,
            "key_bias_grad_norm": {
                n: sum(g[k].float().norm().item() for k in g
                       if k.endswith(KEY_BIAS)) for n, g in
                (("kernels", g_k), ("plain", g_p))}})
        if not math.isfinite(l_k) or \
                seeds[-1]["loss_rel_err"] > GPT_BF16_LOSS_RTOL or \
                rel[worst] > GPT_BF16_GRAD_RTOL:
            fail(f"gpt_bf16: {seeds[-1]}")
    emit({"phase": "gpt_bf16", "model": "GPT(vocab 1024, hidden 128, 2 "
          "layers, 2 heads of 64, mlp 256) bf16, b2 s320, K2-K4 against "
          "plain_flash_attention", "seeds": seeds,
          "tolerance": {"loss_rtol": GPT_BF16_LOSS_RTOL,
                        "grad_norm_rtol": GPT_BF16_GRAD_RTOL,
                        "exempt": f"*/{KEY_BIAS}"}})


#: in_graph_steps of the graph_parity runs
GRAPH_PARITY_KS = (1, 3)


def _graph_parity_run(htt, kernels, model, opt, loss_fn, x, y, k, *,
                      eager, batch_stats, **kw):
    """3 calls of a new step over ``model`` on the card, graphed (eager
    warm-up, capture, replay) or through ``step.eager``: the step, its
    state, the calls' losses and the port's launches the wrappers had
    counted after each call."""
    step = htt.make_train_step(apply_fn=model, loss_fn=loss_fn,
                               optimizer=opt, in_graph_steps=k,
                               loss_fetch_steps=0, **kw)
    state = htt.init_train_state(model, opt, has_batch_stats=batch_stats,
                                 device="cuda")
    reset_counts(kernels)
    run = step.eager if eager else step
    losses, counts = [], []
    for _ in range(3):
        state, loss = run(state, x, y)
        losses.append(loss)
        counts.append(host_launches(kernels))
    torch.cuda.synchronize()
    return step, state, [t.item() for t in losses], counts


def _gpt_close(what, got, want, lr, steps) -> dict:
    """GPT parameters held as gpt_parity holds them: at most 3e-4 of them
    beyond GPT_PARAM_ATOL, none beyond GPT_FLIP_BOUND * lr a step."""
    diff = torch.cat([(got[k] - want[k]).abs().reshape(-1) for k in want])
    beyond = int((diff > GPT_PARAM_ATOL).sum().item())
    worst = diff.max().item()
    if worst > GPT_FLIP_BOUND * lr * steps or \
            beyond > GPT_FLIP_SHARE * len(diff):
        fail(f"{what}: parameters differ by up to {worst}, "
             f"{beyond} of {len(diff)} beyond {GPT_PARAM_ATOL}")
    return {"max_param_abs_err": worst, "params_beyond_atol": beyond}


def phase_graph_parity(htt, kernels):
    """The compiled step against ``step.eager`` on the card, in float32
    with TF32 off: the narrow ResNet-18 (fused momentum; all three kernel
    options; the per-leaf momentum update) and the narrow float32 GPT
    (fused Adam), each 3 calls of k = 1 and 3 steps, graphed (eager
    warm-up, capture, replay) against eager, from the same weights and
    batch: the losses of every call, the parameters and statistics at
    the parity phases' limits, and the launches counted: the graphed
    warm-up and capture issue what the first two eager calls issue, the
    replay none.  A call of a graphed step with the eager run's state
    raises ``ValueError``.  A graphed remat-full GPT step matches the
    graphed GPT step."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet18, gpt_tiny, next_token_loss

    def resnet(**options):
        return lambda: ResNet18(num_classes=10, num_filters=8,
                                dtype=torch.float32,
                                generator=torch.Generator().manual_seed(1),
                                **options)

    gen = torch.Generator().manual_seed(2)
    image = (torch.rand((8, 64, 64, 3), generator=gen).cuda(),
             torch.randint(0, 10, (8,), generator=gen).cuda())
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, size=(2, 136))).cuda()
    lr_adam = 1e-3

    def momentum():
        return htt.fused_sgd(0.01, momentum=0.9)

    stats = {"batch_stats": True}
    cases = {
        "resnet18": (resnet(), momentum, F.cross_entropy, image, stats),
        "resnet18_all_options": (resnet(**VARIANTS), momentum,
                                 F.cross_entropy, image, stats),
        "resnet18_per_leaf": (resnet(), momentum, F.cross_entropy, image,
                              {**stats, "fused_optimizer": False}),
        "gpt_f32": (lambda: gpt_tiny(
            vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
            dtype=torch.float32, generator=torch.Generator().manual_seed(3)),
            lambda: htt.fused_adam(lr_adam), next_token_loss, (ids, ids),
            {"batch_stats": False}),
    }
    rows = []
    graphed_gpt = None
    with no_tf32():
        for name, (factory, make_opt, loss_fn, (x, y), kw) in cases.items():
            base = factory()
            for k in GRAPH_PARITY_KS:
                g_step, g_state, g_loss, g_counts = _graph_parity_run(
                    htt, kernels, copy.deepcopy(base), make_opt(), loss_fn,
                    x, y, k, eager=False, **kw)
                e_step, e_state, e_loss, e_counts = _graph_parity_run(
                    htt, kernels, copy.deepcopy(base), make_opt(), loss_fn,
                    x, y, k, eager=True, **kw)
                what = f"{name} k={k}"
                if g_step.calls != {"eager": 1, "capture": 1, "replay": 1} \
                        or e_step.calls != {"eager": 3, "capture": 0,
                                            "replay": 0}:
                    fail(f"graph_parity: {what}: calls {g_step.calls} and "
                         f"{e_step.calls}")
                k1 = 0 if kw.get("fused_optimizer") is False else k
                if g_counts[1] != e_counts[1] or g_counts[2] != g_counts[1] \
                        or [c["K1"] for c in e_counts] != [k1, 2 * k1,
                                                           3 * k1]:
                    fail(f"graph_parity: {what}: launches after each call "
                         f"graphed {g_counts}, eager {e_counts}")
                try:
                    g_step(e_state, x, y)
                except ValueError:
                    pass
                else:
                    fail(f"graph_parity: {what}: a foreign state was taken")
                got = {**g_state.params, **g_state.model_state}
                want = {**e_state.params, **e_state.model_state}
                row = {"case": what, "loss_graphed": g_loss,
                       "loss_eager": e_loss,
                       "launches_issued": {k_: v for k_, v in
                                           g_counts[-1].items() if v}}
                if name.startswith("gpt"):
                    if any(abs(a - b) > GPT_LOSS_RTOL * abs(b)
                           for a, b in zip(g_loss, e_loss)):
                        fail(f"graph_parity: {what}: losses {g_loss} vs "
                             f"{e_loss}")
                    row.update(_gpt_close(f"graph_parity: {what}", got,
                                          want, lr_adam, 3 * k))
                    if k == 1:
                        graphed_gpt = (base, g_state, g_loss)
                else:
                    if any(abs(a - b) > PARITY_RTOL * abs(b) + PARITY_ATOL
                           for a, b in zip(g_loss, e_loss)):
                        fail(f"graph_parity: {what}: losses {g_loss} vs "
                             f"{e_loss}")
                    for key in want:
                        if not torch.allclose(got[key], want[key],
                                              rtol=PARITY_RTOL,
                                              atol=PARITY_ATOL):
                            fail(f"graph_parity: {what}: {key} differs by "
                                 f"{(got[key] - want[key]).abs().max()}")
                    row["max_state_abs_err"] = max(
                        (got[key] - want[key]).abs().max().item()
                        for key in want)
                rows.append(row)
        base, g_state, g_loss = graphed_gpt
        r_step, r_state, r_loss, _ = _graph_parity_run(
            htt, kernels, copy.deepcopy(base), htt.fused_adam(lr_adam),
            next_token_loss, ids, ids, 1, eager=False, batch_stats=False,
            remat_policy="full")
        if r_step.calls != {"eager": 1, "capture": 1, "replay": 1} or any(
                abs(a - b) > GPT_LOSS_RTOL * abs(b)
                for a, b in zip(r_loss, g_loss)):
            fail(f"graph_parity: remat full GPT calls {r_step.calls}, "
                 f"losses {r_loss} vs {g_loss}")
        rows.append({"case": "gpt_f32 remat=full k=1 against no remat",
                     "loss_graphed": r_loss, "loss_eager": g_loss,
                     **_gpt_close("graph_parity: remat full",
                                  r_state.params, g_state.params, lr_adam,
                                  3)})
    emit({"phase": "graph_parity", "calls": 3, "cases": rows,
          "tolerance": {"resnet": {"rtol": PARITY_RTOL,
                                   "atol": PARITY_ATOL},
                        "gpt": {"loss_rtol": GPT_LOSS_RTOL,
                                "param_atol": GPT_PARAM_ATOL,
                                "share_beyond_atol": GPT_FLIP_SHARE}},
          "tf32": False})


def phase_collectives(htt):
    """Every collective of the port on CUDA tensors over NCCL at world
    size 1 (over the world and over the process set {0}) against its
    plain result, bit for bit; then an allreduce with a prescale and an
    allgatherv captured into one CUDA graph and replayed on new data."""
    dev = htt.device()
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((8, 3), device=dev, generator=gen)
    v = torch.randn((4, 2), device=dev, generator=gen)
    ps = htt.ProcessSet([0])
    masked = torch.cat([v[:2], torch.zeros_like(v[2:])])
    two = torch.tensor([2], device=dev)

    def flat(ts):
        return torch.cat([t.reshape(-1).float() for t in ts])

    gathered, counts = htt.allgatherv(v, valid_rows=2, max_rows=4)
    gathered_ps, counts_ps = htt.allgatherv(
        v, valid_rows=torch.tensor(2, device=dev), max_rows=4,
        process_set=ps)
    grads = htt.allreduce_gradients({"a": x, "b": v})
    cases = {
        "allreduce_sum": (htt.allreduce(x, op=htt.Sum), x),
        "allreduce_average": (htt.allreduce(x), x / 1),
        "allreduce_min": (htt.allreduce(x, op=htt.Min), x),
        "allreduce_max": (htt.allreduce(x, op=htt.Max), x),
        "allreduce_scaled": (htt.allreduce(x, prescale_factor=0.5,
                                           postscale_factor=3.0),
                             x * 0.5 / 1 * 3.0),
        "allreduce_set": (htt.allreduce(x, op=htt.Sum, process_set=ps), x),
        "grouped_allreduce": (flat(htt.grouped_allreduce(
            [x, v], op=htt.Sum, threshold_bytes=32)), flat([x, v])),
        "grouped_allreduce_set": (flat(htt.grouped_allreduce(
            [x, v], process_set=ps)), flat([x / 1, v / 1])),
        "allreduce_gradients": (flat([grads["a"], grads["b"]]),
                                flat([x, v])),
        "allgather": (htt.allgather(x), x),
        "allgather_set": (htt.allgather(x, process_set=ps), x),
        "allgatherv": (flat([gathered, counts]), flat([masked, two])),
        "allgatherv_set": (flat([gathered_ps, counts_ps]),
                           flat([masked, two])),
        "broadcast": (htt.broadcast(x, root_rank=0), x),
        "broadcast_set": (htt.broadcast(x, root_rank=0, process_set=ps), x),
        "alltoall": (htt.alltoall(x), x),
        "alltoall_set": (htt.alltoall(x, process_set=ps), x),
        "reducescatter": (htt.reducescatter(x), x),
        "reducescatter_average": (htt.reducescatter(x, op=htt.Average),
                                  x / 1),
        "reducescatter_set": (htt.reducescatter(x, process_set=ps), x),
    }
    for name, (got, want) in cases.items():
        if got.device != want.device or not torch.equal(got, want):
            fail(f"collectives: {name} gives {got}, want {want}")
    # captured: the replay reduces and gathers what the input holds then
    static = torch.randn((6, 3), device=dev, generator=gen)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        reduced = htt.allreduce(static, op=htt.Sum, prescale_factor=2.0)
        g_rows, g_counts = htt.allgatherv(static[:4], valid_rows=3,
                                          max_rows=6)
    fresh = torch.randn((6, 3), device=dev, generator=gen)
    static.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    want_rows = torch.cat([fresh[:3], torch.zeros_like(fresh[:3])])
    if not (torch.equal(reduced, fresh * 2.0) and
            torch.equal(g_rows, want_rows) and g_counts.tolist() == [3]):
        fail("collectives: the captured allreduce and allgatherv replayed "
             f"to {reduced}, {g_rows}, {g_counts}")
    del graph
    emit({"phase": "collectives", "backend": htt.core.backend(),
          "world_size": htt.size(), "cases": list(cases),
          "tolerance": "bit-equal (torch.equal)",
          "captured": ["allreduce(prescale_factor=2)", "allgatherv"]})


def on_card(factory, **kw):
    """``factory(**kw)`` initialized on the card from a generator there
    seeded with 0 (on the CPU, VGG-16's initialization takes seconds)."""
    with torch.device("cuda"):
        return factory(generator=torch.Generator(device="cuda").manual_seed(
            0), **kw)


def fusion_buckets(factory, **kw) -> int:
    """The fusion buckets of the model ``factory(**kw)`` builds (on the
    meta device: shapes only)."""
    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.ops.fusion import FusionPlan

    with torch.device("meta"):
        return FusionPlan(list(canonical_params(
            factory(**kw)).values())).num_buckets()


def phase_gpt_main_path(htt, kernels, card):
    """``examples.gpt_synthetic_benchmark.run`` at its defaults: GPT-2
    small, batch 4, seq 1024, bf16, flash attention (K2-K4), fused Adam
    (K1), world size 1 over NCCL."""
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    args = gb.parse_args([])
    steps = args.num_warmup_batches + \
        args.num_batches_per_iter * args.num_iters
    layers = 12
    from horovod_tpu_torch.models import gpt2_small

    buckets = fusion_buckets(gpt2_small)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    with AllReduceCounter() as calls:
        t0 = time.perf_counter()
        result = gb.run(args, then=main_path_trace(
            "gpt_main_path", kernels, step_trace(flash=layers)))
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    flash = dict(kernels.flash_launches)
    k1 = kernels.launch_totals(kernels.fused_update_launches)
    k1_issued = _k1(kernels, "adam")

    if not math.isfinite(result["final_loss"]):
        fail(f"gpt_main_path: final loss {result['final_loss']}")
    check_graphed("gpt_main_path", result["step_calls"], steps)
    host_steps = issued_steps(result["step_calls"])
    if flash != flash_counts(kernels, GPT_BF16_FLASH, layers * host_steps):
        fail(f"gpt_main_path: K2-K4 launches issued {flash}, want "
             f"{layers * host_steps} each of {GPT_BF16_FLASH}")
    if k1 != {"sgd": 0, "momentum": 0, "adam": host_steps}:
        fail(f"gpt_main_path: K1 launches issued {k1}, want {host_steps} "
             "adam")
    allreduce = calls.check("gpt_main_path", result["step_calls"],
                            buckets + 1)
    traced = result["then"]
    eager_seq_sec = eager_rate("gpt_main_path", gb, gb.parse_args([]),
                               "seq_sec_per_chip", steps)
    emit({"phase": "gpt_main_path", "model": "gpt2_small",
          "batch_per_chip": args.batch_size, "seq_len": args.seq_len,
          "dtype": args.dtype, "attn": args.attn,
          "optimizer": "fused_adam(1e-4) (K1 adam)",
          "world_size": htt.size(), "steps": steps,
          "k2_k4_launches_issued": {k: v for k, v in flash.items() if v},
          "k1_launches_issued": k1_issued, "trace": traced,
          "fusion_buckets": buckets, "allreduce_calls": allreduce,
          "seq_sec_per_chip": result["seq_sec_per_chip"],
          "eager_seq_sec_per_chip": eager_seq_sec,
          "step_calls": result["step_calls"],
          "mfu": result["mfu"], "final_loss": result["final_loss"],
          "max_memory_allocated_bytes": peak, "wall_s": wall, "card": card})
    return flash, traced, result


def counted_train_flops(model, size: int, batch: int) -> float:
    """Training FLOPs per image of ``model`` (on the card) at ``size``, as
    torch.utils.flop_counter.FlopCounterMode counts them over one forward
    and backward of a ``batch`` there (a multiply-add counts 2)."""
    import torch.nn.functional as F
    from torch.utils.flop_counter import FlopCounterMode

    model = model.to(memory_format=torch.channels_last)
    x = torch.rand((batch, size, size, 3), device="cuda")
    y = torch.randint(0, 1000, (batch,), device="cuda")
    with FlopCounterMode(display=False) as counter:
        F.cross_entropy(model(x), y).backward()
    return counter.get_total_flops() / batch


#: BERT-base's cell: the BERT bench at its defaults with --attn pallas,
#: cut as the other main paths (2 warm-up steps, 3 iterations of 5)
BERT_ARGV = ["--attn", "pallas", "--num-warmup-batches", "2",
             "--num-batches-per-iter", "5", "--num-iters", "3"]


def phase_bert_main_path(htt, kernels, card):
    """``examples.bert_synthetic_benchmark.run`` at its defaults with
    ``--attn pallas``: BERT-base, batch 8, seq 512, bf16, non-causal flash
    attention (K2-K4), AdamW leaf by leaf, world size 1 over NCCL, the step
    graphed.  Checks a finite loss, K2, K3 and K4 each launched 12 times a
    step on TMA + wgmma and no K1, one gradient all_reduce per fusion
    bucket plus one for the loss, as issued and in the trace of 2 more
    replays; then the same through ``step.eager``, and ``--attn xla``
    (the materialized attention) graphed: their rates.  The MLM head's
    float32 product is timed alone at its shape."""
    from horovod_tpu_torch.examples import bert_synthetic_benchmark as bb
    from horovod_tpu_torch.models import bert_base

    args = bb.parse_args(BERT_ARGV)
    steps = args.num_warmup_batches + \
        args.num_batches_per_iter * args.num_iters
    layers = 12
    buckets = fusion_buckets(bert_base)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("bert_main_path: TF32 is on; the head's product is float32")
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    with AllReduceCounter() as calls:
        t0 = time.perf_counter()
        result = bb.run(args, then=main_path_trace(
            "bert_main_path", kernels, step_trace(k1=0, flash=layers)))
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    flash = dict(kernels.flash_launches)
    k1 = kernels.launch_totals(kernels.fused_update_launches)

    if not math.isfinite(result["final_loss"]):
        fail(f"bert_main_path: final loss {result['final_loss']}")
    check_graphed("bert_main_path", result["step_calls"], steps)
    host_steps = issued_steps(result["step_calls"])
    if flash != flash_counts(kernels, GPT_BF16_FLASH, layers * host_steps):
        fail(f"bert_main_path: K2-K4 launches issued {flash}, want "
             f"{layers * host_steps} each of {GPT_BF16_FLASH}")
    if any(k1.values()):
        fail(f"bert_main_path: K1 launched {k1} (AdamW runs leaf by leaf)")
    allreduce = calls.check("bert_main_path", result["step_calls"],
                            buckets + 1)
    traced = result["then"]
    eager = eager_rate("bert_main_path", bb, bb.parse_args(BERT_ARGV),
                       "sent_sec_per_chip", steps)
    reset_counts(kernels)
    xla = bb.run(bb.parse_args(BERT_ARGV + ["--attn", "xla"]))
    check_graphed("bert_main_path --attn xla", xla["step_calls"], steps)
    if not math.isfinite(xla["final_loss"]) or any(
            kernels.flash_launches.values()):
        fail(f"bert_main_path --attn xla: loss {xla['final_loss']}, "
             f"flash launches {kernels.flash_launches}")
    # the MLM head alone: [b*s, 768] @ [768, 30522] in float32
    gen = torch.Generator(device="cuda").manual_seed(3)
    hidden = torch.randn(args.batch_size * args.seq_len, 768, device="cuda",
                         generator=gen)
    head = torch.randn(768, 30522, device="cuda", generator=gen)
    head_ms = cuda_ms(lambda: torch.matmul(hidden, head))
    emit({"phase": "bert_main_path", "model": "bert_base",
          "batch_per_chip": args.batch_size, "seq_len": args.seq_len,
          "dtype": args.dtype, "attn": args.attn,
          "optimizer": "transforms.adamw(1e-4), leaf by leaf",
          "world_size": htt.size(), "steps": steps,
          "k2_k4_launches_issued": {k: v for k, v in flash.items() if v},
          "trace": traced, "fusion_buckets": buckets,
          "allreduce_calls": allreduce,
          "sent_sec_per_chip": result["sent_sec_per_chip"],
          "eager_sent_sec_per_chip": eager,
          "attn_xla_sent_sec_per_chip": xla["sent_sec_per_chip"],
          "step_calls": result["step_calls"], "mfu": result["mfu"],
          "final_loss": result["final_loss"],
          "head_matmul_f32_ms": head_ms, "tf32": False,
          "max_memory_allocated_bytes": peak, "wall_s": wall, "card": card})
    return traced


#: the registry's cells: (model, image size), each at batch 64, bf16,
#: --fused-optimizer, cut to 2 warm-up steps and 2 iterations of 3
REGISTRY_CELLS = (("VGG16", 224), ("InceptionV3", 299), ("ViT-B16", 224))
REGISTRY_BATCH = 64


def phase_registry_main_path(htt, kernels, flops_mod, card) -> dict:
    """``examples.synthetic_benchmark.run`` on each of REGISTRY_CELLS,
    graphed, world size 1 over NCCL.  Each must show a finite loss, one
    K1 momentum launch a step and no flash launch, one gradient
    all_reduce per fusion bucket plus one for the loss, as issued and in
    the trace of 2 more replays; reports the graphed and the eager rate,
    peak memory and MFU over FlopCounterMode's count of one forward and
    backward on the card.  Returns each model's K1 trace."""
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    from horovod_tpu_torch.models import MODELS

    traces = {}
    for name, size in REGISTRY_CELLS:
        argv = ["--model", name, "--image-size", str(size), "--batch-size",
                str(REGISTRY_BATCH), "--dtype", "bfloat16",
                "--fused-optimizer", "--num-warmup-batches", "2",
                "--num-batches-per-iter", "3", "--num-iters", "2"]
        steps = 2 + 3 * 2
        what = f"registry_main_path {name}"
        buckets = fusion_buckets(MODELS[name], image_size=size)
        counted = counted_train_flops(
            on_card(MODELS[name], image_size=size), size, REGISTRY_BATCH)
        reset_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        with AllReduceCounter() as calls:
            t0 = time.perf_counter()
            result = sb.run(sb.parse_args(argv), then=main_path_trace(
                what, kernels, step_trace()))
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        issued = kernels.launch_totals(kernels.fused_update_launches)
        if not math.isfinite(result["final_loss"]):
            fail(f"{what}: final loss {result['final_loss']}")
        check_graphed(what, result["step_calls"], steps)
        host_steps = issued_steps(result["step_calls"])
        if issued != {"sgd": 0, "momentum": host_steps, "adam": 0}:
            fail(f"{what}: K1 launches issued "
                 f"{kernels.fused_update_launches}, want {host_steps} "
                 "momentum")
        if any(kernels.flash_launches.values()):
            fail(f"{what}: launched {kernels.flash_launches}")
        allreduce = calls.check(what, result["step_calls"], buckets + 1)
        traces[name] = result["then"]
        eager = eager_rate(what, sb, sb.parse_args(argv),
                           "img_sec_per_chip", steps)
        rate = result["img_sec_per_chip"]
        emit({"phase": "registry_main_path", "model": name,
              "image_size": size, "batch_per_chip": REGISTRY_BATCH,
              "dtype": "bfloat16", "optimizer": "fused momentum (K1)",
              "world_size": result["size"], "steps": steps,
              "k1_launches_issued": _k1(kernels, "momentum"),
              "trace": traces[name], "fusion_buckets": buckets,
              "allreduce_calls": allreduce, "img_sec_per_chip": rate,
              "img_sec_conf": result["conf"], "eager_img_sec_per_chip": eager,
              "step_calls": result["step_calls"],
              "flop_counter_train_flops_per_img": counted,
              "mfu": flops_mod.image_model_mfu(rate, counted),
              "peak_flops": flops_mod.peak_flops(),
              "final_loss": result["final_loss"],
              "max_memory_allocated_bytes": peak, "wall_s": wall,
              "card": card})
    return traces


def _card_cpu_runs(htt, base, x, y, make_opt, loss_fn, *, apply=None,
                   has_batch_stats: bool, steps: int = 2):
    """``base`` trained ``steps`` steps on the card and on the CPU from
    the same weights and batch (``apply(model, device)``, when given,
    makes the step's apply_fn): each device's losses and final parameters
    and statistics (on the CPU)."""
    runs = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base)
        opt = make_opt()
        apply_fn = model if apply is None else apply(model, dev)
        step = htt.make_train_step(apply_fn=apply_fn, loss_fn=loss_fn,
                                   optimizer=opt,
                                   has_batch_stats=has_batch_stats,
                                   loss_fetch_steps=0)
        state = htt.init_train_state(model, opt,
                                     has_batch_stats=has_batch_stats,
                                     device=dev)
        losses = []
        for _ in range(steps):
            state, loss = step(state, x.to(dev), y.to(dev))
            losses.append(loss.item())
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                              {**state.params,
                               **state.model_state}.items()})
    return runs


def check_card_cpu(what: str, runs) -> dict:
    """Fails unless the card's losses, parameters and statistics in
    ``runs`` (_card_cpu_runs) agree with the CPU's to PARITY_RTOL /
    PARITY_ATOL; returns the readings."""
    (l_gpu, t_gpu), (l_cpu, t_cpu) = runs["cuda"], runs["cpu"]
    if not all(math.isfinite(v) for v in l_gpu):
        fail(f"{what}: non-finite loss on the card {l_gpu}")
    if any(abs(a - b) > PARITY_RTOL * abs(b) + PARITY_ATOL
           for a, b in zip(l_gpu, l_cpu)):
        fail(f"{what}: losses differ, card {l_gpu} vs CPU {l_cpu}")
    for k in t_cpu:
        if not torch.allclose(t_gpu[k], t_cpu[k], rtol=PARITY_RTOL,
                              atol=PARITY_ATOL):
            fail(f"{what}: {k} differs by "
                 f"{(t_gpu[k] - t_cpu[k]).abs().max().item()}")
    return {"loss_card": l_gpu, "loss_cpu": l_cpu,
            "max_loss_err": max(abs(a - b) for a, b in zip(l_gpu, l_cpu)),
            "max_state_abs_err": max((t_gpu[k] - t_cpu[k]).abs().max().item()
                                     for k in t_cpu)}


def phase_registry_parity(htt, kernels):
    """Card-vs-CPU training parity, float32 with TF32 off, 2 steps from
    the same weights and batch (the step graphed on the card from its
    second call), held as ``parity`` holds ResNet-18: a narrow VGG (with
    BatchNorm), Inception V3 at 107x107 (its last stage 2x2) and a
    2-layer ViT with fused momentum (K1); then bert_tiny through the BERT
    bench's masked loss and head with AdamW leaf by leaf and flash
    attention (K2-K4) at a ragged 136, held as gpt_parity holds GPT."""
    import torch.nn.functional as F

    from horovod_tpu_torch.examples import bert_synthetic_benchmark as bb
    from horovod_tpu_torch.models import VGG, InceptionV3, ViT, bert_tiny
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    from horovod_tpu_torch.optim.transforms import adamw, sgd

    momentum = (lambda: htt.fused_sgd(0.01, momentum=0.9), "fused (K1)")
    # model: (build from a generator, image size, batch, BatchNorm,
    # dtype, optimizer, its name).  Inception runs float64 parameters,
    # per leaf (K1 takes float32 and bf16 groups), at the same limits:
    # in float32 at 107x107 the first step's losses agreed to 3e-6 and
    # the second's differed by 1e-2 (1.8197 card, 1.8350 CPU), its small
    # BatchNorms amplifying the two devices' convolution rounding; in
    # float64 only the float32 logits' rounding is left (read: losses
    # 2.6e-7 apart, a stem BatchNorm bias 9.5e-7)
    image = {
        "VGG(16-M-32-M-64-64-M, BN) 32x32 b8": (lambda g: VGG(
            (16, "M", 32, "M", 64, 64, "M"), num_classes=10,
            dtype=torch.float32, batch_norm=True, image_size=32,
            generator=g), 32, 8, True, torch.float32, momentum),
        "InceptionV3 75x75 b4": (lambda g: InceptionV3(
            num_classes=10, dtype=torch.float32, image_size=75,
            generator=g), 75, 4, True, torch.float64,
            (lambda: sgd(0.01, momentum=0.9), "transforms.sgd")),
        "ViT(patch 8, hidden 64, 2 layers, 4 heads) 32x32 b8": (lambda g: ViT(
            num_classes=10, patch_size=8, hidden_dim=64, num_layers=2,
            num_heads=4, mlp_dim=128, dtype=torch.float32, image_size=32,
            generator=g), 32, 8, False, torch.float32, momentum),
    }
    out = []
    with no_tf32():
        for what, (build, size, batch, stats, dtype, (make_opt, opt_name)) \
                in image.items():
            gen = torch.Generator().manual_seed(2)
            x = torch.rand((batch, size, size, 3), generator=gen).to(dtype)
            y = torch.randint(0, 10, (batch,), generator=gen)
            runs = _card_cpu_runs(
                htt, build(torch.Generator().manual_seed(1)).to(dtype), x,
                y, make_opt, F.cross_entropy, has_batch_stats=stats)
            out.append({"model": what, "dtype": str(dtype), "optimizer":
                        opt_name, **check_card_cpu(
                            f"registry_parity: {what}", runs)})

        # bert_tiny, masked MLM loss over the fixed head, AdamW
        lr, steps, seq = 1e-4, 2, 136
        base = bert_tiny(dtype=torch.float32,
                         attention_fn=lambda q, k, v, m: flash_attention(
                             q, k, v, causal=False),
                         generator=torch.Generator().manual_seed(4))
        inputs, tokens, mask = bb.mlm_batch(4, seq, base.vocab_size, 0.15)
        x = torch.from_numpy(inputs[:4]).long()
        y = bb.mlm_targets(tokens[:4], mask[:4])
        head = torch.randn(base.hidden_dim, base.vocab_size,
                           generator=torch.Generator().manual_seed(5)) * 0.02
        reset_counts(kernels)
        runs = _card_cpu_runs(
            htt, base, x, y, lambda: adamw(lr), bb.masked_mlm_loss,
            apply=lambda model, dev: bb.mlm_apply(model, head.to(dev)),
            has_batch_stats=False, steps=steps)
        flash = dict(kernels.flash_launches)
    (l_gpu, p_gpu), (l_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    if flash != flash_counts(kernels, GPT_F32_FLASH, 4 * steps):
        fail(f"registry_parity: bert_tiny launched K2-K4 {flash}")
    if not all(math.isfinite(v) for v in l_gpu) or any(
            abs(a - b) > GPT_LOSS_RTOL * abs(b) for a, b in zip(l_gpu, l_cpu)):
        fail(f"registry_parity: bert_tiny losses card {l_gpu} vs CPU "
             f"{l_cpu}")
    keyb = {k for k in p_cpu if k.endswith(KEY_BIAS)}
    bound = GPT_FLIP_BOUND * lr * steps
    if max((p_gpu[k] - p_cpu[k]).abs().max().item() for k in keyb) > bound:
        fail("registry_parity: bert_tiny key bias beyond its bound")
    close = _gpt_close("registry_parity: bert_tiny",
                       {k: v for k, v in p_gpu.items() if k not in keyb},
                       {k: v for k, v in p_cpu.items() if k not in keyb},
                       lr, steps)
    out.append({"model": "bert_tiny float32, b4 s136, flash (K2-K4), "
                "masked MLM loss over a fixed head, transforms.adamw(1e-4)",
                "loss_card": l_gpu, "loss_cpu": l_cpu, **close,
                "card_launches": {k: v for k, v in flash.items() if v}})
    emit({"phase": "registry_parity", "steps": 2, "runs": out,
          "tolerance": {"image": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL},
                        "bert": {"loss_rtol": GPT_LOSS_RTOL,
                                 "param_atol": GPT_PARAM_ATOL,
                                 "share_beyond_atol": GPT_FLIP_SHARE,
                                 "param_bound": bound}},
          "tf32": False})


#: the port's kernels by the names they have in a CUPTI trace: K9 and
#: K10 (and K8) share the TMA + wgmma conv kernel, and each K9 launch adds
#: its second pass, the column reduce; K6's backward (on either route)
#: adds its own, the reduce over its blocks
TRACE_KERNELS = {
    "K1": ("sgd_kernel", "momentum_kernel", "adam_kernel"),
    "K2": ("flash_fwd",), "K3": ("flash_bwd_dq",), "K4": ("flash_bwd_dkv",),
    "K6": ("hvd_scale_bias_relu_kernel", "hvd_scale_bias_relu_chan_kernel"),
    "K6_bwd": ("hvd_scale_bias_relu_bwd_kernel",
               "hvd_scale_bias_relu_bwd_general_kernel"),
    "K6_bwd_reduce": ("hvd_scale_bias_relu_bwd_reduce",),
    "K6'": ("hvd_relu_grad",),
    "K7": ("hvd_residual_relu",), "K8-K10": ("hvd_conv3x3_",),
    "K9_reduce": ("hvd_conv_stats_reduce",),
}


def trace_launches(spans) -> dict:
    """The port's kernels counted by name in a profiler trace."""
    counts = dict.fromkeys(TRACE_KERNELS, 0)
    for _, _, name in spans:
        for key, parts in TRACE_KERNELS.items():
            if any(p in name for p in parts):
                counts[key] += 1
    return counts


def k1_trace(spans) -> dict:
    """K1's launches in a profiler trace by rule and parameter-group
    type (the kernels are templates of the group's type)."""
    counts = {rule: {"float32": 0, "bfloat16": 0}
              for rule in ("sgd", "momentum", "adam")}
    for _, _, name in spans:
        for rule, by_dtype in counts.items():
            if f"{rule}_kernel" in name:
                by_dtype["bfloat16" if "bfloat16" in name else
                         "float32"] += 1
    return counts


def host_launches(kernels) -> dict:
    """The port's kernels by TRACE_KERNELS' keys, from the wrappers'
    counters: the launches the host issued."""
    flash = kernels.launch_totals(kernels.flash_launches)
    conv = kernels.launch_totals(kernels.conv_bn_launches)
    ew = kernels.elementwise_launches
    return {"K1": sum(kernels.fused_update_launches.values()),
            "K2": flash["fwd"], "K3": flash["bwd_dq"],
            "K4": flash["bwd_dkv"], "K6": ew["scale_bias_relu"],
            "K6_bwd": ew["scale_bias_relu_bwd"],
            "K6_bwd_reduce": ew["scale_bias_relu_bwd"],
            "K6'": ew["relu_grad"], "K7": ew["residual_relu"],
            "K8-K10": sum(conv.values()), "K9_reduce": conv["stats"]}


def step_trace(k1: int = 1, flash: int = 0, variants=None) -> dict:
    """The port's kernels, by TRACE_KERNELS' keys, that one train step
    runs: ``k1`` K1 launches, ``flash`` of each of K2-K4, and K6-K10 as
    ``variants`` (VARIANT_STEP_LAUNCHES' counters) gives them."""
    v = variants or dict.fromkeys(VARIANT_STEP_LAUNCHES, 0)
    return {"K1": k1, "K2": flash, "K3": flash, "K4": flash,
            "K6": v["scale_bias_relu"],
            "K6_bwd": v["scale_bias_relu_bwd"],
            "K6_bwd_reduce": v["scale_bias_relu_bwd"],
            "K6'": v["relu_grad"],
            "K7": v["residual_relu"], "K8-K10": v["stats"] + v["plain"],
            "K9_reduce": v["stats"]}


#: seconds the card idles under torch.profiler before and after the
#: profiled work.  The profiler drops a device record stamped outside its
#: capture window, and a replay launched at once after the profiler
#: started could lose its first kernels.
PROFILE_MARGIN_S = 0.05


def profiled(fn, cpu: bool = True):
    """``fn()`` under torch.profiler, from an idle card and with
    PROFILE_MARGIN_S of idle time on either side, the card synchronized
    before the profiler stops: its result, its wall ms and the device
    kernels' ``(start_us, end_us, name)`` spans.  ``cpu=False`` records
    the device's activity alone (an eager step's thousands of host ops
    would slow it under the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] * cpu +
                 [ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        fail("the profiler recorded no device kernels")
    return out, wall_ms, spans


def trace_replays(what, kernels, step, state, args, calls: int):
    """``calls`` more calls of a graphed ``step`` under torch.profiler.
    Each must be a replay, and no wrapper may count a launch in them: a
    replay runs the captured kernels without their wrappers.  Returns
    the state, the last loss, the calls' wall ms and the device kernels'
    spans."""
    before, issued = dict(step.calls), host_launches(kernels)

    def run():
        st, loss = state, None
        for _ in range(calls):
            st, loss = step(st, *args)
        return st, loss

    (state, loss), wall_ms, spans = profiled(run)
    if step.calls != {**before, "replay": before["replay"] + calls}:
        fail(f"{what}: the traced calls were not all replays: "
             f"{before} -> {step.calls}")
    if host_launches(kernels) != issued:
        fail(f"{what}: the wrappers counted launches in replays: {issued} "
             f"-> {host_launches(kernels)}")
    return state, loss, wall_ms, spans


#: graphed calls traced at the end of each main path
TRACED_CALLS = 2


def main_path_trace(what, kernels, per_step: dict, k: int = 1):
    """The ``then`` of a main path's benchmark ``run``: TRACED_CALLS
    more calls of its graphed step, traced; fails unless the trace holds
    ``per_step`` (step_trace) for each of their ``TRACED_CALLS * k``
    steps.  Returns the steps traced and the port's kernels counted in
    the trace, K1 also by rule and group type, and the steps' device time
    by kind and idle share (device_breakdown)."""
    def then(step, state, x, y):
        _, _, _, spans = trace_replays(what, kernels, step, state, (x, y),
                                       TRACED_CALLS)
        steps = TRACED_CALLS * k
        traced = trace_launches(spans)
        want = {key: n * steps for key, n in per_step.items()}
        if traced != want:
            fail(f"{what}: the trace of {steps} replayed steps holds the "
                 f"port's kernels {traced}, want {want}")
        return {"steps": steps, "launches": traced, "k1": k1_trace(spans),
                "breakdown": device_breakdown(spans, steps)}

    return then


def _profile_steps(what, kernels, step, state, args, per_step: dict,
                   steps: int = 3):
    """``step(state, *args)`` graphed: 2 warm-up calls (eager, capture),
    5 replays timed on the host clock call by call, each from an idle
    card (the host's time to issue a call), then ``steps`` replays under
    torch.profiler, whose trace must hold the port's kernels ``per_step``
    (step_trace) times a step.  Returns the wall ms per profiled step,
    the device kernels' spans, the last loss and the step's numbers."""
    for _ in range(2):
        state, loss = step(state, *args)
    torch.cuda.synchronize()
    issue = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, loss = step(state, *args)
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    state, loss, wall_ms, spans = trace_replays(what, kernels, step, state,
                                                args, steps)
    check_graphed(what, step.calls, 2 + 5 + steps)
    traced = trace_launches(spans)
    want = {key: n * steps for key, n in per_step.items()}
    if traced != want:
        fail(f"{what}: the trace of {steps} replays holds the port's "
             f"kernels {traced}, want {want}")
    return wall_ms / steps, spans, loss.item(), {
        "host_ms_per_call": statistics.median(issue),
        "step_calls": dict(step.calls),
        "trace_launches_per_step": {k: v / steps for k, v in traced.items()
                                    if v}}


def phase_gpt_profile(htt, kernels):
    """3 graphed GPT main-path steps (GPT-2 small, batch 4, seq 1024, bf16,
    flash attention, fused Adam) under torch.profiler: device time per
    step by kind, the device's idle share, the host's time to issue a
    call, and the port's kernels counted by name in the trace."""
    from horovod_tpu_torch.models import gpt2_small, next_token_loss

    model = on_card(gpt2_small)
    opt = htt.fused_adam(1e-4)
    step = htt.make_train_step(apply_fn=model, loss_fn=next_token_loss,
                               optimizer=opt, loss_fetch_steps=0)
    state = htt.init_train_state(model, opt)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1000, size=(4, 1024))).to(htt.device())
    steps = 3
    wall_ms, spans, loss, graphed = _profile_steps(
        "gpt_profile", kernels, step, state, (ids, ids),
        step_trace(flash=model.num_layers), steps)
    flash = {}
    for start, end, name in spans:
        if _kernel_kind(name) == "flash":
            found = re.search(r"flash_\w+", name)
            name = found.group(0) if found else name[:60]
            n, ms = flash.get(name, (0, 0.0))
            flash[name] = (n + 1, ms + (end - start) / 1e3)
    emit({"phase": "gpt_profile", "model": "gpt2_small", "steps": steps,
          "wall_ms_per_step": wall_ms, **graphed,
          **device_breakdown(spans, steps),
          "flash_ms_per_launch": {n: ms / k
                                  for n, (k, ms) in flash.items()},
          "flash_launches_per_step": {n: k / steps
                                      for n, (k, _) in flash.items()},
          "final_loss": loss})


def phase_profile(htt, kernels):
    """3 graphed main-path steps (ResNet-50, 224x224, batch 128, bf16,
    fused momentum) under torch.profiler: device time per step by kind of
    kernel, the device's idle share between the first kernel's start and
    the last one's end, the host's time to issue a call, and the port's
    kernels counted by name in the trace."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50

    device = htt.device()
    gen = torch.Generator(device=device).manual_seed(42)
    x = torch.rand((128, 224, 224, 3), generator=gen, device=device)
    y = torch.randint(0, 1000, (128,), generator=gen, device=device)
    model = on_card(ResNet50).to(memory_format=torch.channels_last)
    opt = htt.fused_sgd(0.01, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, has_batch_stats=True,
                               loss_fetch_steps=0)
    state = htt.init_train_state(model, opt, has_batch_stats=True)
    steps = 3
    wall_ms, spans, loss, graphed = _profile_steps(
        "profile", kernels, step, state, (x, y), step_trace(), steps)
    emit({"phase": "profile", "model": "ResNet50", "steps": steps,
          "wall_ms_per_step": wall_ms, **graphed,
          **device_breakdown(spans, steps),
          "final_loss": loss})
    del model, state, step


def phase_rules(htt, kernels):
    """Fused SGD and fused Adam, 3 graphed trainer steps each at the main
    path's shapes (eager, capture, a traced replay); returns each rule's
    K1 launches by parameter-group type in the replay's trace."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50

    device = htt.device()
    gen = torch.Generator(device=device).manual_seed(42)
    x = torch.rand((128, 224, 224, 3), generator=gen, device=device)
    y = torch.randint(0, 1000, (128,), generator=gen, device=device)
    launches = {}
    for rule, opt in (("sgd", htt.fused_sgd(0.01)),
                      ("adam", htt.fused_adam(1e-3))):
        model = on_card(ResNet50).to(memory_format=torch.channels_last)
        step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                                   optimizer=opt, has_batch_stats=True,
                                   loss_fetch_steps=0)
        state = htt.init_train_state(model, opt, has_batch_stats=True)
        reset_counts(kernels)
        for _ in range(2):
            state, loss = step(state, x, y)
        issued = dict(kernels.fused_update_launches)
        state, loss, _, spans = trace_replays(f"rules: {rule}", kernels,
                                              step, state, (x, y), 1)
        final = loss.item()
        launches[rule] = k1_trace(spans)[rule]
        if not math.isfinite(final) or sum(_k1(kernels, rule).values()) != 2 \
                or sum(issued.values()) != 2 or \
                sum(launches[rule].values()) != 1 or \
                trace_launches(spans)["K1"] != 1:
            fail(f"rules: {rule} loss {final}, launches issued {issued}, "
                 f"traced {launches[rule]}")
        emit({"phase": "rules", "rule": rule, "steps": 3,
              "k1_launches_issued": _k1(kernels, rule),
              "k1_trace_of_replay": launches[rule], "final_loss": final})
        del model, state, step
    return launches


# ---------------------------------------------------------------------------
# the wire tier and the Horovod torch frontend (world size 1 on the card)
# ---------------------------------------------------------------------------
#: the wire phase's compressors
WIRE_COMPRESSORS = ("bf16", "int8", "fp8_e4m3", "fp8_e5m2")
#: the guard's cadence in the error-feedback main path (calls a read)
EF_GUARD_STEPS = 5


def fp8_wire_route() -> dict:
    """What this card's torch and NCCL do with a float8 SUM all-reduce at
    world size 1: ``reduced`` (right), ``wrong`` or ``refused`` (torch's
    or NCCL's error, checked before anything is sent)."""
    import torch.distributed as dist

    route = {"nccl": ".".join(map(str, torch.cuda.nccl.version())),
             "torch": torch.__version__}
    for name, dtype in (("fp8_e4m3", torch.float8_e4m3fn),
                        ("fp8_e5m2", torch.float8_e5m2)):
        t = torch.full((16,), 1.5, device="cuda").to(dtype)
        try:
            dist.all_reduce(t)
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as e:
            route[name] = "refused: " + str(e).strip().splitlines()[0][:240]
            continue
        route[name] = "reduced" if torch.equal(
            t.float(), torch.full((16,), 1.5, device="cuda")) else \
            f"wrong: {t.float()[:4].tolist()}"
    return route


def _resnet50_leaves(seed: int, device) -> list:
    """Random float32 tensors shaped like ResNet-50's 161 gradient leaves
    (made on the CPU from ``seed``, then moved)."""
    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.models import ResNet50

    with torch.device("meta"):
        shapes = [p.shape for p in canonical_params(ResNet50()).values()]
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(s, generator=gen) * 1e-2).to(device)
            for s in shapes]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bytes (float8 has no equality of
    its own)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def _cpu_wire(comp, grads, residuals):
    """The port's CPU result of one error-feedback reduction at world size
    1, by its own functions (gloo reduces no float8, so not through the
    collective): each leaf's q, output and new residual."""
    from horovod_tpu_torch.ops import compression as C

    xs = [g + r for g, r in zip(grads, residuals)]
    maxima = C.local_max_abs(xs) if C.is_scaled(comp) else None
    out = []
    for i, x in enumerate(xs):
        q, ctx = C.compress_with(comp, x, 1, max_abs=None if maxima is None
                                 else maxima[i])
        red = C.average_(q.clone(), 1)
        out.append((q, comp.decompress(red, ctx),
                    x - comp.decompress(q, ctx)))
    return out


def phase_wire(htt, card) -> dict:
    """The wire tier at world size 1 over NCCL, on tensors shaped like
    ResNet-50's 161 gradient leaves: for each compressor, error feedback
    through ``fused_allreduce`` eagerly and inside one captured graph,
    held bit for bit against the port's CPU result on the same seeded
    inputs (q, the output and the new residual), with one MAX all-reduce
    a call for a quantizer's scales; then Adasum, hierarchical and
    two-level at world size 1.  Nothing across cards is shown."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.ops import compression as C

    route = fp8_wire_route()
    grads_cpu, res_cpu = _resnet50_leaves(11, "cpu"), _resnet50_leaves(12,
                                                                       "cpu")
    fresh_cpu = _resnet50_leaves(13, "cpu"), _resnet50_leaves(14, "cpu")
    grads, res = [t.cuda() for t in grads_cpu], [t.cuda() for t in res_cpu]
    fresh = [[t.cuda() for t in ts] for ts in fresh_cpu]
    buckets = {}
    results = {}
    for name in WIRE_COMPRESSORS:
        comp = C.Compression.lookup(name)
        if name.startswith("fp8") and route[name] != "reduced":
            try:
                htt.fused_allreduce(grads, compression=C.ErrorFeedback(comp),
                                    residuals=res)
            except RuntimeError as e:
                results[name] = {"route": route[name],
                                 "raised": str(e).splitlines()[0][:200]}
                continue
            fail(f"wire: {name} was reduced, though the probe found "
                 f"{route[name]}")
        ef = C.ErrorFeedback(comp)
        want = _cpu_wire(comp, grads_cpu, res_cpu)
        # q on the card, by the same functions, bit for bit
        xs = [g + r for g, r in zip(grads, res)]
        maxima = C.local_max_abs(xs) if C.is_scaled(comp) else None
        q_bad = 0
        for i, x in enumerate(xs):
            q, _ = C.compress_with(comp, x, 1, max_abs=None if maxima is None
                                   else maxima[i])
            q_bad += int(not same_bits(q.cpu(), want[i][0]))
        with AllReduceCounter() as calls:
            out, new_res = htt.fused_allreduce(grads, compression=ef,
                                               residuals=res)
        torch.cuda.synchronize()
        n_buckets = calls.counts.get("sum.eager", 0)
        buckets[name] = n_buckets
        want_calls = {"sum.eager": n_buckets,
                      **({"max.eager": 1} if C.is_scaled(comp) else {})}
        if calls.counts != want_calls or n_buckets < 1:
            fail(f"wire: {name} all_reduce calls {calls.counts}, want "
                 f"{want_calls}")
        out_err = max((o.cpu() - w[1]).abs().max().item()
                       for o, w in zip(out, want))
        res_err = max((r.cpu() - w[2]).abs().max().item()
                      for r, w in zip(new_res, want))
        if q_bad or out_err or res_err:
            fail(f"wire: {name} against the CPU: {q_bad} leaves' q differ, "
                 f"output {out_err}, residual {res_err}")
        # captured: one graph; replayed on fresh inputs it must give the
        # eager call's numbers on them
        static_g = [g.clone() for g in grads]
        static_r = [r.clone() for r in res]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            htt.fused_allreduce(static_g, compression=ef, residuals=static_r)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with AllReduceCounter() as captured:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                g_out, g_res = htt.fused_allreduce(
                    static_g, compression=ef, residuals=static_r)
        want_captured = {k.replace("eager", "captured"): v
                         for k, v in want_calls.items()}
        if captured.counts != want_captured:
            fail(f"wire: {name} captured all_reduce calls {captured.counts}"
                 f", want {want_captured}")
        for dst, src in zip(static_g + static_r, fresh[0] + fresh[1]):
            dst.copy_(src)
        graph.replay()
        e_out, e_res = htt.fused_allreduce(fresh[0], compression=ef,
                                           residuals=fresh[1])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(g_out + g_res,
                                                     e_out + e_res)):
            fail(f"wire: {name}: the replayed graph differs from the eager "
                 "call on the same inputs")
        del graph
        results[name] = {"route": "nccl", "buckets": n_buckets,
                         "allreduce_calls": calls.counts,
                         "captured_allreduce_calls": captured.counts,
                         "q_leaves_differing": q_bad,
                         "max_abs_err_output": out_err,
                         "max_abs_err_residual": res_err,
                         "graph_equals_eager": True}
    # Adasum, hierarchical and two-level at world size 1
    x = torch.randn(1001, device="cuda")
    before = metrics.TWO_LEVEL_FALLBACKS.get()
    adasum = htt.allreduce(x, op=htt.Adasum)
    hier = htt.allreduce(x, hierarchical=True)
    two = htt.allreduce(x, two_level=True, compression=C.Compression.int8)
    fallbacks = metrics.TWO_LEVEL_FALLBACKS.get() - before
    two_err = (two - x).abs().max().item()
    if not (torch.equal(adasum, x) and torch.equal(hier, x)) or \
            fallbacks != 1 or two_err > x.abs().max().item() / 127:
        fail(f"wire: at world size 1 Adasum / hierarchical / two-level "
             f"gave {adasum[:3]}, {hier[:3]}, two-level error {two_err} "
             f"with {fallbacks} fallbacks")
    emit({"phase": "wire", "world_size": htt.size(),
          "leaves": len(grads), "elements": sum(g.numel() for g in grads),
          "fp8_route": route, "compressors": results,
          "adasum_returns_input": True, "hierarchical_returns_input": True,
          "two_level_fallbacks": fallbacks,
          "tolerance": "bit-equal (q, output, residual; graph vs eager)",
          "note": "world size 1 over NCCL: nothing across cards is shown",
          "card": card})
    return route


def _residual_check(what, step, state, calls: int) -> dict:
    """The error-feedback state after ``calls`` calls of ``step``: one
    residual leaf a parameter, finite, not all zero, and one guard read
    every EF_GUARD_STEPS calls."""
    res = state.residual
    if sorted(res) != sorted(state.params):
        fail(f"{what}: residual leaves {len(res)} for "
             f"{len(state.params)} parameters")
    finite = all(bool(torch.isfinite(r).all()) for r in res.values())
    nonzero = any(bool(r.any()) for r in res.values())
    if not (finite and nonzero):
        fail(f"{what}: residual finite {finite}, nonzero {nonzero}")
    if step.guard["reads"] != calls // EF_GUARD_STEPS or step.guard["trips"]:
        fail(f"{what}: guard {step.guard} after {calls} calls, want "
             f"{calls // EF_GUARD_STEPS} reads and no trip")
    return {"residual_leaves": len(res), "guard": dict(step.guard)}


def phase_ef_main_path(kernels, flops_mod, card, default_img_sec,
                       fp8_route) -> dict:
    """``examples.synthetic_benchmark.run`` as the main path (ResNet-50,
    224x224, batch 128, bf16, fused momentum, graphed) with
    ``--compression int8`` (error feedback, the default), and again with
    fp8 e4m3 when the card reduces it: a finite loss, K1 momentum once a
    step issued and traced, per step one all_reduce per (1-byte) bucket,
    one MAX for the scales and one for the loss, a residual of one leaf a
    parameter that is finite and nonzero, one guard read every
    EF_GUARD_STEPS calls; img/s beside the main path's."""
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    from horovod_tpu_torch.models import ResNet50

    base_argv = ["--model", "ResNet50", "--image-size", "224",
                 "--batch-size", "128", "--dtype", "bfloat16",
                 "--fused-optimizer", "--num-warmup-batches", "2",
                 "--num-batches-per-iter", "5", "--num-iters", "3"]
    steps = 2 + 5 * 3
    wires = ["int8"] + (["fp8"] if fp8_route["fp8_e4m3"] == "reduced"
                        else [])
    out = {}
    with env_vars({"HVD_COMPRESSION_GUARD_STEPS": str(EF_GUARD_STEPS)}):
        for wire in wires:
            with torch.device("meta"):
                from horovod_tpu_torch.convert import canonical_params
                from horovod_tpu_torch.ops.fusion import FusionPlan

                leaves = [p.to(torch.int8) for p in canonical_params(
                    ResNet50()).values()]
            buckets = FusionPlan(leaves).num_buckets()
            what = f"ef_main_path {wire}"
            trace = main_path_trace(what, kernels, step_trace())

            def then(step, state, x, y, trace=trace, what=what):
                traced = trace(step, state, x, y)
                return {**traced, **_residual_check(
                    what, step, state, sum(step.calls.values()))}

            reset_counts(kernels)
            torch.cuda.reset_peak_memory_stats()
            with AllReduceCounter() as calls:
                t0 = time.perf_counter()
                result = sb.run(sb.parse_args(base_argv + [
                    "--compression", wire]), then=then)
                wall = time.perf_counter() - t0
            if not math.isfinite(result["final_loss"]):
                fail(f"{what}: final loss {result['final_loss']}")
            check_graphed(what, result["step_calls"], steps)
            host_steps = issued_steps(result["step_calls"])
            k1 = kernels.launch_totals(kernels.fused_update_launches)
            if k1 != {"sgd": 0, "momentum": host_steps, "adam": 0}:
                fail(f"{what}: K1 launches issued "
                     f"{kernels.fused_update_launches}")
            allreduce = calls.check_ops(what, result["step_calls"],
                                        {"sum": buckets + 1, "max": 1})
            traced = result["then"]
            out[wire] = result["img_sec_per_chip"]
            emit({"phase": "ef_main_path", "model": "ResNet50",
                  "image_size": 224, "batch_per_chip": 128,
                  "dtype": "bfloat16", "optimizer": "fused momentum (K1)",
                  "compression": f"ErrorFeedback({wire})",
                  "world_size": result["size"], "steps": steps,
                  "k1_launches_issued": _k1(kernels, "momentum"),
                  "fusion_buckets": buckets, "allreduce_calls": allreduce,
                  "trace": traced,
                  "img_sec_per_chip": result["img_sec_per_chip"],
                  "img_sec_conf": result["conf"],
                  "main_path_img_sec_per_chip": default_img_sec,
                  "step_calls": result["step_calls"],
                  "mfu": flops_mod.image_model_mfu(
                      result["img_sec_per_chip"]),
                  "final_loss": result["final_loss"],
                  "max_memory_allocated_bytes":
                      torch.cuda.max_memory_allocated(),
                  "wall_s": wall, "card": card})
    return out


@contextlib.contextmanager
def cudnn_benchmark(on: bool):
    """cuDNN's benchmark mode set to ``on`` inside, restored after."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = on
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


#: the frontend's traced steps (eager: no graph to replay)
FRONTEND_TRACED_STEPS = 2


def phase_frontend_main_path(htt, card):
    """The Horovod torch frontend.  First a narrow ResNet-18 (the
    reference bench's plain-torch model, width 8, 64x64, batch 8) in
    float64, 2 steps through ``DistributedOptimizer`` on the card and 2
    through plain ``torch.optim.SGD`` on the CPU, TF32 off, at the parity
    limits.  Then ``examples.pytorch_synthetic_benchmark.run`` at the
    reference's defaults (ResNet-50, batch 32, 224x224, float32, eager):
    a finite loss, one gradient all_reduce a parameter a step, img/s,
    and 2 more steps traced (device time, idle share); then with
    ``--fp16-allreduce``."""
    import torch.nn.functional as F

    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as pb

    with no_tf32():
        torch.manual_seed(3)
        base = pb.make_model("resnet18", 10, width=8).double()
        gen = torch.Generator().manual_seed(4)
        x = torch.rand((8, 3, 64, 64), generator=gen, dtype=torch.float64)
        y = torch.randint(0, 10, (8,), generator=gen)
        runs = {}
        for dev in ("cuda", "cpu"):
            model = copy.deepcopy(base).to(dev)
            opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
            if dev == "cuda":
                opt = hvd_torch.DistributedOptimizer(
                    opt, named_parameters=model.named_parameters())
            losses = []
            for _ in range(2):
                opt.zero_grad()
                loss = F.cross_entropy(model(x.to(dev)), y.to(dev))
                loss.backward()
                opt.step()
                losses.append(loss.item())
            runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                                  model.state_dict().items()
                                  if v.is_floating_point()})
    parity = check_card_cpu("frontend parity", runs)
    emit({"phase": "frontend_parity",
          "model": "pytorch_synthetic_benchmark resnet18 (width 8) 64x64 "
                   "b8, float64", "steps": 2, **parity,
          "tolerance": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL},
          "tf32": False})

    with torch.device("meta"):
        n_grads = sum(p.requires_grad for p in pb.make_model(
            "resnet50", 1000).parameters())
    args = pb.parse_args([])
    steps = args.num_warmup_batches + \
        args.num_batches_per_iter * args.num_iters

    def trace(step):
        _, wall_ms, spans = profiled(
            lambda: [step() for _ in range(FRONTEND_TRACED_STEPS)],
            cpu=False)
        return {"steps": FRONTEND_TRACED_STEPS, "wall_ms": wall_ms,
                **device_breakdown(spans, FRONTEND_TRACED_STEPS)}

    rates = {}
    for extra in ([], ["--fp16-allreduce"]):
        name = "fp16_allreduce" if extra else "plain"
        torch.cuda.reset_peak_memory_stats()
        # torch's cuDNN defaults, as the reference's harness runs (the
        # image benches before it turned cuDNN's benchmark mode on)
        with cudnn_benchmark(False), AllReduceCounter() as calls:
            t0 = time.perf_counter()
            result = pb.run(pb.parse_args(extra), then=trace)
            wall = time.perf_counter() - t0
        done = steps + FRONTEND_TRACED_STEPS
        if not math.isfinite(result["final_loss"]) or \
                (calls.eager, calls.captured) != (done * n_grads, 0):
            fail(f"frontend_main_path {name}: loss {result['final_loss']}, "
                 f"all_reduce calls {calls.eager} eager / {calls.captured} "
                 f"captured, want {done * n_grads} ({n_grads} a step)")
        rates[name] = result["img_sec_per_proc"]
        emit({"phase": "frontend_main_path", "run": name,
              "model": "resnet50", "batch_per_chip": args.batch_size,
              "image_size": args.image_size, "dtype": "float32",
              "optimizer": "hvd.DistributedOptimizer(SGD(0.01 * size, "
                           "momentum=0.9))",
              "compression": "fp16 (bf16)" if extra else "none",
              "world_size": htt.size(), "steps": steps,
              "allreduce_calls_per_step": n_grads,
              "img_sec_per_chip": result["img_sec_per_proc"],
              "trace": result["then"], "final_loss": result["final_loss"],
              "max_memory_allocated_bytes":
                  torch.cuda.max_memory_allocated(),
              "wall_s": wall, "card": card})
    return rates


#: BERT-base with --adasum: 1 warm-up (eager), the capture, 2 replays
BERT_ADASUM_ARGV = ["--attn", "pallas", "--num-warmup-batches", "2",
                    "--num-batches-per-iter", "2", "--num-iters", "1"]


def phase_bert_adasum(htt, kernels, card):
    """``examples.bert_synthetic_benchmark.run`` at full size with
    ``--attn pallas --adasum``, graphed, cut to the warm-up and capture
    and 2 replays: K2-K4 12 a step each (issued and traced), one
    all_reduce a step (the loss: Adasum at world size 1 exchanges
    nothing), and the final loss bit-equal to the same run without
    ``--adasum`` from the same seeds."""
    from horovod_tpu_torch.examples import bert_synthetic_benchmark as bb

    layers, steps = 12, 4
    reset_counts(kernels)
    with AllReduceCounter() as calls:
        t0 = time.perf_counter()
        ada = bb.run(bb.parse_args(BERT_ADASUM_ARGV + ["--adasum"]),
                     then=main_path_trace("bert_adasum", kernels,
                                          step_trace(k1=0, flash=layers)))
        wall = time.perf_counter() - t0
    check_graphed("bert_adasum", ada["step_calls"], steps)
    host_steps = issued_steps(ada["step_calls"])
    flash = dict(kernels.flash_launches)
    if flash != flash_counts(kernels, GPT_BF16_FLASH, layers * host_steps):
        fail(f"bert_adasum: K2-K4 launches issued {flash}")
    allreduce = calls.check("bert_adasum", ada["step_calls"], 1)
    base = bb.run(bb.parse_args(BERT_ADASUM_ARGV))
    if ada["final_loss"] != base["final_loss"] or \
            not math.isfinite(ada["final_loss"]):
        fail(f"bert_adasum: final loss {ada['final_loss']!r}, the default "
             f"run's {base['final_loss']!r} (want bit-equal)")
    emit({"phase": "bert_adasum", "model": "bert_base", "attn": "pallas",
          "op": "Adasum", "world_size": htt.size(), "steps": steps,
          "step_calls": ada["step_calls"], "allreduce_calls": allreduce,
          "k2_k4_launches_issued": {k: v for k, v in flash.items() if v},
          "trace": ada["then"], "final_loss": ada["final_loss"],
          "default_final_loss": base["final_loss"], "bit_equal": True,
          "sent_sec_per_chip": ada["sent_sec_per_chip"],
          "default_sent_sec_per_chip": base["sent_sec_per_chip"],
          "wall_s": wall, "card": card})
    return base


# ---------------------------------------------------------------------------
# model parallelism: K5 (the flash ring's hops), the sequence-parallel main
# paths, tensor / pipeline / expert parallelism on the card
# ---------------------------------------------------------------------------
#: the ring's virtual ranks on one card: GPT-2 small's attention (b 4,
#: h 12, s 1024, d 64) in shards of 256
RING_RANKS = 4
#: the float32 ring case: shards of 136 keys (ragged against the 64-row
#: tiles), b 2, h 3, d 64
RING_F32_SHAPE = (2, RING_RANKS * 136, 3, 64)
#: per K5 call: (the K2-K4 launch kind it runs, the ring building block it
#: replaces)
RING_HOPS = {
    "K5 mha_partial": ("fwd", "horovod_tpu/ops/flash_attention.py:442"),
    "K5 mha_bwd_dq": ("bwd_dq", "horovod_tpu/ops/flash_attention.py:455"),
    "K5 mha_bwd_dkv": ("bwd_dkv", "horovod_tpu/ops/flash_attention.py:466"),
}
#: the bf16 ring against flash_attention over the whole sequence, row by
#: row in norm (largest, mean).  The ring rounds each hop's p to bf16
#: against that hop's running max, the whole-sequence kernel against the
#: sequence's, and sums dq, dk, dv over the hops in float32 before one
#: bf16 rounding where the kernel sums them in one pass, so a share of
#: the terms round apart and the bf16 outputs flip by an ulp (2^-8 of a
#: row) in many elements, where against the plain hops at the kernel's
#: own tile few do (FLASH_BF16_*).  An H100 run read 7.6e-3 for
#: the largest row (dq's, a row of few large terms) and 2.3e-3 for the
#: mean (o's); the limits are two ulps and one: 2^-6 and 2^-8.  Each
#: case also runs the ring with each of RING_FAULTS planted in its hop
#: calls and fails unless the same comparison catches it.
RING_FULL_ROW_LIMIT, RING_FULL_MEAN_LIMIT = 2 ** -6, 2 ** -8
#: faults the whole-sequence comparison must catch (``_faulty_hop_ops``)
RING_FAULTS = ("hop_local_lse", "dropped_hop")
#: a ring's whole forward and backward on one card issues more host work
#: than SLEEP_CYCLES covers: 16 hops and their merges, 48 kernels
RING_SLEEP_CYCLES = 40_000_000


def _ring_shards(t, r, seq):
    return t[:, r * seq:(r + 1) * seq].transpose(1, 2)


def _ring_errors(got, want, dtype, seq, limits=None):
    """Every virtual rank's block of out, dq, dk and dv against ``want``'s
    (bf16 row by row in norm, to ``limits`` = (largest, mean) or
    FLASH_BF16_*; float32 elementwise).  Returns the max abs error, the
    worst (max, mean) row error per output (bf16) and the blocks that
    miss their limit, as ``(output, virtual rank, what)``."""
    worst, rows, misses = 0.0, {}, []
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        g, w = g.to(dtype).float(), w.to(dtype).float()
        for r in range(RING_RANKS):
            gb_, wb = g[:, r * seq:(r + 1) * seq], w[:, r * seq:(r + 1) * seq]
            if not torch.isfinite(gb_).all():
                misses.append((name, r, "non-finite"))
                continue
            err = (gb_ - wb).abs().max().item()
            worst = max(worst, err)
            if dtype == torch.bfloat16:
                top, mean = row_rel_err(gb_, wb)
                prev = rows.get(name, (0.0, 0.0))
                rows[name] = (max(prev[0], top), max(prev[1], mean))
                row_limit, mean_limit = limits or (
                    FLASH_BF16_ROW_LIMIT[name], FLASH_BF16_MEAN_LIMIT)
                ok = top <= row_limit and mean <= mean_limit
                how = f"row error max {top}, mean {mean}"
            else:
                ok = torch.allclose(gb_, wb, *FLASH_TOL[torch.float32])
                how = f"max abs {err}"
            if not ok:
                misses.append((name, r, how))
    return worst, rows, misses


def _ring_compare(what, got, want, dtype, seq, limits=None
                  ) -> Tuple[float, dict]:
    """:func:`_ring_errors`, failing on any block that misses its limit;
    returns the max abs error and the row errors."""
    worst, rows, misses = _ring_errors(got, want, dtype, seq, limits)
    if misses:
        name, r, how = misses[0]
        fail(f"ring_kernels: {name} of virtual rank {r} disagrees ({what}): "
             f"{how}; {len(misses)} blocks miss")
    return worst, rows


def _faulty_hop_ops(ra, fa, fault: str, seq: int):
    """The ring's hop calls on the kernels with one fault planted, for
    ``ring_lockstep``'s ``ops``: ``hop_local_lse`` hands K3 and K4 the
    hop's own lse (from K2 on that hop) in place of the ring's global
    one; ``dropped_hop`` returns the empty partial (o 0, m ``NEG_INF``,
    l 0) for the kv shard one rank back, so every rank's hop 1 merges
    nothing."""
    ops = ra.HOP_KERNELS
    if fault == "hop_local_lse":
        def hop_lse(q, k, v, q_off, kv_off, kw):
            _, m, l = ops.partial(q, k, v, q_off, kv_off, **kw)
            return (m + torch.log(l.clamp_min(1e-30))).contiguous()

        def bwd_dq(q, k, v, do, lse, delta, q_off, kv_off, **kw):
            return ops.bwd_dq(q, k, v, do, hop_lse(q, k, v, q_off, kv_off,
                                                   kw), delta, q_off,
                              kv_off, **kw)

        def bwd_dkv(q, k, v, do, lse, delta, q_off, kv_off, **kw):
            return ops.bwd_dkv(q, k, v, do, hop_lse(q, k, v, q_off, kv_off,
                                                    kw), delta, q_off,
                               kv_off, **kw)

        return ra.HopOps(ops.partial, bwd_dq, bwd_dkv)
    if fault != "dropped_hop":
        raise ValueError(fault)

    def partial(q, k, v, q_off, kv_off, **kw):
        o, m, l = ops.partial(q, k, v, q_off, kv_off, **kw)
        if (q_off - kv_off) // seq % RING_RANKS == 1:
            return (torch.zeros_like(o), torch.full_like(m, fa.NEG_INF),
                    torch.zeros_like(l))
        return o, m, l

    return ra.HopOps(partial, ops.bwd_dq, ops.bwd_dkv)


def _ring_case(kernels, fa, ra, shape, dtype, causal, seed) -> dict:
    """The flash ring of RING_RANKS virtual ranks in lockstep
    (``ring_attention.ring_lockstep``, the distributed ring's own hop
    functions) on the kernels, against (i) the same hops through the
    plain versions at the plan's kv tile and (ii) ``flash_attention``
    over the whole sequence; the launches by mainloop; with ``causal``,
    every hop whose kv shard is wholly in its queries' future alone: l
    and dq exactly 0, o finite."""
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    seq, n = s // RING_RANKS, RING_RANKS
    loop = "wgmma" if dtype == torch.bfloat16 else "f32"
    kv_tile = kernels.flash_plan_for("fwd", *(_ring_shards(t, 0, seq)
                                             for t in (q, k, v))).kv_tile
    case = f"{tuple(shape)} {dtype} causal={causal}"
    before = dict(kernels.flash_launches)
    got = _on_card(f"ring_kernels: the ring at {case}",
                   lambda: ra.ring_lockstep(q, k, v, do, n, causal=causal))
    took = {key: c - before[key] for key, c in kernels.flash_launches.items()
            if c != before[key]}
    want = {f"{kind}.{loop}": n * n for kind in ("fwd", "bwd_dq", "bwd_dkv")}
    if took != want:
        fail(f"ring_kernels: the ring at {case} launched {took}, want {want}")
    plain = ra.ring_lockstep(q, k, v, do, n, causal=causal,
                             ops=ra.plain_hop_ops(kv_tile))
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qq, kk, vv, causal=causal)
    out.backward(do)
    full = (out.detach(), qq.grad, kk.grad, vv.grad)
    err_plain, rows_plain = _ring_compare(f"{case} against the plain hops",
                                          got, plain, dtype, seq)
    full_limits = (RING_FULL_ROW_LIMIT, RING_FULL_MEAN_LIMIT)
    err_full, rows_full = _ring_compare(
        f"{case} against flash_attention over the whole sequence", got,
        full, dtype, seq, full_limits)
    faults = {}
    for fault in RING_FAULTS:
        bad = ra.ring_lockstep(q, k, v, do, n, causal=causal,
                               ops=_faulty_hop_ops(ra, fa, fault, seq))
        _, rows_bad, misses = _ring_errors(bad, full, dtype, seq,
                                           full_limits)
        if not misses:
            fail(f"ring_kernels: the ring with a {fault} planted passes "
                 f"the comparison with flash_attention ({case}): the "
                 f"limits cannot see that fault")
        faults[fault] = {"row_rel_err_vs_flash_attention": rows_bad,
                         "blocks_missing_the_limit": len(misses)}
    future = 0
    if causal:
        scale = 1.0 / math.sqrt(d)
        stats = torch.zeros((b, h, seq, 1), device="cuda")
        for r in range(n):
            for owner in range(r + 1, n):
                qs, ks, vs, ds = (_ring_shards(t, i, seq) for t, i in
                                  ((q, r), (k, owner), (v, owner), (do, r)))
                po, _, pl = ra.HOP_KERNELS.partial(
                    qs, ks, vs, r * seq, owner * seq, causal=True,
                    scale=scale)
                dq = ra.HOP_KERNELS.bwd_dq(qs, ks, vs, ds, stats, stats,
                                           r * seq, owner * seq, causal=True,
                                           scale=scale)
                if pl.abs().max().item() != 0.0 or \
                        dq.abs().max().item() != 0.0 or \
                        not torch.isfinite(po).all():
                    fail(f"ring_kernels: the future shard {owner} of "
                         f"virtual rank {r} gave l or dq != 0 or o "
                         f"non-finite ({case})")
                future += 1
    return {"shape_bshd": list(shape), "dtype": str(dtype).split(".")[-1],
            "causal": causal, "virtual_ranks": n, "shard": seq,
            "launches_by_mainloop": took, "kv_tile_of_plain": kv_tile,
            "max_abs_err_vs_plain_hops": err_plain,
            "max_abs_err_vs_flash_attention": err_full,
            "row_rel_err_vs_plain_hops": rows_plain,
            "row_rel_err_vs_flash_attention": rows_full,
            "planted_faults_vs_flash_attention": faults,
            "future_hops_checked": future}


def _ring_hop_timing(kernels, fa, ra, flops_mod) -> dict:
    """One hop of each of K2 (unnormalized), K3 and K4 at the shard shape
    of GPT-2 small's ring of RING_RANKS (b 4, h 12, s 256, d 64, bf16,
    the model's layout), a kv shard wholly in the past of its queries
    (the hop with the most work, every pair seen), beside the same hop
    through the plain versions and the bound; then the whole ring's
    forward and backward in lockstep beside ``flash_attention``'s over
    the whole sequence.  Timed only."""
    b, h, s, d = GPT_ATTN_SHAPE
    seq = s // RING_RANKS
    gen = torch.Generator(device="cuda").manual_seed(11)
    shard = (b, seq, h, d)
    q, k, v, do = (torch.randn(shard, device="cuda", generator=gen).to(
        torch.bfloat16).transpose(1, 2) for _ in range(4))
    kw = dict(causal=True, scale=1.0 / math.sqrt(d))
    offs = (seq, 0)          # virtual rank 1 on rank 0's shard
    kv_tile = kernels.flash_plan_for("fwd", q, k, v).kv_tile
    plain = ra.plain_hop_ops(kv_tile)
    o, m, l = plain.partial(q, k, v, *offs, **kw)
    lse = (m + torch.log(l.clamp_min(1e-30))).contiguous()
    delta = (do.float() * (o / l.clamp_min(1e-30))).sum(
        -1, keepdim=True).contiguous()
    bwd = (q, k, v, do, lse, delta, *offs)
    calls = {"K5 mha_partial": (
        lambda: ra.HOP_KERNELS.partial(q, k, v, *offs, **kw),
        lambda: plain.partial(q, k, v, *offs, **kw)),
        "K5 mha_bwd_dq": (lambda: ra.HOP_KERNELS.bwd_dq(*bwd, **kw),
                          lambda: plain.bwd_dq(*bwd, **kw)),
        "K5 mha_bwd_dkv": (lambda: ra.HOP_KERNELS.bwd_dkv(*bwd, **kw),
                           lambda: plain.bwd_dkv(*bwd, **kw))}
    pairs = b * h * seq * seq
    elems, rows = b * h * seq * d, b * h * seq * 4
    # (flops, bytes): each input read once, each output written once; K2
    # unnormalized writes o in float32
    work = {"K5 mha_partial": (4 * d * pairs, 3 * elems * 2 + elems * 4
                               + 2 * rows),
            "K5 mha_bwd_dq": (6 * d * pairs, 4 * elems * 2 + 2 * rows
                              + elems * 4),
            "K5 mha_bwd_dkv": (8 * d * pairs, 4 * elems * 2 + 2 * rows
                               + 2 * elems * 4)}
    out = {}
    for key, (kernel_fn, plain_fn) in calls.items():
        flops, nbytes = work[key]
        bound_ms, bound_by = _bound(flops_mod, flops, nbytes,
                                    flops_mod.H100_PEAK_FLOPS)
        out[key] = {"mainloop": kernels.flash_plan_for(
            RING_HOPS[key][0], q, k, v, None if key == "K5 mha_partial"
            else do).mainloop,
            "hop_shape_bhsd": [b, h, seq, d], "offsets": list(offs),
            "dtype": "bfloat16", "flops": flops, "bytes": nbytes,
            "ms": cuda_ms(kernel_fn), "plain_ms": cuda_ms(plain_fn),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library_call": "none: no one library call returns the "
                            "unnormalized (o, m, l) or one hop's dq, dk, "
                            "dv at global offsets"}
    # the whole ring (lockstep, 16 hops each way) and flash_attention at
    # full length, forward and backward, in the model's layout
    full = [torch.randn((b, s, h, d), device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(4)]
    ring_ms = cuda_ms(lambda: ra.ring_lockstep(*full, RING_RANKS,
                                               causal=True),
                      sleep=RING_SLEEP_CYCLES)
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in full[:3])

    def whole():
        fa.flash_attention(qq, kk, vv, causal=True).backward(full[3])

    return out, {"ring_fwd_bwd_ms": ring_ms,
                 "flash_attention_fwd_bwd_ms": cuda_ms(
                     whole, sleep=RING_SLEEP_CYCLES)}


def phase_ring_kernels(kernels, fa, ra, flops_mod) -> dict:
    """K5 on the card: the flash ring of RING_RANKS virtual ranks
    (``ring_lockstep``) at GPT-2 small's attention in bf16, causal and
    not, and in float32 at shards of 136, each against the plain hops and
    against whole-sequence ``flash_attention``, n² launches of each of
    K2-K4 on the mainloop ``flash_plan`` names; then one hop of each
    timed.  Returns K5's entries for the kernels line."""
    b, h, s, d = GPT_ATTN_SHAPE
    cases = [_ring_case(kernels, fa, ra, (b, s, h, d), torch.bfloat16,
                        causal, 200 + causal) for causal in (True, False)]
    cases += [_ring_case(kernels, fa, ra, RING_F32_SHAPE, torch.float32,
                         causal, 210 + causal) for causal in (True, False)]
    timing, whole = _ring_hop_timing(kernels, fa, ra, flops_mod)
    worst = max(max(c["max_abs_err_vs_plain_hops"] for c in cases), 0.0)
    results = {}
    for key, (kind, replaces) in RING_HOPS.items():
        results[key] = {
            "name": f"ring hop: {key.split()[1]} ({kind})", "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": worst,
            "tolerance": {
                "float32": dict(zip(("rtol", "atol"),
                                    FLASH_TOL[torch.float32])),
                "bfloat16_row": FLASH_BF16_ROW_LIMIT["o"],
                "bfloat16_mean_row": FLASH_BF16_MEAN_LIMIT,
                "bfloat16_vs_flash_attention": [RING_FULL_ROW_LIMIT,
                                                RING_FULL_MEAN_LIMIT]},
            **timing[key], **whole}
    emit({"phase": "ring_kernels", "cases": cases,
          "timing": {k: {f: v[f] for f in ("mainloop", "ms", "plain_ms",
                                            "bound_ms", "bound_by")}
                     for k, v in timing.items()},
          **whole})
    return results


def _sp_run(bench, argv, what, kernels, layers, k1, buckets, causal_loops):
    """One sequence-parallel main path: the bench's ``run`` graphed,
    traced; checks a finite loss, the graphed calls, K2-K4 ``layers``
    each a step (issued, on ``causal_loops``' mainloop keys, and in the
    trace), K1 ``k1`` a step and one all_reduce a bucket plus the loss's
    a step.  Returns the result."""
    args = bench.parse_args(argv)
    steps = args.num_warmup_batches + \
        args.num_batches_per_iter * args.num_iters
    reset_counts(kernels)
    with AllReduceCounter() as calls:
        result = bench.run(args, then=main_path_trace(
            what, kernels, step_trace(k1=k1, flash=layers)))
    flash = dict(kernels.flash_launches)
    if not math.isfinite(result["final_loss"]):
        fail(f"{what}: final loss {result['final_loss']}")
    check_graphed(what, result["step_calls"], steps)
    host_steps = issued_steps(result["step_calls"])
    if flash != flash_counts(kernels, causal_loops, layers * host_steps):
        fail(f"{what}: K2-K4 launches issued {flash}, want "
             f"{layers * host_steps} each of {causal_loops}")
    k1_issued = kernels.launch_totals(kernels.fused_update_launches)
    if sum(k1_issued.values()) != k1 * host_steps:
        fail(f"{what}: K1 launches issued {k1_issued}")
    result["allreduce_calls"] = calls.check(what, result["step_calls"],
                                            buckets + 1)
    result["k2_k4_launches_issued"] = {k: v for k, v in flash.items() if v}
    result["steps"] = steps
    return result


def phase_gpt_sp_main_path(htt, kernels, card, none) -> dict:
    """``examples.gpt_synthetic_benchmark.run`` at its defaults (GPT-2
    small, batch 4, seq 1024, bf16, fused Adam) with ``--seq-parallel
    ring`` (K2 unnormalized a hop, K3 and K4: the flash ring of one rank)
    and then ``--seq-parallel ulysses`` (K2 normalized), world size 1 over
    NCCL, graphed: the main path's checks, 12 of each of K2-K4 a step on
    TMA + wgmma, and the final loss against the data-parallel run's
    (``none``, gpt_main_path's, same seeds and steps) within the bf16 GPT
    limit.  Returns the ring run's trace."""
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb
    from horovod_tpu_torch.models import gpt2_small

    buckets = fusion_buckets(gpt2_small)
    out = {}
    for sp in ("ring", "ulysses"):
        what = f"gpt_sp_main_path --seq-parallel {sp}"
        res = _sp_run(gb, ["--seq-parallel", sp], what, kernels, 12, 1,
                      buckets, GPT_BF16_FLASH)
        rel = abs(res["final_loss"] - none["final_loss"]) / \
            abs(none["final_loss"])
        if rel > GPT_BF16_LOSS_RTOL:
            fail(f"{what}: final loss {res['final_loss']} against the "
                 f"data-parallel run's {none['final_loss']} ({rel:.3g} "
                 f"relative, limit {GPT_BF16_LOSS_RTOL})")
        out[sp] = {"seq_sec_per_chip": res["seq_sec_per_chip"],
                   "mfu": res["mfu"], "final_loss": res["final_loss"],
                   "loss_rel_diff_vs_none": rel, "steps": res["steps"],
                   "step_calls": res["step_calls"],
                   "k2_k4_launches_issued": res["k2_k4_launches_issued"],
                   "allreduce_calls": res["allreduce_calls"],
                   "trace": res["then"]}
    emit({"phase": "gpt_sp_main_path", "model": "gpt2_small",
          "batch": 4, "seq_len": 1024, "dtype": "bfloat16",
          "world_size": htt.size(), "runs": out,
          "none_seq_sec_per_chip": none["seq_sec_per_chip"],
          "none_final_loss": none["final_loss"],
          "loss_rtol": GPT_BF16_LOSS_RTOL, "card": card})
    return out["ring"]["trace"]


def phase_bert_sp_main_path(htt, kernels, card, base) -> None:
    """The BERT bench at full size with ``--attn pallas --seq-parallel
    ring`` (non-causal flash ring of one rank), cut as bert_adasum (the
    warm-up, the capture, 2 replays) so the script stays inside its
    time: the main path's checks, 12 of each of K2-K4 a step on TMA +
    wgmma, no K1, and the final loss against the same cut without
    sequence parallelism (``base``, bert_adasum's default run) within the
    bf16 limit."""
    from horovod_tpu_torch.examples import bert_synthetic_benchmark as bb
    from horovod_tpu_torch.models import bert_base

    what = "bert_sp_main_path --seq-parallel ring"
    res = _sp_run(bb, BERT_ADASUM_ARGV + ["--seq-parallel", "ring"], what,
                  kernels, 12, 0, fusion_buckets(bert_base), GPT_BF16_FLASH)
    rel = abs(res["final_loss"] - base["final_loss"]) / \
        abs(base["final_loss"])
    if rel > GPT_BF16_LOSS_RTOL:
        fail(f"{what}: final loss {res['final_loss']} against "
             f"{base['final_loss']} ({rel:.3g} relative)")
    emit({"phase": "bert_sp_main_path", "model": "bert_base",
          "attn": "pallas", "seq_parallel": "ring", "batch": 8,
          "seq_len": 512, "world_size": htt.size(), "steps": res["steps"],
          "cut": "the warm-up (eager), the capture, 2 replays: full depth",
          "step_calls": res["step_calls"],
          "k2_k4_launches_issued": res["k2_k4_launches_issued"],
          "allreduce_calls": res["allreduce_calls"], "trace": res["then"],
          "sent_sec_per_chip": res["sent_sec_per_chip"],
          "none_sent_sec_per_chip": base["sent_sec_per_chip"],
          "final_loss": res["final_loss"],
          "none_final_loss": base["final_loss"],
          "loss_rel_diff_vs_none": rel, "card": card})


def _model_parallel_step(device) -> dict:
    """One SGD step (0.1) each of a ParallelMLP through shard_tp_params
    (tp = 1), a pipeline of one stage over 4 microbatches and a MoE layer
    of 4 experts on one rank (ep = 1), every group the world of one, from
    weights drawn on the CPU: the losses, outputs and new parameters."""
    import torch.distributed as dist

    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.parallel import moe, pipeline
    from horovod_tpu_torch.parallel import tensor_parallel as tp

    world = dist.group.WORLD
    gen = torch.Generator().manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    out = {}
    mlp = tp.ParallelMLP(16, 64, 8, dtype=torch.float32, axis=world,
                         generator=gen).to(device)
    x, y = rnd(4, 16), rnd(4, 8)
    params = canonical_params(mlp)
    pred = mlp(x)
    loss = torch.mean((pred - y) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    out["tp/loss"], out["tp/out"] = loss, pred
    for (k, p), g in zip(params.items(), grads):
        out[f"tp/{k}"] = p - 0.1 * g
    stage = {"w": rnd(8, 8, scale=0.5).requires_grad_(),
             "b": rnd(8, scale=0.1).requires_grad_()}
    xs, ts = rnd(4, 2, 8), rnd(4, 2, 8)
    pout = pipeline.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p[
        "b"]), stage, xs, axis=world)
    loss = torch.mean((pout - ts) ** 2)
    grads = torch.autograd.grad(loss, list(stage.values()))
    out["pp/loss"], out["pp/out"] = loss, pout
    for (k, p), g in zip(stage.items(), grads):
        out[f"pp/{k}"] = p - 0.1 * g
    experts = {"w": rnd(4, 8, 16, scale=0.5).requires_grad_(),
               "v": rnd(4, 16, 8, scale=0.5).requires_grad_()}
    router = rnd(8, 4).requires_grad_()
    xt, tt = rnd(16, 8), rnd(16, 8)
    mout = moe.moe_apply(lambda p, t: torch.tanh(t @ p["w"]) @ p["v"],
                         experts, xt, router, capacity=8, axis=world)
    loss = torch.mean((mout - tt) ** 2)
    leaves = {**experts, "router": router}
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out["ep/loss"], out["ep/out"] = loss, mout
    for (k, p), g in zip(leaves.items(), grads):
        out[f"ep/{k}"] = p - 0.1 * g
    return {k: v.detach().cpu() for k, v in out.items()}


def phase_model_parallel(htt) -> None:
    """Tensor, pipeline and expert parallelism on the card with groups of
    one (``_model_parallel_step``) against the same on the CPU, float32
    with TF32 off, at the card-vs-CPU parity limits."""
    with no_tf32():
        card = _model_parallel_step("cuda")
    cpu = _model_parallel_step("cpu")
    errs = {}
    for k, want in cpu.items():
        got = card[k]
        errs[k] = (got - want).abs().max().item()
        if not torch.isfinite(got).all() or not torch.allclose(
                got, want, rtol=PARITY_RTOL, atol=PARITY_ATOL):
            fail(f"model_parallel: {k} on the card is {errs[k]} off the "
                 f"CPU's")
    emit({"phase": "model_parallel", "world_size": htt.size(),
          "cases": {"tp": "ParallelMLP 16-64-8 through shard_tp_params, "
                          "tp = 1", "pp": "pipeline_apply, S = 1, M = 4",
                    "ep": "moe_apply, ep = 1, 4 experts, capacity 8"},
          "losses": {k: cpu[k].item() for k in cpu if k.endswith("/loss")},
          "max_abs_err": errs,
          "tolerance": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL}})


# ---------------------------------------------------------------------------
# the trace plane
# ---------------------------------------------------------------------------
#: the trace window of the trace_plane phase: calls 3-5 of the GPT bench,
#: after its warm-up call (1) and the capture (2); the timeline and the
#: profiler share it
TRACE_WINDOW = (3, 5)
#: where the trace_plane phase writes its trace directories (gitignored)
TRACE_DIR = Path(__file__).resolve().parent / "build" / "trace_plane"
#: K1-K4 by the names of their ops in a make_fx DAG, and the fewest
#: inputs (in-edges) each node must have: q, k, v (and do, lse, delta);
#: p and g
DAG_OPS = {"K1": ("hvd.fused_update", 2), "K2": ("hvd.flash_fwd", 3),
           "K3": ("hvd.flash_bwd_dq", 6), "K4": ("hvd.flash_bwd_dkv", 6)}
#: the graphed rate outside the trace window may trail the untraced
#: bench's by this share at most: the mean of four runs each, in turns
TRACE_RATE_SHARE = 0.02
#: the runs after the checked one (off, then the checked run, then these);
#: one run settles at ~117 or ~120 seq/s, by chance (PERF.md §6, PR 16)
TRACE_RATE_TURNS = ("on", "off", "off", "on", "on", "off")
#: the profiled forward's FLOPs against the analytic count's third
TRACE_FLOPS_SHARE = 0.05
#: launches timed for a launch's host cost through the op and directly,
#: in rounds taken in turns (the first round of each is not kept)
OP_COST_CALLS = 100
OP_COST_ROUNDS = 6


@contextlib.contextmanager
def env_vars(values: dict):
    """``values`` set in the environment inside, as they were after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def read_gml(path):
    """``(nodes, edges)`` of a dag.gml: ``{id: (label, kind)}`` and
    ``[(source, target)]``."""
    text = Path(path).read_text()
    nodes = {int(m.group(1)): (m.group(2), m.group(3)) for m in re.finditer(
        r'node \[\s*id (\d+)\s*label "([^"]*)"(?:\s*\w+ "[^"]*")*?'
        r'\s*kind "([^"]*)"', text)}
    edges = [(int(a), int(b)) for a, b in re.findall(
        r"edge \[\s*source (\d+)\s*target (\d+)", text)]
    return nodes, edges


def _bucket_labels(factory) -> list:
    """The range names ``ops/fusion.py`` gives the buckets of the model
    ``factory()`` builds (on the meta device)."""
    from horovod_tpu_torch.convert import canonical_params
    from horovod_tpu_torch.ops import fusion

    with torch.device("meta"):
        params = canonical_params(factory())
    names = list(params)
    labels = []
    for bucket in fusion.FusionPlan(list(params.values())).buckets:
        label = "allreduce:" + ",".join(names[i] for i in bucket)
        if len(label) > fusion._NVTX_NAME_CHARS:
            label = label[:fusion._NVTX_NAME_CHARS - 3] + "..."
        labels.append(label)
    return labels


def _op_host_us(kernels, fa) -> dict:
    """Host µs to issue one K2 launch at GPT-2 small's shape: through its
    wrapper directly, as the training path calls it (no dispatch mode on:
    the wrapper after one check) and through the op ``hvd::flash_fwd``
    (what make_fx and FlopCounterMode see): the median
    over rounds of OP_COST_CALLS launches, each round queued behind a
    sleeping kernel so no launch waits for the card."""
    q, k, v, _ = _flash_inputs(*GPT_ATTN_SHAPE[:3], GPT_ATTN_SHAPE[2],
                               GPT_ATTN_SHAPE[3], torch.bfloat16, 5)
    ways = {"direct": lambda: kernels.launch_flash_fwd(
                q, k, v, causal=True, scale=0.125),
            "path": lambda: fa._mha_fwd(q, k, v, causal=True, scale=0.125),
            "op": lambda: torch.ops.hvd.flash_fwd(q, k, v, True, 0.125, 0,
                                                  0, True)}
    runs = {name: [] for name in ways}
    for _ in range(OP_COST_ROUNDS):  # the two ways in turns
        for name, fn in ways.items():
            torch.cuda.synchronize()
            torch.cuda._sleep(RING_SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(OP_COST_CALLS):
                fn()
            runs[name].append((time.perf_counter() - t0) / OP_COST_CALLS
                              * 1e6)
            torch.cuda.synchronize()
    return {name: statistics.median(v[1:]) for name, v in runs.items()}


def _trace_plane_gpt(htt, kernels, card, none) -> dict:
    """The GPT bench with the whole trace plane on; returns the checks'
    numbers.  See phase_trace_plane."""
    import shutil

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb
    from horovod_tpu_torch.models import gpt2_small
    from horovod_tpu_torch.timeline.profiler import CUDA_TRACE_DIR
    from horovod_tpu_torch.timeline.recorder import Recorder
    from horovod_tpu_torch.timeline.timeline import timeline
    from horovod_tpu_torch.utils import flops as flops_mod

    what = "trace_plane"
    start, end = TRACE_WINDOW
    trace_dir = TRACE_DIR / "gpt"
    shutil.rmtree(trace_dir, ignore_errors=True)
    if not metrics.on():
        fail(f"{what}: the metrics registry is off")
    args = gb.parse_args([])
    k = args.num_in_graph_steps
    steps = args.num_warmup_batches + \
        args.num_batches_per_iter * args.num_iters
    seen = {}

    def plane(into) -> dict:
        """The trace plane's environment, its files under ``into``."""
        return {"HVD_TRACE_DIR": str(into),
                "HVD_TRACE_START_STEP": str(start),
                "HVD_TRACE_END_STEP": str(end), "HVD_PROFILE": "1",
                "HVD_PROFILE_XLA": "1"}

    def outside(into=None) -> float:
        """The bench's seq/s after the window (iterations 2 and 3), with
        the trace plane on into ``into``, or off."""
        if into is not None:
            shutil.rmtree(into, ignore_errors=True)
        with env_vars(plane(into) if into is not None else {}):
            if into is not None:
                timeline.initialize()
            return statistics.mean(gb.run(gb.parse_args([]))["rates"][1:])

    def then(step, state, x, y):
        seen["issued"] = host_launches(kernels)
        seen["flash"] = dict(kernels.flash_launches)
        seen["losses"] = list(step.profile_losses)
        seen["anatomy"] = step.profiler.anatomy
        seen["steps_total"] = metrics.STEPS_TOTAL.get()
        seen["calls"] = dict(step.calls)
        # the DAG of the step, traced on the card (make_fx runs it once;
        # the recorder puts the state back)
        t0 = time.perf_counter()
        Recorder().record_step_function(step.eager, state, x, y)
        seen["dag_s"] = time.perf_counter() - t0
        return {}

    turns = {"off": [outside()], "on": []}
    metrics.registry.reset()
    with env_vars(plane(trace_dir)):
        # the world is up already: open the timeline as init would
        timeline.initialize()
        writer = timeline.writer_kind
        reset_counts(kernels)
        t0 = time.perf_counter()
        result = gb.run(args, then=then)
        wall = time.perf_counter() - t0
    turns["on"].append(statistics.mean(result["rates"][1:]))
    for i, mode in enumerate(TRACE_RATE_TURNS):
        turns[mode].append(outside(TRACE_DIR / f"gpt_turn{i}"
                                   if mode == "on" else None))
    rank_dir = trace_dir / "0"

    # 1. comm.json: the native writer's, one STEP span a call of the
    # window, closed after the end step
    if writer != "native":
        fail(f"{what}: the timeline opened the {writer} writer, not the "
             "native one (csrc/timeline.cc)")
    if timeline.active:
        fail(f"{what}: the timeline is still open after its end step")
    comm = json.loads((rank_dir / "comm.json").read_text())
    step_spans = [e for e in comm if e.get("name") == "STEP"]
    if len(step_spans) != end - start + 1 or \
            any(e.get("cat") != "train_step" for e in step_spans):
        fail(f"{what}: comm.json holds {len(step_spans)} STEP spans, want "
             f"{end - start + 1} (calls {start}-{end})")

    # 2. compute.json: the four segments once a profiled step each; K1-K4
    # ran in them; the forward's FLOPs against the analytic count
    profiled = end - start + 1
    compute = json.loads((rank_dir / "compute.json").read_text())
    anatomy = compute["anatomy"]
    segs = anatomy["segments"]
    names = ("forward", "backward", "grad_allreduce", "optimizer_update")
    if sorted(segs) != sorted(names) or anatomy["steps"] != profiled or \
            any(segs[n]["count"] != profiled * k for n in names):
        fail(f"{what}: compute.json segments "
             f"{ {n: d['count'] for n, d in segs.items()} } over "
             f"{anatomy['steps']} steps, want each of {names} "
             f"{profiled * k} times over {profiled}")
    layers, hidden, seq = 12, 768, args.seq_len
    from horovod_tpu_torch.convert import canonical_params

    with torch.device("meta"):
        n_params = flops_mod.param_count(canonical_params(gpt2_small()))
    analytic = flops_mod.transformer_train_flops_per_seq(
        n_params, layers, hidden, seq, causal=True) * args.batch_size / 3
    fwd_flops = segs["forward"]["flops"] / segs["forward"]["count"]
    if abs(fwd_flops / analytic - 1) > TRACE_FLOPS_SHARE:
        fail(f"{what}: the forward segment counted {fwd_flops:.4g} FLOPs "
             f"a step, the analytic count {analytic:.4g}")
    if not (anatomy["mfu"] is not None and math.isfinite(anatomy["mfu"])
            and math.isfinite(anatomy["host_gap"]["per_step_us"])):
        fail(f"{what}: mfu {anatomy['mfu']}, host gap "
             f"{anatomy['host_gap']}")
    # the launches the wrappers issued: the warm-up and the capture a
    # step each, the segments' first run and the window's calls, each
    # running the forward twice (its own segment and the backward's)
    chains = profiled * k + 1
    want = {"K1": 2 * k + chains, "K2": layers * (2 * k + 2 * chains),
            "K3": layers * (2 * k + chains),
            "K4": layers * (2 * k + chains)}
    got = {key: seen["issued"][key] for key in want}
    mainloops = {key.split(".")[1] for key, n in seen["flash"].items() if n}
    if got != want or mainloops != {"wgmma"}:
        fail(f"{what}: K1-K4 issued {got} on {mainloops}, want {want} on "
             "wgmma")

    # 3. metrics.json, dumped when the end step closed the timeline
    snap = json.loads((rank_dir / "metrics.json").read_text())["metrics"]

    def sample(name, **labels):
        for s in snap[name]["samples"]:
            if s["labels"] == labels:
                return s["value"]
        return None

    closed_at = end + 1
    traced = sample("hvd_collectives_traced_total", op="allreduce")
    traced_bytes = sample("hvd_collectives_traced_bytes_total",
                          op="allreduce")
    buckets = fusion_buckets(gpt2_small)
    if sample("hvd_steps_total") != closed_at * k:
        fail(f"{what}: metrics.json hvd_steps_total "
             f"{sample('hvd_steps_total')}, want {closed_at * k} (the "
             f"calls when call {closed_at} closed the timeline)")
    # the traced inventory is the reference's: the loss's all-reduce once
    # a recorded program (the capture and the segments' first run); the
    # fused buckets reduce without it, as the reference's lax.psum does
    if (traced, traced_bytes) != (2, 8):
        fail(f"{what}: traced all-reduces {traced} ({traced_bytes} bytes),"
             " want 2 (the loss, at the capture and at the segments' "
             "first run; 8 bytes)")
    if sample("hvd_train_loss") != seen["losses"][-1]:
        fail(f"{what}: metrics.json hvd_train_loss "
             f"{sample('hvd_train_loss')}, want the last loss "
             f"{seen['losses'][-1]}")
    if seen["steps_total"] != steps * k:
        fail(f"{what}: hvd_steps_total {seen['steps_total']} after the "
             f"run, want {steps * k}")

    # 4. the DAG: one node per launch of K1-K4, with edges from inputs
    nodes, edges = read_gml(rank_dir / "dag.gml")
    indeg = {}
    for _, t in edges:
        indeg[t] = indeg.get(t, 0) + 1
    dag = {}
    for key, (label, ins) in DAG_OPS.items():
        ids = [i for i, (lab, _) in nodes.items() if lab == label]
        dag[key] = {"nodes": len(ids),
                    "min_inputs": min((indeg.get(i, 0) for i in ids),
                                      default=0)}
    want_dag = {"K1": 1, "K2": layers, "K3": layers, "K4": layers}
    if any(dag[key]["nodes"] != n or dag[key]["min_inputs"] <
           DAG_OPS[key][1] for key, n in want_dag.items()):
        fail(f"{what}: dag.gml holds {dag}, want {want_dag} nodes with "
             f"{ {key: v[1] for key, v in DAG_OPS.items()} } inputs each")

    # 5. the CUPTI trace of the window: K1-K4 by name, one range a bucket
    trace = json.loads((rank_dir / CUDA_TRACE_DIR / "trace.json")
                       .read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernel_names = [e.get("name", "") for e in events
                    if e.get("cat") == "kernel"]
    in_trace = {key: sum(any(p in n for p in TRACE_KERNELS[key])
                         for n in kernel_names)
                for key in ("K1", "K2", "K3", "K4")}
    ranges = [e.get("name", "") for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("allreduce:")]
    labels = _bucket_labels(gpt2_small)
    want_ranges = sorted(labels * chains)
    if min(in_trace.values()) < 1 or sorted(ranges) != want_ranges:
        fail(f"{what}: the window's trace holds K1-K4 {in_trace} and "
             f"{len(ranges)} bucket ranges, want each kernel and "
             f"{len(want_ranges)} ranges ({buckets} buckets x {chains} "
             "chains) named after their tensors")

    # 6. the run's final loss: the window left the graph's state sound
    rel = abs(result["final_loss"] - none["final_loss"]) / \
        abs(none["final_loss"])
    if rel > GPT_BF16_LOSS_RTOL:
        fail(f"{what}: final loss {result['final_loss']} against "
             f"gpt_main_path's {none['final_loss']} ({rel:.3g} relative, "
             f"limit {GPT_BF16_LOSS_RTOL})")
    # 7. the graphed rate outside the window (iterations 2 and 3), the
    # runs with the trace plane on against those with it off, in turns
    on, off = (statistics.mean(turns[mode]) for mode in ("on", "off"))
    share = on / off - 1
    if share < -TRACE_RATE_SHARE:
        fail(f"{what}: {on:.2f} seq/s outside the window against {off:.2f}"
             f" with the trace plane off, in turns ({share:+.2%}, limit "
             f"-{TRACE_RATE_SHARE:.0%}; runs {turns})")
    return {
        "trace_dir": str(trace_dir.relative_to(TRACE_DIR.parents[1])),
        "writer": writer, "window": list(TRACE_WINDOW),
        "step_spans": len(step_spans), "comm_events": len(comm),
        "segments": {n: {key: segs[n][key] for key in (
            "count", "per_step_us", "flops", "bytes", "verdict")}
            for n in names},
        "mfu": anatomy["mfu"], "host_gap": anatomy["host_gap"],
        "profiled_wall_us_per_step": anatomy["wall_us"] / profiled,
        "forward_flops": fwd_flops, "analytic_forward_flops": analytic,
        "forward_flops_ratio": fwd_flops / analytic,
        "k1_k4_issued": got, "metrics_steps_total": closed_at * k,
        "traced_allreduce": traced, "fusion_buckets": buckets,
        "train_loss": seen["losses"][-1], "profile_losses": seen["losses"],
        "dag": dag, "dag_nodes": len(nodes), "dag_edges": len(edges),
        "dag_seconds": seen["dag_s"], "cuda_trace_kernels": in_trace,
        "bucket_ranges": len(ranges), "final_loss": result["final_loss"],
        "loss_rel_diff_vs_main_path": rel,
        "seq_sec_per_chip_iterations": result["rates"],
        "seq_sec_per_chip_outside_window_in_turns": turns,
        "rate_share_in_turns": share,
        "main_path_seq_sec_per_chip": none["seq_sec_per_chip"],
        "step_calls": seen["calls"], "wall_s": wall}


def _trace_plane_frontend(card, frontend_rate) -> dict:
    """The frontend's per-tensor trace: the PyTorch bench at its defaults
    with HVD_TIMELINE set, in turns with it unset (off, on, on, off)."""
    import collections
    import shutil

    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as pb
    from horovod_tpu_torch.timeline.timeline import timeline

    what = "trace_plane frontend"
    args = pb.parse_args([])
    steps = args.num_warmup_batches + \
        args.num_batches_per_iter * args.num_iters
    rates = {"off": [], "on": []}
    checked = []
    for i, mode in enumerate(("off", "on", "on", "off")):
        trace_dir = TRACE_DIR / f"frontend{i}"
        shutil.rmtree(trace_dir, ignore_errors=True)
        env = {"HVD_TIMELINE": str(trace_dir)} if mode == "on" else {}
        with env_vars(env):
            timeline.initialize()
            writer = timeline.writer_kind
            with cudnn_benchmark(False):
                result = pb.run(args)
            timeline.shutdown()
        rates[mode].append(result["img_sec_per_proc"])
        if mode == "off":
            continue
        rank_dir = trace_dir / "0"
        comm = json.loads((rank_dir / "comm.json").read_text())
        grads = json.loads((rank_dir / "gradient_name_list.json")
                           .read_text())
        spans = collections.Counter(e["tid"] for e in comm
                                    if e.get("name") == "MESH_ALLREDUCE")
        want = {"allreduce." + n[len("gradients/"):]: steps for n in grads}
        if writer != "native" or len(grads) != 161 or dict(spans) != want:
            fail(f"{what}: {writer} writer, {len(grads)} gradient names, "
                 f"{len(spans)} tensors with spans (counts "
                 f"{sorted(set(spans.values()))}), want the native writer "
                 f"and one MESH_ALLREDUCE span a step ({steps}) for each "
                 "of 161 parameters named as gradient_name_list.json "
                 "names them")
        checked.append({"trace_dir": str(trace_dir.relative_to(
            TRACE_DIR.parents[1])), "writer": writer,
            "spans": sum(spans.values()), "final_loss": result["final_loss"]})
    return {"steps": steps, "parameters": 161, "runs": checked,
            "img_sec_per_chip_traced": rates["on"],
            "img_sec_per_chip_untraced_in_turns": rates["off"],
            "traced_share": statistics.mean(rates["on"])
            / statistics.mean(rates["off"]) - 1,
            "img_sec_per_chip_frontend_main_path": frontend_rate}


def _profiled_window_alone() -> dict:
    """The same profiled window without the CUPTI capture (no
    HVD_PROFILE_XLA, no timeline): the GPT bench cut to its 2 warm-up
    calls and 3 more, the window over calls 3-5.  Its segments' ms a
    step, to set beside the captured window's."""
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    start, end = TRACE_WINDOW
    seen = {}

    def then(step, state, x, y):
        seen["anatomy"] = step.profiler.finalize()

    with env_vars({"HVD_TRACE_DIR": str(TRACE_DIR / "gpt_no_capture"),
                   "HVD_PROFILE": "1", "HVD_PROFILE_START_STEP": str(start),
                   "HVD_PROFILE_END_STEP": str(end)}):
        gb.run(gb.parse_args(["--num-iters", "1",
                              "--num-batches-per-iter",
                              str(end - start + 1)]), then=then)
    an = seen["anatomy"]
    if an is None or an["steps"] != end - start + 1:
        fail(f"trace_plane: the window without the capture gave {an}")
    return {"wall_us_per_step": an["wall_us"] / an["steps"],
            "mfu": an["mfu"], "host_gap_per_step_us":
            an["host_gap"]["per_step_us"],
            "segments_us_per_step": {n: d["per_step_us"]
                                     for n, d in an["segments"].items()}}


def phase_trace_plane(htt, kernels, fa, card, none, frontend_rate) -> None:
    """The trace plane on the GPT main path (module docstring, phase
    27), the profiled window again without the CUPTI capture, then the
    frontend's per-tensor communication trace, then a K2 launch's host
    cost by route."""
    gpt = _trace_plane_gpt(htt, kernels, card, none)
    alone = _profiled_window_alone()
    frontend = _trace_plane_frontend(card, frontend_rate)
    emit({"phase": "trace_plane", "model": "gpt2_small", "batch": 4,
          "seq_len": 1024, "dtype": "bfloat16", "world_size": htt.size(),
          "gpt": gpt, "window_without_capture": alone, "frontend": frontend,
          "k2_host_us_per_launch": _op_host_us(kernels, fa), "card": card})


# ---------------------------------------------------------------------------
# the tuners on the card (phase 28)
# ---------------------------------------------------------------------------
#: where the autotune phase writes its GP log and its trace
AUTOTUNE_DIR = Path(__file__).resolve().parent / "build" / "autotune"
#: the GP's settings in autotune (a): one warm-up sample, a sample every
#: AUTOTUNE_SPS calls, no freezing inside the run
AUTOTUNE_SPS = 5
AUTOTUNE_ENV = {"HVD_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HVD_AUTOTUNE_STEPS_PER_SAMPLE": str(AUTOTUNE_SPS),
                "HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "100"}
#: distinct fusion thresholds the GP must have scored
AUTOTUNE_SCORED = 3
#: memory allocated after the last capture against after the first
AUTOTUNE_MEMORY_SHARE = 0.05
#: autotune (b): the profile-guided loop's windows (calls), the
#: profiler's window (calls; after the first graph's traced replays),
#: the calls driven, the host batches cycled and the ones checked
PG_WINDOW = 9
PG_PROFILE = (5, 6)
PG_CALLS = 26
PG_HOST_BATCHES = 3


def _builds_calls(step) -> list:
    return [dict(b["calls"]) for b in step.builds]


def _ran(step, before: list):
    """``(build, kind)`` of the call made since ``before``
    (``_builds_calls``): the build whose own counter moved, and how it
    ran; a profiled call moves none (``None, "profiled"``)."""
    for i, b in enumerate(step.builds):
        prev = before[i] if i < len(before) else dict.fromkeys(b["calls"], 0)
        for kind, n in b["calls"].items():
            if n != prev[kind]:
                return i, kind
    return None, "profiled"


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, benchmark mode off, inside."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved


def _gpt_tuning_run(htt, kernels, autotune: bool, calls: int = None):
    """GPT-2 small (b 4, s 1024, bf16, flash K2-K4, K1 Adam) through
    ``make_train_step(autotune=autotune)``, one synced call at a time:
    with the GP on, until it has scored AUTOTUNE_SCORED thresholds (2
    replays of each new graph traced after its capture), else ``calls``
    calls.  Returns the calls (kind, build, host ms, loss, memory after
    a capture), the traces, the step and the GP's log rows."""
    from horovod_tpu_torch.models import gpt2_small, next_token_loss

    log_file = AUTOTUNE_DIR / "gpt_autotune.csv"
    log_file.unlink(missing_ok=True)
    model = on_card(gpt2_small, dtype=torch.bfloat16, max_len=1024)
    opt = htt.fused_adam(1e-4)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1000, size=(4, 1024))).cuda()
    step = htt.make_train_step(apply_fn=model, loss_fn=next_token_loss,
                               optimizer=opt, autotune=autotune,
                               autotune_log_file=str(log_file),
                               loss_fetch_steps=0)
    state = htt.init_train_state(model, opt)
    rows, traces, scored = [], [], []
    while True:
        before = _builds_calls(step)
        t0 = time.perf_counter()
        state, loss = step(state, ids, ids)
        value = loss.item()
        build, kind = _ran(step, before)
        row = {"kind": kind, "build": build,
               "host_ms": (time.perf_counter() - t0) * 1e3, "loss": value}
        rows.append(row)
        if row["kind"] == "capture":
            row["memory_allocated"] = torch.cuda.memory_allocated()
            if autotune:
                state, loss, _, spans = trace_replays(
                    f"autotune: build {build}", kernels, step, state,
                    (ids, ids), TRACED_CALLS)
                traces.append((build, spans))
                rows += [{"kind": "replay", "build": build, "traced": True,
                          "loss": None}] * TRACED_CALLS
        if autotune:
            scored = [r.split(",") for r in
                      log_file.read_text().splitlines()[1:]] \
                if log_file.exists() else []
            if len({r[1] for r in scored}) >= AUTOTUNE_SCORED:
                break
            if len(rows) > 12 * AUTOTUNE_SPS:
                fail(f"autotune: the GP scored {scored} in {len(rows)} calls")
        elif len(rows) >= calls:
            break
    return rows, traces, step, state, scored


def _autotune_gpt(htt, kernels) -> dict:
    """autotune (a): see the module docstring, phase 28."""
    what = "autotune (a)"
    reset_counts(kernels)
    with env_vars(AUTOTUNE_ENV):
        rows, traces, step, state, scored = _gpt_tuning_run(htt, kernels,
                                                            True)
    flash = dict(kernels.flash_launches)
    k1 = kernels.launch_totals(kernels.fused_update_launches)
    pm = step.parameter_manager
    builds = step.builds
    sigs = [(b["threshold"], b["hierarchical"]) for b in builds]
    # one capture a knob signature that ran twice, and no more
    per_build = {}
    for r in rows:
        per_build.setdefault(r["build"], []).append(r["kind"])
    for b, kinds in per_build.items():
        if kinds[:2] != ["eager", "capture"] or \
                any(k != "replay" for k in kinds[2:]):
            fail(f"{what}: build {b} {sigs[b]} ran {kinds}")
    captured = [sigs[b] for b in per_build]
    if step.calls["capture"] != len(per_build) or \
            len(set(captured)) != len(captured):
        fail(f"{what}: {step.calls['capture']} captures for the knob "
             f"signatures {captured}")
    # each captured graph: K1 once a step, K2-K4 12 times, in 2 replays
    want = {key: n * TRACED_CALLS for key, n in
            step_trace(flash=12).items()}
    for b, spans in traces:
        if trace_launches(spans) != want:
            fail(f"{what}: build {b}'s replays hold {trace_launches(spans)}"
                 f", want {want}")
    issued = step.calls["eager"] + step.calls["capture"]
    if k1 != {"sgd": 0, "momentum": 0, "adam": issued} or \
            flash != flash_counts(kernels, GPT_BF16_FLASH, 12 * issued):
        fail(f"{what}: launches issued K1 {k1}, K2-K4 {flash} over "
             f"{issued} eager and captured calls")
    mem = [r["memory_allocated"] for r in rows if r["kind"] == "capture"]
    if abs(mem[-1] - mem[0]) > AUTOTUNE_MEMORY_SHARE * mem[0]:
        fail(f"{what}: memory allocated after each capture {mem}")
    # the same run untuned: its losses, call by call
    plain_rows, _, plain, _, _ = _gpt_tuning_run(
        htt, kernels, False, calls=len(rows))
    if plain.calls != {"eager": 1, "capture": 1, "replay": len(rows) - 2} \
            or len(plain_rows) != len(rows):
        fail(f"{what}: the untuned run's calls {plain.calls}")
    # call by call (a traced replay's loss is not read); a knob whose
    # build changes a loss is held to the graphed-vs-eager limit
    differ = [{"call": i + 1, "tuned": r["loss"], "untuned": p["loss"],
               "knobs": sigs[r["build"]], "kind": r["kind"]}
              for i, (r, p) in enumerate(zip(rows, plain_rows))
              if r["loss"] is not None and r["loss"] != p["loss"]]
    worst = max((abs(d["tuned"] - d["untuned"]) / abs(d["untuned"])
                 for d in differ), default=0.0)
    if worst > GPT_LOSS_RTOL or any(
            not math.isfinite(r["loss"]) for r in rows
            if r["loss"] is not None):
        fail(f"{what}: losses differ from the untuned run's beyond the "
             f"graphed-vs-eager limit {GPT_LOSS_RTOL}: {differ}")

    def rate(build):
        ms = [r["host_ms"] for r in rows if r["build"] == build and
              r["kind"] == "replay" and not r.get("traced")]
        return 4 / (statistics.median(ms) / 1e3) if ms else None

    # the GP's own reading: a score is the gradient bytes over a synced
    # call's seconds (the sample's median), so seq/s = 4 · score / bytes
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in state.params.values())
    seq_sec = [4 * float(r[3]) / grad_bytes for r in scored]

    rebuild_ms = {str(b): sum(r["host_ms"] for r in rows if r["build"] == b
                              and r["kind"] in ("eager", "capture"))
                  for b in per_build}
    return {"calls": len(rows), "step_calls": dict(step.calls),
            "knob_signatures": [list(s) for s in captured],
            "gp_scores": [{"threshold": int(r[1]),
                           "hierarchical": bool(int(r[2])),
                           "score_bytes_per_sec": float(r[3])}
                          for r in scored],
            "rebuild_host_ms_eager_plus_capture": rebuild_ms,
            "capture_host_ms": [r["host_ms"] for r in rows
                                if r["kind"] == "capture"],
            "memory_allocated_after_capture": mem,
            "seq_sec_before_tuning": seq_sec[0],
            "seq_sec_best_scored": max(seq_sec),
            "seq_sec_synced_replays_first_build": rate(0),
            "seq_sec_synced_replays_last_build": rate(max(per_build)),
            "losses_bit_equal_untuned": not differ,
            "loss_differences": differ[:8], "loss_max_rel_diff": worst,
            "trace_per_graph": want, "frozen": pm.frozen}


def _resnet_pg_run(htt, kernels, host, tuned: bool):
    """ResNet-50 (b 128, bf16, fused_sgd momentum on the per-leaf path)
    for PG_CALLS calls, its batches through prefetch_to_device; tuned:
    with the trace, the profiler and the profile-guided loop (the first
    graph's and each new graph's 2 replays traced after its capture).
    Returns the calls, the traces, the step and the prefetcher."""
    import torch.nn.functional as F

    from horovod_tpu_torch.data.loader import prefetch_to_device
    from horovod_tpu_torch.models import ResNet50

    model = on_card(ResNet50, dtype=torch.bfloat16).to(
        memory_format=torch.channels_last)
    opt = htt.fused_sgd(0.01, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, has_batch_stats=True,
                               fused_optimizer=False, loss_fetch_steps=0,
                               profile_guided=tuned)
    state = htt.init_train_state(model, opt, has_batch_stats=True)

    def batches():
        for i in range(PG_CALLS):
            yield host[i % len(host)]

    it = prefetch_to_device(batches(), 2)
    rows, traces, checked = [], [], 0
    pending = iter(it)
    while True:
        try:
            x, y = next(pending)
        except StopIteration:
            break
        i = len(rows)
        if checked < PG_HOST_BATCHES and tuned:
            hx, hy = host[i % len(host)]
            if not (torch.equal(x.cpu(), torch.from_numpy(hx))
                    and torch.equal(y.cpu(), torch.from_numpy(hy))):
                fail(f"autotune (b): prefetched batch {i} differs from the "
                     "host batch")
            checked += 1
        before = _builds_calls(step)
        k1_before = sum(kernels.fused_update_launches.values())
        state, loss = step(state, x, y)
        build, kind = _ran(step, before)
        rows.append({"kind": kind, "build": build,
                     "loss": loss.item(), "k1_issued": sum(
                         kernels.fused_update_launches.values()) - k1_before,
                     "phase": step.profile_guided_tuner.phase
                     if tuned else None})
        if tuned and rows[-1]["kind"] == "capture" and \
                len(rows) + TRACED_CALLS <= PG_CALLS:
            # the next calls, on their own batches, traced: replays that
            # issue no launch of their own
            batches_ = [next(pending) for _ in range(TRACED_CALLS)]
            before, issued = dict(step.calls), host_launches(kernels)

            def run(st=state):
                losses = []
                for bx, by in batches_:
                    st, out = step(st, bx, by)
                    losses.append(out)
                return st, losses

            (state, losses), _, spans = profiled(run)
            if step.calls != {**before,
                              "replay": before["replay"] + TRACED_CALLS} \
                    or host_launches(kernels) != issued:
                fail(f"autotune (b): build {build}'s traced calls "
                     f"{before} -> {step.calls}")
            traces.append((build, spans))
            rows += [{"kind": "replay", "build": build, "loss": t.item(),
                      "traced": True} for t in losses]
    return rows, traces, step, it, checked


def _autotune_resnet(htt, kernels) -> dict:
    """autotune (b): see the module docstring, phase 28."""
    import shutil

    from horovod_tpu_torch.optim.compute_knobs import (
        KNOB_FUSED_OPTIMIZER, compute_plans_from_anatomy,
    )
    from horovod_tpu_torch.timeline.replay import analyze
    from horovod_tpu_torch.timeline.timeline import timeline

    what = "autotune (b)"
    trace_dir = AUTOTUNE_DIR / "resnet"
    shutil.rmtree(trace_dir, ignore_errors=True)
    rng = np.random.default_rng(0)
    host = [(rng.random((128, 224, 224, 3), dtype=np.float32),
             rng.integers(0, 1000, size=128).astype(np.int64))
            for _ in range(PG_HOST_BATCHES)]
    env = {"HVD_TRACE_DIR": str(trace_dir), "HVD_PROFILE": "1",
           "HVD_PROFILE_START_STEP": str(PG_PROFILE[0]),
           "HVD_PROFILE_END_STEP": str(PG_PROFILE[1]),
           "HVD_AUTOTUNE_PROFILE_GUIDED": "1",
           "HVD_AUTOTUNE_WINDOW_STEPS": str(PG_WINDOW)}
    reset_counts(kernels)
    with deterministic_cudnn(), env_vars(env):
        # the world is up already: open the timeline as init would
        timeline.initialize()
        rows, traces, step, it, checked = _resnet_pg_run(htt, kernels,
                                                         host, True)
        timeline.shutdown()
    tuner = step.profile_guided_tuner
    anatomy = step.profiler.anatomy
    if it.stream is None or it.stream == torch.cuda.default_stream() or \
            checked != PG_HOST_BATCHES:
        fail(f"{what}: the batches were copied on {it.stream}, "
             f"{checked} checked")
    history = tuner.history
    outcomes = [h["outcome"] for h in history]
    if outcomes not in (["applied", "verified"],
                        ["applied", "rolled_back"]):
        fail(f"{what}: the tuner's history {history}")
    want = compute_plans_from_anatomy(
        anatomy, exclude=("loss_fetch_steps",), fused_available=True)
    applied = {k: history[0][k] for k in (
        "compute", "predicted_step_us", "baseline_step_us",
        "predicted_speedup_pct")}
    if not want or applied != {k: want[0].to_dict()[k] for k in applied} \
            or applied["compute"] != {KNOB_FUSED_OPTIMIZER: True}:
        fail(f"{what}: applied {applied}, the planner gives "
             f"{[p.to_dict() for p in want]}")
    fused = [b["fused"] for b in step.builds]
    if fused != ([False, True] if outcomes[1] == "verified"
                 else [False, True, False]):
        fail(f"{what}: builds {step.builds}")
    # K1: none a step in the first graph, one in the plan's
    trace_k1 = {b: trace_launches(spans)["K1"] / TRACED_CALLS
                for b, spans in traces}
    issued_k1 = {}
    for r in rows:
        if r["kind"] in ("eager", "capture"):
            issued_k1.setdefault(r["build"], []).append(r["k1_issued"])
    if trace_k1.get(0) != 0 or trace_k1.get(1) != 1 or \
            issued_k1.get(0) != [0, 0] or issued_k1.get(1) != [1, 1]:
        fail(f"{what}: K1 a step in the graphs' traces {trace_k1}, issued "
             f"by the builds' eager and capture calls {issued_k1}")
    # the per-leaf run: the same losses, call by call, to the card's
    # parity limits (the switch to K1 changes no value)
    with deterministic_cudnn():
        plain_rows, _, plain, _, _ = _resnet_pg_run(htt, kernels, host,
                                                    False)
    pairs = [(r["loss"], p["loss"]) for r, p in zip(rows, plain_rows)
             if r["loss"] is not None]
    if len(plain_rows) != len(rows) or any(
            not math.isfinite(a) or abs(a - b) > PARITY_RTOL * abs(b)
            + PARITY_ATOL for a, b in pairs):
        fail(f"{what}: losses against the per-leaf run {pairs}")
    result = analyze(str(trace_dir), last_steps=1)
    last = result.summary["steps"][-1]
    return {
        "calls": [r["kind"] + ("*" if r.get("traced") else "")
                  for r in rows],
        "profile_window": list(PG_PROFILE), "window_steps": PG_WINDOW,
        "history": history, "planner": [p.to_dict() for p in want],
        "anatomy_segments_us_per_step": {
            k: v["per_step_us"] for k, v in anatomy["segments"].items()},
        "anatomy_step_us": anatomy["wall_us"] / anatomy["steps"],
        "k1_per_step_traced": {str(b): v for b, v in trace_k1.items()},
        "losses_bit_equal_per_leaf": all(a == b for a, b in pairs),
        "loss_max_abs_diff": max(abs(a - b) for a, b in pairs),
        "prefetch": {"stream": str(it.stream), "checked": checked},
        "replay": {"step": last["step"],
                   "measured_step_us": last["measured_step_us"],
                   "replay_step_us": last["replay_step_us"],
                   "critical_path": last["critical_path"],
                   "attribution": last["attribution"]["per_rank"],
                   "scenarios": [[s["scenario"], s["speedup_pct"]] for s
                                 in last["what_if"]["scenarios"]]},
        "fusion_plan": tuner.plan.to_dict() if tuner.plan is not None and
        tuner.plan.buckets else None}


def phase_autotune(htt, kernels, card) -> None:
    """The tuners through the rebuild seam (module docstring, phase
    28): (a) the GP on GPT-2 small, (b) the profile-guided compute tier
    on ResNet-50."""
    AUTOTUNE_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    gpt = _autotune_gpt(htt, kernels)
    t1 = time.perf_counter()
    resnet = _autotune_resnet(htt, kernels)
    emit({"phase": "autotune", "world_size": htt.size(),
          "gpt": {"model": "gpt2_small", "batch": 4, "seq_len": 1024,
                  "dtype": "bfloat16", "seconds": t1 - t0, **gpt},
          "resnet": {"model": "ResNet50", "batch": 128, "dtype": "bfloat16",
                     "optimizer": "fused_sgd(0.01, momentum=0.9), per leaf "
                     "until the plan", "seconds": time.perf_counter() - t1,
                     **resnet},
          "card": card})


#: where the kernels line's launches come from
LAUNCHES_NOTE = (
    f"counted by name in the CUPTI trace of the last {TRACED_CALLS} "
    "graphed calls (replays, 1 step each) of each kernel's main path: "
    "K1 momentum on ResNet-50, K1 adam and K2-K4 on GPT-2 small, K6-K10 "
    "on the variants path (K8 in its eval forward of one batch); K1 sgd "
    "in one replay of the rules phase; the 'bert' entries of K2-K4 on "
    "BERT-base (--attn pallas), the 'vgg16' entry of K1 momentum on "
    "VGG-16; K5's three entries (the flash ring's hops: K2 unnormalized, "
    "K3, K4) on GPT-2 small with --seq-parallel ring at world size 1")

#: the counters of K8-K10
CONV_COUNTERS = ("bn_relu", "stats", "plain")
#: the kernels line's entries of K6-K10, in order
VARIANT_KEYS = ("K6", "K6_bwd", "K6'", "K7", "K8", "K9", "K10")
#: the counter of each of them
VARIANT_COUNTERS = {"K6": "scale_bias_relu",
                    "K6_bwd": "scale_bias_relu_bwd", "K6'": "relu_grad",
                    "K7": "residual_relu", "K8": "bn_relu", "K9": "stats",
                    "K10": "plain"}


# ---------------------------------------------------------------------------
# the launcher: the GPT bench started by the port's own launcher
# ---------------------------------------------------------------------------
#: the launched GPT bench's trace window (graphed replays under a CUDA
#: trace: the bench's --cuda-trace) and its profiler window (the anatomy
#: GET /profile serves).  The profiler's window opens after the timeline
#: closed (at its end step + 1 the timeline finalizes every profiler
#: whose window is open, one just opened included), so iteration 1
#: (calls 3-7) holds the trace window, iteration 2 (calls 8-12) the
#: profiler's, and the launched rate is iteration 3's (calls 13-17),
#: replays only
LAUNCH_WINDOW = (3, 5)
LAUNCH_PROFILE = (8, 9)
#: the launched rate may trail gpt_main_path's graphed rate by this share
LAUNCH_RATE_SHARE = 0.05
#: the worker's push interval: several snapshots land during the run
LAUNCH_PUSH_S = 1.0
#: where the launcher phase writes its trace directory and journal
LAUNCH_DIR = Path(__file__).resolve().parent / "build" / "launcher"
#: seconds the launched job may take, the kernels' load included
LAUNCH_TIMEOUT_S = 300


def _worker_summary(stdout: str) -> dict:
    """The launched bench's last JSON line (rank 0's, tagged ``[0]`` by
    the launcher)."""
    for line in reversed(stdout.splitlines()):
        _, _, body = line.partition("<stdout>: ")
        if body.startswith('{"gpt_synthetic_benchmark"'):
            return json.loads(body)["gpt_synthetic_benchmark"]
    return {}


def phase_launcher(kernels, card, none) -> dict:
    """``python -m horovod_tpu_torch.run -np 1`` starting the GPT bench
    at its defaults (b 4, s 1024, bf16, K2-K4 flash, K1 fused Adam) with
    this process's rendezvous server as its external server
    (``HVD_METRICS_KV_*``, every scope journaled), ``HVD_TRACE_DIR`` with
    the launcher's ``--trace-start-step`` / ``--trace-end-step`` window
    of calls LAUNCH_WINDOW under the bench's ``--cuda-trace``, and
    ``HVD_PROFILE`` over LAUNCH_PROFILE.  ``--journal`` is passed as a
    user passes it, but with an external server the launcher stands up
    none (as the reference's does not), so the journal checked is the
    one this script's server writes.  Checks what reached the server,
    the trace directory, the journal and the worker's output;
    ``none`` is gpt_main_path's result, whose graphed rate the launched
    one is held to."""
    import shutil
    import threading

    from horovod_tpu_torch.run import http_client, journal
    from horovod_tpu_torch.run.http_server import RendezvousServer
    from horovod_tpu_torch.run.store import ShardedKVStore
    from horovod_tpu_torch.timeline.profiler import CUDA_TRACE_DIR

    what = "launcher"
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    LAUNCH_DIR.mkdir(parents=True)
    trace_dir, jpath = LAUNCH_DIR / "trace", LAUNCH_DIR / "rdv.journal"
    secret = os.urandom(16)
    srv = RendezvousServer(secret=secret)
    port = srv.start()
    # every scope journaled (the default leaves out the reconstructible
    # ones, metrics among them), so the replay is held to them all
    jr = journal.Journal(str(jpath), exclude=frozenset())
    srv.store.journal = jr
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    env.update({"HVD_METRICS_KV_ADDR": "127.0.0.1",
                "HVD_METRICS_KV_PORT": str(port),
                "HVD_METRICS_SECRET": secret.hex(),
                "HVD_METRICS_PUSH_SECONDS": str(LAUNCH_PUSH_S),
                "HVD_TRACE_DIR": str(trace_dir), "HVD_PROFILE": "1",
                "HVD_PROFILE_START_STEP": str(LAUNCH_PROFILE[0]),
                "HVD_PROFILE_END_STEP": str(LAUNCH_PROFILE[1])})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
           "--journal", str(jpath),
           "--trace-start-step", str(LAUNCH_WINDOW[0]),
           "--trace-end-step", str(LAUNCH_WINDOW[1]),
           sys.executable, "-m",
           "horovod_tpu_torch.examples.gpt_synthetic_benchmark",
           "--cuda-trace"]
    snapshots, stop = set(), threading.Event()

    def poll():   # the distinct snapshots that landed while the job ran
        while not stop.wait(0.1):
            raw = srv.get("metrics", "0")
            if raw is not None:
                snapshots.add(json.loads(raw).get("ts"))

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    t_wall, t_perf = time.time(), time.perf_counter()
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=LAUNCH_TIMEOUT_S,
                              cwd=Path(__file__).resolve().parent)
    finally:
        t_end = time.perf_counter()
        stop.set()
        poller.join()
    (LAUNCH_DIR / "launcher.out").write_text(proc.stdout + proc.stderr)
    try:
        prom = http_client.get_metrics("127.0.0.1", port, secret=secret)
        profile = http_client.get_profile("127.0.0.1", port, secret=secret)
        evs = http_client.get_events("127.0.0.1", port, secret=secret)
        health = http_client.get_health("127.0.0.1", port, secret=secret)
        metrics_scope = srv.store.prefix_items("/metrics/")
        held = srv.store.items()
    finally:
        srv.stop()
        jr.close()
    wall = time.perf_counter() - t_perf
    tail = (proc.stdout + proc.stderr)[-3000:]

    # 1. the launcher exited 0 and its worker ran on the card
    summary = _worker_summary(proc.stdout)
    if proc.returncode != 0 or not summary:
        fail(f"{what}: the launcher exited {proc.returncode} (worker "
             f"summary {bool(summary)}):\n{tail}")
    if summary["device"] != "cuda:0" or summary["size"] != 1:
        fail(f"{what}: the worker ran on {summary['device']} in a world of "
             f"{summary['size']}, want cuda:0 alone")
    # 2. signed GET /metrics: rank 0's families, the step counter, a
    # finite loss; and the pusher's snapshots kept landing
    from horovod_tpu_torch.examples import gpt_synthetic_benchmark as gb

    args = gb.parse_args([])
    steps = args.num_warmup_batches + \
        args.num_batches_per_iter * args.num_iters
    lines = [ln for ln in prom.splitlines() if 'rank="0"' in ln]
    families = {ln.split("{")[0] for ln in lines}
    loss = [float(ln.rsplit(" ", 1)[1]) for ln in lines
            if ln.startswith("hvd_train_loss{")]
    if f'hvd_steps_total{{rank="0"}} {steps}' not in prom or \
            len(loss) != 1 or not math.isfinite(loss[0]) or \
            len(snapshots) < 2:
        fail(f"{what}: GET /metrics holds {len(families)} families of rank "
             f"0, hvd_train_loss {loss}, {len(snapshots)} snapshots seen "
             f"(want hvd_steps_total {steps}, a finite loss, >= 2)")
    # 3. GET /profile: rank 0's anatomy of the profiled window
    anatomy = (profile.get("ranks") or {}).get("0")
    if not isinstance(anatomy, dict) or anatomy.get("steps") != \
            LAUNCH_PROFILE[1] - LAUNCH_PROFILE[0] + 1:
        fail(f"{what}: GET /profile holds {profile.get('ranks')}")
    # 4. GET /events: the rank's bench.result event, and the journal
    kinds = [e.get("kind") for e in evs.get("events", [])]
    if "bench.result" not in kinds:
        fail(f"{what}: GET /events holds {kinds}, want bench.result")
    replayed = ShardedKVStore()
    journal.replay(str(jpath), replayed)
    if replayed.prefix_items("/metrics/") != metrics_scope or \
            replayed.items() != held:
        fail(f"{what}: the journal replays to {sorted(replayed.items())}, "
             f"the server holds {sorted(held)}")
    # 5. GET /health: world 1 runs no heartbeat, and no abort was set
    if health != {"ranks": {}, "abort": None}:
        fail(f"{what}: GET /health answered {health}")
    # 6. comm.json and clock_sync.json: mapped onto the server's clock
    # (this process's monotonic clock), the worker's spans fall inside
    # the launch, to within half the handshake's round trip
    rank_dir = trace_dir / "0"
    comm = json.loads((rank_dir / "comm.json").read_text())
    sync = json.loads((rank_dir / "clock_sync.json").read_text())
    stamps = [e["ts"] + sync["offset_us"] for e in comm if "ts" in e]
    half = sync["rtt_us"] / 2
    if not stamps or not 0 <= sync["rtt_us"] < 1e5 or \
            min(stamps) < t_perf * 1e6 - half or \
            max(stamps) > t_end * 1e6 + half:
        fail(f"{what}: clock_sync.json {sync} maps comm.json's "
             f"{len(stamps)} events outside the launch")
    step_spans = [e for e in comm if e.get("name") == "STEP"]
    if len(step_spans) != LAUNCH_WINDOW[1] - LAUNCH_WINDOW[0] + 1:
        fail(f"{what}: comm.json holds {len(step_spans)} STEP spans, want "
             f"calls {LAUNCH_WINDOW[0]}-{LAUNCH_WINDOW[1]}")
    # 7. K1 Adam and K2-K4 issued (the eager call, the capture and the
    # profiled window's chains), and the window's graphed replays ran
    # K1 once and K2-K4 12 times each a step
    layers, profiled = 12, LAUNCH_PROFILE[1] - LAUNCH_PROFILE[0] + 1
    chains = profiled + 1
    want_k1 = {"sgd": 0, "momentum": 0, "adam": 2 + chains}
    want_flash = {"fwd.wgmma": layers * (2 + 2 * chains),
                  "bwd_dq.wgmma": layers * (2 + chains),
                  "bwd_dkv.wgmma": layers * (2 + chains)}
    if summary["k1_launches_issued"] != want_k1 or \
            summary["flash_launches_issued"] != want_flash:
        fail(f"{what}: the worker issued K1 {summary['k1_launches_issued']}"
             f" and K2-K4 {summary['flash_launches_issued']}, want "
             f"{want_k1} and {want_flash}")
    trace = json.loads((rank_dir / CUDA_TRACE_DIR / "trace.json")
                       .read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [(e.get("ts", 0.0), e.get("ts", 0.0) + e.get("dur", 0.0),
              e.get("name", "")) for e in events if e.get("cat") == "kernel"]
    in_window = trace_launches(spans)
    n = LAUNCH_WINDOW[1] - LAUNCH_WINDOW[0] + 1
    want = {key: n * v for key, v in step_trace(flash=layers).items()}
    if in_window != want:
        fail(f"{what}: the window's trace ran {in_window}, want {want} "
             f"({n} graphed replays)")
    # 8. the control plane's cost: the launched graphed rate (iteration
    # 3) against gpt_main_path's, in this run
    launched = summary["rates"][2]
    share = launched / none["seq_sec_per_chip"] - 1
    startup = summary["first_step_at"] - t_wall
    out = {"phase": what, "command": " ".join(cmd[2:]),
           "window": list(LAUNCH_WINDOW), "profile_window":
           list(LAUNCH_PROFILE), "exit_code": proc.returncode,
           "device": summary["device"],
           "k1_launches_issued": summary["k1_launches_issued"],
           "flash_launches_issued": summary["flash_launches_issued"],
           "window_trace": in_window, "metrics_families": len(families),
           "snapshots_seen": len(snapshots), "train_loss": loss[0],
           "profile_steps": anatomy["steps"], "events": kinds,
           "journal_records": len(held), "clock_sync": sync,
           "launched_seq_sec_per_chip": launched,
           "launched_iterations": summary["rates"],
           "main_path_seq_sec_per_chip": none["seq_sec_per_chip"],
           "rate_share_vs_main_path": share,
           "startup_s_to_first_step": startup, "wall_s": wall,
           "final_loss": summary["final_loss"], "card": card}
    emit(out)
    if share < -LAUNCH_RATE_SHARE:
        fail(f"{what}: launched {launched:.3f} seq/s against gpt_main_path's"
             f" {none['seq_sec_per_chip']:.3f} ({share:+.2%}, limit "
             f"-{LAUNCH_RATE_SHARE:.0%})")
    return out


# -- phase 30: elastic -------------------------------------------------------
ELASTIC_DIR = Path(__file__).resolve().parent / "build" / "elastic"
#: (a): the calls of the snapshot run, a snapshot every ELASTIC_EVERY
#: calls, the calls resumed from the restored state, the restores timed;
#: the uninterrupted run makes the calls of both
ELASTIC_CALLS = 20
ELASTIC_EVERY = 5
ELASTIC_RESUMED = 5
ELASTIC_RESTORES = 5
#: the rate window: the calls after the first snapshot (its storage save)
ELASTIC_WINDOW = (ELASTIC_EVERY, ELASTIC_CALLS)
#: (b): reinit() after this call of a 20-call run; allocated memory after
#: the new capture within this share of before
ELASTIC_REINIT_AT = 10
ELASTIC_MEMORY_SHARE = 0.01
#: (c): the restart task's steps, the step its fault ends attempt 0 at,
#: the step whose loss is held to the unbroken run's
RESTART_STEPS = 16
RESTART_KILL_AT = 12
RESTART_CHECK = 15
#: (d): ResNet-50's gradient count, summed this many times over the ring
HOST_RING_ELEMENTS = 25_557_032
HOST_RING_REPS = 3
ELASTIC_TIMEOUT_S = 300


def _elastic_tasks():
    """``scripts/torch_elastic_tasks.py`` as a module (its batches and its
    restart task, run here uninterrupted)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / \
        "torch_elastic_tasks.py"
    spec = importlib.util.spec_from_file_location("torch_elastic_tasks",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _elastic_cell(htt, seed: int = 0):
    """The headline cell (ResNet-50, bf16 over float32 parameters, fused
    momentum through K1, graphed), its model made on the card from
    ``seed``: ``(step, state)``."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50

    with torch.device("cuda"):
        model = ResNet50(dtype=torch.bfloat16, generator=torch.Generator(
            device="cuda").manual_seed(seed))
    model = model.to(memory_format=torch.channels_last)
    opt = htt.fused_sgd(0.01, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, has_batch_stats=True,
                               fused_optimizer=True, loss_fetch_steps=0)
    return step, htt.init_train_state(model, opt, has_batch_stats=True)


def _elastic_calls(step, state, batches, first: int, calls: int, *,
                   es=None, gens=None, on_call=None):
    """``calls`` calls of ``step`` on ``batches[first:]``; with ``es`` a
    save (a peer snapshot) every ELASTIC_EVERY calls, each timed on the
    host and, by events around it, on the card; ``gens`` (a dict) gets a
    clone of the state's tensors at every such call; ``on_call(i, step,
    state)`` runs after call ``i``.  The window ELASTIC_WINDOW is timed
    (synced at both ends).  Returns ``(state, losses, window_s,
    saves)``."""
    from horovod_tpu_torch.training import _state_tensors

    losses, saves, window = [], [], [0.0, 0.0]
    for i in range(first, first + calls):
        if i == ELASTIC_WINDOW[0]:
            torch.cuda.synchronize()
            window[0] = time.perf_counter()
        state, loss = step(state, *batches[i])
        losses.append(loss)
        n = i + 1
        if n % ELASTIC_EVERY == 0 and es is not None:
            before, after = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            before.record()
            t0 = time.perf_counter()
            es.state = state
            es.save(n)
            host = time.perf_counter() - t0
            after.record()
            saves.append((n, host, before, after))
        if n % ELASTIC_EVERY == 0 and gens is not None:
            gens[n] = [t.clone() for t in _state_tensors(state)]
        if on_call is not None:
            on_call(i, step, state)
        if n == ELASTIC_WINDOW[1]:
            torch.cuda.synchronize()
            window[1] = time.perf_counter()
    return state, [float.hex(t.item()) for t in losses], \
        window[1] - window[0], saves


@contextlib.contextmanager
def _captured_events():
    """The flight-recorder events recorded inside, by kind (the
    recorder's own ring may drain to a server meanwhile)."""
    from horovod_tpu_torch.observe import events as events_mod

    seen, record = [], events_mod.record_event

    def capture(kind, *args, **kw):
        seen.append((kind, kw.get("payload")))
        return record(kind, *args, **kw)

    events_mod.record_event = capture
    try:
        yield seen
    finally:
        events_mod.record_event = record


def _elastic_snapshots(htt, kernels, tasks, card) -> dict:
    """elastic (a): see the module docstring, phase 30."""
    from horovod_tpu_torch.elastic import peerstate
    from horovod_tpu_torch.run.http_server import RendezvousServer
    from horovod_tpu_torch.training import _state_tensors
    from horovod_tpu_torch.utils.checkpoint import latest_step

    what = "elastic (a)"
    batches = [tasks.batch(i, 128, 224, 1000, "cuda")
               for i in range(ELASTIC_CALLS + ELASTIC_RESUMED)]
    # the uninterrupted run: every loss, and the state at each generation
    gens: dict = {}
    step, state = _elastic_cell(htt)
    _, want, plain_s, _ = _elastic_calls(
        step, state, batches, 0, ELASTIC_CALLS + ELASTIC_RESUMED, gens=gens)
    del step, state

    secret = os.urandom(16)
    central = RendezvousServer(secret=secret)
    port = central.start()
    env = {"HVD_METRICS_KV_ADDR": "127.0.0.1",
           "HVD_METRICS_KV_PORT": str(port),
           "HVD_METRICS_SECRET": secret.hex(), "HVD_SNAPSHOT": "1",
           "HVD_PEER_REPLICAS": "2", "HVD_SNAPSHOT_STORAGE_EVERY": "1000",
           "HVD_ELASTIC_WORKER_ID": "0", "HVD_PROCESS_ID": "0",
           "HVD_NUM_PROCESSES": "1"}
    peers = [peerstate.PeerSnapshotManager(
        worker=str(w), rank=w, addr="127.0.0.1", port=port, secret=secret)
        for w in (1, 2)]
    for p in peers:
        p.start()
    ckpt = ELASTIC_DIR / "snapshots"
    try:
        with env_vars(env), _captured_events() as seen:
            peerstate.reset()
            reset_counts(kernels)
            step, state = _elastic_cell(htt)
            es = htt.ElasticState(str(ckpt), state)
            if es._peer is None:
                fail(f"{what}: HVD_SNAPSHOT=1 gave no peer manager")
            state, got, snap_s, saves = _elastic_calls(
                step, state, batches, 0, ELASTIC_CALLS, es=es)
            issued = kernels.launch_totals(kernels.fused_update_launches)
            calls = dict(step.calls)
            mgr = es._peer
            # what a crash right after call 20 could restore: the newest
            # committed peer generation, else the storage tier's step
            at_crash = mgr.resolve_committed()
            storage_at_crash = latest_step(str(ckpt))
            t0 = time.perf_counter()
            if not mgr.drain(ELASTIC_TIMEOUT_S):
                fail(f"{what}: the snapshotter did not drain")
            tail_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            stalls = [(n, host * 1e6, b.elapsed_time(a) * 1e3)
                      for n, host, b, a in saves]
            del step, state
            # a process after a crash: a fresh model (another seed), a
            # fresh step, resumed from the peers
            step, state = _elastic_cell(htt, seed=1)
            es2 = htt.ElasticState(str(ckpt), state)
            seen.clear()
            t0 = time.perf_counter()
            state, gen = es2.resume()
            restore_s = [time.perf_counter() - t0]
            sources = [p.get("source") for k, p in seen
                       if k == "restore.source"]
            if sources != ["peer"]:
                fail(f"{what}: restore.source {sources}, want ['peer']")
            if gen not in gens:
                fail(f"{what}: restored generation {gen}, not one of "
                     f"{sorted(gens)}")
            diff = [i for i, (a, b) in enumerate(zip(
                _state_tensors(state), gens[gen])) if not same_bits(a, b)]
            if diff or len(gens[gen]) != len(_state_tensors(state)):
                fail(f"{what}: {len(diff)} restored tensors differ from the "
                     f"state at generation {gen} (first: {diff[:3]})")
            state, resumed, _, _ = _elastic_calls(
                step, state, batches, gen, ELASTIC_RESUMED)
            if resumed != want[gen:gen + ELASTIC_RESUMED]:
                fail(f"{what}: resumed losses {resumed} differ from the "
                     f"uninterrupted run's calls {gen + 1}-"
                     f"{gen + ELASTIC_RESUMED}: "
                     f"{want[gen:gen + ELASTIC_RESUMED]}")
            for _ in range(ELASTIC_RESTORES - 1):
                t0 = time.perf_counter()
                es2.resume()
                restore_s.append(time.perf_counter() - t0)
            del step, state
    finally:
        peerstate.reset()
        for p in peers:
            p.stop()
        central.stop()
    if got != want[:ELASTIC_CALLS]:
        fail(f"{what}: the snapshot run's losses differ from the "
             "uninterrupted run's")
    if issued != {"sgd": 0, "momentum": issued_steps(calls), "adam": 0}:
        fail(f"{what}: K1 launches issued {issued}, calls {calls}")
    window = ELASTIC_WINDOW[1] - ELASTIC_WINDOW[0]
    rate = 128 * window / snap_s
    plain_rate = 128 * window / plain_s
    out = {"phase": "elastic_snapshots", "model": "ResNet50",
           "batch": 128, "calls": ELASTIC_CALLS, "every": ELASTIC_EVERY,
           "step_calls": calls, "k1_launches_issued": issued,
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in gens[ELASTIC_EVERY]),
           "storage_save_ms": saves[0][1] * 1e3,
           "snapshot_stall_us": {n: h for n, h, _ in stalls[1:]},
           "snapshot_device_copy_us": {n: d for n, _, d in stalls[1:]},
           "img_sec_with_snapshots": rate, "img_sec_without": plain_rate,
           "rate_share": rate / plain_rate - 1,
           "rate_window_calls": list(ELASTIC_WINDOW),
           "peer_gen_committed_at_crash": at_crash,
           "storage_step_at_crash": storage_at_crash,
           "steps_lost": ELASTIC_CALLS - max(at_crash or 0,
                                             storage_at_crash or 0),
           "background_tail_s": tail_s, "restored_gen": gen,
           "restore_source": sources[0],
           "restore_ms": [s * 1e3 for s in restore_s],
           "restore_ms_p50": statistics.median(restore_s) * 1e3,
           "resumed_losses": resumed, "card": card}
    emit(out)
    return out


def _elastic_reinit(htt, tasks, card) -> dict:
    """elastic (b): see the module docstring, phase 30."""
    what = "elastic (b)"
    batches = [tasks.batch(i, 128, 224, 1000, "cuda")
               for i in range(2 * ELASTIC_REINIT_AT)]
    step, state = _elastic_cell(htt)
    _, want, _, _ = _elastic_calls(step, state, batches, 0, len(batches))
    del step, state
    step, state = _elastic_cell(htt)
    memory = {}

    def on_call(i, step_, state_):
        if i + 1 == ELASTIC_REINIT_AT:
            torch.cuda.synchronize()
            memory["before"] = torch.cuda.memory_allocated()
            htt.reinit()
        elif i + 1 == ELASTIC_REINIT_AT + 2:
            torch.cuda.synchronize()
            memory["after"] = torch.cuda.memory_allocated()

    _, got, _, _ = _elastic_calls(step, state, batches, 0, len(batches),
                                  on_call=on_call)
    calls = dict(step.calls)
    share = memory["after"] / memory["before"] - 1
    out = {"phase": "elastic_reinit", "reinit_after_call": ELASTIC_REINIT_AT,
           "step_calls": calls, "builds": len(step.builds),
           "allocated_before": memory["before"],
           "allocated_after_recapture": memory["after"],
           "allocated_share": share, "card": card}
    emit(out)
    if len(step.builds) != 2 or calls != {
            "eager": 2, "capture": 2, "replay": len(batches) - 4}:
        fail(f"{what}: {len(step.builds)} builds, calls {calls}; want one "
             "rebuild: an eager call and one new capture")
    if abs(share) > ELASTIC_MEMORY_SHARE:
        fail(f"{what}: allocated {memory['after']} B after the new capture "
             f"against {memory['before']} B before ({share:+.2%}, limit "
             f"{ELASTIC_MEMORY_SHARE:.0%})")
    if got != want:
        fail(f"{what}: losses across the reinit differ from the unbroken "
             f"run's: {got} != {want}")
    return out


def _worker_events(stdout: str) -> list:
    """The JSON lines the launched workers printed, with their rank."""
    out = []
    for line in stdout.splitlines():
        tag, _, body = line.partition("<stdout>: ")
        if body.startswith("{"):
            out.append(dict(json.loads(body), worker=tag.strip("[]")))
    return out


def _launch(argv, env_extra: dict, what: str):
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    env.update(env_extra)
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", *argv], env=env,
        capture_output=True, text=True, timeout=ELASTIC_TIMEOUT_S, cwd=root)
    wall = time.perf_counter() - t0
    (ELASTIC_DIR / f"{what}.out").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"elastic: {' '.join(argv)} exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-2000:]}")
    return _worker_events(proc.stdout), wall


def _elastic_restart(tasks, card) -> dict:
    """elastic (c): see the module docstring, phase 30."""
    import shutil

    what = "elastic (c)"
    ckpt = ELASTIC_DIR / "restart"
    shutil.rmtree(ckpt, ignore_errors=True)
    script = Path(__file__).resolve().parent / "scripts" / \
        "torch_elastic_tasks.py"
    events, wall = _launch(
        ["-np", "1", "--restarts", "1", sys.executable, str(script),
         "restart", "--ckpt", str(ckpt), "--steps", str(RESTART_STEPS)],
        {"HVD_FAULT_SPEC": f"rank=0:step={RESTART_KILL_AT}:kind=crash"},
        "restart")
    resumes = [e for e in events if e["event"] == "resume"]
    if [(r["restart"], r["step"]) for r in resumes] != [(0, 0), (1, 10)]:
        fail(f"{what}: resumes {resumes}; want attempt 0 fresh and attempt "
             "1 from the committed step_10")
    calls0 = [e for e in events if e["event"] == "call"
              and e["t"] < resumes[1]["t"]]
    if calls0[-1]["step"] != RESTART_KILL_AT:
        fail(f"{what}: attempt 0 ended at step {calls0[-1]['step']}")
    steps1 = [e for e in events if e["event"] == "step"
              and e["t"] > resumes[1]["t"]]
    kill_to_resume = steps1[0]["t"] - calls0[-1]["t"]
    got = {e["step"]: e["loss"] for e in steps1}
    # the same task here, unbroken (its checkpoints in a directory of
    # their own)
    shutil.rmtree(ELASTIC_DIR / "unbroken", ignore_errors=True)
    with deterministic_cudnn():
        want = dict(tasks.train(str(ELASTIC_DIR / "unbroken"), RESTART_STEPS,
                                out=lambda **_: None, shutdown=False))
    if got.get(RESTART_CHECK) != float.hex(want[RESTART_CHECK]):
        fail(f"{what}: loss at step {RESTART_CHECK} after the restart "
             f"{got.get(RESTART_CHECK)}, unbroken "
             f"{float.hex(want[RESTART_CHECK])}")
    out = {"phase": "elastic_restart", "steps": RESTART_STEPS,
           "killed_at_step": RESTART_KILL_AT,
           "resumed_from": resumes[1]["step"],
           "resume_read_s": resumes[1]["seconds"],
           "kill_to_first_resumed_step_s": kill_to_resume,
           "loss_at_check": got[RESTART_CHECK],
           "losses_equal_unbroken": sorted(
               s for s, v in got.items() if v == float.hex(want[s])),
           "wall_s": wall, "card": card}
    emit(out)
    return out


def _elastic_host_ring(card) -> dict:
    """elastic (d): see the module docstring, phase 30."""
    from horovod_tpu_torch.runtime import native

    what = "elastic (d)"
    t0 = time.perf_counter()
    native.load()  # make -C csrc here once, before the workers load it
    build_s = time.perf_counter() - t0
    script = Path(__file__).resolve().parent / "scripts" / \
        "torch_elastic_tasks.py"
    events, wall = _launch(
        ["-np", "2", "--controller", "native", sys.executable, str(script),
         "allreduce", "--elements", str(HOST_RING_ELEMENTS), "--reps",
         str(HOST_RING_REPS), "--star-reps", "1"], {}, "host_ring")
    out = {"phase": "elastic_host_ring", "elements": HOST_RING_ELEMENTS,
           "workers": 2, "native_build_s": build_s, "wall_s": wall,
           "card": card}
    for transport, reps in (("ring", HOST_RING_REPS), ("star", 1)):
        runs = [e for e in events if e["event"] == "allreduce"
                and e["transport"] == transport]
        if len(runs) != 2 * reps:
            fail(f"{what}: {transport} runs {runs}")
        # a collective ends on its slowest rank
        per_rep = [max(e["seconds"] for e in runs if e["rep"] == r)
                   for r in range(reps)]
        nbytes = runs[0]["bytes"]
        out[transport] = {"seconds": per_rep,
                          "gb_per_s": [nbytes / s / 1e9 for s in per_rep]}
    emit(out)
    return out


def phase_elastic(htt, kernels, card) -> None:
    """Phase 30 (see the module docstring): the state plane and the
    native host planes on the headline cell."""
    import shutil

    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    ELASTIC_DIR.mkdir(parents=True)
    tasks = _elastic_tasks()
    t0 = time.perf_counter()
    with deterministic_cudnn():
        _elastic_snapshots(htt, kernels, tasks, card)
        _elastic_reinit(htt, tasks, card)
    _elastic_restart(tasks, card)
    _elastic_host_ring(card)
    emit({"phase": "elastic", "wall_s": time.perf_counter() - t0,
          "card": card})


# ---------------------------------------------------------------------------
# phase 31: the serving plane and the watchdog
SERVE_DIR = Path(__file__).resolve().parent / "build" / "serving"
#: the bucket ladder of the served ResNet-50 (max batch 32, 5 ms flush)
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_MAX_WAIT_MS = 5.0
#: distinct requests: random images, request i scaled by 2^(i/4), so the
#: rows of one model with random weights stay far apart
SERVE_POOL = 32
#: a served row (bf16 compute, int8 weights at rest) against the float32
#: forward of its own request with the same decompressed weights, TF32
#: off: ||served - f32|| / ||f32|| at most this, every row (about 3x the
#: largest reading on an H100, 5.24e-3; PERF.md section 2)
SERVE_ROW_LIMIT = 1.5e-2
SERVE_CAPACITY_BATCHES = 40          # closed loop: 40 full buckets
SERVE_LATENCY_REQUESTS = 50          # bucket 1, one request at a time
SERVE_SPLIT_REPS = 20
SERVE_SLO_MS = 100.0
#: a trace counts only if the generator admitted every request within
#: this share of the SLO of its scheduled time (an open loop)
SERVE_LATE_SHARE = 0.2
#: (c)'s trace: base 20%, burst 150% of (b)'s capacity, long enough for a
#: grow, the new replica's captures, and the drained shrink after
SERVE_ELASTIC_TRACE = {"pre_s": 0.5, "burst_s": 2.0, "post_s": 3.0}
SERVE_SHRINK_WAIT_S = 30.0
SERVE_REMOTE_REQUESTS = 8
SERVE_LAUNCH_TIMEOUT_S = 300
#: (e): the step seam slowed 30 ms from the 41st call (seam step 40)
WATCH_SLOW_FROM, WATCH_SLOW_MS, WATCH_STEPS = 40, 30, 300
#: the alert must name a step at most this far past the slowdown's start
#: (the EWMA needs HVD_WATCH_CONFIRM = 3 slow samples)
WATCH_FIRE_WITHIN = 8
WATCH_AB_CALLS, WATCH_AB_TURNS = 15, ("on", "off", "off", "on") * 2
SERVING_KEYS = {"K6": "scale_bias_relu", "K7": "residual_relu",
                "K8": "bn_relu"}
#: what one eval forward of the served model launches (K6, K7, K8)
SERVE_FORWARD = {"scale_bias_relu": 20, "residual_relu": 16, "bn_relu": 13}


def _serve_tasks():
    """``scripts/torch_serve_tasks.py`` as a module (its served model)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / \
        "torch_serve_tasks.py"
    spec = importlib.util.spec_from_file_location("torch_serve_tasks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tmpdir() -> Path:
    """A temporary directory for the launched jobs, inside SERVE_DIR."""
    path = SERVE_DIR / "tmp"
    path.mkdir(parents=True, exist_ok=True)
    return path


def _serving_kernels(kernels, ew, cb, flops_mod) -> dict:
    """serving (a): K8 at batch 1 and 32 on the four CONV_SHAPES against
    its plain version (row by row in norm, on wgmma), K6 and K7 bit-equal
    at [1 and 32, 56, 56, 256], each timed beside its plain version, its
    bound and (K8) ``F.conv2d``."""
    import torch.nn.functional as F

    out = {"K6": {}, "K7": {}, "K8": {}}
    for b in (1, 32):
        for s, c, _ in CONV_SHAPES:
            x = _seeded((b, s, s, c), torch.bfloat16, 900 + b + s)
            w = _seeded((3, 3, c, c), torch.bfloat16, 950 + s,
                        scale=(9 * c) ** -0.5)
            scale = torch.rand(c, device="cuda") + 0.5
            bias = torch.randn(c, device="cuda") * 0.1
            before = dict(kernels.conv_bn_launches)
            got = cb.conv3x3_bn_relu(x, w, scale, bias)
            took = {k: v - before[k] for k, v in
                    kernels.conv_bn_launches.items() if v != before[k]}
            want = cb.plain_conv3x3_bn_relu(x, w, scale, bias)
            top, mean = row_rel_err(got, want)
            if took != {"bn_relu.wgmma": 1} or not torch.isfinite(
                    got.float()).all() or top > CONV_BF16_ROW_LIMIT or \
                    mean > CONV_BF16_MEAN_LIMIT:
                fail(f"serving (a): K8 at [{b}, {s}, {s}, {c}] ran {took}, "
                     f"row error (max, mean) ({top}, {mean}), limits "
                     f"({CONV_BF16_ROW_LIMIT}, {CONV_BF16_MEAN_LIMIT})")
            m = b * s * s
            flops, nbytes = 2 * m * c * 9 * c, 2 * m * c * 2 + \
                9 * c * c * 2 + 2 * 4 * c
            bound_ms, bound_by = _bound(flops_mod, flops, nbytes,
                                        flops_mod.H100_PEAK_FLOPS)
            xl = x.permute(0, 3, 1, 2)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            out["K8"][f"{b}x{s}x{s}x{c}"] = {
                "ms": cuda_ms(lambda: cb.conv3x3_bn_relu(x, w, scale, bias)),
                "plain_ms": cuda_ms(
                    lambda: cb.plain_conv3x3_bn_relu(x, w, scale, bias)),
                "library_ms": cuda_ms(lambda: F.conv2d(xl, wl, padding=1)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "row_rel_err": [top, mean]}
        shape = (b, 56, 56, 256)
        n, c = math.prod(shape), shape[-1]
        x = _seeded(shape, torch.bfloat16, 960 + b)
        y = _seeded(shape, torch.bfloat16, 970 + b)
        scale = torch.rand(c, device="cuda") + 0.5
        bias = torch.randn(c, device="cuda")
        pairs = {"K7": (lambda: ew._residual_relu(x, y),
                        lambda: ew.plain_residual_relu(x, y), 2 * n,
                        3 * 2 * n),
                 "K6": (lambda: ew._scale_bias_relu(x, scale, bias),
                        lambda: ew.plain_scale_bias_relu(x, scale, bias),
                        3 * n, 2 * 2 * n + 2 * 4 * c)}
        for key, (fn, plain, flops, nbytes) in pairs.items():
            if not torch.equal(fn(), plain()):
                fail(f"serving (a): {key} differs from its plain version "
                     f"at {list(shape)} bf16")
            bound_ms, bound_by = _bound(flops_mod, flops, nbytes,
                                        flops_mod.H100_FP32_FLOPS)
            out[key][f"{b}x56x56x256"] = {
                "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain),
                "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by}
    emit({"phase": "serving_kernels", "timing": out,
          "tolerance": {"K8": {"bfloat16_row": CONV_BF16_ROW_LIMIT,
                               "bfloat16_mean_row": CONV_BF16_MEAN_LIMIT},
                        "K6": "bit-equal", "K7": "bit-equal"}})
    return out


def _serving_model(tasks):
    """The served model's state written with ``save_checkpoint`` after one
    train-mode forward (the BatchNorm statistics moved off their initial
    constants) and read back with ``load_params`` into another seed's
    model: ``(apply_fn, restored params, checkpoint dir)``."""
    import shutil

    from horovod_tpu_torch.serving import load_params, module_apply_fn
    from horovod_tpu_torch.utils.checkpoint import save_checkpoint

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    model = tasks.served_model("cuda", seed=0).train()
    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad():
        model(torch.rand((32, *tasks.IMAGE), device="cuda", generator=gen))
    model.eval()
    _, params = module_apply_fn(model)
    stats = [v for k, v in params.items() if k.endswith("running_var")]
    if not stats or all(torch.equal(v, torch.ones_like(v)) for v in stats):
        fail("serving: the BatchNorm statistics did not move")
    ckpt = SERVE_DIR / "ckpt"
    save_checkpoint(str(ckpt), params, step=1)
    apply_fn, like = module_apply_fn(tasks.served_model("cuda", seed=1))
    restored = load_params(str(ckpt), like)
    if any(not torch.equal(restored[k], params[k]) for k in params):
        fail("serving: load_params did not restore the saved state")
    return apply_fn, restored, ckpt


def _serving_pool(tasks):
    """SERVE_POOL distinct float32 requests [224, 224, 3]."""
    rng = np.random.RandomState(11)
    return [(rng.rand(*tasks.IMAGE) * 2.0 ** (i / 4)).astype(np.float32)
            for i in range(SERVE_POOL)]


def _f32_rows(tasks, params, pool) -> np.ndarray:
    """The float32 forward (TF32 off) of every pool request with
    ``params`` (the replica's decompressed weights)."""
    from horovod_tpu_torch.serving import module_apply_fn

    apply_fn, _ = module_apply_fn(tasks.served_model(
        "cuda", seed=2, dtype=torch.float32))
    with torch.inference_mode(), no_tf32():
        return apply_fn(params, torch.from_numpy(np.stack(pool)).cuda()) \
            .float().cpu().numpy()


def _check_rows(what, served, refs) -> dict:
    """Every served row within SERVE_ROW_LIMIT of its own request's
    float32 row and nearer to it than to any other request's."""
    worst, margin = 0.0, math.inf
    norms = np.linalg.norm(refs, axis=1)
    for idx, row in served:
        d = np.linalg.norm(refs - row[None].astype(np.float64), axis=1)
        rel = d[idx] / norms[idx]
        worst = max(worst, rel)
        others = np.delete(d, idx)
        margin = min(margin, others.min() / max(d[idx], 1e-30))
        if not np.isfinite(row).all() or rel > SERVE_ROW_LIMIT or \
                d[idx] >= others.min():
            fail(f"{what}: the row of request {idx} is {rel} of its float32 "
                 f"row away (limit {SERVE_ROW_LIMIT}); nearest other "
                 f"{others.min() / norms[idx]}")
    return {"rows": len(served), "max_row_rel_err": worst,
            "min_other_over_own_distance": margin}


def _trace(plane, pool, arrivals, windows, what):
    """Play an open-loop trace through ``plane``'s broker: each request
    is the pool entry ``i % SERVE_POOL``; returns the summary and the
    served (pool index, row) pairs.  Fails a trace the generator did not
    offer on time (lateness past SERVE_LATE_SHARE of the SLO)."""
    from horovod_tpu_torch.serving import OpenLoopLoadGenerator

    index = {id(x): i for i, x in enumerate(pool)}
    served = []

    def wait(req, timeout):
        out = plane.broker.wait(req, timeout)
        served.append((index[id(req.inputs)], out))
        return out

    gen = OpenLoopLoadGenerator(plane.broker.submit, arrivals,
                                lambda i: pool[i % SERVE_POOL], wait=wait,
                                slo_ms=SERVE_SLO_MS, timeout_s=30.0)
    pauses, began = [], []

    def on_gc(phase, info):  # the interpreter's collections, timed
        if phase == "start":
            began.append(time.monotonic())
        elif began:
            pauses.append((info["generation"], began.pop(),
                           time.monotonic()))

    # freeze the heap built before the trace (earlier phases, the model,
    # the checkpoint) out of the collector, as a serving process freezes
    # what it loaded: a full collection over it stalled every thread of
    # this process ~0.2 s in (c), the arrivals and the replicas alike
    gc.collect()
    gc.freeze()
    gc.callbacks.append(on_gc)
    start = time.monotonic()
    try:
        summary = gen.run(windows)
    finally:
        gc.callbacks.remove(on_gc)
        gc.unfreeze()
    late = [r["late_ms"] for r in gen.records]
    summary["late_ms"] = {"max": max(late), "p99": float(
        np.percentile(late, 99)), "mean": float(np.mean(late))}
    summary["gc_pauses_ms"] = {
        str(g): {"count": sum(p[0] == g for p in pauses),
                 "max": max([(p[2] - p[1]) * 1e3 for p in pauses
                             if p[0] == g], default=0.0)}
        for g in (0, 1, 2)}
    if summary["offered"] != summary["completed"] or \
            len(served) != summary["offered"]:
        fail(f"{what}: offered {summary['offered']}, completed "
             f"{summary['completed']}, served {len(served)}")
    if max(late) > SERVE_LATE_SHARE * SERVE_SLO_MS:
        worst = sorted(gen.records, key=lambda r: -r["late_ms"])[:5]
        scaler = plane.autoscaler
        marks = {f"{e[0]} {e[1]}": t - start for e, t in zip(
            scaler.events, scaler.event_times)} if scaler else {}
        marks["gc pauses over 20 ms"] = [
            (g, t0 - start, (t1 - t0) * 1e3) for g, t0, t1 in pauses
            if t1 - t0 > 0.02]
        for w, rep in plane.replicas.items():
            for name in ("warmup_window", "drain_window"):
                if getattr(rep, name):
                    marks[f"{w} {name}"] = [
                        t - start for t in getattr(rep, name)]
        fail(f"{what}: the generator sent a request {max(late)} ms late "
             f"(limit {SERVE_LATE_SHARE * SERVE_SLO_MS} ms): the trace was "
             "not offered open-loop; the latest (arrival s, ms late): "
             f"{[(r['t'], r['late_ms']) for r in worst]}; s from the "
             f"trace's start: {marks}")
    return summary, served


class _ServeReq:
    """A request as the replica's ``stack`` reads it (its ``inputs``)."""

    def __init__(self, inputs):
        self.inputs = inputs


def _host_split(rep, pool, bucket) -> dict:
    """One batch of ``bucket`` requests through the replica's steps, each
    closed by a device sync, median of SERVE_SPLIT_REPS: stack and pad
    into the pinned buffer, the host-to-device copy, the replay, the
    device-to-host copy and the rows; and the replay's device ms."""
    batch = [_ServeReq(pool[i % SERVE_POOL]) for i in range(bucket)]
    times = {"stack_pad": [], "h2d": [], "replay": [], "d2h": []}
    for _ in range(SERVE_SPLIT_REPS):
        t0 = time.perf_counter()
        g, n = rep.stack(batch)
        t1 = time.perf_counter()
        g.x.copy_(g.host_in, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        g.graph.replay()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        g.host_out.copy_(g.out, non_blocking=True)
        torch.cuda.synchronize()
        g.host_out[:n].numpy().copy()
        t4 = time.perf_counter()
        for k, (a, b) in zip(times, ((t0, t1), (t1, t2), (t2, t3),
                                     (t3, t4))):
            times[k].append((b - a) * 1e3)
    out = {k: statistics.median(v) for k, v in times.items()}
    out["total"] = sum(out.values())
    out["replay_device_ms"] = cuda_ms(g.graph.replay, runs=10)
    return out


def _serving_fixed(kernels, tasks, apply_fn, params, pool, card) -> dict:
    """serving (b): see the module docstring, phase 31."""
    from horovod_tpu_torch.serving import LocalServingPlane

    what = "serving (b)"
    reset_counts(kernels)
    t0 = time.perf_counter()
    plane = LocalServingPlane(apply_fn, params, replicas=1,
                              max_batch=SERVE_BUCKETS[-1],
                              max_wait_ms=SERVE_MAX_WAIT_MS, device="cuda",
                              warmup_sample=pool[0])
    rep = plane.replicas["0"]
    try:
        if not rep.ready.wait(300) or rep.warmup_error is not None:
            fail(f"{what}: the replica's warm-up did not end or raised "
                 f"{rep.warmup_error!r}")
        warm_s = time.perf_counter() - t0
        issued = {k: v for k, v in _counts(kernels).items() if v}
        want = {k: v * 2 * len(SERVE_BUCKETS)
                for k, v in SERVE_FORWARD.items()}
        if issued != want or _loops(kernels) != {
                "bn_relu.wgmma": want["bn_relu"]} or \
                rep.recompiles != len(SERVE_BUCKETS) or \
                rep.bucketer.sizes != SERVE_BUCKETS:
            fail(f"{what}: warm-up issued {issued} on {_loops(kernels)} "
                 f"(want {want}, K8 on wgmma), {rep.recompiles} graphs on "
                 f"the ladder {rep.bucketer.sizes}")
        refs = _f32_rows(tasks, rep.params, pool)
        # each bucket's replay against the eager forward of its batch
        bucket1 = []
        for b in SERVE_BUCKETS:
            batch = [_ServeReq(pool[i]) for i in range(b)]
            g, n = rep.stack(batch)
            graphed = rep.fetch(rep.forward(g), n)
            eager = rep.eager_forward(g.host_in.numpy())
            if not np.array_equal(graphed, eager[:n]):
                fail(f"{what}: bucket {b}'s replay differs from the eager "
                     f"forward by {np.abs(graphed - eager[:n]).max()}")
        for i in range(SERVE_REMOTE_REQUESTS):
            g, n = rep.stack([_ServeReq(pool[i])])
            bucket1.append(rep.fetch(rep.forward(g), n)[0])
        _, _, spans = profiled(lambda: rep.forward(rep.stack(
            [_ServeReq(pool[i]) for i in range(32)])[0]))
        replay_trace = trace_launches(spans)
        if (replay_trace["K6"], replay_trace["K7"],
                replay_trace["K8-K10"]) != (20, 16, 13):
            fail(f"{what}: one replay of bucket 32 ran {replay_trace}")
        split = {b: _host_split(rep, pool, b) for b in (1, 32)}
        checks = []
        # the capacity: closed loop, full buckets
        b = plane.broker
        n = SERVE_CAPACITY_BATCHES * SERVE_BUCKETS[-1]
        before = (rep.requests, rep.batches)
        t0 = time.perf_counter()
        reqs = [b.submit(pool[i % SERVE_POOL]) for i in range(n)]
        outs = [b.wait(r, 60.0) for r in reqs]
        capacity = n / (time.perf_counter() - t0)
        capacity_fill = (rep.requests - before[0]) / (rep.batches -
                                                      before[1])
        checks.append(_check_rows(f"{what} capacity", [
            (i % SERVE_POOL, o) for i, o in enumerate(outs)], refs))
        # bucket 1 at low load
        lat = []
        for i in range(SERVE_LATENCY_REQUESTS):
            r = b.submit(pool[i % SERVE_POOL])
            b.wait(r, 30.0)
            lat.append(r.latency_s() * 1e3)
        # the bench fixture's bursty trace at 20% / 100% of the capacity
        from horovod_tpu_torch.serving import bursty_arrivals
        from horovod_tpu_torch.serving.plane import BENCH_FIXTURE_KWARGS

        fx = BENCH_FIXTURE_KWARGS
        arrivals, windows = bursty_arrivals(
            0.2 * capacity, capacity, pre_s=fx["pre_s"],
            burst_s=fx["burst_s"], post_s=fx["post_s"], seed=fx["seed"])
        before = (rep.requests, rep.batches)
        summary, served = _trace(plane, pool, arrivals, windows, what)
        fill = (rep.requests - before[0]) / max(rep.batches - before[1], 1)
        checks.append(_check_rows(f"{what} trace", served, refs))
        stats = b.window_stats()
        if rep.recompiles != len(SERVE_BUCKETS) or any(
                stats[k] for k in ("failed", "rejected", "duplicates",
                                   "requeued")):
            fail(f"{what}: {rep.recompiles} graphs at the end, broker "
                 f"{stats}")
        out = {"phase": "serving_fixed", "model": "ResNet50", "options":
               VARIANTS, "image": list(tasks.IMAGE), "dtype": "bfloat16",
               "weights": rep.compression_info, "buckets": SERVE_BUCKETS,
               "max_wait_ms": SERVE_MAX_WAIT_MS, "warmup_s": warm_s,
               "warmup_launches_issued": issued,
               "replay_trace_bucket32": replay_trace,
               "capacity_img_s": capacity,
               "capacity_batch_fill": capacity_fill,
               "bucket1_latency_ms": {
                   "p50": statistics.median(lat), "max": max(lat)},
               "trace": {"base_rps": 0.2 * capacity, "burst_rps": capacity,
                         **{k: fx[k] for k in ("pre_s", "burst_s",
                                                "post_s", "seed")},
                         "slo_ms": SERVE_SLO_MS},
               "summary": summary, "batch_fill": fill,
               "host_split_ms": split, "row_checks": checks,
               "row_limit": SERVE_ROW_LIMIT,
               "broker": {k: stats[k] for k in (
                   "submitted", "completed", "failed", "rejected",
                   "duplicates", "requeued")},
               "graphs": rep.recompiles, "card": card}
        emit(out)
        return {"capacity": capacity, "refs": refs, "bucket1": bucket1,
                "issued": issued}
    finally:
        plane.shutdown()


def _serving_elastic(tasks, apply_fn, params, pool, refs, capacity,
                     card) -> dict:
    """serving (c): see the module docstring, phase 31."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.serving import (
        AutoscalePolicy,
        LocalServingPlane,
        bursty_arrivals,
    )

    what = "serving (c)"
    policy = AutoscalePolicy(queue_high=8.0, queue_low=0.5,
                             slo_ms=60_000.0, hysteresis_ticks=3,
                             cooldown_s=1.0, min_replicas=1, max_replicas=2)
    drains_before = metrics.SERVE_DRAINS.get()
    arrivals, windows = bursty_arrivals(
        0.2 * capacity, 1.5 * capacity, seed=11, **SERVE_ELASTIC_TRACE)
    plane = LocalServingPlane(apply_fn, params, replicas=1,
                              spare_workers=["1"], elastic=True,
                              policy=policy, max_batch=SERVE_BUCKETS[-1],
                              max_wait_ms=SERVE_MAX_WAIT_MS, device="cuda",
                              warmup_sample=pool[0], drain_timeout_s=30.0)
    try:
        if not plane.replicas["0"].ready.wait(300) or \
                plane.replicas["0"].warmup_error is not None:
            fail(f"{what}: replica 0's warm-up did not end or raised "
                 f"{plane.replicas['0'].warmup_error!r}")
        # the burst's backlog outgrows HVD_SERVE_QUEUE_LIMIT until the
        # grow lands: admit the whole trace, so a refusal can only mean a
        # lost request
        plane.broker.queue_limit = max(plane.broker.queue_limit,
                                       len(arrivals))
        plane.start()
        summary, served = _trace(plane, pool, arrivals, windows, what)
        deadline = time.monotonic() + SERVE_SHRINK_WAIT_S
        while time.monotonic() < deadline and \
                len(plane.autoscaler.events) < 2:
            time.sleep(0.05)
        events = list(plane.autoscaler.events)
        rec = json.loads(plane.server.get("membership", "epoch"))
        rep0, rep1 = plane.replicas["0"], plane.replicas.get("1")
        stats = plane.broker.window_stats()
        drained = metrics.SERVE_DRAINS.get() - drains_before
        if events != [("grow", "1", 1), ("shrink", "1", 2)] or \
                rec["world"] != ["0"] or "drained" not in rec["reason"] or \
                drained != 1 or any(stats[k] for k in (
                    "failed", "rejected", "duplicates", "requeued")):
            fail(f"{what}: autoscale events {events}, epoch record {rec}, "
                 f"drains {drained}, broker {stats}")
        if rep1 is None or rep1.recompiles != len(SERVE_BUCKETS) or \
                rep1.first_batch_time is None or \
                rep1.warmup_window is None or rep1.warmup_error is not None \
                or rep1.drain_window is None:
            fail(f"{what}: replica 1 {rep1 and rep1.recompiles} graphs, "
                 f"{rep1 and rep1.batches} batches, warm-up error "
                 f"{rep1 and rep1.warmup_error!r}")
        lo, hi = rep1.warmup_window
        overlap = sum(lo <= t <= hi for t in rep0.batch_times)
        if not overlap:
            fail(f"{what}: replica 0 served no batch while replica 1 "
                 "captured its graphs")
        rows = _check_rows(what, served, refs)
        out = {"phase": "serving_elastic", "policy": {
                   "queue_high": policy.queue_high,
                   "queue_low": policy.queue_low,
                   "hysteresis_ticks": policy.hysteresis_ticks,
                   "cooldown_s": policy.cooldown_s,
                   "slo_ms": policy.slo_ms},
               "trace": {"base_rps": 0.2 * capacity,
                         "burst_rps": 1.5 * capacity, "seed": 11,
                         **SERVE_ELASTIC_TRACE},
               "summary": summary, "autoscale_events": events,
               "epoch_record": {k: rec[k] for k in ("epoch", "world",
                                                    "reason")},
               "drains_total": drained,
               "drain_ms": (rep1.drain_window[1] - rep1.drain_window[0])
               * 1e3,
               "grow_to_first_batch_s":
                   rep1.first_batch_time - plane.autoscaler.event_times[0],
               "replica1_capture_s": hi - lo,
               "replica0_batches_during_capture": overlap,
               "replica_batches": {"0": rep0.batches, "1": rep1.batches},
               "row_checks": rows,
               "broker": {k: stats[k] for k in (
                   "submitted", "completed", "failed", "rejected",
                   "duplicates", "requeued")}, "card": card}
        emit(out)
        return out
    finally:
        plane.shutdown()


def _serving_remote(tasks, ckpt, pool, bucket1, card) -> dict:
    """serving (d): see the module docstring, phase 31."""
    from horovod_tpu_torch.run import http_client

    what = "serving (d)"
    port_file, done_file = SERVE_DIR / "remote.port", SERVE_DIR / "done"
    secret = os.urandom(16)
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    env.update({"HVD_METRICS_SECRET": secret.hex(),
                "HVD_SERVE_WEIGHT_COMPRESSION": "int8",
                "TMPDIR": str(_tmpdir())})
    script = Path(__file__).resolve().parent / "scripts" / \
        "torch_serve_tasks.py"
    t0 = time.perf_counter()
    log = open(SERVE_DIR / "remote.out", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
         "--serve", "--serve-max-batch", "1", sys.executable, str(script),
         "serve", "--ckpt", str(ckpt), "--port-file", str(port_file),
         "--done-file", str(done_file)], env=env, stdout=log,
        stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent)
    try:
        while not port_file.exists():
            if proc.poll() is not None or \
                    time.perf_counter() - t0 > SERVE_LAUNCH_TIMEOUT_S:
                fail(f"{what}: the launched replica ended or never got "
                     f"ready: {(SERVE_DIR / 'remote.out').read_text()[-2000:]}")
            time.sleep(0.1)
        ready_s = time.perf_counter() - t0
        info = json.loads(port_file.read_text())
        addr, port = info["addr"], info["port"]
        lat = []
        for i in range(SERVE_REMOTE_REQUESTS):
            t1 = time.perf_counter()
            got = http_client.post_infer(addr, port, pool[i],
                                         secret=secret, timeout=60.0)
            lat.append({"client_ms": (time.perf_counter() - t1) * 1e3,
                        "server_ms": got["latency_ms"],
                        "replica": got["replica"]})
            row = np.asarray(got["outputs"], dtype=np.float32)
            if not np.array_equal(row, bucket1[i]):
                fail(f"{what}: request {i}'s row differs from (b)'s bucket-1 "
                     f"graph by {np.abs(row - bucket1[i]).max()}")
        page = http_client.get_serving(addr, port, secret=secret)
        broker = page["broker"]
        if (broker["submitted"], broker["completed"], broker["failed"]) != \
                (SERVE_REMOTE_REQUESTS, SERVE_REMOTE_REQUESTS, 0):
            fail(f"{what}: GET /serving reports {broker}")
        done_file.write_text("done")
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if rc != 0:
        fail(f"{what}: the launcher exited {rc}: "
             f"{(SERVE_DIR / 'remote.out').read_text()[-2000:]}")
    out = {"phase": "serving_remote", "requests": SERVE_REMOTE_REQUESTS,
           "floats_a_request": int(pool[0].size),
           "launch_to_ready_s": ready_s, "latency": lat,
           "broker": {k: broker[k] for k in (
               "submitted", "completed", "failed", "p50_ms", "p99_ms")},
           "bit_equal_to_bucket1_graph": True,
           "wall_s": time.perf_counter() - t0, "card": card}
    emit(out)
    return out


def _headline_step(htt, profile):
    """The headline cell's graphed step, state and batch (ResNet-50,
    224x224, batch 128, bf16 over float32 parameters, fused momentum)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50

    model = on_card(ResNet50).to(memory_format=torch.channels_last)
    opt = htt.fused_sgd(0.01, momentum=0.9)
    step = htt.make_train_step(apply_fn=model, loss_fn=F.cross_entropy,
                               optimizer=opt, has_batch_stats=True,
                               fused_optimizer=True, loss_fetch_steps=0,
                               profile=profile)
    state = htt.init_train_state(model, opt, has_batch_stats=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((128, 224, 224, 3), device="cuda", generator=gen)
    y = torch.randint(0, 1000, (128,), device="cuda", generator=gen)
    return step, state, x, y


def _serving_watchdog(htt, card, tasks) -> dict:
    """serving (e): see the module docstring, phase 31."""
    from horovod_tpu_torch.observe import autoarm

    what = "serving (e)"
    for k in ("HVD_PROFILE", "HVD_WATCH_ARM"):
        if os.environ.get(k):
            fail(f"{what}: {k} is set; the dormant profiler needs it unset")
    cells = {"on": _headline_step(htt, None),
             "off": _headline_step(htt, False)}
    if cells["on"][0].profiler is None or cells["on"][0].profiler.enabled \
            or cells["on"][0].profiler not in autoarm._profilers \
            or cells["off"][0].profiler is not None:
        fail(f"{what}: profile=None gave {cells['on'][0].profiler}, "
             f"profile=False {cells['off'][0].profiler}")
    for name, (step, state, x, y) in cells.items():
        for _ in range(3):  # eager, capture, a replay
            state, loss = step(state, x, y)
        cells[name] = (step, state, x, y)
    rates = {"on": [], "off": []}
    for name in WATCH_AB_TURNS:
        step, state, x, y = cells[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WATCH_AB_CALLS):
            state, loss = step(state, x, y)
        loss.item()
        rates[name].append(128 * WATCH_AB_CALLS / (time.perf_counter() - t0))
        cells[name] = (step, state, x, y)
    on, off = statistics.mean(rates["on"]), statistics.mean(rates["off"])
    if not cells["on"][0].calls.get("replay"):
        fail(f"{what}: the dormant cell ran {dict(cells['on'][0].calls)}")
    del cells
    torch.cuda.empty_cache()

    script = Path(__file__).resolve().parent / "scripts" / \
        "torch_serve_tasks.py"
    spec = ";".join(f"rank=0:step={s}:kind=slow={WATCH_SLOW_MS}ms"
                    for s in range(WATCH_SLOW_FROM, WATCH_STEPS))
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    # the watchdog's armed window writes under TMPDIR when no trace
    # directory is set
    env.update({"HVD_WATCH_INTERVAL_SECONDS": "0.5",
                "HVD_TIMESERIES_FLUSH_SECONDS": "0.5",
                "HVD_FAULT_SPEC": spec, "TMPDIR": str(_tmpdir())})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
         sys.executable, str(script), "watch", "--steps", str(WATCH_STEPS),
         "--poll-from", str(WATCH_SLOW_FROM)],
        env=env, capture_output=True, text=True,
        timeout=SERVE_LAUNCH_TIMEOUT_S, cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    (SERVE_DIR / "watch.out").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"{what}: the launched job exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-2000:]}")
    events = {e["event"]: e for e in _worker_events(proc.stdout)}
    w = events.get("watched", {})
    alert = w.get("alert") or {}
    ev = alert.get("evidence") or {}
    anatomy = (w.get("profile") or {}).get("ranks", {}).get("0") or {}
    cadence = w.get("cadence_ms") or []
    if not events.get("start", {}).get("dormant") or \
            alert.get("signal") != "step_time_regression" or \
            ev.get("rank") != "0" or not alert.get("armed") or \
            not (WATCH_SLOW_FROM < ev.get("fired_step", 0)
                 <= WATCH_SLOW_FROM + WATCH_FIRE_WITHIN) or \
            not (w.get("anatomy_steps") or 0) >= 1 or \
            not anatomy.get("steps"):
        fail(f"{what}: start {events.get('start')}, alert {alert}, the "
             f"profiler's window {w.get('armed_window')} enabled "
             f"{w.get('profiler_enabled')} steps {w.get('anatomy_steps')}, "
             f"/profile rank 0 {str(anatomy)[:300]}; the launcher's newest "
             f"step at each poll {w.get('launcher_newest_step')}; the "
             f"cadence ms it held {cadence[:WATCH_SLOW_FROM + 12]}")
    ms = w["step_ms"]
    out = {"phase": "serving_watchdog",
           "dormant_rate_img_s": on, "off_rate_img_s": off,
           "dormant_cost_pct": (off - on) / off * 100.0,
           "rates": rates, "calls_a_turn": WATCH_AB_CALLS,
           "slow_from_call": WATCH_SLOW_FROM + 1, "slow_ms": WATCH_SLOW_MS,
           "alert": {k: alert.get(k) for k in (
               "signal", "severity", "evidence", "window", "armed")},
           "fired_after_slow_steps": ev["fired_step"] - WATCH_SLOW_FROM,
           "armed_window": w["armed_window"],
           "anatomy_steps": w["anatomy_steps"],
           "profile_segments": sorted((anatomy.get("segments") or {})),
           "steps_run": w["steps"],
           "launcher_newest_step_at_polls": w["launcher_newest_step"],
           "pre_slow_cadence_ms_median_max": [
               statistics.median(v for st, v in cadence
                                 if st <= WATCH_SLOW_FROM),
               max(v for st, v in cadence if st <= WATCH_SLOW_FROM)],
           "pre_slow_ticks_that_could_fire": tasks.early_fires(
               [[st, v / 1e3] for st, v in cadence], WATCH_SLOW_FROM),
           "step_ms_median_before_after": [
               statistics.median(ms[5:WATCH_SLOW_FROM]),
               statistics.median(ms[WATCH_SLOW_FROM + 2:
                                    WATCH_SLOW_FROM + 12])],
           "wall_s": wall, "card": card}
    emit(out)
    return out


def phase_serving(htt, kernels, ew, cb, flops_mod, card) -> dict:
    """Phase 31 (see the module docstring): the serving plane on the
    variants' kernels and the watchdog.  Returns the serving entries of
    K6, K7 and K8 for the kernels line."""
    tasks = _serve_tasks()
    t0 = time.perf_counter()
    # replicas read their weights' at-rest format from the knob
    with deterministic_cudnn(), no_tf32(), env_vars(
            {"HVD_SERVE_WEIGHT_COMPRESSION": "int8"}):
        timing = _serving_kernels(kernels, ew, cb, flops_mod)
        apply_fn, params, ckpt = _serving_model(tasks)
        pool = _serving_pool(tasks)
        fixed = _serving_fixed(kernels, tasks, apply_fn, params, pool, card)
        _serving_elastic(tasks, apply_fn, params, pool, fixed["refs"],
                         fixed["capacity"], card)
    del apply_fn, params
    torch.cuda.empty_cache()
    _serving_remote(tasks, ckpt, pool, fixed["bucket1"], card)
    _serving_watchdog(htt, card, tasks)
    emit({"phase": "serving", "wall_s": time.perf_counter() - t0,
          "card": card})
    return {key: {"launches_issued_in_warmup": fixed["issued"][counter],
                  "timing_by_shape": timing[key]}
            for key, counter in SERVING_KEYS.items()}


def run_variant_phases(htt, kernels, ew, cb, flops_mod, card,
                       default_img_sec) -> dict:
    """The phases of K6-K10: each kernel against its plain version, the
    card-vs-CPU parity of the variant models, their main path and
    profile.  Returns the kernels' entries, launches from the main
    path."""
    results = phase_elementwise_kernels(kernels, ew, flops_mod)
    results.update(phase_conv_kernels(kernels, cb, flops_mod))
    phase_variants_parity(htt, kernels)
    launches, by_loop = phase_variants_main_path(kernels, flops_mod, card,
                                                 default_img_sec)
    for key, counter in VARIANT_COUNTERS.items():
        results[key]["launches"] = launches[counter]
        if counter in CONV_COUNTERS:
            results[key]["launches_issued_by_mainloop"] = {
                k.split(".")[1]: v for k, v in by_loop.items()
                if k.startswith(counter + ".")}
    phase_variants_profile(htt, kernels)
    return results


def run_model_parallel_phases(htt, kernels, fa, ra, flops_mod,
                              card) -> dict:
    """The phases of K5 and model parallelism alone (with the GPT main
    path and the BERT cut they are compared with): K5's entries,
    launches from the ring's main path."""
    results = phase_ring_kernels(kernels, fa, ra, flops_mod)
    phase_model_parallel(htt)
    _, _, gpt_none = phase_gpt_main_path(htt, kernels, card)
    ring_trace = phase_gpt_sp_main_path(htt, kernels, card, gpt_none)
    for key, k in zip(RING_HOPS, ("K2", "K3", "K4")):
        results[key]["launches"] = ring_trace["launches"][k]
    phase_bert_sp_main_path(htt, kernels, card,
                            phase_bert_adasum(htt, kernels, card))
    return results


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flash-only", action="store_true",
                    help="run the device, build and flash_kernels phases")
    ap.add_argument("--variants-only", action="store_true",
                    help="run the device and build phases and those of "
                         "K6-K10 (elementwise_kernels to variants_profile)")
    ap.add_argument("--trace-plane-only", action="store_true",
                    help="run the device and build phases, gpt_main_path "
                         "and trace_plane")
    ap.add_argument("--autotune-only", action="store_true",
                    help="run the device and build phases, gpt_main_path "
                         "and autotune")
    ap.add_argument("--launcher-only", action="store_true",
                    help="run the device and build phases, gpt_main_path "
                         "and launcher")
    ap.add_argument("--elastic-only", action="store_true",
                    help="run the device and build phases and elastic")
    ap.add_argument("--serving-only", action="store_true",
                    help="run the device and build phases and serving")
    ap.add_argument("--model-parallel-only", action="store_true",
                    help="run the device and build phases and those of "
                         "K5 and model parallelism (ring_kernels, "
                         "model_parallel, gpt_main_path, gpt_sp_main_path, "
                         "bert_adasum, bert_sp_main_path)")
    cli = ap.parse_args()
    flash_only, variants_only = cli.flash_only, cli.variants_only
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA card")
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import kernels
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.ops import elementwise as ew
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim import fused_update as fu
    from horovod_tpu_torch.parallel import ring_attention as ra
    from horovod_tpu_torch.utils import flops as flops_mod

    card = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = kernels.build(force=True, verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(kernels.LIB_PATH.relative_to(
              kernels.BUILD_DIR.parents[1]))})
    print(log, file=sys.stderr, flush=True)

    # CPU tensors (the parity phase's reference run) reduce over gloo,
    # CUDA tensors over NCCL, on one world-size-1 group
    htt.init(backend="cpu:gloo,cuda:nccl")
    if flash_only:
        phase_flash_kernels(kernels, fa, flops_mod)
        htt.shutdown()
        return
    if variants_only:
        results = run_variant_phases(htt, kernels, ew, cb, flops_mod, card,
                                     None)
        emit({"kernels": [results[k] for k in VARIANT_KEYS],
              "launches": LAUNCHES_NOTE})
        htt.shutdown()
        return
    if cli.trace_plane_only:
        _, _, gpt_none = phase_gpt_main_path(htt, kernels, card)
        phase_trace_plane(htt, kernels, fa, card, gpt_none, None)
        htt.shutdown()
        return
    if cli.autotune_only:
        phase_gpt_main_path(htt, kernels, card)
        phase_autotune(htt, kernels, card)
        htt.shutdown()
        return
    if cli.launcher_only:
        _, _, gpt_none = phase_gpt_main_path(htt, kernels, card)
        phase_launcher(kernels, card, gpt_none)
        htt.shutdown()
        return
    if cli.elastic_only:
        phase_elastic(htt, kernels, card)
        htt.shutdown()
        return
    if cli.serving_only:
        emit({"serving_kernels": phase_serving(htt, kernels, ew, cb,
                                               flops_mod, card)})
        htt.shutdown()
        return
    if cli.model_parallel_only:
        results = run_model_parallel_phases(htt, kernels, fa, ra, flops_mod,
                                            card)
        emit({"kernels": [results[k] for k in RING_HOPS],
              "launches": LAUNCHES_NOTE})
        htt.shutdown()
        return
    results = phase_kernels(fu, flops_mod)
    results.update(phase_flash_kernels(kernels, fa, flops_mod))
    results.update(phase_ring_kernels(kernels, fa, ra, flops_mod))
    phase_parity(htt)
    phase_gpt_parity(htt, kernels)
    phase_gpt_bf16(kernels, fa)
    phase_graph_parity(htt, kernels)
    phase_registry_parity(htt, kernels)
    phase_collectives(htt)
    phase_model_parallel(htt)
    fp8_route = phase_wire(htt, card)
    k1_launches = {}
    k1_launches["momentum"], default_img_sec = phase_main_path(
        kernels, flops_mod, card)
    phase_ef_main_path(kernels, flops_mod, card, default_img_sec, fp8_route)
    frontend_rates = phase_frontend_main_path(htt, card)
    phase_profile(htt, kernels)
    results.update(run_variant_phases(htt, kernels, ew, cb, flops_mod, card,
                                      default_img_sec))
    k1_launches.update(phase_rules(htt, kernels))
    flash, gpt_trace, gpt_none = phase_gpt_main_path(htt, kernels, card)
    phase_trace_plane(htt, kernels, fa, card, gpt_none,
                      frontend_rates["plain"])
    phase_autotune(htt, kernels, card)
    phase_launcher(kernels, card, gpt_none)
    k1_launches["adam"] = gpt_trace["k1"]["adam"]
    for rule, by_dtype in k1_launches.items():
        results[rule]["launches"] = by_dtype["float32"]
        results[rule]["bf16"]["launches"] = by_dtype["bfloat16"]
    for key, counter in (("K2", "fwd"), ("K3", "bwd_dq"),
                         ("K4", "bwd_dkv")):
        results[key]["launches"] = gpt_trace["launches"][key]
        results[key]["launches_issued_by_mainloop"] = {
            k.split(".")[1]: v for k, v in flash.items()
            if k.startswith(counter + ".")}
    phase_gpt_profile(htt, kernels)
    ring_trace = phase_gpt_sp_main_path(htt, kernels, card, gpt_none)
    for key, k in zip(RING_HOPS, ("K2", "K3", "K4")):
        results[key]["launches"] = ring_trace["launches"][k]
    bert_trace = phase_bert_main_path(htt, kernels, card)
    for key in ("K2", "K3", "K4"):
        results[key]["bert"]["launches"] = bert_trace["launches"][key]
    phase_bert_sp_main_path(htt, kernels, card,
                            phase_bert_adasum(htt, kernels, card))
    registry = phase_registry_main_path(htt, kernels, flops_mod, card)
    results["momentum"]["vgg16"]["launches"] = \
        registry["VGG16"]["k1"]["momentum"]["float32"]
    for key, entry in phase_serving(htt, kernels, ew, cb, flops_mod,
                                    card).items():
        results[key]["serving"] = entry
    phase_elastic(htt, kernels, card)
    htt.shutdown()

    emit({"kernels": [results[r] for r in ("momentum", "sgd", "adam", "K2",
                                           "K3", "K4", *RING_HOPS,
                                           *VARIANT_KEYS)],
          "launches": LAUNCHES_NOTE, "card": card,
          "seconds": time.perf_counter() - T_START})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
