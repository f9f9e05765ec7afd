"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which succeeds or raises (a failure exits non-zero and
prints no ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, and torch's device name;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   (all sources at once), and time the build;
3. each kernel against its plain PyTorch version on the card, on ragged
   inputs (fp32 with TF32 matmuls off, rtol = atol = 3e-5 for attention
   and 3e-4 for the SSD scan; bf16, rtol = atol = 2e-2; length-0 decode
   rows exactly zero, Sq != Sk flash, G > 1 SSD; flash at Sq and Sk of 1
   and of its tile sizes +-1; decode of one 30000-token row of a 32768
   cache over many splits, and lengths on split boundaries; paged decode
   with -1 table entries past and below a row's length, lengths on and
   beside its split and block boundaries, block sizes 16, 32 and 128, a
   one-column table, and qwen2-moe-a2.7b's MHA shape (H = KV = 16, D 128)
   at the main path's mid-decode lengths and on ragged lengths with a
   length-0 row; dense decode at zamba2-7b's shared block, H = KV = 32,
   D 112, the same way, and at whisper-medium's cross-attention (H = KV
   = 16, D 64, S 1500, all lengths 1500) and self-attention (S 448); the
   SSD scan at b 1 and 2, one chunk and
   several, and at the shapes phase 10's prefills give it: mamba2-780m's
   and zamba2-7b's heads at each workload prompt length, padded as
   ``kernels.ops.ssd`` pads it, and a rank's half of those heads (phase
   13e-f); dense decode at phase 13's rank shapes: zamba2's shared block
   at 16 of 32 heads and whisper's cross- and self-attention at 8 of 16;
   paged decode at phase 13h's rank shapes: tinyllama's 16 of 32 heads
   and 2 of 4 KV heads, 8 rows, and qwen2-moe's MHA shape at 4 of 8
   rows; every head and state width the Pallas kernels take: flash at
   zamba2-7b's D 112 (H = KV = 32) and stablelm-12b's D 160 (H 32, KV 8),
   causal and not, also through ``ops.flash_attention_bshd``, and at D
   80, 96, 192, 72 and 100 (bf16: the ``pad_head_dim`` route); the SSD
   scan at P 128, N 256, P 96 with N 192, P 24 with N 40 and P 20 with N
   12 (bf16: the ``pad_dims`` route); dense and paged decode at D 100
   and 98 on ragged lengths with a length-0 row),
   with the count of tensor-core instructions (``cuobjdump -sass``: HGMMA
   in each bf16 flash kernel, HMMA in each bf16 SSD kernel with products)
   and each split-K decode call's grid; then each timed beside its bound,
   its plain version's time and the library call's (SDPA for the attention
   kernels; none for the paged and SSD kernels), with each kernel's share
   of a call's critical path from the profiler: paged decode at the main
   path's decode shapes (tinyllama-1.1b's heads, and qwen2-moe-a2.7b's
   for phase 9), flash at tinyllama-1.1b and gemma-7b prefill
   widths (S 2048) and at stablelm-12b's (D 160) and zamba2-7b's (D
   112), dense decode at tinyllama's and zamba2-7b's (B 8,
   S 1024) and whisper-medium's cross-attention (B 8, S 1500), the SSD
   scan at mamba2-780m's (L 2048 and 768) and
   zamba2-7b's (L 768); and phase 13's rank shapes on model 2: dense
   decode at a rank's heads of tinyllama (16 of 32), zamba2 (16 of 32)
   and whisper's cross-attention (8 of 16), at qwen2-moe's 4 rows, and
   the SSD scan at mamba2's 24 of 48 heads and zamba2's 56 of 112 (L
   768); paged decode at 13h's two rank shapes (no library call computes
   paged attention); and phase 16's: paged decode at llama2-13b's (H = KV
   = 40, D 128), gemma-7b's (H = KV = 16, D 256), stablelm-12b's (H 32,
   KV 8, D 160) and chameleon-34b's (H 64, KV 8, D 128) heads, dense
   decode at gemma-7b's and stablelm-12b's (B 8, S 1024); the gelu
   kernel and its gradient (``kernels.gelu``: jax.nn.gelu's op chain in
   one pass, replacing no Pallas kernel) bit-equal to their plain
   versions in fp32 and bf16, timed at ``GELU_SHAPES`` and
   ``GELU_GRAD_SHAPES`` with torch's fused tanh gelu as the library call;
4. a small fp32 decode step on the card (kernel) against the same step on
   the CPU (plain version), logits within rtol = atol = 1e-4;
5. the main path end to end at full width: tinyllama-1.1b (random bf16
   weights from a seeded torch.Generator, 22 layers), the paged engine
   with the token-budget scheduler and prefix sharing, serving 8 requests,
   its steps as CUDA graphs (the default), then again with
   ``cuda_graphs=False`` (eager); each engine then serves 8 more requests
   of the same lengths, warm. The launch counts are reset just before and
   read just after each engine's runs (a graph replay counts the launches
   its capture recorded: ``serving.graphs.launches_run``); steady decode
   steps run under ``torch.cuda.set_sync_debug_mode("error")`` and make
   one host sync each, but for a step that captured a graph, which is
   reported apart. Gates: the graph and eager streams token-identical,
   launches = layers x decode steps, replays = decode steps less
   captures, no capture in the warm run. One decode step's logits are
   held against the "gather" attention path, in bf16 (relative L2 2e-2)
   and in fp32 (1e-4); two more runs, profiled (graphs and eager), record
   where a decode step's time goes and the device's idle share;
6. the kernel API (``kernels.ops``) at full width, its launch counts
   reset just before and read just after: flash at S 2000 and decode
   against a 1000-position cache (both padded as the reference pads), the
   SSD scan at L 2000, each within 2e-2 relative L2 of its plain version;
   then one full-width mamba2-780m mixer layer (B 1, S 2048, random
   weights) through the SSD kernel against the same layer through
   ``ssd_chunked``, within 2e-2 relative L2 in bf16 and 1e-4 in fp32;
7. the module-scaling loop at full width: an ``Orchestrator`` of two
   engines on the card (phase 5's bf16 weights and workload, all 8
   requests on instance 0). Stop-the-world (``migrate_requests``) and
   two-phase (``migrate_requests_overlapped``, 3 overlap steps) moves of
   every decoding request to the empty instance 1, the moves themselves
   under sync-debug "error" with only the counted syncs allowed: every
   request resumed, every imported block bit-equal to its payload, the
   source left with no block, nothing dropped, and the streams
   token-identical to phase 5's unmigrated run (the stop-the-world moves
   are then repeated 1 -> 0 -> 1, export and import timed apart); a
   mixed, then an all-ones replication plan applied mid-decode on
   instance 1 (streams unchanged, part of that gate); a violating
   snapshot turned by the controller into a scale-down that migrates off
   instance 0 (greedy agreement printed, not gated). The engines run their
   steps as CUDA graphs; no move captures a graph or rebinds a pool tensor
   (counts and addresses before and after each move). The paged kernel's
   launches over the phase equal layers x decode steps of every engine.
   It prints bytes moved, the
   stop-the-world time and the two-phase stall per request, and
   ``fit_migration_model`` on the card beside ``estimate_cost``'s
   defaults;
8. the remote plane at full width: two engine-server processes brought
   up by ``launch.pod.launch_pod`` on the one card (each its own CUDA
   context, phase 5's engine settings, phase 5's weights sent over the
   wire as the init stream), driven by an ``Orchestrator`` over TCP
   loopback. First an ``Ingress`` in front: 8 prompts (phase 5's
   lengths, other tokens) as HTTP completions, the even ones streamed,
   every stream token-identical to the same requests on an in-process
   engine per server (same weights and ``max_batch``); then phase 5's
   workload on server 0 moved to server 1 stop-the-world, and its warm
   workload moved two-phase (3 overlap steps), over the RPC wire: every
   moved block read back bit-equal from server 1 and every stream
   token-identical to phase 5's. Each server reports through ``info``
   its pid and device (gated to be a CUDA child, not this process), its
   paged launches (gated: layers x its decode steps) and its host syncs
   per steady step (gated: 1); nothing dropped; both servers are joined
   and must exit 0. It prints each server's bring-up (spawn to
   connection, weight bytes and seconds, first ready), TTFT and tok/s
   over HTTP, each server's steady step, and bytes and ms per request
   moved over RPC beside phase 7's in-process figures;
9. qwen2-moe-a2.7b at full width, after phases 5-8's weights and engines
   are freed: random bf16 weights (fp32 router) from a seeded
   torch.Generator, 60 routed experts padded to 64, top-4, 4 shared,
   every MoE layer through the scatter dispatch; phase 5's engine
   settings and workload (prompts below qwen's vocab), once through CUDA
   graphs and once eager, each cold and then warm, with phase 5's gates
   (streams token-identical, launches = layers x decode steps, replays =
   steps - captures, no capture in the warm run, one host sync per
   steady step under sync-debug "error"); one decode step through the
   kernel against the gather path: each paged-kernel call against its
   plain version (2e-2), the bf16 logits (2e-2) over the rows whose
   top-4 experts agree with the gather route's in every layer (a
   rounding difference can flip a row's experts, which moves its logits
   far more), the first 12 layers widened to fp32 (1e-4, and the same
   experts in every row and layer: past layer 10, where the bf16 routes'
   first experts flip), with the kernel's layout run through the plain
   paged attention printed beside them as a witness that the flips are
   rounding; a profiled window of 4 steady graph steps; then one stop-the-world
   move of all 8 decoding requests to a second engine sharing the
   weights dict (every imported block bit-equal to its payload, 3 host
   syncs per move, streams token-identical to the unmigrated graph run).
   It prints the weight bytes held and the peak memory, the steady step
   beside the weight-read bound (every weight but the embedding over
   3.35 TB/s), TTFT and tok/s, the captures, and the move's bytes and ms.
   The paged kernel's launches in the JSON line add phase 9's to phase
   5's;
10. the dense-cache engine (``Engine(cache_kind="dense")``), after phase
   9's weights are freed, at phase 5's engine settings (``max_batch`` 8,
   ``max_len`` 1024, bf16) and workload (prompts below each model's
   vocab), each model through graphs and eagerly, cold then warm, with
   phase 9's gates (streams token-identical, replays = steps - captures,
   no capture warm, one host sync per steady step) and launch gates
   (dense decode = attention applications x decode steps, the SSD scan
   = Mamba2 layers x prefills):
   a. tinyllama-1.1b (phase 5's weights drawn again): the dense-decode
      kernel against the gather route on the first steady step (relative
      L2 2e-2) and whole greedy streams (agreement printed); a dense and
      a paged engine that each prefilled the 8 prompts whole, one decode
      step fed the same tokens (2e-2), and the dense streams' agreement
      with phase 5's;
   b. the sliding-window ring at the config's own window W = 8192: 2
      requests of W + W / 64 = 8320-token prompts, 16 new tokens,
      ``max_len`` W + W / 16 = 8704 (capacity W), once in one shot and
      once with ``prefill_chunk`` W / 4; the ring wrapped (no row holds
      position 0); first-token and decode logits against the paged
      engine with ``swa=True`` on the same requests (2e-2);
   c. mamba2-780m and d. zamba2-7b at full width but cut depth (6 of
      48 layers; 13 of 81: two applications of the shared block, each
      over its own KV cache, and a tail layer), random bf16 weights from a seeded generator (their
      bytes equal to the reference's ``init_params`` at that depth): the
      kernel routes against the plain ones (the
      SSD kernel against ``ssd_chunked`` on every prompt's first-token
      logits; the dense-decode kernel against the gather route on the
      first steady step), ``prefill_chunk=256`` against the one-shot
      prefill (the last chunk's logits of every prompt, 2e-2; greedy
      agreement printed), a profiled window of 4 steady graph steps, the
      steady step beside its weight-read bound (every weight once over
      3.35 TB/s), the cache bytes and the peak device memory.
   The dense-decode and SSD rows of the JSON line add the graph runs'
   cold launches (a: 22 a step, d: 1; c: 6 a prefill, d: 7) to their
   kernel-API launches, with each timed shape in ``shapes``;
11. MLA and the encoder-decoder on the dense-cache engine, after phase
   10's weights are freed, each model at full width in bf16 (random
   weights from a seeded generator, their bytes and the cache's equal
   to the reference's), phase 5's workload through graphs and eagerly,
   cold then warm, with phase 10's gates:
   a. minicpm3-4b (8 of its 62 layers, MLA with q rank 768, kv rank 256, rope
      32), ``max_len`` 1024: dense-decode launches gated to 0 (MLA
      attends plainly, as the reference does); one decode step of an
      engine's live cache (the absorbed form) against one prefill over
      each prompt plus its token (the expanded form), in fp32 within
      1e-4 relative L2 (bf16 printed); ``prefill_chunk=256`` against one
      shot (last-chunk logits in fp32 1e-4; greedy agreement printed);
   b. whisper-medium (12 of its 24 encoder and 12 of its 24 decoder
      layers), ``max_len``
      448 (its decoder's context), prompts capped at 416 tokens, frames
      [1, 1500, 1024] from an ``encoder_input_fn`` drawing them on the
      card seeded by request id: dense-decode launches = 2 x decoder
      layers x decode steps (self- and cross-attention); on the first steady step every
      kernel call against its plain version (2e-2) and the logits of the
      kernel routes against the gather routes (bf16 2e-2, fp32 1e-4);
   each with the steady step beside its bound (a: every weight once; b:
   the decoder's weights read by a step, the lm_head, the cross K/V and
   the self K/V rows the first steady step's lengths reach), a
   profiled window of 4 steady graph steps and the peak device memory.
   The dense-decode row adds b's launches and phase 3's S 1500 shape;
12. module replication across ranks: two spawned rank processes share
   the card (``torch.cuda.set_device(0)``) in a gloo group over a
   ``TCPStore`` (NCCL refuses two ranks on one device), so this phase
   shows the program right, not replication's speed. Rank 0 draws phase
   5's tinyllama-1.1b weights, ``replicate_params_for_plan`` broadcasts
   them (timed; the ranks' weights bit-equal). Each rank serves phase
   5's workload through eager ``Engine(group=...)`` engines in the same
   order of calls: in bf16 at degree 1 (streams equal to phase 5's),
   under degree 2 on layers 0-10 (a logit probe against degree 1 within
   2e-2 relative L2; one replicated step profiled: 22 paged split
   kernels and 22 launches a rank) and under degree 2 on every other
   layer; in fp32 at degree 1, under both plans and under a plan changed
   mid-stream (degree 2 everywhere at step 3, all ones at step 6; at
   step 4 rank 1's pool is zeroed and re-placed from rank 0 by
   ``migrate_paged_pool``), the greedy streams equal to degree 1's but
   where a top-2 tie within 1e-4 flips. Gates: the ranks' tokens equal
   at every step and their pools bit-equal after every run; paged
   launches = 22 x decode steps; each replicated step's all-gathers as
   the hooks predict (12 contiguous, 22 fragmented, 23 everywhere);
   ``migrate_by_path`` of the attention weights moves ``tree_bytes``
   and restores rank 1's zeroed copy; every paged-kernel call of one
   steady replicated step (bf16 contiguous, fp32 fragmented: a
   replicated layer's 4 of 8 rows a rank) against its plain version,
   relative L2 within 2e-2 in bf16 and 1e-4 in fp32, on each rank (phase
   3 checks that shape too, with inert rows). Printed: steady step times
   (eager, degree 1 against replicated), collectives and host syncs per
   step, one staged all-reduce alone. The paged row of the JSON line
   adds both ranks' launches and phase 3's replicated shape (rows 0-3).
   Then re-placement (``migrate_by_path`` / ``migrate_kv_cache``, each
   rank sent only the part of a leaf it lacks, one all-to-all a leaf):
   rank 0 draws llama2-13b at published width, ``REPLACE_LAYERS`` of 40
   layers, and a bf16 dense KV cache of 8 rows x 1024; rank 1 holds
   ``meta`` placeholders of both. a. the attention projections split
   over r0 on their heads (wo on its rows); b. back replicated; c. every
   other leaf replicated, w_up / w_down split on d_ff (each rank holds
   its half already) and replicated again; d. the cache split on its KV
   heads, then replicated; e. one paged decode step (8 rows) on the
   re-placed weights through the paged-decode kernel. Gates: after each
   move each rank's leaves bit-equal to rank 0's original slices
   (``bits_checksum`` sent as plain values), the bytes each rank received
   equal to the plan's (``planned_bytes``) and to the share of the move
   ``REPLACE_MOVES`` states (0 for c's split, half the leaves for its
   return), one all-to-all a leaf and none for c's split; rank 1's peak
   device memory over a grown by its shards and at most
   ``REPLACE_SLACK``; e's logits bit-equal on both ranks and to rank 0's
   step before any move, ``REPLACE_LAYERS`` paged launches a step.
   Printed: bytes received per rank, seconds and ``estimate_cost`` per
   move. The paged row adds e's launches.
13. the reference's sharded serving step (``repro_torch.parallel``): two
   spawned rank processes share the card, each building its meshes as
   gloo groups (one per axis line) over a ``TCPStore``, each drawing
   phase 5's full weights and keeping its shard (``shard_params`` under
   ``param_specs``), its rows and its cache shard (``init_cache_shard``),
   and running ``forward`` under ``use_rules`` in fp32 and bf16, eagerly
   (every collective stages through the host). Rank 0 runs the
   unsharded ``forward`` on the same weights, fed the sharded run's
   tokens, as the reference. First a probe of gloo on CUDA tensors (MAX
   all-reduce, its own all-to-all). a. tensor parallel: tinyllama-1.1b
   on (data 1, model 2) under ``rules_for`` (heads, KV heads, d_ff and
   vocab split), phase 5's 8 prompts over a 1024-slot dense cache and
   ``TP_STEPS`` greedy decode steps through the dense-decode kernel at a rank's 16
   of 32 heads: fp32 tokens equal and logits within 1e-4, bf16 last-step
   logits within 2e-2, every dense-decode call of decode step 3 against
   ``decode_attention_ref`` (1e-4 / 2e-2), collectives per decode step as
   ``predicted_collectives`` says, launches = 22 x steps a rank; b.
   distributed flash-decoding: tinyllama-1.1b at ``LONG13_LAYERS`` of 22
   layers on (data 2, model 1) under
   ``long_context_rules`` + ``flash_decode`` (the reference's long_500k
   step): batch 1, an 8320-token prompt wrapping the 8192-slot ring of
   the window, 4096 slots a rank, 16 decode steps; fp32 tokens and
   logits (1e-4) against the unsharded ring, bf16 logits (2e-2), each
   rank's (m, l, o) partial of every layer at one step against plain
   attention over its slice; c. the same for minicpm3-4b's
   ``flash_decode_mla`` at ``MLA13_LAYERS`` of 62 layers; d. expert
   parallel: qwen2-moe-a2.7b at ``EP_LAYERS`` of 24 layers on (data 2,
   model 1) under ``rules_for`` + ``moe_a2a``, 32 of 64 experts and 4 of
   8 rows a rank, decoding 16 steps from rank 0's unsharded prefill
   cache (each rank's rows handed over by an all-reduce): dropped slots
   per step (none predicted), tokens and fp32 logits against the
   unsharded ``dispatch="dense"`` stream where nothing drops, bf16
   first-step logits over the rows whose experts agree, and the
   expert-parallel prefill's drops; e-g. the ssm, hybrid and audio
   families on (data 1, model 2) under ``rules_for``
   (``FAMILY13``): mamba2-780m at 6 of 48 layers (a rank's 24 of 48
   SSD heads; the gated norm's sum of squares summed across the ranks),
   zamba2-7b at one block of 6 layers and a tail layer (56 of 112 SSD
   heads, the shared block at 16 of 32 attention heads through the
   dense-decode kernel), whisper-medium at 4 encoder and 4 decoder
   layers (8 of 16 heads, self- and cross-attention through the
   dense-decode kernel, frames drawn on the card); phase 10's 8 prompts
   (an SSM's each prefilled alone through the SSD kernel into its row of
   the cache shard, whisper's cut to 416 and prefilled together), 16
   greedy decode steps in fp32, then in bf16 fed the fp32 tokens: fp32
   tokens equal and logits within 1e-4 of the unsharded ``forward``,
   bf16 logits no more than 2e-2 farther from the unsharded fp32 ones
   than the unsharded bf16 ones are (``tests/_bf16_gap.py``'s rule),
   every SSD call of the first prefill against ``ssd_chunked`` and
   every dense-decode call of decode step 3 against
   ``decode_attention_ref`` (1e-4 / 2e-2), collectives per prefill and
   per decode step as ``predicted_collectives`` says, SSD launches =
   Mamba2 layers x prefills and dense-decode launches = calls a step x
   steps, a rank; h. the paged decode step under sharding rules
   (``forward_paged``, ``PAGED13``): tinyllama-1.1b at full width and
   depth on (data 1, model 2) and qwen2-moe-a2.7b at 13d's depth on
   (data 2, model 1) with ``moe_a2a``, phase 5's 8 prompts prefilled by
   rank 0's unsharded ``forward`` and handed over, each rank keeping its
   rows and KV heads in its own pool (``paged_kv.init_paged_shard``),
   ``PAGED_STEPS`` paged decode steps through the paged-decode kernel at
   a rank's heads, fp32 then bf16 fed the fp32 tokens, against rank 0's
   unsharded ``forward_paged`` on the whole pool (``dispatch="dense"``
   for the MoE): fp32 tokens equal and logits within 1e-4, bf16 no more
   than ``BF16_GAP`` farther from the unsharded fp32 than the unsharded
   bf16 (over the rows whose experts agree so far), each rank's pool
   after the steps against its slice of the unsharded pool (1e-4 / 2e-2),
   every paged call of step 3 against ``paged_decode_attention_ref``,
   collectives per step as 13a's and 13d's, paged launches = layers a
   step a rank; i. after 13b's and 13c's steps, two multi-token decodes
   (``forward`` in decode mode, S > 1) over the same split rings: 4
   tokens, then an extension whose writes cross from rank 0's half of
   the ring into rank 1's, held against rank 0's unsharded ``forward``
   over the same tokens (fp32: last-row argmax equal, logits 1e-4, each
   rank's partials of the extension's rows against plain attention over
   its slice; bf16 by ``BF16_GAP``), 3 x layers collectives a call (13b and
   13c's bf16 streams are fed the fp32 tokens). Printed beside each
   part: the eager decode step's median on each rank and the unsharded
   step's. The dense-decode and SSD rows of the JSON line add both
   ranks' launches of 13a, 13d and 13e-g and phase 3's rank shapes of
   them; the paged row 13h's.
14. the training path (``repro_torch.training``, ``launch.train``), on
   the plain routes: a. ``launch.train.main`` on tinyllama-1.1b at full
   width with the reference's defaults (batch 8, seq 128, lr 1e-3), fp32
   (TF32 off) and bf16, ``TRAIN_STEPS`` steps each (final loss finite),
   then the same step timed on ONE repeated batch (losses finite and
   falling by more than ``TRAIN_FALL`` nats): the median synchronised
   step, tokens/s, the model FLOPs by the reference's convention
   (``model_flops_train``) and their share of the type's dense peak, and
   the peak memory against params + grads + moments; the bf16 step
   profiled (``train_profile.txt``); b. bf16 loss and gradients at batch
   8 x seq 1024 with and without ``remat`` (each leaf within 1e-6,
   relative L2; peak memory of each); c. one fp32 train step of each
   reduced config (``TRAIN_CHECK_ARCHS``) on the card against the CPU
   port from the same weights (loss 1e-5, each gradient leaf and updated
   parameter 1e-4); a and b also print the dry run's memory prediction
   of one step (arguments + temp, ``launch.dryrun.MemoryTally`` over the
   same call on meta copies of its arguments) beside
   ``torch.cuda.max_memory_allocated()`` over that call, gated within
   ``MEMORY_TOL`` (a's bf16 step, b's remat call); d. (at
   ``TRAIN_CUT_LAYERS`` of 22 layers) a bf16
   checkpoint of params and moments after one step, saved and loaded
   with ``like=``, the next step bit-equal to the uninterrupted one (file
   bytes, save and load seconds); e. (the same depth)
   ``make_train_step_accum`` over 4 micro-batches against one step on
   the same unmasked fp32 batch (first moments, loss, grad norm 1e-5);
   f. qwen2-moe-a2.7b at ``TRAIN_MOE_LAYERS`` of 24 layers, bf16 with
   bf16 moments, two steps through the scatter dispatch's backward
   (finite loss and aux loss; step ms, peak memory); g. the four kernel
   wrappers' launch counts unchanged across the phase, and each wrapper
   raising, unlaunched, on an input that requires grad; the gelu kernel
   and its gradient launched (14c's whisper-medium on the card: the
   gradient row's launches in the JSON line).
15. the sharded train step (``training.train`` under sharding rules, the
   collectives' backward from ``parallel.mesh``): two more spawned rank
   processes, each building ``RankMesh``es (gloo groups per axis line)
   over a ``TCPStore``, fp32 (TF32 off) from phase 5's seeded weights,
   batch 8 x seq 128 from ``sharded_batches``: a. tinyllama-1.1b at full
   width and ``P15_TP_LAYERS`` of 22 layers, tensor parallel on (data 1,
   model 2), 3 steps; b. the same at ``P15_DP_LAYERS`` of 22 layers data
   parallel on (2, 1);
   c. qwen2-moe-a2.7b at
   ``P15_MOE_LAYERS`` of 24 layers on (2, 1), experts on ``data``, the
   scatter dispatch (2 steps), then the all-to-all dispatch
   (``rules["moe_a2a"]``, 2 steps on one repeated batch); e. mamba2-780m
   at 13e's 6 layers, head-split on (1, 2), 3 steps; f. whisper-medium
   at 13g's depth, data parallel on (2, 1), 3 steps, each rank's rows of
   the frames from ``sharded_batches(..., frames=True)``. Gates: each
   step's collectives by phase (forward, backward, update) and kind equal
   to ``p15_predicted`` and to ``launch.dryrun``'s count of the same case
   on ``RankMesh.dry``; each rank's bytes of params and moments equal the
   dry run's ``params`` + ``opt_state`` bytes; the losses within 1e-5
   of the unsharded step on the same weights and global batches (run on
   each rank in turn), and each rank's params and both moments within
   1e-4 relative L2 of their slices of the unsharded step's (a, b, and
   c after its first step: its routing is discontinuous, and Adam turns
   the two steps' ~1e-6 differences into expert ids that differ later,
   printed by step and layer; the first step's ids are gated equal;
   and f); e's shards are gated in float64: step 1 again in float64
   (``float64_math``), sharded and unsharded from the same weights,
   within ``F64_TOL`` of each other, since in float32 the unsharded step
   alone lies 3.2e-4 from the float64 one on ``conv_x_b`` (Adam's first
   update of a zero bias whose gradient holds entries near eps grows
   rounding); e prints its float32 shards after each step, the
   unsharded step from weights one float32 ulp apart against itself,
   and each float32 step 1's distance from the float64 one;
   the ranks' losses equal; the all-to-all dispatch's aux loss finite and
   its loss falling (it routes per rank: no unsharded twin); a and b's
   bf16 run of ``TRAIN_STEPS`` on one repeated batch falling by more
   than ``TRAIN_FALL``; d. the four kernel counters unchanged here and on
   both ranks. Printed: step ms, tokens/s, the staged collectives' ms by
   phase (the data-parallel gradient sums are the largest), collective
   bytes, peak memory (a's beside the dry run's memory prediction of the
   rank's step, gated within ``MEMORY_TOL``), the unsharded step's ms.
16. the paper's own evaluation model, llama2-13b, and gemma-7b,
   stablelm-12b and chameleon-34b at their published widths and depths in
   bf16, one at a time on the card emptied of phase 15's ranks (device
   memory allocated printed before each): a. each through the paged
   engine at phase 5's settings and workload, graphs and eager, cold and
   warm, with phase 5's gates (paged launches = layers x decode steps:
   40, 28, 40, 48 a step); a graph run whose first steady step is probed
   on the live pool (each paged call against its plain version, 2e-2;
   the bf16 logits kernel vs gather, 2e-2) and profiled; the steady step
   beside the weight-read bound at 3.35 TB/s; ``init_params``' peak gated
   to the weights + ``INIT_SLACK``; b. gemma-7b (D 256) and stablelm-12b
   (D 160) through the dense engine's graphs, cold and warm (phase 10's
   settings and gates, each dense-decode call against its plain
   version, kernel vs gather); after
   each model is freed, its first ``WIDE_FP32_LAYERS`` layers with the
   probed pool or cache, stashed in host memory, widened to fp32 (TF32
   off): kernel vs gather logits within 1e-4 and greedy tokens equal; c.
   the serving entry point ``launch.serve.run(ServeConfig(arch=
   "llama2-13b", reduced=False, instances=2, requests=24, rps=4))``, the
   live CoCoServe loop (gates: 24 of 24 finished, 0 dropped; printed: the
   controller's actions, migrations with bytes and ms, each engine's
   median decode step). The gelu kernel's launches over the phase (graph
   replays counted through ``launches_run``) are gated above 0: gemma-7b's
   GeGLU runs through it.
17. the README's first quickstarts on the port, each through its
   ``main`` in this process: ``examples/torch_quickstart.py
   --no-reduced`` (tinyllama-1.1b at published width in bf16: a prefill
   and 5 greedy steps, 3 requests through the paged engine's graphs, a
   scale-up plan) and ``examples/torch_shared_prefix.py`` (6 streams
   over one system prompt, sharing off and on, token-identical); gates:
   the reference's banner lines in their output, which is printed.

Logits are compared over the real vocabulary: a padded vocabulary's
padding columns hold -2**20, which would swamp any norm of a difference.
It then prints a JSON line of kernel results, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Longer
logs go to ``chiprun_out/``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import hashlib
import importlib.util
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): memory and compute by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
SEED = 0


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    out = subprocess.run(query, capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_time_ms(fns, reps=5):
    """Device time per call of ``fns`` (a list of closures over distinct
    inputs): the calls are captured once into a CUDA graph and replayed,
    so no host launch overhead lands between them, timed by CUDA events.
    The inputs together exceed the 50 MB L2 cache, so each call finds its
    operands cold, as it does between the layers of a decode step."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        graph.replay()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / (reps * len(fns))


# ------------------------------------------------------- paged decode kernel
def block_table(lengths, bs, width, block_ids):
    """[B, width] int32 table: each row's valid columns take the next ids
    of ``block_ids`` in order; -1 past them."""
    table = np.full((len(lengths), width), -1, np.int32)
    at = 0
    for b, n in enumerate(lengths):
        cols = -(-n // bs)
        table[b, :cols] = block_ids[at : at + cols]
        at += cols
    return table


def paged_inputs(gen, B, H, KV, D, bs, lengths, n_blocks, width, dtype, holes=True):
    """Random pool and query, and a block table of distinct blocks for
    each row's valid columns; -1 entries past them (and, with ``holes``,
    in a column below a row's length too, which reads block 0)."""
    dev = "cuda"
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((n_blocks, KV, bs, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((n_blocks, KV, bs, D), generator=gen, device=dev).to(dtype)
    perm = np.random.default_rng(SEED).permutation(n_blocks)
    tables = block_table(lengths, bs, width, perm)
    if holes:  # a hole below a row's length reads block 0
        for b, n in enumerate(lengths):
            if n > bs:
                tables[b, 0] = -1
                break
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, torch.from_numpy(tables).to(dev), lens


def least_time_ms(nbytes, flops, dtype):
    """Least time for the work: the larger of the bytes over the memory
    rate and the flops over the input type's peak; and which one it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def paged_bound_ms(q, k, lengths, bs):
    """K and V tiles of every valid block read once, q read, out written,
    the table entries and lengths read; 4*H*D flops per valid key."""
    B, H, D = q.shape
    KV = k.shape[1]
    lens = lengths.cpu().numpy().astype(np.int64)
    blocks = int(np.sum(-(-lens // bs)))
    es = q.element_size()
    nbytes = blocks * bs * KV * D * 2 * es + 2 * q.numel() * es + blocks * 4 + B * 4
    flops = 4 * H * D * int(lens.sum())
    return least_time_ms(nbytes, flops, q.dtype)


def paged_grid(PD, B, KV, width, bs):
    """The paged kernel's split grid for a [B, width] table of bs blocks."""
    n_split, span = PD.plan_paged_splits(B, KV, width, bs, PD.sm_count(0))
    return f"grid {B * KV}x{n_split} (splits of {span})"


def check_paged_decode(PD, mid_lens):
    """Kernel against plain version on ragged cases: a length-0 row, -1
    entries past every row's blocks and a -1 hole below one row's length
    (it reads block 0); lengths on and beside the split and block
    boundaries of the main path's grid (width 64, bs 16: 16 splits of
    64); block sizes 16, 32 and 128 (spans of whole blocks); and
    qwen2-moe-a2.7b's decode shape (MHA, H = KV = 16, D 128) at the main
    path's mid-decode lengths ``mid_lens`` and on ragged lengths with a
    length-0 row; and phase 12's replicated shape, one rank's 4 of 8 rows
    (tinyllama's heads, width 64), at the main path's lengths and with
    inert rows (length 0, every table entry -1), as a rank's rows carry
    once slots are free or a batch pads to an uneven shard; and phase
    13h's rank shapes (tinyllama's 16 of 32 heads and 2 of 4 KV heads,
    8 rows; qwen2-moe's MHA shape at 4 of 8 rows); and phase 16a's
    (llama2-13b, gemma-7b, stablelm-12b and chameleon-34b at the main
    path's lengths; D 160 and 256 on ragged lengths too); D 100 and 98,
    rows that are not whole 16-byte vectors in bf16 (8- and 4-byte
    vectors; D 98 in fp32 8-byte), on ragged lengths with a length-0 row.
    Returns the max abs error seen."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # (B, H, KV, D, bs, lengths, table width or None: just enough + 2)
        (8, 32, 4, 64, 16, [37, 0, 16, 32, 1, 600, 17, 255], None),
        (3, 8, 2, 64, 16, [20, 7, 33], None),
        (8, 32, 4, 64, 16, [64, 128, 0, 65, 63, 640, 1, 1024], 64),
        (4, 8, 2, 64, 32, [32, 31, 0, 500], 32),
        (2, 8, 2, 64, 128, [130, 256], 4),
        (1, 32, 4, 64, 16, [1], 1),
        (8, 16, 16, 128, 16, mid_lens, 64),
        (8, 16, 16, 128, 16, [37, 0, 16, 600, 1, 255, 17, 64], None),
        (4, 32, 4, 64, 16, mid_lens[:4], 64),
        (4, 32, 4, 64, 16, [mid_lens[4], 0, mid_lens[6], 0], 64),
        # phase 13h's rank shapes: tinyllama's 16 of 32 heads and 2 of 4 KV
        # heads on model 2; qwen2-moe's 4 of 8 rows on data 2
        (8, 16, 2, 64, 16, mid_lens, 64),
        (4, 16, 16, 128, 16, mid_lens[:4], 64),
        # phase 16a's shapes: llama2-13b (H = KV = 40, D 128), gemma-7b
        # (H = KV = 16, D 256), stablelm-12b (H 32, KV 8, D 160: 20 vectors
        # a bf16 row) and chameleon-34b (H 64, KV 8, D 128); D 160 and 256
        # on ragged lengths with a length-0 row too
        (8, 40, 40, 128, 16, mid_lens, 64),
        (8, 16, 16, 256, 16, mid_lens, 64),
        (8, 32, 8, 160, 16, mid_lens, 64),
        (8, 64, 8, 128, 16, mid_lens, 64),
        (8, 16, 16, 256, 16, [37, 0, 16, 600, 1, 255, 17, 64], None),
        (8, 32, 8, 160, 16, [37, 0, 16, 600, 1, 255, 17, 64], None),
        # head dims whose rows are not whole 16-byte vectors
        (8, 8, 2, 100, 16, [37, 0, 16, 600, 1, 255, 17, 64], None),
        (8, 8, 2, 98, 16, [37, 0, 16, 600, 1, 255, 17, 64], None),
    ]
    worst = 0.0
    for dtype, tol in ((torch.float32, 3e-5), (torch.bfloat16, 2e-2)):
        for B, H, KV, D, bs, lens, width in cases:
            width = width or max(-(-n // bs) for n in lens) + 2
            n_blocks = max(128, sum(-(-n // bs) for n in lens) + 8)
            args = paged_inputs(gen, B, H, KV, D, bs, lens, n_blocks, width, dtype)
            out = PD.paged_decode_attention(*args).float()
            ref = PD.paged_decode_attention_ref(*args).float()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
            zero_rows = [b for b, n in enumerate(lens) if n == 0]
            if zero_rows and not bool((out[zero_rows] == 0).all()):
                raise AssertionError("length-0 row is not exactly zero")
            worst = max(worst, err)
            log(
                f"[kernel] paged_decode {dtype} B={B} H={H} KV={KV} D={D} bs={bs} "
                f"width={width} lengths={lens} {paged_grid(PD, B, KV, width, bs)} "
                f"max_abs_err={err:.3e} (tol {tol})"
            )
    return worst


def time_paged_decode(PD, cfg, lengths, width, smi, n_sets=64):
    """Kernel, plain version and bound at the main path's decode shapes:
    bf16, ``cfg``'s heads, the engine's block size and table width,
    and the row lengths halfway through the engine run's decode. Each of
    ``n_sets`` calls reads its own blocks of one large pool."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bs = 16
    B, H, KV, D = len(lengths), cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n_blocks = n_sets * sum(-(-n // bs) for n in lengths)
    q, k, v, _, ln = paged_inputs(
        gen, B, H, KV, D, bs, lengths, n_blocks, width, torch.bfloat16, holes=False
    )
    perm = np.random.default_rng(SEED).permutation(n_blocks)
    per_set = n_blocks // n_sets
    calls = []
    for i in range(n_sets):
        qi = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        ids = perm[i * per_set : (i + 1) * per_set]
        ti = torch.from_numpy(block_table(lengths, bs, width, ids)).cuda()
        calls.append((qi, ti))

    def over_calls(fn):
        return [lambda qi=qi, ti=ti: fn(qi, k, v, ti, ln) for qi, ti in calls]

    ms = graph_time_ms(over_calls(PD.paged_decode_attention))
    plain_ms = graph_time_ms(over_calls(PD.paged_decode_attention_ref))
    bound_ms, bound_by = paged_bound_ms(q, k, ln, bs)
    parts = split_parts(over_calls(PD.paged_decode_attention))
    log(
        f"[kernel] paged_decode bf16 B={B} H={H} KV={KV} lengths={lengths} "
        f"width={width}, {paged_grid(PD, B, KV, width, bs)} + {B * H} combine "
        f"blocks, profiled critical-path ms {parts}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.1%} of bound [{smi}]"
    )
    return ms, plain_ms, bound_ms, bound_by


# ------------------------------------------- flash, decode and SSD kernels
TOLS = ((torch.float32, 3e-5), (torch.bfloat16, 2e-2))
SSD_TOLS = ((torch.float32, 3e-4), (torch.bfloat16, 2e-2))


def randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def heads_view(gen, B, S, heads, D, dtype, bshd):
    """A [B, heads, S, D] operand: contiguous, or (``bshd``) the
    transposed view of a [B, S, heads, D] tensor, as the kernel API
    passes the model's layout."""
    if bshd:
        return randn(gen, (B, S, heads, D), dtype).transpose(1, 2)
    return randn(gen, (B, heads, S, D), dtype)


def compare(name, out, ref, tol, what):
    """Kernel output against its plain version: assert within ``tol``
    (rtol = atol) and return the max abs error."""
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite output ({what})")
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    log(f"[kernel] {name} {what} max_abs_err={err:.3e} (tol {tol})")
    return err


def expect_bound(name, fn, *args, **kwargs):
    """The wrapper raises ValueError, naming ROADMAP B, for a shape past
    its kernel's bound; the message is printed."""
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        if "ROADMAP B" not in str(e):
            raise
        log(f"[kernel] {name} past its bound raises: {e}")
        return
    raise AssertionError(f"{name}: no raise past the kernel's bound")


def check_flash(FA, ops):
    """Ragged shapes, GQA and MQA, Sq != Sk both ways, D 64/128/256,
    causal and not, contiguous and transposed-view operands; Sq and Sk of
    1, and of the bf16 kernel's tiles +-1 (128 query rows a block; 128
    keys a tile at D 64, 64 at wider heads); zamba2-7b's D 112 (H = KV =
    32) and stablelm-12b's D 160 (H 32, KV 8), causal and not, also
    through ``ops.flash_attention_bshd``; D 80, 96 and 192 (kernel widths
    of their own), D 72 (a multiple of 8 run on the width-80 kernel, its
    columns past 72 zero-filled) and D 100 (in bf16 not a 16-byte row:
    the wrapper's ``pad_head_dim`` route)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [  # (B, H, KV, Sq, Sk, D, causal, bshd)
        (1, 8, 2, 200, 200, 64, True, True),
        (2, 4, 4, 100, 300, 128, True, False),
        (1, 4, 1, 300, 100, 256, True, True),
        (1, 4, 2, 130, 130, 64, False, False),
        (1, 2, 2, 1, 1, 64, True, False),
        (1, 4, 2, 127, 129, 64, True, True),
        (1, 4, 2, 129, 127, 64, False, False),
        (2, 4, 1, 65, 63, 128, True, True),
        (1, 2, 2, 128, 128, 128, False, True),
        (1, 2, 1, 1, 300, 256, True, False),
        (1, 2, 2, 300, 1, 64, True, True),
        # the repo's other head dims: zamba2-7b's attention (H = KV = 32,
        # D 112) and stablelm-12b's (H 32, KV 8, D 160)
        (1, 32, 32, 200, 200, 112, True, True),
        (1, 32, 32, 256, 256, 112, False, True),
        (1, 32, 8, 200, 200, 160, True, True),
        (1, 32, 8, 256, 256, 160, False, True),
        (1, 4, 2, 130, 130, 80, True, False),
        (2, 4, 1, 65, 200, 96, True, True),
        (1, 4, 2, 129, 127, 192, False, False),
        (1, 4, 4, 100, 100, 72, True, True),
        (1, 4, 2, 150, 150, 100, True, True),
    ]
    worst = 0.0
    for dtype, tol in TOLS:
        for B, H, KV, Sq, Sk, D, causal, bshd in cases:
            q = heads_view(gen, B, Sq, H, D, dtype, bshd)
            k = heads_view(gen, B, Sk, KV, D, dtype, bshd)
            v = heads_view(gen, B, Sk, KV, D, dtype, bshd)
            out = FA.flash_attention(q, k, v, causal=causal)
            ref = FA.flash_attention_ref(q, k, v, causal=causal)
            route = " (pad_head_dim)" if dtype == torch.bfloat16 and D % 8 else ""
            what = (f"{dtype} B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} D={D} "
                    f"causal={causal}{route}")
            worst = max(worst, compare("flash_attention", out, ref, tol, what))
        # the kernel API at zamba2-7b's and stablelm-12b's heads, S 300
        # padded to 384 as the reference pads it
        for H, KV, D in ((32, 32, 112), (32, 8, 160)):
            q, k, v = (randn(gen, (1, 300, n, D), dtype) for n in (H, KV, KV))
            out = ops.flash_attention_bshd(q, k, v)
            ref = FA.flash_attention_ref(
                *(ops.pad_time(t, 84).transpose(1, 2) for t in (q, k, v))
            ).transpose(1, 2)[:, :300]
            what = f"{dtype} ops.flash_attention_bshd S=300 H={H} KV={KV} D={D}"
            worst = max(worst, compare("flash_attention", out, ref, tol, what))
    q = randn(gen, (1, 2, 16, FA.MAX_HEAD_DIM + 32), torch.bfloat16)
    expect_bound("flash_attention", FA.flash_attention, q, q, q)
    return worst


def check_decode(DA, mid_lens):
    """Ragged lengths with a length-0 row (exact zeros) and one past S,
    GQA/MHA, D 64/128/256, contiguous and transposed-view caches; one
    30000-token row of a 32768-position cache (132 splits of 256), and
    lengths on and beside the split boundaries of B 8, S 1024 (16 splits
    of 64); zamba2-7b's shared block (H = KV = 32, D 112, the first head
    dim that is not a multiple of 32) at the main path's mid-decode
    lengths and on ragged lengths with a length-0 row, against a
    transposed view of a [B, 1024, KV, D] cache as the dense engine
    passes it; whisper-medium's cross-attention (H = KV = 16, D 64, S
    1500, all lengths 1500) and self-attention (S 448) the same way; the
    rank shapes of phase 13 (tinyllama's and zamba2's heads on model 2,
    whisper's at 8 of 16 heads, qwen2-moe's 4 rows); phase 16b's gemma-7b
    (D 256) and stablelm-12b (D 160) at the main path's lengths and on
    lengths at split boundaries with a length-0 row; D 100 and 98 (rows
    that are not whole 16-byte vectors in bf16, and strides of a
    transposed view that are not either) on ragged lengths with a
    length-0 row."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [  # (H, KV, S, D, lengths, bshd)
        (32, 4, 1024, 64, [37, 0, 16, 1024, 1, 600, 17, 1500], True),
        (8, 2, 200, 128, [20, 0, 199], False),
        (16, 16, 300, 256, [300, 5], True),
        (32, 4, 32768, 64, [30000], True),
        (32, 4, 1024, 64, [64, 256, 0, 65, 63, 640, 1, 1024], False),
        (32, 32, 1024, 112, list(mid_lens), True),
        (32, 32, 1024, 112, [0, 1, 63, 64, 65, 640, 1023, 1024], True),
        # whisper-medium's decoder: cross-attention over the 1500 encoder
        # frames (every row's length 1500; S not a multiple of 64, so the
        # last split is partial) and self-attention over its 448 rows
        (16, 16, 1500, 64, [1500] * 8, True),
        (16, 16, 448, 64, [0, 1, 63, 64, 65, 300, 447, 448], True),
        # phase 13's local heads: tinyllama-1.1b on model 2 (16 of 32
        # heads, 2 of 4 KV heads) and qwen2-moe-a2.7b's 4 rows a rank
        (16, 2, 1024, 64, list(mid_lens), True),
        (16, 16, 1024, 128, list(mid_lens[:4]), True),
        # 13f / 13g: zamba2-7b's shared block at 16 of 32 heads, and
        # whisper-medium's cross- and self-attention at 8 of 16
        (16, 16, 1024, 112, list(mid_lens), True),
        (8, 8, 1500, 64, [1500] * 8, True),
        (8, 8, 448, 64, [0, 1, 63, 64, 65, 300, 447, 448], True),
        # phase 16b: gemma-7b (H = KV = 16, D 256) and stablelm-12b (H 32,
        # KV 8, D 160) against their dense caches
        (16, 16, 1024, 256, list(mid_lens), True),
        (32, 8, 1024, 160, list(mid_lens), True),
        (16, 16, 1024, 256, [0, 1, 63, 64, 65, 640, 1023, 1024], True),
        (32, 8, 1024, 160, [0, 1, 63, 64, 65, 640, 1023, 1024], True),
        # head dims whose rows are not whole 16-byte vectors
        (8, 2, 300, 100, [0, 1, 63, 64, 65, 200, 299, 300], True),
        (8, 2, 300, 98, [0, 1, 63, 64, 65, 200, 299, 300], True),
        (8, 8, 200, 98, [20, 0, 199, 5], False),
    ]
    worst = 0.0
    for dtype, tol in TOLS:
        for H, KV, S, D, lens, bshd in cases:
            B = len(lens)
            q = randn(gen, (B, H, D), dtype)
            k = heads_view(gen, B, S, KV, D, dtype, bshd)
            v = heads_view(gen, B, S, KV, D, dtype, bshd)
            ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = DA.decode_attention(q, k, v, ln)
            ref = DA.decode_attention_ref(q, k, v, ln)
            n_split, span = DA.plan_splits(B, KV, S, DA.sm_count(0))
            what = (
                f"{dtype} B={B} H={H} KV={KV} S={S} D={D} lengths={lens[:8]} "
                f"grid {B * KV}x{n_split} (splits of {span})"
            )
            worst = max(worst, compare("decode_attention", out, ref, tol, what))
            zero_rows = [b for b, n in enumerate(lens) if n == 0]
            if not bool((out[zero_rows] == 0).all()):
                raise AssertionError("decode_attention: length-0 row is not zero")
    return worst


def tensor_core_counts(lib_path, tag, opcode):
    """Tensor-core instructions (``opcode``: HGMMA for wgmma, HMMA for
    mma.sync) in each kernel of the built library whose name holds
    ``tag``, from ``cuobjdump -sass``; fails without cuobjdump or when a
    kernel has none."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"
    )
    sass = subprocess.run(
        [tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True,
        timeout=120,
    ).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if tag in fn:
                counts[fn] = 0
        elif fn in counts and opcode in line:
            counts[fn] += 1
    if not counts or min(counts.values()) == 0:
        raise AssertionError(f"kernels '{tag}' without {opcode}: {counts}")
    return counts


def hgmma_counts(lib_path, widths):
    """HGMMA count of each bf16 flash kernel, one a kernel width."""
    counts = tensor_core_counts(lib_path, "flash_wgmma_kernel", "HGMMA")
    if len(counts) != len(widths):
        raise AssertionError(f"expected {len(widths)} bf16 flash kernels: {counts}")
    return {f"W={fn.split('ILi')[1].split('E')[0]}": n for fn, n in counts.items()}


def hmma_counts(lib_path):
    """HMMA count of each bf16 SSD kernel with products (chunk states, and
    the chunk scan built for N up to 128 and up to 256; the state passing
    in between is elementwise fp32)."""
    counts = tensor_core_counts(lib_path, "_mma_kernel", "HMMA")
    if len(counts) != 3:
        raise AssertionError(f"expected 3 bf16 SSD product kernels: {counts}")
    return {
        ("state" if "state_mma" in fn else f"scan N<={fn.split('ILi')[1].split('E')[0]}"): n
        for fn, n in counts.items()
    }


def kernel_path_ms(fns, reps=3):
    """Device time each CUDA kernel adds to the stream's critical path, per
    call, by kernel name: torch.profiler traces ``reps`` rounds of the
    calls (launched eagerly), and a kernel counts its end minus the later
    of its start and the end of the kernel before it. A dependent launch
    starts early and waits for its predecessor; only what it adds after
    that end counts, so the parts of a call sum to its device time."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for f in fns:
                f()
        torch.cuda.synchronize()
    trace = ROOT / "chiprun_out" / "kernel_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    kernels = sorted(
        (ev["ts"], ev["ts"] + ev["dur"], ev["name"])
        for ev in events
        if ev.get("cat") == "kernel" and "dur" in ev
    )
    out, prev_end = {}, float("-inf")
    for start, end, name in kernels:
        out[name] = out.get(name, 0.0) + max(0.0, end - max(start, prev_end))
        prev_end = max(prev_end, end)
    calls = reps * len(fns)
    return {name: us / 1e3 / calls for name, us in out.items()}


def split_parts(fns):
    """Profiled critical-path ms per call of a split-K decode call's two
    kernels."""
    return short_names(kernel_path_ms(fns), ("split_kernel", "combine_kernel"))


def short_names(times, tags):
    """{tag: ms} for the first kernel name holding each tag."""
    out = {}
    for tag in tags:
        hit = [ms for name, ms in times.items() if tag in name]
        out[tag] = hit[0] if hit else None
    return out


def ssd_inputs(gen, b, L, H, G, P, N, dtype):
    """Inputs shaped like the reference's kernel tests: x * 0.5,
    dt = softplus(randn) in fp32, A = -exp(0.3 randn), B and C * 0.3."""
    x = randn(gen, (b, L, H, P), dtype, 0.5)
    dt = torch.nn.functional.softplus(randn(gen, (b, L, H), torch.float32))
    A = -torch.exp(randn(gen, (H,), torch.float32, 0.3))
    Bm = randn(gen, (b, L, G, N), dtype, 0.3)
    Cm = randn(gen, (b, L, G, N), dtype, 0.3)
    return x, dt, A, Bm, Cm


def serving_ssd_shapes(cfg, prompt_lens):
    """The (b, L, H, G, P, N, Q) shapes the dense engine's prefills give
    the SSD kernel: each prompt alone, L padded as ``kernels.ops.ssd``
    pads it (to a multiple of Q = min(chunk, L))."""
    out = []
    for n in prompt_lens:
        Q = min(cfg.ssm_chunk, n)
        out.append((1, -(-n // Q) * Q, cfg.ssm_heads, cfg.ssm_ngroups,
                    cfg.ssm_head_dim, cfg.ssm_state, Q))
    return out


def check_ssd(SS, serving=()):
    """One and several chunks (one chunk of 96: a query tile of 64 rows and
    one of 32), b 1 and 2, G > 1, P 32/64, N 16-128, chunks 64-256; P 128
    (two slabs of 64 in passes 1 and 3), N 256 (two slabs of 128 in pass
    1, pass 3's wider build), P 24 with N 40 (zero-filled past them to
    the products' steps of 16), P 20 with N 12 (in bf16 not whole 16-byte
    rows: the wrapper's ``pad_dims`` route); then the ``serving`` shapes
    (phase 10's prefills); y and the final state both held."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cases = [  # (b, L, H, G, P, N, Q)
        (2, 256, 4, 2, 64, 128, 128),
        (1, 192, 3, 1, 32, 16, 64),
        (1, 512, 2, 1, 64, 128, 256),
        (2, 512, 4, 1, 64, 128, 256),
        (1, 96, 2, 1, 32, 16, 128),
        (2, 128, 4, 2, 64, 64, 128),
        (1, 256, 2, 1, 128, 64, 128),
        (1, 256, 2, 1, 64, 256, 128),
        (2, 512, 2, 1, 96, 192, 256),
        (1, 192, 4, 2, 24, 40, 64),
        (1, 192, 2, 1, 20, 12, 64),
        *serving,
    ]
    worst = 0.0
    for dtype, tol in SSD_TOLS:
        for b, L, H, G, P, N, Q in cases:
            args = ssd_inputs(gen, b, L, H, G, P, N, dtype)
            y, h = SS.ssd_scan(*args, chunk=Q)
            yr, hr = SS.ssd_scan_ref(*args, chunk=Q)
            if y.dtype != dtype or h.dtype != dtype:
                raise AssertionError(f"ssd_scan: outputs in {y.dtype}/{h.dtype}")
            what = f"{dtype} b={b} L={L} H={H} G={G} P={P} N={N} Q={Q}"
            worst = max(worst, compare("ssd_scan", y, yr, tol, what + " y"))
            worst = max(worst, compare("ssd_scan", h, hr, tol, what + " state"))
    args = ssd_inputs(gen, 1, 64, 2, 1, 64, SS.MAX_N + 16, torch.bfloat16)
    expect_bound("ssd_scan", SS.ssd_scan, *args, chunk=64)
    return worst


def n_sets(per_call_bytes, least=2):
    """Input sets whose operands together exceed the 50 MB L2 cache."""
    return max(least, -(-64 * 2**20 // per_call_bytes))


def time_calls(calls, kernel, plain, library=None):
    """Kernel, plain version and library call (or None) over the same
    argument sets, in ms per call."""

    def over(fn):
        return [functools.partial(fn, *args) for args in calls]

    ms = graph_time_ms(over(kernel))
    plain_ms = graph_time_ms(over(plain))
    lib_ms = graph_time_ms(over(library)) if library is not None else None
    return ms, plain_ms, lib_ms


def report(name, what, ms, plain_ms, lib_ms, bound, smi):
    lib = f"{lib_ms:.5f} ms" if lib_ms is not None else "none"
    log(
        f"[kernel] {name} {what}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"library {lib}, bound {bound[0]:.5f} ms ({bound[1]}), "
        f"{bound[0] / ms:.1%} of bound [{smi}]"
    )


def time_flash(FA, B, S, H, KV, D, smi):
    """Causal bf16 self-attention at [B, S] with H query and KV heads of
    dim D; the library call is SDPA with ``is_causal`` and GQA."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    dtype = torch.bfloat16
    per_call = (2 * B * H * S * D + 2 * B * KV * S * D) * 2
    calls = [
        tuple(randn(gen, (B, n, S, D), dtype) for n in (H, KV, KV))
        for _ in range(n_sets(per_call))
    ]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    q, k, v = calls[0]
    lib_err = (FA.flash_attention(q, k, v).float() - sdpa(q, k, v).float()).abs().max()
    ms, plain_ms, lib_ms = time_calls(
        calls, FA.flash_attention, FA.flash_attention_ref, sdpa
    )
    pairs = sum(min(i + 1, S) for i in range(S))
    bound = least_time_ms(per_call, 4 * B * H * D * pairs, dtype)
    what = (
        f"bf16 causal B={B} S={S} H={H} KV={KV} D={D} "
        f"(max abs vs library {lib_err.item():.3e})"
    )
    report("flash_attention", what, ms, plain_ms, lib_ms, bound, smi)
    return ms, plain_ms, lib_ms, bound


def time_decode(DA, cfg, lengths, S, smi):
    """bf16 decode at tinyllama's heads against a dense [B, S, KV, D]
    cache passed as the kernel API passes it (a transposed view); the
    library call is SDPA with a [B, 1, 1, S] length mask and GQA."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    dtype = torch.bfloat16
    B, H, KV, D = len(lengths), cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
    per_call = (2 * B * KV * S * D + 2 * B * H * D) * 2
    calls = [
        (
            randn(gen, (B, H, D), dtype),
            heads_view(gen, B, S, KV, D, dtype, True),
            heads_view(gen, B, S, KV, D, dtype, True),
            ln,
        )
        for _ in range(n_sets(per_call))
    ]

    def sdpa(q, k, v, ln):
        out = F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True
        )
        return out[:, :, 0]

    ms, plain_ms, lib_ms = time_calls(
        calls, DA.decode_attention, DA.decode_attention_ref, sdpa
    )
    keys = sum(min(n, S) for n in lengths)
    nbytes = (keys * KV * D * 2 + 2 * B * H * D) * 2 + B * 4
    bound = least_time_ms(nbytes, 4 * H * D * keys, dtype)
    n_split, span = DA.plan_splits(B, KV, S, DA.sm_count(0))
    parts = split_parts([functools.partial(DA.decode_attention, *a) for a in calls])
    what = (
        f"bf16 B={B} S={S} H={H} KV={KV} D={D} lengths={lengths}, grid "
        f"{B * KV}x{n_split} = {B * KV * n_split} blocks (splits of {span}) "
        f"+ {B * H} combine blocks, profiled critical-path ms {parts}"
    )
    report("decode_attention", what, ms, plain_ms, lib_ms, bound, smi)
    return ms, plain_ms, lib_ms, bound


def ssd_flops(b, L, H, G, P, N, Q):
    """Least work of the chunked scan: C B^T once per group over each
    chunk's causal pairs; per head the masked scores times x, then C h
    and the state update (2 Q P N flops each)."""
    nc, pairs = L // Q, Q * (Q + 1) // 2
    return b * nc * (G * pairs * 2 * N + H * (pairs * 2 * P + 4 * Q * P * N))


def time_ssd(SS, cfg, L, smi):
    """bf16 SSD scan at the config's widths (b 1, L a multiple of the
    chunk); no library call computes it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    dtype = torch.bfloat16
    H, P, N, G, Q = (
        cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_chunk
    )
    b = 1
    per_call = (2 * b * L * H * P + 2 * b * L * G * N + b * H * P * N) * 2 + (
        b * L * H + H
    ) * 4
    calls = [
        ssd_inputs(gen, b, L, H, G, P, N, dtype) + (Q,) for _ in range(n_sets(per_call))
    ]
    ms, plain_ms, _ = time_calls(calls, SS.ssd_scan, SS.ssd_scan_ref)
    bound = least_time_ms(per_call, ssd_flops(b, L, H, G, P, N, Q), dtype)
    passes = short_names(
        kernel_path_ms([functools.partial(SS.ssd_scan, *a) for a in calls]),
        ("state_mma", "state_pass", "scan_mma"),
    )
    what = (
        f"bf16 b={b} L={L} H={H} G={G} P={P} N={N} Q={Q}, profiled critical-path "
        f"ms per pass {passes}"
    )
    report("ssd_scan", what, ms, plain_ms, None, bound, smi)
    return ms, plain_ms, None, bound


# ---------------------------------------------------- small fp32 reference
def check_small_step(T, PK, get_config):
    """One fp32 paged decode step of a small GQA model: the kernel on
    the card against the plain version on the CPU, same weights/pool."""
    reduced = get_config("tinyllama-1.1b").reduced()
    cfg = dataclasses.replace(reduced, num_heads=8, num_kv_heads=2)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    params_cpu = T.init_params(cfg, gen, "float32")
    lens = [20, 7, 0, 33]
    n_blocks, bs = 32, 8
    shape = (cfg.num_layers, n_blocks, cfg.num_kv_heads, bs, cfg.resolved_head_dim)
    pool = np.random.default_rng(SEED).standard_normal(shape).astype(np.float32)
    logits = {}
    for dev in ("cpu", "cuda"):
        params = _tree_map(lambda t: t.to(dev), params_cpu)
        st = PK.init_paged(
            cfg,
            len(lens),
            n_blocks,
            block_size=bs,
            dtype="float32",
            max_len=64,
            device=dev,
        )
        st.k[:, :n_blocks].copy_(torch.from_numpy(pool))  # the real blocks
        st.v[:, :n_blocks].copy_(torch.from_numpy(pool * 0.5))
        for slot, n in enumerate(lens):
            PK.allocate(st, slot, n + 1)
            st.lengths[slot] = n
        handle = {
            "k": st.k,
            "v": st.v,
            "block_tables": torch.from_numpy(st.block_tables).to(dev),
            "lengths": torch.from_numpy(st.lengths).to(dev),
            "active": torch.tensor([n > 0 for n in lens], device=dev),
        }
        toks = torch.tensor([[3], [5], [7], [11]], device=dev)
        out, _, _ = T.forward_paged(params, cfg, toks, handle, attn_impl="kernel")
        logits[dev] = out.cpu()
    active = [i for i, n in enumerate(lens) if n > 0]
    got, want = logits["cuda"][active], logits["cpu"][active]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    err = (got - want).abs().max().item()
    log(
        f"[small] fp32 decode step, card (kernel) vs CPU (plain): "
        f"max_abs_err={err:.3e} (tol 1e-4)"
    )


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ------------------------------------------------------------- main path
def workload(cfg, seed=SEED):
    """8 requests: prompt lengths from 32 to 600 (four longer than the
    default token budget of 128, so they are chunked), two sharing a
    64-token prefix, 32 new tokens each; greedy but for one sampled.
    Another ``seed`` gives other tokens at the same lengths."""
    rng = np.random.default_rng(seed)
    lens = [600, 32, 200, 96, 130, 64, 300, 80]
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    # the second holder of the prefix is admitted after the first has
    # finished its prefill and published its blocks
    shared = rng.integers(2, cfg.vocab_size, size=64).astype(np.int32)
    prompts[3][:64] = shared
    prompts[7][:64] = shared
    sampled = {6}
    return prompts, sampled


#: phase 5's engine settings, shared by phase 8's engine servers
ENGINE_KW = dict(max_batch=8, max_len=1024, block_size=16, dtype="bfloat16",
                 scheduler="budget", prefix_sharing=True)


def run_engine(
    Engine,
    RequestSpec,
    SamplingParams,
    cfg,
    params,
    impl,
    prompts,
    sampled,
    strict_sync=False,
    probe=None,
    cuda_graphs=True,
    eng=None,
):
    """Serve the workload once, through the engine's CUDA graphs or, with
    ``cuda_graphs=False``, its eager steps. ``strict_sync`` runs the
    steady decode steps (empty queue, nothing mid-prefill) under
    sync-debug "error". Every steady step's host syncs are counted; a
    steady step that captured a graph is kept apart (``capture_steps``:
    step, ms, syncs) from the steps that replayed or ran eagerly.
    ``probe(engine)`` runs once, just before the first steady step.
    ``eng`` serves the workload again on an engine that already ran."""
    from repro_torch.serving import instrument as INS

    eng = eng or Engine(
        cfg, params, paged_attn_impl=impl, device="cuda", cuda_graphs=cuda_graphs,
        **ENGINE_KW
    )
    reqs = []
    for i, p in enumerate(prompts):
        temp, top_k = (0.8, 8) if i in sampled else (0.0, 0)
        sampling = SamplingParams(temperature=temp, top_k=top_k, seed=100 + i)
        spec = RequestSpec(rid=i, prompt=p, max_tokens=32, sampling=sampling)
        reqs.append(eng.submit(spec))
    torch.cuda.synchronize()
    captures0 = dict(eng.graphs.counts.captures)
    t0 = time.perf_counter()
    ttft = {}
    steady_ms, steady_syncs, capture_steps = [], [], []
    steps0 = eng._step_count
    while eng.queue or eng.active or eng.prefilling:
        steady = not eng.queue and not eng.prefilling
        if steady and probe is not None:
            probe(eng)
            probe = None
        captures = sum(eng.graphs.counts.captures.values())
        ts = time.perf_counter()
        if steady and strict_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with INS.count_host_syncs() as syncs:
                eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ms = (time.perf_counter() - ts) * 1e3
        if steady:
            if sum(eng.graphs.counts.captures.values()) > captures:
                capture_steps.append((eng._step_count, round(ms, 3), syncs.n))
            else:
                steady_ms.append(ms)
                steady_syncs.append(syncs.n)
        now = time.perf_counter() - t0
        for r in reqs:
            if r.generated and r.rid not in ttft:
                ttft[r.rid] = now
    torch.cuda.synchronize()
    stats = {
        "wall_s": time.perf_counter() - t0,
        "ttft_s": sorted(ttft.values()),
        "steady_step_ms": sorted(steady_ms),
        "steady_syncs": steady_syncs,
        "capture_steps": capture_steps,
        "decode_steps": eng._step_count - steps0,
        "captures": dict(eng.graphs.counts.captures - collections.Counter(captures0)),
    }
    return eng, reqs, stats


def serve_graphs_and_eager(engine_args, PD, GR, work, smi, after=None):
    """The main path's gated runs: the workload through a fresh engine's
    CUDA graphs, then its warm workload (same lengths, other tokens) on
    the same engine; the same two through a fresh eager engine. The
    launch counts are reset just before and read just after each engine's
    runs. Gates: every request 32 in-vocab tokens, launches = layers x
    decode steps, decode replays = steps - captures and no capture in the
    warm run, one host sync per steady step, prefix hits, and the graph
    and eager streams token-identical. ``work``: (prompts, warm prompts,
    sampled). ``after(engine)``, if given, runs on the graph engine after
    its gated runs (ungated). Returns {"graphs" / "eager": (reqs, warm
    reqs, stats, launches)}."""
    prompts, warm_prompts, sampled = work
    cfg = engine_args[3]
    runs = {}
    for what, graphs in (("graphs", True), ("eager", False)):
        PD.paged_decode_attention.launches = 0
        eng, reqs, stats = run_engine(
            *engine_args, "kernel", prompts, sampled, strict_sync=True,
            cuda_graphs=graphs
        )
        raw = PD.paged_decode_attention.launches
        launches = GR.launches_run(PD.paged_decode_attention, [eng.graphs])
        steps = stats["decode_steps"]
        engine_report(what, eng, reqs, stats, launches, raw, smi)
        _, wreqs, wstats = run_engine(
            *engine_args, "kernel", warm_prompts, sampled, strict_sync=True, eng=eng
        )
        wlaunches = GR.launches_run(PD.paged_decode_attention, [eng.graphs]) - launches
        wraw = PD.paged_decode_attention.launches - raw
        wsteps = wstats["decode_steps"]
        for r in reqs + wreqs:
            if len(r.generated) != 32 or not r.done:
                raise AssertionError(f"{what} rid={r.rid}: {len(r.generated)} tokens")
            if not all(0 <= tok < cfg.vocab_size for tok in r.generated):
                raise AssertionError(f"{what} rid={r.rid}: token out of range")
        L = cfg.num_layers
        if launches != L * steps or steps == 0 or wlaunches != L * wsteps:
            raise AssertionError(
                f"{what}: {launches} / {wlaunches} kernel launches for {steps} / "
                f"{wsteps} decode steps x {L} layers"
            )
        counts = eng.graphs.counts
        if graphs and (
            counts.replays["decode"] != steps + wsteps - counts.captures["decode"]
            or wstats["captures"]
        ):
            raise AssertionError(
                f"decode replays {dict(counts.replays)} for {steps} + {wsteps} "
                f"steps, captures {dict(counts.captures)}, in the warm run "
                f"{wstats['captures']}"
            )
        if not graphs and (counts.captures or counts.replays):
            raise AssertionError(f"eager run captured {dict(counts.captures)}")
        for st in (stats, wstats):
            if set(st["steady_syncs"]) != {1}:
                raise AssertionError(
                    f"{what}: host syncs per steady step {st['steady_syncs']}"
                )
        pstats = eng.prefix_stats()
        if pstats["hits"] < 2:
            raise AssertionError(f"prefix-cache hits: {pstats}")
        engine_report(f"{what}, warm", eng, wreqs, wstats, wlaunches, wraw, smi)
        runs[what] = (reqs, wreqs, stats, launches)
        if graphs and after is not None:
            after(eng)
        del eng
    reqs, wreqs = runs["graphs"][:2]
    for a, b in zip(reqs + wreqs, runs["eager"][0] + runs["eager"][1]):
        if a.generated != b.generated:
            raise AssertionError(f"graph and eager streams differ: rid {a.rid}")
    log(
        f"[engine] {cfg.name}: graph and eager runs token-identical for all "
        f"{len(reqs)} requests of each workload (the sampled ones included); "
        f"prefix hits {pstats['hits']}, cow forks {pstats['cow_forks']}"
    )
    return runs


def paged_probe_inputs(eng):
    """(tokens [B, 1], active rows [B] bool, paged handle) of a decode step
    on a paged engine's live pool that feeds each active request its last
    token, at the engine's pow2 table width."""
    st = eng.pstate
    toks = np.zeros((eng.max_batch, 1), np.int64)
    act = np.zeros((eng.max_batch,), bool)
    for s, r in eng.active.items():
        toks[s, 0] = r.generated[-1]
        act[s] = True
    need = int(st.lengths[act].max()) // st.block_size + 1
    nb = 1 << (need - 1).bit_length()  # the engine's pow2 table width
    tables = np.ascontiguousarray(st.block_tables[:, :nb])
    handle = {
        "k": st.k,
        "v": st.v,
        "block_tables": torch.from_numpy(tables).cuda(),
        "lengths": torch.from_numpy(st.lengths.copy()).cuda(),
        "active": torch.from_numpy(act).cuda(),
    }
    return torch.from_numpy(toks).cuda(), act, handle


def logit_probe(T, cfg, out, fp32):
    """A ``run_engine`` probe: one decode step's logits (over the real
    vocabulary) through the kernel and through the gather path, on the
    engine's live pool (both write
    the same new K/V at the same place, so the state is unchanged), in
    bf16 (``out["rel_err"]``, ``out["max_abs"]``, ``out["finite"]``) and,
    with ``fp32``, again with weights and pool widened (TF32 off), where
    the two paths differ only by summation order (``out["rel_err32"]``)."""

    def probe(eng):
        tk, act, handle = paged_probe_inputs(eng)
        st = eng.pstate

        def rel_err(params, h):
            got = {
                impl: T.forward_paged(params, cfg, tk, h, attn_impl=impl)[0][
                    act, : cfg.vocab_size]
                for impl in ("kernel", "gather")
            }
            out["finite"] = bool(torch.isfinite(got["kernel"]).all())
            d = got["kernel"].float() - got["gather"].float()
            rel = (d.norm() / got["gather"].float().norm()).item()
            return rel, d.abs().max().item()

        out["rel_err"], out["max_abs"] = rel_err(eng.params, handle)
        if fp32:
            p32 = _tree_map(lambda t: t.float(), eng.params)
            h32 = dict(handle, k=st.k.float(), v=st.v.float())
            out["rel_err32"], _ = rel_err(p32, h32)

    return probe


def capture_report(graphs):
    """Per step kind: captures, and the median warm-up and capture ms."""
    by_kind = {}
    for kind, warm, cap in graphs.capture_seconds:
        by_kind.setdefault(kind, []).append((warm * 1e3, cap * 1e3))
    out = {}
    for kind, xs in by_kind.items():
        warm, cap = sorted(x[0] for x in xs), sorted(x[1] for x in xs)
        out[kind] = (len(xs), round(warm[len(xs) // 2], 3), round(cap[len(xs) // 2], 3))
    return out


def engine_report(what, eng, reqs, stats, launches, raw, smi):
    """Print one phase-5 run: tokens, launches, the graphs' captures in
    the run, the engine's captures, replays and pool so far, the steady
    step and TTFT."""
    n_tok = sum(len(r.generated) for r in reqs)
    ttft, step_ms = stats["ttft_s"], stats["steady_step_ms"]
    counts = eng.graphs.counts
    log(
        f"[engine] {what}: {len(reqs)} requests, {n_tok} tokens, "
        f"{stats['decode_steps']} decode steps, paged kernel launches "
        f"{launches} (= {eng.cfg.num_layers} x {stats['decode_steps']}; "
        f"wrapper calls {raw}); graph captures in this run "
        f"{stats['captures']}; the engine's so far: captures "
        f"{dict(counts.captures)}, replays {dict(counts.replays)}, graph pool "
        f"{eng.graphs.pool_bytes()} B; chunk keys (G, cb, Sb, cache_len) "
        f"{sorted(k[1:] for k in eng.graphs.keys if k[0] == 'chunk')}; per "
        f"kind (captures, median warm-up ms, median capture ms) "
        f"{capture_report(eng.graphs)} [{smi}]"
    )
    log(
        f"[engine] {what}: wall {stats['wall_s']:.3f} s, output "
        f"{n_tok / stats['wall_s']:.1f} tok/s, first token median "
        f"{ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms, "
        f"steady decode step median {step_ms[len(step_ms) // 2]:.3f} ms, min "
        f"{step_ms[0]:.3f} ms, max {step_ms[-1]:.3f} ms over {len(step_ms)} "
        f"steps, host syncs per step {sorted(set(stats['steady_syncs']))}; "
        f"steady steps that captured (step, ms, syncs): "
        f"{stats['capture_steps']} [{smi}]"
    )


def device_time(trace):
    """(device ops, busy us, us by kernel name) of a chrome trace: busy is
    the union of its kernel, copy and memset intervals."""
    spans, by_name = [], {}
    for ev in json.loads(trace.read_text())["traceEvents"]:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in ev:
            spans.append((ev["ts"], ev["ts"] + ev["dur"]))
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev["dur"]
    busy_us, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return len(spans), busy_us, by_name


def profile_decode(eng, out_dir, smi, n=4, tag="", sink=None, keep_trace=True):
    """``n`` steady decode steps under torch.profiler, after two that are
    not profiled (so the window replays graphs that exist): device busy
    time (union of kernel / copy / memset intervals in the trace) against
    the host wall time of the same steps, and device time by kernel name.
    The table goes to ``out_dir/decode_profile{tag}.txt`` (the trace to
    ``decode_trace{tag}.json`` with ``keep_trace``); ``sink[tag]`` gets the
    device busy ms per step."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    captures = sum(eng.graphs.counts.captures.values())
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    captures = sum(eng.graphs.counts.captures.values()) - captures
    trace = out_dir / f"decode_trace{tag}.json"
    prof.export_chrome_trace(str(trace))
    n_ops, busy_us, by_name = device_time(trace)
    if not keep_trace:
        trace.unlink()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    mode = "CUDA graphs" if eng.graphs.enabled else "eager"
    head = (
        f"{n} steady decode steps ({mode}, {captures} captures in the window), "
        f"wall {wall_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
        f"{n_ops} device ops [{smi}]"
    )
    rows = [f"{us / 1e3 / n:10.4f} ms/step  {name[:110]}" for name, us in top]
    (out_dir / f"decode_profile{tag}.txt").write_text("\n".join([head, *rows]) + "\n")
    top5 = "; ".join(f"{name[:60]} {us / 1e3 / n:.4f} ms" for name, us in top[:5])
    idle = 1 - busy_us / 1e3 / wall_ms
    log(f"[profile] {head}; idle share {idle:.3f}; top device time per step: {top5}")
    if sink is not None:
        sink[tag] = busy_us / 1e3 / n


# ------------------------------------------------ qwen2-moe at full width
MOE_ARCH = "qwen2-moe-a2.7b"
#: phase 9's fp32 comparison runs this many of qwen2-moe's 24 layers (their
#: fp32 copy is 30.3 GB; all 24 would be 60.6 GB beside 30.3 GB of bf16);
#: 12 reach past layer 10, where the bf16 routes' first experts flip
MOE_FP32_LAYERS = 12


def moe_phase(mods, get_config, out_dir, smi):
    """Phase 9 (module docstring): qwen2-moe-a2.7b at full width through
    the paged engine. Returns the paged kernel's launches in the graph
    engine's cold run (the main path's run of this phase)."""
    Engine, RS, SP, PD, GR, INS, T, Orchestrator, MIG, MOE = mods
    cfg = get_config(MOE_ARCH)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = T.init_params(cfg, gen, "bfloat16")
    torch.cuda.synchronize()
    weight_bytes = MIG.tree_bytes(params)
    # the scatter dispatch's bytes: a decode step reads every weight but
    # the embedding table (8 rows of it), for it runs every expert's
    # buffer, padding experts included
    step_bytes = weight_bytes - MIG.tree_bytes(params, "^embed")
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    moe = params["layers"]["moe"]
    expert_bytes = sum(  # one routed expert's weights in one layer
        w[0, 0].numel() * w.element_size()
        for w in (moe["w_gate"], moe["w_up"], moe["w_down"])
    )
    log(
        f"[moe] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"H={cfg.num_heads}, KV={cfg.num_kv_heads}, {cfg.num_experts} experts "
        f"padded to {moe['w_gate'].shape[1]}, top-{cfg.num_experts_per_tok}, "
        f"{cfg.num_shared_experts} shared, d_ff={cfg.d_ff}, "
        f"vocab={cfg.vocab_size}; router {moe['router'].dtype}, experts "
        f"{moe['w_gate'].dtype}; weights {weight_bytes} B in "
        f"{time.perf_counter() - t:.1f} s (device memory held before: {before} B); "
        f"weight bytes the scatter dispatch's decode step reads {step_bytes} B, "
        f"bound {bound_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s [{smi}]"
    )
    prompts, sampled = workload(cfg)
    warm_prompts, _ = workload(cfg, seed=SEED + 1)
    engine_args = (Engine, RS, SP, cfg, params)
    runs = serve_graphs_and_eager(
        engine_args, PD, GR, (prompts, warm_prompts, sampled), smi
    )
    reqs, wreqs, stats, launches = runs["graphs"]
    for what, (_, _, st, _) in runs.items():
        ms = st["steady_step_ms"]
        log(
            f"[moe] {what}, cold: steady decode step median "
            f"{ms[len(ms) // 2]:.3f} ms (min {ms[0]:.3f}, max {ms[-1]:.3f}) "
            f"against the scatter dispatch's weight-read bound {bound_ms:.3f} ms "
            f"({bound_ms / ms[len(ms) // 2]:.1%} of bound) [{smi}]"
        )

    # kernel vs gather on a fresh graph engine's live pool, then a profiled
    # window of 4 steady steps on the same engine. A bf16 rounding
    # difference can flip a row's top-4 experts in some layer, and a flip
    # moves that row's logits far more than 2e-2: so each paged-kernel call
    # is held to its plain version (2e-2), the bf16 logits to 2e-2 on the
    # rows whose experts agree in every layer, and the first
    # MOE_FP32_LAYERS layers, widened to fp32, to 1e-4 with the same experts
    # picked in every row and layer (all 24 in fp32 would not fit beside
    # the bf16 weights). Two witnesses that the bf16 flips are rounding:
    # fp32 through the layers of the first flips picks alike, and the
    # kernel's layout with its plain version in the kernel's place
    # ("plain") is printed against both routes
    from repro_torch.kernels.paged_decode import paged_decode_attention_ref
    from repro_torch.models import layers as LAYERS

    busy, picks, calls, logits = {}, {}, {}, {}
    profile = functools.partial(
        profile_decode, out_dir=out_dir, smi=smi, tag="_moe", sink=busy
    )

    def probe(eng):
        tk, act, handle = paged_probe_inputs(eng)
        route, V = MOE.route, cfg.vocab_size

        def forward(tag, params, c, h, impl):
            def recording(p, x, cc):
                out = route(p, x, cc)
                picks.setdefault(tag, []).append(out[1][act].sort(-1).values)
                return out

            MOE.route = recording
            try:
                logits[tag] = T.forward_paged(params, c, tk, h, attn_impl=impl)[0][act, :V]
            finally:
                MOE.route = route

        with checked_kernel_calls(calls):
            forward("kernel", eng.params, cfg, handle, "kernel")
        forward("gather", eng.params, cfg, handle, "gather")
        paged = LAYERS.paged_decode_attention
        LAYERS.paged_decode_attention = paged_decode_attention_ref
        try:
            forward("plain", eng.params, cfg, handle, "kernel")
        finally:
            LAYERS.paged_decode_attention = paged
        n = MOE_FP32_LAYERS
        cut = dataclasses.replace(cfg, num_layers=n)
        p32 = widened({**{k: v for k, v in eng.params.items() if k != "layers"},
                       "layers": _tree_map(lambda t: t[:n], eng.params["layers"])})
        h32 = dict(handle, k=handle["k"][:n].float(), v=handle["v"][:n].float())
        for impl in ("kernel", "gather"):
            forward((impl, 32), p32, cut, h32, impl)
        del p32, h32
        profile(eng)

    run_engine(*engine_args, "kernel", prompts, sampled, probe=probe)
    L_ = cfg.num_layers
    routed = [picks["kernel"][i].unique().numel() for i in range(L_)]
    rows = len(logits["kernel"])

    def flipped(a, b):
        """(row, layer) pairs whose experts differ between two runs."""
        return [(r, i) for i in range(len(picks[a])) for r in range(rows)
                if not torch.equal(picks[a][i][r], picks[b][i][r])]

    flips = flipped("kernel", "gather")
    flips32 = flipped(("kernel", 32), ("gather", 32))
    same = [r for r in range(rows) if r not in {f[0] for f in flips}]
    worst = max(calls.get("paged", [float("inf")]))
    if len(calls.get("paged", ())) != L_ or worst > 2e-2 or not same or flips32:
        raise AssertionError(
            f"{cfg.name}: {len(calls.get('paged', ()))} paged calls checked, worst "
            f"{worst}; rows whose experts agree in every layer {same}; (row, "
            f"layer) pairs that flip in fp32 {flips32}")
    rel_same = gate_rel(f"{cfg.name} kernel vs gather logits, rows {same}",
                        logits["kernel"][same], logits["gather"][same])
    rel32 = gate_rel(f"{cfg.name} kernel vs gather logits, {MOE_FP32_LAYERS} layers "
                     f"in fp32", logits["kernel", 32], logits["gather", 32], tol=1e-4)
    log(
        f"[moe] one decode step, kernel vs gather: each of the {L_} bf16 paged "
        f"calls against its plain version, worst relative L2 {worst:.3e} (tol "
        f"2e-2); (row, layer) pairs whose top-{cfg.num_experts_per_tok} experts "
        f"differ {flips}; logits relative L2 in bf16 over the {len(same)} rows "
        f"whose experts agree in every layer {rel_same:.3e} (tol 2e-2), over all "
        f"{rows} rows {rel_l2(logits['kernel'], logits['gather']):.3e} (not "
        f"gated); the first {MOE_FP32_LAYERS} layers in fp32: pairs that differ "
        f"{flips32} (none allowed), logits {rel32:.3e} (tol 1e-4) [{smi}]"
    )
    log(
        f"[moe] witness, the kernel's layout with the plain paged attention in "
        f"the kernel's place (bf16, not gated): pairs that differ from gather "
        f"{flipped('plain', 'gather')}, from the kernel "
        f"{flipped('plain', 'kernel')}; all-row logits relative L2 against "
        f"gather {rel_l2(logits['plain'], logits['gather']):.3e}, against the "
        f"kernel {rel_l2(logits['plain'], logits['kernel']):.3e} [{smi}]"
    )
    ms = stats["steady_step_ms"]
    median = ms[len(ms) // 2]
    E = moe["w_gate"].shape[1]
    routed_bytes = step_bytes - (E * cfg.num_layers - sum(routed)) * expert_bytes
    routed_ms = routed_bytes / HBM_BYTES_PER_S * 1e3
    log(
        f"[moe] routed-only bound: one decode step's {rows} rows "
        f"route to {sum(routed)} of {E * cfg.num_layers} (layer, expert) pairs "
        f"(per layer {routed}); those experts' weights plus the rest of the "
        f"step's weights are {routed_bytes} B, bound {routed_ms:.3f} ms; the "
        f"graph step's median {median:.3f} ms runs at {routed_ms / median:.1%} "
        f"of this bound [{smi}]"
    )
    log(
        f"[moe] graphs: device busy {busy['_moe']:.3f} ms per steady step "
        f"(profiled) against the unprofiled steady step's median {median:.3f} "
        f"ms: idle share outside the profiler {1 - busy['_moe'] / median:.3f} "
        f"[{smi}]"
    )

    # one stop-the-world move of all 8 decoding requests to a second
    # engine that shares the weights dict
    reference = {r.rid: r.generated for r in reqs}
    orch, oreqs = scaling_setup(
        Orchestrator, RS, SP, (cfg, params, prompts, sampled), "cuda"
    )
    if orch.engines[0].params is not orch.engines[1].params:
        raise AssertionError("the two engines do not share one weights dict")
    paused = []
    for h in orch.instances:
        capture(h, "pause_request", paused)
    with sync_errors("cuda"), INS.count_host_syncs() as syncs:
        recs = orch.migrate_requests(0, 1)
    check_moved(orch, recs, oreqs, f"{cfg.name} stop-the-world")
    if syncs.n != 3 * len(recs):
        raise AssertionError(f"{syncs.n} host syncs for {len(recs)} moves")
    blocks = shipped([(p["request"].rid, p["kv"]) for p, _ in paused])
    n_checked = check_imported(orch.engines[1], blocks)
    block_bytes = cfg.num_layers * 2 * cfg.num_kv_heads * 16 * cfg.resolved_head_dim * 2
    recs = sorted(recs, key=lambda r: r.rid)
    total = sum(r.bytes_moved for r in recs)
    check_streams(orch, reference, f"{cfg.name} stop-the-world")
    log(
        f"[moe] stop-the-world: {len(recs)} requests 0 -> 1, {n_checked} imported "
        f"blocks ({block_bytes} B of K/V each) bit-equal to their payload, "
        f"{syncs.n} host syncs under sync-debug error; streams token-identical "
        f"to the unmigrated graph run, dropped 0; bytes per request "
        f"{[r.bytes_moved for r in recs]}, total {total} B; wall per request "
        f"(pause -> resume) ms {ms_list(r.seconds for r in recs)}, total "
        f"{sum(r.seconds for r in recs) * 1e3:.3f} ms [{smi}]"
    )
    peak = torch.cuda.max_memory_allocated()
    log(
        f"[moe] weights held {weight_bytes} B; peak device memory allocated in "
        f"phase 9 {peak} B [{smi}]"
    )
    return launches


# ------------------------------------------------------------ kernel API
def rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def kernel_api_phase(ops, FA, DA, ssm, get_config, mid_lens, smi):
    """The three ``kernels.ops`` wrappers at full width, each on a shape
    that needs the reference's padding, then one full-width mamba2-780m
    mixer layer (B 1, S 2048) through the SSD kernel (``ssd_fn=ops.ssd``)
    against the same layer through ``ssd_chunked``, in bf16 and in fp32."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bf = torch.bfloat16
    tl = get_config("tinyllama-1.1b")
    H, KV, D = tl.num_heads, tl.num_kv_heads, tl.resolved_head_dim

    def check(name, got, want, shape, tol):
        if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite")
        rel = rel_l2(got, want)
        if rel > tol:
            raise AssertionError(f"{name}: relative L2 {rel:.3e} > {tol}")
        log(f"[api] {name} {shape}: relative L2 {rel:.3e} (tol {tol})")

    # flash at S = 2000 (padded to 2048, as the reference pads)
    S = 2000
    q = randn(gen, (1, S, H, D), bf)
    k, v = randn(gen, (1, S, KV, D), bf), randn(gen, (1, S, KV, D), bf)
    got = ops.flash_attention_bshd(q, k, v)
    want = FA.flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)))
    check("ops.flash_attention_bshd", got, want.transpose(1, 2), (1, S, H, D), 2e-2)

    # decode against a dense cache of S = 1000 positions (padded to 1024)
    B, S = len(mid_lens), 1000
    qd = randn(gen, (B, 1, H, D), bf)
    kc, vc = randn(gen, (B, S, KV, D), bf), randn(gen, (B, S, KV, D), bf)
    ln = torch.tensor(mid_lens, dtype=torch.int32, device="cuda")
    got = ops.decode_attention_bshd(qd, kc, vc, ln)
    want = DA.decode_attention_ref(qd[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), ln)
    check("ops.decode_attention_bshd", got, want[:, None], (B, 1, H, D), 2e-2)

    # SSD at mamba2-780m's widths, L = 2000 (padded to a chunk multiple)
    mc = get_config("mamba2-780m")
    Hs, P, N = mc.ssm_heads, mc.ssm_head_dim, mc.ssm_state
    G, Q = mc.ssm_ngroups, mc.ssm_chunk
    args = ssd_inputs(gen, 1, 2000, Hs, G, P, N, bf)
    y, h = ops.ssd(*args, chunk=Q)
    yr, hr = ssm.ssd_chunked(*args, Q)
    check("ops.ssd y", y, yr, (1, 2000, Hs, P), 2e-2)
    check("ops.ssd state", h, hr, (1, Hs, P, N), 2e-2)

    # one full-width Mamba2 mixer layer, kernel scan against ssd_chunked
    params = ssm.init_mamba2(mc, gen, bf)
    x = randn(gen, (1, 2048, mc.d_model), bf)
    rels = {}
    for dtype, tol in ((bf, 2e-2), (torch.float32, 1e-4)):
        p = {name: t.to(dtype) if t.dtype == bf else t for name, t in params.items()}
        xx = x.to(dtype)
        out_k, st_k = ssm.apply_mamba2(p, xx, mc, ssd_fn=ops.ssd)
        out_p, st_p = ssm.apply_mamba2(p, xx, mc)
        check(f"apply_mamba2 {dtype} out", out_k, out_p, tuple(x.shape), tol)
        state = (1, Hs, P, N)
        check(f"apply_mamba2 {dtype} state", st_k["ssd"], st_p["ssd"], state, tol)
        rels[dtype] = rel_l2(out_k, out_p)
    log(
        f"[api] {mc.name} mixer (d={mc.d_model}, H={Hs}, P={P}, N={N}, Q={Q}, "
        f"S={x.shape[1]}): kernel scan vs ssd_chunked, relative L2 "
        f"{rels[bf]:.3e} in bf16 (tol 2e-2), {rels[torch.float32]:.3e} in fp32 "
        f"(tol 1e-4) [{smi}]"
    )


# ------------------------------------------------- module-scaling loop
def capture(handle, op, sink):
    """Record (result, host seconds) of every call of ``handle.op`` (a
    migration step) in ``sink``; the handle works as before."""
    orig = getattr(handle, op)

    def wrapped(*args, **kwargs):
        t = time.perf_counter()
        out = orig(*args, **kwargs)
        sink.append((out, time.perf_counter() - t))
        return out

    setattr(handle, op, wrapped)


@contextlib.contextmanager
def sync_errors(device):
    """Any host sync but the counted ones (``instrument.fetch`` and
    ``instrument.synchronize`` relax the mode) raises inside the block."""
    if torch.device(device).type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def pool_bits(eng, slot, cols):
    """The K and V blocks of ``slot`` at table columns ``cols``, as the
    raw bf16 bits the wire carries."""
    ids = eng.pstate.block_tables[slot, cols].astype(np.int64)
    ids = torch.from_numpy(ids).to(eng.device)
    return [
        t.index_select(1, ids).view(torch.int16).cpu().numpy().view(np.uint16)
        for t in (eng.pstate.k, eng.pstate.v)
    ]


def shipped(payloads, into=None):
    """Fold payload ``kv`` parts, in order, into rid -> {column: (k, v)}
    (a later payload's column replaces an earlier one's: the delta over
    the snapshot)."""
    into = {} if into is None else into
    for rid, kv in payloads:
        if kv.get("kv_dtype") != "bfloat16":
            raise AssertionError(f"rid={rid}: bf16 pool shipped {kv.get('kv_dtype')}")
        by_col = into.setdefault(rid, {})
        for i, c in enumerate(kv["cols"]):
            by_col[int(c)] = (kv["k"][:, i], kv["v"][:, i])
    return into


def check_imported(eng, blocks):
    """``blocks`` (from ``shipped``) must sit bit for bit in ``eng``'s pool
    at their columns, and be all its live columns. Returns the count."""
    slot_of = {rid: slot for slot, rid in eng.slot_rids().items()}
    n = 0
    for rid, by_col in blocks.items():
        cols = np.asarray(sorted(by_col))
        live = np.nonzero(eng.pstate.block_tables[slot_of[rid]] >= 0)[0]
        if live.tolist() != cols.tolist():
            raise AssertionError(f"rid={rid}: columns {live} vs shipped {cols}")
        k, v = pool_bits(eng, slot_of[rid], cols)
        want_k = np.stack([by_col[c][0] for c in cols], axis=1)
        want_v = np.stack([by_col[c][1] for c in cols], axis=1)
        if not (np.array_equal(k, want_k) and np.array_equal(v, want_v)):
            raise AssertionError(f"rid={rid}: imported blocks differ from payload")
        n += len(cols)
    return n


def scaling_setup(Orchestrator, RequestSpec, SamplingParams, work, device):
    """Two engines, all the workload's requests on instance 0, stepped
    until none is prefilling and each has at least 4 tokens."""
    cfg, params, prompts, sampled = work
    orch = Orchestrator(
        cfg,
        params,
        n_instances=2,
        max_batch=8,
        max_len=1024,
        block_size=16,
        dtype="bfloat16",
        telemetry_every=10_000,
        device=device,
    )
    src = orch.engines[0]
    reqs = []
    for i, p in enumerate(prompts):
        temp, top_k = (0.8, 8) if i in sampled else (0.0, 0)
        sampling = SamplingParams(temperature=temp, top_k=top_k, seed=100 + i)
        orch._home[i] = 0
        spec = RequestSpec(rid=i, prompt=p, max_tokens=32, sampling=sampling)
        reqs.append(src.submit(spec))
    while src.queue or src.prefilling or min(len(r.generated) for r in reqs) < 4:
        orch.step()
    if len(src.active) != len(reqs) or any(r.done for r in reqs):
        raise AssertionError(f"{len(src.active)} of {len(reqs)} requests decoding")
    return orch, reqs


def check_moved(orch, recs, reqs, what, src=0):
    resumed = [r.resumed for r in recs]
    if len(recs) != len(reqs) or not all(resumed):
        raise AssertionError(f"{what}: {len(recs)} records, resumed {resumed}")
    src = orch.engines[src]
    held = src.pstate.blocks_in_use()
    if src.active or src.prefilling or held:
        raise AssertionError(f"{what}: source holds {held} blocks")


def finished_streams(orch, reference, what):
    orch.run_until_done()
    got = {r.rid: r.generated for r in orch.finished}
    if orch.dropped or sorted(got) != sorted(reference):
        raise AssertionError(f"{what}: dropped {orch.dropped}, finished {sorted(got)}")
    return got


def check_streams(orch, reference, what):
    got = finished_streams(orch, reference, what)
    bad = [rid for rid in reference if got[rid] != reference[rid]]
    if bad:
        raise AssertionError(f"{what}: streams differ from the unmigrated run: {bad}")


def graph_state(orch):
    """Captures summed over the orchestrator's engines, and the address
    of every pool tensor (a move must leave both as they were)."""
    captures = sum(sum(e.graphs.counts.captures.values()) for e in orch.engines)
    ptrs = [(e.pstate.k.data_ptr(), e.pstate.v.data_ptr()) for e in orch.engines]
    return captures, ptrs


def check_no_capture(before, after, what):
    log(f"[scaling] {what}: graph captures before {before[0]}, after {after[0]}")
    if before != after:
        raise AssertionError(f"{what}: the move captured or rebound a pool: "
                             f"{before} -> {after}")


def ms_list(xs):
    return "[" + ", ".join(f"{x * 1e3:.3f}" for x in xs) + "]"


def scaling_phase(mods, work, reference, smi, device="cuda"):
    """Phase 7 (module docstring). ``mods``: (paged_decode, graphs, instrument,
    core.migration, MetricsSnapshot, Orchestrator, RequestSpec,
    SamplingParams); ``work``: (cfg, params, prompts, sampled);
    ``reference``: rid -> tokens of the unmigrated run (one engine, the
    same max_batch)."""
    PD, GR, INS, MIG, MetricsSnapshot, Orchestrator, RS, SP = mods
    cfg, sampled = work[0], work[3]
    L = cfg.num_layers
    engines = []
    PD.paged_decode_attention.launches = 0

    def setup():
        orch, reqs = scaling_setup(Orchestrator, RS, SP, work, device)
        engines.extend(orch.engines)
        return orch, reqs

    # 1. stop-the-world, then a plan applied mid-decode at the destination
    orch, reqs = setup()
    paused, resumed = [], []
    for h in orch.instances:
        capture(h, "pause_request", paused)
        capture(h, "resume_request", resumed)
    before = graph_state(orch)
    with sync_errors(device), INS.count_host_syncs() as syncs:
        recs = orch.migrate_requests(0, 1)
    check_no_capture(before, graph_state(orch), "stop-the-world 0 -> 1")
    check_moved(orch, recs, reqs, "stop-the-world")
    want = (3 if torch.device(device).type == "cuda" else 2) * len(recs)
    if syncs.n != want:
        raise AssertionError(f"{syncs.n} host syncs for {len(recs)} moves, not {want}")
    blocks = shipped([(p["request"].rid, p["kv"]) for p, _ in paused])
    n_checked = check_imported(orch.engines[1], blocks)
    stw = sorted(recs, key=lambda r: r.rid)
    total = sum(r.bytes_moved for r in stw)
    log(
        f"[scaling] stop-the-world: {len(stw)} requests 0 -> 1, all resumed, "
        f"{n_checked} imported blocks bit-equal to their payload, source empty; "
        f"{syncs.n} host syncs, {syncs.uploads} uploads, under sync-debug error"
    )
    log(
        f"[scaling] stop-the-world bytes per request "
        f"{[r.bytes_moved for r in stw]}, total {total} B; wall per request "
        f"(pause -> resume, after synchronize) ms {ms_list(r.seconds for r in stw)}, "
        f"total {sum(r.seconds for r in stw) * 1e3:.3f} ms [{smi}]"
    )
    # the same moves twice more (1 -> 0 -> 1), each step timed: export
    # (pause) and import (resume, after synchronize), in migration order
    for src, dst, again in ((0, 1, False), (1, 0, True), (0, 1, True)):
        if again:
            paused.clear()
            resumed.clear()
            before = graph_state(orch)
            with sync_errors(device):
                recs = orch.migrate_requests(src, dst)
            check_no_capture(before, graph_state(orch), f"stop-the-world {src} -> {dst}")
            check_moved(orch, recs, reqs, f"stop-the-world {src} -> {dst}", src)
        log(
            f"[scaling] stop-the-world {src} -> {dst}, in migration "
            f"order: rids {[p['request'].rid for p, _ in paused]}, export ms "
            f"{ms_list(dt for _, dt in paused)}, import ms "
            f"{ms_list(dt for _, dt in resumed)}, total "
            f"{sum(r.seconds for r in recs) * 1e3:.3f} ms [{smi}]"
        )
    mixed = [1 + i % 3 for i in range(L)]
    for plan in (mixed, [1] * L):
        for _ in range(2):
            orch.step()
        orch.instances[1].apply_plan(plan)
        if orch.engines[1].replication_degrees != tuple(plan):
            raise AssertionError("apply_plan did not reach the engine")
    check_streams(orch, reference, "stop-the-world + apply_plan")
    log(
        "[scaling] stop-the-world streams token-identical to the unmigrated run "
        "(a mixed, then the all-ones plan applied mid-decode at the "
        "destination), dropped 0"
    )

    # 2. two-phase: snapshot + staging while the source decodes 3 steps
    orch, reqs = setup()
    snaps, paused = [], []
    capture(orch.instances[0], "snapshot_request", snaps)
    capture(orch.instances[0], "pause_request", paused)
    before = {r.rid: len(r.generated) for r in reqs}
    state = graph_state(orch)
    with sync_errors(device):
        recs = orch.migrate_requests_overlapped(0, 1, overlap_steps=3)
    check_no_capture(state, graph_state(orch), "two-phase 0 -> 1 (3 overlap steps)")
    check_moved(orch, recs, reqs, "two-phase")
    gained = {r.rid: len(r.generated) - before[r.rid] for r in reqs}
    if set(gained.values()) != {3}:
        raise AssertionError(f"tokens gained during the overlap: {gained}")
    deltas = [(r.delta_blocks, r.delta_bytes, r.bytes_moved) for r in recs]
    if not all(n >= 1 and d < b for n, d, b in deltas):
        raise AssertionError(f"two-phase deltas (blocks, bytes, moved): {deltas}")
    blocks = shipped([(snap["rid"], snap["kv"]) for snap, _ in snaps])
    blocks = shipped([(p["request"].rid, p["kv"]) for p, _ in paused], blocks)
    n_checked = check_imported(orch.engines[1], blocks)
    ov = sorted(recs, key=lambda r: r.rid)
    log(
        f"[scaling] two-phase: {len(ov)} requests 0 -> 1, each gained 3 tokens "
        f"during the overlap, all resumed, {n_checked} imported blocks bit-equal "
        f"to snapshot + delta, source empty"
    )
    log(
        f"[scaling] two-phase bytes per request {[r.bytes_moved for r in ov]}, "
        f"delta blocks {[r.delta_blocks for r in ov]}, delta bytes "
        f"{[r.delta_bytes for r in ov]}; stall per request (phase-2 pause -> "
        f"commit, after synchronize) ms {ms_list(r.stall_s for r in ov)}, whole "
        f"move ms {ms_list(r.seconds for r in ov)} [{smi}]"
    )
    check_streams(orch, reference, "two-phase")
    log("[scaling] two-phase streams token-identical to the unmigrated run, dropped 0")

    # 3. a controller scale-down turned into block migrations
    orch, reqs = setup()
    snap = MetricsSnapshot(
        t=orch.engines[0].clock,
        slo_violation_rate=1.0,
        device_util=[1.0, 0.0],
        device_mem_frac=[0.9, 0.0],
        block_vacancy=[0.1, 1.0],
    )
    orch.controller.observe(snap)
    action = orch.controller.tick()
    if not (action and action.startswith("scale-down")):
        raise AssertionError(f"controller action {action!r}")
    state = graph_state(orch)
    moved = orch._execute_scale_down()
    check_no_capture(state, graph_state(orch), "controller scale-down")
    from_0 = [m for m in orch.migrations if m.src == 0 and m.resumed]
    if moved < 1 or not from_0:
        raise AssertionError(f"scale-down moved {moved}: {orch.migrations}")
    got = finished_streams(orch, reference, "scale-down")
    greedy = [rid for rid in reference if rid not in sampled]
    agree = sum(x == y for rid in greedy for x, y in zip(got[rid], reference[rid]))
    n_greedy = sum(len(reference[rid]) for rid in greedy)
    log(
        f"[scaling] controller: {action}; {len(from_0)} requests migrated off "
        f"instance 0 (two-phase), every request finished, dropped 0; greedy "
        f"tokens equal to the unmigrated run {agree}/{n_greedy} (not gated)"
    )

    steps = sum(e._step_count for e in engines)
    launches = GR.launches_run(PD.paged_decode_attention, [e.graphs for e in engines])
    if torch.device(device).type == "cuda" and launches != L * steps:
        raise AssertionError(f"{launches} paged launches for {steps} steps x {L}")
    captures = sum(sum(e.graphs.counts.captures.values()) for e in engines)
    replays = sum(sum(e.graphs.counts.replays.values()) for e in engines)
    log(
        f"[scaling] paged_decode_attention launches over phase 7: {launches} "
        f"(= {L} layers x {steps} decode steps over {len(engines)} engines; "
        f"wrapper calls {PD.paged_decode_attention.launches}); graph captures "
        f"{captures}, replays {replays}"
    )

    # 4. the cost model fitted on the card
    t = time.perf_counter()
    fit = MIG.fit_migration_model(cfg, block_size=16, dtype="bfloat16", device=device)
    bw, fixed = fit["bandwidth_Bps"], fit["fixed_overhead_s"]
    per_req = sum(MIG.estimate_cost(r.bytes_moved, bw, fixed) for r in stw)
    log(
        f"[scaling] fit_migration_model({cfg.name}, block_size=16, bf16) on the "
        f"card: fixed overhead {fixed * 1e3:.4f} ms, bandwidth {bw / 1e9:.3f} GB/s "
        f"(probes {fit['probe_small']}, {fit['probe_large']}; "
        f"{time.perf_counter() - t:.1f} s); estimate_cost defaults: 240 ms, "
        f"50 GB/s; fitted estimate of the stop-the-world moves {per_req * 1e3:.3f} "
        f"ms against {sum(r.seconds for r in stw) * 1e3:.3f} ms measured [{smi}]"
    )
    return stw, ov


# ------------------------------------------------------- the remote plane
def http_send(port, body):
    """Open a connection and POST ``body`` to /v1/completions."""
    s = socket.create_connection(("127.0.0.1", port), timeout=600)
    payload = json.dumps(body).encode()
    s.sendall(
        b"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
        b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
        % len(payload) + payload
    )
    return s


def http_read(s, out):
    """Read one response to its end into ``out``: the raw bytes, and the
    host time of the first token event of a stream."""
    data, first = b"", None
    try:
        while chunk := s.recv(65536):
            data += chunk
            if first is None and b'"token":' in data:
                first = time.perf_counter()
    finally:
        s.close()
    out.update(raw=data, first=first, end=time.perf_counter())


def http_result(raw):
    """(status, instance, tokens) of a unary or an SSE completion."""
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    if b"transfer-encoding: chunked" not in head.lower():
        obj = json.loads(body)
        return status, obj.get("routing", {}).get("instance"), obj.get("tokens")
    events, rest = [], body
    while rest:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        events.append(rest[:n].removeprefix(b"data: ").strip())
        rest = rest[n + 2:]
    if events[-1] != b"[DONE]":
        raise AssertionError(f"stream ended with {events[-1][:80]!r}")
    first = json.loads(events[0])
    toks = [json.loads(e)["token"] for e in events[1:-1]]
    return status, first["instance"], toks


def serve_http(Ingress, orch, cfg, prompts, sampled, smi):
    """Phase 8's HTTP part: the prompts as completions through an
    ``Ingress`` in front of ``orch`` over loopback, the even ones
    streamed. The pump is held until every request is accepted, so each
    server admits its share, in acceptance order, before its first step.
    Returns [(instance, tokens)] in prompt order."""
    ing = Ingress(orch, model_id=cfg.name, govern_budget=False).start()
    try:
        ing.hold_pump.set()
        outs, threads = [], []
        for i, p in enumerate(prompts):
            temp, top_k = (0.8, 8) if i in sampled else (0.0, 0)
            body = {"prompt": [int(t) for t in p], "max_tokens": 32,
                    "temperature": temp, "top_k": top_k, "seed": 100 + i,
                    "stream": i % 2 == 0}
            s = http_send(ing.port, body)
            deadline = time.monotonic() + 60
            while ing.counters.requests < i + 1:
                if time.monotonic() > deadline:
                    raise AssertionError(f"request {i} never accepted")
                time.sleep(0.002)
            out = {}
            th = threading.Thread(target=http_read, args=(s, out), daemon=True)
            th.start()
            outs.append(out)
            threads.append(th)
        t0 = time.perf_counter()
        ing.hold_pump.clear()
        for th in threads:
            th.join(timeout=600)
            if th.is_alive():
                raise AssertionError("an HTTP completion never finished")
    finally:
        ing.close()
    results = []
    for i, out in enumerate(outs):
        status, inst, toks = http_result(out["raw"])
        if status != 200 or len(toks) != 32:
            raise AssertionError(f"request {i}: HTTP {status}, {toks}")
        results.append((inst, toks))
    ttft = sorted(o["first"] - t0 for o in outs if o["first"] is not None)
    wall = max(o["end"] for o in outs) - t0
    n_tok = sum(len(t) for _, t in results)
    log(
        f"[remote] HTTP: {len(prompts)} completions ({len(ttft)} streamed) "
        f"routed to servers {[inst for inst, _ in results]}; from the pump's "
        f"release: first streamed token median {ttft[len(ttft) // 2] * 1e3:.1f} "
        f"ms, max {ttft[-1] * 1e3:.1f} ms; output {n_tok / wall:.1f} tok/s "
        f"({n_tok} tokens in {wall:.3f} s); ingress counters "
        f"{ing.counters.as_dict()} [{smi}]"
    )
    return results


def engine_streams(Engine, RS, SP, cfg, params, prompts, sampled, order, kw):
    """rid -> tokens of ``order``'s prompts submitted together to one
    fresh in-process engine (phase 8's reference)."""
    eng = Engine(cfg, params, **kw)
    for i in order:
        temp, top_k = (0.8, 8) if i in sampled else (0.0, 0)
        sampling = SP(temperature=temp, top_k=top_k, seed=100 + i)
        eng.submit(RS(rid=i, prompt=prompts[i], max_tokens=32, sampling=sampling))
    return {r.rid: r.generated for r in eng.run_until_done()}


def remote_setup(orch, RS, SP, prompts, sampled, base):
    """The prompts submitted to server 0 as rids ``base + i``, stepped
    until none prefills and every stream has at least 4 tokens."""
    src = orch.instances[0]
    orch.finished.clear()
    rids = [base + i for i in range(len(prompts))]
    for i, p in enumerate(prompts):
        temp, top_k = (0.8, 8) if i in sampled else (0.0, 0)
        sampling = SP(temperature=temp, top_k=top_k, seed=100 + i)
        orch._home[rids[i]] = 0
        src.submit(RS(rid=rids[i], prompt=p, max_tokens=32, sampling=sampling))
    while True:
        orch.step()
        streams = orch.stream_view()
        if (not src.queue_len() and len(src.active_rids()) == len(rids)
                and all(len(streams.get(r, ())) >= 4 for r in rids)):
            return


def check_remote_imported(dst, payloads):
    """Every block shipped in ``payloads`` (snapshot parts first, then the
    pause deltas) must sit bit for bit in ``dst``'s pool, read back with
    the server's own export (``snapshot_request``) of each moved slot.
    Returns the count of blocks checked."""
    blocks = shipped(payloads)
    slot_of = {rid: slot for slot, rid in dst.active_rids().items()}
    n = 0
    for rid, by_col in blocks.items():
        back = dst.snapshot_request(slot_of[rid])["kv"]
        if back.get("kv_dtype") != "bfloat16":
            raise AssertionError(f"rid={rid}: read back {back.get('kv_dtype')}")
        cols = [int(c) for c in back["cols"]]
        if cols != sorted(by_col):
            raise AssertionError(
                f"rid={rid}: columns {cols} vs shipped {sorted(by_col)}"
            )
        for j, c in enumerate(cols):
            k, v = by_col[c]
            same_k = np.array_equal(back["k"][:, j], k)
            if not (same_k and np.array_equal(back["v"][:, j], v)):
                raise AssertionError(f"rid={rid} column {c}: imported block differs")
        n += len(cols)
    return n


def remote_streams(orch, reference, base, what):
    """Run ``orch`` to the end; stream ``base + i`` must equal
    ``reference[i]``."""
    orch.run_until_done()
    got = {r.rid - base: r.generated for r in orch.finished}
    if orch.dropped or sorted(got) != sorted(reference):
        raise AssertionError(f"{what}: dropped {orch.dropped}, finished {sorted(got)}")
    bad = [i for i in reference if got[i] != reference[i]]
    if bad:
        raise AssertionError(f"{what}: streams differ from the in-process run: {bad}")


def remote_phase(mods, work, references, in_process, smi, device="cuda", kw=ENGINE_KW):
    """Phase 8 (module docstring). ``mods``: (launch_pod, Node, Orchestrator,
    Ingress, transport, Engine, RequestSpec, SamplingParams); ``work``:
    (cfg, params, sampled); ``references``: {"http": prompts, "stw": (prompts,
    rid -> tokens), "two-phase": (prompts, rid -> tokens)}, each rid -> tokens
    of an unmigrated in-process engine with all the prompts at ``max_batch``;
    ``in_process``: phase 7's (stop-the-world, two-phase) records."""
    launch_pod, Node, Orchestrator, Ingress, TR, Engine, RS, SP = mods
    cfg, params, sampled = work
    L = cfg.num_layers
    ports = [int(TR.free_tcp_endpoint().rsplit(":", 1)[1]) for _ in range(2)]
    nodes = [Node(host="127.0.0.1", port=p, capacity=1, spawn=True) for p in ports]
    t = time.perf_counter()
    handles = launch_pod(cfg, params, nodes, pod_timeout=600, device=device, **kw)
    log(f"[remote] launch_pod: 2 engine servers up in {time.perf_counter() - t:.3f} s")
    procs = [h.process for h in handles]
    orch = None
    try:
        for k, h in enumerate(handles):
            info, b = h.info(), h.bringup
            if info["pid"] == os.getpid() or not info["device"].startswith(device):
                raise AssertionError(
                    f"server {k}: pid {info['pid']} on {info['device']}"
                )
            log(
                f"[remote] server {k}: pid {info['pid']} on {info['device']} "
                f"({info['device_name']}), {h.endpoint}; bring-up: spawn to "
                f"connection {b['connect_s']:.3f} s, weights {b['weight_bytes']} B "
                f"in {b['weights_s']:.3f} s "
                f"({b['weight_bytes'] / b['weights_s'] / 1e9:.3f} GB/s), first "
                f"ready {b['ready_s']:.3f} s [{smi}]"
            )
        orch = Orchestrator(cfg, params, handles=handles, telemetry_every=10_000)

        # 1. HTTP completions through the ingress
        prompts = references["http"]
        results = serve_http(Ingress, orch, cfg, prompts, sampled, smi)
        for k in (0, 1):
            order = [i for i, (inst, _) in enumerate(results) if inst == k]
            if not order:
                continue
            want = engine_streams(Engine, RS, SP, cfg, params, prompts, sampled,
                                  order, dict(kw, device=device))
            bad = [i for i in order if results[i][1] != want[i]]
            if bad:
                raise AssertionError(f"HTTP streams of server {k} differ: {bad}")
        log(
            "[remote] HTTP streams token-identical to the same requests on an "
            "in-process engine per server (same weights, max_batch "
            f"{kw['max_batch']}), dropped {orch.dropped}"
        )

        # 2. stop-the-world 0 -> 1 over the RPC wire
        prompts, want = references["stw"]
        remote_setup(orch, RS, SP, prompts, sampled, base=100)
        paused = []
        capture(orch.instances[0], "pause_request", paused)
        recs = orch.migrate_requests(0, 1)
        if len(recs) != len(prompts) or not all(r.resumed for r in recs):
            raise AssertionError(
                f"stop-the-world: {[(r.rid, r.resumed) for r in recs]}"
            )
        n = check_remote_imported(
            orch.instances[1], [(p["request"].rid, p["kv"]) for p, _ in paused]
        )
        if orch.instances[0].blocks_in_use() or orch.instances[0].active_rids():
            raise AssertionError("stop-the-world: the source server still holds blocks")
        stw = sorted(recs, key=lambda r: r.rid)
        remote_streams(orch, want, 100, "stop-the-world over RPC")
        log(
            f"[remote] stop-the-world 0 -> 1 over RPC: {len(stw)} requests resumed, "
            f"{n} imported blocks bit-equal to the payloads (read back from "
            f"server 1), streams token-identical, dropped 0; bytes per request "
            f"{[r.bytes_moved for r in stw]}, ms per request (pause -> resume) "
            f"{ms_list(r.seconds for r in stw)}; phase 7 in-process: bytes "
            f"{[r.bytes_moved for r in in_process[0]]}, ms "
            f"{ms_list(r.seconds for r in in_process[0])} [{smi}]"
        )

        # 3. two-phase 0 -> 1 over the RPC wire
        prompts, want = references["two-phase"]
        remote_setup(orch, RS, SP, prompts, sampled, base=200)
        snaps, paused = [], []
        capture(orch.instances[0], "snapshot_request", snaps)
        capture(orch.instances[0], "pause_request", paused)
        recs = orch.migrate_requests_overlapped(0, 1, overlap_steps=3)
        if len(recs) != len(prompts) or not all(r.resumed for r in recs):
            raise AssertionError(f"two-phase: {[(r.rid, r.resumed) for r in recs]}")
        n = check_remote_imported(
            orch.instances[1],
            [(s["rid"], s["kv"]) for s, _ in snaps]
            + [(p["request"].rid, p["kv"]) for p, _ in paused],
        )
        ov = sorted(recs, key=lambda r: r.rid)
        remote_streams(orch, want, 200, "two-phase over RPC")
        log(
            f"[remote] two-phase 0 -> 1 over RPC (3 overlap steps): {len(ov)} "
            f"requests resumed, {n} imported blocks bit-equal to snapshot + delta, "
            f"streams token-identical, dropped 0; bytes per request "
            f"{[r.bytes_moved for r in ov]}, delta bytes "
            f"{[r.delta_bytes for r in ov]}, "
            f"stall ms {ms_list(r.stall_s for r in ov)}, whole move ms "
            f"{ms_list(r.seconds for r in ov)}; phase 7 in-process: stall ms "
            f"{ms_list(r.stall_s for r in in_process[1])} [{smi}]"
        )

        # 4. each server's own counters
        for k, h in enumerate(handles):
            h.refresh_info()
            info = h.info()
            steps, launches = info["decode_steps"], info["paged_launches"]
            syncs = info["steady_syncs"]
            cuda = device == "cuda"
            if cuda and (launches != L * steps or steps == 0):
                raise AssertionError(
                    f"server {k}: {launches} paged launches for {steps} steps"
                )
            if set(syncs) != {"1"}:
                raise AssertionError(f"server {k}: host syncs per steady step {syncs}")
            med, lo, hi, n_steady = info["steady_ms"]
            log(
                f"[remote] server {k}: {steps} decode steps, paged_decode_attention "
                f"launches {launches} (= {L} x {steps}); graph captures "
                f"{info['graph_captures']}, replays {info['graph_replays']}; host "
                f"syncs per steady step {syncs}; steady step median {med:.3f} ms, "
                f"min {lo:.3f}, max {hi:.3f} over {n_steady} steps (two servers "
                f"time-slice one card) [{smi}]"
            )
        if orch.dropped:
            raise AssertionError(f"dropped {orch.dropped}")
    finally:
        if orch is not None:
            orch.close()
        else:
            for h in handles:
                h.close()
    codes = [(p.pid, p.exitcode) for p in procs]
    if any(p.is_alive() for p in procs) or any(c != 0 for _, c in codes):
        raise AssertionError(f"engine servers (pid, exit code): {codes}")
    log(f"[remote] engine servers joined, (pid, exit code) {codes}")


# ------------------------------------------------ the dense-cache engine
SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "zamba2-7b"
#: phase 10's engine settings: phase 5's batch and length, dense cache
DENSE_KW = dict(max_batch=8, max_len=1024, dtype="bfloat16", cache_kind="dense")
MLA_ARCH = "minicpm3-4b"
AUDIO_ARCH = "whisper-medium"
#: phase 10 runs the SSM and the hybrid at full width but cut depth, to
#: keep the script's time: mamba2-780m 6 of its 48 layers, zamba2-7b 13 of
#: its 81 (two applications of the shared block, each over its own KV
#: cache, then a tail layer: the only phase that applies the block more
#: than once in a forward); cut from 24 and 27, then 12 and 15 (PERF.md §4)
PHASE10_LAYERS = {SSM_ARCH: 6, HYBRID_ARCH: 13}
#: phase 11 runs minicpm3-4b and whisper-medium at full width but cut
#: depth, to keep the script's time: minicpm3-4b 8 of its 62 layers (16
#: before), whisper-medium 12 of its 24 encoder and 12 of its 24 decoder
#: layers (PERF.md §4)
PHASE11_LAYERS = {MLA_ARCH: {"num_layers": 8},
                  AUDIO_ARCH: {"num_layers": 12, "num_encoder_layers": 12}}
#: the weight bytes of the reference's init_params at full width in bf16
#: (jax.eval_shape of repro.models.transformer.init_params), at phase
#: 10's and 11's depths
REFERENCE_WEIGHT_BYTES = {
    SSM_ARCH: 330_661_248, HYBRID_ARCH: 2_667_877_696,
    MLA_ARCH: 1_378_964_480, AUDIO_ARCH: 917_757_952,
}
#: the dense cache's bytes at phase 11's settings (max_batch 8; max_len
#: 1024, whisper 448), from the reference's init_cache at phase 11's
#: depths: minicpm3's latents, whisper's self K/V and cross K/V of 1500 rows
REFERENCE_CACHE_BYTES = {MLA_ARCH: 37_781_536, AUDIO_ARCH: 765_999_136}
#: whisper's decoder context, and the longest prompt that leaves room for
#: 32 new tokens in it
WHISPER_MAX_LEN, WHISPER_PROMPT = 448, 416


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def dense_decode_logits(T, eng, toks=None, params=None, cache=None, **routes):
    """One decode step's logits (over the real vocabulary: the padding
    columns hold -2**20, which would swamp any norm of a difference) for
    the engine's active rows on its live
    dense cache (or on ``cache``, a copy of it, with ``params``), through
    ``routes`` (``attn_impl`` / ``ssd_impl``); the cache is restored after
    (the step advances the SSM states in place). ``toks`` [B]: the tokens
    fed (default: each active request's last)."""
    if toks is None:
        toks = np.zeros((eng.max_batch,), np.int64)
        for s, r in eng.active.items():
            toks[s] = r.generated[-1]
    cache = eng.cache if cache is None else cache
    snap = [(t, t.clone()) for t in tree_leaves(cache)]
    act = sorted(eng.active)
    pos = torch.from_numpy(eng._host_lengths[:, None].astype(np.int32)).cuda()
    tk = torch.from_numpy(np.asarray(toks, np.int64)[:, None]).cuda()
    logits = T.forward(
        params or eng.params, eng.cfg, tk, pos, cache, mode="decode",
        window=eng.window, **routes
    )[0]
    for t, c in snap:
        t.copy_(c)
    return logits[act, : eng.cfg.vocab_size]


def widened(tree):
    """A copy of a weights or cache tree with every floating leaf in fp32."""
    return _tree_map(lambda t: t.float() if t.is_floating_point() else t.clone(), tree)


@contextlib.contextmanager
def checked_kernel_calls(out):
    """Inside, every SSD-kernel call from the zero state (``ops.ssd``),
    every dense-decode call (``layers.decode_attention``) and every
    paged-decode call (``layers.paged_decode_attention``) is held against
    its plain version on the same inputs: ``out["ssd"]`` / ``out["decode"]``
    / ``out["paged"]`` collect each call's relative L2 (the SSD scan's
    larger of y and the final state)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.paged_decode import paged_decode_attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models.ssm import ssd_chunked

    ssd, dec, paged = ops.ssd, L.decode_attention, L.paged_decode_attention

    def ssd_checked(x, dt, A, B, C, chunk=128, initial_state=None):
        y, h = ssd(x, dt, A, B, C, chunk, initial_state)
        if initial_state is None:
            yr, hr = ssd_chunked(x, dt, A, B, C, chunk)
            out.setdefault("ssd", []).append(max(rel_l2(y, yr), rel_l2(h, hr)))
        return y, h

    def dec_checked(q, k, v, lengths):
        o = dec(q, k, v, lengths)
        out.setdefault("decode", []).append(
            rel_l2(o, decode_attention_ref(q, k, v, lengths)))
        return o

    def paged_checked(q, k_pool, v_pool, tables, lengths):
        o = paged(q, k_pool, v_pool, tables, lengths)
        out.setdefault("paged", []).append(
            rel_l2(o, paged_decode_attention_ref(q, k_pool, v_pool, tables, lengths)))
        return o

    ops.ssd, L.decode_attention = ssd_checked, dec_checked
    L.paged_decode_attention = paged_checked
    try:
        yield out
    finally:
        ops.ssd, L.decode_attention, L.paged_decode_attention = ssd, dec, paged


def paged_decode_logits(T, eng, toks):
    """One decode step's logits for a paged engine's active rows, fed
    ``toks`` [B], through the paged kernel (the window's gather where the
    engine has a window), after the engine's own pre-step allocation of
    each row's write block."""
    eng._ensure_decode_room()
    st = eng.pstate
    act = np.zeros((eng.max_batch,), bool)
    act[list(eng.active)] = True
    handle = {
        "k": st.k,
        "v": st.v,
        "block_tables": torch.from_numpy(st.block_tables.copy()).cuda(),
        "lengths": torch.from_numpy(st.lengths.copy()).cuda(),
        "active": torch.from_numpy(act).cuda(),
    }
    tk = torch.from_numpy(np.asarray(toks, np.int64)[:, None]).cuda()
    out = T.forward_paged(eng.params, eng.cfg, tk, handle, window=eng.window,
                          attn_impl="kernel")[0]
    return out[sorted(eng.active), : eng.cfg.vocab_size]


def prefill_logits(T, cfg, params, prompts, max_len, dtype="bfloat16", **routes):
    """First-token logits [n, V] (the real vocabulary) of each prompt
    prefilled alone over a fresh batch-1 dense cache of ``max_len`` (the
    dense engine's admission), through ``routes``."""
    rows = []
    for p in prompts:
        cache = T.init_cache(cfg, 1, max_len, dtype, "cuda")
        tk = torch.from_numpy(np.asarray(p, np.int64)[None]).cuda()
        rows.append(T.forward(params, cfg, tk, mode="prefill", cache=cache,
                              **routes)[0][:, : cfg.vocab_size])
    return torch.cat(rows)


def no_worse_than_plain(what, got, plain, truth, tol=2e-2):
    """bf16 logits of a route (``got``) and of the plain route (``plain``)
    against the plain route in fp32 (``truth``): the route's relative L2
    error may exceed the plain route's own by at most ``tol``. Returns
    both errors."""
    err, floor = rel_l2(got, truth), rel_l2(plain, truth)
    if not bool(torch.isfinite(got).all()) or err > floor + tol:
        raise AssertionError(
            f"{what}: relative L2 {err:.3e} against fp32, the plain route's "
            f"{floor:.3e} + {tol}")
    return err, floor


def gate_rel(what, got, want, tol=2e-2):
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite logits")
    rel = rel_l2(got, want)
    if rel > tol:
        raise AssertionError(f"{what}: relative L2 {rel:.3e} > {tol}")
    return rel


def agreement(a_reqs, b_streams):
    """Greedy tokens equal between requests and rid -> tokens."""
    pairs = [(r.generated, b_streams[r.rid]) for r in a_reqs if r.temperature == 0]
    same = sum(x == y for a, b in pairs for x, y in zip(a, b))
    return same, sum(len(a) for a, _ in pairs)


def submit_all(eng, RS, SP, prompts, sampled, max_tokens):
    reqs = []
    for i, p in enumerate(prompts):
        temp, top_k = (0.8, 8) if i in sampled else (0.0, 0)
        sp = SP(temperature=temp, top_k=top_k, seed=100 + i)
        reqs.append(eng.submit(RS(rid=i, prompt=p, max_tokens=max_tokens, sampling=sp)))
    return reqs


def serve_dense(mods, cfg, params, work, smi, per_step, per_prefill, tag, eager=True,
                **kw):
    """Phase 5's gated runs on the dense engine: the workload through a
    fresh engine's CUDA graphs, then its warm workload on the same engine;
    the same two eagerly (unless ``eager`` is False). The launch counts are reset just before and read
    just after each engine's runs. Gates: every request 32 in-vocab
    tokens, dense-decode launches = ``per_step`` x decode steps, SSD
    launches = ``per_prefill`` x prefills, dense replays = steps -
    captures and no capture in the warm run, one host sync per steady
    step, and the graph and eager streams token-identical. Returns
    {"graphs" / "eager": (reqs, warm reqs, stats, {"decode", "ssd"}
    launches of the cold run)}."""
    Engine, RS, SP, DA, SS, GR = mods
    prompts, warm_prompts, sampled = work
    runs = {}
    for what, graphs in (("graphs", True), ("eager", False))[: 2 if eager else 1]:
        DA.decode_attention.launches = 0
        SS.ssd_scan.launches = 0
        eng = Engine(cfg, params, device="cuda", cuda_graphs=graphs, **dict(DENSE_KW, **kw))
        counted = []
        for wl in (prompts, warm_prompts):
            dec0 = GR.launches_run(DA.decode_attention, [eng.graphs])
            ssd0 = SS.ssd_scan.launches
            _, reqs, stats = run_engine(
                Engine, RS, SP, cfg, params, None, wl, sampled, strict_sync=True, eng=eng
            )
            dec = GR.launches_run(DA.decode_attention, [eng.graphs]) - dec0
            ssd = SS.ssd_scan.launches - ssd0
            steps = stats["decode_steps"]
            for r in reqs:
                if len(r.generated) != 32 or not r.done:
                    raise AssertionError(f"{what} rid={r.rid}: {len(r.generated)} tokens")
                if not all(0 <= tok < cfg.vocab_size for tok in r.generated):
                    raise AssertionError(f"{what} rid={r.rid}: token out of range")
            if steps == 0 or dec != per_step * steps or ssd != per_prefill * len(wl):
                raise AssertionError(
                    f"{cfg.name} {what}: dense-decode launches {dec} for {steps} "
                    f"steps x {per_step}, SSD launches {ssd} for {len(wl)} "
                    f"prefills x {per_prefill}"
                )
            if set(stats["steady_syncs"]) != {1}:
                raise AssertionError(f"{what}: host syncs per steady step {stats['steady_syncs']}")
            counted.append((reqs, stats, dec, ssd))
        (reqs, stats, dec, ssd), (wreqs, wstats, wdec, wssd) = counted
        counts = eng.graphs.counts
        steps, wsteps = stats["decode_steps"], wstats["decode_steps"]
        if graphs and (
            counts.replays["dense"] != steps + wsteps - counts.captures["dense"]
            or wstats["captures"]
        ):
            raise AssertionError(
                f"dense replays {dict(counts.replays)} for {steps} + {wsteps} steps, "
                f"captures {dict(counts.captures)}, in the warm run {wstats['captures']}"
            )
        if not graphs and (counts.captures or counts.replays):
            raise AssertionError(f"eager run captured {dict(counts.captures)}")
        for label, rs, st, d, n in (
            (what, reqs, stats, dec, ssd), (f"{what}, warm", wreqs, wstats, wdec, wssd)
        ):
            n_tok = sum(len(r.generated) for r in rs)
            ttft, ms = st["ttft_s"], st["steady_step_ms"]
            log(
                f"[{tag}] {label}: {len(rs)} requests, {n_tok} tokens, "
                f"{st['decode_steps']} decode steps, dense-decode launches {d} "
                f"(= {per_step} x {st['decode_steps']}), SSD launches {n} (= "
                f"{per_prefill} x {len(rs)} prefills); captures in this run "
                f"{st['captures']}, the engine's so far {dict(counts.captures)}, "
                f"replays {dict(counts.replays)}, graph pool {eng.graphs.pool_bytes()} "
                f"B; wall {st['wall_s']:.3f} s, {n_tok / st['wall_s']:.1f} tok/s, "
                f"first token median {ttft[len(ttft) // 2] * 1e3:.1f} ms max "
                f"{ttft[-1] * 1e3:.1f} ms; steady step median {ms[len(ms) // 2]:.3f} "
                f"ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {len(ms)} steps, host "
                f"syncs per step {sorted(set(st['steady_syncs']))}; steady steps "
                f"that captured {st['capture_steps']} [{smi}]"
            )
        runs[what] = (reqs, wreqs, stats, {"decode": dec, "ssd": ssd})
        del eng
    if not eager:
        return runs
    reqs, wreqs = runs["graphs"][:2]
    for a, b in zip(reqs + wreqs, runs["eager"][0] + runs["eager"][1]):
        if a.generated != b.generated:
            raise AssertionError(f"{cfg.name}: graph and eager streams differ: rid {a.rid}")
    log(
        f"[{tag}] {cfg.name}: graph and eager runs token-identical for all "
        f"{len(reqs)} requests of each workload (the sampled ones included)"
    )
    return runs


def dense_tinyllama(mods, cfg, params, work, reference, smi):
    """Phase 10 a: tinyllama-1.1b through the dense cache. Returns the
    dense-decode launches of the graph engine's cold run."""
    from repro_torch.core.migration import tree_bytes

    Engine, RS, SP, DA, SS, GR, T, PK = mods
    prompts, _, sampled = work
    runs = serve_dense(mods[:6], cfg, params, work, smi, cfg.num_layers, 0, "dense")
    reqs, _, _, launches = runs["graphs"]
    eng = Engine(cfg, params, device="cuda", **DENSE_KW)
    log(
        f"[dense] {cfg.name}: cache {tree_bytes(eng.cache)} B "
        f"(K/V [L, B, S, KV, D] = {list(eng.cache['layers']['k'].shape)} bf16, positions, "
        f"length) [{smi}]"
    )
    # kernel vs gather on the first steady step's live cache, in bf16 and
    # with weights and cache widened to fp32
    out = {}
    p32 = widened(params)

    def probe(e):
        for impl in ("kernel", "gather"):
            out[impl] = dense_decode_logits(T, e, attn_impl=impl)
        c32 = widened(e.cache)
        for impl in ("kernel", "gather"):
            out[impl, 32] = dense_decode_logits(T, e, params=p32, cache=c32, attn_impl=impl)

    run_engine(Engine, RS, SP, cfg, params, None, prompts, sampled, probe=probe, eng=eng)
    del p32
    rel = gate_rel("dense kernel vs gather", out["kernel"], out["gather"])
    rel32 = gate_rel("dense kernel vs gather in fp32", out["kernel", 32], out["gather", 32],
                     tol=1e-4)
    gather_eng = Engine(cfg, params, device="cuda", dense_attn_impl="gather", **DENSE_KW)
    _, gather_reqs, _ = run_engine(Engine, RS, SP, cfg, params, None, prompts, sampled,
                                   eng=gather_eng)
    same, total = agreement(reqs, {r.rid: r.generated for r in gather_reqs})
    log(
        f"[dense] first steady decode step, kernel vs gather logits: relative L2 "
        f"{rel:.3e} in bf16 (tol 2e-2), {rel32:.3e} in fp32 (tol 1e-4); greedy tokens "
        f"equal between the kernel and gather runs {same}/{total} (bf16; not gated) "
        f"[{smi}]"
    )
    del gather_eng, eng
    # against the paged engine: both admit the 8 prompts (whole-prompt
    # prefill), then one decode step fed the same tokens
    paged = Engine(cfg, params, device="cuda", max_batch=8, max_len=1024,
                   dtype="bfloat16", scheduler="phase", prefix_sharing=False)
    dense = Engine(cfg, params, device="cuda", **DENSE_KW)
    for e in (paged, dense):
        submit_all(e, RS, SP, prompts, sampled, 32)
        e._admit()
    toks = np.zeros((8,), np.int64)
    first = {}
    for e, name in ((dense, "dense"), (paged, "paged")):
        first[name] = {s: r.generated[0] for s, r in e.active.items()}
    for s, r in dense.active.items():
        toks[s] = r.generated[-1]
    rel_p = gate_rel(
        "dense vs paged decode logits",
        dense_decode_logits(T, dense, toks, attn_impl="kernel"),
        paged_decode_logits(T, paged, toks),
    )
    first_same = sum(first["dense"][s] == first["paged"].get(s) for s in first["dense"])
    same, total = agreement(reqs, reference)
    log(
        f"[dense] dense vs paged engine (phase 5's settings, each prompt "
        f"prefilled whole): one decode step fed the same tokens, relative L2 "
        f"{rel_p:.3e} (tol 2e-2); first tokens equal {first_same}/8; greedy "
        f"tokens of the dense graph run equal to phase 5's paged run "
        f"{same}/{total} (bf16; not gated) [{smi}]"
    )
    del paged, dense
    return launches["decode"]


def dense_ring(mods, cfg, params, smi):
    """Phase 10 b: tinyllama-1.1b's sliding-window ring at the config's
    own window W = 8192 (W rows of a W + W / 16 = 8704-token logical
    length), 2 requests of W + W / 64 = 8320-token prompts and 16 new
    tokens, one-shot and with ``prefill_chunk`` = W / 4 = 2048, against
    the paged engine with ``swa=True`` on the same requests."""
    Engine, RS, SP, DA, SS, GR, T, PK = mods
    W = cfg.sliding_window
    S = W + W // 64
    rng = np.random.default_rng(SEED + 10)
    prompts = [rng.integers(2, cfg.vocab_size, size=S).astype(np.int32) for _ in range(2)]
    max_len = W + max(W // 16, 32)
    kw = dict(max_batch=2, max_len=max_len, dtype="bfloat16", swa=True, device="cuda")
    first_logits = {}

    def recording(eng, name):
        orig = eng._sample_batch

        def sample(logits, reqs):
            first_logits.setdefault(name, []).append(
                logits[:, : cfg.vocab_size].float().clone())
            return orig(logits, reqs)

        eng._sample_batch = sample

    engines = {
        "one-shot": Engine(cfg, params, cache_kind="dense", **kw),
        "chunked": Engine(cfg, params, cache_kind="dense", prefill_chunk=W // 4, **kw),
        # the oracle: paged, each prompt prefilled whole at its exact length
        "paged": Engine(cfg, params, scheduler="phase", prefix_sharing=False,
                        prefill_chunk=S, **kw),
    }
    t = time.perf_counter()
    for name, e in engines.items():
        recording(e, name)
        submit_all(e, RS, SP, prompts, set(), 16)
        e._admit()
        if len(e.active) != 2:
            raise AssertionError(f"ring {name}: {len(e.active)} admitted")
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t
    for name in ("one-shot", "chunked"):
        e = engines[name]
        if e.max_len != W:
            raise AssertionError(f"ring capacity {e.max_len}")
        pos = e.cache["positions"][:2]
        if bool((pos == 0).any()) or int(pos.max()) != S - 1 or int(pos.min()) != S - W:
            raise AssertionError(f"ring {name}: positions did not wrap")
    want_first = torch.cat(first_logits["paged"])
    toks = np.zeros((2,), np.int64)
    for s, r in engines["one-shot"].active.items():
        toks[s] = r.generated[-1]
    want_dec = paged_decode_logits(T, engines["paged"], toks)
    rels = {}
    for name in ("one-shot", "chunked"):
        e = engines[name]
        rels[name] = (
            gate_rel(f"ring {name} first-token logits", torch.cat(first_logits[name]), want_first),
            gate_rel(f"ring {name} decode logits",
                     dense_decode_logits(T, e, toks, attn_impl="kernel"), want_dec),
        )
    streams = {}
    for name in ("one-shot", "chunked"):
        e = engines[name]
        done = []
        while e.active:
            done += e.step() or []
        streams[name] = {r.rid: r.generated for r in done}
        if sorted(len(g) for g in streams[name].values()) != [16, 16]:
            raise AssertionError(f"ring {name}: {streams[name]}")
    same = sum(x == y for rid in (0, 1)
               for x, y in zip(streams["one-shot"][rid], streams["chunked"][rid]))
    log(
        f"[dense] ring: {cfg.name} swa, window {W} = cache rows, logical max_len "
        f"{max_len}, 2 prompts of {S} tokens: positions wrapped (rows hold "
        f"{S - W}..{S - 1}, none holds 0); against the paged engine with "
        f"swa (relative L2, tol 2e-2) first-token / decode logits: one-shot "
        f"{rels['one-shot'][0]:.3e} / {rels['one-shot'][1]:.3e}, prefill_chunk={W // 4} "
        f"{rels['chunked'][0]:.3e} / {rels['chunked'][1]:.3e}; 16 tokens each, "
        f"one-shot and chunked streams equal {same}/32 (not gated); the three "
        f"admissions took {admit_s:.2f} s [{smi}]"
    )


def full_width_params(T, cfg):
    """Random bf16 weights of ``cfg`` from a seeded generator on the card,
    their bytes gated to the reference's (after the peak-memory counter is
    reset). Returns (params, bytes, seconds)."""
    from repro_torch.core.migration import tree_bytes

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = T.init_params(cfg, gen, "bfloat16")
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    if weight_bytes != REFERENCE_WEIGHT_BYTES[cfg.name]:
        raise AssertionError(f"{cfg.name}: {weight_bytes} B of weights")
    return params, weight_bytes, time.perf_counter() - t


def step_summary(stats, bound_ms, busy_ms, smi):
    """The graph run's steady step beside its bound, the profiled busy
    time and the peak device memory since the last reset."""
    step_ms = stats["steady_step_ms"]
    median = step_ms[len(step_ms) // 2]
    return (
        f"graphs, cold: steady step median {median:.3f} ms against the "
        f"bound {bound_ms:.3f} ms ({bound_ms / median:.1%} of bound); device "
        f"busy {busy_ms:.3f} ms per steady step (profiled), idle share "
        f"outside the profiler {1 - busy_ms / median:.3f}; peak device "
        f"memory allocated {torch.cuda.max_memory_allocated()} B [{smi}]"
    )


def dense_ssm(mods, cfg, work, out_dir, smi, per_step):
    """Phase 10 c and d: an SSM or hybrid model at full width in bf16
    through the dense engine. Returns the {"decode", "ssd"} launches of
    the graph engine's cold run."""
    from repro_torch.core.migration import tree_bytes

    Engine, RS, SP, DA, SS, GR, T, PK = mods
    prompts, _, sampled = work
    tag = "mamba2" if cfg.family == "ssm" else "zamba2"
    t = time.perf_counter()
    params, weight_bytes, _ = full_width_params(T, cfg)
    # a decode step reads every weight once (the tied embedding is the
    # unembedding's matrix; the shared block's weights count once)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    nb = cfg.num_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    log(
        f"[{tag}] {cfg.name}: {cfg.num_layers} Mamba2 layers, d={cfg.d_model}, "
        f"d_inner={cfg.ssm_d_inner}, SSD H={cfg.ssm_heads} P={cfg.ssm_head_dim} "
        f"N={cfg.ssm_state} Q={cfg.ssm_chunk}"
        + (f", shared block applied {nb} times (H = KV = {cfg.num_heads}, D "
           f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff})" if nb else "")
        + f", vocab={cfg.vocab_size}; weights {weight_bytes} B in "
        f"{time.perf_counter() - t:.1f} s; decode-step weight-read bound "
        f"{bound_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s [{smi}]"
    )
    runs = serve_dense(mods[:6], cfg, params, work, smi, per_step, cfg.num_layers, tag)
    reqs, _, stats, launches = runs["graphs"]
    eng = Engine(cfg, params, device="cuda", **DENSE_KW)
    cache_bytes = tree_bytes(eng.cache)
    # both kernel routes against both plain routes, on every prompt's
    # first-token logits and on one decode step of the first steady
    # step's cache: in fp32 (weights and cache widened, TF32 off) the
    # logits within 1e-4; in bf16 each kernel call against its plain
    # version on the same inputs within 2e-2, and the logits through
    # no_worse_than_plain (bf16's own error at full depth is larger than
    # 2e-2, so bf16 logits of two routes that round differently differ by
    # more than that)
    plain = dict(attn_impl="gather", ssd_impl="chunked")
    kern = dict(attn_impl="kernel", ssd_impl="kernel")
    p32 = widened(params)
    calls, logits, busy = {}, {}, {}
    with checked_kernel_calls(calls):
        logits["first", "kernel"] = prefill_logits(T, cfg, params, prompts, 1024, **kern)
    logits["first", "plain"] = prefill_logits(T, cfg, params, prompts, 1024, **plain)
    for route, kw in (("kernel32", kern), ("plain32", plain)):
        logits["first", route] = prefill_logits(T, cfg, p32, prompts, 1024, "float32", **kw)
    # the table only: the SSM steps' traces (~40k events each) would pass
    # the size of what a run may bring back
    profile = functools.partial(profile_decode, out_dir=out_dir, smi=smi, tag=f"_{tag}",
                                sink=busy, keep_trace=False)

    def probe(e):
        with checked_kernel_calls(calls):
            logits["decode", "kernel"] = dense_decode_logits(T, e, **kern)
        logits["decode", "plain"] = dense_decode_logits(T, e, **plain)
        c32 = widened(e.cache)
        for route, kw in (("kernel32", kern), ("plain32", plain)):
            logits["decode", route] = dense_decode_logits(T, e, params=p32, cache=c32, **kw)
        del c32
        profile(e)

    run_engine(Engine, RS, SP, cfg, params, None, prompts, sampled, probe=probe, eng=eng)
    del eng
    worst = {k: max(v) for k, v in calls.items()}
    if len(calls.get("ssd", ())) != cfg.num_layers * len(prompts) or (
        nb and len(calls.get("decode", ())) != nb
    ) or max(worst.values()) > 2e-2:
        raise AssertionError(
            f"{cfg.name}: kernel calls against their plain versions: "
            f"{ {k: len(v) for k, v in calls.items()} } calls, worst {worst}"
        )
    rel = {}
    for what in ("first", "decode"):
        rel[what, "32"] = gate_rel(
            f"{cfg.name} {what} logits, kernel vs plain routes in fp32",
            logits[what, "kernel32"], logits[what, "plain32"], tol=1e-4,
        )
        rel[what, "16"] = rel_l2(logits[what, "kernel"], logits[what, "plain"])
        rel[what, "k16"], rel[what, "p16"] = no_worse_than_plain(
            f"{cfg.name} {what} logits, kernel route in bf16", logits[what, "kernel"],
            logits[what, "plain"], logits[what, "plain32"])
    routes = "the SSD kernel vs ssd_chunked" + (
        ", the dense-decode kernel vs gather" if nb else "")
    log(
        f"[{tag}] cache {cache_bytes} B; kernel routes vs plain routes ({routes}): "
        f"each bf16 kernel call against its plain version on the same inputs, worst "
        f"relative L2 {worst} over { {k: len(v) for k, v in calls.items()} } calls "
        f"(tol 2e-2); logits relative L2, first token of the 8 prompts / first steady "
        f"decode step: fp32 {rel['first', '32']:.3e} / {rel['decode', '32']:.3e} "
        f"(tol 1e-4); bf16 {rel['first', '16']:.3e} / {rel['decode', '16']:.3e}, "
        f"against fp32 plain: kernel route {rel['first', 'k16']:.3e} / "
        f"{rel['decode', 'k16']:.3e}, plain route {rel['first', 'p16']:.3e} / "
        f"{rel['decode', 'p16']:.3e} (bf16's own error; the kernel route's may "
        f"exceed it by 2e-2) [{smi}]"
    )
    # prefill_chunk=256 against one shot: the last chunk's logits of every
    # prompt through each engine's own prefill (fp32, 1e-4; bf16 printed),
    # and the greedy streams of a chunked engine against phase 10's run
    last = {}
    for dtype, w in (("bfloat16", params), ("float32", p32)):
        for chunk in (256, 0):
            e = Engine(cfg, w, device="cuda", prefill_chunk=chunk,
                       **dict(DENSE_KW, dtype=dtype, max_batch=1))
            last[dtype, chunk] = torch.cat(
                [e._run_prefill(p[None], cache_len=1024)[0][:, : cfg.vocab_size]
                 for p in prompts])
            del e
    del p32
    rel_chunk = gate_rel(
        f"{cfg.name} prefill_chunk=256 vs one-shot last-chunk logits in fp32",
        last["float32", 256], last["float32", 0], tol=1e-4,
    )
    rel_chunk16 = rel_l2(last["bfloat16", 256], last["bfloat16", 0])
    chunk16, one16 = no_worse_than_plain(
        f"{cfg.name} prefill_chunk=256 last-chunk logits in bf16",
        last["bfloat16", 256], last["bfloat16", 0], last["float32", 0])
    chunked = Engine(cfg, params, device="cuda", prefill_chunk=256, **DENSE_KW)
    _, creqs, _ = run_engine(Engine, RS, SP, cfg, params, None, prompts, sampled, eng=chunked)
    same, total = agreement(creqs, {r.rid: r.generated for r in reqs})
    log(
        f"[{tag}] prefill_chunk=256 vs one-shot: last-chunk logits relative L2 "
        f"{rel_chunk:.3e} in fp32 (tol 1e-4), {rel_chunk16:.3e} in bf16; against "
        f"one shot in fp32, chunked {chunk16:.3e} and one-shot {one16:.3e} in bf16 "
        f"(the first may exceed the second by 2e-2); "
        f"greedy tokens equal {same}/{total} (bf16; not gated); weight-read "
        f"bound; {step_summary(stats, bound_ms, busy[f'_{tag}'], smi)}"
    )
    return launches


def dense_phase(mods, get_config, reference, out_dir, smi):
    """Phase 10 (module docstring). Returns the launches of the graph
    engines' cold runs: {"decode": {model: n}, "ssd": {model: n}}."""
    Engine, RS, SP, DA, SS, GR, T, PK = mods
    cfg = get_config("tinyllama-1.1b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = T.init_params(cfg, gen, "bfloat16")   # phase 5's weights
    work = (workload(cfg)[0], workload(cfg, seed=SEED + 1)[0], workload(cfg)[1])
    t = time.perf_counter()
    dec_tl = dense_tinyllama(mods, cfg, params, work, reference, smi)
    log(f"[dense] 10a in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    dense_ring(mods, cfg, params, smi)
    log(f"[dense] 10b in {time.perf_counter() - t:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"decode": {cfg.name: dec_tl}, "ssd": {}}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        t = time.perf_counter()
        c = dataclasses.replace(get_config(arch), num_layers=PHASE10_LAYERS[arch])
        per_step = c.num_layers // c.hybrid_attn_every if c.hybrid_attn_every else 0
        prompts, sampled = workload(c)
        work = (prompts, workload(c, seed=SEED + 1)[0], sampled)
        got = dense_ssm(mods, c, work, out_dir, smi, per_step)
        launches["ssd"][arch] = got["ssd"]
        if per_step:
            launches["decode"][arch] = got["decode"]
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[dense] {arch} in {time.perf_counter() - t:.1f} s")
    return launches


def dense_mla(mods, cfg, work, out_dir, smi):
    """Phase 11 a: minicpm3-4b (MLA) at full width in bf16 through the
    dense engine. MLA has no kernel (the reference attends it plainly):
    the dense-decode launches are gated to 0."""
    from repro_torch.core.migration import tree_bytes

    Engine, RS, SP, DA, SS, GR, T, PK = mods
    prompts, _, sampled = work
    params, weight_bytes, init_s = full_width_params(T, cfg)
    # a decode step reads every weight once (the tied embedding is the
    # unembedding's matrix)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(
        f"[minicpm3] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"H={cfg.num_heads}, MLA q rank {cfg.q_lora_rank}, kv rank "
        f"{cfg.kv_lora_rank}, rope {cfg.qk_rope_head_dim}, nope "
        f"{cfg.qk_nope_head_dim}, v {cfg.v_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}; weights {weight_bytes} B in {init_s:.1f} s; "
        f"decode-step weight-read bound {bound_ms:.3f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s [{smi}]"
    )
    runs = serve_dense(mods[:6], cfg, params, work, smi, 0, 0, "minicpm3")
    reqs, _, stats, _ = runs["graphs"]
    # the absorbed decode against the expanded form: an engine admits the
    # 8 prompts (its prefills: the expanded form), then one decode step of
    # its live cache (the absorbed form) fed each row's first token,
    # against one prefill over each prompt plus that token; gated in fp32
    # (weights widened, TF32 off), bf16 printed
    p32 = widened(params)
    rel, cache_bytes = {}, None
    for dtype, w in (("float32", p32), ("bfloat16", params)):
        eng = Engine(cfg, w, device="cuda", **dict(DENSE_KW, dtype=dtype))
        if dtype == "bfloat16":
            cache_bytes = tree_bytes(eng.cache)
        submit_all(eng, RS, SP, prompts, sampled, 32)
        eng._admit()
        act = sorted(eng.active)
        if len(act) != len(prompts):
            raise AssertionError(f"{cfg.name}: {len(act)} admitted")
        dec = dense_decode_logits(T, eng)
        longer = [np.append(prompts[eng.active[s].rid], eng.active[s].generated[-1])
                  for s in act]
        rel[dtype] = rel_l2(dec, prefill_logits(T, cfg, w, longer, DENSE_KW["max_len"],
                                                dtype))
        del eng
    if cache_bytes != REFERENCE_CACHE_BYTES[cfg.name]:
        raise AssertionError(f"{cfg.name}: cache {cache_bytes} B")
    if not rel["float32"] <= 1e-4:
        raise AssertionError(
            f"{cfg.name}: absorbed decode vs expanded prefill logits, relative L2 "
            f"{rel['float32']:.3e} in fp32 > 1e-4")
    # prefill_chunk=256 (its extensions attend in the absorbed form)
    # against one shot: the last chunk's logits (fp32 gated 1e-4, bf16
    # printed) and the greedy streams of a chunked engine
    last = {}
    for dtype, w in (("bfloat16", params), ("float32", p32)):
        for chunk in (256, 0):
            e = Engine(cfg, w, device="cuda", prefill_chunk=chunk,
                       **dict(DENSE_KW, dtype=dtype, max_batch=1))
            last[dtype, chunk] = torch.cat(
                [e._run_prefill(p[None], cache_len=DENSE_KW["max_len"])[0][:, : cfg.vocab_size]
                 for p in prompts])
            del e
    del p32
    rel_chunk = gate_rel(
        f"{cfg.name} prefill_chunk=256 vs one-shot last-chunk logits in fp32",
        last["float32", 256], last["float32", 0], tol=1e-4,
    )
    rel_chunk16 = rel_l2(last["bfloat16", 256], last["bfloat16", 0])
    chunked = Engine(cfg, params, device="cuda", prefill_chunk=256, **DENSE_KW)
    _, creqs, _ = run_engine(Engine, RS, SP, cfg, params, None, prompts, sampled,
                             eng=chunked)
    same, total = agreement(creqs, {r.rid: r.generated for r in reqs})
    del chunked
    busy = {}
    profile = functools.partial(profile_decode, out_dir=out_dir, smi=smi,
                                tag="_minicpm3", sink=busy, keep_trace=False)
    run_engine(Engine, RS, SP, cfg, params, None, prompts, sampled, probe=profile,
               eng=Engine(cfg, params, device="cuda", **DENSE_KW))
    log(
        f"[minicpm3] cache {cache_bytes} B (latents c [L, B, S, {cfg.kv_lora_rank}] "
        f"and kr [L, B, S, {cfg.qk_rope_head_dim}] bf16, positions, length); "
        f"absorbed decode vs expanded prefill over prompt + token, logits of the "
        f"8 rows: relative L2 {rel['float32']:.3e} in fp32 (tol 1e-4), "
        f"{rel['bfloat16']:.3e} in bf16 (not gated); prefill_chunk=256 vs one "
        f"shot, last-chunk logits {rel_chunk:.3e} in fp32 (tol 1e-4), "
        f"{rel_chunk16:.3e} in bf16; greedy tokens equal {same}/{total} (bf16; "
        f"not gated); weight-read bound; "
        f"{step_summary(stats, bound_ms, busy['_minicpm3'], smi)}"
    )
    del params


def whisper_frames(cfg):
    """An ``encoder_input_fn``: each request's frames [1, S_enc, d] in
    fp32 (the reference engine's default frames' type), drawn on the
    card from a generator seeded by its rid."""

    def frames(req):
        gen = torch.Generator(device="cuda").manual_seed(req.rid)
        return torch.randn((1, cfg.encoder_seq_len, cfg.d_model), generator=gen,
                           device="cuda")

    return frames


def dense_audio(mods, cfg, work, out_dir, smi):
    """Phase 11 b: whisper-medium at full width in bf16 through the dense
    engine, frames from ``whisper_frames``. Returns the dense-decode
    launches of the graph engine's cold run (self- and cross-attention of
    every decoder layer, 2 x decoder layers a step)."""
    from repro_torch.core.migration import tree_bytes

    Engine, RS, SP, DA, SS, GR, T, PK = mods
    prompts, _, sampled = work
    params, weight_bytes, init_s = full_width_params(T, cfg)
    log(
        f"[whisper] {cfg.name}: {cfg.num_encoder_layers} encoder and "
        f"{cfg.num_layers} decoder layers, d={cfg.d_model}, H = KV = "
        f"{cfg.num_heads} of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}; weights {weight_bytes} B in {init_s:.1f} s [{smi}]"
    )
    kw = dict(max_len=WHISPER_MAX_LEN, encoder_input_fn=whisper_frames(cfg))
    runs = serve_dense(mods[:6], cfg, params, work, smi, 2 * cfg.num_layers, 0,
                       "whisper", **kw)
    reqs, _, stats, launches = runs["graphs"]
    eng = Engine(cfg, params, device="cuda", **dict(DENSE_KW, **kw))
    cache_bytes = tree_bytes(eng.cache)
    if cache_bytes != REFERENCE_CACHE_BYTES[cfg.name]:
        raise AssertionError(f"{cfg.name}: cache {cache_bytes} B")
    # a decode step reads the decoder's weights (not the cross K/V
    # projections, which only a prefill uses, nor the embedding but its 8
    # rows), the lm_head, the cross K/V, the cache's positions and length,
    # and of the self K/V only each row's first position + 1 rows (the
    # kernel's lengths; an idle row reads one): the bound is taken at the
    # probe's step, the first steady one, whose rows later steps only add to
    dec, ck = params["layers"], eng.cache["layers"]["k"]
    fixed_bytes = (
        tree_bytes(dec) - tree_bytes({k: dec["xattn"][k] for k in ("wk", "wv")})
        + tree_bytes(params["lm_head"]) + tree_bytes(params["final_norm"])
        + cache_bytes - 2 * tree_bytes(ck)
    )
    row_bytes = 2 * ck.shape[0] * ck[0, 0, 0].numel() * ck.element_size()
    all_rows = ck.shape[1] * ck.shape[2]
    del ck
    # kernel vs gather on the first steady step's live cache: every kernel
    # call held against its plain version on the same inputs (2e-2), the
    # logits in bf16 (2e-2) and with weights and cache widened (1e-4)
    out, calls = {}, {}
    p32 = widened(params)

    def probe(e):
        out["rows"] = int((e._host_lengths + 1).sum())
        with checked_kernel_calls(calls):
            out["kernel"] = dense_decode_logits(T, e, attn_impl="kernel")
        out["gather"] = dense_decode_logits(T, e, attn_impl="gather")
        c32 = widened(e.cache)
        for impl in ("kernel", "gather"):
            out[impl, 32] = dense_decode_logits(T, e, params=p32, cache=c32, attn_impl=impl)

    run_engine(Engine, RS, SP, cfg, params, None, prompts, sampled, probe=probe, eng=eng)
    del p32, eng
    step_bytes = fixed_bytes + out["rows"] * row_bytes
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(
        f"[whisper] cache {cache_bytes} B (self K/V [L, B, {WHISPER_MAX_LEN}, KV, D] "
        f"and cross K/V [L, B, {cfg.encoder_seq_len}, KV, D] bf16, positions, "
        f"length); decode-step bound {bound_ms:.3f} ms ({step_bytes} B at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: the self K/V at the first steady "
        f"step's {out['rows']} rows over the batch, of {all_rows}) [{smi}]"
    )
    worst = max(calls.get("decode", [float("inf")]))
    if len(calls.get("decode", ())) != 2 * cfg.num_layers or worst > 2e-2:
        raise AssertionError(
            f"{cfg.name}: dense-decode calls against their plain versions: "
            f"{len(calls.get('decode', ()))} calls, worst {worst}")
    rel = gate_rel(f"{cfg.name} kernel vs gather logits", out["kernel"], out["gather"])
    rel32 = gate_rel(f"{cfg.name} kernel vs gather logits in fp32", out["kernel", 32],
                     out["gather", 32], tol=1e-4)
    busy = {}
    profile = functools.partial(profile_decode, out_dir=out_dir, smi=smi,
                                tag="_whisper", sink=busy, keep_trace=False)
    run_engine(Engine, RS, SP, cfg, params, None, prompts, sampled, probe=profile,
               eng=Engine(cfg, params, device="cuda", **dict(DENSE_KW, **kw)))
    log(
        f"[whisper] first steady decode step, kernel routes (self- and "
        f"cross-attention) vs gather: each of the {len(calls['decode'])} bf16 "
        f"kernel calls against its plain version, worst relative L2 {worst:.3e} "
        f"(tol 2e-2); logits {rel:.3e} in bf16 (tol 2e-2), {rel32:.3e} in fp32 "
        f"(tol 1e-4); decode-step bound; "
        f"{step_summary(stats, bound_ms, busy['_whisper'], smi)}"
    )
    del params
    return launches["decode"]


def encdec_phase(mods, get_config, out_dir, smi):
    """Phase 11 (module docstring). Returns the dense-decode launches of
    the graph engines' cold runs: {model: n}."""
    T = mods[6]
    launches = {}
    for arch in (MLA_ARCH, AUDIO_ARCH):
        t = time.perf_counter()
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, **PHASE11_LAYERS[arch])
        prompts, sampled = workload(cfg)
        warm = workload(cfg, seed=SEED + 1)[0]
        if arch == MLA_ARCH:
            dense_mla(mods, cfg, (prompts, warm, sampled), out_dir, smi)
            launches[arch] = 0
        else:
            cap = [[p[:WHISPER_PROMPT] for p in ps] for ps in (prompts, warm)]
            launches[arch] = dense_audio(mods, cfg, (*cap, sampled), out_dir, smi)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[dense] {arch} in {time.perf_counter() - t:.1f} s")
    return launches


# -------------------------------------------- replication across two ranks
#: phase 12's ranks: two processes sharing the one card in a gloo group
#: (NCCL refuses two ranks on one device: "Duplicate GPU detected")
REPL_RANKS = 2


def predicted_gathers(degrees):
    """The all-gathers the replication hooks make in one paged decode
    step under ``degrees``: one per replicated layer (its K/V rows) and
    one where a run of layers of one degree above 1 ends (at a change of
    degree or after the last layer)."""
    n, cur = sum(d > 1 for d in degrees), 1
    for d in (*degrees, 1):
        n += cur > 1 and d != cur
        cur = d
    return n


def tensor_sha(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


class Top2:
    """While installed, wraps ``transformer.forward_paged`` (which the
    engine's decode step calls): each decode step's top-2 logits of every
    active row, keyed by (rid, index of the token being sampled) — the
    witness of a greedy flip between two runs."""

    def __init__(self, T, cfg):
        self.T, self.V, self.orig = T, cfg.vocab_size, T.forward_paged
        self.eng, self.rec = None, {}

    def __call__(self, *args, **kw):
        logits, cache, aux = self.orig(*args, **kw)
        vals, ids = (t.cpu().tolist() for t in logits[:, : self.V].float().topk(2, dim=-1))
        for slot, req in self.eng.active.items():
            self.rec[(req.rid, len(req.generated))] = (vals[slot], ids[slot])
        return logits, cache, aux

    @contextlib.contextmanager
    def installed(self, eng):
        self.eng, self.T.forward_paged = eng, self
        try:
            yield self
        finally:
            self.T.forward_paged = self.orig


def repl_flips(c, one, rec_one, got, rec_got):
    """The first differing token of each greedy stream of two runs, with
    each run's top-2 logits there: (rid, index, top-2 of ``one``, of
    ``got``)."""
    out = []
    for i in range(len(c.prompts)):
        if i in c.sampled or one[i] == got[i]:
            continue
        t = next(j for j, (a, b) in enumerate(zip(one[i], got[i])) if a != b)
        out.append((i, t, rec_one.get((i, t)), rec_got.get((i, t))))
    return out


def repl_run(c, params, dtype, plans, probe=None, rec=None, migrate_at=None,
             profile_dir=None, check=None):
    """Phase 5's workload through a fresh eager ``Engine(group=...)`` on
    this rank, ``plans[i]`` applied before step i; each steady step timed
    (ms, collectives, host syncs), apart by whether its degrees replicate;
    every request's last token after every step; the pool's sha256 at the
    end. ``probe(eng)`` runs before the first steady step; ``rec`` (a
    ``Top2``) records the decode logits; at ``migrate_at`` every rank but
    0 loses its pool (zeroed) and takes rank 0's back through
    ``migrate_paged_pool``; ``profile_dir`` profiles the second timed
    steady replicated step; ``check`` (a dict) holds every paged-kernel
    call of the first steady replicated step against its plain version
    (``checked_kernel_calls``: ``check["paged"]``, one relative L2 a
    call). Neither of those two steps is timed."""
    from torch.profiler import ProfilerActivity, profile

    eng = c.Engine(c.cfg, params, paged_attn_impl="kernel", device=c.device,
                   cuda_graphs=False, group=c.group, **dict(ENGINE_KW, dtype=dtype))
    reqs = []
    for i, p in enumerate(c.prompts):
        temp, top_k = (0.8, 8) if i in c.sampled else (0.0, 0)
        sampling = c.SP(temperature=temp, top_k=top_k, seed=100 + i)
        reqs.append(eng.submit(c.RS(rid=i, prompt=p, max_tokens=32, sampling=sampling)))
    c.PD.paged_decode_attention.launches = 0
    out = {"one": [], "rep": [], "colls": [], "steps": [], "profile": None,
           "pool_move": None}
    i = 0
    with rec.installed(eng) if rec else contextlib.nullcontext():
        while eng.queue or eng.active or eng.prefilling:
            if i in plans:
                eng.apply_plan(plans[i])
            if i == migrate_at:
                st, k0 = eng.pstate, eng.pstate.k
                if c.group.rank:
                    st.k.zero_()
                    st.v.zero_()
                _, cost = c.MIG.migrate_paged_pool(st, (), c.group, measure=True)
                if st.k is not k0 or cost.bytes_moved != 2 * k0.numel() * k0.element_size():
                    raise AssertionError(f"pool move: {cost}, rebound {st.k is not k0}")
                out["pool_move"] = (cost.bytes_moved, cost.measured_seconds)
            steady = not eng.queue and not eng.prefilling
            if steady and probe is not None:   # its launches do not count
                n0 = c.PD.paged_decode_attention.launches
                probe(eng)
                c.PD.paged_decode_attention.launches = n0
                probe = None
            degrees = eng._step_degrees
            replicated = degrees is not None and max(degrees) > 1
            prof = (profile_dir is not None and steady and replicated
                    and len(out["rep"]) == 1 and out["profile"] is None)
            checked = check is not None and steady and replicated and not check
            launches, decoded = c.PD.paged_decode_attention.launches, eng._step_count
            c.INS.synchronize(c.device)
            t = time.perf_counter()
            with contextlib.ExitStack() as stack:
                n = stack.enter_context(c.R.count_collectives(c.group))
                syncs = stack.enter_context(c.INS.count_host_syncs())
                if prof:
                    p = stack.enter_context(profile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
                if checked:
                    stack.enter_context(checked_kernel_calls(check))
                eng.step()
            ms = (time.perf_counter() - t) * 1e3
            if replicated and eng._step_count > decoded:
                out["colls"].append(sum(n.values()))
            if prof:
                c.INS.synchronize(c.device)
                trace = profile_dir / f"replicated_step_trace_rank{c.group.rank}.json"
                p.export_chrome_trace(str(trace))
                kernels = [ev["name"] for ev in json.loads(trace.read_text())["traceEvents"]
                           if ev.get("cat") == "kernel"]
                out["profile"] = {
                    "split_kernels": sum("split_kernel" in k for k in kernels),
                    "device_kernels": len(kernels),
                    "launches": c.PD.paged_decode_attention.launches - launches,
                }
            elif steady and not checked:
                out["rep" if replicated else "one"].append(
                    (ms, sum(n.values()), syncs.n, degrees if replicated else None))
            out["steps"].append([(r.rid, r.generated[-1] if r.generated else -1) for r in reqs])
            i += 1
    nb = eng.pstate.k.shape[1] - 1
    out.update(
        streams={r.rid: r.generated for r in reqs},
        launches=c.PD.paged_decode_attention.launches,
        decode_steps=eng._step_count,
        eager=eng.graphs.counts.eager["decode"],
        pool=tensor_sha(eng.pstate.k[:, :nb], eng.pstate.v[:, :nb]),
    )
    return out


#: phase 12's re-placement part: llama2-13b at published width, cut to
#: these of its 40 layers (cut from 10 for the script's time)
REPLACE_LAYERS = 6
#: what rank 1's peak device memory may grow by in step (a) beyond the
#: shards it receives
REPLACE_SLACK = 64 << 20
#: the moves of the re-placement part, in order: (step, tree, path regex,
#: placement, the share of the moved leaves' bytes rank 0 and rank 1
#: receive). Step (a) splits the attention projections on their heads
#: (wo on its rows), (b) takes them back replicated, (c) replicates every
#: other leaf, splits w_up / w_down on d_ff (each rank holds its half
#: already) and replicates them again, (d) splits the dense KV cache on
#: its KV heads and replicates it again
REPLACE_MOVES = (
    ("a", "params", r"layers/attn/w[qkv]$", (None, None, "r0"), (0, 0.5)),
    ("a", "params", r"layers/attn/wo$", (None, "r0"), (0, 0.5)),
    ("b", "params", r"layers/attn/", (), (0.5, 0.5)),
    ("c", "params", r"^(?!layers/attn/)", (), (0, 1)),
    ("c split", "params", r"layers/mlp/w_up$", (None, None, "r0"), (0, 0)),
    ("c split", "params", r"layers/mlp/w_down$", (None, "r0"), (0, 0)),
    ("c back", "params", r"layers/mlp/w_(up|down)$", (), (0.5, 0.5)),
    ("d", "cache", r"layers/", (None, None, None, "r0"), (0, 0.5)),
    ("d back", "cache", r"layers/", (), (0.5, 0.5)),
)


def path_leaves(tree, regex, prefix=""):
    """(path, leaf) of each leaf of a dict tree whose '/'-joined path
    matches ``regex`` (``migrate_by_path``'s matching)."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from path_leaves(v, regex, path + "/")
        elif re.search(regex, path):
            yield path, v


def bits_checksum(t, chunk=1 << 25):
    """Two int64 sums of a tensor's bits on its device, plain and
    position-weighted, both wrapping: equal bits give equal sums, and the
    shape goes beside them."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = t.reshape(-1).view(ints[t.element_size()])
    sums = torch.zeros(2, dtype=torch.int64, device=t.device)
    for i in range(0, flat.numel(), chunk):
        x = flat[i:i + chunk].long()
        w = torch.arange(i, i + x.numel(), device=t.device) % 65521 + 1
        sums[0] += x.sum()
        sums[1] += (x * w).sum()
    return (*sums.tolist(), tuple(t.shape))


def replacement_step(T, PK, cfg, params, device, rows=8, bs=16):
    """One paged decode step of ``cfg`` on ``params`` through the
    paged-decode kernel: 8 rows of 64 to 561 tokens in a pool drawn from
    a fixed seed, tokens likewise. Returns the logits over the vocabulary."""
    lens = [64 + 71 * i for i in range(rows)]
    st = PK.init_paged(cfg, rows, sum(-(-(n + 1) // bs) for n in lens), block_size=bs,
                       dtype="bfloat16", max_len=1024, device=device)
    for slot, n in enumerate(lens):
        PK.allocate(st, slot, n + 1)
        st.lengths[slot] = n
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    st.k.normal_(generator=gen)
    st.v.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen, device=device)
    handle = {
        "k": st.k,
        "v": st.v,
        "block_tables": torch.from_numpy(st.block_tables.copy()).to(device),
        "lengths": torch.from_numpy(st.lengths.copy()).to(device),
        "active": torch.ones(rows, dtype=torch.bool, device=device),
    }
    return T.forward_paged(params, cfg, tokens, handle, attn_impl="kernel")[0][:, : cfg.vocab_size]


def replacement_part(c, reduced=False):
    """Phase 12's re-placement part on this rank (module docstring):
    rank 0 draws llama2-13b at ``REPLACE_LAYERS`` layers and a dense KV
    cache of 8 rows x 1024, rank 1 holds ``meta`` placeholders of both;
    ``REPLACE_MOVES`` run in order, each timed, with the bytes this rank
    received and the plan's, its collectives and the bits checksum of
    every leaf it re-placed; rank 1's peak device memory over step (a);
    then (e), one paged decode step on the re-placed weights (rank 0 also
    runs it first, on its own weights before any move). ``reduced``
    rehearses it at the config's reduced widths."""
    from repro_torch.configs import get_config
    from repro_torch.serving import paged_kv as PK

    T, MIG, group, device = c.T, c.MIG, c.group, c.device
    rank = group.rank
    cfg = get_config("llama2-13b")
    cfg = cfg.reduced() if reduced else dataclasses.replace(cfg, num_layers=REPLACE_LAYERS)
    if rank == 0:
        gen = torch.Generator(device=device).manual_seed(SEED)
        trees = {"params": T.init_params(cfg, gen, "bfloat16"),
                 "cache": T.init_cache(cfg, 8, 1024, "bfloat16", device)}
        for x in trees["cache"]["layers"].values():
            x.normal_(generator=gen)
    else:
        trees = {"params": T.init_params_meta(cfg, "bfloat16"),
                 "cache": T.init_cache(cfg, 8, 1024, "bfloat16", "meta")}
    res = {"layers": cfg.num_layers, "name": cfg.name, "moves": [], "expect": {}}
    launches = c.PD.paged_decode_attention.launches
    if rank == 0:   # every rank's block of every leaf a move places, unmoved
        for _, tree, regex, spec, _ in REPLACE_MOVES:
            for path, leaf in path_leaves(trees[tree], regex):
                for q in range(group.size):
                    block = MIG.replacement_plan(leaf.shape, None, spec, group.size).after[q]
                    key = f"{tree}/{path} {block}"
                    if key not in res["expect"]:
                        res["expect"][key] = bits_checksum(leaf[tuple(slice(*b) for b in block)])
        res["logits_before"] = bits_checksum(
            replacement_step(T, PK, cfg, trees["params"], device))
    group.all_reduce(torch.zeros(1, device=device))   # both ranks start together
    t0 = time.perf_counter()
    pending = []    # a step's leaves, checksummed once the step (and its peak) is done
    for i, (step, tree, regex, spec, _) in enumerate(REPLACE_MOVES):
        planned = MIG.planned_bytes(trees[tree], regex, spec, group.size, rank)
        counts, received = collections.Counter(group.counts), group.bytes_received
        if step == "a" and "a_base" not in res and device.type == "cuda":
            c.INS.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            res["a_base"] = torch.cuda.memory_allocated(device)
        move = MIG.migrate_kv_cache if tree == "cache" else functools.partial(
            MIG.migrate_by_path, path_regex=regex)
        trees[tree], cost = move(trees[tree], new_spec=spec, group=group, measure=True)
        res["moves"].append({
            "step": step, "regex": regex, "spec": spec, "planned": planned,
            "received": group.bytes_received - received,
            "collectives": dict(group.counts - counts), "moved": cost.bytes_moved,
            "seconds": cost.measured_seconds, "estimate": cost.est_seconds,
        })
        leaves = {}
        for path, leaf in path_leaves(trees[tree], regex):
            block = MIG.replacement_plan(MIG.placement_of(leaf).shape, None, spec,
                                         group.size).after[rank]
            leaves[f"{tree}/{path} {block}"] = leaf
        pending.append((res["moves"][-1], leaves))
        if i + 1 < len(REPLACE_MOVES) and REPLACE_MOVES[i + 1][0] == step:
            continue
        if step == "a" and device.type == "cuda":
            res["a_peak"] = torch.cuda.max_memory_allocated(device)
            res["a_shards"] = sum(x.numel() * x.element_size() for x in tree_leaves(
                trees["params"]["layers"]["attn"]))
        for record, done in pending:
            record["checksums"] = {k: bits_checksum(x) for k, x in done.items()}
        pending.clear()
    res["seconds"] = time.perf_counter() - t0
    res["logits"] = bits_checksum(replacement_step(T, PK, cfg, trees["params"], device))
    res["launches"] = c.PD.paged_decode_attention.launches - launches
    return res


def replacement_gates(r0, r1, on_card, smi):
    """Gates and prints phase 12's re-placement part (``replacement_part``
    on both ranks). Returns the paged kernel's launches on both ranks."""
    name, L = r0["name"], r0["layers"]
    expect = r0["expect"]
    for i, (a, b) in enumerate(zip(r0["moves"], r1["moves"])):
        what = f"re-placement {a['step']} ({a['regex']} -> {a['spec']})"
        for r, m in ((0, a), (1, b)):
            share = REPLACE_MOVES[i][4][r]
            if not m["received"] == m["planned"] == share * m["moved"]:
                raise AssertionError(f"{what} rank {r}: received {m['received']} B, "
                                     f"the plan {m['planned']} B, {share} of the "
                                     f"{m['moved']} B moved")
            for key, ck in m["checksums"].items():
                if expect.get(key) != ck:
                    raise AssertionError(f"{what} rank {r}: {key} is not rank 0's "
                                         f"original slice ({ck} / {expect.get(key)})")
        n = [m["collectives"] for m in (a, b)]
        if a["step"] == "c split":
            if a["received"] or b["received"] or n != [{}, {}]:
                raise AssertionError(f"{what}: each rank holds its half already, yet "
                                     f"{a['received']} / {b['received']} B, {n}")
        elif n != [{"all-to-all": len(a["checksums"])}] * 2:
            raise AssertionError(f"{what}: collectives {n}, one all-to-all a leaf")
        log(
            f"[replacement] {name} ({L} of 40 layers, bf16) move {i} step "
            f"{a['step']}: {a['regex']} -> {a['spec']}: {len(a['checksums'])} leaves, "
            f"bytes_moved {a['moved']} B; received rank 0 / 1 {a['received']} / "
            f"{b['received']} B (= the plan's); collectives {n[0]} / {n[1]}; "
            f"{a['seconds']:.3f} / {b['seconds']:.3f} s (estimate_cost "
            f"{a['estimate']:.3f} s); each rank's leaves bit-equal to rank 0's "
            f"original slices [{smi}]"
        )
    if on_card:
        grew = r1["a_peak"] - r1["a_base"]
        if grew > r1["a_shards"] + REPLACE_SLACK:
            raise AssertionError(f"step (a): rank 1's peak grew {grew} B for "
                                 f"{r1['a_shards']} B of shards")
        log(
            f"[replacement] step (a) on rank 1 (meta placeholders): peak device "
            f"memory grew {grew} B for its {r1['a_shards']} B of attention shards "
            f"(gate: + {REPLACE_SLACK} B); the whole leaves are "
            f"{2 * r1['a_shards']} B"
        )
    log(f"[replacement] the {len(r0['moves'])} moves took {r0['seconds']:.3f} / "
        f"{r1['seconds']:.3f} s on rank 0 / 1, checksums included [{smi}]")
    before, got0, got1 = r0["logits_before"], r0["logits"], r1["logits"]
    if not got0 == got1 == before:
        raise AssertionError(f"step (e): logits {got0} / {got1}, before any move {before}")
    launches = r0["launches"] + r1["launches"]
    if on_card and (r0["launches"], r1["launches"]) != (2 * L, L):
        raise AssertionError(f"step (e): paged launches {r0['launches']} / "
                             f"{r1['launches']}, {L} a step")
    log(
        f"[replacement] step (e): one paged decode step (8 rows, 64-561 tokens) on "
        f"the re-placed {L}-layer {name} through the paged-decode kernel: logits "
        f"{list(got0[2])} bit-equal on both ranks and to rank 0's step before any "
        f"move; paged launches {r0['launches']} / {r1['launches']} [{smi}]"
    )
    return launches


def replication_rank(rank, world, port, reference, out_dir, results, device="cuda"):
    """One rank of phase 12, a spawned process: its gloo group on the
    card, tinyllama-1.1b's weights (rank 0's broadcast), the runs of the
    module docstring; puts (rank, measurements) on ``results``.
    ``device="cpu"`` rehearses the phase without a card."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import migration as MIG
    from repro_torch.core import replication as R
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.models import transformer as T
    from repro_torch.serving import instrument as INS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import RequestSpec, SamplingParams

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timeout = datetime.timedelta(seconds=180)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=rank == 0, timeout=timeout)
    group = R.ReplicationGroup.of(dist.ProcessGroupGloo(store, rank, world, timeout), device)
    cfg = get_config("tinyllama-1.1b")
    prompts, sampled = workload(cfg)
    c = types.SimpleNamespace(Engine=Engine, RS=RequestSpec, SP=SamplingParams, PD=PD,
                              INS=INS, R=R, MIG=MIG, T=T, cfg=cfg, group=group,
                              prompts=prompts, sampled=sampled, device=device)
    res = {"device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}
    # phase 5's weights on rank 0; rank 1 draws others, then takes rank 0's
    gen = torch.Generator(device=device).manual_seed(SEED + rank)
    params = T.init_params(cfg, gen, "bfloat16")
    INS.synchronize(device)
    t = time.perf_counter()
    with R.count_collectives(group) as n:
        R.replicate_params_for_plan(params, group)
    INS.synchronize(device)
    leaves = list(tree_leaves(params))
    res["broadcast"] = (time.perf_counter() - t, sum(n.values()),
                        sum(x.numel() * x.element_size() for x in leaves))
    res["weights_sha"] = tensor_sha(*leaves)
    # one collective of each of the hooks' shapes, alone: the full-batch
    # activations and one layer's K/V rows (bf16)
    coll = {}
    for shape in ((8, 1, cfg.d_model), (8, 1, cfg.num_kv_heads, 2 * cfg.resolved_head_dim)):
        buf = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        times = []
        for _ in range(21):
            t = time.perf_counter()
            group.all_reduce(buf)
            times.append((time.perf_counter() - t) * 1e3)
        coll[shape] = sorted(times)[10]
    res["collective_ms"] = coll
    L = cfg.num_layers
    contiguous = [2 if i <= 10 else 1 for i in range(L)]
    fragmented = [2 if i % 2 == 0 else 1 for i in range(L)]
    midstream = {3: [2] * L, 6: [1] * L}
    res["plans"] = {"contiguous": contiguous, "fragmented": fragmented,
                    "mid-stream": [2] * L}
    probe = {}

    def logit_probe(eng):
        tk, act, handle = paged_probe_inputs(eng)
        hook = R.layer_hook_from_degrees(eng._step_degrees, group)
        got, want = (
            T.forward_paged(eng.params, cfg, tk, handle, attn_impl="kernel",
                            layer_hook=h)[0][act, : cfg.vocab_size].float()
            for h in (hook, None))
        probe["finite"] = bool(torch.isfinite(got).all())
        probe["rel"] = ((got - want).norm() / want.norm()).item()

    runs, checks = {}, {"bf16 contiguous": {}, "fp32 fragmented": {}}
    runs["bf16 degree 1"] = repl_run(c, params, "bfloat16", {})
    runs["bf16 contiguous"] = repl_run(c, params, "bfloat16", {0: contiguous},
                                       probe=logit_probe, profile_dir=out_dir,
                                       check=checks["bf16 contiguous"])
    runs["bf16 fragmented"] = repl_run(c, params, "bfloat16", {0: fragmented})
    res["probe"] = probe
    res["checks"] = checks
    p32 = _tree_map(lambda x: x.float(), params)
    recs = {}
    for what, plans, at in (("degree 1", {}, None), ("contiguous", {0: contiguous}, None),
                            ("fragmented", {0: fragmented}, None),
                            ("mid-stream", midstream, 4)):
        recs[what] = Top2(T, cfg)
        runs[f"fp32 {what}"] = repl_run(c, p32, "float32", plans, rec=recs[what],
                                        migrate_at=at, check=checks.get(f"fp32 {what}"))
    one = runs["fp32 degree 1"]["streams"]
    res["flips"] = {
        what: repl_flips(c, one, recs["degree 1"].rec, runs[f"fp32 {what}"]["streams"],
                         recs[what].rec)
        for what in ("contiguous", "fragmented", "mid-stream")
    }
    del p32
    # the attention weights re-placed replicated from rank 0, rank 1's lost
    if rank:
        for x in params["layers"]["attn"].values():
            x.zero_()
    _, cost = MIG.migrate_by_path(params, r"layers/attn", (), group, measure=True)
    res["attn_move"] = (cost.bytes_moved, MIG.tree_bytes(params, r"layers/attn"),
                        cost.measured_seconds, tensor_sha(*tree_leaves(params)))
    res["runs"] = runs
    res["reference_ok"] = runs["bf16 degree 1"]["streams"] == reference
    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res["replacement"] = replacement_part(c, reduced=device.type != "cuda")
    group.all_reduce(torch.zeros(1, device=device))   # both ranks are done
    results.put((rank, res))


def replication_phase(TR, reference, out_dir, smi, device="cuda"):
    """Phase 12 (module docstring): spawns the two ranks, waits for both
    (a rank that fails fails the phase), gates and prints their runs.
    Returns the paged kernel's launches on both ranks: the tinyllama runs',
    then the re-placement part's (``replacement_gates``)."""
    import multiprocessing as mp
    import queue

    port = int(TR.free_tcp_endpoint().rsplit(":", 1)[1])
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=replication_rank,
                         args=(r, REPL_RANKS, port, reference, out_dir, results, device))
             for r in range(REPL_RANKS)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + 600
        while len(got) < REPL_RANKS:
            try:
                rank, res = results.get(timeout=5)
                got[rank] = res
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"phase 12: a rank failed (exit codes "
                                         f"{[p.exitcode for p in procs]})")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if [p.exitcode for p in procs] != [0] * REPL_RANKS:
        raise AssertionError(f"phase 12 exit codes {[p.exitcode for p in procs]}")
    r0, r1 = got[0], got[1]
    log(
        f"[replication] {REPL_RANKS} rank processes on one card ({r0['device']}) in a "
        f"gloo group: NCCL refuses two ranks on one device, and gloo stages each "
        f"collective through the host. Two ranks sharing one card measure the "
        f"program, not replication's speed; chip_multicard.py runs the ranks "
        f"across cards, one a card over NCCL [{smi}]"
    )
    secs, n_bc, nbytes = r0["broadcast"]
    if r0["weights_sha"] != r1["weights_sha"]:
        raise AssertionError("the ranks' weights differ after replicate_params_for_plan")
    log(
        f"[replication] replicate_params_for_plan: {n_bc} broadcasts, {nbytes} B of "
        f"bf16 weights from rank 0 in {secs:.3f} s; the ranks' weights bit-equal"
    )
    if not (r0["reference_ok"] and r1["reference_ok"]):
        raise AssertionError("a rank's degree-1 bf16 streams differ from phase 5's")
    L = len(r0["plans"]["contiguous"])
    predicted = {what: predicted_gathers(p) for what, p in r0["plans"].items()}
    launches = 0
    for what in r0["runs"]:
        a, b = r0["runs"][what], r1["runs"][what]
        if a["streams"] != b["streams"] or a["steps"] != b["steps"]:
            raise AssertionError(f"{what}: the ranks' tokens differ")
        if a["pool"] != b["pool"]:
            raise AssertionError(f"{what}: the ranks' pools differ")
        for r, run in ((0, a), (1, b)):
            if run["launches"] != L * run["decode_steps"]:
                raise AssertionError(f"{what} rank {r}: {run['launches']} paged launches "
                                     f"for {run['decode_steps']} decode steps")
            launches += run["launches"]
        plan = what.split()[-1]
        if plan in predicted and set(a["colls"] + b["colls"]) != {predicted[plan]}:
            raise AssertionError(f"{what}: collectives per replicated step "
                                 f"{sorted(set(a['colls']))}, predicted {predicted[plan]}")
        if what.endswith("degree 1") == bool(a["eager"]):
            raise AssertionError(f"{what}: {a['eager']} eager replicated steps")
        steady = "; ".join(
            f"{kind} steady step median ms, rank 0 / 1: "
            f"{sorted(x[0] for x in a[key])[len(a[key]) // 2]:.3f} / "
            f"{sorted(x[0] for x in b[key])[len(b[key]) // 2]:.3f} over {len(a[key])}"
            for kind, key in (("degree-1", "one"), ("replicated", "rep")) if a[key])
        log(
            f"[replication] {what}: {a['decode_steps']} decode steps ({a['eager']} "
            f"replicated, eager), paged launches {a['launches']} / {b['launches']} "
            f"(= {L} x steps per rank); {steady}; all-gathers per replicated decode "
            f"step {sorted(set(a['colls']))}, host syncs per steady step "
            f"{sorted({s for _, _, s, _ in a['one'] + a['rep']})}; tokens equal on both "
            f"ranks at every step, pools bit-equal [{smi}]"
        )
    if not predicted["contiguous"] < predicted["fragmented"]:
        raise AssertionError(f"continuity: {predicted}")
    log(
        f"[replication] continuity: 11 replicated layers make "
        f"{predicted['contiguous']} all-gathers a step as one run (layers 0-10) "
        f"against {predicted['fragmented']} fragmented (every other layer), each "
        f"step's count as the hooks predict"
    )
    for r, res in ((0, r0), (1, r1)):
        pr = res["probe"]
        if not pr["finite"] or pr["rel"] > 2e-2:
            raise AssertionError(f"rank {r}: bf16 replicated vs degree-1 logits {pr}")
        for what, flips in res["flips"].items():
            for rid, t, one, rep in flips:
                ok = (one and rep and set(one[1]) == set(rep[1])
                      and abs(one[0][0] - one[0][1]) <= 1e-4 * max(1.0, abs(one[0][0]))
                      and abs(rep[0][0] - rep[0][1]) <= 1e-4 * max(1.0, abs(rep[0][0])))
                if not ok:
                    raise AssertionError(f"rank {r} fp32 {what}: rid {rid} token {t} "
                                         f"flips, top-2 {one} against {rep}")
        prof = res["runs"]["bf16 contiguous"]["profile"]
        if prof is None or prof["split_kernels"] != L or prof["launches"] != L:
            raise AssertionError(f"rank {r}: profile of a replicated step {prof}")
    log(
        f"[replication] bf16 contiguous vs degree 1, one decode step's logits over "
        f"the real vocabulary: relative L2 {r0['probe']['rel']:.3e} / "
        f"{r1['probe']['rel']:.3e} (rank 0 / 1, tol 2e-2); fp32 greedy streams equal "
        f"degree 1's but for the flips {r0['flips']} (each a top-2 tie within 1e-4)"
    )
    for what, tol in (("bf16 contiguous", 2e-2), ("fp32 fragmented", 1e-4)):
        for r, res in ((0, r0), (1, r1)):
            errs = res["checks"][what].get("paged", [])
            if len(errs) != L or max(errs) > tol:
                raise AssertionError(f"rank {r} {what}: paged kernel calls of a "
                                     f"replicated step against their plain version: "
                                     f"{len(errs)} calls, relative L2 {errs} (tol {tol})")
        log(
            f"[replication] {what}: each of the {L} paged-kernel calls of one steady "
            f"replicated step (degree-2 layers at 4 of 8 rows a rank) against "
            f"paged_decode_attention_ref on the same inputs: worst relative L2 "
            f"{max(r0['checks'][what]['paged']):.3e} / "
            f"{max(r1['checks'][what]['paged']):.3e} (rank 0 / 1, tol {tol})"
        )
    prof = r0["runs"]["bf16 contiguous"]["profile"]
    log(
        f"[replication] profile of one replicated step (rank 0; rank 1 alike): "
        f"{prof['split_kernels']} paged split kernels, {prof['launches']} paged "
        f"launches, {prof['device_kernels']} device kernels"
    )
    moved, seconds = r0["runs"]["fp32 mid-stream"]["pool_move"]
    log(
        f"[replication] migrate_paged_pool at step 4 of the mid-stream run: rank 1's "
        f"zeroed pool re-placed from rank 0 in place, {moved} B in {seconds:.3f} s; "
        f"served on token-identical to degree 1"
    )
    a, b = r0["attn_move"], r1["attn_move"]
    if a[0] != a[1] or b[0] != b[1] or a[3] != b[3] or a[3] != r0["weights_sha"]:
        raise AssertionError(f"migrate_by_path: {a[:3]} / {b[:3]}")
    log(
        f"[replication] migrate_by_path(layers/attn, replicated): {a[0]} B "
        f"(= tree_bytes) in {a[2]:.3f} s; rank 1's zeroed attention weights back "
        f"to rank 0's, bit for bit"
    )
    replaced = replacement_gates(r0["replacement"], r1["replacement"],
                                 torch.device(device).type == "cuda", smi)
    log(
        f"[replication] one staged all-reduce alone (the hooks' all-gather), "
        f"median of 21, bf16, by shape: "
        f"{ {s: round(ms, 4) for s, ms in r0['collective_ms'].items()} } ms (rank 0) "
        f"[{smi}]"
    )
    return launches, replaced


# --------------------------------------- the sharded serving step (phase 13)
#: phase 13's ranks: two processes sharing the one card in gloo groups
SHARD_RANKS = 2
def rank_heads(cfg, m=2):
    """The head counts a rank of a model axis of ``m`` holds of ``cfg``'s
    attention and SSD heads (with the other widths the kernels read)."""
    return types.SimpleNamespace(
        num_heads=cfg.num_heads // m, num_kv_heads=cfg.num_kv_heads // m,
        resolved_head_dim=cfg.resolved_head_dim if cfg.num_heads else 0,
        ssm_heads=cfg.ssm_heads // m, ssm_head_dim=cfg.ssm_head_dim,
        ssm_state=cfg.ssm_state, ssm_ngroups=cfg.ssm_ngroups, ssm_chunk=cfg.ssm_chunk)
#: the long-context shape of the reference's long_500k serving step
#: (launch/dryrun.py: batch 1, window = sliding_window, a ring of that
#: many slots): a prompt that wraps the ring, then decode steps
LONG_PROMPT, LONG_STEPS = 8320, 16
#: 13a's greedy decode steps (cut from 32, 16, then 8, for the script's
#: time, PERF.md §4); 13d's decode steps and qwen2-moe depth (13h b's
#: too; cut from 6)
TP_STEPS, EP_STEPS, EP_LAYERS = 4, 16, 3
#: 13b's and 13i's tinyllama-1.1b depth (of 22; cut to 11, then 6, for
#: the script's time)
LONG13_LAYERS = 6
#: 13c's minicpm3-4b depth (of 62), to keep the script's time: cut from
#: 31, 16 and then 8 as phases 13, 15 and 16 lengthened the script
#: (PERF.md)
MLA13_LAYERS = 4
#: every stream's eager decode steps timed after its gated run (cut from
#: 8 for the script's time)
TIMED_STEPS = 4
#: 13e-g on (data 1, model 2): part -> (arch, depth on the card): mamba2
#: at phase 10's 6 of 48 layers (15e's too; cut from 12), zamba2 at
#: one block of 6 and a tail layer (7 of 81), whisper at 4 of 24 encoder
#: and 4 of 24 decoder layers
FAMILY13 = {"ssm": (SSM_ARCH, {"num_layers": 6}),
            "hybrid": (HYBRID_ARCH, {"num_layers": 7}),
            "audio": (AUDIO_ARCH, {"num_layers": 4, "num_encoder_layers": 4})}
FAMILY_STEPS = 16


def p13_settings(device):
    """Phase 13's sizes: the card's, or a CPU rehearsal's (reduced
    configs, short prompts)."""
    if torch.device(device).type == "cuda":
        return dict(reduced=False, cut=None, max_len=1024, tp_steps=TP_STEPS,
                    long_prompt=LONG_PROMPT, long_steps=LONG_STEPS,
                    mla_layers=MLA13_LAYERS, ep_layers=EP_LAYERS,
                    ep_steps=EP_STEPS, timed=TIMED_STEPS)
    return dict(reduced=True, cut=24, max_len=64, tp_steps=4, long_prompt=72,
                long_steps=3, mla_layers=2, ep_layers=2, ep_steps=3, timed=2)


def p13_config(get_config, arch, st, layers=None, experts=None, cut=None):
    """``arch`` at phase 13's size: reduced for a CPU rehearsal (where an
    expert-parallel part takes ``experts``, and a hybrid 3 layers so its
    tail runs), else at full width with ``layers`` or the config changes
    ``cut``."""
    cfg = get_config(arch)
    if st["reduced"]:
        cfg = cfg.reduced()
        if experts:   # the expert-parallel dispatch takes more than 8
            cfg = dataclasses.replace(cfg, num_experts=experts)
        if cfg.family == "hybrid":
            cfg = dataclasses.replace(cfg, num_layers=3)
        return cfg
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return dataclasses.replace(cfg, **(cut or {}))


def predicted_collectives(cfg, kind):
    """The collectives of one decode step of phase 13's parts, from the
    design (PERF.md §3, §6): a: the vocab-split embedding's psum,
    two row-parallel psums a layer (``wo``, ``w_down``), the logits'
    all-gather; b, c: flash-decoding's pmax and two psums a layer; d: two
    all-to-alls a MoE layer; e-g (``kind`` "ssm", "hybrid", "audio"): the
    embedding's psum and the logits' all-gather, two psums a Mamba2 layer
    (the gated norm's sum of squares, ``out_proj``), two a shared-block
    application, three an audio decoder layer (self and cross ``wo``,
    ``w_down``). ``kind`` "audio_prefill": a prefill of e-g's audio part,
    its encoder's two psums a layer besides."""
    L = cfg.num_layers
    if kind in ("ssm", "hybrid", "audio", "audio_prefill"):
        nb = L // cfg.hybrid_attn_every if kind == "hybrid" else 0
        if kind.startswith("audio"):
            n = 3 * L + (2 * cfg.num_encoder_layers if kind == "audio_prefill" else 0)
        else:
            n = 2 * L + 2 * nb
        return {"all-reduce": 1 + n, "all-gather": 1}
    return {"tp": {"all-reduce": 1 + 2 * L, "all-gather": 1},
            "long": {"all-reduce": 3 * L},
            "ep": {"all-to-all": 2 * L}}[kind]


def padded_prompts(prompts, device):
    """Right-padded [B, S] tokens, each row's length and last index."""
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    toks = np.zeros((len(prompts), int(lens.max())), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    return torch.from_numpy(toks).to(device), lens.to(device)


def decode_stream(T, INS, cfg, params, prompts, steps, cache, device, window=None,
                  forced=None, impl="kernel", dispatch="auto", mesh=None, hook=None,
                  timed=0, first=None, enc=None, row_cache=None, prefill_hook=None):
    """A prefill of right-padded ``prompts`` over ``cache`` (or, given
    ``first`` [B], the prefill's tokens: a cache prefilled already; or,
    given ``row_cache``, a function returning a fresh batch-1 cache, each
    prompt prefilled alone into one and put into its row of ``cache``, as
    the dense engine admits an SSM's prompts), then ``steps`` greedy
    decode steps (or steps fed ``forced`` [B, steps + 1], another stream's
    tokens; the ``timed`` steps then feed its last column, so both
    streams' caches hold the same tokens). ``impl`` picks both kernel
    routes (``attn_impl``, and the SSD scan's ``ssd_impl``); ``enc``: an
    audio config's frames. Returns dict:
    ``tokens`` [B, steps + 1] (each call's argmax over the real
    vocabulary), ``logits`` [calls, B, V] fp32 (the prefill's first where
    it ran), ``prefill_colls`` / ``colls`` (the mesh's collectives of each
    prefill call / decode step), ``ms`` (the ``timed`` eager decode steps
    run after, host clock with a sync each side) and ``coll_ms`` (the
    mesh's staged collectives inside each of them), ``dropped`` (the
    expert-parallel dispatch's drops each decode step). ``hook(t)`` /
    ``prefill_hook(i)`` return a context manager entered around decode
    step t / row i's prefill (its step is neither timed nor counted
    apart)."""
    V = cfg.vocab_size
    toks, lens = padded_prompts(prompts, device)
    routes = dict(attn_impl=impl, ssd_impl="kernel" if impl == "kernel" else "chunked")
    out = {"colls": [], "ms": [], "coll_ms": [], "dropped": [], "prefill_colls": []}

    def counted(fn, i):
        before = collections.Counter(mesh.collectives) if mesh else None
        with prefill_hook(i) if prefill_hook else contextlib.nullcontext():
            lg = fn()
        if mesh:
            out["prefill_colls"].append(dict(mesh.collectives - before))
        return lg

    if first is not None:
        logits, nxt = [], [first]
    else:
        if row_cache is None:
            lg = counted(lambda: T.forward(
                params, cfg, toks, cache=cache, mode="prefill", window=window,
                last_idx=(lens - 1).long(), dispatch=dispatch, encoder_input=enc,
                **routes)[0], 0)
        else:
            from repro_torch.serving import kvcache as KV

            rows = []
            for i, p in enumerate(prompts):
                one = row_cache()
                rows.append(counted(lambda: T.forward(
                    params, cfg, toks[i:i + 1, :len(p)], cache=one, mode="prefill",
                    window=window, **routes)[0], i))
                KV.insert_request(cache, i, one, len(p))
                del one
            lg = torch.cat(rows)
        logits, nxt = [lg[:, :V].float()], [lg[:, :V].argmax(-1)]

    def step(t, tok):
        pos = (lens + t)[:, None]
        return T.forward(params, cfg, tok[:, None], positions=pos, cache=cache,
                         mode="decode", window=window, dispatch=dispatch, **routes)[0]

    for t in range(steps):
        tok = forced[:, t] if forced is not None else nxt[-1]
        before = collections.Counter(mesh.collectives) if mesh else None
        d0 = mesh.moe_dropped if mesh else 0
        with hook(t) if hook else contextlib.nullcontext():
            lg = step(t, tok)
        if mesh:
            out["colls"].append(dict(mesh.collectives - before))
            out["dropped"].append(int(mesh.moe_dropped - d0))
        logits.append(lg[:, :V].float())
        nxt.append(lg[:, :V].argmax(-1))
    last = forced[:, -1] if forced is not None else nxt[-1]
    for t in range(steps, steps + timed):
        INS.synchronize(device)
        c0 = mesh.seconds["forward"] if mesh else 0.0
        t0 = time.perf_counter()
        step(t, last)
        INS.synchronize(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["coll_ms"].append(((mesh.seconds["forward"] if mesh else 0.0) - c0) * 1e3)
    out["tokens"] = torch.stack(nxt, 1)
    out["logits"] = torch.stack(logits)
    return out


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def draw_shard(T, SH, cfg, rules, mesh, dtype, keep_full):
    """The full weights drawn on this rank from phase 5's seeded generator
    (every rank draws the same tree), each leaf sliced to this rank's
    shard; the full tree is kept only where ``keep_full`` (the unsharded
    comparison), else freed."""
    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    full = T.init_params(cfg, gen, "bfloat16")
    shard = SH.shard_params(full, SH.param_specs(cfg, full, rules, mesh), mesh)
    if dtype == "float32":   # widening is exact, so shard and widen commute
        shard = widened(shard)
        full = widened(full) if keep_full else None
    return (full if keep_full else None), shard


@contextlib.contextmanager
def recorded(module, name, sink):
    """Inside, every call of ``module.name`` appends (args, result) to
    ``sink``, its tensor arguments copied (a cache the call reads is
    written again by later steps)."""
    fn = getattr(module, name)

    def rec(*args):
        out = fn(*args)
        sink.append((tuple(a.clone() if torch.is_tensor(a) else a for a in args), out))
        return out

    setattr(module, name, rec)
    try:
        yield sink
    finally:
        setattr(module, name, fn)


def check_partials(L, calls, mla):
    """Each recorded shard-local partial (m, l, o) of its S query rows
    against the plain attention over the same slice: o / l against
    ``attention`` (GQA) or the absorbed latent softmax (MLA), each row
    masked by its own position, and m the masked scores' max. Returns the
    worst relative L2 of o / l and the calls checked."""
    worst = 0.0
    for args, (m, l, o) in calls:
        if mla:
            ql, qr, c, kr, qpos, kpos, window, scale = args
            s = (torch.einsum("bshr,btr->bhst", ql.float(), c.float())
                 + torch.einsum("bshk,btk->bhst", qr.float(), kr.float())) * scale
            mask = L._attn_mask(qpos, kpos, None, window, True)
            s = torch.where(mask[:, None], s, L.NEG_INF)
            want = torch.einsum("bhst,btr->bhsr", torch.softmax(s, -1), c.float())
            got = o / l[..., None]
        else:
            q, k, v, qpos, kpos, window, softcap = args
            B, S, KV, R, D = q.shape
            want = L.attention(q.reshape(B, S, KV * R, D).float(), k.float(),
                               v.float(), q_positions=qpos, k_positions=kpos,
                               window=window, softcap=softcap)
            got = (o / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, KV * R, -1)
        if not bool(torch.isfinite(m).all()):
            raise AssertionError("a shard-local max is not finite")
        worst = max(worst, rel_l2(got, want))
    return worst, len(calls)


def extension_tokens(cfg, window, world, pos0, device):
    """13i's two multi-token decodes of batch 1 from position ``pos0`` on
    a ring of ``window`` slots split over ``world`` ranks: 4 tokens, then
    as many as carry the write across the next boundary of the ranks'
    slices (4 slots past it), seeded."""
    rng = np.random.default_rng(SEED + 27)
    part = window // world
    s0 = (pos0 + 4) % window
    n = part - s0 % part + 4
    return [torch.from_numpy(rng.integers(2, cfg.vocab_size, size=(1, k))).to(device)
            for k in (4, n)]


def extend(T, cfg, params, cache, exts, pos0, window, mesh=None, hook=None):
    """Each token block of ``exts`` [1, n] decoded (``forward`` in decode
    mode, S = n) over ``cache`` at the next positions from ``pos0``: the
    last row's logits over the real vocabulary (fp32), the mesh's
    collectives and host-clock ms of each call. ``hook(i)`` returns a
    context manager entered around block i's call."""
    out = {"logits": [], "colls": [], "ms": []}
    pos = pos0
    for i, e in enumerate(exts):
        n = e.shape[1]
        positions = (pos + torch.arange(n, dtype=torch.int32, device=e.device))[None]
        before = collections.Counter(mesh.collectives) if mesh else None
        sync(e.device)
        t0 = time.perf_counter()
        with hook(i) if hook else contextlib.nullcontext():
            lg = T.forward(params, cfg, e, positions=positions, cache=cache,
                           mode="decode", window=window)[0]
        sync(e.device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if mesh:
            out["colls"].append(dict(mesh.collectives - before))
        out["logits"].append(lg[:, : cfg.vocab_size].float())
        pos += n
    return out


def sharded_rank(rank, world, port, results, device="cuda"):
    """One rank of phase 13, a spawned process: its meshes on the card
    (gloo groups over a ``TCPStore``) and the four parts of the module
    docstring; puts (rank, measurements) on ``results``. ``device="cpu"``
    rehearses the phase without a card (reduced configs)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.parallel import distributed_attention as DATT
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.mesh import RankMesh
    from repro_torch.serving import instrument as INS

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = p13_settings(device)
    timeout = datetime.timedelta(seconds=300)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=rank == 0, timeout=timeout)
    res = {"device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}
    t_phase = time.perf_counter()

    def mesh_of(tag, shape):
        return RankMesh.build(dist.PrefixStore(tag, store), ("data", "model"), shape,
                              rank, device, timeout)

    # gloo on CUDA tensors: MAX, and its own all-to-all (the mesh's
    # all-to-all is an all-reduce; this probe is for the record)
    probe = mesh_of("probe", (world, 1))
    pg = probe.groups["data"]
    x = torch.full((4,), float(rank), device=device)
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.MAX
    pg.allreduce([x], opts).wait()
    res["gloo_max"] = x.tolist()
    try:
        src = torch.arange(world, dtype=torch.float32, device=device) + 10 * rank
        dst = torch.empty_like(src)
        pg.alltoall_base(dst, src, [], [], dist.AllToAllOptions()).wait()
        res["gloo_alltoall"] = dst.tolist()
    except RuntimeError as e:   # recorded, not used: the mesh all-reduces
        res["gloo_alltoall"] = f"raises: {str(e).splitlines()[0][:200]}"

    # 13a: tensor parallel, tinyllama-1.1b at (data 1, model 2)
    cfg = p13_config(get_config, "tinyllama-1.1b", st)
    prompts, _ = workload(cfg)
    if st["cut"]:
        prompts = [p[: st["cut"]] for p in prompts]
    mesh = mesh_of("13a", (1, world))
    rules = dict(SH.rules_for(cfg, mesh), mesh=mesh)
    tp = {"rules": {k: v for k, v in rules.items() if k != "mesh"},
          "predicted": predicted_collectives(cfg, "tp")}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        full, shard = draw_shard(T, SH, cfg, rules, mesh, dtype, rank == 0)
        cache = T.init_cache_shard(cfg, len(prompts), st["max_len"], rules, mesh, dtype,
                                   device)
        checks = {}

        def hook(t):
            return checked_kernel_calls(checks) if t == 3 else contextlib.nullcontext()

        DA.decode_attention.launches = 0
        with SH.use_rules(rules):
            got = decode_stream(T, INS, cfg, shard, prompts, st["tp_steps"], cache, device,
                                mesh=mesh, hook=hook, timed=st["timed"])
        r = {"launches": DA.decode_attention.launches, "tokens": got["tokens"].tolist(),
             "colls": got["colls"], "ms": got["ms"], "checks": checks.get("decode", []),
             "local_wq": tuple(shard["layers"]["attn"]["wq"].shape),
             "local_cache": tuple(cache["layers"]["k"].shape)}
        if rank == 0:
            ucache = T.init_cache(cfg, len(prompts), st["max_len"], dtype, device)
            want = decode_stream(T, INS, cfg, full, prompts, st["tp_steps"], ucache,
                                 device, forced=got["tokens"], timed=st["timed"])
            r["unsharded_ms"] = want["ms"]
            r["tokens_equal"] = bool((want["tokens"] == got["tokens"]).all())
            r["first_flip"] = next((t for t in range(want["tokens"].shape[1])
                                    if not bool((want["tokens"][:, t]
                                                 == got["tokens"][:, t]).all())), None)
            r["rel_last"] = rel_l2(got["logits"][-1], want["logits"][-1])
            r["rel_max"] = max(rel_l2(a, b) for a, b in zip(got["logits"], want["logits"]))
            del ucache, want
        r["seconds"] = time.perf_counter() - t0
        tp[dtype] = r
        del full, shard, cache, got
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    res["tp"] = tp

    # 13b / 13c: distributed flash-decoding, (data 2, model 1), batch 1;
    # 13i: then the multi-token decodes over the same split caches
    for part, arch, layers, fn, mla in (
            ("long", "tinyllama-1.1b", LONG13_LAYERS, "_local_partial", False),
            ("mla", "minicpm3-4b", st["mla_layers"], "_mla_local_partial", True)):
        cfg = p13_config(get_config, arch, st, layers=layers)
        window = cfg.sliding_window
        prompt = np.random.default_rng(SEED + 13).integers(
            2, cfg.vocab_size, size=st["long_prompt"]).astype(np.int32)
        mesh = mesh_of(f"13{part}", (world, 1))
        rules = dict(SH.long_context_rules(cfg, mesh), flash_decode=True, mesh=mesh)
        pos0 = st["long_prompt"] + st["long_steps"] + st["timed"]
        exts = extension_tokens(cfg, window, world, pos0, device)
        out = {"rules": {k: v for k, v in rules.items() if k != "mesh"},
               "predicted": predicted_collectives(cfg, "long"), "layers": cfg.num_layers,
               "ext_lens": [e.shape[1] for e in exts], "ext_pos": pos0}
        tokens32 = truth = None
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            full, shard = draw_shard(T, SH, cfg, rules, mesh, dtype, rank == 0)
            cache = T.init_cache_shard(cfg, 1, window, rules, mesh, dtype, device)
            calls = []

            def hook(t, calls=calls):
                return (recorded(DATT, fn, calls) if t == 2 and dtype == "float32"
                        else contextlib.nullcontext())

            with SH.use_rules(rules):
                got = decode_stream(T, INS, cfg, shard, [prompt], st["long_steps"], cache,
                                    device, window=window, mesh=mesh, hook=hook,
                                    timed=st["timed"], forced=tokens32)
            r = {"tokens": got["tokens"].tolist(), "colls": got["colls"], "ms": got["ms"],
                 "local_cache": tuple(next(iter(cache["layers"].values())).shape)}
            if calls:
                r["partials"] = check_partials(L, calls, mla)
            del calls[:]
            # 13i: a 4-token decode, then an extension whose slots cross from
            # rank 0's half of the ring into rank 1's (its partials checked)
            def ext_hook(i, calls=calls, dtype=dtype):
                return (recorded(DATT, fn, calls) if i == 1 and dtype == "float32"
                        else contextlib.nullcontext())

            with SH.use_rules(rules):
                ext = extend(T, cfg, shard, cache, exts, pos0, window, mesh=mesh,
                             hook=ext_hook)
            r.update(ext_colls=ext["colls"], ext_ms=ext["ms"])
            if calls:
                r["ext_partials"] = check_partials(L, calls, mla)
            del calls[:]
            if rank == 0:
                ucache = T.init_cache(cfg, 1, window, dtype, device)
                want = decode_stream(T, INS, cfg, full, [prompt], st["long_steps"], ucache,
                                     device, window=window,
                                     forced=got["tokens"] if tokens32 is None else tokens32,
                                     timed=st["timed"])
                r["unsharded_ms"] = want["ms"]
                r["tokens_equal"] = bool((want["tokens"] == got["tokens"]).all())
                r["rel"] = [rel_l2(a, b) for a, b in zip(got["logits"], want["logits"])]
                uext = extend(T, cfg, full, ucache, exts, pos0, window)
                r["ext_unsharded_ms"] = uext["ms"]
                r["ext_rel"] = [rel_l2(a, b) for a, b in zip(ext["logits"], uext["logits"])]
                r["ext_tokens_equal"] = [bool((a.argmax(-1) == b.argmax(-1)).all())
                                         for a, b in zip(ext["logits"], uext["logits"])]
                r["ext_finite"] = all(bool(torch.isfinite(a).all()) for a in ext["logits"])
                if dtype == "float32":
                    truth = uext["logits"]
                else:   # tests/_bf16_gap.py's rule, against the fp32 unsharded logits
                    r["ext_gap"] = [(rel_l2(a, w), rel_l2(b, w)) for a, b, w in
                                    zip(ext["logits"], uext["logits"], truth)]
                del ucache, want, uext
            if dtype == "float32":
                tokens32 = got["tokens"]
            r["seconds"] = time.perf_counter() - t0
            out[dtype] = r
            del full, shard, cache, got, ext
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        res[part] = out

    # 13d: expert parallel, qwen2-moe-a2.7b at (data 2, model 1)
    cfg = p13_config(get_config, "qwen2-moe-a2.7b", st, layers=st["ep_layers"],
                     experts=12)
    prompts, _ = workload(cfg)
    if st["cut"]:
        prompts = [p[: st["cut"]] for p in prompts]
    B = len(prompts)
    mesh = mesh_of("13d", (world, 1))
    rules = dict(SH.rules_for(cfg, mesh), moe_a2a=True, mesh=mesh)
    b = B // world
    mine = slice(rank * b, (rank + 1) * b)
    ep = {"rules": {k: v for k, v in rules.items() if k != "mesh"},
          "predicted": predicted_collectives(cfg, "ep"), "layers": cfg.num_layers}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        full, shard = draw_shard(T, SH, cfg, rules, mesh, dtype, rank == 0)
        r = {"local_experts": shard["layers"]["moe"]["w_gate"].shape[1]}
        # one prefill through the unsharded forward on rank 0; each rank
        # takes its rows of that cache (an all-reduce with rank 0 the only
        # writer) and decodes them expert-parallel
        ucache = T.init_cache(cfg, B, st["max_len"], dtype, device)
        toks, lens = padded_prompts(prompts, device)
        first = torch.zeros((B,), dtype=torch.int64, device=device)
        if rank == 0:
            lg = T.forward(full, cfg, toks, cache=ucache, mode="prefill",
                           last_idx=(lens - 1).long(), attn_impl="kernel",
                           dispatch="dense")[0]
            first = lg[:, : cfg.vocab_size].argmax(-1)
        handed = {k: mesh.psum(t, "data") for k, t in
                  (("k", ucache["layers"]["k"]), ("v", ucache["layers"]["v"]),
                   ("positions", ucache["positions"]), ("length", ucache["length"]),
                   ("first", first))}
        cache = {"layers": {"k": handed["k"][:, mine].contiguous(),
                            "v": handed["v"][:, mine].contiguous()},
                 "positions": handed["positions"][mine].contiguous(),
                 "length": handed["length"][mine].contiguous()}
        first = handed["first"]
        del handed
        routes = []

        def hook(t, routes=routes):   # every gated decode step's experts
            return recorded(MOE, "route", routes)

        DA.decode_attention.launches = 0
        with SH.use_rules(rules):
            got = decode_stream(T, INS, cfg, shard, prompts[mine], st["ep_steps"], cache,
                                device, mesh=mesh, hook=hook, timed=st["timed"],
                                first=first[mine])
        r["launches"] = DA.decode_attention.launches
        r.update(colls=got["colls"], dropped=got["dropped"], ms=got["ms"])
        # every rank's tokens, logits and experts on rank 0, for the
        # comparison (results cross processes as plain Python values)
        all_logits = mesh.all_gather(got["logits"], "data", 1)
        all_tokens = mesh.all_gather(got["tokens"], "data", 0)
        n_sh = len(routes)   # [steps * layers, b, 1, k], then every row's
        all_routes = mesh.all_gather(torch.stack([o[1] for _, o in routes]), "data", 1)
        if rank == 0:
            want = decode_stream(T, INS, cfg, full, prompts, st["ep_steps"], ucache, device,
                                 dispatch="dense", hook=hook, timed=st["timed"],
                                 first=first)
            uroutes = torch.stack([o[1] for _, o in routes[n_sh:]])
            r["unsharded_ms"] = want["ms"]
            r["tokens_equal"] = bool((want["tokens"] == all_tokens).all())
            # decode step t's logits are comparable while the tokens fed
            # up to it agree (the two streams run free) and, row by row,
            # while its top-k experts agree in every layer of every step
            # so far (a flip changes the K/V a row writes)
            agree = (want["tokens"] == all_tokens).all(0).tolist() + [False]
            r["comparable"] = min(agree.index(False), len(want["logits"]))
            same = (all_routes.sort(-1).values == uroutes.sort(-1).values).all(-1)
            same = same.reshape(st["ep_steps"], -1, B).all(1).int().cumprod(0).bool()
            r["flipped_rows"] = {i: int((~same[:, i]).nonzero()[0])
                                 for i in range(B) if not bool(same[-1, i])}
            r["rel"] = [rel_l2(a[k], w[k]) for a, w, k in
                        zip(all_logits, want["logits"], same[: r["comparable"]])
                        if bool(k.any())]
            r["rel_first"] = r["rel"][0] if r["rel"] else None
            del want
        del ucache, cache
        # the expert-parallel prefill on its own: this rank's rows, fresh
        pcache = T.init_cache_shard(cfg, B, st["max_len"], rules, mesh, dtype, device)
        d0 = mesh.moe_dropped
        with SH.use_rules(rules):
            T.forward(shard, cfg, toks[mine], cache=pcache, mode="prefill",
                      last_idx=(lens[mine] - 1).long(), attn_impl="kernel")
        r["prefill_dropped"] = int(mesh.moe_dropped - d0)
        r["seconds"] = time.perf_counter() - t0
        ep[dtype] = r
        del full, shard, pcache, got, all_logits
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    res["ep"] = ep

    # 13e-g: the ssm, hybrid and audio families, (data 1, model 2)
    for part in FAMILY13:
        res[part] = family_part(T, SH, DA, INS, get_config, st, mesh_of(f"13{part}", (1, world)),
                                rank, part, device)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # 13h: the paged decode step under sharding rules
    from repro_torch.kernels import paged_decode as PD
    for part, (_, shape_of, _) in PAGED13.items():
        res[f"paged_{part}"] = paged_part(T, SH, PD, MOE, INS, get_config, st,
                                          mesh_of(f"13h{part}", shape_of(world)), rank,
                                          part, device)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    res["phase_seconds"] = time.perf_counter() - t_phase
    results.put((rank, res))


def family_part(T, SH, DA, INS, get_config, st, mesh, rank, part, device):
    """13e-g on this rank: ``FAMILY13[part]``'s config at full width and
    cut depth (reduced on the CPU) on ``mesh`` under ``rules_for``, phase
    10's 8 prompts (whisper's cut to 416 tokens, over frames drawn on the
    device from a seeded generator, the same on every rank), each SSM or
    hybrid prompt prefilled alone into its row of the cache shard (as the
    dense engine admits them), a batch prefill of right-padded prompts for
    whisper; then ``FAMILY_STEPS`` greedy decode steps, in fp32 and then
    in bf16 fed the fp32 stream's tokens. Every SSD call of the first
    prompt's prefill and every dense-decode call of decode step 3 (the
    last of a CPU rehearsal's 3) is held
    against its plain version. Rank 0 runs the unsharded ``forward`` on
    the same weights fed the same tokens, in both types."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.training.optimizer import tree_items

    arch, cut = FAMILY13[part]
    cfg = p13_config(get_config, arch, st, cut=cut)
    prompts, _ = workload(cfg)
    audio = cfg.family == "audio"
    if audio:
        prompts = [p[:WHISPER_PROMPT] for p in prompts]
    if st["cut"]:
        prompts = [p[: st["cut"]] for p in prompts]
    B = len(prompts)
    max_len = WHISPER_MAX_LEN if audio and not st["reduced"] else st["max_len"]
    enc = None
    if audio:
        gen = torch.Generator(device=device).manual_seed(SEED + 13)
        enc = torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=gen,
                          device=device)
    rules = dict(SH.rules_for(cfg, mesh), mesh=mesh)
    steps, timed = (FAMILY_STEPS, st["timed"]) if not st["reduced"] else (3, 2)
    out = {"rules": {k: v for k, v in rules.items() if k != "mesh"},
           "predicted": predicted_collectives(cfg, part),
           "predicted_prefill": predicted_collectives(
               cfg, "audio_prefill" if audio else part),
           "layers": cfg.num_layers, "enc_layers": cfg.num_encoder_layers,
           "prefills": 1 if audio else B, "steps": steps, "timed": timed,
           # Mamba2 layers (an SSD call each a prefill) and dense-decode
           # calls a decode step (the shared block's; self and cross)
           "mamba": 0 if audio else cfg.num_layers,
           "attn": (cfg.num_layers // cfg.hybrid_attn_every if cfg.family == "hybrid"
                    else 2 * cfg.num_layers if audio else 0)}
    tokens32 = truth = None
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        full, shard = draw_shard(T, SH, cfg, rules, mesh, dtype, rank == 0)
        cache = T.init_cache_shard(cfg, B, max_len, rules, mesh, dtype, device)
        row_cache = None if audio else functools.partial(
            T.init_cache_shard, cfg, 1, max_len, rules, mesh, dtype, device)
        checks, pchecks = {}, {}

        def hook(t, checks=checks):
            return (checked_kernel_calls(checks) if t == min(3, steps - 1)
                    else contextlib.nullcontext())

        def prefill_hook(i, pchecks=pchecks):
            return checked_kernel_calls(pchecks) if i == 0 else contextlib.nullcontext()

        DA.decode_attention.launches = SS.ssd_scan.launches = 0
        with SH.use_rules(rules):
            got = decode_stream(T, INS, cfg, shard, prompts, steps, cache, device, mesh=mesh,
                                hook=hook, timed=timed, enc=enc, row_cache=row_cache,
                                prefill_hook=prefill_hook, forced=tokens32)
        r = {"decode_launches": DA.decode_attention.launches,
             "ssd_launches": SS.ssd_scan.launches, "tokens": got["tokens"].tolist(),
             "colls": got["colls"], "prefill_colls": got["prefill_colls"], "ms": got["ms"],
             "coll_ms": got["coll_ms"],
             "checks": checks.get("decode", []), "ssd_checks": pchecks.get("ssd", []),
             "local": {"/".join(k): tuple(v.shape) for k, v in tree_items(shard)
                       if k[-1] in ("w_x", "w_dt", "out_proj", "wq")},
             "local_cache": {"/".join(k): tuple(v.shape) for k, v in tree_items(cache)
                             if k[-1] in ("ssd", "conv_x", "conv_B", "k")}}
        del cache
        if rank == 0:
            ucache = T.init_cache(cfg, B, max_len, dtype, device)
            urow = None if audio else functools.partial(T.init_cache, cfg, 1, max_len, dtype,
                                                        device)
            want = decode_stream(T, INS, cfg, full, prompts, steps, ucache, device,
                                 forced=tokens32 if tokens32 is not None else got["tokens"],
                                 timed=timed, enc=enc, row_cache=urow)
            r["unsharded_ms"] = want["ms"]
            r["tokens_equal"] = bool((want["tokens"] == got["tokens"]).all())
            r["rel"] = [rel_l2(a, b) for a, b in zip(got["logits"], want["logits"])]
            if dtype == "float32":
                truth = want["logits"]
            else:   # tests/_bf16_gap.py's rule: against the fp32 unsharded logits
                r["gap"] = [(rel_l2(a, w), rel_l2(b, w)) for a, b, w in
                            zip(got["logits"], want["logits"], truth)]
            r["finite"] = bool(torch.isfinite(got["logits"]).all())
            del ucache, want
        if dtype == "float32":
            tokens32 = got["tokens"]
        r["seconds"] = time.perf_counter() - t0
        out[dtype] = r
        del full, shard, got
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out



#: 13h's paged decode steps, and its parts: (arch, mesh shape, the
#: rules' extras, the design's collectives of a step)
PAGED_STEPS = 16
PAGED13 = {"tp": ("tinyllama-1.1b", lambda w: (1, w), {}),
           "ep": (MOE_ARCH, lambda w: (w, 1), {"moe_a2a": True})}


def paged_rows(cache, rows, kv, pst, slots, lens, steps):
    """``slots`` of the paged state ``pst``, each taking one prompt's
    prefill K/V: row ``rows[i]`` of the dense ``cache`` [L, B, S, KV, hd]
    at the KV heads ``kv``, ``lens[i]`` tokens, with blocks for ``steps``
    more allocated."""
    from repro_torch.serving import paged_kv as PK

    for i, n in zip(slots, lens):
        PK.allocate(pst, i, n + steps)
    k = cache["layers"]["k"][:, rows][..., kv, :]
    v = cache["layers"]["v"][:, rows][..., kv, :]
    PK.write_tokens_batch(pst, slots, k, v, lengths=lens)


def row_blocks(pst, slots, n_cols):
    """The pool's blocks of each of ``slots``' first ``n_cols[i]`` table
    columns, in row order: (K, V) [L, blocks, KV, bs, hd]."""
    ids = np.concatenate([pst.block_tables[i, :n] for i, n in zip(slots, n_cols)])
    idx = torch.from_numpy(ids.astype(np.int64)).to(pst.k.device)
    return pst.k.index_select(1, idx), pst.v.index_select(1, idx)


def paged_part(T, SH, PD, MOE, INS, get_config, st, mesh, rank, part, device):
    """13h on this rank: the paged decode step under sharding rules
    (``forward_paged``). ``PAGED13[part]``'s config at full width (13d's
    depth for qwen2-moe) on ``mesh`` under ``rules_for`` (with
    ``moe_a2a`` for the MoE part), phase 5's 8 prompts prefilled by rank
    0's unsharded ``forward`` and handed to every rank (an all-reduce
    with rank 0 the only writer); each rank keeps its rows and its KV
    heads of that cache in its own pool (``init_paged_shard``, its own
    allocator), then ``PAGED_STEPS`` greedy paged decode steps through the
    paged-decode kernel at its heads, fp32 and then bf16 fed the fp32
    tokens. Rank 0 runs the unsharded ``forward_paged`` on the whole pool
    and the same weights, fed the same tokens (an MoE part with
    ``dispatch="dense"``, exact where nothing drops); every rank's pool
    after the steps is held against its slice of rank 0's."""
    from repro_torch.serving import paged_kv as PK
    from repro_torch.training.optimizer import tree_items

    arch, shape_of, extra = PAGED13[part]
    moe = part == "ep"
    cfg = p13_config(get_config, arch, st, layers=st["ep_layers"] if moe else None,
                     experts=12 if moe else None)
    prompts, _ = workload(cfg)
    if st["cut"]:
        prompts = [p[: st["cut"]] for p in prompts]
    B, V, bs = len(prompts), cfg.vocab_size, 16
    steps = PAGED_STEPS if not st["reduced"] else 3
    rules = dict(SH.rules_for(cfg, mesh), mesh=mesh, **extra)
    bat = rules["batch"]
    nb = mesh.axes_size(bat)
    b = B // nb
    mine = list(range(mesh.axes_index(bat) * b, (mesh.axes_index(bat) + 1) * b))
    n_kv = cfg.num_kv_heads // mesh.axes_size(rules["kv_heads"])
    kv = slice(mesh.axes_index(rules["kv_heads"]) * n_kv,
               (mesh.axes_index(rules["kv_heads"]) + 1) * n_kv)
    lens = [len(p) for p in prompts]
    cols = [-(-(n + steps) // bs) for n in lens]
    axis = "model" if mesh.axis_size("model") > 1 else "data"
    out = {"rules": {k: v for k, v in rules.items() if k != "mesh"},
           "predicted": predicted_collectives(cfg, part), "layers": cfg.num_layers,
           "steps": steps, "rows": len(mine), "kv_heads": n_kv}
    tokens32 = truth = None
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        full, shard = draw_shard(T, SH, cfg, rules, mesh, dtype, rank == 0)
        toks, lens_t = padded_prompts(prompts, device)
        ucache = T.init_cache(cfg, B, toks.shape[1], dtype, device)
        first = torch.zeros((B,), dtype=torch.int64, device=device)
        if rank == 0:
            lg = T.forward(full, cfg, toks, cache=ucache, mode="prefill",
                           last_idx=(lens_t - 1).long(), attn_impl="kernel",
                           dispatch="dense")[0]
            first = lg[:, :V].argmax(-1)
        handed = {"k": mesh.psum(ucache["layers"]["k"], axis),
                  "v": mesh.psum(ucache["layers"]["v"], axis),
                  "first": mesh.psum(first, axis)}
        del ucache
        pst = PK.init_paged_shard(cfg, B, sum(cols[g] for g in mine) + 2, rules, mesh,
                                  block_size=bs, dtype=dtype, max_len=1024, device=device)
        slots = list(range(len(mine)))
        paged_rows({"layers": handed}, mine, kv, pst, slots, [lens[g] for g in mine], steps)

        def handle(ps, n):
            return {"k": ps.k, "v": ps.v,
                    "block_tables": T.to_device(ps.block_tables, device),
                    "lengths": T.to_device(ps.lengths, device),
                    "active": torch.ones((n,), dtype=torch.bool, device=device)}

        def run(params, h, first_tok, feed, routes, sharded):
            """The decode steps from ``first_tok`` (or fed ``feed``): logits
            [steps, rows, V], tokens, and per step the collectives, paged
            launches and host-clock ms (the checked step's left out)."""
            res = {"logits": [], "tok": [first_tok], "colls": [], "launches": [],
                   "ms": [], "checks": {}}
            for t in range(steps):
                tok = feed[:, t] if feed is not None else res["tok"][-1]
                before = collections.Counter(mesh.collectives)
                l0 = PD.paged_decode_attention.launches
                check = sharded and t == min(3, steps - 1)
                with (SH.use_rules(rules) if sharded else contextlib.nullcontext()), \
                        (checked_kernel_calls(res["checks"]) if check
                         else contextlib.nullcontext()), \
                        (recorded(MOE, "route", routes) if moe else contextlib.nullcontext()):
                    sync(device)
                    t1 = time.perf_counter()
                    lg, h, _ = T.forward_paged(params, cfg, tok[:, None], h,
                                               attn_impl="kernel",
                                               dispatch="auto" if sharded else "dense")
                    sync(device)
                    if not check:
                        res["ms"].append((time.perf_counter() - t1) * 1e3)
                res["colls"].append(dict(mesh.collectives - before))
                res["launches"].append(PD.paged_decode_attention.launches - l0)
                res["logits"].append(lg[:, :V].float())
                res["tok"].append(lg[:, :V].argmax(-1))
            return res

        feed = None if tokens32 is None else tokens32[mine]
        routes = []
        got = run(shard, handle(pst, len(mine)), handed["first"][mine], feed, routes, True)
        r = {"colls": got["colls"], "launches": got["launches"], "ms": got["ms"],
             "checks": got["checks"].get("paged", []),
             "local_wq": tuple(shard["layers"]["attn"]["wq"].shape),
             "local_pool": tuple(pst.k.shape)}
        logits = torch.stack(got["logits"])                   # [steps, rows, V]
        tokens = torch.stack(got["tok"], 1)                   # [rows, steps + 1]
        if nb > 1:   # every rank's rows on every rank
            logits = mesh.all_gather(logits, bat, 1)
            tokens = mesh.all_gather(tokens, bat, 0)
        r["tokens"] = tokens.tolist()
        n_sh = len(routes)
        if moe:
            all_routes = torch.stack([o[1] for _, o in routes])   # [steps*L, rows, 1, k]
            all_routes = mesh.all_gather(all_routes, bat, 1) if nb > 1 else all_routes
        # the reference's blocks of every row after the steps, to every rank
        ref_k = torch.zeros((cfg.num_layers, sum(cols), cfg.num_kv_heads, bs,
                             cfg.resolved_head_dim), dtype=pst.k.dtype, device=device)
        ref_v = torch.zeros_like(ref_k)
        if rank == 0:
            ust = PK.init_paged(cfg, B, sum(cols) + 2, block_size=bs, dtype=dtype,
                                max_len=1024, device=device)
            paged_rows({"layers": handed}, list(range(B)), slice(None), ust,
                       list(range(B)), lens, steps)
            want = run(full, handle(ust, B), handed["first"],
                       tokens32 if tokens32 is not None else tokens, routes, False)
            wlog = torch.stack(want["logits"])
            r["unsharded_ms"] = want["ms"]
            r["tokens_equal"] = bool((torch.stack(want["tok"], 1) == tokens).all())
            same = torch.ones((steps, B), dtype=torch.bool, device=device)
            if moe:   # rows whose top-k experts agree in every layer so far
                uroutes = torch.stack([o[1] for _, o in routes[n_sh:]])
                agree = (all_routes.sort(-1).values == uroutes.sort(-1).values).all(-1)
                same = agree.reshape(steps, -1, B).all(1).int().cumprod(0).bool()
            r["flipped_rows"] = {i: int((~same[:, i]).nonzero()[0]) for i in range(B)
                                 if not bool(same[-1, i])}
            r["rel"] = [rel_l2(a[k], w[k]) for a, w, k in zip(logits, wlog, same)
                        if bool(k.any())]
            r["finite"] = bool(torch.isfinite(logits).all())
            if dtype == "float32":
                truth = wlog
            else:   # tests/_bf16_gap.py's rule, over the rows not flipped
                r["gap"] = [(rel_l2(a[k], w[k]), rel_l2(u[k], w[k])) for a, u, w, k in
                            zip(logits, wlog, truth, same) if bool(k.any())]
            ref_k, ref_v = row_blocks(ust, list(range(B)), cols)
            del ust, want
        ref_k, ref_v = mesh.psum(ref_k, axis), mesh.psum(ref_v, axis)
        at = sum(cols[g] for g in range(mine[0]))
        n_mine = sum(cols[g] for g in mine)
        got_k, got_v = row_blocks(pst, slots, [cols[g] for g in mine])
        r["pool_rel"] = max(rel_l2(got_k, ref_k[:, at:at + n_mine, kv]),
                            rel_l2(got_v, ref_v[:, at:at + n_mine, kv]))
        r["pool_equal"] = bool(torch.equal(got_k, ref_k[:, at:at + n_mine, kv])
                               and torch.equal(got_v, ref_v[:, at:at + n_mine, kv]))
        if dtype == "float32":
            tokens32 = tokens
        r["local"] = {"/".join(k): tuple(v.shape) for k, v in tree_items(shard)
                      if k[-1] in ("wq", "wk", "w_gate")}
        r["seconds"] = time.perf_counter() - t0
        out[dtype] = r
        del full, shard, pst, got, logits, handed, ref_k, ref_v, got_k, got_v
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def sharded_phase(TR, smi, device="cuda"):
    """Phase 13 (module docstring): spawns the two ranks, waits for both
    (a rank that fails fails the phase), gates and prints their parts.
    Returns the dense-decode kernel's launches on both ranks' main paths
    by part ({"tp": n, "ep": n})."""
    import multiprocessing as mp
    import queue

    port = int(TR.free_tcp_endpoint().rsplit(":", 1)[1])
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, SHARD_RANKS, port, results, device))
             for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + 900
        while len(got) < SHARD_RANKS:
            try:
                rank, res = results.get(timeout=5)
                got[rank] = res
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"phase 13: a rank failed (exit codes "
                                         f"{[p.exitcode for p in procs]})")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if [p.exitcode for p in procs] != [0] * SHARD_RANKS:
        raise AssertionError(f"phase 13 exit codes {[p.exitcode for p in procs]}")
    r0, r1 = got[0], got[1]
    st = p13_settings(device)
    log(
        f"[sharded] {SHARD_RANKS} rank processes on one card ({r0['device']}) in gloo "
        f"groups, one per mesh axis line: two ranks sharing one card measure the "
        f"program (its collectives staged through the host), not the gain of "
        f"sharding [{smi}]"
    )
    log(
        f"[sharded] gloo on CUDA tensors: all-reduce MAX gave {r0['gloo_max']} (rank 0) "
        f"/ {r1['gloo_max']}; gloo's own all-to-all: {r0['gloo_alltoall']} (rank 0) "
        f"(the mesh's all-to-all is an exact all-reduce either way)"
    )
    if r0["gloo_max"] != [float(SHARD_RANKS - 1)] * 4:
        raise AssertionError(f"gloo MAX on CUDA tensors: {r0['gloo_max']}")
    launches = {}

    def same_tokens(part, what):
        a, b = r0[part][what]["tokens"], r1[part][what]["tokens"]
        if a != b:
            raise AssertionError(f"{part} {what}: the ranks' tokens differ")

    def colls_ok(part, what, res):
        want = res[part]["predicted"]
        seen = res[part][what]["colls"]
        if any(c != want for c in seen):
            raise AssertionError(f"{part} {what}: collectives per decode step "
                                 f"{seen[:3]}..., predicted {want}")

    on_card = torch.device(device).type == "cuda"
    # 13a
    tp = r0["tp"]
    n_layers = tp["predicted"]["all-reduce"] // 2
    for what, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        a = r0["tp"][what]
        same_tokens("tp", what)
        for res in (r0, r1):
            colls_ok("tp", what, res)
            errs = res["tp"][what]["checks"]
            if len(errs) != n_layers or max(errs) > tol:
                raise AssertionError(f"tp {what}: dense-decode calls of a steady step "
                                     f"against decode_attention_ref: {errs} (tol {tol})")
        if what == "float32" and not (a["tokens_equal"] and a["rel_max"] <= 1e-4):
            raise AssertionError(f"tp fp32: tokens equal {a['tokens_equal']} (first "
                                 f"differing call {a['first_flip']}), logits {a['rel_max']:.3e}")
        if what == "bfloat16" and a["rel_last"] > 2e-2:
            raise AssertionError(f"tp bf16: last-step logits {a['rel_last']:.3e} > 2e-2")
        per_rank = n_layers * (st["tp_steps"] + st["timed"])
        if on_card:
            for res in (r0, r1):
                if res["tp"][what]["launches"] != per_rank:
                    raise AssertionError(f"tp {what}: {res['tp'][what]['launches']} "
                                         f"dense-decode launches, {per_rank} expected")
        launches["tp"] = launches.get("tp", 0) + r0["tp"][what]["launches"] \
            + r1["tp"][what]["launches"]
        log(
            f"[sharded] 13a tensor parallel, tinyllama-1.1b on (data 1, model 2) under "
            f"rules_for {tp['rules']}, {what}: local wq {a['local_wq']}, cache shard "
            f"{a['local_cache']}; 8 prompts, {st['tp_steps']} greedy decode steps: tokens "
            f"equal to the unsharded stream's: {a['tokens_equal']} (first differing "
            f"call {a['first_flip']}); logits relative L2 at the last step "
            f"{a['rel_last']:.3e}, worst over calls {a['rel_max']:.3e}; dense-decode calls "
            f"of step 3 against decode_attention_ref: worst relative L2 "
            f"{max(a['checks']):.3e} / {max(r1['tp'][what]['checks']):.3e} (rank 0 / 1, "
            f"{len(a['checks'])} calls, tol {tol}); collectives per decode step "
            f"{a['colls'][0]} (predicted {tp['predicted']}); dense-decode launches "
            f"{a['launches']} / {r1['tp'][what]['launches']}; eager decode step median "
            f"{median(a['ms']):.3f} / {median(r1['tp'][what]['ms']):.3f} ms (rank 0 / 1) "
            f"against the unsharded eager step's {median(a['unsharded_ms']):.3f} ms; "
            f"{a['seconds']:.1f} s [{smi}]"
        )
    # 13b, 13c
    for part, name in (("long", "13b distributed flash-decoding, tinyllama-1.1b"),
                       ("mla", "13c flash_decode_mla, minicpm3-4b")):
        info = r0[part]
        for what, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
            a = info[what]
            same_tokens(part, what)
            for res in (r0, r1):
                colls_ok(part, what, res)
            if what == "float32":
                if not a["tokens_equal"] or max(a["rel"]) > tol:
                    raise AssertionError(f"{part} fp32: tokens equal {a['tokens_equal']}, "
                                         f"logits {max(a['rel']):.3e}")
                for res in (r0, r1):
                    worst, n = res[part][what]["partials"]
                    if n != info["layers"] or worst > 1e-4:
                        raise AssertionError(f"{part}: shard partials {worst:.3e} over {n}")
            elif max(a["rel"]) > tol:
                raise AssertionError(f"{part} bf16: logits {max(a['rel']):.3e} > {tol}")
            parts = ""
            if what == "float32":
                parts = (f"; each rank's (m, l, o) of every layer at step 2 against the plain "
                         f"attention over its slice: worst relative L2 "
                         f"{a['partials'][0]:.3e} / {r1[part][what]['partials'][0]:.3e} "
                         f"(rank 0 / 1, {a['partials'][1]} calls, tol 1e-4)")
            ext_gates(part, what, info, r0, r1, smi)
            log(
                f"[sharded] {name} ({info['layers']} layers) on (data 2, model 1) under "
                f"long_context_rules + flash_decode, {what}: batch 1, a "
                f"{st['long_prompt']}-token prompt over a ring of the {a['local_cache'][2] * 2}"
                f"-slot window, cache shard {a['local_cache']}; {st['long_steps']} greedy "
                f"decode steps: tokens equal to the unsharded ring's: {a['tokens_equal']}; "
                f"logits relative L2 worst {max(a['rel']):.3e} (tol {tol}){parts}; "
                f"collectives per decode step {a['colls'][0]} (predicted "
                f"{info['predicted']}); eager decode step median {median(a['ms']):.3f} / "
                f"{median(r1[part][what]['ms']):.3f} ms against the unsharded ring's "
                f"{median(a['unsharded_ms']):.3f} ms; {a['seconds']:.1f} s [{smi}]"
            )
    # 13d
    info = r0["ep"]
    for what in ("float32", "bfloat16"):
        a, b = r0["ep"][what], r1["ep"][what]
        for res in (r0, r1):
            colls_ok("ep", what, res)
        dropped = [x + y for x, y in zip(a["dropped"], b["dropped"])]
        per_rank = info["layers"] * (st["ep_steps"] + st["timed"])
        if on_card and (a["launches"], b["launches"]) != (
                per_rank, per_rank):
            raise AssertionError(f"ep {what}: dense-decode launches {a['launches']} / "
                                 f"{b['launches']}, {per_rank} expected")
        launches["ep"] = launches.get("ep", 0) + a["launches"] + b["launches"]
        if what == "float32" and not any(dropped):
            if not a["tokens_equal"] or a["flipped_rows"] or max(a["rel"]) > 1e-4:
                raise AssertionError(f"ep fp32: tokens equal {a['tokens_equal']}, "
                                     f"flipped rows {a['flipped_rows']}, logits "
                                     f"{max(a['rel']) if a['rel'] else None}")
        if what == "bfloat16" and a["rel"] and max(a["rel"]) > 2e-2:
            raise AssertionError(f"ep bf16: logits {max(a['rel']):.3e} over rows whose "
                                 f"experts agree")
        rel = f"{max(a['rel']):.3e}" if a["rel"] else "none comparable"
        log(
            f"[sharded] 13d expert parallel, qwen2-moe-a2.7b ({info['layers']} layers) on "
            f"(data 2, model 1) under rules_for + moe_a2a {info['rules']}, {what}: "
            f"{a['local_experts']} experts and 4 of 8 rows a rank; decode from the "
            f"unsharded prefill's cache: dropped slots per step {dropped} (predicted none); "
            f"tokens equal to the unsharded dispatch='dense' stream's: {a['tokens_equal']}; "
            f"rows whose top-k experts differ from the unsharded route's in a layer "
            f"(row: first such decode step) {a['flipped_rows']}; logits relative L2 over "
            f"the rows not flipped so far: first "
            f"step {a['rel_first'] or 0:.3e}, worst {rel} over the {a['comparable']} "
            f"steps fed the same tokens; collectives per decode step "
            f"{a['colls'][0]} (predicted {info['predicted']}); dense-decode launches "
            f"{a['launches']} / {b['launches']}; the expert-parallel prefill alone dropped "
            f"{a['prefill_dropped']} / {b['prefill_dropped']} slots (rank 0 / 1); eager "
            f"decode step median {median(a['ms']):.3f} / {median(b['ms']):.3f} ms against "
            f"the unsharded dense dispatch's {median(a['unsharded_ms']):.3f} ms; "
            f"{a['seconds']:.1f} s [{smi}]"
        )
    # 13e-g
    ssd_launches = {}
    for part, name in (("ssm", "13e mamba2-780m"), ("hybrid", "13f zamba2-7b"),
                       ("audio", "13g whisper-medium")):
        launches[part], ssd_launches[part] = family_gates(part, name, r0, r1, on_card, smi)
    # 13h
    paged = {part: paged_gates(part, r0, r1, on_card, smi) for part in PAGED13}
    log(f"[sharded] the ranks' phase took {r0['phase_seconds']:.1f} / "
        f"{r1['phase_seconds']:.1f} s after their start")
    return {"decode": launches, "ssd": ssd_launches, "paged": paged}


#: 13h and 13i's bf16 gate: no more than this farther from the unsharded
#: fp32 logits than the unsharded bf16 ones are (tests/_bf16_gap.py's rule)
BF16_GAP = 5e-3


def ext_gates(part, what, info, r0, r1, smi):
    """13i's gates on both ranks' multi-token decodes over 13b's or 13c's
    split cache, and its line."""
    a = info[what]
    for res in (r0, r1):
        b = res[part][what]
        if any(c != info["predicted"] for c in b["ext_colls"]):
            raise AssertionError(f"13i {part} {what}: collectives per call "
                                 f"{b['ext_colls']}, predicted {info['predicted']}")
        if what == "float32":
            worst, n = b["ext_partials"]
            if n != info["layers"] or worst > 1e-4:
                raise AssertionError(f"13i {part}: shard partials {worst:.3e} over {n}")
    if not a["ext_finite"]:
        raise AssertionError(f"13i {part} {what}: non-finite logits")
    if what == "float32":
        if not all(a["ext_tokens_equal"]) or max(a["ext_rel"]) > 1e-4:
            raise AssertionError(f"13i {part} fp32: argmax equal {a['ext_tokens_equal']}, "
                                 f"logits {a['ext_rel']} (tol 1e-4)")
        gate = (f"last-row argmax equal to the unsharded: {a['ext_tokens_equal']}; logits "
                f"relative L2 {fmt_errs(a['ext_rel'])} (tol 1e-4); each rank's (m, l, o) of "
                f"every layer's {info['ext_lens'][1]} rows of the second decode against the "
                f"plain attention over its slice: worst "
                f"{a['ext_partials'][0]:.3e} / {r1[part][what]['ext_partials'][0]:.3e}")
    else:
        worst = max(g - p for g, p in a["ext_gap"])
        if worst > BF16_GAP:
            raise AssertionError(f"13i {part} bf16: logits farther from fp32 than the "
                                 f"unsharded bf16 by {worst:.3e} (tol {BF16_GAP})")
        gate = (f"fed the fp32 stream's tokens; against the unsharded fp32: sharded "
                f"{fmt_errs([g for g, _ in a['ext_gap']])}, unsharded "
                f"{fmt_errs([p for _, p in a['ext_gap']])}: no more than {worst:.3e} "
                f"farther (tol {BF16_GAP})")
    log(f"[sharded] 13i {part} ({info['layers']} layers), {what}: decodes of "
        f"{info['ext_lens']} tokens from position {info['ext_pos']} over 13"
        f"{'b' if part == 'long' else 'c'}'s split ring (the second's slots cross into "
        f"rank 1's half): {gate}; collectives per call {a['ext_colls']} (predicted "
        f"{info['predicted']}); ms {fmt_errs(a['ext_ms'], '.1f')} / "
        f"{fmt_errs(r1[part][what]['ext_ms'], '.1f')} (rank 0 / 1, host clock) against "
        f"the unsharded {fmt_errs(a['ext_unsharded_ms'], '.1f')} [{smi}]")


def fmt_errs(xs, f=".3e"):
    return "[" + ", ".join(format(x, f) for x in xs) + "]"


def paged_gates(part, r0, r1, on_card, smi):
    """13h's gates on both ranks' paged steps under rules, and its lines.
    Returns the paged-decode launches of both ranks' sharded steps."""
    key = f"paged_{part}"
    info = r0[key]
    arch = PAGED13[part][0]
    L, steps = info["layers"], info["steps"]
    launches = 0
    for what, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        a = info[what]
        if a["tokens"] != r1[key][what]["tokens"]:
            raise AssertionError(f"13h {part} {what}: the ranks' tokens differ")
        for res in (r0, r1):
            b = res[key][what]
            if any(c != info["predicted"] for c in b["colls"]):
                raise AssertionError(f"13h {part} {what}: collectives per step "
                                     f"{b['colls'][:2]}..., predicted {info['predicted']}")
            if on_card and b["launches"] != [L] * steps:
                raise AssertionError(f"13h {part} {what}: paged launches per step "
                                     f"{b['launches']}, {L} expected")
            if len(b["checks"]) != L or max(b["checks"]) > tol:
                raise AssertionError(f"13h {part} {what}: paged calls of step 3 against "
                                     f"paged_decode_attention_ref: {b['checks']} (tol {tol})")
            if b["pool_rel"] > tol:
                raise AssertionError(f"13h {part} {what}: the rank's pool against its "
                                     f"slice of the unsharded pool: {b['pool_rel']:.3e}")
            launches += sum(b["launches"])
        if not a["finite"]:
            raise AssertionError(f"13h {part} {what}: non-finite logits")
        if what == "float32":
            if not a["tokens_equal"] or a["flipped_rows"] or max(a["rel"]) > tol:
                raise AssertionError(f"13h {part} fp32: tokens equal {a['tokens_equal']}, "
                                     f"flipped rows {a['flipped_rows']}, logits "
                                     f"{max(a['rel']):.3e} (tol {tol})")
            gate = (f"tokens equal to the unsharded paged stream's: {a['tokens_equal']}; "
                    f"logits relative L2 worst {max(a['rel']):.3e} (tol {tol})")
        else:
            worst = max(g - p for g, p in a["gap"])
            if worst > BF16_GAP:
                raise AssertionError(f"13h {part} bf16: logits farther from fp32 than the "
                                     f"unsharded bf16 by {worst:.3e} (tol {BF16_GAP})")
            gate = (f"fed the fp32 tokens; logits against the unsharded bf16 worst "
                    f"{max(a['rel']):.3e}; against the unsharded fp32: sharded "
                    f"{max(g for g, _ in a['gap']):.3e}, unsharded "
                    f"{max(p for _, p in a['gap']):.3e}, no more than {worst:.3e} farther "
                    f"(tol {BF16_GAP})")
            if part == "ep":
                gate += (f" over the rows whose experts agree with the unsharded bf16 "
                         f"route's so far (flipped rows: first step {a['flipped_rows']})")
        log(
            f"[sharded] 13h paged step under rules, {arch} ({L} layers) on "
            f"{'(data 1, model 2)' if part == 'tp' else '(data 2, model 1)'} under "
            f"rules_for {info['rules']}, {what}: {info['rows']} of 8 rows and "
            f"{info['kv_heads']} KV heads a rank, pool shard {a['local_pool']}, local "
            f"{a['local']}; 8 prompts from rank 0's unsharded prefill, {steps} paged decode "
            f"steps (attn_impl kernel): {gate}; the rank's pool after the steps against its "
            f"slice of the unsharded pool: relative L2 {a['pool_rel']:.3e} / "
            f"{r1[key][what]['pool_rel']:.3e}, bit-equal {a['pool_equal']} / "
            f"{r1[key][what]['pool_equal']} (tol {tol}); the {len(a['checks'])} paged calls "
            f"of step 3 against paged_decode_attention_ref worst {max(a['checks']):.3e} / "
            f"{max(r1[key][what]['checks']):.3e}; collectives per step {a['colls'][0]} "
            f"(predicted {info['predicted']}); paged launches per step {a['launches'][0]} a "
            f"rank; eager step median {median(a['ms']):.3f} / "
            f"{median(r1[key][what]['ms']):.3f} ms (rank 0 / 1, host clock) against the "
            f"unsharded paged step's {median(a['unsharded_ms']):.3f} ms; "
            f"{a['seconds']:.1f} s [{smi}]"
        )
    return launches


def family_gates(part, name, r0, r1, on_card, smi):
    """13e-g's gates on both ranks' results, and their lines. Returns the
    dense-decode and SSD launches of both ranks' sharded streams."""
    info = r0[part]
    L, n_pre, mamba, attn = info["layers"], info["prefills"], info["mamba"], info["attn"]
    decode_launches = ssd_launches = 0
    for what, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        a = info[what]
        if a["tokens"] != r1[part][what]["tokens"]:
            raise AssertionError(f"{part} {what}: the ranks' tokens differ")
        for res in (r0, r1):
            b = res[part][what]
            if any(c != info["predicted"] for c in b["colls"]) or any(
                    c != info["predicted_prefill"] for c in b["prefill_colls"]) or len(
                    b["prefill_colls"]) != n_pre:
                raise AssertionError(
                    f"{part} {what}: collectives per prefill {b['prefill_colls'][:2]}... and "
                    f"per decode step {b['colls'][:2]}..., predicted "
                    f"{info['predicted_prefill']} and {info['predicted']}")
            if len(b["ssd_checks"]) != mamba or (mamba and max(b["ssd_checks"]) > tol):
                raise AssertionError(f"{part} {what}: SSD calls of the first prefill against "
                                     f"the plain scan: {b['ssd_checks']} (tol {tol})")
            if len(b["checks"]) != attn or (attn and max(b["checks"]) > tol):
                raise AssertionError(f"{part} {what}: dense-decode calls of decode step 3 "
                                     f"against decode_attention_ref: {b['checks']} (tol {tol})")
            if on_card and (b["ssd_launches"] != mamba * n_pre or b["decode_launches"]
                            != attn * (info["steps"] + info["timed"])):
                raise AssertionError(
                    f"{part} {what}: SSD launches {b['ssd_launches']} (expected "
                    f"{mamba * n_pre}), dense-decode {b['decode_launches']} (expected "
                    f"{attn * (info['steps'] + info['timed'])})")
            decode_launches += b["decode_launches"]
            ssd_launches += b["ssd_launches"]
        if not a["finite"]:
            raise AssertionError(f"{part} {what}: non-finite logits")
        if what == "float32":
            if not a["tokens_equal"] or max(a["rel"]) > tol:
                raise AssertionError(f"{part} fp32: tokens equal {a['tokens_equal']}, logits "
                                     f"{max(a['rel']):.3e} (tol {tol})")
            gate = (f"tokens equal to the unsharded stream's: {a['tokens_equal']}; logits "
                    f"relative L2 worst {max(a['rel']):.3e} over {len(a['rel'])} calls "
                    f"(tol {tol})")
        else:
            worst = max(g - p for g, p in a["gap"])
            if worst > tol:
                raise AssertionError(f"{part} bf16: logits farther from fp32 than the "
                                     f"unsharded bf16 by {worst:.3e} (tol {tol})")
            gate = (f"fed the fp32 stream's tokens; logits against the unsharded bf16 "
                    f"worst {max(a['rel']):.3e}; against the unsharded fp32: sharded "
                    f"{max(g for g, _ in a['gap']):.3e}, unsharded "
                    f"{max(p for _, p in a['gap']):.3e}, the sharded no more than "
                    f"{worst:.3e} farther (tol {tol}, tests/_bf16_gap.py's rule)")
        checks = []
        if mamba:
            checks.append(f"the {len(a['ssd_checks'])} SSD calls of the first prefill "
                          f"against ssd_chunked worst {max(a['ssd_checks']):.3e} / "
                          f"{max(r1[part][what]['ssd_checks']):.3e}")
        if attn:
            checks.append(f"the {len(a['checks'])} dense-decode calls of decode step 3 "
                          f"against decode_attention_ref worst {max(a['checks']):.3e} / "
                          f"{max(r1[part][what]['checks']):.3e}")
        log(
            f"[sharded] {name} ({L} layers"
            + (f", {info['enc_layers']} encoder layers" if part == "audio" else "")
            + f") on (data 1, model 2) under rules_for {info['rules']}, {what}: local "
            f"{a['local']}, cache shard {a['local_cache']}; {n_pre} prefill call(s), "
            f"{info['steps']} decode steps: {gate}; {'; '.join(checks)} (rank 0 / 1, tol "
            f"{tol}); collectives per prefill {a['prefill_colls'][0]}, per decode step "
            f"{a['colls'][0]} (predicted {info['predicted_prefill']} / {info['predicted']}); "
            f"launches SSD {a['ssd_launches']}, dense decode {a['decode_launches']} a rank; "
            f"eager decode step median {median(a['ms']):.3f} / "
            f"{median(r1[part][what]['ms']):.3f} ms (rank 0 / 1), its staged collectives "
            f"{median(a['coll_ms']):.3f} ms (rank 0, host clock), against the unsharded "
            f"eager step's {median(a['unsharded_ms']):.3f} ms; {a['seconds']:.1f} s [{smi}]"
        )
    return decode_launches, ssd_launches


# ------------------------------------------------- training (phase 14)
TRAIN_ARCH = "tinyllama-1.1b"
#: steps of each phase-14a run, the driver's and the timed one, and of
#: 15a's and 15b's bf16 runs (cut from 10 for the script's time)
TRAIN_STEPS = 6
#: the timed run trains on ONE batch repeated; its loss must fall by more
#: than this many nats over TRAIN_STEPS steps at the driver's lr 1e-3
TRAIN_FALL = 1.0
#: phase 14f runs qwen2-moe-a2.7b at this many of its 24 layers
TRAIN_MOE_LAYERS = 4
#: phases 14d (the checkpoint) and 14e (accumulation) run tinyllama-1.1b
#: at this many of its 22 layers: at full depth 14d's 11.0 GB file took
#: 35.6 s to save and load on an H100 machine, past phase 14's time; at 6
#: layers 11.2-18.4 s (cut to 2)
TRAIN_CUT_LAYERS = 2
#: phase 14c's reduced configs, card against the CPU: one per family but
#: vlm (chameleon's decoder is the dense one)
TRAIN_CHECK_ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "mamba2-780m",
                     "zamba2-7b", "minicpm3-4b", "whisper-medium")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device):
    """Frees what the caching allocator holds and resets the peak."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device):
    return (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)


def model_flops_train(cfg, batch, seq):
    """A train step's model FLOPs by the reference's convention
    (``repro.launch.dryrun.model_flops_analytic``, kind ``train``): 2 x
    the active parameters per token for the forward, plus attention
    scores over half the sequence and the SSD state work, times 3 for
    the backward."""
    tokens, ctx = batch * seq, seq / 2
    n_active = cfg.param_count()
    if cfg.num_experts:
        expert = 3 * cfg.d_model * cfg.d_ff
        n_active += (cfg.num_experts_per_tok - cfg.num_experts) * expert * cfg.num_layers
    attn = 0.0
    if cfg.attention_kind != "none":
        hd = (cfg.resolved_head_dim if cfg.attention_kind == "gqa"
              else cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        layers = (cfg.num_layers if cfg.hybrid_attn_every == 0
                  else cfg.num_layers // cfg.hybrid_attn_every)
        attn = 4.0 * tokens * ctx * cfg.num_heads * hd * layers
    ssd = 0.0
    if cfg.ssm_state:
        ssd = 6.0 * tokens * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * cfg.num_layers
    return (2.0 * n_active * tokens + attn + ssd) * 3.0


def rel_tree(got, want):
    """Relative L2 of each leaf of two ``tree_items`` lists (0 where both
    are zero), by path."""
    out = {}
    for (path, a), (_, b) in zip(got, want):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        den, num = b.norm().item(), (a - b).norm().item()
        out["/".join(path)] = num / den if den else (0.0 if num == 0 else float("inf"))
    return out


def profile_train(step, args, n, out_dir, smi):
    """``n`` train steps under torch.profiler: the device's busy time
    (the union of kernel, copy and memset intervals) against the wall
    time, and device time by kernel name (``train_profile.txt``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            args = step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    trace = out_dir / "train_trace.json"
    prof.export_chrome_trace(str(trace))
    n_ops, busy_us, by_name = device_time(trace)
    trace.unlink()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    head = (f"{n} bf16 train steps of {TRAIN_ARCH} (batch 8, seq 128), wall "
            f"{wall_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms, {n_ops} "
            f"device ops [{smi}]")
    rows = [f"{us / 1e3 / n:10.4f} ms/step  {name[:110]}" for name, us in top]
    (out_dir / "train_profile.txt").write_text("\n".join([head, *rows]) + "\n")
    top5 = "; ".join(f"{name[:60]} {us / 1e3 / n:.4f} ms" for name, us in top[:5])
    log(f"[train] profile: {head}; idle share {1 - busy_us / 1e3 / wall_ms:.3f}; "
        f"top device time per step: {top5}")


#: the measured peak of a step against the dry run's prediction (arguments
#: + temp): within this share of the prediction
MEMORY_TOL = 0.15


def meta_like(tree):
    """A copy of a tree of tensors on the meta device (shapes, strides and
    types; no memory)."""
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(meta_like(v) for v in tree)
    if torch.is_tensor(tree):
        return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype, device="meta")
    return tree


def step_memory(fn, args, device):
    """(arguments, temp, measured, allocated at the start): the dry run's
    meta tally (``launch.dryrun.MemoryTally``) of ``fn(*args)`` on meta
    copies of the arguments, and the card's ``max_memory_allocated`` over
    one call of ``fn(*args)`` after ``reset_peak_memory_stats`` (0 off the
    card). The cuBLAS workspaces that earlier phases' streams left in the
    allocator (one a stream, kept for the process's life) are released
    first: they are not the call's."""
    from repro_torch.launch import dryrun as DR

    meta = meta_like(args)
    tally = DR.MemoryTally(meta)
    with tally:
        fn(*meta)
    del meta
    if torch.device(device).type == "cuda":
        torch._C._cuda_clearCublasWorkspaces()
    reset_peak(device)
    start = torch.cuda.memory_allocated() if torch.device(device).type == "cuda" else 0
    out = fn(*args)
    sync(device)
    measured = peak_bytes(device)
    del out
    return DR.tree_bytes(args), tally.temp, measured, start


def memory_gate(what, arg_bytes, temp, measured, start, on_card, smi, how="",
                tol=MEMORY_TOL):
    """Prints the dry run's memory prediction of a step (arguments + temp)
    beside the card's measured peak (and the bytes allocated when the
    call began), and gates their gap at ``tol`` of the prediction (on the
    card)."""
    predicted = arg_bytes + temp
    gap = (measured - predicted) / predicted
    log(f"{what}: the dry run's memory prediction (arguments {arg_bytes} B + temp {temp} B "
        f"= {predicted} B; {how}) against torch.cuda.max_memory_allocated() {measured} B "
        f"({start} B allocated when it began): {gap:+.2%} (gate +-{tol:.0%}) "
        f"[{smi}]")
    if on_card and abs(gap) > tol:
        raise AssertionError(f"{what}: measured peak {measured} B is {gap:+.2%} from the "
                             f"dry run's {predicted} B")


def train_driver(mods, cfg, st, out_dir, smi):
    """14a: ``launch.train.main`` at the reference's defaults in fp32 and
    bf16, then a timed run of the same step on one repeated batch."""
    LT, OPT, TR, T, DP = mods
    dev, B, S = st.device, 8, 128
    flops = model_flops_train(cfg, B, S)
    for dtype in ("float32", "bfloat16"):
        reset_peak(dev)
        t = time.perf_counter()
        argv = ["--arch", cfg.name, "--steps", str(TRAIN_STEPS), "--batch", str(B),
                "--seq", str(S), "--lr", "1e-3", "--dtype", dtype, "--log-every", "5",
                "--device", dev] + (["--reduce"] if st.reduced else [])
        final = LT.main(argv)
        if not np.isfinite(final):
            raise AssertionError(f"launch.train.main {dtype}: final loss {final}")
        log(f"[train] launch.train.main {' '.join(argv)}: final loss {final:.4f} in "
            f"{time.perf_counter() - t:.1f} s, peak device memory allocated "
            f"{peak_bytes(dev)} B [{smi}]")

        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dtype)
        ocfg = OPT.OptimizerConfig(lr=1e-3, warmup_steps=min(20, TRAIN_STEPS // 5),
                                   total_steps=TRAIN_STEPS)
        opt = OPT.init_opt_state(params)
        step = TR.make_train_step(cfg, ocfg)
        batch = DP.synth_batch(cfg, DP.DataConfig(seq_len=S, global_batch=B), 0, dev)
        n_params = sum(p.numel() for p in OPT.tree_leaves(params))
        elt = torch.finfo(getattr(torch, dtype)).bits // 8
        predicted = n_params * (2 * elt + 2 * 4)   # params, grads, fp32 moments
        reset_peak(dev)
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            sync(dev)
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
        peak = peak_bytes(dev)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{dtype} train losses {losses}")
        if not losses[-1] < losses[0] - TRAIN_FALL:
            raise AssertionError(
                f"{dtype}: the loss on one repeated batch fell {losses[0] - losses[-1]:.3f} "
                f"nats in {TRAIN_STEPS} steps at lr 1e-3 (gate > {TRAIN_FALL}): {losses}")
        ms = median(times)
        peak_flops = PEAK_FLOPS[getattr(torch, dtype)]
        log(f"[train] 14a {cfg.name} {dtype}, batch {B} x seq {S}, lr 1e-3 (warmup "
            f"{ocfg.warmup_steps}), one batch repeated: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} (fell {losses[0] - losses[-1]:.3f} nats, gate > "
            f"{TRAIN_FALL}); step median {ms:.3f} ms (min {min(times):.3f}, first "
            f"{times[0]:.3f}; synchronised), {B * S / ms * 1e3:.0f} tokens/s, model FLOPs "
            f"{flops:.4e} a step = {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{flops / (ms / 1e3) / peak_flops:.4f} of the {dtype} dense peak "
            f"{peak_flops / 1e12:.0f} TFLOP/s (H100 SXM data sheet); peak device memory "
            f"allocated {peak} B against params + grads + fp32 moments {predicted} B "
            f"({n_params} parameters) [{smi}]")
        if dtype == "bfloat16":   # one more step, its peak against the dry run's
            memory_gate(f"[train] 14a {cfg.name} bf16 step", *step_memory(
                step, (params, opt, batch), dev), dev == "cuda", smi,
                "meta tally of the same step, fp32 moments as the steps leave them")
        if dtype == "bfloat16" and dev == "cuda":
            profile_train(lambda p, o: step(p, o, batch)[:2], (params, opt), 2, out_dir,
                          smi)
        del params, opt, m


def train_remat(mods, cfg, st, smi):
    """14b: bf16 gradients at batch 8 x seq 1024 with and without remat."""
    LT, OPT, TR, T, DP = mods
    dev = st.device
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), "bfloat16")
    batch = DP.synth_batch(cfg, DP.DataConfig(seq_len=st.long_seq, global_batch=8), 0,
                           dev)
    out = {}
    for remat in (False, True):
        reset_peak(dev)
        t = time.perf_counter()
        (total, _), grads = TR.value_and_grad(TR.make_loss_fn(cfg, remat=remat), params,
                                              batch)
        sync(dev)
        # on the host, so the next call's peak holds only its own arguments
        out[remat] = (total.cpu(), OPT.tree_map(lambda t: t.cpu(), grads),
                      (time.perf_counter() - t) * 1e3, peak_bytes(dev))
        del total, grads
    memory_gate(f"[train] 14b {cfg.name} bf16 remat loss and gradients, batch 8 x seq "
                f"{st.long_seq}", *step_memory(
                    lambda p, b: TR.value_and_grad(TR.make_loss_fn(cfg, remat=True), p, b),
                    (params, batch), dev), dev == "cuda", smi,
                "meta tally of the same call")
    rel = rel_tree(OPT.tree_items(out[True][1]), OPT.tree_items(out[False][1]))
    equal = sum(torch.equal(a, b) for a, b in zip(OPT.tree_leaves(out[True][1]),
                                                   OPT.tree_leaves(out[False][1])))
    worst = max(rel.values())
    if worst > 1e-6 or not torch.equal(out[True][0], out[False][0]):
        raise AssertionError(f"remat changed the gradients: worst leaf {worst:.3e} "
                             f"(gate 1e-6), loss {out[True][0]} vs {out[False][0]}")
    log(f"[train] 14b {cfg.name} bf16, batch 8 x seq {st.long_seq}, loss and gradients "
        f"with remat vs without: {equal} of {len(rel)} leaves bit-equal, worst relative "
        f"L2 {worst:.3e} (gate 1e-6), loss equal; peak device memory allocated "
        f"{out[False][3]} B without remat, {out[True][3]} B with; loss + gradients "
        f"{out[False][2]:.1f} / {out[True][2]:.1f} ms (first call each) [{smi}]")


def train_card_vs_cpu(mods, get_config, st, smi):
    """14c: one fp32 train step of each reduced config on the card and on
    the CPU, from the same drawn weights and batch."""
    LT, OPT, TR, T, DP = mods
    worst = {}
    for arch in TRAIN_CHECK_ARCHS:
        cfg = get_config(arch).reduced()
        params = T.init_params(cfg, torch.Generator().manual_seed(SEED), "float32")
        batch = DP.synth_batch(cfg, DP.DataConfig(seq_len=32, global_batch=2), 0, "cpu")
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
                (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
        ocfg = OPT.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        res = []
        for dev in ("cpu", st.device):
            p = OPT.tree_map(lambda t: t.to(dev, copy=True), params)
            b = {k: v.to(dev) for k, v in batch.items()}
            (total, _), grads = TR.value_and_grad(TR.make_loss_fn(cfg), p, b)
            p, _, _ = OPT.apply_updates(ocfg, p, grads, OPT.init_opt_state(p))
            res.append((total, grads, p))
        (tc, g_cpu, pc), (tg, g_dev, pg) = res
        loss_rel = abs(float(tg) - float(tc)) / abs(float(tc))
        g_rel = max(rel_tree(OPT.tree_items(g_dev), OPT.tree_items(g_cpu)).values())
        p_rel = max(rel_tree(OPT.tree_items(pg), OPT.tree_items(pc)).values())
        if loss_rel > 1e-5 or g_rel > 1e-4 or p_rel > 1e-4:
            raise AssertionError(f"{arch} card vs CPU: loss {loss_rel:.3e} (1e-5), "
                                 f"grads {g_rel:.3e}, params {p_rel:.3e} (1e-4)")
        worst[arch] = (loss_rel, g_rel, p_rel)
    log("[train] 14c one fp32 train step of each reduced config, card vs CPU from the "
        "same weights (loss relative, worst gradient leaf and updated parameter relative "
        "L2; gates 1e-5, 1e-4, 1e-4): " + "; ".join(
            f"{a} {x:.2e} / {g:.2e} / {p:.2e}" for a, (x, g, p) in worst.items())
        + f" [{smi}]")


def train_checkpoint(mods, cfg, st, smi):
    """14d: save -> load(like=) at full width (bf16; ``cfg`` at cut
    depth), then one more step from the loaded trees against the
    uninterrupted step."""
    LT, OPT, TR, T, DP = mods
    from repro_torch.training import checkpoint as CKPT

    dev = st.device
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), "bfloat16")
    opt = OPT.init_opt_state(params)
    step = TR.make_train_step(cfg, OPT.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                       total_steps=10))
    data = DP.DataConfig(seq_len=128, global_batch=8)
    params, opt, _ = step(params, opt, DP.synth_batch(cfg, data, 0, dev))
    ckdir = ROOT / "build" / "train_ckpt"
    ckdir.mkdir(parents=True, exist_ok=True)
    path = str(ckdir / "step1.ckpt")
    tree = {"params": params, "opt": opt}
    try:
        sync(dev)
        t = time.perf_counter()
        CKPT.save(path, tree, {"arch": cfg.name, "step": 1})
        save_s = time.perf_counter() - t
        nbytes = os.path.getsize(path)
        t = time.perf_counter()
        loaded, meta = CKPT.load(path, like=tree)
        sync(dev)
        load_s = time.perf_counter() - t
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    b1 = DP.synth_batch(cfg, data, 1, dev)
    a = step(params, opt, b1)
    b = step(loaded["params"], loaded["opt"], b1)
    same = all(torch.equal(x, y) for x, y in zip(
        OPT.tree_leaves({"p": a[0], "o": a[1]}), OPT.tree_leaves({"p": b[0], "o": b[1]})))
    if not same or meta != {"arch": cfg.name, "step": 1}:
        raise AssertionError("the step after save -> load differs from the "
                             "uninterrupted step")
    log(f"[train] 14d checkpoint of {cfg.name} ({cfg.num_layers} layers) bf16 params + "
        f"fp32 moments after one step: {nbytes} B, save {save_s:.2f} s, load(like=) {load_s:.2f} s; the next "
        f"step from the loaded trees bit-equal to the uninterrupted one (params, "
        f"moments, step) [{smi}]")


def train_accum(mods, cfg, st, smi):
    """14e: accumulation over 4 micro-batches against one step over the
    same global batch (fp32, no mask: each micro-batch's mean loss then
    weighs its tokens as the global mean does)."""
    LT, OPT, TR, T, DP = mods
    dev = st.device
    batch = DP.synth_batch(cfg, DP.DataConfig(seq_len=128, global_batch=8), 0, dev)
    del batch["mask"]
    ocfg = OPT.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    res = {}
    for accum in (1, 4):
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                               "float32")
        step = (TR.make_train_step(cfg, ocfg) if accum == 1
                else TR.make_train_step_accum(cfg, ocfg, accum_steps=accum))
        _, opt, m = step(params, OPT.init_opt_state(params), batch)
        res[accum] = (opt["mu"], float(m["total_loss"]), float(m["grad_norm"]))
        del params, opt
        reset_peak(dev)
    worst = max(rel_tree(OPT.tree_items(res[4][0]), OPT.tree_items(res[1][0])).values())
    loss_rel = abs(res[4][1] - res[1][1]) / abs(res[1][1])
    norm_rel = abs(res[4][2] - res[1][2]) / abs(res[1][2])
    if max(worst, loss_rel, norm_rel) > 1e-5:
        raise AssertionError(f"accum 4 vs one step: moments {worst:.3e}, loss "
                             f"{loss_rel:.3e}, grad norm {norm_rel:.3e} (gate 1e-5)")
    log(f"[train] 14e {cfg.name} ({cfg.num_layers} layers) fp32, batch 8 x seq 128: "
        f"make_train_step_accum (4 "
        f"micro-batches of 2) vs make_train_step: first moments (1 - b1) x clipped "
        f"gradient, worst leaf relative L2 {worst:.3e}, loss {loss_rel:.3e}, grad norm "
        f"{norm_rel:.3e} (gate 1e-5) [{smi}]")


def train_moe(mods, get_config, st, smi):
    """14f: qwen2-moe-a2.7b at full width and cut depth, bf16 with bf16
    moments, two steps through the scatter dispatch's backward."""
    LT, OPT, TR, T, DP = mods
    dev = st.device
    cfg = get_config(MOE_ARCH)
    cfg = (cfg.reduced() if st.reduced
           else dataclasses.replace(cfg, num_layers=TRAIN_MOE_LAYERS))
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), "bfloat16")
    opt = OPT.init_opt_state(params, "bfloat16")
    n_params = sum(p.numel() for p in OPT.tree_leaves(params))
    step = TR.make_train_step(cfg, OPT.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                       total_steps=10))
    reset_peak(dev)
    times, metrics = [], []
    for i in range(2):
        batch = DP.synth_batch(cfg, DP.DataConfig(seq_len=128, global_batch=8), i, dev)
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        sync(dev)
        times.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"qwen2-moe train step metrics {metrics}")
    dispatch = "dense" if cfg.num_experts <= 8 else "scatter"
    log(f"[train] 14f {cfg.name} at {cfg.num_layers} of 24 layers ({n_params} "
        f"parameters), bf16 with bf16 moments, batch 8 x seq 128, {cfg.num_experts} "
        f"experts through the {dispatch} dispatch: loss {metrics[0]['loss']:.4f} / "
        f"{metrics[1]['loss']:.4f}, aux loss {metrics[0]['aux_loss']:.4f} / "
        f"{metrics[1]['aux_loss']:.4f} (finite), grad norm "
        f"{metrics[0]['grad_norm']:.3f}; step {times[0]:.1f} ms (first) / "
        f"{times[1]:.1f} ms; peak device memory allocated {peak_bytes(dev)} B [{smi}]")


def grad_probe_args(device):
    """Small valid inputs of the four wrappers (paged, flash, decode, SSD),
    the first one requiring grad."""
    def z(*shape, grad=False):
        return torch.zeros(shape, device=device, requires_grad=grad)

    def i32(*shape, fill=16):
        return torch.full(shape, fill, dtype=torch.int32, device=device)

    return ((z(1, 4, 64, grad=True), z(2, 1, 16, 64), z(2, 1, 16, 64), i32(1, 1, fill=0),
             i32(1)),
            (z(1, 4, 16, 64, grad=True), z(1, 1, 16, 64), z(1, 1, 16, 64)),
            (z(1, 4, 64, grad=True), z(1, 1, 16, 64), z(1, 1, 16, 64), i32(1)),
            (z(1, 64, 2, 32, grad=True), z(1, 64, 2), z(2), z(1, 64, 1, 16),
             z(1, 64, 1, 16)))


def training_phase(kernel_fns, get_config, out_dir, smi, device="cuda", reduced=False):
    """Phase 14: the training path at full width. ``kernel_fns`` are the
    four kernel wrappers, whose launch counts must not move: training
    takes the plain routes. ``device="cpu"`` with ``reduced`` rehearses
    the phase on the CPU at the reduced configs."""
    from repro_torch.data import pipeline as DP
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train as TR

    mods = (LT, OPT, TR, T, DP)
    st = types.SimpleNamespace(device=device, reduced=reduced,
                               long_seq=128 if reduced else 1024)
    before = [k.launches for k in kernel_fns]
    cfg = get_config(TRAIN_ARCH)
    cfg = cfg.reduced() if reduced else cfg
    cut = cfg if reduced else dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS)
    parts = (("14a", lambda: train_driver(mods, cfg, st, out_dir, smi)),
             ("14b", lambda: train_remat(mods, cfg, st, smi)),
             ("14c", lambda: train_card_vs_cpu(mods, get_config, st, smi)),
             ("14d", lambda: train_checkpoint(mods, cut, st, smi)),
             ("14e", lambda: train_accum(mods, cut, st, smi)),
             ("14f", lambda: train_moe(mods, get_config, st, smi)))
    for name, part in parts:
        t = time.perf_counter()
        part()
        reset_peak(device)
        log(f"[train] {name} in {time.perf_counter() - t:.1f} s")
    refused = []
    if torch.device(device).type == "cuda":
        for fn, args in zip(kernel_fns, grad_probe_args(device)):
            try:
                fn(*args)
            except RuntimeError as e:
                if "no backward" not in str(e):
                    raise
                refused.append(fn.__name__)
            else:
                raise AssertionError(f"{fn.__name__} launched on an input that "
                                     f"requires grad")
    after = [k.launches for k in kernel_fns]
    if after != before:
        raise AssertionError(f"kernel launches during training: {before} -> {after}")
    log(f"[train] 14g kernel launches across phase 14 unchanged: {after} (paged, flash, "
        f"decode, SSD; training takes the plain routes); each wrapper refuses an input "
        f"that requires grad (no backward): {refused}")


# ------------------------------------ the sharded train step (phase 15)
#: phase 15's ranks: two processes sharing the one card in gloo groups
#: (on the card ranks must be processes: CUDA autograd runs one worker
#: thread per device, in which two thread-ranks' backward collectives
#: would wait on each other)
TRAIN_RANKS = 2
#: 15e's float64 witness: the sharded step 1 against the unsharded one,
#: both in float64, at most this far apart (relative L2 of every shard)
F64_TOL = 1e-9
#: 15c's qwen2-moe-a2.7b depth (of 24): two fp32 ranks and the unsharded
#: step must fit the card one after another (cut from 2 for the script's
#: time, PERF.md §4)
P15_MOE_LAYERS = 1
#: 15a's and 15b's tinyllama-1.1b depths (of 22), to keep the script's
#: time: their collectives stage through the host (15b's gradient sums at
#: ~1 GB/s); cut from 22 and 22, then 22 and 11, 11 and 6, 6 and 3
#: (PERF.md §4)
P15_TP_LAYERS, P15_DP_LAYERS = 3, 2
P15_AXES = ("data", "model")


def p15_settings(device):
    """Phase 15's sizes: the card's (batch 8 x seq 128, as phase 14a), or
    a CPU rehearsal's (reduced configs)."""
    if torch.device(device).type == "cuda":
        return dict(reduced=False, batch=8, seq=128, steps=3, moe_steps=2,
                    bf16_steps=TRAIN_STEPS, ep_steps=2, moe_layers=P15_MOE_LAYERS)
    return dict(reduced=True, batch=4, seq=16, steps=2, moe_steps=2, bf16_steps=4,
                ep_steps=3, moe_layers=None)


def p15_predicted(T, cfg, part, shape=None):
    """The collectives of one train step of phase 15's parts (and of
    ``chip_multicard.py``'s part T), by phase and kind, from the design
    (``parallel.mesh``'s convention; no remat). A dense decoder on (data
    d, model m), ``shape`` (tp's (1, 2) and dp's (2, 1) by default, 2d's
    (2, 2)): over model, the embedding's psum, two row-parallel psums a
    layer and the logits' all-gather forward; backward, an ``enter`` psum
    a layer's attention input, one its MLP input and one the final norm's
    output entering the vocab-split ``lm_head``; update, one scalar psum
    of the norm (the model-split leaves; the replicated ones count once,
    unsummed). Over data: the loss's psum forward; update, one gradient
    sum a leaf (none is split over data). On (2, 2) the two add up. No
    count depends on an axis's size beyond it being > 1, nor on the
    params' type: llama2-13b on (1, 4) in bf16 is tp, its 40 K/V heads
    split with its 40 query heads, so no K/V ``enter`` is added (a K/V
    head kept whole under split query heads would add one a layer, which
    no case here has). moe, (2, 1) or (4, 1), experts on data: a
    layer gathers the rows and sums the experts forward, a reduce-scatter
    and a psum backward; update, a gradient sum a leaf but the three
    routed-expert leaves, and the norm's psum over data. ep: two
    all-to-alls a layer each way. ssm, (1, 2): forward as tp, two psums a
    Mamba2 layer (the gated norm's sum of squares, ``out_proj``);
    backward, seven a layer (the ``enter`` of x into the split
    projections, of the whole B and C, of ``dt_bias``, ``A_log`` and
    ``D`` at the rank's heads, and the gated norm's psum backward) and the
    final norm's; update as tp. audio, (2, 1): as dp."""
    L = cfg.num_layers
    n = len(list(tree_leaves(T.init_params_meta(cfg))))
    if part == "ssm":
        return {"forward": {"all-gather": 1, "all-reduce": 1 + 2 * L},
                "backward": {"all-reduce": 7 * L + 1}, "update": {"all-reduce": 1}}
    if part in ("tp", "dp", "2d", "audio"):
        d, m = shape or {"tp": (1, 2), "2d": (2, 2)}.get(part, (2, 1))
        fwd, bwd, upd = collections.Counter(), collections.Counter(), collections.Counter()
        if m > 1:
            fwd.update({"all-gather": 1, "all-reduce": 1 + 2 * L})
            bwd["all-reduce"] += 2 * L + 1
            upd["all-reduce"] += 1
        if d > 1:
            fwd["all-reduce"] += 1
            upd["all-reduce"] += n
        return {"forward": dict(fwd), "backward": dict(bwd), "update": dict(upd)}
    return {
        "moe": {"forward": {"all-gather": L, "all-reduce": L + 1},
                "backward": {"all-reduce": L, "reduce-scatter": L},
                "update": {"all-reduce": n - 3 + 1}},
        "ep": {"forward": {"all-reduce": 1, "all-to-all": 2 * L},
               "backward": {"all-to-all": 2 * L}, "update": {"all-reduce": n - 3 + 1}},
    }[part]


def fmt_ms(xs):
    return "[" + ", ".join(f"{x:.1f}" for x in xs) + "]"


def tally_counts(tally):
    return {ph: {k: v["count"] for k, v in by.items()} for ph, by in tally.items()}


@contextlib.contextmanager
def float64_math():
    """Inside, ``Tensor.float()`` leaves a float64 tensor float64: the port
    computes its norms, scans and optimizer moments through ``.float()``,
    so a float64 step under this context rounds nowhere to float32."""
    cast = torch.Tensor.float

    def keep(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else cast(self, *args, **kwargs)

    torch.Tensor.float = keep
    try:
        yield
    finally:
        torch.Tensor.float = cast


def p15_turns(store, tag, rank, world, fn, serial):
    """``fn()`` on every rank, then a barrier. ``serial``: each rank in
    turn, rank order, the others waiting, so that the unsharded step runs
    on one rank at a time (ranks sharing one card: memory); else all at
    once (a card each)."""
    if serial and rank:
        store.wait([f"{tag}/{rank - 1}"])
    out = fn()
    store.set(f"{tag}/{rank}", "1")
    store.wait([f"{tag}/{q}" for q in range(world)])
    return out


@contextlib.contextmanager
def counted_syncs():
    """Inside, each host sync is recorded: sync-debug "warn" warns once a
    sync (the backward's too: autograd replays its worker's warnings on
    the caller), and every warning is kept. Yields the list of the syncs'
    Python sites (``file:line`` of the call that synchronised), complete
    when the block ends."""
    import warnings

    found = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(0)
            found.extend(f"{Path(w.filename).name}:{w.lineno}" for w in seen
                         if "synchroniz" in str(w.message))


def p15_timed_steps(step, params, opt, batches, mesh, device, trace=None):
    """Runs ``step`` over ``batches``; per step: losses, ms, the mesh's
    collectives (tally) and their ms by phase and by (phase, kind)
    (``RankMesh.kind_seconds``: the host clock on gloo, CUDA events on
    NCCL, timed in a window opened for each step),
    and on the card its host syncs and their sites (``counted_syncs``).
    ``trace``: the last step runs under torch.profiler and its trace goes
    to that path; ``profile`` holds its device ops, busy ms, NCCL
    kernels' ms and wall ms."""
    out = {"loss": [], "aux": [], "ms": [], "tally": [], "coll_ms": [], "kind_ms": [],
           "syncs": [], "sync_sites": []}
    syncs = torch.device(device).type == "cuda"
    for i, b in enumerate(batches):
        mesh.reset_tally(timing=True)
        sync(device)
        profiled = trace is not None and i == len(batches) - 1
        with profiler() if profiled else contextlib.nullcontext() as prof:
            t = time.perf_counter()
            with counted_syncs() if syncs else contextlib.nullcontext() as found:
                params, opt, m = step(params, opt, b)
            loss = float(m["loss"])        # a host sync: the step has ended
            out["ms"].append((time.perf_counter() - t) * 1e3)
        if syncs:
            out["syncs"].append(len(found))
            out["sync_sites"].append(list(found))
        out["loss"].append(loss)
        out["aux"].append(float(m["aux_loss"]))
        out["tally"].append(mesh.tally())
        out["kind_ms"].append({f"{ph} {k}": v * 1e3
                               for (ph, k), v in mesh.kind_seconds.items()})
        out["coll_ms"].append({k: v * 1e3 for k, v in mesh.seconds.items()})
        if profiled:
            prof.export_chrome_trace(str(trace))
            n_ops, busy, by_name = device_time(Path(trace))
            out["profile"] = {
                "step": i, "ops": n_ops, "busy_ms": busy / 1e3, "wall_ms": out["ms"][-1],
                "nccl_ms": sum(v for k, v in by_name.items() if "nccl" in k.lower()) / 1e3}
    return params, opt, out


def profiler():
    """torch.profiler over the card's kernels."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def p15_part(mods, st, store, rank, world, device, tag, cfg, shape, extra=None, ref=True,
             bf16=False, repeat=False, compare_at=None, witness=False, trace=None):
    """One part of phase 15 on this rank: the dry run's count and bytes
    for the case; the fp32 sharded steps (TF32 off) from phase 5's seeded
    weights on ``sharded_batches``; with ``ref``, the unsharded step on
    the same weights and global batches, each rank in turn, against this
    rank's shards of the params and both moments after ``compare_at``
    steps (all of them by default); with ``bf16``, a bf16 run of
    ``bf16_steps`` on one repeated batch. ``repeat`` trains the fp32 run
    on one repeated batch too (``ep_steps`` of them). An MoE part records
    each layer's expert ids in both runs (``route_flips``: the tokens
    whose ids differ, by step and layer). ``witness``: the shards are
    also compared after every step (``errs_steps``, each step's worst
    leaf, ungated), and rank 0 runs the unsharded step a second time from
    its weights perturbed by up to one float32 ulp, in lockstep, against
    the first (``ulp_steps``): the spread that rounding alone grows to;
    and the compared steps run again in float64 (``float64_math``),
    sharded and unsharded from the same weights widened, each rank's
    shards of the two compared after each of them (``f64``, by step,
    gated to ``F64_TOL``: a sharding fault would show at any precision,
    rounding at float64's; step s is run from the weights, s steps, since
    two float64 copies of a model may not fit one card at once), and the
    float32 step 1 against the float64 unsharded one (``f64_sharded``,
    ``f64_unsharded``): which of the two float32 steps lies nearer. The
    ranks run the unsharded steps one at a time (``p15_turns``) where
    their groups are gloo (two ranks share one card), else all at once,
    each on its own card. On the card each step's host syncs are counted, sharded
    and unsharded (``counted_syncs``). ``trace``: the last step of the
    last sharded run is profiled there (``p15_timed_steps``). Each of the
    mesh's groups runs one all-reduce before the first step (an NCCL
    communicator forms at its first collective), timed apart
    (``warm_s``)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.models import moe as MOE

    T, SH, OPT, TR, DP, DR, RankMesh, InputShape = mods
    timeout = datetime.timedelta(seconds=600)
    mesh = RankMesh.build(dist.PrefixStore(tag, store), P15_AXES, shape, rank, device, timeout)
    rules = dict(SH.rules_for(cfg, mesh), mesh=mesh, **(extra or {}))
    dcfg = DP.DataConfig(seq_len=st["seq"], global_batch=st["batch"])
    ocfg = OPT.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    out = {"shape": shape, "layers": cfg.num_layers, "warm_s": warm_groups(mesh, device)}
    syncs = torch.device(device).type == "cuda"
    serial = any(pg.name() != "nccl" for pg in mesh.groups.values())

    # the dry run of the same case: rank's meta inputs, counted step
    dry = RankMesh.dry(P15_AXES, shape, rank)
    _, drules, dstep, dargs = DR.input_specs(
        cfg.name, InputShape(tag, "train", st["seq"], st["batch"]), dry, dtype="float32",
        moments_dtype="float32", rules_override=extra, cfg_override=cfg, remat=False)
    out["dry_bytes"] = DR.tree_bytes(dargs[0]) + DR.tree_bytes(dargs[1])
    _, dtally, out["dry_memory"] = DR.run_step(drules, dstep, dargs)
    out["dry"] = tally_counts(dtally)
    del dargs

    reset_peak(device)
    full = T.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), "float32")
    specs = SH.param_specs(cfg, full, rules, mesh)
    params = SH.shard_params(full, specs, mesh)
    del full
    reset_peak(device)
    out["start"] = peak_bytes(device)
    opt = OPT.init_opt_state(params)
    n = (st["ep_steps"] if repeat else st["moe_steps"] if cfg.num_experts
         else st["steps"])
    k = compare_at or n
    audio = cfg.family == "audio"
    batches = list(DP.sharded_batches(cfg, dcfg, mesh, SH.batch_specs(rules)["tokens"], n,
                                      frames=audio))
    if repeat:
        batches = [batches[0]] * n
    routes, ref_routes = [], []

    def routing(sink):     # each moe.route call's (args, (weights, ids, aux))
        return recorded(MOE, "route", sink) if cfg.num_experts else contextlib.nullcontext()

    def trees(p, o):
        return (("params", p), ("mu", o["mu"]), ("nu", o["nu"]))

    snap_at = set(range(1, n + 1)) if witness else {k}
    hosts, run = {}, None
    with routing(routes):
        step = TR.make_train_step(cfg, ocfg)
        for i, b in enumerate(batches):
            last = trace if (not bf16 and i + 1 == len(batches)) else None
            with SH.use_rules(rules):
                params, opt, one = p15_timed_steps(step, params, opt, [b], mesh, device,
                                                   trace=last)
            profile = one.pop("profile", None)
            run = one if run is None else {key: run[key] + v for key, v in one.items()}
            if profile:
                run["profile"] = dict(profile, step=i)
            if i + 1 in snap_at:
                hosts[i + 1] = {name: {p: t.to("cpu", copy=True)
                                       for p, t in OPT.tree_items(tree)}
                                for name, tree in trees(params, opt)}
        out["bytes"] = sum(t.numel() * t.element_size()
                           for t in [*tree_leaves(params), *tree_leaves(opt)])
    out.update(run, peak=peak_bytes(device), compared_steps=k)
    del params, opt
    reset_peak(device)

    def rel_errs(p, o, other):
        """Relative L2 of each leaf of ``other(name, path, leaf)`` against
        the leaf of (p, o) (this rank's shard of it where ``shard``)."""
        errs = {}
        for name, tree in trees(p, o):
            for path, leaf in OPT.tree_items(tree):
                want, got = other(name, path, leaf)
                den = want.norm().item()
                errs[f"{name}/{'/'.join(path)}"] = ((got - want).norm().item() / den
                                                    if den else (got - want).norm().item())
        return errs

    def worst(errs):
        w = max(errs, key=errs.get)
        return w, errs[w]

    def twin_batch(i):   # the unsharded step's global batch i
        b = DP.synth_batch(cfg, dcfg, 0 if repeat else i, device)
        if audio:
            b["frames"] = DP.synth_frames(cfg, dcfg, 0 if repeat else i, device)
        return b

    spec_of = dict(OPT.tree_items(specs))
    if ref:

        def against_host(at):
            return lambda name, path, leaf: (
                SH.shard_leaf(leaf, spec_of[path], mesh).float(),
                hosts[at][name][path].to(device).float())

        def reference():
            reset_peak(device)
            gen = torch.Generator(device=device).manual_seed(SEED)
            p = T.init_params(cfg, gen, "float32")
            o = OPT.init_opt_state(p)
            control = witness and rank == 0
            if control:   # every weight times (1 + u 2^-23), |u| <= 1
                gen.manual_seed(SEED + 15)
                pp = {path: t * (1 + (torch.rand(t.shape, generator=gen, device=device) * 2
                                      - 1) * 2.0 ** -23) for path, t in OPT.tree_items(p)}
                pp = OPT.tree_from(list(pp), list(pp.values()))
                oo = OPT.init_opt_state(pp)
            step = TR.make_train_step(cfg, ocfg)
            losses, ms, errs, ulp, n_syncs, sites = [], [], {}, {}, [], []
            with routing(ref_routes):
                for i in range(n):
                    b = twin_batch(i)
                    sync(device)
                    t = time.perf_counter()
                    with counted_syncs() if syncs else contextlib.nullcontext() as found:
                        p, o, m = step(p, o, b)
                    losses.append(float(m["loss"]))
                    ms.append((time.perf_counter() - t) * 1e3)
                    if syncs:
                        n_syncs.append(len(found))
                        sites.append(list(found))
                    if i + 1 in hosts:
                        errs[i + 1] = rel_errs(p, o, against_host(i + 1))
                    if control:
                        pp, oo, _ = step(pp, oo, b)
                        other = {name: dict(OPT.tree_items(tree))
                                 for name, tree in trees(pp, oo)}
                        ulp[i + 1] = worst(rel_errs(p, o, lambda name, path, leaf: (
                            leaf, other[name][path])))
            peak = peak_bytes(device)
            del p, o
            reset_peak(device)
            return {"ref_loss": losses, "ref_ms": ms, "errs": errs[k], "ref_peak": peak,
                    "ref_syncs": n_syncs, "ref_sync_sites": sites,
                    "errs_steps": {s: worst(e) for s, e in errs.items()} if witness else None,
                    "ulp_steps": ulp or None}

        out.update(p15_turns(store, f"{tag}/ref", rank, world, reference, serial))
        out["route_flips"] = [int((a[1][1] != b[1][1]).any(-1).sum())
                              for a, b in zip(routes, ref_routes)]

    def widened():   # the seeded weights in float64, and them in float32
        p = T.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), "float32")
        return OPT.tree_map(lambda t: t.to(torch.float64, copy=True), p), p

    f64 = {}
    for s in range(1, k + 1) if witness else ():
        with float64_math():   # s steps sharded, then s unsharded, both in float64
            p64 = SH.shard_params(widened()[0], specs, mesh)
            o64 = OPT.init_opt_state(p64)
            with SH.use_rules(rules):
                for b in batches[:s]:
                    p64, o64, _ = step(p64, o64, b)
            hosts64 = {name: {q: t.to("cpu", copy=True) for q, t in OPT.tree_items(tree)}
                       for name, tree in trees(p64, o64)}
            del p64, o64
        reset_peak(device)

        def unsharded64():
            got = {}
            with float64_math():
                p64, p = widened()
                if s > 1:
                    del p
                o64 = OPT.init_opt_state(p64)
                for i in range(s):
                    p64, o64, _ = step(p64, o64, twin_batch(i))
                got[s] = rel_errs(p64, o64, lambda name, path, leaf: (
                    SH.shard_leaf(leaf, spec_of[path], mesh), hosts64[name][path].to(device)))
            if s == 1:   # each float32 step 1 against the float64 unsharded one
                got["f64_sharded"] = rel_errs(p64, o64, lambda name, path, leaf: (
                    SH.shard_leaf(leaf, spec_of[path], mesh),
                    hosts[1][name][path].to(device).double()))
                p, o, _ = step(p, OPT.init_opt_state(p), twin_batch(0))
                mine = {name: dict(OPT.tree_items(tree)) for name, tree in trees(p, o)}
                del p, o
                got["f64_unsharded"] = rel_errs(p64, o64, lambda name, path, leaf: (
                    leaf, mine[name][path].double()))
                del mine
            del p64, o64
            reset_peak(device)
            return got

        got = p15_turns(store, f"{tag}/f64/{s}", rank, world, unsharded64, serial)
        del hosts64
        f64[s] = got.pop(s)
        out.update(got)
    if witness:
        out["f64"] = f64
    del hosts, batches

    if bf16:
        full = T.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), "bfloat16")
        params = SH.shard_params(full, SH.param_specs(cfg, full, rules, mesh), mesh)
        del full
        reset_peak(device)
        opt = OPT.init_opt_state(params)
        b = next(DP.sharded_batches(cfg, dcfg, mesh, SH.batch_specs(rules)["tokens"], 1))
        with SH.use_rules(rules):
            params, opt, run = p15_timed_steps(TR.make_train_step(cfg, ocfg), params, opt,
                                               [b] * st["bf16_steps"], mesh, device,
                                               trace=trace)
        out["bf16"] = dict(run, peak=peak_bytes(device))
        del params, opt
        reset_peak(device)
    return out


def warm_groups(mesh, device):
    """One all-reduce on each of ``mesh``'s groups, each timed (s, host
    clock, synchronised): an NCCL communicator forms at its group's
    first collective, which a step should not time."""
    out = {}
    for axis, pg in mesh.groups.items():
        sync(device)
        t = time.perf_counter()
        pg.allreduce([torch.zeros(1, device=device)]).wait()
        sync(device)
        out[axis] = time.perf_counter() - t
    return out


def sharded_train_rank(rank, world, port, results, device="cuda"):
    """One rank of phase 15, a spawned process: its meshes on the card
    (gloo groups over a ``TCPStore``) and the parts of the module
    docstring; puts (rank, measurements) on ``results``. ``device="cpu"``
    rehearses the phase without a card (reduced configs)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import pipeline as DP
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.mesh import RankMesh
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train as TR

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (PD.paged_decode_attention, FA.flash_attention, DA.decode_attention, SS.ssd_scan)
    before = [k.launches for k in kernels]
    st = p15_settings(device)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=600))
    mods = (T, SH, OPT, TR, DP, DR, RankMesh, InputShape)
    res = {"device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}
    args = (mods, st, store, rank, world, device)
    cfg = p13_config(get_config, "tinyllama-1.1b", st, layers=P15_TP_LAYERS)
    dp_cfg = p13_config(get_config, "tinyllama-1.1b", st, layers=P15_DP_LAYERS)
    mcfg = p13_config(get_config, MOE_ARCH, st, layers=st["moe_layers"], experts=12)
    scfg = p13_config(get_config, SSM_ARCH, st, cut=FAMILY13["ssm"][1])
    acfg = p13_config(get_config, AUDIO_ARCH, st, cut=FAMILY13["audio"][1])
    for part, tag, c, shape, kw in (
            ("tp", "15a", cfg, (1, 2), dict(bf16=True)),
            ("dp", "15b", dp_cfg, (2, 1), dict(bf16=True)),
            ("moe", "15c", mcfg, (2, 1), dict(compare_at=1)),
            ("ep", "15c-a2a", mcfg, (2, 1), dict(extra={"moe_a2a": True}, ref=False,
                                                 repeat=True)),
            # gated after its first step, as 15c: the witness shows the
            # unsharded step 1 ulp apart from itself drift past 1e-4
            ("ssm", "15e", scfg, (1, 2), dict(witness=True, compare_at=1)),
            ("audio", "15f", acfg, (2, 1), {})):
        t = time.perf_counter()
        res[part] = p15_part(*args, tag, c, shape, **kw)
        res[part]["predicted"] = p15_predicted(T, c, part)
        res[part]["seconds"] = time.perf_counter() - t
    res["launches"] = (before, [k.launches for k in kernels])
    results.put((rank, res))


def p15_gates(part, r, on_card):
    """Phase 15's gates on one rank's result of one part."""
    want = r["predicted"]
    for i, t in enumerate(r["tally"]):
        if tally_counts(t) != want:
            raise AssertionError(f"{part}: step {i}'s collectives {tally_counts(t)}, "
                                 f"predicted {want}")
    if r["dry"] != want:
        raise AssertionError(f"{part}: the dry run counts {r['dry']}, predicted {want}")
    if r["bytes"] != r["dry_bytes"]:
        raise AssertionError(f"{part}: {r['bytes']} B of params and moments, the dry run "
                             f"{r['dry_bytes']}")
    if "ref_loss" in r:
        k = r["compared_steps"]
        if any(r["route_flips"][:k * r["layers"]]):
            raise AssertionError(f"{part}: expert ids differ from the unsharded step's in the "
                                 f"compared steps: {r['route_flips']}")
        # every step's loss, but where routing may flip after the first
        for got, ref in zip(r["loss"][:k] if r["route_flips"] else r["loss"], r["ref_loss"]):
            if abs(got - ref) > 1e-5 * abs(ref):
                raise AssertionError(f"{part}: loss {got} against the unsharded {ref}")
        # a float64 witness gates the shards after every compared step
        # where it runs: in float32 the unsharded step alone lies past 1e-4
        # of the float64 one (15e)
        for at, errs, tol in ([(at, e, F64_TOL) for at, e in r["f64"].items()] if "f64" in r
                              else [(k, r["errs"], 1e-4)]):
            worst = max(errs, key=errs.get)
            if errs[worst] > tol:
                raise AssertionError(f"{part}: {worst} {errs[worst]:.3e} from the unsharded "
                                     f"step after step {at}"
                                     f"{' in float64' if 'f64' in r else ''} (tol {tol})")
    else:   # the expert-parallel dispatch: no unsharded twin (ROADMAP C3)
        if not (np.isfinite(r["aux"]).all() and r["loss"][-1] < r["loss"][0]):
            raise AssertionError(f"{part}: aux {r['aux']}, loss {r['loss']}")
    if "bf16" in r:
        losses = r["bf16"]["loss"]
        fall = losses[0] - losses[-1]
        if not np.isfinite(losses).all() or fall <= (TRAIN_FALL if on_card else 0.0):
            raise AssertionError(f"{part} bf16: losses {losses}")


def witness_lines(what, rs):
    """The lines of a part's witness (``p15_part(witness=True)``) over
    its ranks' results ``rs``: the float32 shards against the unsharded
    step after each step, beside the ulp control (rank 0), then the
    float64 comparison of each compared step and, by leaf, each float32
    step 1 against the float64 unsharded one."""
    if not rs[0].get("errs_steps"):
        return []

    def fmt(steps):
        return ", ".join(f"step {i}: {k} {v:.3e}" for i, (k, v) in sorted(steps.items()))

    ranks = list(enumerate(rs))
    out = [f"[sharded-train] {what}, witness (ungated): the worst shard after each step "
           f"against the unsharded step, "
           + "; ".join(f"rank {i}: {fmt(r['errs_steps'])}" for i, r in ranks)
           + f"; the unsharded step from its weights perturbed by up to one float32 ulp "
           f"against itself unperturbed: {fmt(rs[0]['ulp_steps'])} (rounding alone, grown "
           f"by Adam's u = m / (sqrt(v) + eps) where a gradient entry is near eps)"]
    worst = {}
    for at in rs[0]["f64"]:
        w = max(((i, key, v) for i, r in ranks for key, v in r["f64"][at].items()),
                key=lambda t: t[2])
        worst[at] = f"{w[1]} {w[2]:.3e} (rank {w[0]})"
    near = {key: [(f"rank {i}", r["f64_sharded"][key], r["f64_unsharded"][key])
                  for i, r in ranks]
            for key in sorted({max(r[x], key=r[x].get) for _, r in ranks
                               for x in ("errs", "f64_sharded", "f64_unsharded")})}
    out.append(f"[sharded-train] {what}, float64 witness of steps "
               f"{', '.join(map(str, worst))} (gate "
               f"{F64_TOL}): the sharded steps against the unsharded ones, both in float64 "
               f"from the same weights, worst shard after each step {worst}; the float32 "
               f"sharded and unsharded step 1 against the float64 unsharded one, by leaf "
               f"(rank, sharded, unsharded): "
               + "; ".join(f"{key} " + ", ".join(f"({a}, {b:.3e}, {c:.3e})" for a, b, c in v)
                           for key, v in near.items()))
    return out


def sharded_train_phase(TR, smi, kernel_fns, device="cuda"):
    """Phase 15: spawns the two ranks, waits for both (a rank that fails
    fails the phase), prints and gates their parts, and gates the four
    kernel counters unchanged on both ranks and here (15d)."""
    import multiprocessing as mp
    import queue

    before = [k.launches for k in kernel_fns]
    port = int(TR.free_tcp_endpoint().rsplit(":", 1)[1])
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=sharded_train_rank, args=(r, TRAIN_RANKS, port, results, device))
             for r in range(TRAIN_RANKS)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + 900
        while len(got) < TRAIN_RANKS:
            try:
                rank, res = results.get(timeout=5)
                got[rank] = res
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"phase 15: a rank failed (exit codes "
                                         f"{[p.exitcode for p in procs]})")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if [p.exitcode for p in procs] != [0] * TRAIN_RANKS:
        raise AssertionError(f"phase 15 exit codes {[p.exitcode for p in procs]}")
    on_card = torch.device(device).type == "cuda"
    log(f"[sharded-train] {TRAIN_RANKS} rank processes on one card ({got[0]['device']}) in "
        f"gloo groups: two ranks sharing one card measure the program (every collective "
        f"staged through the host), not the gain of sharding [{smi}]")
    names = {"tp": "15a tensor parallel (1, 2)", "dp": "15b data parallel (2, 1)",
             "moe": "15c moe scatter dispatch (2, 1)", "ep": "15c moe all-to-all dispatch (2, 1)",
             "ssm": "15e mamba2-780m head-split (1, 2)",
             "audio": "15f whisper-medium data parallel with frames (2, 1)"}
    for part, what in names.items():
        r0, r1 = got[0][part], got[1][part]
        tokens = p15_settings(device)["batch"] * p15_settings(device)["seq"]
        # the first step of a run warms up (allocator, cuBLAS, gloo buffers)
        step_ms = median(r0["ms"][1:])
        coll = {ph: median([c.get(ph, 0.0) for c in r0["coll_ms"][1:]])
                for ph in ("forward", "backward", "update")}
        nbytes = {ph: {k: v["bytes"] for k, v in by.items()} for ph, by in r0["tally"][0].items()}
        log(f"[sharded-train] {what}: {r0['layers']} layers, fp32, collectives per step "
            f"{r0['predicted']} = predicted = the dry run's (launch.dryrun); their bytes "
            f"{nbytes}; params + moments {r0['bytes']} B a rank = the dry run's "
            f"per_device_arg_bytes params + opt_state")
        line = (f"[sharded-train] {what}: step ms {fmt_ms(r0['ms'])} (warm median {step_ms:.1f}, "
                f"{tokens / step_ms * 1e3:.0f} tokens/s of both ranks); staged-collective ms "
                f"a step (rank 0, host clock) forward {coll['forward']:.1f}, backward "
                f"{coll['backward']:.1f}, update {coll['update']:.1f}; peak device memory "
                f"{r0['peak']} / {r1['peak']} B (ranks 0 / 1)")
        if "ref_loss" in r0:
            errs = {**r0["errs"], **{k + " (rank 1)": v for k, v in r1["errs"].items()}}
            worst = max(errs, key=errs.get)
            line += (f"; the unsharded step {fmt_ms(r0['ref_ms'])} ms (peak {r0['ref_peak']} "
                     f"B); losses {[f'{x:.6f}' for x in r0['loss']]} against "
                     f"{[f'{x:.6f}' for x in r0['ref_loss']]} (gated over the first "
                     f"{r0['compared_steps'] if r0['route_flips'] else len(r0['loss'])}); "
                     f"worst shard after step "
                     f"{r0['compared_steps']}: {worst} {errs[worst]:.3e} "
                     + ("(ungated: the float64 witness below gates the shards)"
                        if "f64" in r0 else "(tol 1e-4)"))
            if r0["route_flips"]:
                line += (f"; tokens whose expert ids differ from the unsharded step's, by "
                         f"step and layer: {r0['route_flips']}")
        else:
            line += (f"; losses {[f'{x:.4f}' for x in r0['loss']]} on one repeated batch, aux "
                     f"{[f'{x:.4f}' for x in r0['aux']]} (routes per rank: no unsharded twin)")
        log(line + f"; part {r0['seconds']:.1f} s [{smi}]")
        for ln in witness_lines(what, [r0, r1]):
            log(f"{ln} [{smi}]")
        for r in (r0, r1):
            p15_gates(part, r, on_card)
        if part == "tp":   # the dry run's memory prediction of the rank's step
            for i, r in enumerate((r0, r1)):
                m = r["dry_memory"]
                memory_gate(f"[sharded-train] {what}, rank {i}", m["argument_size_in_bytes"],
                            m["temp_size_in_bytes"], r["peak"], r["start"], on_card, smi,
                            "launch.dryrun on RankMesh.dry, the same case; measured over "
                            "the optimizer state's init and the fp32 steps")
        if any(abs(a - b) > 1e-6 * abs(b) for a, b in zip(r0["loss"], r1["loss"])):
            raise AssertionError(f"{part}: the ranks' losses differ: {r0['loss']} / {r1['loss']}")
        if "bf16" in r0:
            b = r0["bf16"]
            log(f"[sharded-train] {what}, bf16: {len(b['loss'])} steps on one repeated batch, "
                f"loss {b['loss'][0]:.4f} -> {b['loss'][-1]:.4f} (gate: falls more than "
                f"{TRAIN_FALL}), warm step median {median(b['ms'][1:]):.1f} ms, update "
                f"collectives median "
                f"{median([c.get('update', 0.0) for c in b['coll_ms'][1:]]):.1f} ms, peak "
                f"{b['peak']} B [{smi}]")
    for r in (0, 1):
        a, b = got[r]["launches"]
        if a != b:
            raise AssertionError(f"phase 15 rank {r}: kernel launches {a} -> {b}")
    after = [k.launches for k in kernel_fns]
    if after != before:
        raise AssertionError(f"kernel launches during phase 15: {before} -> {after}")
    log(f"[sharded-train] 15d kernel launches unchanged across phase 15: here {after}, rank 0 "
        f"{got[0]['launches'][1]}, rank 1 {got[1]['launches'][1]} (paged, flash, decode, SSD)")


# ------------------------------------- published widths: the paper's models
#: phase 16's models: the paper's own evaluation model and three assigned
#: configurations, each at its published width and depth in bf16
WIDE_ARCHS = ("llama2-13b", "gemma-7b", "stablelm-12b", "chameleon-34b")
#: the models also served through the dense engine (16b): D 256 and D 160
WIDE_DENSE = ("gemma-7b", "stablelm-12b")
#: the fp32 cut of each model (its first layers widened): an fp32 copy of a
#: whole model would not fit beside the bf16 one, nor chameleon-34b's cut
#: beside its 68.6 GB (that cut is widened after the model is freed)
WIDE_FP32_LAYERS = {"llama2-13b": 2, "gemma-7b": 2, "stablelm-12b": 2,
                    "chameleon-34b": 2}
#: an init_params peak may exceed the weights by at most this (the draw
#: holds one fp32 layer slice, <= 0.27 GB, beside its result)
INIT_SLACK = 2e9


def wide_bound(T, MIG, cfg, params):
    """Weight bytes a decode step reads (every weight but the embedding
    table, of which it reads a row a token; a tied table is read whole as
    the head) and their least time at the card's memory rate, without the
    K/V the step reads."""
    step = MIG.tree_bytes(params)
    if not cfg.tie_embeddings:
        step -= MIG.tree_bytes(params, "^embed")
    return step, step / HBM_BYTES_PER_S * 1e3


def to_host(tree):
    """A copy of a tensor tree in host memory."""
    return _tree_map(lambda t: t.to("cpu", copy=True), tree)


def cut_params(params, n):
    """The first ``n`` layers of a dense decoder's weights, with its
    embedding, final norm and head."""
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": _tree_map(lambda t: t[:n], params["layers"])}


def wide_fp32_cut(T, what, cfg, stash, smi):
    """The first layers of a model widened to fp32 (weights and the live
    pool or cache a probe stashed in host memory), one decode step through
    the kernel and the gather route (TF32 off): logits within 1e-4 and
    each row's greedy token equal. Returns the relative L2 error."""
    n = stash["layers"]
    cut = dataclasses.replace(cfg, num_layers=n)

    def fresh(t):  # a new card copy, floating leaves in fp32
        return t.cuda().to(torch.float32 if t.is_floating_point() else t.dtype, copy=True)

    p32 = _tree_map(fresh, stash["params"])
    logits = {}
    for impl in ("kernel", "gather"):
        state = _tree_map(fresh, stash["state"])  # each route writes its step
        if "pool" in stash:
            out = T.forward_paged(p32, cut, stash["tokens"].cuda(), state,
                                  attn_impl=impl)[0]
        else:
            out = T.forward(p32, cut, stash["tokens"].cuda(), stash["positions"].cuda(),
                            state, mode="decode", attn_impl=impl)[0]
        logits[impl] = out[stash["rows"], : cfg.vocab_size]
        del state
    rel = gate_rel(f"{what}: the first {n} layers in fp32, kernel vs gather",
                   logits["kernel"], logits["gather"], tol=1e-4)
    tok_k, tok_g = logits["kernel"].argmax(-1), logits["gather"].argmax(-1)
    if not torch.equal(tok_k, tok_g):
        raise AssertionError(f"{what}: fp32 greedy tokens differ: {tok_k.tolist()} / "
                             f"{tok_g.tolist()}")
    log(f"[wide] {what}: the first {n} of {cfg.num_layers} layers widened to fp32, "
        f"one decode step kernel vs gather: logits relative L2 {rel:.3e} (tol 1e-4), "
        f"greedy tokens equal in all {len(tok_k)} rows [{smi}]")
    return rel


def wide_paged(mods, cfg, params, out_dir, smi, bound_ms):
    """16a: ``cfg`` through the paged engine at phase 5's settings and
    workload (``serve_graphs_and_eager``'s gated runs, graphs and eager,
    cold and warm); then a third workload of the same lengths on the warm
    graph engine (no capture), whose first steady step is probed on the
    live pool: each paged call against its plain version (2e-2) and the
    bf16 logits kernel vs gather (2e-2), the fp32 cut stashed in host
    memory for ``wide_fp32_cut``; and a profiled window. Returns (paged
    launches of the cold graph run, the fp32 stash)."""
    Engine, RS, SP, PD, GR, T = mods
    prompts, sampled = workload(cfg)
    warm_prompts, _ = workload(cfg, seed=SEED + 1)
    probe_prompts, _ = workload(cfg, seed=SEED + 2)
    engine_args = (Engine, RS, SP, cfg, params)
    n = WIDE_FP32_LAYERS[cfg.name]
    calls, busy, out, stash = {}, {}, {}, {}

    def probe(eng):
        tk, act, handle = paged_probe_inputs(eng)
        rows = torch.from_numpy(act).cuda()
        with checked_kernel_calls(calls):
            got = T.forward_paged(eng.params, cfg, tk, handle, attn_impl="kernel")[0]
        want = T.forward_paged(eng.params, cfg, tk, handle, attn_impl="gather")[0]
        out["rel"] = gate_rel(f"{cfg.name} paged kernel vs gather logits (bf16)",
                              got[rows, : cfg.vocab_size], want[rows, : cfg.vocab_size])
        stash.update(layers=n, tokens=tk.cpu(), rows=rows.cpu(), pool=True,
                     params=to_host(cut_params(eng.params, n)),
                     state=to_host(dict(handle, k=handle["k"][:n], v=handle["v"][:n])))
        profile_decode(eng, out_dir, smi, tag=f"_{cfg.name}", sink=busy, keep_trace=False)

    runs = serve_graphs_and_eager(
        engine_args, PD, GR, (prompts, warm_prompts, sampled), smi,
        after=lambda eng: run_engine(*engine_args, "kernel", probe_prompts, sampled,
                                     probe=probe, eng=eng))
    launches, stats = runs["graphs"][3], runs["graphs"][2]
    worst = max(calls.get("paged", [float("inf")]))
    if len(calls.get("paged", ())) != cfg.num_layers or worst > 2e-2:
        raise AssertionError(f"{cfg.name}: {len(calls.get('paged', ()))} paged calls "
                             f"checked, worst relative L2 {worst}")
    ms = stats["steady_step_ms"]
    median_ms = ms[len(ms) // 2]
    tag = f"_{cfg.name}"
    log(
        f"[wide] {cfg.name} paged: one decode step on the live pool, each of the "
        f"{cfg.num_layers} bf16 paged calls against its plain version, worst relative L2 "
        f"{worst:.3e} (tol 2e-2); logits kernel vs gather {out['rel']:.3e} (tol 2e-2); "
        f"graphs, cold: steady step median {median_ms:.3f} ms (min {ms[0]:.3f}, max "
        f"{ms[-1]:.3f}) against the weight-read bound {bound_ms:.3f} ms "
        f"({bound_ms / median_ms:.1%} of bound); eager "
        f"{runs['eager'][2]['steady_step_ms'][len(runs['eager'][2]['steady_step_ms']) // 2]:.3f} "
        f"ms; device busy {busy[tag]:.3f} ms per steady step (profiled), idle share "
        f"outside the profiler {1 - busy[tag] / median_ms:.3f} [{smi}]"
    )
    return launches, stash


def wide_dense(mods, cfg, params, smi):
    """16b: ``cfg`` through the dense engine at phase 10's settings
    (``serve_dense``'s gated graph runs, cold and warm: dense-decode
    launches = layers x steps), then a probe of the first steady step on the live cache: each
    dense-decode call against its plain version (2e-2) and the bf16
    logits kernel vs gather (2e-2), the fp32 cut stashed in host memory.
    Returns (dense-decode launches of the cold graph run, the fp32
    stash)."""
    Engine, RS, SP, DA, SS, GR, T = mods
    prompts, sampled = workload(cfg)
    warm_prompts, _ = workload(cfg, seed=SEED + 1)
    runs = serve_dense(mods[:6], cfg, params, (prompts, warm_prompts, sampled), smi,
                       cfg.num_layers, 0, "wide", eager=False)
    n = WIDE_FP32_LAYERS[cfg.name]
    calls, out, stash = {}, {}, {}

    def probe(e):
        with checked_kernel_calls(calls):
            out["kernel"] = dense_decode_logits(T, e, attn_impl="kernel")
        out["gather"] = dense_decode_logits(T, e, attn_impl="gather")
        toks = np.zeros((e.max_batch,), np.int64)
        for s, r in e.active.items():
            toks[s] = r.generated[-1]
        cache = dict(e.cache, layers=_tree_map(lambda t: t[:n], e.cache["layers"]))
        stash.update(layers=n, tokens=torch.from_numpy(toks[:, None]),
                     positions=torch.from_numpy(e._host_lengths[:, None].astype(np.int32)),
                     rows=torch.tensor(sorted(e.active)),
                     params=to_host(cut_params(e.params, n)), state=to_host(cache))

    eng = Engine(cfg, params, device="cuda", **DENSE_KW)
    run_engine(Engine, RS, SP, cfg, params, None, prompts, sampled, probe=probe, eng=eng)
    del eng
    worst = max(calls.get("decode", [float("inf")]))
    if len(calls.get("decode", ())) != cfg.num_layers or worst > 2e-2:
        raise AssertionError(f"{cfg.name}: {len(calls.get('decode', ()))} dense-decode "
                             f"calls checked, worst relative L2 {worst}")
    rel = gate_rel(f"{cfg.name} dense kernel vs gather logits (bf16)", out["kernel"],
                   out["gather"])
    log(f"[wide] {cfg.name} dense: one decode step on the live cache, each of the "
        f"{cfg.num_layers} bf16 dense-decode calls against its plain version, worst "
        f"relative L2 {worst:.3e} (tol 2e-2); logits kernel vs gather {rel:.3e} (tol "
        f"2e-2) [{smi}]")
    return runs["graphs"][3]["decode"], stash


def wide_serve(PD, GR, smi):
    """16c: the port's serving entry point, ``launch.serve.run``, at
    llama2-13b's published widths on two in-process instances (the live
    loop: Orchestrator -> Monitor -> Controller, scale-up degrees,
    scale-down migration). Gates: all 24 requests finish, none dropped,
    the paged kernel launched. Prints the controller's actions, the
    migrations (bytes, ms) and each engine's median decode step (steps
    with no prompt waiting or mid-prefill). Returns the paged launches."""
    from repro_torch.launch import serve as SV
    from repro_torch.serving import engine as ENG
    from repro_torch.serving import orchestrator as ORC

    seen, steps = {}, collections.defaultdict(list)
    step, close = ENG.Engine.step, ORC.Orchestrator.close

    def timed_step(self, *args, **kwargs):
        steady = bool(self.active) and not self.queue and not self.prefilling
        t = time.perf_counter()
        out = step(self, *args, **kwargs)
        if steady:
            steps[id(self)].append((time.perf_counter() - t) * 1e3)
        return out

    def closing(self):
        seen.update(stats=self.stats(), migrations=list(self.migrations),
                    launches=GR.launches_run(PD.paged_decode_attention,
                                             [e.graphs for e in self.engines]))
        return close(self)

    PD.paged_decode_attention.launches = 0
    ENG.Engine.step, ORC.Orchestrator.close = timed_step, closing
    t = time.perf_counter()
    try:
        n = SV.run(SV.ServeConfig(arch="llama2-13b", reduced=False, instances=2,
                                  requests=24, rps=4))
    finally:
        ENG.Engine.step, ORC.Orchestrator.close = step, close
    wall = time.perf_counter() - t
    st = seen["stats"]
    if n != 24 or st["finished"] != 24 or st["dropped"] or not seen["launches"]:
        raise AssertionError(f"launch.serve.run: {n} of 24 requests finished, dropped "
                             f"{st['dropped']}, paged launches {seen['launches']}")
    medians = [round(sorted(v)[len(v) // 2], 3) for v in steps.values()]
    moves = [(m.rid, m.src, m.dst, m.mode, m.bytes_moved, round(m.seconds * 1e3, 3))
             for m in seen["migrations"]]
    log(f"[wide] 16c launch.serve.run(arch=llama2-13b, reduced=False, instances=2, "
        f"requests=24, rps=4): {n} of 24 finished, dropped {st['dropped']}, in "
        f"{wall:.1f} s (weights drawn, captures included); controller actions "
        f"{st['controller_log']}; final plan P {st['plan_p'][:8]}; migrations executed "
        f"(rid, src, dst, mode, bytes, ms) {moves}; paged kernel launches "
        f"{seen['launches']}; decode steps per engine {[len(v) for v in steps.values()]}, "
        f"median ms {medians} [{smi}]")
    return seen["launches"]


def wide_kernel_times(PD, DA, get_config, mid_lens, width, smi):
    """Phase 3's rows for phase 16: the paged kernel at each model's decode
    shape, the dense-decode kernel at 16b's (with SDPA beside it)."""
    paged = {a: time_paged_decode(PD, get_config(a), mid_lens, width, smi)
             for a in WIDE_ARCHS}
    dense = {a: time_decode(DA, get_config(a), mid_lens, 1024, smi) for a in WIDE_DENSE}
    return paged, dense


def wide_rows(kernels, times, launches):
    """Phase 16's shapes and launches into the JSON line's paged-decode
    (``kernels[0]``) and dense-decode (``kernels[2]``) rows."""
    paged, dense = times
    for arch, (ms, plain_ms, bound_ms, bound_by) in paged.items():
        kernels[0]["shapes"].append({
            "model": f"{arch} (phase 16a)", "launches": launches["paged"][arch], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    kernels[0]["shapes"].append({
        "model": "llama2-13b through launch.serve.run (phase 16c, the shape timed above)",
        "launches": launches["serve"], "ms": None, "plain_ms": None, "bound_ms": None,
        "bound_by": None, "library_ms": None})
    kernels[0]["launches"] += sum(launches["paged"].values()) + launches["serve"]
    for arch, (ms, plain_ms, lib_ms, (bound_ms, bound_by)) in dense.items():
        kernels[2]["shapes"].append({
            "model": f"{arch} (phase 16b)", "timed": f"decode_{arch}",
            "launches": launches["decode"][arch], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    kernels[2]["launches"] += sum(launches["decode"].values())


# ------------------------------------------------------------ the gelu kernel
#: the gelu kernel's timed shapes: gemma-7b's GeGLU in a decode step of 8
#: rows and in a 600-token prefill (d_ff 24576), whisper-medium's MLP over
#: its 1500 encoder frames (d_ff 4096), bf16; its gradient at whisper's
#: train step of 8 x 128 tokens in fp32 (phases 14-15) and at gemma's
#: prefill in bf16
GELU_SHAPES = (("gemma-7b decode", (8, 1, 24576), torch.bfloat16),
               ("gemma-7b prefill", (1, 600, 24576), torch.bfloat16),
               ("whisper-medium encoder", (1, 1500, 4096), torch.bfloat16))
GELU_GRAD_SHAPES = (("whisper-medium train", (8, 128, 4096), torch.float32),
                    ("gemma-7b prefill", (1, 600, 24576), torch.bfloat16))


def check_gelu(GK):
    """The gelu kernel and its gradient against their plain versions (the
    op chain, a launch an op) on the card, in fp32 and bf16, at the timed
    shapes, at an odd length (the vector loop's scalar tail) and on a view
    one element off 16-byte alignment (the scalar loop); inputs normal x 3
    (gelu's flat tails), cotangents normal. Gate: every element equal, as
    the kernel rounds where the chain does. Returns the max abs error."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    shapes = sorted({s for _, s, _ in GELU_SHAPES + GELU_GRAD_SHAPES}) + [(1_000_003,)]
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes + [None]:
            if shape is None:     # 4098 elements one element past alignment
                x, g = randn(gen, (4099,), dtype, 3.0)[1:], randn(gen, (4099,), dtype)[1:]
            else:
                x, g = randn(gen, shape, dtype, 3.0), randn(gen, shape, dtype)
            for what, got, want in (("gelu", GK.gelu(x), GK.gelu_ref(x)),
                                    ("gradient", GK.gelu_grad(x, g), GK.gelu_grad_ref(x, g))):
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                differ = int((got != want).sum())
                if differ or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"gelu kernel, {what} {dtype} {tuple(x.shape)}: "
                                         f"{differ} of {x.numel()} elements differ from the "
                                         f"plain version's, max abs {err:.3e}")
                worst, n = max(worst, err), n + x.numel()
    log(f"[kernel] gelu and its gradient in fp32 and bf16 at {shapes} and on a misaligned "
        f"view: all {n} elements of each equal to the plain version's (max abs err "
        f"{worst:.3e}; gate: bit-equal)")
    return worst


def time_gelu(GK, what, shape, dtype, grad, smi):
    """The gelu kernel (or its gradient) at ``shape``: kernel, plain
    version and torch's fused tanh-form gelu (``F.gelu`` or
    ``aten.gelu_backward``, which rounds once: the same function, other
    roundings) over input sets that exceed the L2 cache; the bound reads
    x (and g) once and writes the output once."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    n = int(np.prod(shape))
    nbytes = (3 if grad else 2) * n * torch.empty((), dtype=dtype).element_size()
    if grad:
        calls = [(randn(gen, shape, dtype, 3.0), randn(gen, shape, dtype))
                 for _ in range(n_sets(nbytes))]
        fns = (GK.gelu_grad, GK.gelu_grad_ref,
               lambda x, g: torch.ops.aten.gelu_backward(g, x, approximate="tanh"))
    else:
        calls = [(randn(gen, shape, dtype, 3.0),) for _ in range(n_sets(nbytes))]
        fns = (GK.gelu, GK.gelu_ref, lambda x: F.gelu(x, approximate="tanh"))
    ms, plain_ms, lib_ms = time_calls(calls, *fns)
    # the chain's fp32 operations an element: 10 forward, 24 with the gradient
    bound = least_time_ms(nbytes, (24 if grad else 10) * n, dtype)
    name = "gelu_grad" if grad else "gelu"
    report(name, f"{what} {str(dtype)[6:]} {shape}", ms, plain_ms, lib_ms, bound, smi)
    return ms, plain_ms, lib_ms, bound


def gelu_row(name, times, launches, err, path):
    """A JSON row of the gelu kernel (``name``): the first timed shape's
    numbers, each shape's in ``shapes``, ``launches`` those of ``path``."""
    rows = [{"model": what, "shape": list(shape), "dtype": str(dtype)[6:], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": lib_ms}
            for (what, shape, dtype), (ms, plain_ms, lib_ms, bound) in times]
    top = rows[0]
    return {"name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/gelu.cu",
            "replaces": "src/repro/models/layers.py:457", "launches": launches,
            "max_abs_err": err, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "launches_on": path, "shapes": rows}


@contextlib.contextmanager
def step_graphs(GR, sink):
    """Inside, every ``serving.graphs.StepGraphs`` made is appended to
    ``sink`` (for ``launches_run`` over every engine of a phase)."""
    init = GR.StepGraphs.__init__

    def rec(self, *args, **kwargs):
        init(self, *args, **kwargs)
        sink.append(self)

    GR.StepGraphs.__init__ = rec
    try:
        yield sink
    finally:
        GR.StepGraphs.__init__ = init


def wide_phase(mods, get_config, out_dir, smi):
    """Phase 16 (module docstring). Returns {"paged": {arch: launches},
    "decode": {arch: launches}, "serve": launches}."""
    Engine, RS, SP, PD, DA, SS, GR, T, MIG = mods
    launches = {"paged": {}, "decode": {}}
    for arch in WIDE_ARCHS:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = T.init_params(cfg, gen, "bfloat16")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - before
        weight_bytes = MIG.tree_bytes(params)
        if weight_bytes != MIG.tree_bytes(T.init_params_meta(cfg, "bfloat16")):
            raise AssertionError(f"{arch}: {weight_bytes} B of weights")
        if peak > weight_bytes + INIT_SLACK:
            raise AssertionError(f"{arch}: init_params peaked at {peak} B for "
                                 f"{weight_bytes} B of weights")
        step_bytes, bound_ms = wide_bound(T, MIG, cfg, params)
        log(f"[wide] {arch}: {cfg.num_layers} layers, d={cfg.d_model}, H={cfg.num_heads}, "
            f"KV={cfg.num_kv_heads}, D={cfg.resolved_head_dim}, d_ff={cfg.d_ff} "
            f"({cfg.ffn_kind}), vocab={cfg.vocab_size}, tied {cfg.tie_embeddings}, qk-norm "
            f"{cfg.use_qk_norm}; device memory allocated before {before} B; bf16 weights "
            f"{weight_bytes} B in {init_s:.2f} s, init_params peak {peak} B (gate: weights "
            f"+ {INIT_SLACK:.0f} B); a decode step reads {step_bytes} B of weights, bound "
            f"{bound_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s [{smi}]")
        torch.cuda.reset_peak_memory_stats()
        paged, stash = wide_paged((Engine, RS, SP, PD, GR, T), cfg, params, out_dir,
                                  smi, bound_ms)
        launches["paged"][arch] = paged
        stashes = [("paged", stash)]
        if arch in WIDE_DENSE:
            dense, dstash = wide_dense((Engine, RS, SP, DA, SS, GR, T), cfg, params, smi)
            launches["decode"][arch] = dense
            stashes.append(("dense", dstash))
        log(f"[wide] {arch}: peak device memory allocated while serving "
            f"{torch.cuda.max_memory_allocated()} B [{smi}]")
        # the fp32 cuts after the bf16 model is freed (chameleon-34b's 21 GB
        # cut does not fit beside its 68.6 GB)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        for what, st in stashes:
            wide_fp32_cut(T, f"{arch} {what}", cfg, st, smi)
        del stashes, stash
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[wide] device memory allocated before 16c {torch.cuda.memory_allocated()} B")
    launches["serve"] = wide_serve(PD, GR, smi)
    return launches


# ------------------------------------------------- phase 17: the examples
EXAMPLE_BANNERS = {
    "quickstart": ("greedy tokens:", "paged engine rid=", "scale-up: replicated"),
    "shared_prefix": ("[sharing OFF]", "[sharing ON ]", "token-identical: True",
                      " saved, "),
}


def run_example(name, argv):
    """``examples/torch_<name>.py``'s ``main(argv)`` in this process; its
    standard output, which must hold the reference's banner lines."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(argv)
    text = out.getvalue()
    missing = [b for b in EXAMPLE_BANNERS[name] if b not in text]
    if missing:
        raise AssertionError(f"examples/torch_{name}.py: no {missing} in:\n{text}")
    return text


def examples_phase(smi):
    """The README's first quickstarts on the port, on the card, each
    in-process through its ``main``: ``torch_quickstart`` at
    tinyllama-1.1b's published width in bf16 (``--no-reduced``: the
    forward, the paged engine's CUDA graphs, the scale-up plan), then
    ``torch_shared_prefix`` (reduced, fp32); their banners printed."""
    for name, argv in (("quickstart", ["--no-reduced"]), ("shared_prefix", [])):
        t = time.perf_counter()
        text = run_example(name, argv)
        for line in text.splitlines():
            log(f"[examples] torch_{name}: {line}")
        log(f"[examples] torch_{name} {' '.join(argv)} in "
            f"{time.perf_counter() - t:.1f} s [{smi}]")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gelu as GK
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import moe as MOE
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    from repro_torch.core import migration as MIG
    from repro_torch.core.monitor import MetricsSnapshot
    from repro_torch.serving import graphs as GR
    from repro_torch.serving import instrument as INS
    from repro_torch.serving import paged_kv as PK
    from repro_torch.launch.pod import Node, launch_pod
    from repro_torch.serving import transport as TR
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.ingress import Ingress
    from repro_torch.serving.orchestrator import Orchestrator
    from repro_torch.serving.request import RequestSpec, SamplingParams

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    # phase 1: the card
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(
        f"[card] nvidia-smi: {smi}; torch: {kind}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}"
    )

    # phase 2: build
    t = time.perf_counter()
    libs = build.build_all()
    names = ", ".join(p.name for p in libs.values())
    log(f"[build] {names} in {time.perf_counter() - t:.2f} s")
    build_log = "\n".join(f"== {n}\n{s}" for n, s in build.build_logs.items())
    (out_dir / "chip_smoke_build.log").write_text(build_log)

    # phase 3: kernels against their plain versions
    cfg = get_config("tinyllama-1.1b")
    prompts, sampled = workload(cfg)
    mid_lens = [len(p) + 16 for p in prompts]  # halfway through decode
    err = check_paged_decode(PD, mid_lens)
    width = 64  # pow2 bucket of the widest table prefix on the main path
    wide_times = wide_kernel_times(PD, DA, get_config, mid_lens, width, smi)
    wide_mods = (Engine, RequestSpec, SamplingParams, PD, DA, SS, GR, T, MIG)
    ms, plain_ms, bound_ms, bound_by = time_paged_decode(PD, cfg, mid_lens, width, smi)
    # phase 9's shape: qwen2-moe-a2.7b's heads, the same lengths
    moe_paged = time_paged_decode(PD, get_config(MOE_ARCH), mid_lens, width, smi)
    # phase 12's: a replicated layer's call on one rank, rows 0-3 of 8
    repl_paged = time_paged_decode(PD, cfg, mid_lens[:4], width, smi)
    # phase 13h's: a rank's heads of tinyllama on model 2, and a rank's 4
    # of 8 rows of qwen2-moe on data 2
    tp_paged = time_paged_decode(PD, rank_heads(cfg), mid_lens, width, smi)
    ep_paged = time_paged_decode(PD, get_config(MOE_ARCH), mid_lens[:4], width, smi)
    # phase 10's serving shapes: mamba2-780m's and zamba2-7b's prefills,
    # whole and at a rank's heads on model 2 (phase 13e-f)
    mamba, zamba = get_config(SSM_ARCH), get_config(HYBRID_ARCH)
    serving_ssd = [
        shape for c in (mamba, zamba, rank_heads(mamba), rank_heads(zamba))
        for shape in serving_ssd_shapes(c, sorted({len(p) for p in prompts}))
    ]
    errs = {
        "flash": check_flash(FA, ops),
        "decode": check_decode(DA, mid_lens),
        "ssd": check_ssd(SS, serving_ssd),
    }
    log(
        f"[kernel] flash_attention bf16 tensor-core instructions (cuobjdump -sass "
        f"HGMMA count per kernel): "
        f"{hgmma_counts(libs['flash_attention'], FA.KERNEL_WIDTHS)}"
    )
    log(
        f"[kernel] ssd_scan bf16 tensor-core instructions (cuobjdump -sass HMMA "
        f"count per kernel): {hmma_counts(libs['ssd_scan'])}"
    )
    errs["gelu"] = check_gelu(GK)
    gemma, stablelm = get_config("gemma-7b"), get_config("stablelm-12b")
    timed = {
        "flash": time_flash(FA, 1, 2048, cfg.num_heads, cfg.num_kv_heads, 64, smi),
        "flash_gemma": time_flash(
            FA, 1, 2048, gemma.num_heads, gemma.num_kv_heads, gemma.head_dim, smi
        ),
        # the head dims the kernel took last: stablelm-12b's prefill (H 32,
        # KV 8, D 160) and zamba2-7b's attention (H = KV = 32, D 112)
        "flash_stablelm": time_flash(
            FA, 1, 2048, stablelm.num_heads, stablelm.num_kv_heads,
            stablelm.resolved_head_dim, smi,
        ),
        "flash_zamba": time_flash(
            FA, 1, 2048, zamba.num_heads, zamba.num_kv_heads, zamba.resolved_head_dim,
            smi,
        ),
        "decode": time_decode(DA, cfg, mid_lens, 1024, smi),
        "ssd": time_ssd(SS, mamba, 2048, smi),
        # phase 10's shapes: zamba2's shared block against its dense cache;
        # the longest prompt (600, padded to 768) of mamba2 and zamba2
        "decode_zamba": time_decode(DA, zamba, mid_lens, 1024, smi),
        # phase 11's: whisper-medium's cross-attention over 1500 frames
        "decode_whisper": time_decode(DA, get_config(AUDIO_ARCH), [1500] * 8, 1500, smi),
        # phase 13's: a rank's heads under tensor parallelism (13a) and
        # its 4 rows under expert parallelism (13d)
        "decode_tp": time_decode(DA, rank_heads(cfg), mid_lens, 1024, smi),
        "decode_ep": time_decode(DA, get_config(MOE_ARCH), mid_lens[:4], 1024, smi),
        "ssd_mamba_768": time_ssd(SS, mamba, 768, smi),
        "ssd_zamba_768": time_ssd(SS, zamba, 768, smi),
        # phase 13e-g's rank shapes on model 2: zamba2's shared block at
        # 16 of 32 heads, whisper's cross-attention at 8 of 16, the SSD
        # scan at mamba2's 24 of 48 heads and zamba2's 56 of 112
        "decode_zamba_tp": time_decode(DA, rank_heads(zamba), mid_lens, 1024, smi),
        "decode_whisper_tp": time_decode(DA, rank_heads(get_config(AUDIO_ARCH)),
                                         [1500] * 8, 1500, smi),
        "ssd_mamba_tp": time_ssd(SS, rank_heads(mamba), 768, smi),
        "ssd_zamba_tp": time_ssd(SS, rank_heads(zamba), 768, smi),
    }
    gelu_times = {
        "gelu": [(c, time_gelu(GK, *c, False, smi)) for c in GELU_SHAPES],
        "gelu_grad": [(c, time_gelu(GK, *c, True, smi)) for c in GELU_GRAD_SHAPES],
    }

    # phase 4: small fp32 step, card vs CPU
    check_small_step(T, PK, get_config)

    # phase 5: main path at full width
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = T.init_params(cfg, gen, "bfloat16")
    torch.cuda.synchronize()
    log(
        f"[engine] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"H={cfg.num_heads}, KV={cfg.num_kv_heads}, d_ff={cfg.d_ff}, "
        f"vocab={cfg.vocab_size}; bf16 weights in {time.perf_counter() - t:.1f} s"
    )
    engine_args = (Engine, RequestSpec, SamplingParams, cfg, params)

    # the main path: the engine's steps as CUDA graphs (the default on the
    # card), then the same workload through its eager steps; each engine
    # then serves a second workload of the same lengths (other tokens),
    # warm: every graph key it needs is captured already
    warm_prompts, _ = workload(cfg, seed=SEED + 1)
    runs = serve_graphs_and_eager(
        engine_args, PD, GR, (prompts, warm_prompts, sampled), smi
    )
    reqs, wreqs, stats, launches = runs["graphs"]

    # kernel vs gather: one decode step's logits, and whole greedy streams
    probe_out = {}
    probe = logit_probe(T, cfg, probe_out, fp32=True)
    _, greqs, _ = run_engine(*engine_args, "gather", prompts, sampled, probe=probe)
    if not probe_out.get("finite"):
        raise AssertionError("non-finite logits on the kernel path")
    rel, rel32 = probe_out["rel_err"], probe_out["rel_err32"]
    if rel > 2e-2 or rel32 > 1e-4:
        raise AssertionError(
            f"kernel vs gather logits: relative error {rel:.3e} in bf16 "
            f"(tol 2e-2), {rel32:.3e} in fp32 (tol 1e-4)"
        )
    log(
        f"[engine] one decode step, kernel vs gather logits: relative L2 error "
        f"{rel:.3e} in bf16 (tol 2e-2), max abs {probe_out['max_abs']:.3e}; the "
        f"same step in fp32: {rel32:.3e} (tol 1e-4)"
    )
    greedy = [(a, b) for a, b in zip(reqs, greqs) if a.temperature == 0]
    total = sum(len(a.generated) for a, _ in greedy)
    agree = sum(x == y for a, b in greedy for x, y in zip(a.generated, b.generated))
    log(
        f"[engine] greedy tokens equal between kernel and gather paths: "
        f"{agree}/{total} (bf16; near-ties may flip, not gated)"
    )

    # two more runs, each profiled over a few steady decode steps (not
    # counted): through the graphs, and eager
    busy = {}
    for graphs, tag in ((True, ""), (False, "_eager")):
        profile = functools.partial(
            profile_decode, out_dir=out_dir, smi=smi, tag=tag, sink=busy
        )
        run_engine(
            *engine_args, "kernel", prompts, sampled, probe=profile, cuda_graphs=graphs
        )
    for what, tag in (("graphs", ""), ("eager", "_eager")):
        step_ms = runs[what][2]["steady_step_ms"]
        median = step_ms[len(step_ms) // 2]
        log(
            f"[profile] {what}: device busy {busy[tag]:.3f} ms per steady step "
            f"(profiled) against the unprofiled steady step's median "
            f"{median:.3f} ms: idle share outside the profiler "
            f"{1 - busy[tag] / median:.3f} [{smi}]"
        )

    # phase 6: the kernel API and the Mamba2 mixer at full width
    t = time.perf_counter()
    for kern in (FA.flash_attention, DA.decode_attention, SS.ssd_scan):
        kern.launches = 0
    kernel_api_phase(ops, FA, DA, ssm, get_config, mid_lens, smi)
    api_launches = {
        "flash": FA.flash_attention.launches,
        "decode": DA.decode_attention.launches,
        "ssd": SS.ssd_scan.launches,
    }
    if min(api_launches.values()) == 0:
        raise AssertionError(f"a kernel API kernel never launched: {api_launches}")
    log(
        f"[api] kernel launches {api_launches} in {time.perf_counter() - t:.1f} s "
        f"[{smi}]"
    )

    kernels = [
        {
            "name": "paged_decode_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:73",
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            # launches sum both paths; ms .. bound_by above are the first
            # shape's, and each shape's own numbers follow
            "shapes": [
                {"model": cfg.name, "launches": launches, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by},
                {"model": MOE_ARCH, "launches": None, "ms": moe_paged[0],
                 "plain_ms": moe_paged[1], "bound_ms": moe_paged[2],
                 "bound_by": moe_paged[3]},
            ],
        }
    ]
    ported = [  # (name, key, source file, Pallas function)
        ("flash_attention", "flash", "flash_attention", "flash_attention.py:71"),
        ("decode_attention", "decode", "decode_attention", "decode_attention.py:62"),
        ("ssd_scan", "ssd", "ssd_scan", "ssd_scan.py:75"),
    ]
    for name, key, src, replaces in ported:
        k_ms, k_plain, k_lib, (k_bound, k_by) = timed[key]
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}.cu",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": api_launches[key],
                "max_abs_err": errs[key],
                "ms": k_ms,
                "plain_ms": k_plain,
                "bound_ms": k_bound,
                "bound_by": k_by,
                "library_ms": k_lib,
            }
        )
    # flash's timed prefill shapes (no serving path calls flash: the
    # launches are phase 6's kernel API calls, on the first row)
    kernels[1]["shapes"] = []
    for model, timed_key in (("tinyllama-1.1b", "flash"), ("gemma-7b", "flash_gemma"),
                             ("stablelm-12b", "flash_stablelm"),
                             (HYBRID_ARCH, "flash_zamba")):
        k_ms, k_plain, k_lib, (k_bound, k_by) = timed[timed_key]
        kernels[1]["shapes"].append({
            "model": model, "timed": timed_key, "launches": None, "ms": k_ms,
            "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
            "library_ms": k_lib,
        })
    # phase 7: the module-scaling loop at full width
    t = time.perf_counter()
    reference = {r.rid: r.generated for r in reqs}
    mods = (PD, GR, INS, MIG, MetricsSnapshot, Orchestrator, RequestSpec, SamplingParams)
    work = (cfg, params, prompts, sampled)
    in_process = scaling_phase(mods, work, reference, smi)
    log(f"[scaling] phase 7 in {time.perf_counter() - t:.1f} s")

    # phase 8: the remote plane at full width
    torch.cuda.empty_cache()
    t = time.perf_counter()
    references = {
        "http": workload(cfg, seed=SEED + 2)[0],
        "stw": (prompts, reference),
        "two-phase": (warm_prompts, {r.rid: r.generated for r in wreqs}),
    }
    mods = (launch_pod, Node, Orchestrator, Ingress, TR, Engine, RequestSpec,
            SamplingParams)
    remote_phase(mods, (cfg, params, sampled), references, in_process, smi)
    log(f"[remote] phase 8 in {time.perf_counter() - t:.1f} s")

    # phase 9: qwen2-moe-a2.7b at full width, after phases 5-8's weights
    # and engines are freed
    del params, engine_args, work, runs, reqs, wreqs, greqs, greedy, references
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    mods = (Engine, RequestSpec, SamplingParams, PD, GR, INS, T, Orchestrator,
            MIG, MOE)
    moe_launches = moe_phase(mods, get_config, out_dir, smi)
    kernels[0]["launches"] += moe_launches
    kernels[0]["shapes"][1]["launches"] = moe_launches
    log(f"[moe] phase 9 in {time.perf_counter() - t:.1f} s")

    # phase 10: the dense-cache engine, after phase 9's weights are freed
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    mods = (Engine, RequestSpec, SamplingParams, DA, SS, GR, T, PK)
    served = dense_phase(mods, get_config, reference, out_dir, smi)
    # the dense-decode and SSD rows gain the serving launches (each
    # engine's graph run, cold), and each timed shape's own numbers with
    # the launches of the model it stands for (a model's SSD launches span
    # all its prompt lengths; L 2048 serves none)
    for row, key, shapes in (
        (kernels[2], "decode", (("tinyllama-1.1b", "decode"), (HYBRID_ARCH, "decode_zamba"))),
        (kernels[3], "ssd", ((None, "ssd"), (SSM_ARCH, "ssd_mamba_768"),
                             (HYBRID_ARCH, "ssd_zamba_768"))),
    ):
        row["launches"] += sum(served[key].values())
        row["shapes"] = []
        for model, timed_key in shapes:
            k_ms, k_plain, k_lib, (k_bound, k_by) = timed[timed_key]
            row["shapes"].append({
                "model": model, "timed": timed_key, "launches": served[key].get(model),
                "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound,
                "bound_by": k_by, "library_ms": k_lib,
            })
    log(f"[dense] phase 10 in {time.perf_counter() - t:.1f} s; serving launches {served}")

    # phase 11: MLA and the encoder-decoder on the dense engine, after
    # phase 10's weights are freed
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    encdec = encdec_phase(mods, get_config, out_dir, smi)
    row = kernels[2]
    row["launches"] += sum(encdec.values())
    k_ms, k_plain, k_lib, (k_bound, k_by) = timed["decode_whisper"]
    row["shapes"].append({
        "model": AUDIO_ARCH, "timed": "decode_whisper", "launches": encdec[AUDIO_ARCH],
        "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
        "library_ms": k_lib,
    })
    log(f"[dense] phase 11 in {time.perf_counter() - t:.1f} s; serving launches {encdec}")

    # phase 12: module replication across two ranks sharing the card
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    repl, replaced = replication_phase(TR, reference, out_dir, smi)
    kernels[0]["launches"] += repl + replaced
    kernels[0]["shapes"].append({
        "model": f"{cfg.name} replicated (4 of 8 rows a rank)", "launches": repl,
        "ms": repl_paged[0], "plain_ms": repl_paged[1], "bound_ms": repl_paged[2],
        "bound_by": repl_paged[3],
    })
    log(f"[replication] phase 12 in {time.perf_counter() - t:.1f} s; paged launches "
        f"on both ranks {repl}, and {replaced} in its re-placement part's steps")

    # phase 13: the sharded serving step across two ranks sharing the card
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[sharded] before phase 13 this process holds {torch.cuda.memory_allocated()} B "
        f"allocated, {torch.cuda.memory_reserved()} B reserved; the card has {free} B free "
        f"of {total} B")
    t = time.perf_counter()
    sharded = sharded_phase(TR, smi)
    for row, key, shapes in (
        (kernels[2], "decode", (
            ("tp", "decode_tp", f"{cfg.name} on model 2 (16 of 32 heads a rank)"),
            ("ep", "decode_ep", f"{MOE_ARCH} on data 2 (4 of 8 rows a rank)"),
            ("hybrid", "decode_zamba_tp", f"{HYBRID_ARCH} on model 2 (16 of 32 heads a rank)"),
            ("audio", "decode_whisper_tp",
             f"{AUDIO_ARCH} cross-attention on model 2 (8 of 16 heads a rank; the "
             f"launches count self- and cross-attention)"))),
        (kernels[3], "ssd", (
            ("ssm", "ssd_mamba_tp", f"{SSM_ARCH} on model 2 (24 of 48 heads a rank)"),
            ("hybrid", "ssd_zamba_tp", f"{HYBRID_ARCH} on model 2 (56 of 112 heads a "
                                       f"rank)"))),
    ):
        row["launches"] += sum(sharded[key].values())
        for part, timed_key, model in shapes:
            k_ms, k_plain, k_lib, (k_bound, k_by) = timed[timed_key]
            row["shapes"].append({
                "model": model, "timed": timed_key, "launches": sharded[key][part],
                "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
                "library_ms": k_lib,
            })
    kernels[0]["launches"] += sum(sharded["paged"].values())
    for part, timed_paged, model in (
            ("tp", tp_paged, f"{cfg.name} paged step under rules on model 2 (16 of 32 "
                             f"heads, 2 of 4 KV heads a rank)"),
            ("ep", ep_paged, f"{MOE_ARCH} paged step under rules on data 2 (4 of 8 rows "
                             f"a rank)")):
        kernels[0]["shapes"].append({
            "model": model, "launches": sharded["paged"][part], "ms": timed_paged[0],
            "plain_ms": timed_paged[1], "bound_ms": timed_paged[2],
            "bound_by": timed_paged[3], "library_ms": None,
        })
    log(f"[sharded] phase 13 in {time.perf_counter() - t:.1f} s; launches on both ranks "
        f"{sharded}")

    # phase 14: the training path, after phase 13's ranks are gone
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    GK.gelu.launches = GK.gelu_grad.launches = 0
    training_phase((PD.paged_decode_attention, FA.flash_attention, DA.decode_attention,
                    SS.ssd_scan), get_config, out_dir, smi)
    grad_launches = GK.gelu_grad.launches
    if grad_launches == 0 or GK.gelu.launches == 0:
        raise AssertionError(f"phase 14: gelu kernel launches {GK.gelu.launches}, its "
                             f"gradient's {grad_launches}")
    log(f"[train] phase 14 in {time.perf_counter() - t:.1f} s; gelu kernel launches "
        f"{GK.gelu.launches}, its gradient's {grad_launches} (14c's whisper-medium on the "
        f"card)")

    # phase 15: the sharded train step across two ranks sharing the card
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    sharded_train_phase(TR, smi, (PD.paged_decode_attention, FA.flash_attention,
                                  DA.decode_attention, SS.ssd_scan))
    log(f"[sharded-train] phase 15 in {time.perf_counter() - t:.1f} s")

    # phase 16: the paper's llama2-13b and three assigned models at their
    # published widths, on the card emptied of phase 15's ranks
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    GK.gelu.launches = 0
    with step_graphs(GR, []) as graphs:
        wide = wide_phase(wide_mods, get_config, out_dir, smi)
    gelu_launches = GR.launches_run(GK.gelu, graphs)
    if gelu_launches == 0:
        raise AssertionError("phase 16: the gelu kernel never launched (gemma-7b's GeGLU)")
    wide_rows(kernels, wide_times, wide)
    log(f"[wide] phase 16 in {time.perf_counter() - t:.1f} s; launches {wide}, gelu "
        f"{gelu_launches} (wrapper calls {GK.gelu.launches})")
    kernels.append(gelu_row("gelu", gelu_times["gelu"], gelu_launches, errs["gelu"],
                            "phase 16 (gemma-7b's GeGLU, graph replays counted)"))
    kernels.append(gelu_row("gelu_grad", gelu_times["gelu_grad"], grad_launches,
                            errs["gelu"], "phase 14 (14c's whisper-medium train step)"))

    # phase 17: the README's quickstarts on the port, on the card
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    examples_phase(smi)
    log(f"[examples] phase 17 in {time.perf_counter() - t:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
