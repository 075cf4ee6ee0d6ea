#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dist_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--only PHASE,...] [--ep-world 4] [--tp-world 4]

Phases, each printed as one JSON line:

1. ``env``/``build``: versions, the card, and the build of the CUDA kernels
   from ``tpu_dist_torch/csrc`` (one ``nvcc`` per source, all at once; the
   Triton kernels compile at first launch) with the control-plane store's
   host library (``g++``, beside them).
2. ``kernel``: every kernel of the training paths against its plain PyTorch
   version on the card, at the paths' shapes and at ragged shapes, with the
   tolerance it is held to; kernel, plain and library-yardstick times (CUDA
   events, median) and the least time the card could take (``bound_ms``).
   Flash attention (K2f, K2b) and the grouped products (K3 in its four
   forms, K4) are also timed against their older ``mma.sync`` design in the
   same run (``older_ms`` / ``mma_sync_ms``, in turns), every case checks
   which design each launch took (``flash_design``, ``gmm_design``), and
   two launches of K2f, K2b and K4 on the same inputs must agree bit for
   bit.  Their timed lines also split ``ms`` (one call a sample, the
   wrapper's host work included) into the card's own time (``device_ms``,
   the host kept ahead) and the wrapper's host time (``host_ms``); K2b's
   line also gives its dQ and dK/dV kernels' card time (``dq_ms``,
   ``dkv_ms``, from ``torch.profiler`` over ten calls).  The ``gmm``
   phase ends with B2, ``gmm(activation=)``: each activation of
   ``ACTIVATIONS`` in each design (wgmma at the path shape, also with
   float32 output and on a transpose view; mma_sync at a ragged shape and
   through ``_older``; fma in float32) against ``gmm_plain`` with the same
   callable, the dead tail exact zeros, the product without its activation
   (and, in float32, the tanh GELU against the erf one) rejected, an
   unknown callable refused on the card; timed with ``gelu_tanh`` at the
   path shape beside K3 alone (in turns), the plain version and the
   two-call composition ``torch._grouped_mm`` + ``F.gelu(approximate=
   "tanh")`` (no one PyTorch call computes it: ``library_ms`` is null).
3. ``slice``: the dense GPT-2-small-shaped TransformerLM trained at full
   width through the port's DDP (bf16, fused cross-entropy, flash attention
   at T = 2048), with every kernel's launch count over that run (every
   flash launch must be the wgmma design); then one more step, untimed,
   inside ``tpu_dist_torch.utils.profiler.trace``: the exported Chrome
   trace must hold K1f, K1b, K2f and K2b's kernels as many times as the
   wrappers counted launches (K2b: a dQ and a dK/dV kernel a launch), and
   ``utils.memory`` must read what ``torch.cuda`` reads; then
   ``composition``: one step against the plain composition (dense attention,
   unfused loss) on the same weights and batch.
4. ``moe_slice``: the same trunk with a top-2-of-8 dropless MoE in every
   block, trained at full width (grouped matmuls K3/K4 too), with the launch
   counts over that run, by design for K2f/K2b/K3/K4 (every one must be the
   wgmma design); ``moe_layer``: one full-width MoE layer forward and
   backward with the kernels against the plain grouped products on the same
   inputs; ``moe_composition``: one step against the plain composition
   (plain grouped products, dense attention, unfused loss).
5. ``serve``: the full-width dense model (float32, weights from a seeded
   generator) served through ``ServeClient`` → socket → ``Frontend`` →
   ``Scheduler`` → ``SlotEngine(8 slots, max_len 2048)``: the 16 requests
   of :func:`smoke_requests` (prompts 16-1536 tokens, one above 1024; 16-64
   new tokens; 12 greedy, 4 sampled at temperature 0.8 with seeds 1-4).
   Every request must end ``done`` with all its tokens and equal
   ``generate()`` alone on the card, and two greedy ones the plain path on
   a CPU copy of the weights, token for token except at a step where the
   two largest values the reference drew its token from (its own logits
   there, replayed) lie within ``SERVE_TIE_GAP`` (each such divergence is
   printed with its gap).  The path runs no kernel: every launch count over
   the served run must be 0.  Printed: tokens/s, TTFT and decode-step
   percentiles, prefill p50, occupancy, peak memory and the decode step's
   bound.  Once the frontend, scheduler and engine are closed, the memory
   the card holds must be back to what it held before the phase, within
   ``SERVE_LEFTOVER_BYTES``, so the next phase's peak is its own.
   ``serve_int8``: the same with the int8 KV cache, against
   ``generate(cache_dtype=torch.int8)``.  ``quant``: the model with int8
   weights (``quantize_linear_weights(attention=True)``), 32 greedy tokens
   on the card against the same weights on the CPU, and its decode step
   against the float32 model's, in turns.
6. ``convnet``: the ConvNet twin example's ``train`` at world 1 on the card
   (batch 100, synthetic MNIST, float32) for 300 steps at lr 0.05: the loss
   must fall at least 5x, and ``evaluate`` over the 10,000 test images must
   count 10,000 and score above 0.9; one float32 step against the same
   step on a CPU copy of the port, TF32 off (``VISION_STEP_TOL``); then
   images/s/GPU, step ms and peak memory at bench.py's headline (batch
   8192, bf16, ``train_chunk`` of 50) and its float32 row (2048), under
   torch's default TF32 permissions.  ``resnet``: resnet18(num_classes=10)
   through the ResNet twin example's path (RandomCrop + Flip on the host,
   DataLoader, DeviceLoader), batch 256, 20 steps in float32 (then
   ``evaluate``, an exact count) and 20 in bf16: losses finite and falling,
   every BatchNorm statistic moved and finite; one float32 step (parameters
   and BatchNorm statistics) against the CPU copy; images/s/GPU at batch
   256 and 1024 (bf16).  Neither path runs a hand-written kernel: every
   launch count over each phase must be 0.
7. ``optim``: at the dense slice's 136,993,280 float32 parameters (150
   tensors), every optimizer's multi-tensor update (SGD classic, nesterov
   and with a schedule; AdamW; Adam; RMSprop centered with momentum;
   Adagrad), EMA's and ``clip_grad_norm`` against its plain per-parameter
   loop on the same state and gradients (``OPTIM_TOL``, with a planted
   1e-3 error that must be rejected); ms and launches per update against
   the bytes bound, the plain loop's, and torch.optim's fused AdamW and
   SGD as a yardstick.  An update that launches a third or more of the
   plain loop's kernels fails: the multi-tensor path must not fall back.
8. ``resume``: the dense slice at full width and depth with
   ``AdamW(lr=warmup_cosine)``, ``accum_steps=2`` and an EMA: six steps
   straight against three, a save through ``AsyncCheckpointer``, a fresh
   DDP restored with ``verify=True`` and three more; parameters, AdamW
   moments, counts and the EMA shadow must be equal bit for bit, and the
   K1/K2 launch counts those of two micro-batches a step.  Save and
   restore seconds and the checkpoint's bytes.  Then the example_mp twin
   with ``--checkpoint-dir``/``--resume`` and the train_lm twin at its
   defaults with ``--generate 32`` (the loss falls tenfold, all 32
   transitions follow the permutation).
9. ``flash_offdiag``: K2f/K2b in ``causal="offdiag"`` mode against their
   plain versions in each design (wgmma: bf16, D = 64, (8, 2048, 12) with
   blocks (1024, 1024) and (1024, 512); mma_sync: bf16, D = 128; fma:
   float32, blocks clamped to 512; and ragged T in each): tolerance, a
   bit-for-bit repeat, exact launches by design and mode, the first query
   block empty, and the plain causal result rejected; timed against the
   operations bound over the offdiag pairs and SDPA with the band as a
   boolean mask.  ``split_diag``: ``flash_attention(split_diag=True)``
   against ``split_diag=False`` at (8, 2048, 12, 64) and (1, 8192, 12, 64),
   bf16: forward and q/k/v grads, one causal and one offdiag call of each
   kernel a pass (the kernels line's offdiag launches), both timed.
10. ``ring``: the ring's hop functions over 4 virtual ranks in one process
   at GPT-2-small's attention over 8192 positions (4 shards of 2048, bf16),
   causal and not, against one K2f/K2b call on the gathered sequence, with
   n(n+1)/2 or n² launches; Ulysses' local attention (3 heads a rank);
   ``ring_self_attention`` at world 1 through its entry point.
   ``sp_train``: ``train_lm --parallel sp`` at world 1, full width
   (GPT-2-small, vocab 32768, T = 8192, batch 1, bf16), each mode: one step
   against the model without ``sequence_axis``, then 20 steps (the loss
   falls; K2f/K2b 12 launches a step; step ms, tokens/s).
11. ``augment``: ``DeviceAugment.imagenet(224, bf16)``,
   ``imagenet_eval(224, 256)`` and ``cifar10(32)`` at full batch on the
   card against the same call on a CPU copy (float32 within 1e-5, bf16
   within one ulp), the modes' invariants, images/s of the augmentation, of
   the raw host gather and of the ResNet-50 step, the pinned staging's host
   time and ``loader_keeps_card_fed``.  ``imagenet``: the
   ``example_imagenet`` twin at its defaults (ResNet-50, 224, 128, bf16,
   augmentation on the card) for 30 steps and ``--evaluate``; one float32
   step at batch 4 against the CPU copy; the ``imagenet_e2e`` twin (the
   step alone and the sustained rate).  ``vit``: the twin with ``--model
   vit_b_16`` for 20 steps at 64; one float32 step at batch 2 against the
   CPU copy; the ``vit_train`` twin; then ViT-B/16's attention at (64, 197,
   12, 64) through the dense composition and through K2f/K2b, timed in
   turns, the flash result held to its plain version.  None of the three
   paths runs a hand-written kernel: every count over each must be 0.
12. ``launch``: ``python -m tpu_dist_torch.launch --standalone
   --nproc_per_node=1`` on a worker this script writes, which runs the
   train_lm twin at GPT-2-small width (vocab 32768, T = 2048, batch 8,
   bf16, 3 steps) on NCCL: the env contract, K2f/K2b launched in the child
   (12 of each a step, all wgmma: the ``launch_kernels`` line), its losses
   bit for bit those of the same twin run in this process, the seconds
   from starting the launcher to the child's first step against this
   process's, and that the launcher never holds a context on the card.
   ``launch_restart``: the same with ``--max_restarts=1`` — generation 0
   exits 1 after its first step, generation 1 sees
   ``TPU_DIST_RESTART_COUNT=1`` and the store's ``tpu_dist/generation`` =
   1 and finishes; the seconds from the failure to its first step.
   ``gateway``: ``--max_restarts=1 --serve`` on the serve_lm twin at the
   serve phases' model (float32, 8 slots, 2048 positions, seed 0): 8
   greedy requests through the gateway, equal to the same requests sent
   straight to the worker's Frontend and to ``generate()`` here (the tie
   rule), tokens/s of each; a SIGKILL of the model rank with 8 requests
   in flight, each of which must end done or named
   (``BackendGoneError``/``BackendUnavailableError``); the same tokens on
   the same connection after the relaunch.  ``store``: set/get/add round
   trips through one client, µs per op, native and Python.
13. ``moe_dispatch``: the ``moe_lm`` twin with each capacity dispatch at
   full width (capacity factor 1.25): gather at batch 8 (23 steps), einsum
   at the largest of 8, 4, 2 that fits (two steps, one timed); step ms,
   tokens/s, peak memory, dropped choices a layer, K1f/K1b 1 and K2f/K2b
   12 launches a step (wgmma), K3/K4 none; one step of each against the
   plain composition (``MOE_DISPATCH_TOL``), and einsum's update against
   gather's; one full-width float32 layer of each (2048 tokens, some
   choices dropped) forward and backward against a CPU copy
   (``MOE_CPU_TOL``, a planted expert swap rejected).  ``llama``: the
   dense slice with ``norm="rmsnorm", rope=True`` (23 steps, K1 1 and K2
   12 a step), its tokens/s beside the
   layernorm model's run in the same phase, one step against the plain
   composition, and K2f/K2b on the rotated q/k (views of one rotated
   buffer) beside the projection's v (design, tolerance, times beside the
   unrotated views).  ``long_32k``:
   the ``run_32k`` twin (T = 32768, batch 1, remat): 24 K2f and 12 K2b a
   step, a finite falling loss, tokens/s and peak memory beside
   ``run_long`` (T = 8192) and T = 32768 without remat; K2f/K2b at (1,
   32768, 12, 64) held head by head to their plain versions and timed
   against their bound and SDPA.  ``serve_rope``: the slot engine (8
   slots) on a float32 ``rope=True, norm="rmsnorm"`` model at full width,
   eight ``smoke_requests`` each equal to ``generate()`` alone but for
   ties, no kernel launch.
14. ``zero_ddp``: the dense cell with ``AdamW(lr=1e-4)`` on one card under
   the DDP replicated, with ``shard_optimizer=True`` (ZeRO-1: three steps
   bit for bit the replicated ones) and with ``comm_dtype=bfloat16``
   (within ``COMPOSITION_TOL`` of them); K1f/K1b 1 and K2f/K2b 12 launches
   a step (wgmma) in each; step ms, peak memory and optimizer-state bytes
   of each; the flat-shard AdamW update beside the per-leaf one and its
   bytes bound.  ``zero_opt``: the ``bench_zero`` twin at world 1 (the
   JAX benchmark's 64-leaf tree): the ZeRO parameters bit for bit the
   replicated ones, steps/s and state bytes of each.  ``elastic``: the
   ``elastic_train`` twin under ``python -m tpu_dist_torch.launch
   --standalone --nproc_per_node=1 --max_restarts=1`` (batch 100, 40
   steps, a save every 10), killed at step 20 by ``TPU_DIST_CHAOS`` and
   restarted, with and without ``--zero``, beside uninterrupted runs (all
   four at once): the resumed steps 21-39's losses and the final
   parameters bit for bit the uninterrupted ones; the seconds from the
   kill to the first resumed step; the twin's step with cuDNN's
   deterministic algorithms and without.  No kernel on the elastic path.
15. ``host_ring``: the dense cell's gradients (four seeded batches of 2
   rows: K1f/K1b 4 and K2f/K2b 48 launches, wgmma; of the 548 MB of CUDA
   leaves a rank, blocks 0-1 and every other leaf but the two vocabulary
   tables: 63 MB) reduced by four thread ranks on the host data plane (one port
   TCPStore, a DataPlane and a ``Bucketer(dp=, comm_dtype=)`` a rank), op
   ``avg``: float32, bfloat16 and ``int8_block256`` with an ErrorFeedback
   over the flat TCP ring; float32 and int8 over SHM lanes and over the
   hierarchical ring (hosts simulated 2 x 2 with
   ``TPU_DIST_HOST_ID_R{rank}``).  Every result byte-identical across
   ranks and back on the card; hier and SHM bit for bit the flat TCP ring;
   the float32 ring at world 2 bit for bit ``(g0 + g1) / 2`` on the card;
   the float32 and int8 rings bit for bit the same rings over CPU copies
   of the gradients; int8 within 0.05 x max(|exact|, 1).  MB/s per wire and
   algorithm, the wire compression off the byte counters, which lanes were
   live, the D2H, pack and H2D staging ms, the checksum that resolved and
   its cost (the float32 ring at world 2 with checksums off).  ``host_zero``:
   ``ZeroOptimizer(AdamW, dp=, comm_dtype="int8_block256",
   error_feedback=True)`` on four thread ranks for two steps of those
   gradients: parameters byte-identical across ranks, ``zstate["ef"]``
   shard-shaped on the host, the exact gather equal to the master shards;
   a sharded save (ranks 2 and 3 share a root, the others each their own)
   and a reshard 4 -> 3 in which the fragments a new rank's root lacks are
   pushed over the data plane, bit for bit the saved shards; ``frags_peer``,
   the bytes pushed and the reshard seconds.  ``quant_gate``: the
   ``accuracy_run`` twin's ConvNet gate at world 2 (two worker processes on
   this card, store and data plane only, no NCCL; 150 steps, batch 128, lr
   0.02; the two worlds at once): the int8 + EF accuracy within ±3 SE of
   the float32 wire's.
16. ``vgg``: ``vgg11_bn(num_classes=10)`` and ``vgg16(num_classes=10)``
   at 32×32, batch 16, float32 with TF32 off: one DDP step each (SGD 0.01,
   momentum 0.9, both dropouts live) against the same step on a CPU copy of
   the port (``VGG_STEP_TOL``: ``VISION_STEP_TOL``, and the convolution
   biases under a BatchNorm, whose exact gradient is 0, at most 1e-4 of
   the next BatchNorm bias's update), every BatchNorm statistic moved and
   finite; ``vgg16`` forward at 224², batch 8, in bf16 (finite logits);
   images/s and peak memory of the ``vgg16`` bf16 DDP step at batch 64,
   32² (torch's default TF32 permissions).  ``accuracy``: the
   ``accuracy_run`` twin's MNIST low-SNR oracle at the JAX spec (4 epochs,
   20,000 training and 10,000 test images, world 1): the final accuracy in
   [0.7625, 0.7875], the ceiling 0.775 ± 3 binomial SE; its torch-parity
   row (the literal ``torch.nn`` ConvNet and ``torch.optim.SGD`` against the
   port's, 200 steps at lr 0.05, TF32 off): the largest step loss delta
   below 4e-3 and the mean below 4e-4.  ``twins``: the ``generate`` twin at
   full width and short lengths (batch 2, prompt 16, 32 and 8 new tokens):
   its greedy tokens equal ``generate()`` on the same seeded model, its
   implied parameter-read bandwidth no more than the card's memory rate;
   the ``attention`` twin at T = 1024 and 2048 (b 4, h 8, d 64, bf16):
   flash's output and q/k/v gradients against dense's (the float32
   composition) within ``FLASH_BF16_TOL`` — dq no further from it than
   flash's plain version plus one tolerance — and against the plain
   version within it, the K2f/K2b launches of each row equal to its flash
   calls; the ``input_pipeline`` twin at a small image
   count: every JAX key present and every rate above 0.  No kernel launches
   in ``vgg`` and ``accuracy``; in ``twins`` only the attention rows'.
17. ``obs``: the flight recorder on the dense cell's real gradients at
   world 2 — ``python -m tpu_dist_torch.launch --standalone
   --nproc_per_node=2 --flight-recorder --heartbeat_timeout=5`` on a worker
   this script writes (both ranks on this card, the store and the host data
   plane only, no NCCL: a step is the gradients of one seeded row, K1 once
   and K2 12 times, then the ``host_ring`` subset with the head's weight,
   221 MB, averaged by a ``Bucketer`` over the float32 host ring inside
   ``resilience.TrainState``), rank 1
   chaos-stalled at step 3: the launcher names ``RankLostError`` for rank
   1 with its last obs position, prints the positions table and the dump
   directory; both dumps read; every collective number up to the stall has
   the same op, digest and bytes on both ranks, path ``dataplane``;
   ``diagnose`` names rank 1 the straggler and rank 0 pending in the next
   bucket's span and the ring span in it, at the worker's line; ``python
   -m tpu_dist_torch.obs diagnose`` exits 3 and ``merge`` writes two
   tracks; ``tpu_dist_torch.analysis.replay_dir`` over the dumps finds no
   TD110 and one TD115 error naming rank 1 at ``diagnose``'s stuck
   collective, its diagnosis ``diagnose``'s (the stall's launch runs in
   ``faults``).  The same worker under
   ``--flight-recorder --sanitize``
   (one launch, shared with ``sanitize``): steps 0-7 with the recorder
   armed on even steps and disarmed on odd ones, the sanitizer off: step
   and sync ms of each arm, and the dumps' bytes.  ``sanitize``: steps 8-9
   of that launch pass the signature checks (the sanitizer's ms a
   collective); at step 10 rank 1 casts its last gradient leaf to bfloat16
   and both ranks raise ``CollectiveMismatchError`` naming the ``leaves``
   divergence, with no payload moved for the refused collective.  ``roles``: the ``actor_learner`` twin under
   ``--roles learner:1,actor:4:solo --solo_restarts 2`` (100 steps, the
   recorder armed) and the ``param_server`` twin (``server:1,worker:4:solo``,
   48 rounds), each with rank 2 killed at its 3rd message: exit 0, one solo
   restart and no gang restart, the learner or server on the card in
   generation 0 for every step with its loss falling by the JAX tests'
   margins, the respawn's messages reaching it, data-plane frames on the
   queue, no kernel launch and no NCCL; the dumps' channel put, claim and
   ack events; then the ``bench_roles`` twin's channel cells, every
   payload equal.
18. ``cluster_failover``: two ``python -m tpu_dist_torch.cluster.agent``
   processes host the replicated store; the train_lm twin at full width
   (80 steps, the dense cell's fused loss) under ``--store_endpoints``
   with heartbeats; the leader's agent SIGKILLed after the first step:
   epoch 1 names node 1's replica, generation 0 throughout, the parameters
   of an unkilled launch, K1 1 and K2 12 a step, the recorder's
   ``store``/``failover`` event read by ``obs.diagnose``; seconds to epoch
   1, the longest step across the failover beside the median.
   ``cluster_elastic``: two launchers, a rank each on this card
   (``--nnodes=2 --store_replica --elastic_world=1:2``), the
   ``elastic_train`` twin with ``--zero`` over the host data plane, 2 → 1
   → 2 across the node boundary: JAX's plans, each world's phase bit for
   bit a single launcher resumed from a copy of the tree.  ``netchaos``:
   the dense cell's gradients (the 63 MB ``host_ring`` subset) at world
   2 (two rank processes, a Bucketer on the float32 host ring) under
   ``corrupt`` (named ``FrameCorruptError``,
   the launch fails, no result), ``delay`` and an SHM ``conn-reset``
   (byte-identical), ``partition`` (``CollectiveTimeoutError`` within
   ``--coll_timeout`` + 5 s); the served model under ``corrupt:surface=
   serve`` (8 requests, each a named error).  The ``corrupt`` cells'
   launches run in ``faults``.
19. ``serve_sharded``: the served model (GPT-2-small, float32, 8 slots,
   2048 positions, seed 0) as a tensor-parallel group of two rank
   processes on this card over the store and the host data plane
   (``ShardedDecoder``/``ShardedSlotEngine``/``ShardFollower``), each rank's
   shard range-read from a full checkpoint of the model
   (``ShardedParams.from_checkpoint``: bit for bit ``shard_params``, no
   more bytes read than the shard's own and the replicated leaves plus
   ``SHARD_READ_SLACK``): 16 of bench_serve's ``_mixed_requests`` and the
   benchmark's two long prompts (1536 and 768 tokens: their prefill
   partials take the float32 ring, which must have run), greedy, each equal
   to ``generate()`` alone but for ties; two sampled requests
   against the single-rank engine's streams; every follower's token stream
   the leader's, slot by slot; with ``comm_dtype="int8_block256"`` the
   group in lockstep (full budgets, tokens in the vocabulary); then the
   follower SIGKILLed under 4 in-flight requests, each failing on the
   leader with the named ``PeerGoneError`` within ``SHARD_KILL_BOUND_S``.
   No kernel launch on either rank.  The decode step's p50/p99 beside the
   single-rank engine's on the same requests, tokens/s, and the combines
   taken by exchange and by ring.  ``serve_disagg``: ``--serve --roles
   prefill:1:solo,decode:1`` on the serve_lm twin with ``--disagg`` at that
   model, through the gateway client: greedy requests, three sharing a
   36-token prefix, equal to ``generate()`` but for ties, with the KV
   transfers counted, at least 2 prefix hits and fewer prefilled tokens
   than prompt tokens; the prefill rank SIGKILLed, then a request that
   re-dispatches once and fails with a ``KVTransferError`` naming it; no
   kernel launched by either role up to the served requests (each rank's
   counts, zeroed when it starts serving, beside ``--pid-file``).  The
   first request waits for both roles' pid files: the prefill rank writes
   its own after one throwaway forward (``PrefillWorker.warm``), so no
   request's 1.5 s transfer deadline pays its first-call costs.  Then
   the ``serve_lm --disagg`` benchmark's rows in this process (the bursty
   workload unified against disaggregated: tokens/s and p99 TTFT; the KV
   send's ms and MB/s; the prefix-heavy row), no kernel launch there
   either.
20. ``ep_train``: expert parallelism at full width — the JAX ``moe_lm``
   configuration (gather dispatch, batch 8, bf16, SGD, aux 0.01) through
   the library's GSPMD step (``benchmarks.moe_lm.ep_steps``), 3 steps at
   world 1 in this process, then the same steps at ``data 1 × expert 2``:
   two rank processes on this card over gloo (two ranks on one card cannot
   share an NCCL communicator), after a probe that gloo takes each
   collective the layer and the step use on CUDA tensors (``--ep-world
   4``: at ``data 2 × expert 2``, four ranks on four cards over NCCL).
   Losses and updates within ``COMPOSITION_TOL`` of world 1's (on four
   cards: float32 within ``EP_F32_TOL``, bf16 updates by
   ``SPLIT_BF16_TOL``, ROADMAP C13), step 1's dropped choices per layer
   equal, each rank holding 4 of the 8
   experts (half the banks' bytes), the replicated leaves bit for bit
   across the ranks, and
   per rank and step K1f/K1b 1 and K2f/K2b 12 launches (wgmma), K3/K4
   none; step ms p50 and tokens/s at both worlds, the combine's collectives
   (one more step with each ``ops.psum`` timed) and peak memory a rank.
   ``ep_train_cli``: ``train_lm --parallel ep`` at world 1 at its defaults
   on the card: finite losses, the last below half the first, the second
   differing from the first (the JAX dry run's check).
21. ``tp_train``: tensor parallelism and FSDP at full width — the dense
   GPT-2-small cell (batch 8, T 2048, SGD) through the library's GSPMD
   step (``benchmarks.transformer_lm.tp_steps``), 3 steps at world 1 in
   this process in float32 and bf16, then on two rank processes on this
   card over gloo at ``data 1 × model 2`` (both dtypes) and FSDP at
   ``data 2`` (bf16) (``--tp-world 4``: four cards over NCCL at ``data 2 ×
   model 2`` and ``data 1 × fsdp 2 × model 2``, both dtypes).  Float32
   losses and updates within ``TP_F32_TOL``, bf16 by ``SPLIT_BF16_TOL``
   (the ranks' bf16 updates no further from world 1's float32 updates
   than 1.25× world 1's own bf16 ones: ROADMAP C13); every leaf held as
   the rules split it; K1f/K1b 1 and K2f/K2b 12 launches a rank a step
   (K1 on the vocab slice, K2 on the local heads), K3/K4 none; greedy
   ``generate`` under the tp placement equal to world 1's (the serve
   phases' tie rule, ``SERVE_TIE_GAP``); step ms, tokens/s a rank, the model and fsdp lines' collectives
   (one more step counted and timed) and peak memory a rank, beside world
   1's and the ``slice`` phase's DDP step.  ``tp_train_host``: the host
   route (``TPTrainer`` at dp 1 × tp 2 over socket data planes, full
   width, depth 2, batch 2 × 1024) bit for bit ``SerialTPRunner``, two
   steps.  ``tp_train_cli``: ``train_lm --parallel tp`` at world 1 at its
   defaults: the loss falls.
22. ``pp_train``: pipeline parallelism at full width — the dense cell
   (batch 8, T 2048, SGD 0.01, fused loss) through ``PipelineParallel``
   (``benchmarks.transformer_lm.pp_steps``) on two rank processes on this
   card over gloo, started by the port's launcher, at pipe 2 and M = 4:
   GPipe in float32 and bf16, 1F1B in bf16 (``--pp-world 4``: a card a
   rank over NCCL at ``data 2 × pipe 2`` GPipe and ``data 1 × pipe 4``
   1F1B, both dtypes), 3 steps held to world 1's (``tp_train``'s, or run
   here): float32 by ``PP_F32_TOL``, bf16 by ``SPLIT_BF16_TOL``; the
   replicated embedding and head bit for bit across the ranks; each rank
   holding its blocks plus them; K1f/K1b and K2f/K2b launches a rank a
   step as ``pp_per_step`` says (wgmma in bf16), K3/K4 none; greedy
   ``generate`` from the gathered and unpacked seeded state equal to world
   1's; step ms, tokens/s a rank and a card, hop bytes, the repl
   reduction's ms, the measured bubble and peak memory a rank.  In the
   same launch, ResNet-18/CIFAR-10 (batch 256) under the GSPMD
   step at data 2 against world 1 on the global batch (float32 over one
   step by ``BN_TOL``, float64 over two by ``BN_F64_TOL``).
   ``pp_train_cli``: ``train_lm --parallel pp`` at world 1 at its
   defaults: the loss falls.  ``pp_host``: the host route at full width
   (2 stages, M = 4, float32): the in-process rig (a thread and a data
   plane a stage) runs GPipe, 1F1B and GPipe with the int8_block256 wire,
   bit for bit ``SerialPipelineRunner`` (the int8 wire within
   ``PP_INT8``), 1F1B's stash within its bound and below GPipe's;
   ``pp_host_grid``: ``build_tp_stage_fns`` on a pp 2 × tp 2 grid at
   depth 2 bit for bit ``SerialTPRunner``.
23. ``faults``: the launches that wait on an injected fault, at once —
   ``obs``'s stall (``obs_stall``), ``netchaos``'s corrupt frames
   (``netchaos_corrupt``) and ``pp_host_twin``: the ``pipeline_train``
   twin under the launcher with ``PP_KILL``, the launcher's automatic
   ``--verify_graph`` pre-flight first, its gang restart resuming bit for
   bit the serial oracle.  Checks of function only: the seconds they
   print are no metric, and no timed window runs beside them.
24. ``kernels``: one line over all kernels; the card's name and power limit
   as ``nvidia-smi`` gives them; and, last, the result line.

Each phase's wall time is printed (``phase_seconds``).  ``--only`` runs the
named phases (``cross_entropy``, ``flash``, ``gmm``, ``slice``,
``composition``, ``moe_slice``, ``moe_layer``, ``moe_composition``,
``serve``, ``serve_int8``, ``quant``, ``convnet``, ``resnet``, ``optim``,
``resume``, ``flash_offdiag``, ``split_diag``, ``ring``, ``sp_train``,
``augment``, ``imagenet``, ``vit``, ``launch``, ``launch_restart``,
``gateway``, ``store``, ``moe_dispatch``, ``llama``, ``long_32k``,
``serve_rope``, ``zero_ddp``, ``zero_opt``, ``elastic``, ``host_ring``,
``host_zero``, ``quant_gate``, ``vgg``, ``accuracy``, ``twins``, ``obs``,
``sanitize``, ``roles``,
``cluster_failover``, ``cluster_elastic``, ``netchaos``,
``serve_sharded``, ``serve_disagg``, ``ep_train``, ``tp_train``,
``pp_train``, ``pp_host``, ``faults``) and never prints the result line.

Any failure exits non-zero and prints no result line; so does a machine with
no CUDA device, or a directory without the ``tpu_dist_torch`` package.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import torch

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the peak rate of
# their type
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16_tensor": 989e12, "f32": 67e12}

# bf16 flash: the floor under each element's own tolerance, as fractions of
# its row's rms and of the tensor's; and the relative error on the later
# half of the rows that the check must reject
BF16_ATOL_ROW = 1.6e-2
BF16_ATOL_ALL = 1e-3
SENSITIVITY = 0.03

# the tolerances flash attention's kernels are held to against their plain
# versions, by dtype
FLASH_BF16_TOL = {"rtol": 1.6e-2, "atol": 0.0, "atol_row": BF16_ATOL_ROW,
                  "atol_all": BF16_ATOL_ALL,
                  "why": "each element within 2 bf16 steps (2^-6 at the top "
                         "of a binade) of the larger of its own value and its "
                         "row's rms (the row over D: one query of o and dq, "
                         "one key of dk and dv): kernel and plain round the "
                         "outputs to bf16, and round p or dS to bf16 at other "
                         "scales or from float32 values summed in other "
                         "orders, which shows at the scale of the row's "
                         "terms even where an element sums to near 0; plus "
                         "1e-3 of the tensor's rms for a row whose terms "
                         "cancel (a causal first query: its dS = p(dP - "
                         "delta) is float32 round-off of 0)"}
FLASH_F32_TOL = {"rtol": 2e-5, "atol": 2e-5, "atol_row": 0.0, "atol_all": 0.0,
                 "why": "float32 throughout; the JAX package's forward "
                        "tolerance (tests/test_flash_attention.py:42), here "
                        "for o and the gradients alike"}

KERNEL_INFO = {
    "cross_entropy_fwd": ("K1f", "triton",
                          "tpu_dist_torch/ops/_cross_entropy_triton.py",
                          "tpu_dist/ops/cross_entropy.py:89"),
    "cross_entropy_bwd": ("K1b", "triton",
                          "tpu_dist_torch/ops/_cross_entropy_triton.py",
                          "tpu_dist/ops/cross_entropy.py:121"),
    "flash_fwd": ("K2f", "cuda", "tpu_dist_torch/csrc/flash_attention.cu",
                  "tpu_dist/ops/flash_attention.py:169"),
    "flash_bwd": ("K2b", "cuda", "tpu_dist_torch/csrc/flash_attention.cu",
                  "tpu_dist/ops/flash_attention.py:305"),
    # the same kernels in causal="offdiag" mode (_tile_live, :89-100): a row
    # key limit in place of the causal mask
    "flash_fwd_offdiag": ("K2f-o", "cuda",
                          "tpu_dist_torch/csrc/flash_attention.cu",
                          "tpu_dist/ops/flash_attention.py:169"),
    "flash_bwd_offdiag": ("K2b-o", "cuda",
                          "tpu_dist_torch/csrc/flash_attention.cu",
                          "tpu_dist/ops/flash_attention.py:305"),
    "gmm": ("K3", "cuda", "tpu_dist_torch/csrc/gmm.cu",
            "tpu_dist/ops/gmm.py:74"),
    "tgmm": ("K4", "cuda", "tpu_dist_torch/csrc/gmm.cu",
             "tpu_dist/ops/gmm.py:181"),
    # gmm(activation=): act(acc + bias) in the K3 kernels' epilogue
    "gmm_activation": ("B2", "cuda", "tpu_dist_torch/csrc/gmm.cu",
                       "tpu_dist/ops/gmm.py:141"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 10, warm: int = 2,
            hide_host: bool = False) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds.  With
    ``hide_host`` the start event waits on the card behind a sleep of about
    a millisecond, so the host has enqueued the call before the clock
    starts: the card's own time for it, as in a training step where the
    host runs ahead (a separate reading; ``ms`` everywhere is without)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median host time of one ``fn()`` call started with the card idle:
    the wrapper's own work up to its launch, not the card's."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def split_ms(fn, lib_fn) -> dict:
    """The card's own time of a kernel call and of its library call, and
    the kernel wrapper's host time: what ``ms`` (one call a sample, host
    work included) is made of."""
    return {"device_ms": time_ms(fn, hide_host=True),
            "host_ms": host_ms(fn),
            "library_device_ms": time_ms(lib_fn, hide_host=True)}


def kernel_ms(fn, names: dict, calls: int = 10) -> dict:
    """Card time per call of each kernel whose name contains the given
    fragment, from ``torch.profiler`` over ``calls`` calls of ``fn``
    (``{label: fragment}`` → ``{label: ms}``; None where the profiler saw
    no such kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
        for label, frag in names.items():
            if frag in ev.key:
                out[label] = (out[label] or 0.0) + total / 1e3 / calls
    return out


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, rtol: float, atol: float, atol_row: float = 0.0,
            atol_all: float = 0.0):
    """Hold every element to its own scale: ``|got - want| <= atol +
    atol_row*rms_row(want) + atol_all*rms(want) + rtol*|want|``, where
    ``rms_row`` is the rms of the element's row (its last axis) and ``rms``
    that of the whole tensor.  Returns the max abs error, that error
    relative to max |want|, the margin (the largest error over its limit;
    within tolerance when <= 1) and whether got is finite and within
    tolerance everywhere."""
    got, want = got.detach().float(), want.detach().float()
    diff = (got - want).abs()
    floor = (atol + atol_all * float(want.pow(2).mean().sqrt())
             + atol_row * want.pow(2).mean(-1, keepdim=True).sqrt())
    margin = float((diff / (floor + rtol * want.abs())).max())
    ok = margin <= 1.0 and bool(torch.isfinite(got).all())
    err = float(diff.max())
    return err, err / max(float(want.abs().max()), 1e-30), margin, ok


def offdiag_live(t: int, blocks) -> tuple:
    """The rows offdiag mode reads at Tq = Tk = t (``blocks`` = the clamped
    (bq, bk)): queries from the first whose key limit is above 0 (the rows
    before it see no key), and the keys below the last query's limit."""
    bq, bk = blocks
    return min(-(-bk // bq) * bq, t), min((t - 1) // bq * bq // bk * bk, t)


def causal_pairs(tq: int, tk: int, causal, blocks=None) -> int:
    """The (query, key) pairs a head computes: all, k <= q (causal), or k <
    floor((q // bq) * bq / bk) * bk (offdiag, ``blocks`` = the clamped
    (bq, bk))."""
    if causal == "offdiag":
        bq, bk = blocks
        return sum(min((i // bq) * bq // bk * bk, tk) for i in range(tq))
    if not causal:
        return tq * tk
    return sum(min(i + 1, tk) for i in range(tq))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_cross_entropy(results):
    import torch.nn.functional as F

    from tpu_dist_torch import nn
    from tpu_dist_torch.ops import cross_entropy as ce

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    # path shapes: (B*T, V) = (16384, 32768) bf16, int64 labels
    n, v = 8 * 2048, 32768
    logits = torch.randn(n, v, device=dev, generator=g).to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), device=dev, generator=g)
    cot = torch.rand(n, device=dev, generator=g)

    t0 = time.perf_counter()
    nll_k, lse_k = ce.cross_entropy_fwd(logits, labels)
    torch.cuda.synchronize()
    first_fwd_s = time.perf_counter() - t0
    nll_p, lse_p = ce.cross_entropy_fwd_plain(logits, labels)
    # both reduce the same bf16 inputs in float32, in other orders
    tol_f = {"rtol": 1e-5, "atol": 1e-4,
             "why": "float32 sums of 32768 terms in another order"}
    e1, r1, m1, ok1 = compare(nll_k, nll_p, tol_f["rtol"], tol_f["atol"])
    e2, r2, m2, ok2 = compare(lse_k, lse_p, tol_f["rtol"], tol_f["atol"])
    t0 = time.perf_counter()
    d_k = ce.cross_entropy_bwd(logits, labels, lse_p, cot)
    torch.cuda.synchronize()
    first_bwd_s = time.perf_counter() - t0
    d_p = ce.cross_entropy_bwd_plain(logits, labels, lse_p, cot)
    tol_b = {"rtol": 8e-3, "atol": 1e-8,
             "why": "both round the same float32 value to bf16 (step 2^-8); "
                    "exp differs in the last float32 bits, which can flip "
                    "one rounding"}
    e3, r3, m3, ok3 = compare(d_k, d_p, tol_b["rtol"], tol_b["atol"])

    lg = logits.detach().requires_grad_(True)
    lib_out = F.cross_entropy(lg, labels, reduction="none")
    lib_cot = cot.to(lib_out.dtype)
    t_fwd = (time_ms(lambda: ce.cross_entropy_fwd(logits, labels)),
             time_ms(lambda: ce.cross_entropy_fwd_plain(logits, labels)),
             time_ms(lambda: F.cross_entropy(logits, labels,
                                             reduction="none")))
    t_bwd = (time_ms(lambda: ce.cross_entropy_bwd(logits, labels, lse_p, cot)),
             time_ms(lambda: ce.cross_entropy_bwd_plain(logits, labels,
                                                        lse_p, cot)),
             time_ms(lambda: torch.autograd.grad(lib_out, lg, lib_cot,
                                                 retain_graph=True)))
    el, lb = logits.element_size(), labels.element_size()
    bf = bound(n * v * el + n * lb + 2 * n * 4, 4 * n * v, "f32")
    bb = bound(2 * n * v * el + n * (lb + 8), 4 * n * v, "f32")
    shape = {"logits": [n, v], "dtype": "bfloat16", "labels": "int64"}
    emit("kernel", name="cross_entropy_fwd", shape=shape,
         max_abs_err=max(e1, e2), max_rel_err=max(r1, r2),
         margin={"nll": m1, "lse": m2}, tolerance=tol_f, ok=ok1 and ok2,
         first_call_s=first_fwd_s, ms=t_fwd[0], plain_ms=t_fwd[1],
         library_ms=t_fwd[2], library="F.cross_entropy(reduction='none')",
         bound_ms=bf[0], bound_by=bf[1])
    emit("kernel", name="cross_entropy_bwd", shape=shape, max_abs_err=e3,
         max_rel_err=r3, margin=m3, tolerance=tol_b, ok=ok3,
         first_call_s=first_bwd_s,
         ms=t_bwd[0],
         plain_ms=t_bwd[1], library_ms=t_bwd[2],
         library="F.cross_entropy backward", bound_ms=bb[0], bound_by=bb[1])
    results["cross_entropy_fwd"] = dict(max_abs_err=max(e1, e2), ms=t_fwd[0],
                                        plain_ms=t_fwd[1],
                                        library_ms=t_fwd[2],
                                        bound_ms=bf[0], bound_by=bf[1])
    results["cross_entropy_bwd"] = dict(max_abs_err=e3, ms=t_bwd[0],
                                        plain_ms=t_bwd[1],
                                        library_ms=t_bwd[2],
                                        bound_ms=bb[0], bound_by=bb[1])
    ok = ok1 and ok2 and ok3
    del logits, lg, lib_out, d_k, d_p

    # ragged: (1000, 50257) float32, int32 labels, a tenth ignore_index;
    # the kernels on the masked labels, and the loss module end to end
    n, v = 1000, 50257
    logits = torch.randn(n, v, device=dev, generator=g) * 3
    labels = torch.randint(0, v, (n,), device=dev, generator=g,
                           dtype=torch.int32)
    labels[torch.rand(n, device=dev, generator=g) < 0.1] = -100
    safe = torch.where(labels != -100, labels, torch.zeros_like(labels))
    cot = torch.rand(n, device=dev, generator=g)
    nll_k, lse_k = ce.cross_entropy_fwd(logits, safe)
    nll_p, lse_p = ce.cross_entropy_fwd_plain(logits, safe)
    tol_r = {"rtol": 1e-5, "atol": 1e-4,
             "why": "float32 throughout; sums in another order"}
    e4, r4, m4, ok4 = compare(torch.stack([nll_k, lse_k]),
                              torch.stack([nll_p, lse_p]), tol_r["rtol"],
                              tol_r["atol"])
    e5, r5, m5, ok5 = compare(
        ce.cross_entropy_bwd(logits, safe, lse_p, cot),
        ce.cross_entropy_bwd_plain(logits, safe, lse_p, cot),
        tol_r["rtol"], 1e-7)
    lf = logits.detach().requires_grad_(True)
    loss_k = nn.CrossEntropyLoss(fused=True)(lf, labels)
    (gk,) = torch.autograd.grad(loss_k, lf)
    lp = logits.detach().requires_grad_(True)
    loss_p = nn.CrossEntropyLoss(fused=False)(lp, labels)
    (gp,) = torch.autograd.grad(loss_p, lp)
    e6, r6, m6, ok6 = compare(loss_k, loss_p, tol_r["rtol"], tol_r["atol"])
    e7, r7, m7, ok7 = compare(gk, gp, tol_r["rtol"], 1e-9)
    emit("kernel", name="cross_entropy_ragged",
         shape={"logits": [n, v], "dtype": "float32", "labels": "int32",
                "ignored_rows": int((labels == -100).sum())},
         max_abs_err={"fwd": e4, "bwd": e5, "loss": e6, "loss_grad": e7},
         max_rel_err={"fwd": r4, "bwd": r5, "loss": r6, "loss_grad": r7},
         margin={"fwd": m4, "bwd": m5, "loss": m6, "loss_grad": m7},
         tolerance=tol_r, ok=ok4 and ok5 and ok6 and ok7)
    return ok and ok4 and ok5 and ok6 and ok7


def check_flash(results):
    import torch.nn.functional as F

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    ok_all = True

    def by_design():
        return {k.__name__: dict(k.launches_by_design)
                for k in (fa.flash_fwd, fa.flash_bwd)}

    def run_case(b, t, h, d, dtype, causal, tol, timed):
        nonlocal ok_all
        # q, k, v as the strided views of a fused projection, as on the path
        qkv = torch.randn(b, t, 3, h, d, device=dev, generator=g).to(dtype)
        q, k, v = qkv.unbind(2)
        do = torch.randn(b, t, h, d, device=dev, generator=g).to(dtype)
        scale = 1.0 / math.sqrt(d)
        # the design every launch of the case must take, from the shapes
        design = fa.flash_design(dtype, t, t, d,
                                 [x.stride() for x in (q, k, v)])
        before = by_design()
        t0 = time.perf_counter()
        o_k, lse_k = fa.flash_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
        grads_k = fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale)
        torch.cuda.synchronize()
        grads_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, causal, scale)
        # a second launch of each kernel on the same inputs must agree bit
        # for bit: no atomics, a fixed order of sums
        o_k2, lse_k2 = fa.flash_fwd(q, k, v, causal, scale)
        grads_k2 = fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale)
        torch.cuda.synchronize()
        bitwise = {"fwd": (torch.equal(o_k, o_k2)
                           and torch.equal(lse_k, lse_k2)),
                   "bwd": all(torch.equal(a, b2)
                              for a, b2 in zip(grads_k, grads_k2))}
        after = by_design()
        ran = {k: {dn: after[k][dn] - before[k][dn] for dn in fa.DESIGNS}
               for k in after}
        ok_design = all(ran[k][design] == 2 and sum(ran[k].values()) == 2
                        for k in ran)
        lims = (tol["rtol"], tol["atol"], tol["atol_row"], tol["atol_all"])
        pairs_kp = {"o": (o_k, o_p), "dq": (grads_k[0], grads_p[0]),
                    "dk": (grads_k[1], grads_p[1]),
                    "dv": (grads_k[2], grads_p[2])}
        errs, rels, margins = {}, {}, {}
        ok = True
        for name, (got, want) in pairs_kp.items():
            errs[name], rels[name], margins[name], ok_t = compare(
                got, want, *lims)
            ok = ok and ok_t
        errs["lse"], rels["lse"], margins["lse"], ok_l = compare(
            lse_k, lse_p, 1e-5, 1e-4)
        ok = ok and ok_l and ok_design and all(bitwise.values())
        shape = {"q": [b, t, h, d], "dtype": str(dtype).split(".")[-1],
                 "causal": causal}
        fields = {}
        if timed:
            # the check must reject a kernel that is wrong by a few percent
            # on the later half of the rows (queries for o and dq, keys for
            # dk and dv: the small values under a causal mask)
            caught = {}
            for name, (got, want) in pairs_kp.items():
                bad = got.clone()
                bad[:, t // 2:] *= 1 + SENSITIVITY
                caught[name] = compare(bad, want, *lims)[2]
            fields["sensitivity"] = {"late_half_scaled_by": 1 + SENSITIVITY,
                                     "margin": caught}
            ok = ok and all(m > 1.0 for m in caught.values())
        ok_all = ok_all and ok
        emit("kernel", name="flash", shape=shape, design=design,
             launches_by_design=ran, ok_design=ok_design,
             repeat_bitwise=bitwise, max_abs_err=errs,
             max_rel_err=rels, margin=margins, tolerance=tol, ok=ok,
             first_call_s=first_s, **fields)
        if not timed:
            return
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        def fwd(older=False):
            return fa.flash_fwd(q, k, v, causal, scale, _older=older)

        def bwd(older=False):
            return fa.flash_bwd(q, k, v, do, lse_p, delta, causal, scale,
                                _older=older)

        def lib_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

        def lib_bwd():
            return torch.autograd.grad(lib_o, (qt, kt, vt),
                                       do.transpose(1, 2), retain_graph=True)

        def ab(fn):
            """Same-call times of the design the shape takes and of the
            older mma.sync design, in turns (new, old, old, new): the mean
            of each pair."""
            t_new, t_old = time_ms(fn), time_ms(lambda: fn(True))
            t_old = (t_old + time_ms(lambda: fn(True))) / 2
            return (t_new + time_ms(fn)) / 2, t_old

        t_f = (*ab(fwd),
               time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, scale),
                       reps=5),
               time_ms(lib_fwd))
        t_b = (*ab(bwd),
               time_ms(lambda: fa.flash_bwd_plain(q, k, v, do, lse_p, delta,
                                                  causal, scale), reps=5),
               time_ms(lib_bwd))
        el = q.element_size()
        pairs = b * h * causal_pairs(t, t, causal)
        tile = b * t * h * d * el
        bf = bound(4 * tile + b * h * t * 4, 4 * d * pairs, "bf16_tensor")
        bb = bound(7 * tile + 2 * b * h * t * 4, 10 * d * pairs,
                   "bf16_tensor")
        # the backward's two kernels apart: card time by kernel name
        split_b = kernel_ms(bwd, {"dq_ms": "flash_dq_wgmma_kernel",
                                  "dkv_ms": "flash_dkv_wgmma_kernel"})
        for name, tt, bd, flop, lib, split in (
                ("flash_fwd", t_f, bf, 4 * d * pairs,
                 "F.scaled_dot_product_attention", split_ms(fwd, lib_fwd)),
                ("flash_bwd", t_b, bb, 10 * d * pairs,
                 "F.scaled_dot_product_attention backward",
                 {**split_ms(bwd, lib_bwd), **split_b})):
            emit("kernel", name=name, shape=shape, design=design, ms=tt[0],
                 older_ms=tt[1], plain_ms=tt[2], library_ms=tt[3],
                 library=lib, bound_ms=bd[0], bound_by=bd[1],
                 tflops=flop / tt[0] / 1e9,
                 older_tflops=flop / tt[1] / 1e9,
                 bound_share=bd[0] / tt[0],
                 older_speedup=tt[1] / tt[0], library_ratio=tt[0] / tt[3],
                 **split)
        t_f = (t_f[0], t_f[2], t_f[3])
        t_b = (t_b[0], t_b[2], t_b[3])
        results["flash_fwd"] = dict(max_abs_err=max(errs["o"], errs["lse"]),
                                    ms=t_f[0], plain_ms=t_f[1],
                                    library_ms=t_f[2], bound_ms=bf[0],
                                    bound_by=bf[1])
        results["flash_bwd"] = dict(
            max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]), ms=t_b[0],
            plain_ms=t_b[1], library_ms=t_b[2], bound_ms=bb[0],
            bound_by=bb[1])

    bf16_tol, f32_tol = FLASH_BF16_TOL, FLASH_F32_TOL
    run_case(8, 2048, 12, 64, torch.bfloat16, True, bf16_tol, timed=True)
    # ragged T through the wgmma design (D = 64): a partial last tile of
    # queries and of keys, causal and not
    for causal in (True, False):
        run_case(2, 1000, 3, 64, torch.bfloat16, causal, bf16_tol,
                 timed=False)
    run_case(1, 515, 2, 64, torch.bfloat16, True, bf16_tol, timed=False)
    # a ring hop's shape (a 2048-row shard of RING_SHAPE), causal (the
    # diagonal block) and not (a block below it): full tiles, both modes
    for causal in (True, False):
        run_case(1, 2048, 12, 64, torch.bfloat16, causal, bf16_tol,
                 timed=False)
    # ragged T and D, both head-dim instantiations of the older kernels
    # (D <= 64, D <= 128), both dtypes: the designs flash_design picks
    for dtype, tol in ((torch.bfloat16, bf16_tol), (torch.float32, f32_tol)):
        for causal in (True, False):
            run_case(2, 1000, 3, 40, dtype, causal, tol, timed=False)
        run_case(1, 515, 2, 128, dtype, True, tol, timed=False)
    return ok_all


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

def check_slice(results):
    from tpu_dist_torch.benchmarks.transformer_lm import run

    zero_launch_counts()
    res = run(then=_traced_dense_step)
    traced = res["then"]
    steps, depth = res["steps_run"], res["model"]["depth"]
    # the timed run's counts, read by the hook before its own step
    counts, by_design = traced.pop("counts_before")
    per_step = {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
                "flash_fwd": depth, "flash_bwd": depth}
    ok_counts = all(counts[n] == steps * c for n, c in per_step.items())
    # every flash launch of the path ran the wgmma design
    ok_design = all(d["wgmma"] == counts[n] for n, d in by_design.items())
    ok_loss = all(math.isfinite(x) for x in res["losses"])
    for name in per_step:
        results.setdefault(name, {})["launches"] = counts[name]
    results["_slice"] = {"step_ms": res["step_ms"],
                         "peak_mem_bytes": res["peak_mem_bytes"]}
    emit("slice_trace", **traced)
    emit("slice", tokens_per_s_per_gpu=res["value"], step_ms=res["step_ms"],
         peak_mem_bytes=res["peak_mem_bytes"], n_params=res["n_params"],
         achieved_model_tflops=res["achieved_model_tflops"],
         model=res["model"], steps_run=steps, launches=counts,
         launches_per_step_expected=per_step, ok_launches=ok_counts,
         launches_by_design=by_design, ok_design=ok_design,
         losses=res["losses"], ok_losses_finite=ok_loss)
    return ok_counts and ok_design and ok_loss and all(
        traced["checks"].values()) and traced["launches"] == {
            k: v // steps for k, v in counts.items() if k in per_step}


# K1f, K1b, K2f, K2b: the kernel-name fragments a profiler trace shows
# (K2b launches a dQ and a dK/dV kernel a call)
TRACE_KERNELS = {"cross_entropy_fwd": ("cross_entropy_fwd_kernel",),
                 "cross_entropy_bwd": ("cross_entropy_bwd_kernel",),
                 "flash_fwd": ("flash_fwd_",),
                 "flash_bwd": ("flash_dq_", "flash_dkv_")}


def _traced_dense_step(ddp, state, x, y) -> dict:
    """One untimed full-width dense step (the ``slice`` cell's trained
    model, after its timed steps) inside ``utils.profiler.trace``:
    ``{"kernels_in_trace", "launches", "memory", "checks", ...}``.  The
    trace's kernel events of K1f/K1b/K2f/K2b must number the wrappers'
    launches of that step (two K2b kernels a launch); ``utils.memory``
    must read ``torch.cuda``'s own numbers right after it.
    ``counts_before``: the timed run's launch counts and launches by
    design, read first."""
    import tempfile

    from tpu_dist_torch.ops import KERNELS
    from tpu_dist_torch.utils import memory, profiler

    t0 = time.perf_counter()
    counts_before = ({k.__name__: k.launches for k in KERNELS},
                     {k.__name__: dict(k.launches_by_design)
                      for k in KERNELS if hasattr(k, "launches_by_design")})
    logdir = tempfile.mkdtemp(prefix="slice_trace_",
                              dir=os.environ.get("TMPDIR"))
    zero_launch_counts()
    with profiler.trace(logdir):
        state, m = ddp.train_step(state, x, y)
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    loss = float(m["loss"])
    counts = {k.__name__: k.launches for k in KERNELS}
    dev = ddp.device
    mem = {"memory_allocated": [memory.memory_allocated(),
                                torch.cuda.memory_allocated(dev)],
           "max_memory_allocated": [memory.max_memory_allocated(),
                                    torch.cuda.max_memory_allocated(dev)],
           "mem_get_info_total": [memory.mem_get_info()[1],
                                  torch.cuda.mem_get_info(dev)[1]]}
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    in_trace = {k: sum(1 for n in kernels if any(frag in n for frag in frags))
                for k, frags in TRACE_KERNELS.items()}
    launches = {k: counts[k] for k in TRACE_KERNELS}
    checks = {
        "trace_equals_launches": all(
            in_trace[k] == launches[k] * len(TRACE_KERNELS[k])
            for k in TRACE_KERNELS),
        "loss_finite": math.isfinite(loss),
        "memory_equals_torch_cuda": all(a == b and a > 0
                                        for a, b in mem.values())}
    return {"trace_file_bytes": os.path.getsize(os.path.join(logdir, name)),
            "kernel_events": len(kernels), "kernels_in_trace": in_trace,
            "launches": launches, "memory": mem, "loss": loss,
            "traced_step_seconds": step_s,
            "seconds": time.perf_counter() - t0, "checks": checks,
            "counts_before": counts_before}


COMPOSITION_TOL = {
    "loss_rtol": 1e-2, "update_rel": 5e-2, "attn_leaf_update_rel": 3e-2,
    "leaf_update_rel": 0.25,
    "why": "bf16 compute on both paths: the plain loss is a bf16 mean (step "
           "2^-8 relative) and dense attention rounds its scores and softmax "
           "to bf16 where the kernel keeps float32. Leaf limits are twice the "
           "worst leaf errors measured on an H100 (attention 1.5e-2; any leaf "
           "0.125, a LayerNorm gain, whose gradient is a sum over all 16384 "
           "tokens that mostly cancels); the run is seeded and its kernels "
           "deterministic"}


# ROADMAP C13: a change of split (data, expert or model ranks) rounds every
# bf16 gradient otherwise, so a split's bf16 step is held to world 1's
# float32 step relative to world 1's own bf16 step
SPLIT_BF16_TOL = {
    "k": 1.25, "loss_rtol": COMPOSITION_TOL["loss_rtol"],
    "why": "the ranks' bf16 updates may lie no further from world 1's "
           "float32 updates than k times world 1's own bf16 updates do: "
           "the measured ratio was 1.005 (0.2359 against 0.2346) at data 2 "
           "x expert 2 on four H100s at 700 W (ep_train --ep-world 4), "
           "and k = 1.25 leaves room for another split's rounding while a "
           "wrong "
           "gradient (a missed sum or a double count: an update off by "
           "50% or more in some leaf) lands far outside; losses as "
           "COMPOSITION_TOL"}


def split_bf16_check(upd_w1_f32, upd_w1_bf16, upd_ranks_bf16) -> tuple:
    """The C13 rule: ``(ok, fields)`` with the ranks' and world 1's bf16
    update distances from world 1's float32 updates (each a ``{name:
    tensor}`` of the same leaves, on the host)."""
    zero = dict.fromkeys(upd_w1_f32, 0.0)
    w1_rel, _, w1_groups = _update_diff(zero, upd_w1_bf16, upd_w1_f32)
    n_rel, _, n_groups = _update_diff(zero, upd_ranks_bf16, upd_w1_f32)
    ratio = n_rel / w1_rel if w1_rel else math.inf
    return ratio <= SPLIT_BF16_TOL["k"], dict(
        world1_bf16_from_f32=w1_rel, ranks_bf16_from_f32=n_rel,
        ratio=ratio, world1_worst_by_group=w1_groups,
        ranks_worst_by_group=n_groups)


def step_vs_plain(**build_kw):
    """One step of the dense kernel path (``transformer_lm.build(**build_kw)``
    on the card) against the plain composition (dense attention, unfused
    loss) from the same seed and batch: ``(fields, ok)``."""
    from tpu_dist_torch import nn, optim
    from tpu_dist_torch.benchmarks.transformer_lm import build
    from tpu_dist_torch.parallel import DistributedDataParallel

    ddp, x, y = build(device="cuda", **build_kw)
    state = ddp.init(seed=0)
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    state, m_k = ddp.train_step(state, x, y)
    upd_k = {k: state.params[k].detach() - p0[k] for k in p0}
    plain = DistributedDataParallel(
        ddp.module, optimizer=optim.SGD(lr=0.01),
        loss_fn=nn.CrossEntropyLoss(fused=False),
        compute_dtype=torch.bfloat16)
    state_p = plain.init(seed=0)
    same_init = all(torch.equal(state_p.params[k], p0[k]) for k in p0)
    with nn.attention_impl("dense"):
        state_p, m_p = plain.train_step(state_p, x, y)
    # the relative error of each leaf's update, so that a fault confined to
    # the attention leaves is not hidden under the embedding and head
    num, den = {}, {}
    with torch.no_grad():
        for k in p0:
            upd_p = state_p.params[k] - p0[k]
            num[k] = float((upd_p - upd_k[k]).pow(2).sum())
            den[k] = float(upd_p.pow(2).sum())
    rel = math.sqrt(sum(num.values()) / sum(den.values()))
    leaf = {k: math.sqrt(num[k] / den[k]) if den[k] else
            (0.0 if num[k] == 0 else math.inf) for k in p0}
    worst = max(leaf, key=leaf.get)
    attn = {k: e for k, e in leaf.items() if ".attn." in k}
    worst_attn = max(attn, key=attn.get)
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    tol = COMPOSITION_TOL
    ok = (same_init and abs(loss_k - loss_p) <= tol["loss_rtol"] * abs(loss_p)
          and rel <= tol["update_rel"]
          and attn[worst_attn] <= tol["attn_leaf_update_rel"]
          and leaf[worst] <= tol["leaf_update_rel"])
    return dict(loss_kernel_path=loss_k, loss_plain_path=loss_p,
                update_rel_err=rel, worst_leaf=[worst, leaf[worst]],
                worst_attn_leaf=[worst_attn, attn[worst_attn]],
                worst_leaves=sorted(leaf.items(), key=lambda kv: -kv[1])[:5],
                same_init=same_init, tolerance=tol), ok


def check_composition(results):
    """One step of the kernel path against the plain composition (dense
    attention, unfused loss) from the same seed and batch."""
    fields, ok = step_vs_plain()
    emit("composition", **fields, ok=ok)
    return ok


# ---------------------------------------------------------------------------
# the grouped matmuls (K3 gmm, K4 tgmm) against their plain versions
# ---------------------------------------------------------------------------

def grouped_case(counts, b, d, h, dtype, g, g_w2=None):
    """The MoE layer's layout for the given tokens per expert: rows sorted
    by expert into segments padded to ``b`` rows (padding rows zero), the
    static bound of ``ceil(kN/b) + E`` blocks with the tail on the last
    expert.  Returns x (M, d), dy (M, h) (zero on padding rows, as the
    backward gives), w (E, d, h), w2 (E, h, d) (from ``g_w2`` if given),
    bias (E, h), the block map, the live-block count and the padded segment
    ends."""
    e, kn = len(counts), sum(counts)
    nb = -(-kn // b) + e
    mask = torch.zeros(nb * b, dtype=torch.bool)
    bg, start = [], 0
    for i, c in enumerate(counts):
        blocks = -(-c // b)
        mask[start:start + c] = True
        bg += [i] * blocks
        start += blocks * b
    n_live = len(bg)
    bg += [e - 1] * (nb - n_live)
    ends = torch.tensor([sum(-(-c // b) * b for c in counts[:i + 1])
                         for i in range(e)], dtype=torch.int32)
    dev = "cuda"
    mask = mask.to(dev)[:, None]
    x = (torch.randn(nb * b, d, device=dev, generator=g) * mask).to(dtype)
    dy = (torch.randn(nb * b, h, device=dev, generator=g) * mask).to(dtype)
    w = (torch.randn(e, d, h, device=dev, generator=g) / math.sqrt(d)
         ).to(dtype)
    bias = torch.randn(e, h, device=dev, generator=g).to(dtype)
    w2 = (torch.randn(e, h, d, device=dev, generator=g_w2 or g)
          / math.sqrt(h)).to(dtype)
    return dict(x=x, dy=dy, w=w, w2=w2, bias=bias,
                bg=torch.tensor(bg, dtype=torch.int32, device=dev),
                n_live=torch.tensor([n_live], dtype=torch.int32, device=dev),
                ends=ends.to(dev), routed=kn)


def launches_by_design(gm):
    """A copy of each grouped kernel's launch counts by design."""
    return {k.__name__: dict(k.launches_by_design) for k in (gm.gmm, gm.tgmm)}


def zero_launch_counts():
    """Every kernel's launch count, and the grouped kernels' counts by
    design, set to 0 just before a slice is driven."""
    from tpu_dist_torch.ops import KERNELS
    for k in KERNELS:
        k.launches = 0
        for by in ("launches_by_design", "launches_by_mode",
                   "launches_by_activation"):
            if hasattr(k, by):
                getattr(k, by).update(dict.fromkeys(getattr(k, by), 0))


def library_grouped(fn_variants):
    """The first variant of a PyTorch grouped-product call that runs here
    (layout rules differ between versions): ``(label, fn)`` or ``(None,
    None)``.  A yardstick only; the port never calls it."""
    for label, fn in fn_variants:
        try:
            fn()
            torch.cuda.synchronize()
            return label, fn
        except Exception as exc:  # try the next layout
            print(f"chip_smoke: {label}: {type(exc).__name__}: {exc}"[:300],
                  file=sys.stderr)
    return None, None


def check_gmm(results):
    gm = importlib.import_module("tpu_dist_torch.ops.gmm")

    g = torch.Generator(device="cuda").manual_seed(3)
    ok_all = True
    bf16_tol = {"rtol": 8e-3, "atol": 0.0, "atol_row": 0.0, "atol_all": 1e-5,
                "why": "kernel and plain sum the same exact bf16 products in "
                       "float32 in other orders and round once to bf16, which "
                       "can flip one rounding: one bf16 step, at most 2^-7 "
                       "of the value; plus 1e-5 of the tensor's rms for an "
                       "element that sums to near 0"}
    f32_tol = {"rtol": 1e-5, "atol": 0.0, "atol_row": 0.0, "atol_all": 1e-6,
               "why": "float32 throughout, sums in other orders (the CPU "
                      "parity tests' 1e-5 relative); 1e-6 of the tensor's "
                      "rms for an element that sums to near 0"}

    def lims(tol):
        return tol["rtol"], tol["atol"], 0.0, tol["atol_all"]

    def run_case(name, c, b, tol, design, out_dtype=None, timed=False):
        """``design``: the kernel design every launch of the case must
        take (gm.gmm_design of its shapes)."""
        nonlocal ok_all
        x, dy, w, bias, bg, n_live = (c[k] for k in ("x", "dy", "w", "bias",
                                                     "bg", "n_live"))
        e = w.shape[0]
        before = launches_by_design(gm)
        t0 = time.perf_counter()
        out_k = gm.gmm(x, w, bg, n_live, bias=bias, block_rows=b,
                       out_dtype=out_dtype)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        out_p = gm.gmm_plain(x, w, bg, n_live, bias=bias, block_rows=b,
                             out_dtype=out_dtype)
        dx_k = gm.gmm(dy, w.transpose(1, 2), bg, n_live, block_rows=b)
        dx_p = gm.gmm_plain(dy, w.transpose(1, 2), bg, n_live, block_rows=b)
        dw_k, db_k = gm.tgmm(x, dy, bg, e, block_rows=b, with_rowsum=True,
                             out_dtype=out_dtype, n_live_blocks=n_live)
        dw_p, db_p = gm.tgmm_plain(x, dy, bg, e, block_rows=b,
                                   with_rowsum=True, out_dtype=out_dtype,
                                   n_live_blocks=n_live)
        # the other two forms of the path: w2 (H -> D) forward, and its dx
        # pass through the transpose view of the contiguous (E, H, D) w2
        w2 = c["w2"]
        pairs = {"out": (out_k, out_p), "dx": (dx_k, dx_p),
                 "dw": (dw_k, dw_p), "db": (db_k, db_p)}
        for key, (a, wm) in {"out_w2": (dy, w2),
                             "dx_w2": (x, w2.transpose(1, 2))}.items():
            if x.dtype == torch.bfloat16:  # float32 keeps its two forms
                pairs[key] = (gm.gmm(a, wm, bg, n_live, block_rows=b),
                              gm.gmm_plain(a, wm, bg, n_live, block_rows=b))
        # a second tgmm launch must agree bit for bit: no atomics
        dw_k2, db_k2 = gm.tgmm(x, dy, bg, e, block_rows=b, with_rowsum=True,
                               out_dtype=out_dtype, n_live_blocks=n_live)
        torch.cuda.synchronize()
        bitwise = torch.equal(dw_k, dw_k2) and torch.equal(db_k, db_k2)
        errs, margins, ok = {}, {}, bitwise
        for key, (got, want) in pairs.items():
            errs[key], _, margins[key], ok_t = compare(got, want, *lims(tol))
            ok = ok and ok_t
        # the dx form reads w^T through a transpose view; a contiguous copy
        # of w^T (the other layout of the kernel) gives the same products
        errs["dx_contig"], _, margins["dx_contig"], ok_t = compare(
            gm.gmm(dy, w.transpose(1, 2).contiguous(), bg, n_live,
                   block_rows=b), dx_p, *lims(tol))
        ok = ok and ok_t
        fields = {}
        if timed:
            # planted faults the check must reject: two experts' weights
            # swapped, one block sent to another expert, and two experts'
            # weight gradients swapped
            w_bad = w.clone()
            w_bad[[0, 1]] = w[[1, 0]]
            bg_bad = bg.clone()
            bg_bad[0] = (bg[0] + 1) % e
            caught = {
                "w_swapped": compare(gm.gmm(x, w_bad, bg, n_live, bias=bias,
                                            block_rows=b), out_p,
                                     *lims(tol))[2],
                "block_to_other_expert": compare(
                    gm.gmm(x, w, bg_bad, n_live, bias=bias, block_rows=b),
                    out_p, *lims(tol))[2],
                "dw_swapped": compare(dw_k[[1, 0, *range(2, e)]], dw_p,
                                      *lims(tol))[2]}
            fields["planted_faults_margin"] = caught
            ok = ok and all(m > 1.0 for m in caught.values())
        after = launches_by_design(gm)
        ran = {k: {d: after[k][d] - before[k][d] for d in gm.DESIGNS}
               for k in after}
        ok_design = all(ran[k][design] > 0 and sum(ran[k].values())
                        == ran[k][design] for k in ran)
        ok = ok and ok_design
        ok_all = ok_all and ok
        counts = torch.diff(c["ends"], prepend=c["ends"][:1] * 0)
        emit("kernel", name=name, design=design, launches_by_design=ran,
             ok_design=ok_design, tgmm_repeat_bitwise=bitwise,
             shape={"x": list(x.shape), "w": list(w.shape),
                    "dtype": str(x.dtype).split(".")[-1], "block_rows": b,
                    "out_dtype": str(out_dtype or x.dtype).split(".")[-1],
                    "padded_rows_per_expert": counts.tolist(),
                    "routed_rows": c["routed"],
                    "live_blocks": int(n_live), "blocks": bg.numel()},
             max_abs_err=errs, margin=margins, tolerance=tol, ok=ok,
             first_call_s=first_s, **fields)
        if not timed:
            return
        ends = c["ends"]
        live = int(n_live) * b
        el = x.element_size()

        def lib_gmm(a, bmat):
            return [("torch._grouped_mm", lambda: torch._grouped_mm(
                        a[:live], bmat, offs=ends)),
                    ("torch._grouped_mm (column-major b)",
                     lambda: torch._grouped_mm(
                         a[:live], bmat.transpose(1, 2).contiguous()
                         .transpose(1, 2), offs=ends))]

        def ab(new, old):
            """Same-call times of the new design and the older one, taken
            in turns (new, old, old, new): the mean of each pair."""
            t_new, t_old = time_ms(new), time_ms(old)
            t_old = (t_old + time_ms(old)) / 2
            return (t_new + time_ms(new)) / 2, t_old

        forms = {}
        # the four grouped products of the path: w1 (D->H) and w2 (H->D)
        # forward, and their dx passes against w^T (transpose views); the
        # kernels line keeps the w1 form
        w2 = c["w2"]
        for form, (a, bm, bb) in {"w1": (x, w, bias),
                                  "w2": (dy, w2, None),
                                  "dx_w1T": (dy, w.transpose(1, 2), None),
                                  "dx_w2T": (x, w2.transpose(1, 2), None)
                                  }.items():
            k_dim, n_dim = bm.shape[1], bm.shape[2]
            label, lib_fn = library_grouped(lib_gmm(a, bm))
            if lib_fn is None:
                dense = a[:c["routed"]]
                label = "torch.matmul dense (same live-row product)"
                lib_fn = (lambda dense=dense, w0=bm[0]: dense @ w0)
            new = (lambda a=a, bm=bm, bb=bb: gm.gmm(a, bm, bg, n_live,
                                                    bias=bb, block_rows=b))
            t_new, t_old = ab(
                new,
                lambda a=a, bm=bm, bb=bb: gm.gmm(a, bm, bg, n_live, bias=bb,
                                                 block_rows=b,
                                                 _older=True))
            flop = 2 * c["routed"] * k_dim * n_dim
            forms[form] = {
                **split_ms(new, lib_fn),
                "ms": t_new, "mma_sync_ms": t_old,
                "plain_ms": time_ms(lambda a=a, bm=bm, bb=bb: gm.gmm_plain(
                    a, bm, bg, n_live, bias=bb, block_rows=b), reps=3),
                "library_ms": time_ms(lib_fn), "library": label,
                "bound": bound(c["routed"] * k_dim * el
                               + e * k_dim * n_dim * el
                               + a.shape[0] * n_dim * el, flop,
                               "bf16_tensor"),
                "tflops": flop / t_new / 1e9,
                "mma_sync_tflops": flop / t_old / 1e9}
        d, h = x.shape[1], dy.shape[1]
        label, lib_fn = library_grouped([
            ("torch._grouped_mm (x^T . dy)", lambda: torch._grouped_mm(
                x[:live].t(), dy[:live], offs=ends)),
            ("torch._grouped_mm (x^T . dy, row-major a)",
             lambda: torch._grouped_mm(x[:live].t().contiguous(), dy[:live],
                                       offs=ends))])
        if lib_fn is None:
            label = "torch.matmul dense (same live-row product)"
            xr, dyr = x[:c["routed"]], dy[:c["routed"]]
            lib_fn = lambda: xr.t() @ dyr  # noqa: E731
        def new():
            return gm.tgmm(x, dy, bg, e, block_rows=b, with_rowsum=True,
                           n_live_blocks=n_live)

        t_new, t_old = ab(
            new,
            lambda: gm.tgmm(x, dy, bg, e, block_rows=b, with_rowsum=True,
                            n_live_blocks=n_live, _older=True))
        split_t = split_ms(new, lib_fn)
        t_t = (t_new,
               time_ms(lambda: gm.tgmm_plain(x, dy, bg, e, block_rows=b,
                                             with_rowsum=True,
                                             n_live_blocks=n_live), reps=3),
               time_ms(lib_fn))
        flop_t = 2 * c["routed"] * d * h
        bt = bound(c["routed"] * (d + h) * el + e * (d * h + h) * el,
                   flop_t, "bf16_tensor")
        for form, f in forms.items():
            emit("kernel", name=f"gmm_{form}", ms=f["ms"],
                 mma_sync_ms=f["mma_sync_ms"], plain_ms=f["plain_ms"],
                 library_ms=f["library_ms"], library=f["library"],
                 bound_ms=f["bound"][0], bound_by=f["bound"][1],
                 tflops=f["tflops"], mma_sync_tflops=f["mma_sync_tflops"],
                 device_ms=f["device_ms"], host_ms=f["host_ms"],
                 library_device_ms=f["library_device_ms"])
        emit("kernel", name="tgmm_w1", ms=t_t[0], mma_sync_ms=t_old,
             plain_ms=t_t[1], library_ms=t_t[2], library=label,
             bound_ms=bt[0], bound_by=bt[1], tflops=flop_t / t_t[0] / 1e9,
             mma_sync_tflops=flop_t / t_old / 1e9, **split_t)
        f = forms["w1"]
        results["gmm"] = dict(
            max_abs_err=max(errs[k] for k in ("out", "dx", "out_w2",
                                              "dx_w2")),
            ms=f["ms"], plain_ms=f["plain_ms"], library_ms=f["library_ms"],
            bound_ms=f["bound"][0], bound_by=f["bound"][1])
        results["tgmm"] = dict(max_abs_err=max(errs["dw"], errs["db"]),
                               ms=t_t[0], plain_ms=t_t[1],
                               library_ms=t_t[2], bound_ms=bt[0],
                               bound_by=bt[1])

    # path shapes: 16384 tokens routed top-2 of 8 by a random router, block
    # rows 512 (the MoE layer's choice at kN = 32768), D = 768, H = 3072
    probs = torch.randn(16384, 8, device="cuda", generator=g).softmax(-1)
    top2 = probs.topk(2, dim=-1).indices.reshape(-1)
    counts = torch.bincount(top2, minlength=8).tolist()
    run_case("grouped_path", grouped_case(counts, 512, 768, 3072,
                                          torch.bfloat16, g),
             512, bf16_tol, "wgmma", timed=True)
    # ragged: block rows 8 and 24, D and H not multiples of 64, one expert
    # with no rows, dead tail blocks; float32 output of bf16 once.  Their w2
    # (the forms added after these cases were first drawn) comes from a
    # generator of its own, so x, dy, w and bias stay as they were
    ragged = [37, 0, 81, 5, 60]
    g_w2 = torch.Generator(device="cuda").manual_seed(5)
    for dtype, tol, design in ((torch.bfloat16, bf16_tol, "mma_sync"),
                               (torch.float32, f32_tol, "fma")):
        for b in (8, 24):
            out_dtype = (torch.float32 if dtype == torch.bfloat16 and b == 24
                         else None)
            run_case("grouped_ragged",
                     grouped_case(ragged, b, 200, 360, dtype, g, g_w2), b,
                     tol, design, out_dtype=out_dtype)
    # the wgmma design off the path's shapes: block rows 128, D = 256, H =
    # 640 (a partial 192-wide column tile), one expert with no rows, dead
    # tail blocks
    run_case("grouped_wgmma_small",
             grouped_case([300, 0, 517, 129, 64], 128, 256, 640,
                          torch.bfloat16, g, g_w2), 128, bf16_tol, "wgmma")
    ok_b2 = check_gmm_activation(results, bf16_tol, f32_tol)
    return ok_all and ok_b2


def check_gmm_activation(results, bf16_tol, f32_tol):
    """B2, ``gmm(activation=)``, inside the ``gmm`` phase: every activation
    in every design against ``gmm_plain`` with the same callable (the K3
    tolerances), the dead tail exact zeros, planted faults rejected, an
    unknown callable refused; the B2 launches of these checks are the
    kernels line's.  Then the path shape timed with ``gelu_tanh``."""
    import functools

    import torch.nn.functional as F

    gm = importlib.import_module("tpu_dist_torch.ops.gmm")
    acts = {"gelu_tanh": gm.gelu_tanh, "gelu": F.gelu, "relu": F.relu,
            "silu": F.silu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}
    ok_all = set(acts) == set(gm.ACTIVATIONS)
    g = torch.Generator(device="cuda").manual_seed(7)
    probs = torch.randn(16384, 8, device="cuda", generator=g).softmax(-1)
    counts = torch.bincount(probs.topk(2, dim=-1).indices.reshape(-1),
                            minlength=8).tolist()
    path = grouped_case(counts, 512, 768, 3072, torch.bfloat16, g)
    ragged = [37, 0, 81, 5, 60]
    bf16_ragged = grouped_case(ragged, 24, 200, 360, torch.bfloat16, g)
    f32_ragged = grouped_case(ragged, 8, 200, 360, torch.float32, g)

    def b2_compare(got, want, pre, tol):
        """K3's tolerance carried through the activation: the kernel's and
        the plain version's sums differ as K3's do, and an activation
        moves that difference by at most its slope (1.13 for the GELUs, at
        most 1.1 for the other four), so the floor is 1.13 x atol_all of
        the rms of the sums before the activation (the rms of its output
        would shrink it where relu or tanh flatten the sums)."""
        return compare(got, want, tol["rtol"], 1.13 * tol["atol_all"]
                       * float(pre.float().pow(2).mean().sqrt()))

    # (case, block_rows, weights, bias, out_dtype, design, tolerance,
    # activations, _older): the path's w1 form in wgmma with each
    # activation, its float32-output store, the transpose-view weights (the
    # K-major kernel) with sigmoid (act(0) = 0.5, so a dead-tail leak
    # shows), mma_sync on the path shape and at a ragged one, fma in
    # float32; the tolerance by input type, as run_case's
    cases = {
        "wgmma": (path, 512, path["w"], path["bias"], None, "wgmma",
                  bf16_tol, list(acts), False),
        "wgmma_f32_out": (path, 512, path["w"], path["bias"], torch.float32,
                          "wgmma", bf16_tol, ["gelu_tanh"], False),
        "wgmma_w_view": (path, 512, path["w2"].transpose(1, 2), None, None,
                         "wgmma", bf16_tol, ["sigmoid"], False),
        "mma_sync_older": (path, 512, path["w"], path["bias"], None,
                           "mma_sync", bf16_tol, list(acts), True),
        "mma_sync_ragged": (bf16_ragged, 24, bf16_ragged["w"],
                            bf16_ragged["bias"], None, "mma_sync", bf16_tol,
                            list(acts), False),
        "mma_sync_ragged_f32_out": (bf16_ragged, 24, bf16_ragged["w"],
                                    bf16_ragged["bias"], torch.float32,
                                    "mma_sync", bf16_tol, ["silu"], False),
        "fma": (f32_ragged, 8, f32_ragged["w"], f32_ragged["bias"], None,
                "fma", f32_tol, list(acts), False),
    }
    gm.gmm.launches_by_activation.update(
        dict.fromkeys(gm.gmm.launches_by_activation, 0))
    calls, path_errs = 0, []
    for label, (c, b, w, bias, out_dtype, design, tol, names,
                older) in cases.items():
        x, bg, n_live = c["x"], c["bg"], c["n_live"]
        dead = int(n_live) * b
        errs, margins, ok, dead_zero = {}, {}, True, True
        # the sums before the activation: the floor of the tolerance, and a
        # planted fault (the product without its activation)
        pre = gm.gmm_plain(x, w, bg, n_live, bias=bias, block_rows=b,
                           out_dtype=out_dtype)
        before = dict(gm.gmm.launches_by_design)
        for name in names:
            out_k = gm.gmm(x, w, bg, n_live, bias=bias, block_rows=b,
                           out_dtype=out_dtype, activation=acts[name],
                           _older=older)
            out_p = gm.gmm_plain(x, w, bg, n_live, bias=bias, block_rows=b,
                                 out_dtype=out_dtype, activation=acts[name])
            calls += 1
            errs[name], _, margins[name], ok_t = b2_compare(out_k, out_p,
                                                            pre, tol)
            dead_zero = dead_zero and not out_k[dead:].any()
            ok = ok and ok_t and dead_zero
        ran = {d: gm.gmm.launches_by_design[d] - before[d]
               for d in gm.DESIGNS}
        ok_design = ran[design] == len(names) == sum(ran.values())
        # planted faults: the product without its activation, and in
        # float32 the tanh GELU held to the erf one (jax.nn.gelu's trap)
        caught = {"no_activation": b2_compare(out_k, pre, pre, tol)[2]}
        if x.dtype == torch.float32:
            caught["tanh_gelu_as_erf"] = b2_compare(
                gm.gmm(x, w, bg, n_live, bias=bias, block_rows=b,
                       activation=gm.gelu_tanh),
                gm.gmm_plain(x, w, bg, n_live, bias=bias, block_rows=b,
                             activation=F.gelu), pre, tol)[2]
            calls += 1
        torch.cuda.synchronize()
        ok = ok and ok_design and all(m > 1.0 for m in caught.values())
        ok_all = ok_all and ok
        if design == "wgmma":
            path_errs += list(errs.values())
        emit("kernel", name=f"gmm_activation_{label}", design=design,
             launches_by_design=ran, ok_design=ok_design,
             shape={"x": list(x.shape), "w": list(w.shape),
                    "dtype": str(x.dtype).split(".")[-1], "block_rows": b,
                    "out_dtype": str(out_dtype or x.dtype).split(".")[-1],
                    "bias": bias is not None, "live_blocks": int(n_live),
                    "blocks": bg.numel()},
             max_abs_err=errs, margin=margins, dead_tail_zero=dead_zero,
             planted_faults_margin=caught, tolerance=tol["why"][:60], ok=ok)
    # refused on the card, before any launch: callables with no epilogue
    before = gm.gmm.launches
    refused = {}
    for label, fn in {"lambda": lambda v: v,
                      "partial_gelu_tanh": functools.partial(
                          F.gelu, approximate="tanh")}.items():
        try:
            gm.gmm(path["x"], path["w"], path["bg"], path["n_live"],
                   block_rows=512, activation=fn)
            refused[label] = False
        except ValueError as exc:
            refused[label] = "no epilogue" in str(exc)
    by_act = dict(gm.gmm.launches_by_activation)
    ok_refused = all(refused.values()) and gm.gmm.launches == before
    ok_count = sum(by_act.values()) == calls
    ok_all = ok_all and ok_refused and ok_count

    # the path shape, gelu_tanh: B2 and K3 alone in turns (b2, k3, k3,
    # b2), B2 also without the bias; the plain version; the two-call
    # composition, which has no bias (torch._grouped_mm takes none), beside
    # B2 without it
    x, w, bias, bg, n_live = (path[k] for k in ("x", "w", "bias", "bg",
                                                 "n_live"))
    live, ends = int(n_live) * 512, path["ends"]

    def b2(bb=bias):
        return gm.gmm(x, w, bg, n_live, bias=bb, block_rows=512,
                      activation=gm.gelu_tanh)

    def k3(bb=bias):
        return gm.gmm(x, w, bg, n_live, bias=bb, block_rows=512)

    t = {"b2": time_ms(b2), "k3": time_ms(k3)}
    t["k3"] = (t["k3"] + time_ms(k3)) / 2
    t["b2"] = (t["b2"] + time_ms(b2)) / 2
    t["b2_no_bias"] = time_ms(lambda: b2(None))
    t["b2_device"] = time_ms(b2, hide_host=True)
    t["k3_device"] = time_ms(k3, hide_host=True)
    t["plain"] = time_ms(lambda: gm.gmm_plain(
        x, w, bg, n_live, bias=bias, block_rows=512,
        activation=gm.gelu_tanh), reps=3)
    label, grouped = library_grouped(
        [("torch._grouped_mm", lambda: torch._grouped_mm(x[:live], w,
                                                         offs=ends)),
         ("torch._grouped_mm (column-major b)", lambda: torch._grouped_mm(
             x[:live], w.transpose(1, 2).contiguous().transpose(1, 2),
             offs=ends))])
    comp = {"composition": f"{label} + F.gelu(approximate='tanh')"
            if grouped else None}
    if grouped:
        def composed():
            return F.gelu(grouped(), approximate="tanh")

        t["composition"] = time_ms(composed)
        t["composition_device"] = time_ms(composed, hide_host=True)
        # the yardstick computes the same function as B2 without the bias:
        # it rounds the product to bf16 before the GELU (half a bf16 step
        # of the product, times the slope, at most 1.13) and the GELU's
        # output after it, B2 only the output; sums in other orders may
        # flip each rounding, so twice those, plus 1e-5 of the rms
        want = b2(None)[:live].float()
        pre = k3(None)[:live].float()
        limit = (2.0 ** -7 * (1.13 * pre.abs() + want.abs())
                 + 1e-5 * float(want.pow(2).mean().sqrt()))
        comp["composition_margin"] = float(
            ((composed().float() - want).abs() / limit).max())
        del want, pre, limit
    el, (e, d, h) = x.element_size(), w.shape
    # bytes: x's routed rows, w, the bias read once, the output written;
    # operations: the routed rows' products on the tensor cores, and the
    # tanh GELU's 9 float32 operations on each live output (x sigmoid(2u),
    # its exponential and reciprocal one each; CUDA cores, alongside: the
    # bound is the larger)
    bytes_b2 = (path["routed"] * d + e * d * h + e * h
                + x.shape[0] * h) * el
    bt = bound(bytes_b2, 2 * path["routed"] * d * h, "bf16_tensor")
    act_ms = live * h * 9 / PEAK_OPS_S["f32"] * 1e3
    bound_b2 = max(bt, (act_ms, "operations"))
    results["gmm_activation"] = dict(
        launches=sum(by_act.values()), max_abs_err=max(path_errs),
        ms=t["b2"], plain_ms=t["plain"], library_ms=None,
        bound_ms=bound_b2[0], bound_by=bound_b2[1])
    emit("kernel", name="gmm_activation", activation="gelu_tanh",
         ms=t["b2"], k3_ms=t["k3"], b2_over_k3=t["b2"] / t["k3"],
         device_ms=t["b2_device"], k3_device_ms=t["k3_device"],
         no_bias_ms=t["b2_no_bias"],
         plain_ms=t["plain"], composition_ms=t.get("composition"),
         composition_device_ms=t.get("composition_device"), **comp,
         library_ms=None, bound_ms=bound_b2[0], bound_by=bound_b2[1],
         activation_ops_ms=act_ms, launches_by_activation=by_act,
         launches=sum(by_act.values()), calls=calls, ok_count=ok_count,
         refused=refused, ok_refused=ok_refused,
         tflops=2 * path["routed"] * d * h / t["b2"] / 1e9)
    if grouped:
        ok_all = ok_all and comp["composition_margin"] <= 1.0
    return ok_all


# ---------------------------------------------------------------------------
# the MoE slice
# ---------------------------------------------------------------------------

def check_moe_slice(results):
    from tpu_dist_torch.benchmarks.moe_lm import run
    from tpu_dist_torch.ops import KERNELS, gmm

    zero_launch_counts()
    res = run(dispatch="dropless")
    counts = {k.__name__: k.launches for k in KERNELS}
    steps, depth = res["steps_run"], res["model"]["depth"]
    per_step = {"gmm": 4 * depth, "tgmm": 2 * depth, "cross_entropy_fwd": 1,
                "cross_entropy_bwd": 1, "flash_fwd": depth,
                "flash_bwd": depth}
    ok_counts = all(counts[n] == steps * c for n, c in per_step.items())
    # every grouped and every flash launch of the path ran the wgmma design
    by_design = {k.__name__: dict(k.launches_by_design)
                 for k in KERNELS if hasattr(k, "launches_by_design")}
    ok_design = all(d["wgmma"] == counts[n] for n, d in by_design.items())
    ok_loss = all(math.isfinite(x) for x in res["losses"])
    ok_aux = all(math.isfinite(x) for x in res["aux_losses_last_step"].values())
    # the experts' GELU stays outside the kernel, as in the JAX package: no
    # launch with an activation (B2)
    b2 = dict(gmm.launches_by_activation)
    ok_no_b2 = not any(b2.values())
    for name in ("gmm", "tgmm"):
        results.setdefault(name, {})["launches"] = counts[name]
    emit("moe_slice", tokens_per_s_per_gpu=res["value"],
         step_ms=res["step_ms"], peak_mem_bytes=res["peak_mem_bytes"],
         n_params=res["n_params"], n_active_params=res["n_active_params"],
         achieved_model_tflops_active=res["achieved_model_tflops_active"],
         model=res["model"], steps_run=steps, launches=counts,
         launches_per_step_expected=per_step, ok_launches=ok_counts,
         launches_by_design=by_design, ok_design=ok_design,
         launches_by_activation=b2, ok_no_activation=ok_no_b2,
         losses=res["losses"], ok_losses_finite=ok_loss,
         aux_losses_last_step=res["aux_losses_last_step"], ok_aux_finite=ok_aux,
         tokens_per_expert_last_step=res["tokens_per_expert_last_step"])
    return ok_counts and ok_design and ok_loss and ok_aux and ok_no_b2


MOE_LAYER_TOL = {
    "rtol": 1.6e-2, "atol_row": 1.6e-2, "atol_all": 1e-3,
    "x_scale": 2.0,
    "why": "bf16 on both sides, identical routing: each grouped product "
           "rounds its float32 sums to bf16, where one rounding can flip (a "
           "bf16 step, up to 2^-7), and the flip travels through the GELU "
           "and the second product: two bf16 steps of the element or of its "
           "row's rms (one token's features), plus 1e-3 of the tensor's rms. "
           "dx is held to x_scale times that: it adds the router path, "
           "whose bf16 softmax backward subtracts nearly equal terms; the "
           "common limit gave dx a margin of 1.64 on an H100 (relative norm "
           "error 9.4e-4) and every other tensor at most 0.95"}


def check_moe_layer(results):
    """One full-width MoE layer (16384 tokens) forward and backward with the
    kernels against the same layer with the plain grouped products."""
    from tpu_dist_torch.nn import MoELayer
    from tpu_dist_torch.ops.gmm import gmm_impl

    g = torch.Generator(device="cuda").manual_seed(4)
    layer = MoELayer(768, 8, hidden=3072, top_k=2, dispatch="dropless",
                     device="cuda")
    layer.reset_parameters(g)
    with torch.no_grad():  # non-zero biases, so their paths are checked too
        layer.b1.normal_(0.0, 0.1, generator=g)
        layer.b2.normal_(0.0, 0.1, generator=g)
    layer.to(torch.bfloat16)
    x = torch.randn(8, 2048, 768, device="cuda", generator=g).to(
        torch.bfloat16)
    cot = torch.randn(8, 2048, 768, device="cuda", generator=g).to(
        torch.bfloat16)
    leaves = ["router", "w1", "b1", "w2", "b2"]

    def run_once():
        xr = x.detach().requires_grad_(True)
        y = layer(xr)
        grads = torch.autograd.grad(
            y, [xr] + [getattr(layer, k) for k in leaves], cot)
        route = {k: v.clone() for k, v in layer.routing.items()}
        return y.detach(), dict(zip(["x"] + leaves, grads)), route

    y_k, g_k, r_k = run_once()
    with gmm_impl("plain"):
        y_p, g_p, r_p = run_once()
    # a planted fault the check must reject: two experts' w1 swapped
    with torch.no_grad():
        layer.w1[[0, 1]] = layer.w1[[1, 0]]
    y_bad = run_once()[0]
    with torch.no_grad():
        layer.w1[[0, 1]] = layer.w1[[1, 0]]
    same_route = all(torch.equal(r_k[k], r_p[k]) for k in r_k)
    tol = MOE_LAYER_TOL
    lims = (tol["rtol"], 0.0, tol["atol_row"], tol["atol_all"])
    errs, margins, diag, ok = {}, {}, {}, True
    for k, (got, want) in {"y": (y_k, y_p), **{
            n: (g_k[n], g_p[n]) for n in g_k}}.items():
        scale = tol["x_scale"] if k == "x" else 1.0
        errs[k], _, margins[k], ok_t = compare(
            got, want, *(scale * v for v in lims))
        ok = ok and ok_t
        gf, wf = got.float(), want.float()
        diag[k] = {"rel_norm_err": float((gf - wf).norm() / wf.norm()),
                   "rms": float(wf.pow(2).mean().sqrt())}
    caught = compare(y_bad, y_p, *lims)[2]
    emit("moe_layer", tokens=16384, same_block_map=same_route,
         tokens_per_expert=r_k["counts"].tolist(),
         live_blocks=int(r_k["n_live_blocks"]),
         max_abs_err=errs, margin=margins, diagnostics=diag,
         planted_w1_swap_margin=caught, tolerance=MOE_LAYER_TOL,
         ok=ok and same_route and caught > 1.0)
    return ok and same_route and caught > 1.0


MOE_STEP_TOL = {
    "plain_products": {"loss_rtol": 1e-3, "update_rel": 0.35,
                       "leaf_update_rel": 1.0, "aux_rtol": 1.6e-2,
                       "moved_share": 0.057},
    "plain_composition": {"loss_rtol": 1e-2, "update_rel": 0.4,
                          "leaf_update_rel": 1.0, "aux_rtol": 1.6e-2,
                          "moved_share": 0.073},
    "why": "bf16 compute on both paths.  A token near a routing tie can "
           "pick another expert when its input moves by a bf16 step, and its "
           "whole expert FFN changes: the flips cascade through the layers "
           "and show most in the LayerNorm gains, whose gradients are sums "
           "over all 16384 tokens that mostly cancel.  An H100 measured, "
           "against the plain grouped products alone (their bf16 roundings "
           "differ by a step here and there), an update error of 0.171, "
           "worst leaf 0.47 and 5597 of 196608 token-layers on other "
           "experts (2.85%, none in the first layer); against the full "
           "plain composition (dense attention also rounds scores and "
           "softmax to bf16) 0.197, 0.49 and 7180 (3.65%).  The limits are "
           "about twice that.  aux: two bf16 steps.  Loss: the plain loss "
           "is a bf16 mean (1e-2 as in the dense check); with the fused "
           "loss kept, 1e-3"}


def _update_diff(p0, upd_k, params_p):
    """Relative error of the plain step's parameter update against the
    kernel step's: over all parameters, per leaf, and the worst leaf of
    each group (so a fault confined to one group is not hidden)."""
    num, den = {}, {}
    with torch.no_grad():
        for k in p0:
            upd_p = params_p[k] - p0[k]
            num[k] = float((upd_p - upd_k[k]).pow(2).sum())
            den[k] = float(upd_p.pow(2).sum())
    rel = math.sqrt(sum(num.values()) / sum(den.values()))
    leaf = {k: math.sqrt(num[k] / den[k]) if den[k] else
            (0.0 if num[k] == 0 else math.inf) for k in p0}
    groups = {"attention": (".attn.",), "router": (".mlp.router",),
              "expert_ffn": (".mlp.w", ".mlp.b"), "layernorm": (".ln",),
              "block0": ("block0.",)}
    group_worst = {}
    for gname, frags in groups.items():
        members = {k: v for k, v in leaf.items()
                   if any(f in k for f in frags)}
        if not members:
            continue
        wk = max(members, key=members.get)
        group_worst[gname] = [wk, members[wk]]
    return rel, leaf, group_worst


def check_moe_composition(results):
    """One step of the MoE kernel path from a seed and batch against (1)
    the same step with the plain grouped products, which isolates K3/K4,
    and (2) the full plain composition: plain grouped products, dense
    attention, unfused loss."""
    from tpu_dist_torch import nn, optim
    from tpu_dist_torch.benchmarks.moe_lm import build
    from tpu_dist_torch.ops.gmm import gmm_impl
    from tpu_dist_torch.parallel import DistributedDataParallel

    ddp, x, y = build(device="cuda", dispatch="dropless")
    moe = [(p, m) for p, m in ddp.module.named_modules()
           if isinstance(m, nn.MoELayer)]
    state = ddp.init(seed=0)
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    state, m_k = ddp.train_step(state, x, y)
    upd_k = {k: state.params[k].detach() - p0[k] for k in p0}
    route_k = {p: m.routing["gate_idx"].clone() for p, m in moe}
    aux_k = {p: float(v["aux_loss"]) for p, v in state.model_state.items()}
    loss_k = float(m_k["loss"])
    ok_all = True
    for name, fused, dense in (("plain_products", True, False),
                               ("plain_composition", False, True)):
        plain = DistributedDataParallel(
            ddp.module, optimizer=optim.SGD(lr=0.01),
            loss_fn=nn.CrossEntropyLoss(fused=fused),
            compute_dtype=torch.bfloat16)
        state_p = plain.init(seed=0)
        same_init = all(torch.equal(state_p.params[k], p0[k]) for k in p0)
        attn = (nn.attention_impl("dense") if dense
                else contextlib.nullcontext())
        with attn, gmm_impl("plain"):
            state_p, m_p = plain.train_step(state_p, x, y)
        aux_p = {p: float(v["aux_loss"])
                 for p, v in state_p.model_state.items()}
        # tokens whose ordered expert choice differs between the two paths
        moved = {p: int((m.routing["gate_idx"] != route_k[p]).any(-1).sum())
                 for p, m in moe}
        share = sum(moved.values()) / (x.numel() * len(moe))
        rel, leaf, group_worst = _update_diff(p0, upd_k, state_p.params)
        worst = max(leaf, key=leaf.get)
        loss_p = float(m_p["loss"])
        aux_err = max(abs(aux_k[p] - aux_p[p]) / abs(aux_p[p])
                      for p in aux_p)
        tol = MOE_STEP_TOL[name]
        ok = (same_init
              and abs(loss_k - loss_p) <= tol["loss_rtol"] * abs(loss_p)
              and rel <= tol["update_rel"]
              and leaf[worst] <= tol["leaf_update_rel"]
              and aux_err <= tol["aux_rtol"] and share <= tol["moved_share"])
        ok_all = ok_all and ok
        emit("moe_composition", against=name, loss_kernel_path=loss_k,
             loss_plain_path=loss_p, update_rel_err=rel,
             worst_leaf=[worst, leaf[worst]],
             worst_leaf_by_group=group_worst,
             worst_leaves=sorted(leaf.items(), key=lambda kv: -kv[1])[:5],
             aux_rel_err=aux_err, aux_kernel_path=aux_k,
             tokens_with_other_experts=moved,
             tokens_with_other_experts_total=sum(moved.values()),
             moved_share=share, tokens_per_layer=x.numel(),
             same_init=same_init,
             tolerance={**tol, "why": MOE_STEP_TOL["why"]}, ok=ok)
    return ok_all


# ---------------------------------------------------------------------------
# the serving slice: no kernel on its path
# ---------------------------------------------------------------------------

# Token-for-token equality is required, except at a step where the
# reference's two largest argmax operands lie within this gap: batch size
# and cache length change cuBLAS's and the softmax's reduction order, so
# float32 results across pool sizes are equal only to rounding.
SERVE_TIE_GAP = 1e-4
# What the card may hold after a serve phase beyond what it held before:
# room for the cuBLAS workspaces of the scheduler thread's handle (32 MiB
# each on sm_90), far below the smallest pool (int8, 0.32 GB)
SERVE_LEFTOVER_BYTES = 128 << 20
_SERVE: dict = {}   # the full-width model, built once for the serve phases


def smoke_requests() -> list:
    """The serve phases' 16 requests for the 2048-position pool, from
    ``np.random.default_rng(0)``: prompt lengths uniform in 16-1536 (the
    longest raised to 1536 when none exceeds 1024, so the longest bucket
    runs), new-token counts uniform in 16-64, no eos; the last 4 requests
    at temperature 0.8 with seeds 1-4.  A check of every bucket and of
    sampling, not a traffic mix: the benchmark's traffic is
    ``serve_lm.workload``."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(16, 1536 + 1, 16)
    if plens.max() <= 1024:
        plens[int(plens.argmax())] = 1536
    gens = rng.integers(16, 64 + 1, 16)
    reqs = []
    for i, (p, g) in enumerate(zip(plens, gens)):
        s = i - 12 + 1
        reqs.append({"prompt": rng.integers(0, 32768, int(p)).astype(np.int32),
                     "max_new_tokens": int(g),
                     "temperature": 0.8 if s > 0 else 0.0,
                     "seed": max(s, 0)})
    return reqs


def _serve_model():
    from tpu_dist_torch.benchmarks.serve_lm import build
    if "model" not in _SERVE:
        _SERVE["model"] = build(device="cuda")
    return _SERVE["model"]


def _reference_logits(model, req, want, d, cache_dtype):
    """The (1, vocab) logits the reference, ``generate()`` of ``req`` with
    ``cache_dtype``, drew its token ``d`` from: its own path replayed — the
    prompt prefilled into a cache of the same length, then
    ``decode_step`` fed its tokens before ``d``."""
    prompt = torch.from_numpy(req["prompt"]).to(model.device).long()
    tp = prompt.shape[0]
    with torch.inference_mode():
        cache = model.init_cache(1, tp + req["max_new_tokens"], cache_dtype)
        logits = model(prompt[None], cache=cache)[:, -1]
        slots = {path: {k: v for k, v in entry.items() if k != "index"}
                 for path, entry in cache.items()}
        for i in range(d):
            logits, slots = model.decode_step(
                torch.tensor([want[i]], device=model.device), [tp + i],
                slots)
    return logits.float()


def _first_divergence(model, req, got, want, cache_dtype):
    """None when ``got`` equals the reference ``want``; else ``{"step",
    "gap", "replayed"}`` at the first differing step, ``gap`` being the
    distance of the two largest values whose argmax chose the reference's
    token there: the reference's own logits at that step, divided by the
    temperature and plus the step's Gumbel noise when the request samples.
    ``replayed``: their argmax is the reference's token, so the replay
    reproduced the reference."""
    from tpu_dist_torch import random

    if got == want:
        return None
    d = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    v = _reference_logits(model, req, want, d, cache_dtype)
    if req["temperature"] > 0:
        key = random.fold_in(random.key(req["seed"], model.device), d)
        v = random.gumbel(key, v.shape) + v / v.new_tensor(req["temperature"])
    top = v[0].topk(2)
    return {"step": d, "gap": float(top.values[0] - top.values[1]),
            "replayed": d < len(want) and int(top.indices[0]) == want[d]}


def _generate(model, req, cache_dtype):
    """``generate()`` of ``req`` alone; for the serve phases' model (its
    weights never change) each request's tokens are computed once."""
    from tpu_dist_torch.serve import random_key
    key = None
    if model is _SERVE.get("model"):
        key = ("generate", req["prompt"].tobytes(), req["max_new_tokens"],
               req.get("temperature", 0.0), req.get("seed", 0),
               cache_dtype)
        if key in _SERVE:
            return _SERVE[key]
    prompt = torch.from_numpy(req["prompt"]).to(model.device)
    out = model.generate(
        prompt[None], req["max_new_tokens"],
        temperature=req.get("temperature", 0.0), cache_dtype=cache_dtype,
        rng=random_key(req["seed"]) if req.get("temperature") else None)
    got = out[0, len(req["prompt"]):].tolist()
    if key is not None:
        _SERVE[key] = got
    return got


def _tie_rule(model, reqs, got, want, cache_dtype, against: str) -> list:
    """Every request's tokens against the reference's under the tie rule:
    a list of ``(request, ok, divergence)``; each divergence is printed."""
    out = []
    for i, (r, a, b) in enumerate(zip(reqs, got, want)):
        div = _first_divergence(model, r, a, b, cache_dtype)
        ok = len(a) == r["max_new_tokens"] and (
            div is None or (div["replayed"] and div["gap"] <= SERVE_TIE_GAP))
        if div is not None:
            emit("serve_divergence", against=against, request=i, **div,
                 tie_gap_limit=SERVE_TIE_GAP, ok=ok)
        out.append((i, ok, div))
    return out


def decode_bound(model, engine) -> dict:
    """The least time of one decode step over the whole pool: the bytes it
    must move (every weight matrix once, one row of each embedding table
    per slot, the whole pool that dense cached attention reads) over the
    card's memory rate; its operations (≈ 2 per weight element and slot
    and 4 per cached element and slot) take far less at the float32
    rate."""
    slots = engine.num_slots
    w_bytes = sum(p.numel() * p.element_size()
                  for name, p in model.named_parameters()
                  if not name.startswith(("tok.", "pos.")))
    w_bytes += 2 * slots * model.tok.weight[0].numel() * 4
    pool_bytes = sum(t.numel() * t.element_size()
                     for entry in engine.cache.values()
                     for t in entry.values())
    ops = 2 * slots * sum(p.numel() for name, p in model.named_parameters()
                          if not name.startswith(("tok.", "pos.")))
    ops += 2 * sum(t.numel() for entry in engine.cache.values()
                   for name, t in entry.items() if not name.endswith("scale"))
    ms, by = bound(w_bytes + pool_bytes, ops, "f32")
    return {"bound_ms": ms, "bound_by": by, "weight_bytes": w_bytes,
            "pool_bytes": pool_bytes}


def _serve_over_socket(model, reqs, dtype) -> dict:
    """``reqs`` through ServeClient → socket → Frontend → Scheduler →
    SlotEngine(8 slots, max_len 2048), every serving object closed on
    return: the tokens, end reasons, the engine's stats over the wire,
    wall time, kernel launches, peak memory and the decode step's bound."""
    from tpu_dist_torch import serve
    from tpu_dist_torch.benchmarks.serve_lm import warmup
    from tpu_dist_torch.ops import KERNELS

    engine = serve.SlotEngine(model, num_slots=8, max_len=2048,
                              cache_dtype=dtype, device=model.device)
    warmup(engine, reqs)
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sched = serve.Scheduler(engine, batch_window=0.002)
    fe = serve.Frontend(sched, port=0)
    try:
        with serve.ServeClient("127.0.0.1", fe.port, connect_retry=10,
                               timeout=60) as cli:
            t0 = time.perf_counter()
            handles = [cli.submit(r["prompt"].tolist(),
                                  max_new_tokens=r["max_new_tokens"],
                                  temperature=r["temperature"],
                                  seed=r["seed"]) for r in reqs]
            got = [h.wait_done(600.0) for h in handles]
            wall = time.perf_counter() - t0
            reasons = [h.reason for h in handles]
            stats = cli.stats(timeout=60.0)
    finally:
        fe.close()
        sched.close()
    return {"got": got, "reasons": reasons, "stats": stats, "wall": wall,
            "launches": {k.__name__: k.launches for k in KERNELS},
            "peak": torch.cuda.max_memory_allocated(),
            "bound": decode_bound(model, engine)}


def check_serve(results, cache: str = "float32"):
    """The full-width model served through ServeClient → socket → Frontend
    → Scheduler → SlotEngine(8 slots, max_len 2048); every request against
    ``generate()`` alone on the card, and (float32) two greedy ones against
    the plain path on a CPU copy of the weights.  The memory the card holds
    after the phase must be back to what it held before it."""
    import gc

    from tpu_dist_torch.benchmarks.serve_lm import CACHE_DTYPES, CONFIG
    from tpu_dist_torch.models import TransformerLM

    model = _serve_model()
    dtype = CACHE_DTYPES[cache]
    reqs = smoke_requests()
    held_before = torch.cuda.memory_allocated()
    run = _serve_over_socket(model, reqs, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    leftover = torch.cuda.memory_allocated() - held_before
    ok_memory = leftover <= SERVE_LEFTOVER_BYTES
    got, st = run["got"], run["stats"]
    ok_served = (run["reasons"] == ["length"] * len(reqs)
                 and all(len(a) == r["max_new_tokens"]
                         for a, r in zip(got, reqs)))
    ok_launches = not any(run["launches"].values())
    t1 = time.perf_counter()
    want = [_generate(model, r, dtype) for r in reqs]
    vs_gen = _tie_rule(model, reqs, got, want, dtype, f"generate_{cache}")
    gen_s = time.perf_counter() - t1
    vs_cpu = []
    if cache == "float32":
        cpu = TransformerLM(**CONFIG, device="cpu")
        cpu.load_state_dict(model.state_dict())
        greedy = sorted((i for i, r in enumerate(reqs)
                         if not r["temperature"]),
                        key=lambda i: len(reqs[i]["prompt"]))[:2]
        sub = [reqs[i] for i in greedy]
        cpu_want = [_generate(cpu, r, dtype) for r in sub]
        vs_cpu = [(greedy[i], ok, div) for i, ok, div in _tie_rule(
            cpu, sub, [got[i] for i in greedy], cpu_want, dtype, "cpu")]
        del cpu
    ok_ties = all(ok for _, ok, _ in vs_gen + vs_cpu)
    emit(f"serve{'' if cache == 'float32' else '_int8'}", cache=cache,
         requests=len(reqs), greedy=sum(not r["temperature"] for r in reqs),
         prompt_lens=[len(r["prompt"]) for r in reqs],
         max_new_tokens=[r["max_new_tokens"] for r in reqs],
         generated_tokens=st["generated_tokens"], wall_s=run["wall"],
         tokens_per_s=st["generated_tokens"] / run["wall"],
         ttft_p50_ms=st["ttft"]["p50"] * 1e3,
         ttft_p99_ms=st["ttft"]["p99"] * 1e3,
         decode_step_p50_ms=st["decode_step"]["p50"] * 1e3,
         decode_step_p99_ms=st["decode_step"]["p99"] * 1e3,
         prefill_p50_ms=st["prefill"]["p50"] * 1e3,
         occupancy=st["occupancy"], decode_steps=st["decode_steps"],
         peak_mem_bytes=run["peak"], held_before_bytes=held_before,
         leftover_bytes=leftover, ok_memory_released=ok_memory,
         decode_step_bound=run["bound"],
         kernel_launches=run["launches"], ok_launches_zero=ok_launches,
         ok_served=ok_served,
         divergent_vs_generate=[i for i, _, d in vs_gen if d],
         divergent_vs_cpu=[i for i, _, d in vs_cpu if d],
         cpu_checked_requests=[i for i, _, _ in vs_cpu],
         reference_seconds=gen_s, ok_tie_rule=ok_ties)
    return ok_served and ok_launches and ok_ties and ok_memory


def check_serve_int8(results):
    return check_serve(results, cache="int8")


def check_quant(results):
    """``quantize_linear_weights(attention=True)`` on the full-width model:
    greedy ``generate`` of 32 tokens on the card against the same int8
    weights on the CPU, and the decode step (8 slots, float32 pool) of the
    quantized model against the unquantized one, in turns."""
    import copy

    from tpu_dist_torch.nn import quantize_linear_weights

    model = _serve_model()
    qmodel = quantize_linear_weights(copy.deepcopy(model), attention=True)
    reqs = smoke_requests()
    req = dict(min(reqs, key=lambda r: len(r["prompt"])), max_new_tokens=32,
               temperature=0.0, seed=0)
    got = _generate(qmodel, req, torch.float32)
    cpu = copy.deepcopy(qmodel).to("cpu")
    want = _generate(cpu, req, torch.float32)
    [(_, ok_tie, div)] = _tie_rule(cpu, [req], [got], [want], torch.float32,
                                   "quant_cpu")
    del cpu

    lengths = [len(r["prompt"]) for r in reqs[:8]]
    tokens = torch.zeros(8, dtype=torch.long, device=model.device)

    def step_ms(m, cache, n=20):
        times = []
        for _ in range(n + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.decode_step(tokens, lengths, cache)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[3:])

    caches = {name: m.init_slot_cache(8, 2048)
              for name, m in (("float", model), ("int8", qmodel))}
    timing = {"float": [], "int8": []}
    for name in ("float", "int8", "int8", "float"):
        timing[name].append(step_ms(model if name == "float" else qmodel,
                                    caches[name]))
    q_bytes = sum(p.numel() * p.element_size()
                  for p in qmodel.parameters())
    f_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    emit("quant", prompt_len=len(req["prompt"]), new_tokens=32,
         tokens_card=got, divergence_vs_cpu=div,
         decode_step_ms_float32_weights=timing["float"],
         decode_step_ms_int8_weights=timing["int8"],
         weight_bytes_float32=f_bytes, weight_bytes_int8=q_bytes,
         ok_tie_rule=ok_tie)
    return ok_tie and len(got) == 32


# ---------------------------------------------------------------------------
# the vision slice: ConvNet/MNIST and ResNet-18/CIFAR-10 DDP training
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tf32(cudnn: bool):
    """Whether cuDNN may use TF32 for float32 convolutions in the block
    (cuBLAS may not, torch's default), restored after it.  ``tf32(True)`` is
    torch's default, under which the vision timing lines run; the strict
    comparisons run under ``tf32(False)``."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def launch_counts() -> dict:
    from tpu_dist_torch.ops import KERNELS
    return {k.__name__: k.launches for k in KERNELS}


def step_against_cpu(ddp, make_cpu_model, x, y, tol: dict, prepare=None,
                     null_leaves=None):
    """One float32 train step of ``ddp`` on the card against the same step
    of a CPU copy of the port (same weights, state and batch), TF32 off:
    the loss, every parameter's update and every BatchNorm statistic.
    ``prepare(module)`` changes the initialized weights in place first.
    ``null_leaves`` (``{leaf: reference leaf}``): leaves whose exact
    gradient is 0 (a convolution's bias under a BatchNorm's batch mean),
    whose update on either side must be at most ``tol["null_rel"]`` of the
    reference leaf's, in place of the relative check (their update is
    rounding, with no norm of its own to hold an error to).  Returns the
    fields to print and whether each is within ``tol``."""
    from tpu_dist_torch.parallel import DistributedDataParallel

    with tf32(False):
        state = ddp.init(seed=0)
        if prepare is not None:
            prepare(ddp.module)
        cpu_model = make_cpu_model()
        cpu = DistributedDataParallel(cpu_model, optimizer=ddp.optimizer,
                                      loss_fn=ddp.loss_fn)
        cpu_state = cpu.init(seed=0)
        cpu_model.load_state_dict(ddp.module.state_dict())
        p0 = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        state, m = ddp.train_step(state, x, y)
        cpu_state, m_cpu = cpu.train_step(cpu_state, x.cpu(), y.cpu())
    leaf, upd_norm = {}, {}
    for k, p in state.params.items():
        upd_c = cpu_state.params[k].detach() - p0[k]
        upd_norm[k] = max(float(upd_c.norm()),
                          float((p.detach().cpu() - p0[k]).norm()))
        err = float((p.detach().cpu() - p0[k] - upd_c).norm())
        leaf[k] = err / max(float(upd_c.norm()), 1e-30)
    null = {k: upd_norm[k] / max(float(
        (cpu_state.params[ref].detach() - p0[ref]).norm()), 1e-30)
        for k, ref in (null_leaves or {}).items()}
    for k in null:
        del leaf[k]
    worst_null = max(null, key=null.get) if null else None
    bn = {}
    for path, leaves in state.model_state.items():
        for name, t in leaves.items():
            want = cpu_state.model_state[path][name]
            bn[f"{path}.{name}"] = float((t.cpu() - want).abs().max()
                                         / want.abs().max().clamp_min(1e-30))
    loss, loss_cpu = float(m["loss"]), float(m_cpu["loss"])
    worst = max(leaf, key=leaf.get)
    worst_bn = max(bn, key=bn.get) if bn else None
    ok = (abs(loss - loss_cpu) <= tol["loss_rtol"] * abs(loss_cpu)
          and leaf[worst] <= tol["update_rel"]
          and (not bn or bn[worst_bn] <= tol["state_rel"])
          and (not null or null[worst_null] <= tol["null_rel"])
          and int(m["correct"]) == int(m_cpu["correct"]))
    out = {"loss_card": loss, "loss_cpu": loss_cpu,
           "correct_card": int(m["correct"]),
           "correct_cpu": int(m_cpu["correct"]),
           "worst_update_leaf": [worst, leaf[worst]],
           "worst_bn_stat": [worst_bn, bn.get(worst_bn)],
           "tolerance": tol, "ok": ok}
    if null:
        out["worst_null_leaf"] = [worst_null, null[worst_null]]
    return out


def example_args(module, argv):
    return module.parse_args(["--synthetic", "--epochs", "1"] + argv)


def timed_row(fn, **kw) -> dict:
    """One benchmark run under torch's default TF32 permissions."""
    with tf32(True):
        r = fn(**kw)
    return {k: r[k] for k in ("value", "step_ms", "peak_mem_bytes",
                              "per_gpu_batch", "dtype", "cudnn_allow_tf32")}


def bn_moved(stats) -> bool:
    """Every BatchNorm statistic finite and moved from its initial value
    (mean 0, variance 1)."""
    return all(bool(torch.isfinite(t).all()) and bool(
        (t != (0.0 if leaf == "mean" else 1.0)).all())
        for leaves in stats.values() for leaf, t in leaves.items())


VISION_STEP_TOL = {
    "loss_rtol": 1e-5, "update_rel": 1.2e-2, "state_rel": 1e-5,
    "why": "float32 with TF32 off on both sides: cuDNN and the CPU's "
           "convolutions sum the same products in other orders (the CPU "
           "parity tests' 1e-5 relative on the loss and statistics). A "
           "leaf's update is its gradient, a sum over the batch and the "
           "image whose terms largely cancel (a first-layer weight, a "
           "BatchNorm bias), so its error is held to its own norm: about "
           "twice the worst leaves measured on an H100 (ConvNet "
           "conv1.weight 5.2e-3, ResNet-18 layer3.0.bn2.bias 3.0e-3)"}


def check_convnet(results):
    """The ConvNet twin's ``train`` at world 1 (batch 100, synthetic MNIST,
    float32) to convergence at lr 0.05 and evaluated; one step against the
    CPU copy; images/s/GPU at bench.py's headline (batch 8192, bf16,
    ``train_chunk``) and its float32 row (2048).  No hand-written kernel
    may launch."""
    from tpu_dist_torch.benchmarks import convnet
    from tpu_dist_torch.data import MNIST, DataLoader, transforms
    from tpu_dist_torch.examples import mpspawn_dist
    from tpu_dist_torch.models import ConvNet

    zero_launch_counts()
    t0 = time.perf_counter()
    run = mpspawn_dist.train(example_args(mpspawn_dist, [
        "--max-steps", "300", "--lr", "0.05", "--evaluate"]))
    train_s = time.perf_counter() - t0
    losses = [float(v) for v in run["losses"]]
    ev = run["eval"]
    fall = losses[0] / statistics.mean(losses[-10:])
    ok_train = (len(losses) == 300 and all(map(math.isfinite, losses))
                and fall >= 5.0 and ev["count"] == 10000
                and ev["accuracy"] > 0.9)

    ds = MNIST("./data", train=True, synthetic_fallback=True,
               transform=transforms.Normalize(transforms.MNIST_MEAN,
                                              transforms.MNIST_STD))
    x, y = next(iter(DataLoader(ds, batch_size=100)))
    ddp = convnet.build(batch=100, dtype="float32", device="cuda")[0]
    cmp_ = step_against_cpu(ddp, lambda: ConvNet(device="cpu"),
                            x.cuda(), y.cuda(), VISION_STEP_TOL)

    rows = [timed_row(convnet.run, batch=8192, steps=50, dtype="bfloat16"),
            timed_row(convnet.run, batch=2048, steps=50, dtype="float32")]
    counts = launch_counts()
    ok_launches = not any(counts.values())
    emit("convnet", train_steps=len(losses), first_loss=losses[0],
         last_losses=losses[-5:], loss_fall=fall, eval=ev,
         train_and_eval_s=train_s, ok_converged=ok_train,
         step_vs_cpu=cmp_, timing=rows,
         timing_note="torch's default TF32 permissions (cuDNN yes, cuBLAS "
                     "no); images/s/GPU at world 1",
         kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_train and cmp_["ok"] and ok_launches


def check_resnet(results):
    """resnet18(num_classes=10) through the ResNet twin's path (synthetic
    CIFAR-10, RandomCrop + Flip on the host, DataLoader → DeviceLoader),
    batch 256 and the example's recipe, 20 steps in float32 (then evaluated)
    and 20 in bf16: losses finite and falling, every BatchNorm statistic
    moved and finite, an exact evaluation count; one float32 step against
    the CPU copy; images/s/GPU at batch 256 and 1024 (bf16).  No
    hand-written kernel may launch."""
    from tpu_dist_torch.benchmarks import resnet_cifar
    from tpu_dist_torch.examples import example_mp
    from tpu_dist_torch.models import resnet18

    zero_launch_counts()
    runs = {}
    ok_train = True
    for name, argv in (("float32", ["--evaluate"]), ("bf16", ["--bf16"])):
        t0 = time.perf_counter()
        r = example_mp.train(example_args(example_mp,
                                          ["--max-steps", "20"] + argv))
        losses = [float(v) for v in r["losses"]]
        stats = r["state"].model_state
        moved = bn_moved(stats)
        falling = statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
        ev = r["eval"]
        ok = (len(losses) == 20 and all(map(math.isfinite, losses))
              and falling and moved and len(stats) == 20
              and (ev is None or ev["count"] == 10000))
        ok_train = ok_train and ok
        runs[name] = {"losses": losses, "bn_layers": len(stats),
                      "bn_stats_moved_and_finite": moved,
                      "loss_falling": falling, "eval": ev,
                      "seconds": time.perf_counter() - t0, "ok": ok}
    ok_train = ok_train and runs["float32"]["eval"] is not None

    ddp, x, y = resnet_cifar.build(batch=256, dtype="float32", device="cuda")
    cmp_ = step_against_cpu(ddp, lambda: resnet18(num_classes=10,
                                                  device="cpu"),
                            x, y, VISION_STEP_TOL)
    rows = [timed_row(resnet_cifar.run, batch=b) for b in (256, 1024)]
    counts = launch_counts()
    ok_launches = not any(counts.values())
    emit("resnet", runs=runs, step_vs_cpu=cmp_, timing=rows,
         timing_note="bf16 compute over float32 masters, torch's default "
                     "TF32 permissions (cuDNN yes, cuBLAS no); "
                     "images/s/GPU at world 1",
         kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_train and cmp_["ok"] and ok_launches


# ---------------------------------------------------------------------------
# the training recipe: optimizers (multi-tensor) and checkpoint/resume
# ---------------------------------------------------------------------------

OPTIM_TOL = {
    "rtol": 4.8e-7, "atol_update": 1e-5, "sensitivity": 1e-3,
    "why": "float32 on both sides, from the same state and gradients: the "
           "multi-tensor kernels fuse multiply-adds the plain loop rounds "
           "twice and divide by a host scalar differently, so an element "
           "differs in its last bits. Each tensor (parameters and every "
           "state leaf) is held element by element to 4 ulps of its value "
           "(rtol 4.8e-7) plus 1e-5 of its largest change in the update; "
           "the plain result moved by 1e-3 of its own change must be "
           "rejected"}


def dense_shapes() -> dict:
    """The dense GPT-2-small slice's parameter shapes by name (136,993,280
    float32 values)."""
    from tpu_dist_torch.models import TransformerLM

    model = TransformerLM(vocab_size=32768, dim=768, depth=12, num_heads=12,
                          max_seq_len=2048, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _tensors(tree, prefix=""):
    """``{path: tensor}`` of a dict tree (the optimizer states)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tensors(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def count_launches(fn, names: bool = False):
    """Kernels the card ran for one ``fn()`` (``torch.profiler``); with
    ``names`` also the three commonest kernel names and their counts."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return len(kernels)
    common = collections.Counter(k[:60] for k in kernels).most_common(3)
    return len(kernels), common


def optim_cases():
    """(name, optimizer, bytes a parameter moves, operations a parameter):
    each input read once and each output written once, float32."""
    from tpu_dist_torch import optim

    sched = optim.warmup_cosine(3e-4, 10, 100)
    return [
        ("sgd_momentum", optim.SGD(lr=0.02, momentum=0.9,
                                   weight_decay=1e-4), 20, 6),
        ("sgd_nesterov", optim.SGD(lr=0.02, momentum=0.9, nesterov=True,
                                   weight_decay=1e-4), 20, 8),
        ("sgd_schedule", optim.SGD(lr=sched, momentum=0.9), 20, 4),
        ("adamw", optim.AdamW(lr=sched, weight_decay=0.1), 28, 16),
        ("adam", optim.Adam(lr=1e-3, weight_decay=1e-4), 28, 16),
        ("rmsprop_centered_momentum", optim.RMSprop(
            lr=1e-3, momentum=0.9, centered=True), 36, 16),
        ("adagrad", optim.Adagrad(lr=1e-2, lr_decay=1e-3), 20, 7),
    ]


def _hold(after: dict, want: dict, before: dict, tol: dict) -> tuple:
    """Worst margin of ``after`` against ``want`` over the tensors, each
    element held to ``rtol*|want| + atol_update*max|want - before|``; and
    the worst margin of the plain result moved by ``sensitivity`` of its
    change (must exceed 1)."""
    worst, worst_key, planted = 0.0, None, math.inf
    for k, w in want.items():
        step = float((w - before[k]).abs().max())
        _, _, margin, ok = compare(after[k], w, tol["rtol"],
                                   tol["atol_update"] * step)
        if not ok and margin <= 1.0:
            margin = math.inf  # not finite
        if margin > worst:
            worst, worst_key = margin, k
        if step > 0:
            moved = w + tol["sensitivity"] * (w - before[k])
            planted = min(planted, compare(moved, w, tol["rtol"],
                                           tol["atol_update"] * step)[2])
    return worst, worst_key, planted


def check_optim(results):
    """Every optimizer's multi-tensor update (and EMA's, and
    clip_grad_norm) at the dense slice's 136,993,280 float32 parameters
    against its plain per-parameter loop on the same state and gradients;
    ms per update (CUDA events), launches per update (torch.profiler),
    the bytes bound, and torch.optim's fused AdamW/SGD as a yardstick."""
    from tpu_dist_torch import optim

    shapes = dense_shapes()
    n = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(scale):
        return {k: torch.randn(s, device="cuda", generator=gen) * scale
                for k, s in shapes.items()}

    params, grads = randn(0.02), randn(1e-2)
    lines, ok_all = [], True
    for name, opt, bytes_per, ops_per in optim_cases():
        p = _clone(params)
        state = opt.init(p)
        for _ in range(2):  # moments away from their zero start
            opt.update(grads, state, p)
        before = {**{f"p.{k}": v.clone() for k, v in p.items()},
                  **{k: v.clone() for k, v in _tensors(state).items()
                     if v.is_cuda}}
        p2, state2 = _clone(p), _clone(state)
        opt.update(grads, state, p)
        opt.update_plain(grads, state2, p2)
        got = {**{f"p.{k}": v for k, v in p.items()},
               **{k: v for k, v in _tensors(state).items() if v.is_cuda}}
        want = {**{f"p.{k}": v for k, v in p2.items()},
                **{k: v for k, v in _tensors(state2).items() if v.is_cuda}}
        worst, worst_key, planted = _hold(got, want, before, OPTIM_TOL)
        same_steps = all(int(a) == int(b) for a, b in zip(
            [v for v in _tensors(state).values() if not v.is_cuda],
            [v for v in _tensors(state2).values() if not v.is_cuda]))
        del p2, state2, before, got, want
        launches, common = count_launches(
            lambda: opt.update(grads, state, p), names=True)
        plain_launches = count_launches(
            lambda: opt.update_plain(grads, state, p))
        ms = time_ms(lambda: opt.update(grads, state, p))
        plain_ms = time_ms(lambda: opt.update_plain(grads, state, p),
                           reps=3, warm=1)
        b_ms, b_by = bound(bytes_per * n, ops_per * n, "f32")
        line = {"name": name, "ms": ms, "plain_ms": plain_ms,
                "launches": launches, "plain_launches": plain_launches,
                "commonest_kernels": common,
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes_per_param": bytes_per, "worst_margin": worst,
                "worst_tensor": worst_key, "planted_margin": planted,
                # the per-tensor fallback would launch as many as the loop
                "multi_tensor": 3 * launches < plain_launches,
                "ok": (worst <= 1.0 and planted > 1.0 and same_steps
                       and 3 * launches < plain_launches)}
        if name in ("adamw", "sgd_momentum"):
            line["library_ms"] = _torch_optim_ms(name, params, grads)
        lines.append(line)
        ok_all = ok_all and line["ok"]
        del p, state
        torch.cuda.empty_cache()

    # EMA and clip_grad_norm, the same way
    ema = optim.EMA(0.999)
    shadow = ema.init(params)
    ema.update(shadow, grads)
    s2 = _clone(shadow)
    before = {k: v.clone() for k, v in shadow["shadow"].items()}
    ema.update(shadow, params)
    ema.update_plain(s2, params)
    worst, worst_key, planted = _hold(shadow["shadow"], s2["shadow"], before,
                                      OPTIM_TOL)
    same_steps = int(shadow["step"]) == int(s2["step"])
    line = {"name": "ema", "ms": time_ms(lambda: ema.update(shadow, params)),
            "plain_ms": time_ms(lambda: ema.update_plain(shadow, params),
                                reps=3, warm=1),
            "launches": count_launches(lambda: ema.update(shadow, params)),
            "plain_launches": count_launches(
                lambda: ema.update_plain(shadow, params)),
            "worst_margin": worst, "worst_tensor": worst_key,
            "planted_margin": planted, "bytes_per_param": 12}
    line["bound_ms"], line["bound_by"] = bound(12 * n, 3 * n, "f32")
    line["ok"] = (worst <= 1.0 and planted > 1.0 and same_steps
                  and 3 * line["launches"] < line["plain_launches"])
    lines.append(line)
    ok_all = ok_all and line["ok"]
    del shadow, s2, before

    # clip_grad_norm: the norm against float64 per-leaf sums, the clipped
    # leaves against the plain scale
    g = _clone(grads)
    want_norm = math.sqrt(sum(float(v.double().square().sum())
                              for v in grads.values()))
    clipped, norm = optim.clip_grad_norm(g, 1.0)
    scale = min(1.0, 1.0 / max(want_norm, 1e-12))
    err_norm = abs(float(norm) - want_norm) / want_norm
    # (a floor under the relative limit: an element may be exactly 0)
    worst = max(compare(clipped[k], grads[k] * scale, 4.8e-7, 1e-30)[2]
                for k in grads)
    clip_tol = {"norm_rtol": 1e-5, "rtol": 4.8e-7,
                "why": "the norm is float32 sums of float32 squares, "
                       "against float64; the scale is one float32 multiply"}
    line = {"name": "clip_grad_norm",
            "ms": time_ms(lambda: optim.clip_grad_norm(grads, 1e9)),
            "launches": count_launches(
                lambda: optim.clip_grad_norm(grads, 1e9)),
            "norm": float(norm), "norm_rel_err": err_norm,
            "worst_margin": worst, "bytes_per_param": 8,
            "tolerance": clip_tol}
    line["bound_ms"], line["bound_by"] = bound(8 * n, 3 * n, "f32")
    line["ok"] = (err_norm <= clip_tol["norm_rtol"] and worst <= 1.0
                  and line["launches"] < len(shapes))
    lines.append(line)
    ok_all = ok_all and line["ok"]
    emit("optim", n_params=n, n_tensors=len(shapes), tolerance=OPTIM_TOL,
         updates=lines, ok=ok_all)
    return ok_all


def _torch_optim_ms(name: str, params: dict, grads: dict) -> float:
    """torch.optim's fused update of the same tensors (a yardstick, used
    nowhere in the port)."""
    ps = [torch.nn.Parameter(v.clone()) for v in params.values()]
    for p, g in zip(ps, grads.values()):
        p.grad = g
    opt = (torch.optim.AdamW(ps, lr=3e-4, weight_decay=0.1, fused=True)
           if name == "adamw" else
           torch.optim.SGD(ps, lr=0.02, momentum=0.9, weight_decay=1e-4,
                           fused=True))
    return time_ms(opt.step)


RESUME_STEPS, RESUME_AT = 6, 3


def check_resume(results):
    """The dense slice at full width and depth (T 2048, batch 8, bf16 over
    float32 masters, fused loss, flash attention) through DDP with
    ``AdamW(lr=warmup_cosine)``, ``accum_steps=2`` and an EMA updated each
    step: RESUME_STEPS steps straight, against RESUME_AT steps, a save
    through AsyncCheckpointer, a fresh DDP restored (``verify=True``) and
    the rest; the final parameters, AdamW moments and counts and EMA
    shadow must be equal bit for bit.  Then the example_mp twin's
    ``--checkpoint-dir``/``--resume`` round trip, and the train_lm twin at
    its defaults with ``--generate 32``."""
    import io
    import shutil
    import tempfile

    import numpy as np

    from tpu_dist_torch import checkpoint, nn, optim
    from tpu_dist_torch.examples import example_mp, train_lm
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.ops import KERNELS
    from tpu_dist_torch.parallel import DistributedDataParallel

    ema = optim.EMA(0.999)

    def build():
        model = TransformerLM(vocab_size=32768, dim=768, depth=12,
                              num_heads=12, max_seq_len=2048, device="cuda")
        return DistributedDataParallel(
            model, optimizer=optim.AdamW(
                lr=optim.warmup_cosine(3e-4, 2, RESUME_STEPS),
                weight_decay=0.1),
            loss_fn=nn.CrossEntropyLoss(fused=True),
            compute_dtype=torch.bfloat16, accum_steps=2)

    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, 32768, (8, 2048))).cuda()
               for _ in range(RESUME_STEPS + 1)]

    def run(ddp, state, ema_state, first, last, losses):
        for s in range(first, last):
            state, m = ddp.train_step(state, batches[s], batches[s + 1])
            ema.update(ema_state, state.params)
            losses.append(m["loss"])
        return state, ema_state

    zero_launch_counts()
    ddp = build()
    state = ddp.init(seed=0)
    losses_full = []
    full, full_ema = run(ddp, state, ema.init(state.params), 0,
                         RESUME_STEPS, losses_full)
    torch.cuda.synchronize()
    counts = launch_counts()
    by_design = {k.__name__: dict(k.launches_by_design)
                 for k in KERNELS if hasattr(k, "launches_by_design")}
    per_step = {"cross_entropy_fwd": 2, "cross_entropy_bwd": 2,
                "flash_fwd": 24, "flash_bwd": 24}
    ok_counts = all(counts[k] == RESUME_STEPS * c
                    for k, c in per_step.items())
    ok_design = all(d["wgmma"] == counts[k] for k, d in by_design.items())
    del ddp, state

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ddp = build()
        state = ddp.init(seed=0)
        losses_resumed = []
        state, ema_state = run(ddp, state, ema.init(state.params), 0,
                               RESUME_AT, losses_resumed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with checkpoint.AsyncCheckpointer(root) as ckpt:
            ckpt.save({"state": state, "ema": ema_state}, step=state.step)
            save_call_s = time.perf_counter() - t0
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(root) for f in fs)
        del ddp, state, ema_state
        torch.cuda.empty_cache()

        fresh = build()
        template = {"state": fresh.init(seed=1)}
        template["ema"] = ema.init(template["state"].params)
        t0 = time.perf_counter()
        got = checkpoint.restore(root, template, verify=True,
                                 device=checkpoint.devices(template))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del template
        state, ema_state = run(fresh, got["state"], got["ema"], RESUME_AT,
                               RESUME_STEPS, losses_resumed)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    differ = [f"params.{k}" for k, v in state.params.items()
              if not torch.equal(v, full.params[k])]
    differ += [f"opt_state.{t}.{k}" for t in ("m", "v")
               for k, v in state.opt_state[t].items()
               if not torch.equal(v, full.opt_state[t][k])]
    differ += [f"ema.{k}" for k, v in ema_state["shadow"].items()
               if not torch.equal(v, full_ema["shadow"][k])]
    steps_equal = (state.step == full.step == RESUME_STEPS
                   and int(state.opt_state["step"]) == RESUME_STEPS
                   == int(full.opt_state["step"])
                   and int(ema_state["step"]) == int(full_ema["step"]))
    losses_equal = [float(a) == float(b)
                    for a, b in zip(losses_full, losses_resumed)]
    ok_resume = not differ and steps_equal and all(losses_equal)
    del fresh, state, ema_state, full, full_ema, got
    torch.cuda.empty_cache()

    # the example twins
    d = tempfile.mkdtemp(prefix="chip_smoke_example_mp_")
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            example_mp.train(example_args(example_mp, [
                "--max-steps", "3", "--checkpoint-every", "2",
                "--checkpoint-dir", d]))
            first_dirs = sorted(os.listdir(d))
            example_mp.train(example_args(example_mp, [
                "--max-steps", "2", "--resume", "--checkpoint-dir", d]))
        last_dirs = sorted(os.listdir(d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ok_example = (first_dirs == ["step_00000002", "step_00000003"]
                  and "resumed from step 3" in out.getvalue()
                  and "step_00000005" in last_dirs)

    t0 = time.perf_counter()
    lm = train_lm.train(train_lm.parse_args(["--generate", "32"]))
    lm_s = time.perf_counter() - t0
    lm_losses = lm["losses"]
    consistent = f"{lm['consistent']}/{lm['transitions']}"
    ok_lm = (all(map(math.isfinite, lm_losses))
             and statistics.mean(lm_losses[-10:]) < lm_losses[0] / 10
             and lm["consistent"] == lm["transitions"] == 32)
    del lm
    emit("resume", steps=RESUME_STEPS, saved_at=RESUME_AT,
         bit_exact=ok_resume, differing=differ[:10], n_differing=len(differ),
         losses=[float(v) for v in losses_full], losses_equal=losses_equal,
         save_call_s=save_call_s, save_s=save_s, restore_s=restore_s,
         checkpoint_bytes=ckpt_bytes, launches=counts,
         launches_per_step_expected=per_step, ok_launches=ok_counts,
         launches_by_design=by_design, ok_design=ok_design,
         example_mp={"first_run": first_dirs, "after_resume": last_dirs,
                     "ok": ok_example},
         train_lm={"first_loss": lm_losses[0], "last_losses": lm_losses[-5:],
                   "permutation_consistent": consistent,
                   "seconds": lm_s, "ok": ok_lm})
    return ok_resume and ok_counts and ok_design and ok_example and ok_lm


# ---------------------------------------------------------------------------
# the sequence-parallel slice: K2's offdiag mode, the split, the ring and
# train_lm --parallel sp
# ---------------------------------------------------------------------------

# design, (B, T, H, D), dtype, (block_q, block_k), timed: every design in
# causal="offdiag" mode, at the path's shape and at ragged ones; the first
# case gives the kernels line's rows
OFFDIAG_CASES = (
    ("wgmma", (8, 2048, 12, 64), torch.bfloat16, (1024, 1024), True),
    ("wgmma", (8, 2048, 12, 64), torch.bfloat16, (1024, 512), True),
    ("wgmma", (2, 1000, 3, 64), torch.bfloat16, (256, 384), False),
    ("mma_sync", (8, 2048, 6, 128), torch.bfloat16, (1024, 1024), True),
    ("mma_sync", (2, 1000, 3, 40), torch.bfloat16, (256, 128), False),
    ("fma", (2, 2048, 6, 64), torch.float32, (1024, 1024), True),
    ("fma", (2, 1000, 3, 40), torch.float32, (128, 384), False),
)


def check_flash_offdiag(results):
    """K2f/K2b in causal="offdiag" mode against their plain versions, in
    each design: within tolerance, two launches bit for bit alike, every
    launch of the design and mode the case must take, the first query
    block's rows empty (lse -1e30, o 0), and the plain causal result
    rejected by the same comparison (the planted fault).  Timed against the
    operations bound over the offdiag pairs, the plain version and SDPA
    with the band as a boolean mask."""
    import torch.nn.functional as F

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(2)
    ok_all = True
    for design, (b, t, h, d), dtype, blocks, timed in OFFDIAG_CASES:
        qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=g).to(dtype)
        q, k, v = qkv.unbind(2)
        do = torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)
        scale = 1.0 / math.sqrt(d)
        bq, bk = fa.clamp_blocks(dtype, t, t, *blocks)
        tol = FLASH_BF16_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL
        lims = (tol["rtol"], tol["atol"], tol["atol_row"], tol["atol_all"])
        picked = fa.flash_design(dtype, t, t, d,
                                 [x.stride() for x in (q, k, v)])

        def fwd():
            return fa.flash_fwd(q, k, v, "offdiag", scale, *blocks)

        zero_launch_counts()
        o_k, lse_k = fwd()
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, "offdiag", scale, *blocks)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()

        def bwd():
            return fa.flash_bwd(q, k, v, do, lse_p, delta, "offdiag", scale,
                                *blocks)

        grads_k = bwd()
        grads_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, "offdiag",
                                     scale, *blocks)
        o_k2, lse_k2 = fwd()
        grads_k2 = bwd()
        torch.cuda.synchronize()
        bitwise = {"fwd": torch.equal(o_k, o_k2) and torch.equal(lse_k,
                                                                 lse_k2),
                   "bwd": all(torch.equal(a, b2)
                              for a, b2 in zip(grads_k, grads_k2))}
        ran = {w.__name__: {"by_design": dict(w.launches_by_design),
                            "by_mode": dict(w.launches_by_mode)}
               for w in (fa.flash_fwd, fa.flash_bwd)}
        ok_launches = picked == design and all(
            r["by_design"][design] == 2 == sum(r["by_design"].values())
            and r["by_mode"]["offdiag"] == 2 == sum(r["by_mode"].values())
            for r in ran.values())
        pairs_kp = {"o": (o_k, o_p), "dq": (grads_k[0], grads_p[0]),
                    "dk": (grads_k[1], grads_p[1]),
                    "dv": (grads_k[2], grads_p[2])}
        errs, margins = {}, {}
        ok = True
        for name, (got, want) in pairs_kp.items():
            errs[name], _, margins[name], ok_t = compare(got, want, *lims)
            ok = ok and ok_t
        # rows before the first query block past key block 0 see no key:
        # lse -1e30 and o 0 (held apart: the rms of -1e30 overflows)
        first = offdiag_live(t, (bq, bk))[0]
        ok_empty = (bool((lse_k[:, :, :first] <= -1e29).all())
                    and bool((lse_p[:, :, :first] <= -1e29).all())
                    and not bool(o_k[:, :first].any()))
        errs["lse"], _, margins["lse"], ok_l = compare(
            lse_k[:, :, first:], lse_p[:, :, first:], 1e-5, 1e-4)
        # the planted fault: the plain causal pass (its own lse and delta)
        # in place of the kernels' must fail every comparison
        o_c, lse_c = fa.flash_fwd_plain(q, k, v, True, scale)
        delta_c = (do.float() * o_c.float()).sum(-1).transpose(1, 2)
        g_c = fa.flash_bwd_plain(q, k, v, do, lse_c, delta_c.contiguous(),
                                 True, scale)
        caught = {name: compare(got, pairs_kp[name][1], *lims)[2]
                  for name, got in zip(("o", "dq", "dk", "dv"),
                                       (o_c, *g_c))}
        ok_fault = all(m > 1.0 for m in caught.values())
        del o_c, lse_c, g_c, delta_c
        ok = (ok and ok_l and ok_launches and ok_empty and ok_fault
              and all(bitwise.values()))
        ok_all = ok_all and ok
        shape = {"q": [b, t, h, d], "dtype": str(dtype).split(".")[-1],
                 "blocks": list(blocks), "clamped_blocks": [bq, bk]}
        fields = {}
        if timed:
            keep = fa._keep_mask(t, t, "offdiag", dtype, "cuda", *blocks)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))

            def lib_fwd():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=keep)

            lib_o = lib_fwd()

            def lib_bwd():
                return torch.autograd.grad(lib_o, (qt, kt, vt),
                                           do.transpose(1, 2),
                                           retain_graph=True)

            # bytes: only the rows the mode reads (q and dO from the first
            # live query, k and v below the last query's limit, lse and
            # delta of the live queries), every output written in full
            row = b * h * d * q.element_size()
            q0, k_end = offdiag_live(t, (bq, bk))
            live_q = t - q0
            pairs = b * h * causal_pairs(t, t, "offdiag", (bq, bk))
            kind = "bf16_tensor" if dtype == torch.bfloat16 else "f32"
            bf = bound(row * (live_q + 2 * k_end + t) + b * h * t * 4,
                       4 * d * pairs, kind)
            bb = bound(row * (2 * live_q + 2 * k_end + 3 * t)
                       + 2 * b * h * live_q * 4, 10 * d * pairs, kind)
            t_f = (time_ms(fwd), time_ms(lambda: fa.flash_fwd_plain(
                q, k, v, "offdiag", scale, *blocks), reps=3),
                time_ms(lib_fwd))
            t_b = (time_ms(bwd), time_ms(lambda: fa.flash_bwd_plain(
                q, k, v, do, lse_p, delta, "offdiag", scale, *blocks),
                reps=3), time_ms(lib_bwd))
            del lib_o, qt, kt, vt, keep
            fields = {"pairs": pairs,
                      "fwd": dict(ms=t_f[0], plain_ms=t_f[1],
                                  library_ms=t_f[2], bound_ms=bf[0],
                                  bound_by=bf[1], bound_share=bf[0] / t_f[0]),
                      "bwd": dict(ms=t_b[0], plain_ms=t_b[1],
                                  library_ms=t_b[2], bound_ms=bb[0],
                                  bound_by=bb[1], bound_share=bb[0] / t_b[0]),
                      "library": "F.scaled_dot_product_attention with the "
                                 "offdiag band as a boolean attn_mask"}
            if "flash_fwd_offdiag" not in results:  # the path's shape
                results["flash_fwd_offdiag"] = dict(
                    max_abs_err=max(errs["o"], errs["lse"]), ms=t_f[0],
                    plain_ms=t_f[1], library_ms=t_f[2], bound_ms=bf[0],
                    bound_by=bf[1])
                results["flash_bwd_offdiag"] = dict(
                    max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]),
                    ms=t_b[0], plain_ms=t_b[1], library_ms=t_b[2],
                    bound_ms=bb[0], bound_by=bb[1])
        emit("flash_offdiag", shape=shape, design=design, picked=picked,
             launches=ran, ok_launches=ok_launches, repeat_bitwise=bitwise,
             max_abs_err=errs, margin=margins, tolerance=tol,
             first_block_empty=ok_empty, planted_causal_margin=caught,
             ok_fault_rejected=ok_fault, ok=ok, **fields)
        del qkv, q, k, v, do, o_k, o_p, grads_k, grads_p, o_k2, grads_k2
    return ok_all


SPLIT_SHAPES = ((8, 2048, 12, 64), (1, 8192, 12, 64))


def _split_pass(fa, qkv, do, split: bool, grad: bool = True):
    """One causal flash pass over the fused projection's q/k/v views,
    split or not: ``o``, or ``(o, (dq, dk, dv))`` for the cotangent
    ``do``."""
    q, k, v = qkv.unbind(2)
    o = fa.flash_attention(q, k, v, causal=True, split_diag=split)
    if not grad:
        return o
    return o.detach(), torch.autograd.grad(o, qkv, do)[0].unbind(2)


def check_split_diag(results):
    """``flash_attention(split_diag=True)`` against ``split_diag=False``:
    the forward and the q/k/v grads (through the fused projection's views,
    as on the path) within the flash tolerance, and two K2f and two K2b
    calls a split pass, one causal and one offdiag each (this phase's
    offdiag launches are the kernels line's).  Both timed, forward and
    forward + backward, in turns; beside them the split's plain forward
    (the plain versions of its two calls and the merge), SDPA's causal
    call and the bound of the causal pairs (the split's executed area)."""
    import torch.nn.functional as F

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(3)
    lims = tuple(FLASH_BF16_TOL[k] for k in ("rtol", "atol", "atol_row",
                                             "atol_all"))
    ok_all = True
    runs = []
    zero_launch_counts()
    for b, t, h, d in SPLIT_SHAPES:
        qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=g).to(
            torch.bfloat16).requires_grad_(True)
        do = torch.randn(b, t, h, d, device="cuda", generator=g).to(
            torch.bfloat16)
        before = {w.__name__: dict(w.launches_by_mode)
                  for w in (fa.flash_fwd, fa.flash_bwd)}
        o_s, g_s = _split_pass(fa, qkv, do, True)
        torch.cuda.synchronize()
        split_calls = {w.__name__: {m: w.launches_by_mode[m]
                                    - before[w.__name__][m]
                                    for m in fa.MODES}
                       for w in (fa.flash_fwd, fa.flash_bwd)}
        o_1, g_1 = _split_pass(fa, qkv, do, False)
        torch.cuda.synchronize()
        ok_calls = all(c == {"none": 0, "causal": 1, "offdiag": 1}
                       for c in split_calls.values())
        errs, margins, ok = {}, {}, ok_calls
        for name, got, want in (("o", o_s, o_1), *zip(
                ("dq", "dk", "dv"), g_s, g_1)):
            errs[name], _, margins[name], ok_t = compare(got, want, *lims)
            ok = ok and ok_t
        runs.append(dict(shape=[b, t, h, d], calls_a_pass=split_calls,
                         ok_calls=ok_calls, max_abs_err=errs,
                         margin=margins, ok=ok, qkv=qkv, do=do))
        ok_all = ok_all and ok
    for name in ("flash_fwd", "flash_bwd"):
        w = getattr(fa, name)
        results.setdefault(f"{name}_offdiag", {})["launches"] = \
            w.launches_by_mode["offdiag"]
    for r in runs:
        qkv, do = r.pop("qkv"), r.pop("do")

        def fwd(split):
            with torch.no_grad():
                return _split_pass(fa, qkv, do, split, grad=False)

        def fwd_bwd(split):
            return _split_pass(fa, qkv, do, split)

        times = {}
        for label, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
            one = time_ms(lambda: fn(False))
            split = (time_ms(lambda: fn(True)) + time_ms(lambda: fn(True))) / 2
            one = (one + time_ms(lambda: fn(False))) / 2
            times[label] = {"single_ms": one, "split_ms": split,
                            "split_over_single": split / one}
        b, t, h, d = r["shape"]
        q, k, v = (x.detach() for x in qkv.unbind(2))
        scale, band = 1.0 / math.sqrt(d), min(1024, t)

        def plain_split():
            o_d, lse_d = fa.flash_fwd_plain(
                *(fa._to_bands(x, band) for x in (q, k, v)), True, scale)
            o_off, lse_off = fa.flash_fwd_plain(q, k, v, "offdiag", scale)
            return fa.merge_lse(o_off, lse_off, o_d.reshape(b, t, h, d),
                                fa._rows_from_bands(lse_d, b))

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        times["fwd"]["plain_ms"] = time_ms(plain_split, reps=3)
        times["fwd"]["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True))
        times["fwd_bwd"]["library_ms"] = times["fwd"]["library_ms"] + \
            time_ms(lambda: torch.autograd.grad(
                lib_o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        pairs = b * h * causal_pairs(t, t, True)
        tile = b * t * h * d * q.element_size()
        times["fwd"]["bound_ms"], times["fwd"]["bound_by"] = bound(
            4 * tile + b * h * t * 4, 4 * d * pairs, "bf16_tensor")
        bb = bound(7 * tile + 2 * b * h * t * 4, 10 * d * pairs,
                   "bf16_tensor")
        times["fwd_bwd"]["bound_ms"] = times["fwd"]["bound_ms"] + bb[0]
        del qkv, do, q, k, v, qt, kt, vt, lib_o
        results.setdefault("split_diag", []).append(
            {"shape": r["shape"], **times})
        emit("split_diag", tolerance=FLASH_BF16_TOL["why"][:60], **r,
             times=times)
    return ok_all


RING_N = 4
RING_SHAPE = (1, 8192, 12, 64)  # global (B, T, H, D): 4 shards of 2048


def check_ring(results):
    """The ring's per-hop functions over ``RING_N`` virtual ranks in one
    process (``ring_one_process``: lists stand in for the shifts) at
    GPT-2-small's attention over 8192 positions, causal and not: first one
    K2f/K2b call on the gathered sequence against the plain versions (o,
    lse, q/k/v grads); then the ring's output and q/k/v grads against that
    call, and n(n+1)/2 (causal) or n² launches of each; then Ulysses' local
    attention (3 heads a rank over the whole sequence) the same way, n
    launches each; then ``ring_self_attention`` at world 1 through its
    entry point (one launch each, equal to the single call).  The hops'
    own shape, (1, 2048, 12, 64) causal and not, is held against the plain
    versions in the ``flash`` phase."""
    from tpu_dist_torch import dist
    from tpu_dist_torch.nn.attention import scaled_dot_product_attention
    from tpu_dist_torch.parallel import ring_self_attention
    from tpu_dist_torch.parallel.ring_attention import ring_one_process

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(4)
    b, t, h, d = RING_SHAPE
    n = RING_N
    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=g).to(
        torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    lims = tuple(FLASH_BF16_TOL[key] for key in ("rtol", "atol", "atol_row",
                                                 "atol_all"))
    ok_all = True

    def launches():
        return fa.flash_fwd.launches, fa.flash_bwd.launches

    def held(got, want):
        """Errors and margins of o, dq, dk, dv against the reference."""
        out = {}
        for name, x, y in zip(("o", "dq", "dk", "dv"), got, want):
            err, _, margin, ok = compare(x, y, *lims)
            out[name] = {"max_abs_err": err, "margin": margin, "ok": ok}
        return out, all(r["ok"] for r in out.values())

    for causal in (True, False):
        o_ref, lse_ref = fa.flash_fwd(q, k, v, causal, scale)
        delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        g_ref = fa.flash_bwd(q, k, v, do, lse_ref, delta, causal, scale)
        ref = (o_ref, *g_ref)
        # the reference itself against the plain versions on its inputs
        # (the backward from the kernel's own lse and delta): the single
        # call at T = 8192, which the sp step's attention also runs
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        g_p = fa.flash_bwd_plain(q, k, v, do, lse_ref, delta, causal, scale)
        single_err, ok_single = held(ref, (o_p, *g_p))
        lse_err, _, lse_margin, ok_lse = compare(lse_ref, lse_p, 1e-5, 1e-4)
        single_err["lse"] = {"max_abs_err": lse_err, "margin": lse_margin,
                             "ok": ok_lse}
        ok_single = ok_single and ok_lse
        del o_p, lse_p, g_p
        torch.cuda.empty_cache()
        shards = [list(x.chunk(n, 1)) for x in (q, k, v, do)]

        def ring():
            return ring_one_process(*shards[:3], causal, "flash",
                                    dos=shards[3])

        zero_launch_counts()
        outs, grads = ring()
        torch.cuda.synchronize()
        ring_launches = launches()
        want = n * (n + 1) // 2 if causal else n * n
        got = (torch.cat(outs, 1),
               *(torch.cat([gr[i] for gr in grads], 1) for i in range(3)))
        ring_err, ok_ring = held(got, ref)
        ok_ring = ok_ring and ring_launches == (want, want)

        def ulysses():
            per = h // n
            o_u, g_u = [], []
            for r in range(n):
                hs = slice(r * per, (r + 1) * per)
                qh, kh, vh = (x[:, :, hs].detach().requires_grad_(True)
                              for x in (q, k, v))
                o = scaled_dot_product_attention(qh, kh, vh, causal=causal)
                g_u.append(torch.autograd.grad(o, (qh, kh, vh),
                                               do[:, :, hs]))
                o_u.append(o.detach())
            return (torch.cat(o_u, 2),
                    *(torch.cat([gr[i] for gr in g_u], 2) for i in range(3)))

        zero_launch_counts()
        got_u = ulysses()
        torch.cuda.synchronize()
        uly_launches = launches()
        uly_err, ok_uly = held(got_u, ref)
        ok_uly = ok_uly and uly_launches == (n, n)

        dist.init_process_group(axis_names=("seq",), mesh_shape=(1,))
        try:
            qx, kx, vx = (x.detach().requires_grad_(True) for x in (q, k, v))
            zero_launch_counts()
            o_w1 = ring_self_attention(qx, kx, vx, "seq", causal=causal)
            g_w1 = torch.autograd.grad(o_w1, (qx, kx, vx), do)
            torch.cuda.synchronize()
            w1_launches = launches()
        finally:
            dist.destroy_process_group()
        got_w1 = (o_w1.detach(), *g_w1)
        w1_err, ok_w1 = held(got_w1, ref)
        w1_bitwise = all(torch.equal(x, y) for x, y in zip(got_w1, ref))
        ok_w1 = ok_w1 and w1_launches == (1, 1)

        def single():
            o, lse = fa.flash_fwd(q, k, v, causal, scale)
            dl = (do.float() * o.float()).sum(-1).transpose(1, 2)
            return fa.flash_bwd(q, k, v, do, lse, dl.contiguous(), causal,
                                scale)

        times = {"single_fwd_bwd_ms": time_ms(single, reps=5),
                 "ring_one_process_fwd_bwd_ms": time_ms(ring, reps=5),
                 "ulysses_local_fwd_bwd_ms": time_ms(ulysses, reps=5)}
        ok = ok_single and ok_ring and ok_uly and ok_w1
        ok_all = ok_all and ok
        results.setdefault("ring", {})[f"causal={causal}"] = times
        emit("ring", causal=causal, virtual_ranks=n, global_shape=[b, t, h, d],
             single_call_vs_plain={"held": single_err, "ok": ok_single},
             ring={"launches": ring_launches, "expected": [want, want],
                   "held": ring_err, "ok": ok_ring},
             ulysses_local={"launches": uly_launches, "expected": [n, n],
                            "held": uly_err, "ok": ok_uly},
             world1_entry_point={"launches": w1_launches, "held": w1_err,
                                 "bitwise_equal_single_call": w1_bitwise,
                                 "ok": ok_w1},
             times=times, tolerance=FLASH_BF16_TOL["why"][:60], ok=ok)
        del outs, grads, got, got_u, got_w1, o_ref, g_ref, ref, shards
    return ok_all


# GPT-2-small at long context through the sp twin, bf16 over float32
# masters; SGD at SP_LR (see SP_STEP_TOL)
SP_ARGV = ["--seq-len", "8192", "--batch-size", "1", "--dim", "768",
           "--depth", "12", "--heads", "12", "--vocab", "32768",
           "--compute-dtype", "bfloat16", "--log-every", "5"]
SP_LR = "2.0"
SP_STEPS = 20
SP_STEP_TOL = {"loss_rtol": 1e-2, "update_rel": 5e-2, "leaf_update_rel": 0.25,
               "why": "the dense slice's composition limits (loss, update "
                      "and worst leaf): at world 1 the ring is one "
                      "diagonal block and Ulysses' all-to-all the "
                      "identity, so both run the dense model's kernels "
                      "on the same inputs (bit for bit expected, reported "
                      "as bitwise)"}


def check_sp_train(results):
    """``train_lm --parallel sp`` at world 1 on the card, full width
    (GPT-2-small, vocab 32768, T = 8192, batch 1, bf16): one step of each
    mode against the same model built without ``sequence_axis``
    (``--parallel dp``) from the same seed and batch (``SP_STEP_TOL``);
    then ``SP_STEPS`` steps a mode: the loss falls, K2f/K2b launch ``depth``
    times a step (all wgmma), step ms and tokens/s."""
    from tpu_dist_torch.examples import train_lm
    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

    def run(parallel, mode, steps):
        return train_lm.train(train_lm.parse_args(
            SP_ARGV + ["--parallel", parallel, "--sp-mode", mode,
                       "--steps", str(steps), "--lr", SP_LR]))

    def params(r):
        return {k: p.detach() for k, p in r["state"].params.items()}

    p0 = params(run("dp", "ring", 0))
    dense = run("dp", "ring", 1)
    p_dense, loss_dense = params(dense), dense["losses"][0]
    del dense
    ok_all = True
    for mode in ("ring", "ulysses"):
        one = run("sp", mode, 1)
        p_sp, loss_sp = params(one), one["losses"][0]
        del one
        num = {k: float((p_sp[k] - p_dense[k]).pow(2).sum()) for k in p0}
        den = {k: float((p_dense[k] - p0[k]).pow(2).sum()) for k in p0}
        rel = math.sqrt(sum(num.values()) / max(sum(den.values()), 1e-30))
        leaf = {k: math.sqrt(num[k] / den[k]) if den[k] else
                (0.0 if num[k] == 0 else math.inf) for k in p0}
        worst = max(leaf, key=leaf.get)
        bitwise = all(torch.equal(p_sp[k], p_dense[k]) for k in p0)
        ok_step = (abs(loss_sp - loss_dense)
                   <= SP_STEP_TOL["loss_rtol"] * abs(loss_dense)
                   and rel <= SP_STEP_TOL["update_rel"]
                   and leaf[worst] <= SP_STEP_TOL["leaf_update_rel"])
        del p_sp
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        r = run("sp", mode, SP_STEPS)
        counts = {w.__name__: {"launches": w.launches,
                               "by_design": dict(w.launches_by_design)}
                  for w in (fa.flash_fwd, fa.flash_bwd)}
        depth = int(SP_ARGV[SP_ARGV.index("--depth") + 1])
        ok_counts = all(c["launches"] == SP_STEPS * depth
                        == c["by_design"]["wgmma"] for c in counts.values())
        losses = r["losses"]
        ok_loss = (all(map(math.isfinite, losses))
                   and statistics.mean(losses[-5:]) < losses[0])
        step_ms = r["loop_seconds"] / (SP_STEPS - 1) * 1e3
        tokens_s = (r["batch"] * r["seq_len"] * (SP_STEPS - 1)
                    / r["loop_seconds"])
        r_first = r["first_step_seconds"]
        peak = torch.cuda.max_memory_allocated()
        del r
        ok = ok_step and ok_counts and ok_loss
        ok_all = ok_all and ok
        results.setdefault("sp_train", {})[mode] = {
            "step_ms": step_ms, "tokens_per_s": tokens_s}
        emit("sp_train", mode=mode, world=1,
             one_step={"loss_sp": loss_sp, "loss_dense": loss_dense,
                       "update_rel_err": rel, "worst_leaf": [worst,
                                                             leaf[worst]],
                       "bitwise": bitwise, "tolerance": SP_STEP_TOL,
                       "ok": ok_step},
             steps=SP_STEPS, losses=losses, ok_loss_falls=ok_loss,
             launches=counts, launches_per_step=depth, ok_launches=ok_counts,
             step_ms=step_ms, tokens_per_s=tokens_s,
             first_step_s=r_first, peak_mem_bytes=peak, ok=ok)
    return ok_all


# ---------------------------------------------------------------------------
# ImageNet-class training: augmentation on the card, ResNet-50, ViT-B/16
# ---------------------------------------------------------------------------

AUG_BATCH, AUG_RAW = 128, 256  # the example's batch of raw 256² uint8


def bf16_ulps(got, want) -> float:
    """The largest difference in units of bf16's spacing at the larger of
    the two magnitudes (a value rounded the other way is one unit off)."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max())


def check_augment(results):
    """``DeviceAugment.imagenet(224, bf16)``, ``imagenet_eval(224, 256)`` and
    ``cifar10(32)`` at the example's batch (128 × 256² × 3 uint8; 256 × 32²
    × 3) on the card, each against the same call on a CPU copy with the
    same key: float32 within 1e-5, bf16 within one bf16 ulp.  The modes'
    invariants: a forced flip mirrors the image, a pad_crop window is an
    integer crop of the padded image, the eval output ignores the key.
    Images/s of the card's augmentation, of the raw host gather from an
    in-RAM uint8 array (``DataLoader(to_float=False)``, one thread, as
    ``benchmarks/input_pipeline.py`` measures it) and of the ResNet-50 step
    alone; the pinned staging's host time and the H2D bytes a batch; and
    ``loader_keeps_card_fed`` (``raw_host_rate >= 1/(1/aug_rate +
    1/step_rate)``, the JAX benchmark's verdict)."""
    import numpy as np

    from tpu_dist_torch import random as trandom
    from tpu_dist_torch.benchmarks import imagenet_e2e
    from tpu_dist_torch.data import (ArrayImageDataset, DataLoader,
                                     DeviceAugment)

    zero_launch_counts()
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(
        0, 256, (AUG_BATCH, AUG_RAW, AUG_RAW, 3), np.uint8))
    small = torch.from_numpy(rng.integers(0, 256, (256, 32, 32, 3),
                                          np.uint8))
    key = trandom.fold_in(trandom.key(3), 7)
    cases = (("imagenet", DeviceAugment.imagenet(224, dtype=torch.bfloat16),
              raw),
             ("imagenet_eval", DeviceAugment.imagenet_eval(224, 256), raw),
             ("cifar10", DeviceAugment.cifar10(32), small))
    ok_all = True
    rates = {}
    for name, aug, x in cases:
        x_dev = x.cuda()
        got = aug(x_dev, key.cuda())
        want = aug(x, key)
        on_card = got.device.type == "cuda"
        if aug.dtype == torch.bfloat16:
            err, limit = bf16_ulps(got.cpu(), want), 1.0
        else:
            err, limit = float((got.cpu() - want).abs().max()), 1e-5
        ok = (on_card and err <= limit and got.dtype == aug.dtype
              and tuple(got.shape) == (x.shape[0], 3, *aug.size)
              and bool(torch.isfinite(got).all()))
        k_dev = key.cuda()
        ms = time_ms(lambda: aug(x_dev, k_dev))
        rates[name] = x.shape[0] / ms * 1e3
        emit("augment", case=name, mode=aug.mode,
             dtype=str(aug.dtype).split(".")[-1], shape=list(got.shape),
             err_vs_cpu=err, limit=limit,
             limit_unit="bf16 ulps" if aug.dtype == torch.bfloat16
             else "abs", ms=ms, images_per_s=rates[name], ok=ok)
        ok_all = ok_all and ok

    # invariants, on the card
    x_dev = raw.cuda()
    k_dev = key.cuda()
    flip = DeviceAugment.imagenet(224, flip_p=1.0)(x_dev, k_dev)
    keep = DeviceAugment.imagenet(224, flip_p=0.0)(x_dev, k_dev)
    ok_flip = torch.equal(flip, keep.flip(3))
    plain = DeviceAugment(32, mode="pad_crop", padding=4, flip_p=0.0,
                          mean=(0.0,) * 3, std=(1.0,) * 3)
    s_dev = small.cuda()
    out = plain(s_dev, k_dev)
    # the augmentation's own /255: a tensor divisor (CUDA divides by a
    # Python number as a multiply by its reciprocal)
    padded = torch.nn.functional.pad(
        s_dev.float() / torch.full((), 255.0, device="cuda"),
        (0, 0, 4, 4, 4, 4))
    keys = trandom.split(k_dev, 5)
    top = trandom.randint(keys[2], (256,), 0, 9)
    left = trandom.randint(keys[3], (256,), 0, 9)
    windows = torch.stack([padded[i, t:t + 32, l:l + 32] for i, (t, l) in
                           enumerate(zip(top.tolist(), left.tolist()))])
    ok_pad = torch.equal(out, windows.permute(0, 3, 1, 2))
    ev = DeviceAugment.imagenet_eval(224, 256)
    ok_eval = torch.equal(ev(x_dev, k_dev),
                          ev(x_dev, trandom.key(99).cuda()))
    emit("augment", invariants={"forced_flip_mirrors": ok_flip,
                                "pad_crop_is_integer_window": ok_pad,
                                "eval_ignores_key": ok_eval})
    ok_all = ok_all and ok_flip and ok_pad and ok_eval

    # the host's half: the raw gather, the pinned copy
    n_img = 1024
    ds = ArrayImageDataset(rng.integers(0, 256, (n_img, AUG_RAW, AUG_RAW, 3),
                                        np.uint8),
                           rng.integers(0, 1000, n_img))
    loader = DataLoader(ds, batch_size=AUG_BATCH, shuffle=True,
                        drop_last=True, to_float=False)
    best = math.inf
    for ep in range(3):
        loader.set_epoch(ep)
        t0 = time.perf_counter()
        seen = 0
        for xb, _ in loader:
            seen += xb.shape[0]
        best = min(best, (time.perf_counter() - t0) / seen)
    raw_host = 1.0 / best
    pin_ms, copy_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned = raw.pin_memory()
        t1 = time.perf_counter()
        pinned.to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        pin_ms.append((t1 - t0) * 1e3)
        copy_ms.append((time.perf_counter() - t1) * 1e3)
    with tf32(True):
        ddp, xs, ys = imagenet_e2e.build(device="cuda")
        state = ddp.init(seed=0)
        step = lambda: ddp.train_step(state, xs, ys)
        step_ms = time_ms(step, reps=5, warm=3)
    del ddp, state, xs, ys
    step_rate = AUG_BATCH / step_ms * 1e3
    consume = 1.0 / (1.0 / rates["imagenet"] + 1.0 / step_rate)
    counts = launch_counts()
    ok_launches = not any(counts.values())
    results["augment"] = {"aug_images_per_s": rates["imagenet"],
                          "raw_host_images_per_s": raw_host,
                          "step_images_per_s": step_rate}
    emit("augment", aug_images_per_s=rates,
         raw_host_images_per_s=raw_host,
         h2d_bytes_per_batch=raw.numel(),
         pin_memory_ms=statistics.median(pin_ms),
         h2d_copy_ms=statistics.median(copy_ms),
         resnet50_step_ms=step_ms, resnet50_step_images_per_s=step_rate,
         card_consumes_images_per_s=consume,
         loader_keeps_card_fed=raw_host >= consume,
         kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_all and ok_launches


def _randomize_head(module) -> None:
    """A ViT's head drawn N(0, 0.02) in place (its init is zero, under which
    a first step reaches no parameter below the head)."""
    g = torch.Generator(device=module.head.weight.device).manual_seed(5)
    with torch.no_grad():
        module.head.weight.normal_(0.0, 0.02, generator=g)


RESNET50_STEP_TOL = {
    "loss_rtol": 1e-5, "update_rel": 8e-2, "state_rel": 1e-4,
    "why": "float32 with TF32 off on both sides, ResNet-50 at batch 4: "
           "VISION_STEP_TOL's reasons, over 53 BatchNorm layers. A leaf is "
           "held to the CPU parity tests' LEAF_TOL (tests/"
           "test_torch_vision_ddp.py: a ReLU input within rounding of 0 "
           "takes the other branch in one of two runs); measured on an "
           "H100 at 700 W, bn1.bias 3.7e-2. The statistics to about 3.5 "
           "times the worst measured there, layer4.2.bn1.var 2.8e-5: the "
           "rounding of 50 layers below compounds into layer4's 7x7 maps"}


def _one_step_vs_cpu(model_fn, batch, tol, prepare=None):
    """One float32 step of ``model_fn``'s model on the card at ``batch``
    images, SGD lr 0.1, against the CPU copy; the batch is
    ``DeviceAugment.imagenet(224)`` (float32) over raw 256² images."""
    import numpy as np

    from tpu_dist_torch import nn, optim
    from tpu_dist_torch import random as trandom
    from tpu_dist_torch.data import DeviceAugment
    from tpu_dist_torch.parallel import DistributedDataParallel

    rng = np.random.default_rng(1)
    raw = torch.from_numpy(rng.integers(0, 256, (batch, 256, 256, 3),
                                        np.uint8)).cuda()
    x = DeviceAugment.imagenet(224)(raw, trandom.key(1).cuda())
    y = torch.from_numpy(rng.integers(0, 1000, batch)).cuda()
    ddp = DistributedDataParallel(model_fn("cuda"),
                                  optimizer=optim.SGD(lr=0.1),
                                  loss_fn=nn.CrossEntropyLoss())
    return step_against_cpu(ddp, lambda: model_fn("cpu"), x, y, tol,
                            prepare=prepare)


def check_imagenet(results):
    """The ``example_imagenet`` twin at its defaults (ResNet-50, 224, 128 a
    replica, bf16 over float32 masters, SGD 0.1/0.9/1e-4, augmentation on
    the card) on ``SyntheticImageNet`` for 30 steps: the loss finite and
    falling, every BatchNorm statistic moved and finite; ``--evaluate``
    (``imagenet_eval`` on the card) counts exactly the set's 512 images.
    One float32 step at batch 4 against the CPU copy (``RESNET50_STEP_TOL``).
    Then the ``imagenet_e2e`` twin under torch's default TF32: the step
    alone and the sustained rate with the loader and the augmentation in
    the loop, and the peak memory.  No hand-written kernel may launch."""
    from tpu_dist_torch.benchmarks import imagenet_e2e
    from tpu_dist_torch.examples import example_imagenet
    from tpu_dist_torch.models import resnet50

    zero_launch_counts()
    t0 = time.perf_counter()
    r = example_imagenet.train(example_imagenet.parse_args(
        ["--epochs", "2", "--max-steps", "30", "--evaluate"]))
    run_s = time.perf_counter() - t0
    losses = [float(v) for v in r["losses"]]
    stats = r["state"].model_state
    moved = bn_moved(stats)
    falling = statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
    ev = r["eval"]
    ok_train = (len(losses) == 30 and all(map(math.isfinite, losses))
                and falling and moved and len(stats) == 53
                and ev["count"] == 512)
    del r
    cmp_ = _one_step_vs_cpu(
        lambda d: resnet50(num_classes=1000, device=d), 4, RESNET50_STEP_TOL)
    with tf32(True):
        e2e = imagenet_e2e.run()
    counts = launch_counts()
    ok_launches = not any(counts.values())
    fed = results.get("augment")
    if fed:
        consume = 1.0 / (1.0 / fed["aug_images_per_s"]
                         + 1.0 / e2e["step_only_images_per_sec"])
        fed = {**fed, "e2e_step_images_per_s":
               e2e["step_only_images_per_sec"],
               "loader_keeps_card_fed":
                   fed["raw_host_images_per_s"] >= consume}
    emit("imagenet", steps=len(losses), first_losses=losses[:5],
         last_losses=losses[-5:], loss_falling=falling, bn_layers=len(stats),
         bn_stats_moved_and_finite=moved, eval=ev, run_and_eval_s=run_s,
         ok_train=ok_train, step_vs_cpu=cmp_, e2e=e2e, feed=fed,
         timing_note="torch's default TF32 permissions (cuDNN yes, cuBLAS "
                     "no); images/s/GPU at world 1",
         kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_train and cmp_["ok"] and ok_launches


VIT_SHAPE = (64, 197, 12, 64)  # ViT-B/16 at 224, 64 images: (B, T, H, D)
# the training run's classes: at 1000 (two images a class in the set) the
# loss stays at ln(1000) within bf16's resolution over 20 AdamW steps at
# 3e-4 from the zero head (measured on one H100); at 10 the class
# templates are learnable that soon
VIT_CLASSES = 10


def check_vit(results):
    """The twin with ``--model vit_b_16`` for 20 steps at 64 a card in bf16
    (AdamW 3e-4, weight decay 0.05; ``VIT_CLASSES`` classes): the loss
    finite and falling.  One
    float32 step at batch 2 against the CPU copy (SGD, from a random head:
    AdamW's first update is lr·sign(g), which a rounding flips wherever a
    gradient is near 0).  The ``vit_train`` twin: images/s, step ms, model
    TFLOP/s, peak memory.  No hand-written kernel may launch.  Then
    ``_FLASH_MIN_SEQ`` measured: ViT-B/16's attention at (64, 197, 12, 64)
    bf16, forward and backward, as the dense composition and through
    K2f/K2b (``impl="flash"``), the flash result held against its plain
    version at that ragged T."""
    from tpu_dist_torch.benchmarks import vit_train
    from tpu_dist_torch.examples import example_imagenet
    from tpu_dist_torch.models import vit_b_16
    from tpu_dist_torch.nn import scaled_dot_product_attention

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    zero_launch_counts()
    t0 = time.perf_counter()
    r = example_imagenet.train(example_imagenet.parse_args(
        ["--model", "vit_b_16", "--batch-size", "64", "--max-steps", "20",
         "--num-classes", str(VIT_CLASSES)]))
    run_s = time.perf_counter() - t0
    losses = [float(v) for v in r["losses"]]
    n_params = sum(p.numel() for p in r["state"].params.values())
    del r
    falling = statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
    ok_train = (len(losses) == 20 and all(map(math.isfinite, losses))
                and falling
                and n_params == 86_567_656 - 990 * (768 + 1))
    cmp_ = _one_step_vs_cpu(lambda d: vit_b_16(num_classes=1000, device=d),
                            2, VISION_STEP_TOL, prepare=_randomize_head)
    with tf32(True):
        row = vit_train.run()
    row.pop("losses")
    counts = launch_counts()
    ok_launches = not any(counts.values())
    emit("vit", steps=len(losses), classes=VIT_CLASSES,
         first_losses=losses[:5],
         last_losses=losses[-5:], loss_falling=falling, n_params=n_params,
         run_s=run_s, ok_train=ok_train, step_vs_cpu=cmp_, timing=row,
         peak_tflops_bf16=PEAK_OPS_S["bf16_tensor"] / 1e12,
         kernel_launches=counts, ok_launches_zero=ok_launches)

    # the dispatch crossover at ViT's shape: dense against flash
    b, t, h, d = VIT_SHAPE
    g = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(b, t, 3, h, d, device="cuda",
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(b, t, h, d, device="cuda",
                     generator=g).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    o_k, lse = fa.flash_fwd(q, k, v, False, scale)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, False, scale)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    gk = fa.flash_bwd(q, k, v, do, lse_p, delta, False, scale)
    gp = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, False, scale)
    tol = FLASH_BF16_TOL
    lims = (tol["rtol"], tol["atol"], tol["atol_row"], tol["atol_all"])
    margins = {n: compare(a, w, *lims)[2] for n, a, w in
               (("o", o_k, o_p), ("dq", gk[0], gp[0]), ("dk", gk[1], gp[1]),
                ("dv", gk[2], gp[2]))}
    ok_flash = all(m <= 1.0 for m in margins.values())
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def fwd(impl):
        return lambda: scaled_dot_product_attention(*leaves, impl=impl)

    def fwd_bwd(impl):
        def f():
            o = scaled_dot_product_attention(*leaves, impl=impl)
            torch.autograd.grad(o, leaves, do)
        return f

    times = {}
    for impl in ("dense", "flash", "flash", "dense"):  # in turns
        for what, fn in (("fwd", fwd(impl)), ("fwd_bwd", fwd_bwd(impl))):
            times.setdefault(f"{impl}_{what}_ms", []).append(time_ms(fn))
    times = {k: statistics.mean(v) for k, v in times.items()}
    emit("vit_attention", shape=list(VIT_SHAPE), dtype="bfloat16",
         flash_margin=margins, flash_tolerance=tol, ok_flash=ok_flash,
         flash_min_seq=importlib.import_module(
             "tpu_dist_torch.nn.attention")._FLASH_MIN_SEQ,
         flash_over_dense_fwd=times["flash_fwd_ms"] / times["dense_fwd_ms"],
         flash_over_dense_fwd_bwd=(times["flash_fwd_bwd_ms"]
                                   / times["dense_fwd_bwd_ms"]), **times)
    results["vit"] = {"images_per_s": row["value"],
                      "tflops": row["achieved_model_tflops"]}
    return ok_train and cmp_["ok"] and ok_launches and ok_flash


# ---------------------------------------------------------------------------
# the launcher and the control plane (slice 10)
# ---------------------------------------------------------------------------

# the launched path: the train_lm twin at GPT-2-small width, T = 2048, bf16
LAUNCH_ARGV = ["--vocab", "32768", "--dim", "768", "--depth", "12",
               "--heads", "12", "--seq-len", "2048", "--batch-size", "8",
               "--compute-dtype", "bfloat16", "--steps", "3",
               "--log-every", "1"]
# the served model of the gateway phase: the serve phases' (GPT-2-small,
# float32, seed 0), 8 slots over 2048 positions
GATEWAY_ARGV = ["--dim", "768", "--depth", "12", "--heads", "12", "--vocab",
                "32768", "--max-seq-len", "2048", "--slots", "8"]
LAUNCH_TIMEOUT = 240     # seconds a launched world may take
GATEWAY_WAIT = 300       # seconds for a request through the gateway
SUSTAIN_RAMP = 0.5       # seconds from the submits to a window's start
SUSTAIN_WINDOW = 1.5     # seconds a window of sustained traffic is counted
# the order of the sustained windows: each path first and last in turn
SUSTAIN_ORDER = ("direct", "gateway", "gateway", "direct")

# the launched worker: the train_lm twin's train(), with the env contract,
# every step's loss, the flash launch counts of the run and the wall clock
# at the end of the first step written to OUT; in generation 0 of MODE
# "restart" it exits 1 right after its first step
LAUNCH_WORKER = """
import importlib, json, os, sys, time
t_start = time.time()
import torch
from tpu_dist_torch.examples import train_lm
from tpu_dist_torch.parallel import DistributedDataParallel as DDP
from tpu_dist_torch.dist import TCPStore
from chip_smoke import _digest
fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
out, mode, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
gen = os.environ["TPU_DIST_RESTART_COUNT"]
rec = {"env": {k: os.environ.get(k) for k in (
    "RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "NODE_RANK",
    "MASTER_ADDR", "MASTER_PORT", "TPU_DIST_RESTART_COUNT",
    "TPU_DIST_STORE_ADDR")}, "pid": os.getpid(), "start_at": t_start}
host, _, port = rec["env"]["TPU_DIST_STORE_ADDR"].rpartition(":")
store = TCPStore(host, int(port), timeout=60)
rec["store_generation"] = store.get("tpu_dist/generation").decode()
rec["store_native"] = store.native
store.close()
step = DDP.train_step

def first_step(self, *a, **k):
    res = step(self, *a, **k)
    if "first_step_at" not in rec:
        torch.cuda.synchronize()
        rec["first_step_at"] = time.time()
        rec["backend"] = torch.distributed.get_backend()
        rec["device"] = str(self.device)
        if mode == "restart" and gen == "0":
            rec["failed_at"] = time.time()
            with open(os.path.join(out, f"g{gen}.json"), "w") as f:
                json.dump(rec, f)
            os._exit(1)
    return res

DDP.train_step = first_step
for k in (fa.flash_fwd, fa.flash_bwd):   # zeroed just before the path
    k.launches = 0
    for by in ("launches_by_design", "launches_by_mode"):
        if hasattr(k, by):
            getattr(k, by).update(dict.fromkeys(getattr(k, by), 0))
res = train_lm.train(train_lm.parse_args(argv))
rec.update(losses=res["losses"], params_sha256=_digest(res["state"].params),
           launches={k.__name__: k.launches for k in (fa.flash_fwd,
                                                      fa.flash_bwd)},
           by_design={k.__name__: {d: n for d, n in
                                   k.launches_by_design.items() if n}
                      for k in (fa.flash_fwd, fa.flash_bwd)},
           first_step_seconds=res["first_step_seconds"],
           loop_seconds=res["loop_seconds"])
with open(os.path.join(out, f"g{gen}.json"), "w") as f:
    json.dump(rec, f)
"""


# runs ``python -m tpu_dist_torch.launch ARGS`` (runpy, as ``-m`` does) and
# then writes to PROBE whether torch initialized CUDA in the launcher
# process and whether ``libcuda.so`` was mapped after ``import torch`` and
# at the end: the launcher must never touch the card
LAUNCHER_PROBE = """
import json, runpy, sys
probe = sys.argv.pop(1)
import torch
def mapped():
    with open("/proc/self/maps") as f:
        return "libcuda.so" in f.read()
rec = {"libcuda_after_import_torch": mapped()}
sys.argv[0] = "tpu_dist_torch.launch"
try:
    runpy.run_module("tpu_dist_torch.launch", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
rec.update(rc=rc, cuda_initialized=torch.cuda.is_initialized(),
           libcuda_at_exit=mapped())
with open(probe, "w") as f:
    json.dump(rec, f)
sys.exit(rc)
"""


def _repo() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def _launcher(args, out_dir, **popen):
    """``python -m tpu_dist_torch.launch ARGS`` under :data:`LAUNCHER_PROBE`
    (its record lands in ``OUT_DIR/launcher_probe.json``), in a session of
    its own so that every process it starts can be stopped with it, the
    repo on the path."""
    env = dict(os.environ, PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-c", LAUNCHER_PROBE,
         os.path.join(out_dir, "launcher_probe.json"), *args],
        cwd=out_dir, env=env, start_new_session=True, **popen)


def _probe(out_dir) -> dict:
    try:
        with open(os.path.join(out_dir, "launcher_probe.json")) as f:
            return json.load(f)
    except OSError:
        return {}


def _stop(proc, grace: float = 30.0) -> None:
    """SIGINT the launcher (its clean teardown), then SIGKILL its whole
    session after ``grace`` seconds."""
    import signal
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        pass
    proc.wait(timeout=30)


def _run_launched(mode: str, extra: list) -> dict:
    """The train_lm twin through ``python -m tpu_dist_torch.launch
    --standalone --nproc_per_node=1 EXTRA``; returns the worker's records
    by generation, the launcher's exit code, wall time, stderr and probe
    (whether torch initialized CUDA in the launcher's process)."""
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # two processes share the card
    out = tempfile.mkdtemp(prefix="launch_", dir=os.environ.get("TMPDIR"))
    with open(os.path.join(out, "worker.py"), "w") as f:
        f.write(LAUNCH_WORKER)
    t0 = time.time()
    proc = _launcher(["--standalone", "--nproc_per_node=1", *extra,
                      os.path.join(out, "worker.py"), out, mode,
                      *LAUNCH_ARGV], out, stderr=subprocess.PIPE, text=True)
    try:
        _, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
    finally:
        _stop(proc)
    recs = {}
    for name in os.listdir(out):
        if name.startswith("g") and name.endswith(".json"):
            with open(os.path.join(out, name)) as f:
                recs[int(name[1:-5])] = json.load(f)
    probe = _probe(out)
    return {"recs": recs, "rc": proc.returncode, "t0": t0,
            "wall": time.time() - t0, "stderr": err[-3000:], "probe": probe,
            "launcher_touched_card": probe.get("cuda_initialized") is not
            False}


LAUNCH_RESTART_FLAGS = ["--max_restarts=1", "--restart_backoff=0"]


def _digest(params) -> str:
    """sha256 over every parameter's name and bytes, in name order: the
    launched run's final parameters against this process's."""
    import hashlib
    h = hashlib.sha256()
    for name, p in sorted(params.items()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def _contract_ok(env: dict, gen: int) -> bool:
    return (env["RANK"] == "0" and env["LOCAL_RANK"] == "0"
            and env["WORLD_SIZE"] == "1" and env["LOCAL_WORLD_SIZE"] == "1"
            and env["NODE_RANK"] == "0" and env["MASTER_ADDR"] == "127.0.0.1"
            and int(env["MASTER_PORT"]) > 0
            and env["TPU_DIST_RESTART_COUNT"] == str(gen)
            and env["TPU_DIST_STORE_ADDR"].startswith("127.0.0.1:"))


def check_launch(results):
    """The train_lm twin at GPT-2-small width (T = 2048, batch 8, bf16, 3
    steps) started by ``python -m tpu_dist_torch.launch --standalone
    --nproc_per_node=1`` on NCCL: the env contract, K2f/K2b launched in the
    child (12 each a step, all wgmma), the losses bit for bit those of the
    same twin in this process, and the launcher's wall time to the child's
    first step against this process's."""
    from tpu_dist_torch.examples import train_lm

    run = _run_launched("once", [])
    rec = run["recs"].get(0, {})
    ok_rc = run["rc"] == 0 and set(run["recs"]) == {0}
    ok_contract = bool(rec) and _contract_ok(rec["env"], 0) and \
        rec["store_generation"] == "0" and rec["backend"] == "nccl" \
        and rec["device"] == "cuda:0"
    steps = 3
    want = {"flash_fwd": 12 * steps, "flash_bwd": 12 * steps}
    ok_launches = bool(rec) and rec["launches"] == want and all(
        d == {"wgmma": want[k]} for k, d in rec["by_design"].items())
    emit("launch_kernels", kernel_launches=rec.get("launches"),
         by_design=rec.get("by_design"), want=want, ok=ok_launches)
    # the same twin in this process, no launcher, world 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    here = train_lm.train(train_lm.parse_args(LAUNCH_ARGV))
    here_first = time.perf_counter() - t0 - here["loop_seconds"]
    got, ref = rec.get("losses", []), here["losses"]
    digest = _digest(here["state"].params)
    ok_losses = (len(got) == steps and got == ref
                 and all(math.isfinite(v) for v in got)
                 and rec.get("params_sha256") == digest)
    ok_card = not run["launcher_touched_card"]
    emit("launch", argv=["--standalone", "--nproc_per_node=1"],
         env=rec.get("env"), store_native=rec.get("store_native"),
         backend=rec.get("backend"), device=rec.get("device"),
         launcher_rc=run["rc"], ok_contract=ok_contract,
         losses_launched=got, losses_in_process=ref,
         losses_bitwise_equal=got == ref,
         params_sha256_launched=rec.get("params_sha256"),
         params_sha256_in_process=digest,
         launch_to_first_step_s=(rec["first_step_at"] - run["t0"]
                                 if rec else None),
         child_start_to_first_step_s=(rec["first_step_at"] - rec["start_at"]
                                      if rec else None),
         in_process_to_first_step_s=here_first,
         first_step_s_launched=rec.get("first_step_seconds"),
         first_step_s_in_process=here["first_step_seconds"],
         loop_s_launched=rec.get("loop_seconds"),
         loop_s_in_process=here["loop_seconds"],
         launcher_wall_s=run["wall"], launcher_probe=run["probe"],
         stderr_tail=None if ok_rc else run["stderr"])
    return ok_rc and ok_contract and ok_launches and ok_losses and ok_card


def check_launch_restart(results):
    """The same launch with ``--max_restarts=1 --restart_backoff=0``: the
    worker exits 1 after generation 0's first step; generation 1 sees
    ``TPU_DIST_RESTART_COUNT=1`` and the store's ``tpu_dist/generation`` =
    1 and finishes; the launcher exits 0.  The seconds from the failure to
    generation 1's first step."""
    run = _run_launched("restart", LAUNCH_RESTART_FLAGS)
    g0, g1 = run["recs"].get(0, {}), run["recs"].get(1, {})
    ok = (run["rc"] == 0 and set(run["recs"]) == {0, 1}
          and _contract_ok(g0["env"], 0) and _contract_ok(g1["env"], 1)
          and g0["store_generation"] == "0"
          and g1["store_generation"] == "1"
          and len(g1["losses"]) == 3
          and all(math.isfinite(v) for v in g1["losses"])
          and g1["launches"] == {"flash_fwd": 36, "flash_bwd": 36}
          and not run["launcher_touched_card"])
    emit("launch_restart", launcher_rc=run["rc"],
         generations=sorted(run["recs"]),
         store_generation={g: r["store_generation"]
                           for g, r in run["recs"].items()},
         restart_count_env={g: r["env"]["TPU_DIST_RESTART_COUNT"]
                            for g, r in run["recs"].items()},
         losses_g1=g1.get("losses"), kernel_launches_g1=g1.get("launches"),
         failure_to_first_step_s=(g1["first_step_at"] - g0["failed_at"]
                                  if g0 and g1 else None),
         failure_to_child_start_s=(g1["start_at"] - g0["failed_at"]
                                   if g0 and g1 else None),
         launcher_wall_s=run["wall"], launcher_probe=run["probe"],
         ok=ok, stderr_tail=run["stderr"])
    return ok


def _gateway_requests() -> list:
    """The first 8 greedy requests of :func:`smoke_requests`."""
    return [r for r in smoke_requests() if not r["temperature"]][:8]


def _stream_requests(n: int = 320) -> list:
    """``n`` greedy requests drawn as :func:`smoke_requests` draws its
    (prompt lengths uniform in 16-1536, new-token counts in 32-128: its
    own draws, not those of :func:`smoke_requests`) from
    ``np.random.default_rng(1)``: the traffic of a sustained window."""
    import numpy as np

    rng = np.random.default_rng(1)
    return [{"prompt": rng.integers(0, 32768, int(p)).astype(np.int32),
             "max_new_tokens": int(g)}
            for p, g in zip(rng.integers(16, 1536 + 1, n),
                            rng.integers(32, 128 + 1, n))]


def _sustained(port: int, reqs, ramp: float = SUSTAIN_RAMP,
               window: float = SUSTAIN_WINDOW) -> dict:
    """Every request of ``reqs`` submitted at once through a new serve
    connection to ``port`` — more than the window can serve, so the queue
    keeps every slot busy — then the tokens streamed to the client counted
    over ``window`` seconds that start ``ramp`` seconds later; then the
    rest cancelled, and every handle's end awaited.  ``queued`` is the
    number of requests not yet ended at each end of the window: more than
    the slots means the slots were full throughout."""
    from tpu_dist_torch import serve
    cli = serve.ServeClient("127.0.0.1", port, connect_retry=60, timeout=60)
    try:
        hs = [cli.submit(r["prompt"].tolist(),
                         max_new_tokens=r["max_new_tokens"]) for r in reqs]
        time.sleep(ramp)
        t1, n1 = time.perf_counter(), sum(len(h.tokens()) for h in hs)
        q1 = sum(not h.done for h in hs)
        time.sleep(window)
        t2, n2 = time.perf_counter(), sum(len(h.tokens()) for h in hs)
        q2 = sum(not h.done for h in hs)
        served = sum(h.done for h in hs)
        for h in hs:
            h.cancel()
        for h in hs:
            try:
                h.wait_done(GATEWAY_WAIT)
            except serve.RequestFailedError:
                pass
    finally:
        cli.close()
    return {"tokens_per_s": (n2 - n1) / (t2 - t1), "tokens": n2 - n1,
            "seconds": t2 - t1, "queued": [q1, q2], "served": served}


def _through(port: int, reqs, timeout=GATEWAY_WAIT, cli=None):
    """``reqs`` submitted at once through a serve connection to ``port``
    (``cli``, else a new one): the tokens and the wall time."""
    from tpu_dist_torch import serve
    own = cli is None
    if own:
        cli = serve.ServeClient("127.0.0.1", port, connect_retry=60,
                                timeout=60)
    try:
        t0 = time.perf_counter()
        hs = [cli.submit(r["prompt"].tolist(),
                         max_new_tokens=r["max_new_tokens"]) for r in reqs]
        got = [h.wait_done(timeout) for h in hs]
        return got, time.perf_counter() - t0
    finally:
        if own:
            cli.close()


def check_gateway(results):
    """``--max_restarts=1 --serve`` on the serve_lm twin at GPT-2-small
    width (float32, 8 slots, max_len 2048, seed 0): 8 greedy requests
    through the gateway against the in-process ``generate()`` on the same
    weights (the serve phase's tie rule) and against the same requests sent
    straight to the worker's Frontend (exact); tokens/s of sustained traffic
    (:func:`_sustained`, windows of each path in :data:`SUSTAIN_ORDER`, the
    8 slots full throughout); then a SIGKILL of the model rank with 8
    requests in flight — each must end done or with
    BackendGoneError/BackendUnavailableError within a bounded wait — and,
    after the relaunch, the same connection's tokens."""
    import signal
    import socket
    import tempfile

    from tpu_dist_torch import serve

    model = _serve_model()
    reqs = _gateway_requests()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="gateway_", dir=os.environ.get("TMPDIR"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pid_file = os.path.join(out, "worker.pid")
    log = open(os.path.join(out, "launcher.log"), "w")
    proc = _launcher(["--standalone", "--max_restarts=1",
                      "--restart_backoff=0", "--serve",
                      f"--serve_port={port}", "-m",
                      "tpu_dist_torch.examples.serve_lm", *GATEWAY_ARGV,
                      "--pid-file", pid_file, "--run-seconds", "900"],
                     out, stdout=log, stderr=subprocess.STDOUT)
    cli = None
    try:
        t0 = time.perf_counter()
        cli = serve.ServeClient("127.0.0.1", port, connect_retry=120,
                                timeout=60)
        warm = cli.submit(reqs[0]["prompt"][:16].tolist(),
                          max_new_tokens=4).wait_done(GATEWAY_WAIT)
        ready_s = time.perf_counter() - t0
        # straight to the worker's frontend, the address the gateway
        # resolved from the store's registry, and through the gateway
        gw_stats = cli.stats(timeout=60)
        backend = gw_stats["gateway"]["default"]["addr"]
        fe_port = int(backend.rpartition(":")[2])
        fe_got, _ = _through(fe_port, reqs)
        gw_got, _ = _through(port, reqs, cli=cli)
        ok_same = gw_got == fe_got
        # tokens/s of sustained traffic, each path's windows in turns
        stream = _stream_requests()
        windows = [dict(path=path, **_sustained(
            fe_port if path == "direct" else port, stream))
            for path in SUSTAIN_ORDER]
        ok_full = all(min(w["queued"]) > 8 for w in windows)
        want = [_generate(model, r, torch.float32) for r in reqs]
        vs_gen = _tie_rule(model, reqs, gw_got, want, torch.float32,
                           "gateway_generate")
        ok_ties = all(ok for _, ok, _ in vs_gen)
        # SIGKILL the model rank with requests in flight
        with open(pid_file) as f:
            worker_pid = int(f.read())
        long = [dict(r, max_new_tokens=128) for r in reqs]
        hs = [cli.submit(r["prompt"].tolist(), max_new_tokens=128)
              for r in long]
        next(iter(hs[0].iter_tokens(timeout=GATEWAY_WAIT)))
        t_kill = time.perf_counter()
        os.kill(worker_pid, signal.SIGKILL)
        outcomes = []
        for h in hs:
            try:
                h.wait_done(120.0)
                outcomes.append("done")
            except serve.RequestFailedError as e:
                outcomes.append(e.error)
        ended_s = time.perf_counter() - t_kill
        ok_named = all(o in ("done", "BackendGoneError",
                             "BackendUnavailableError") for o in outcomes) \
            and "done" != outcomes[0]
        # the relaunched rank, on the same connection
        after = None
        deadline = time.perf_counter() + GATEWAY_WAIT
        while time.perf_counter() < deadline:
            try:
                after, _ = _through(port, reqs[:2], cli=cli)
                break
            except serve.RequestFailedError:
                time.sleep(0.5)
        back_s = time.perf_counter() - t_kill
        with open(pid_file) as f:
            new_pid = int(f.read())
        ok_back = after == gw_got[:2] and new_pid != worker_pid
    finally:
        if cli is not None:
            cli.close()
        _stop(proc)
        log.close()
    with open(os.path.join(out, "launcher.log")) as f:
        log_tail = f.read()[-2000:]
    probe = _probe(out)
    ok_card = probe.get("cuda_initialized") is False
    rate = {p: [w["tokens_per_s"] for w in windows if w["path"] == p]
            for p in ("direct", "gateway")}
    emit("gateway", requests=len(reqs),
         prompt_lens=[len(r["prompt"]) for r in reqs],
         max_new_tokens=[r["max_new_tokens"] for r in reqs],
         ready_s=ready_s, warm_tokens=len(warm),
         sustained=dict(requests=len(stream), ramp_s=SUSTAIN_RAMP,
                        window_s=SUSTAIN_WINDOW, windows=windows,
                        direct_tokens_per_s=rate["direct"],
                        gateway_tokens_per_s=rate["gateway"],
                        gateway_over_direct=(
                            statistics.mean(rate["gateway"])
                            / statistics.mean(rate["direct"])),
                        gateway_over_direct_by_pair=[
                            g / d for d, g in zip(rate["direct"],
                                                  rate["gateway"])],
                        ok_slots_full=ok_full),
         ok_gateway_equals_direct=ok_same,
         divergent_vs_generate=[i for i, _, d in vs_gen if d],
         ok_tie_rule=ok_ties, kill_outcomes=outcomes,
         kill_to_all_ended_s=ended_s, ok_named=ok_named,
         kill_to_served_again_s=back_s, ok_same_tokens_after=ok_back,
         gateway_stats=gw_stats["gateway"], launcher_rc=proc.returncode,
         launcher_probe=probe,
         launcher_log_tail=None if ok_back and ok_card else log_tail)

    return (ok_same and ok_full and ok_ties and ok_named and ok_back
            and ok_card)


# a store server in a process of its own, as the launcher hosts one for its
# workers: prints its port and whether it is the native server, then serves
# until its standard input closes
STORE_SERVER = """
import sys
from tpu_dist_torch.dist import TCPStore
server = TCPStore(is_master=True, timeout=30)
print(server.port, int(server.native), flush=True)
sys.stdin.read()
server.close()
"""
# one rank of a world at a rendezvous, standard library only so that many
# start at once: a connection of its own to the store on port ARGV[1];
# after "go" on its standard input, ARGV[3] rounds of set and get of its own
# key and an add to the world's counter, each a request of the store's wire
# in one send
STORE_RANK = """
import socket, struct, sys
port, name, n = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
s = socket.create_connection(("127.0.0.1", port))
s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
def recv(n):
    buf = b""
    while len(buf) < n:
        got = s.recv(n - len(buf))
        if not got:
            raise ConnectionError("store closed the connection")
        buf += got
    return buf
def request(op, key, payload=b""):
    key = key.encode()
    s.sendall(struct.pack("<BI", op, len(key)) + key
              + struct.pack("<I", len(payload)) + payload)
    status, size = struct.unpack("<II", recv(8))
    data = recv(size)
    if status:
        raise RuntimeError(f"store op {op} failed: {status}")
    return data
world = name.split("/")[0]
print("ready", flush=True)
sys.stdin.readline()
for _ in range(n):
    request(1, f"rank/{name}", b"x" * 64)   # SET
    request(2, f"rank/{name}")               # GET
    request(3, f"arrived/{world}", struct.pack("<q", 1))   # ADD
print("done", flush=True)
"""
STORE_OPS = 400          # round trips of each op through one client
STORE_CLIENTS = (8, 64)  # concurrent ranks, one process and connection each
STORE_CLIENT_OPS = 100   # rounds of set, get and add of each rank


def _store_server(python: bool):
    """A :data:`STORE_SERVER` process (the Python server when ``python``),
    its port and whether it is native."""
    env = dict(os.environ, PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("TPU_DIST_PURE_PYTHON_STORE", None)
    if python:
        env["TPU_DIST_PURE_PYTHON_STORE"] = "1"
    proc = subprocess.Popen([sys.executable, "-c", STORE_SERVER],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            env=env, cwd=_repo(), text=True)
    try:
        port, native = proc.stdout.readline().split()
    except ValueError:
        proc.kill()
        proc.wait()
        raise RuntimeError("the store server process did not start")
    return proc, int(port), native == "1"


def check_store(results):
    """The control-plane store with its server in a process of its own, as
    the launcher hosts it: set/get/add round trips through one client,
    microseconds an op (native client and server; Python client and
    server; the native client to the Python server), and the ops a second
    the native server and the Python one serve to ``k`` concurrent ranks
    in :data:`STORE_CLIENTS` (:data:`STORE_RANK`: a process each, as the
    ranks of a large world at a rendezvous, all with the same client).
    The store on the card's machine must be the native one."""
    from tpu_dist_torch.dist import store as tstore

    def per_op(s, n=STORE_OPS):
        row = {}
        for op, fn in (("set", lambda i: s.set(f"k{i % 64}", b"x" * 64)),
                       ("get", lambda i: s.get(f"k{i % 64}")),
                       ("add", lambda i: s.add("ctr", 1))):
            fn(0)
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            row[f"{op}_us"] = (time.perf_counter() - t0) / n * 1e6
        return row

    def concurrent(port, k, n=STORE_CLIENT_OPS):
        ranks = [subprocess.Popen(
            [sys.executable, "-c", STORE_RANK, str(port), f"{k}/{i}",
             str(n)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True) for i in range(k)]
        try:
            for r in ranks:   # each has connected
                assert r.stdout.readline().strip() == "ready"
            t0 = time.perf_counter()
            for r in ranks:
                r.stdin.write("go\n")
                r.stdin.flush()
            done = [r.stdout.readline().strip() for r in ranks]
            wall = time.perf_counter() - t0
        finally:
            for r in ranks:
                if r.poll() is None:
                    r.kill()
                r.wait()
        check = tstore.TCPStore("127.0.0.1", port, timeout=30)
        total = check.add(f"arrived/{k}", 0)
        check.close()
        ops = 3 * n * k
        return {"clients": k, "ops": ops, "seconds": wall,
                "ops_per_s": ops / wall,
                "ok": done == ["done"] * k and total == n * k}

    saved = os.environ.pop("TPU_DIST_PURE_PYTHON_STORE", None)
    tstore._load_native.reset()
    servers = {}
    rows, natives, conc = {}, {}, {}
    try:
        # both servers start at once (a process each; their start is not
        # timed)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=2) as pool:
            started = {name: pool.submit(_store_server,
                                         python=name == "python")
                       for name in ("native", "python")}
            for name, f in started.items():
                try:
                    servers[name] = f.result()
                except RuntimeError:
                    pass
        if len(servers) < 2:
            raise RuntimeError("a store server process did not start")
        for name, server, client_py in (
                ("native", "native", False), ("python", "python", True),
                ("native_client_python_server", "python", False)):
            proc, port, server_native = servers[server]
            os.environ.pop("TPU_DIST_PURE_PYTHON_STORE", None)
            if client_py:
                os.environ["TPU_DIST_PURE_PYTHON_STORE"] = "1"
            tstore._load_native.reset()
            client = tstore.TCPStore("127.0.0.1", port, timeout=30)
            try:
                natives[name] = (server_native, client.native)
                rows[name] = per_op(client)
            finally:
                client.close()
        os.environ.pop("TPU_DIST_PURE_PYTHON_STORE", None)
        tstore._load_native.reset()
        for name in ("native", "python"):
            proc, port, _ = servers[name]
            conc[name] = [concurrent(port, k) for k in STORE_CLIENTS]
    finally:
        for proc, _, _ in servers.values():
            proc.stdin.close()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        os.environ.pop("TPU_DIST_PURE_PYTHON_STORE", None)
        if saved is not None:
            os.environ["TPU_DIST_PURE_PYTHON_STORE"] = saved
        tstore._load_native.reset()
    ok = (natives == {"native": (True, True), "python": (False, False),
                      "native_client_python_server": (False, True)}
          and all(r["ok"] for rs in conc.values() for r in rs))
    emit("store", ops=STORE_OPS, value_bytes=64, rows=rows,
         server_client_native=natives, concurrent=conc,
         native_over_python_ops_per_s=[
             n["ops_per_s"] / p["ops_per_s"]
             for n, p in zip(conc["native"], conc["python"])], ok=ok)
    return ok


# ---------------------------------------------------------------------------
# slice 11: the capacity dispatches, RMSNorm with rope, remat
# ---------------------------------------------------------------------------

def path_launches(steps: int, per_step: dict):
    """Every kernel's launch count since the counts were zeroed, against
    ``steps`` times ``per_step``; every flash launch must be the wgmma
    design: ``(counts, by_design, ok)``."""
    from tpu_dist_torch.ops import KERNELS

    counts = {k.__name__: k.launches for k in KERNELS}
    by_design = {k.__name__: dict(k.launches_by_design)
                 for k in KERNELS if hasattr(k, "launches_by_design")}
    ok = (all(counts[n] == steps * c for n, c in per_step.items())
          and all(by_design[n]["wgmma"] == counts[n]
                  for n in ("flash_fwd", "flash_bwd")))
    return counts, by_design, ok


def largest_batch(fn, batches=(8, 4, 2)):
    """``fn(batch)`` at the first of ``batches`` that fits on the card:
    ``(batch, result, batches that did not fit)``."""
    import gc

    skipped = []
    for b in batches:
        try:
            return b, fn(b), skipped
        except torch.cuda.OutOfMemoryError:
            skipped.append(b)
        # outside the handler: the failed call's frames are gone
        gc.collect()
        torch.cuda.empty_cache()
    raise RuntimeError(f"no batch of {batches} fits on the card")


MOE_DISPATCH_RUN = {"gather": (3, 20), "einsum": (1, 1)}  # warm-up, timed
MOE_DISPATCH_TOL = {
    "plain_composition": MOE_STEP_TOL["plain_composition"],
    "einsum_vs_gather": MOE_STEP_TOL["plain_products"],
    "why": "as MOE_STEP_TOL: bf16 on both paths, so a token near a routing "
           "tie can take another expert, and under a capacity another "
           "token's arrival rank moves with it.  einsum against gather: the "
           "same routing, the combine rounded once (fp32 sums of the (N, E, "
           "C) product) or per term (bf16 products summed in bf16), a bf16 "
           "step here and there, as the plain grouped products differ from "
           "the kernels'; the fused loss on both sides"}


def _moe_capacity_step(dispatch: str, batch: int, other=None) -> tuple:
    """One step of the capacity-dispatch MoE slice on the card (fused loss,
    flash attention) against the plain composition (dense attention,
    unfused loss) from the same seed and batch, and, given ``other`` (the
    gather step's update at this batch), against it.  Returns ``(fields,
    ok, update)``."""
    from tpu_dist_torch import nn, optim
    from tpu_dist_torch.benchmarks.moe_lm import build
    from tpu_dist_torch.parallel import DistributedDataParallel

    ddp, x, y = build(batch=batch, device="cuda", dispatch=dispatch)
    moe = [(p, m) for p, m in ddp.module.named_modules()
           if isinstance(m, nn.MoELayer)]
    state = ddp.init(seed=0)
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    state, m_k = ddp.train_step(state, x, y)
    upd_k = {k: state.params[k].detach() - p0[k] for k in p0}
    del state
    route_k = {p: m.routing["gate_idx"].clone() for p, m in moe}
    aux_k = {p: float(m.aux_loss.detach()) for p, m in moe}
    dropped_k = {p: int(m.routing["dropped"]) for p, m in moe}
    loss_k = float(m_k["loss"])
    plain = DistributedDataParallel(
        ddp.module, optimizer=optim.SGD(lr=0.01),
        loss_fn=nn.CrossEntropyLoss(fused=False),
        compute_dtype=torch.bfloat16)
    state_p = plain.init(seed=0)
    same_init = all(torch.equal(state_p.params[k], p0[k]) for k in p0)
    with nn.attention_impl("dense"):
        state_p, m_p = plain.train_step(state_p, x, y)
    moved = {p: int((m.routing["gate_idx"] != route_k[p]).any(-1).sum())
             for p, m in moe}
    share = sum(moved.values()) / (x.numel() * len(moe))
    rel, leaf, group_worst = _update_diff(p0, upd_k, state_p.params)
    worst = max(leaf, key=leaf.get)
    loss_p = float(m_p["loss"])
    aux_err = max(abs(aux_k[p] - float(m.aux_loss.detach()))
                  / abs(float(m.aux_loss.detach())) for p, m in moe)
    tol = MOE_DISPATCH_TOL["plain_composition"]
    ok = (same_init and abs(loss_k - loss_p) <= tol["loss_rtol"] * abs(loss_p)
          and rel <= tol["update_rel"] and leaf[worst] <= tol["leaf_update_rel"]
          and aux_err <= tol["aux_rtol"] and share <= tol["moved_share"])
    fields = {"batch": batch, "loss_kernel_path": loss_k,
              "loss_plain_path": loss_p, "update_rel_err": rel,
              "worst_leaf": [worst, leaf[worst]],
              "worst_leaf_by_group": group_worst, "aux_rel_err": aux_err,
              "dropped_kernel_path": dropped_k,
              "dropped_plain_path": {p: int(m.routing["dropped"])
                                     for p, m in moe},
              "tokens_with_other_experts": moved, "moved_share": share,
              "same_init": same_init, "ok_plain_composition": ok}
    if other is not None:
        num = sum(float((upd_k[k] - other[k]).pow(2).sum()) for k in upd_k)
        den = sum(float(other[k].pow(2).sum()) for k in upd_k)
        vs = {k: math.sqrt(float((upd_k[k] - other[k]).pow(2).sum())
                           / max(float(other[k].pow(2).sum()), 1e-30))
              for k in upd_k}
        wv = max(vs, key=vs.get)
        tol_g = MOE_DISPATCH_TOL["einsum_vs_gather"]
        ok_g = (math.sqrt(num / den) <= tol_g["update_rel"]
                and vs[wv] <= tol_g["leaf_update_rel"])
        fields.update(vs_gather_update_rel_err=math.sqrt(num / den),
                      vs_gather_worst_leaf=[wv, vs[wv]],
                      ok_vs_gather=ok_g)
        ok = ok and ok_g
    return fields, ok, upd_k


MOE_CPU_TOL = {
    "rtol": 1e-4, "atol_row": 1e-4,
    "why": "float32 on both sides with TF32 off and the same routing: "
           "cuBLAS and the CPU's BLAS sum the products in other orders, "
           "through the GELU and the second product: 1e-4 of each element "
           "plus 1e-4 of its row's rms, where an H100 measured margins of "
           "0.03-0.27 (dx the largest) for both dispatches; two experts' "
           "w1 swapped must be rejected"}


def _capacity_layer_vs_cpu(dispatch: str) -> tuple:
    """One full-width capacity-dispatch MoE layer (768 wide, 8 experts,
    hidden 3072, top-2, capacity factor 1.0, 2048 tokens, float32) forward
    and backward on the card against the same layer on a CPU copy — the
    CPU being what the tests hold to the JAX package — with a router
    scaled so that choices drop.  Returns ``(fields, ok)``."""
    from tpu_dist_torch.nn import MoELayer

    g = torch.Generator().manual_seed(21)
    cpu = MoELayer(768, 8, hidden=3072, capacity_factor=1.0,
                   dispatch=dispatch, device="cpu")
    cpu.reset_parameters(g)
    with torch.no_grad():
        cpu.router.mul_(4.0)
        cpu.b1.normal_(0.0, 0.1, generator=g)
        cpu.b2.normal_(0.0, 0.1, generator=g)
    card = MoELayer(768, 8, hidden=3072, capacity_factor=1.0,
                    dispatch=dispatch, device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(1, 2048, 768, generator=g)
    cot = torch.randn(1, 2048, 768, generator=g)
    leaves = ["router", "w1", "b1", "w2", "b2"]

    def run_once(layer):
        dev = layer.w1.device
        xr = x.to(dev).requires_grad_(True)
        y = layer(xr)
        out = (y * cot.to(dev)).sum() + layer.aux_loss
        grads = torch.autograd.grad(
            out, [xr] + [getattr(layer, k) for k in leaves])
        return ({"y": y.detach(), **dict(zip(["x"] + leaves, grads))},
                dict(layer.routing))

    with tf32(False):
        got, r_card = run_once(card)
        want, r_cpu = run_once(cpu)
        with torch.no_grad():
            card.w1[[0, 1]] = card.w1[[1, 0]]
        bad = run_once(card)[0]["y"]
    same_route = (torch.equal(r_card["gate_idx"].cpu(), r_cpu["gate_idx"])
                  and int(r_card["dropped"]) == int(r_cpu["dropped"]))
    lims = (MOE_CPU_TOL["rtol"], 0.0, MOE_CPU_TOL["atol_row"])
    errs, margins, ok = {}, {}, same_route
    for k in want:
        errs[k], _, margins[k], ok_t = compare(got[k].cpu(), want[k], *lims)
        ok = ok and ok_t
    caught = compare(bad.cpu(), want["y"], *lims)[2]
    ok = ok and caught > 1.0 and int(r_cpu["dropped"]) > 0
    return {"tokens": 2048, "same_routing": same_route,
            "dropped": int(r_cpu["dropped"]), "capacity": r_cpu["capacity"],
            "max_abs_err": errs, "margin": margins,
            "planted_w1_swap_margin": caught, "tolerance": MOE_CPU_TOL,
            "ok": ok}, ok


def check_moe_dispatch(results):
    """The JAX ``moe_lm`` configuration at full width with each capacity
    dispatch: gather at batch 8, einsum at the largest of 8, 4, 2 that fits;
    step ms, tokens/s, peak memory, dropped choices a layer and exact
    launches (K1 1, K2 12 a step, all wgmma, K3/K4 none); one step against
    the plain composition, and einsum's against gather's at one batch; one
    float32 layer against a CPU copy."""
    from tpu_dist_torch.benchmarks.moe_lm import run

    ok_all, gather_update = True, None
    for dispatch in ("gather", "einsum"):
        warm, steps = MOE_DISPATCH_RUN[dispatch]

        def train(batch):
            zero_launch_counts()
            return run(batch=batch, dispatch=dispatch, steps=steps,
                       warmup=warm)

        batch, res, too_big = largest_batch(
            train, (8,) if dispatch == "gather" else (8, 4, 2))
        depth = res["model"]["depth"]
        counts, by_design, ok_counts = path_launches(
            res["steps_run"], {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
                               "flash_fwd": depth, "flash_bwd": depth,
                               "gmm": 0, "tgmm": 0})
        ok_loss = all(math.isfinite(v) for v in res["losses"])
        choices = 2 * batch * res["model"]["seq_len"]
        dropped = res["dropped_choices_last_step"]
        step_batches = tuple(x for x in (8, 4, 2) if x <= batch)
        other = gather_update if dispatch == "einsum" else None
        cbatch, (fields, ok_cmp, upd), cmp_too_big = largest_batch(
            lambda b: _moe_capacity_step(dispatch, b,
                                         other if b == 8 else None),
            step_batches)
        if dispatch == "gather":
            gather_update = upd
        del upd
        layer, ok_layer = _capacity_layer_vs_cpu(dispatch)
        ok = ok_counts and ok_loss and ok_cmp and ok_layer
        ok_all = ok_all and ok
        emit("moe_dispatch", dispatch=dispatch, batch=batch,
             batches_that_did_not_fit=too_big,
             tokens_per_s_per_gpu=res["value"], step_ms=res["step_ms"],
             peak_mem_bytes=res["peak_mem_bytes"], steps_run=res["steps_run"],
             timed_steps=steps, launches=counts, launches_by_design=by_design,
             ok_launches=ok_counts, losses=res["losses"],
             ok_losses_finite=ok_loss,
             aux_losses_last_step=res["aux_losses_last_step"],
             dropped_choices_per_layer=dropped,
             dropped_share_per_layer=[d / choices for d in dropped],
             choices_per_layer=choices,
             tokens_per_expert_last_step=res["tokens_per_expert_last_step"],
             step_check=fields, step_check_batches_that_did_not_fit=cmp_too_big,
             tolerance=MOE_DISPATCH_TOL, layer_vs_cpu=layer, ok=ok)
    del gather_update
    return ok_all


def rope_qkv(b: int, t: int, h: int, d: int, g):
    """q, k and v as the rope layer hands them to K2f, bf16: q and k views
    of one rotated (B, T, 2, H, D) buffer, v a view of the fused
    projection."""
    from tpu_dist_torch.nn import rotary_embed

    qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=g).to(
        torch.bfloat16)
    qk = rotary_embed(qkv[:, :, :2].reshape(b, t, 2 * h, d),
                      torch.arange(t, device="cuda"))
    q, k = qk.reshape(b, t, 2, h, d).unbind(2)
    return q, k, qkv[:, :, 2]


def flash_bounds(b, t, h, d, el=2):
    """K2f's and K2b's bounds at causal (b, t, h, d), as in check_flash."""
    pairs = b * h * causal_pairs(t, t, True)
    tile = b * t * h * d * el
    return (bound(4 * tile + b * h * t * 4, 4 * d * pairs, "bf16_tensor"),
            bound(7 * tile + 2 * b * h * t * 4, 10 * d * pairs,
                  "bf16_tensor"))


def check_llama(results):
    """The dense GPT-2-small slice with ``norm="rmsnorm", rope=True``: its
    launches (K1 1, K2 12 a step, all wgmma), tokens/s beside the layernorm
    model's in the same call, one step against the plain composition, and
    K2f/K2b held to their plain versions on the rope layer's q/k (views of
    one rotated buffer) beside the projection's v, timed beside the
    unrotated views."""
    import torch.nn.functional as F

    from tpu_dist_torch.benchmarks.transformer_lm import run

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    rows = {}
    for name, kw in (("llama", dict(norm="rmsnorm", rope=True)),
                     ("layernorm", {})):
        zero_launch_counts()
        res = run(**kw)
        depth = res["model"]["depth"]
        counts, by_design, ok_counts = path_launches(
            res["steps_run"], {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
                               "flash_fwd": depth, "flash_bwd": depth,
                               "gmm": 0, "tgmm": 0})
        rows[name] = (res, counts, by_design, ok_counts)
    res, counts, by_design, ok_counts = rows["llama"]
    ok_loss = all(math.isfinite(v) for v in res["losses"])
    fields, ok_cmp = step_vs_plain(norm="rmsnorm", rope=True)
    # K2 on the rope layer's inputs
    g = torch.Generator(device="cuda").manual_seed(11)
    b, t, h, d = 8, 2048, 12, 64
    q, k, v = rope_qkv(b, t, h, d, g)
    do = torch.randn(b, t, h, d, device="cuda", generator=g).to(q.dtype)
    scale = 1.0 / math.sqrt(d)
    design = fa.flash_design(q.dtype, t, t, d, [x.stride() for x in (q, k, v)])
    zero_launch_counts()
    o_k, lse_k = fa.flash_fwd(q, k, v, True, scale)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    grads_k = fa.flash_bwd(q, k, v, do, lse_p, delta, True, scale)
    grads_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, True, scale)
    ran = {f.__name__: dict(f.launches_by_design)
           for f in (fa.flash_fwd, fa.flash_bwd)}
    tol = FLASH_BF16_TOL
    lims = (tol["rtol"], tol["atol"], tol["atol_row"], tol["atol_all"])
    errs, margins, ok_hold = {}, {}, True
    for name, (got, want) in {"o": (o_k, o_p), "dq": (grads_k[0], grads_p[0]),
                              "dk": (grads_k[1], grads_p[1]),
                              "dv": (grads_k[2], grads_p[2])}.items():
        errs[name], _, margins[name], ok_t = compare(got, want, *lims)
        ok_hold = ok_hold and ok_t
    ok_hold = (ok_hold and design == "wgmma"
               and all(r["wgmma"] == 1 for r in ran.values()))
    qs, ks, vs = torch.randn(b, t, 3, h, d, device="cuda",
                             generator=g).to(q.dtype).unbind(2)
    (bf, bb) = flash_bounds(b, t, h, d)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    times = {
        "fwd_rotated_ms": time_ms(lambda: fa.flash_fwd(q, k, v, True, scale)),
        "fwd_strided_ms": time_ms(lambda: fa.flash_fwd(qs, ks, vs, True,
                                                       scale)),
        "bwd_rotated_ms": time_ms(lambda: fa.flash_bwd(
            q, k, v, do, lse_p, delta, True, scale)),
        "bwd_strided_ms": time_ms(lambda: fa.flash_bwd(
            qs, ks, vs, do, lse_p, delta, True, scale)),
        "fwd_library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "bwd_library_ms": time_ms(lambda: torch.autograd.grad(
            lib_o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)),
        "fwd_bound_ms": bf[0], "bwd_bound_ms": bb[0]}
    lay = rows["layernorm"][0]
    ok = (ok_counts and rows["layernorm"][3] and ok_loss and ok_cmp
          and ok_hold)
    emit("llama", tokens_per_s_per_gpu=res["value"], step_ms=res["step_ms"],
         peak_mem_bytes=res["peak_mem_bytes"], n_params=res["n_params"],
         layernorm_tokens_per_s_per_gpu=lay["value"],
         layernorm_step_ms=lay["step_ms"],
         over_layernorm=res["value"] / lay["value"], model=res["model"],
         steps_run=res["steps_run"], launches=counts,
         launches_by_design=by_design, ok_launches=ok_counts,
         layernorm_launches=rows["layernorm"][1], losses=res["losses"],
         ok_losses_finite=ok_loss, step_check=fields,
         flash_rotated={"shape": [b, t, h, d], "design": design,
                        "strides": [list(x.stride()) for x in (q, k, v)],
                        "launches_by_design": ran, "max_abs_err": errs,
                        "margin": margins, "tolerance": tol,
                        **times, "ok": ok_hold}, ok=ok)
    return ok


def check_long_32k(results):
    """The ``run_32k`` twin (T = 32768, batch 1, remat, fused loss): 24 K2f
    and 12 K2b a step, the loss finite and falling, tokens/s and peak
    memory beside ``run_long`` (T = 8192, no remat) and T = 32768 without
    remat; then K2f/K2b at (1, 32768, 12, 64) held head by head to their
    plain versions (whose (T, T) float32 scores a head fit where all 12
    would not), and timed against their bound and SDPA."""
    import gc

    import torch.nn.functional as F

    from tpu_dist_torch.benchmarks.transformer_lm import run, run_32k, \
        run_long

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    zero_launch_counts()
    res = run_32k(steps=4, warmup=2)
    depth = res["model"]["depth"]
    counts, by_design, ok_counts = path_launches(
        res["steps_run"], {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
                           "flash_fwd": 2 * depth, "flash_bwd": depth,
                           "gmm": 0, "tgmm": 0})
    losses = res["losses"]
    ok_loss = (all(math.isfinite(v) for v in losses)
               and losses[-1] < losses[0])
    zero_launch_counts()
    long8k = run_long(steps=5, warmup=2)
    _, _, ok_long = path_launches(
        long8k["steps_run"], {"flash_fwd": depth, "flash_bwd": depth})
    try:
        no_remat = run(batch=1, seq_len=32768, remat=False, steps=3, warmup=1)
        no_remat = {k: no_remat[k] for k in ("value", "step_ms",
                                             "peak_mem_bytes")}
    except torch.cuda.OutOfMemoryError:
        no_remat = "does not fit"
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels at T = 32768, head by head
    g = torch.Generator(device="cuda").manual_seed(12)
    b, t, h, d = 1, 32768, 12, 64
    q, k, v = torch.randn(b, t, 3, h, d, device="cuda",
                          generator=g).to(torch.bfloat16).unbind(2)
    do = torch.randn(b, t, h, d, device="cuda", generator=g).to(q.dtype)
    scale = 1.0 / math.sqrt(d)
    zero_launch_counts()
    o_k, lse_k = fa.flash_fwd(q, k, v, True, scale)
    design = {"fwd": dict(fa.flash_fwd.launches_by_design)}
    lse_p = torch.empty_like(lse_k)
    delta = torch.empty_like(lse_k)
    tol = FLASH_BF16_TOL
    lims = (tol["rtol"], tol["atol"], tol["atol_row"], tol["atol_all"])
    errs = {n: 0.0 for n in ("o", "lse", "dq", "dk", "dv")}
    margins = dict.fromkeys(errs, 0.0)
    ok_hold = True

    def hold(name, got, want, *lim):
        nonlocal ok_hold
        e, _, m, ok_t = compare(got, want, *lim)
        errs[name], margins[name] = max(errs[name], e), max(margins[name], m)
        ok_hold = ok_hold and ok_t

    heads = lambda x, i: x[:, :, i:i + 1]  # noqa: E731
    t0 = time.perf_counter()
    for i in range(h):
        o_p, lse_i = fa.flash_fwd_plain(heads(q, i), heads(k, i),
                                        heads(v, i), True, scale)
        hold("o", heads(o_k, i), o_p, *lims)
        hold("lse", lse_k[:, i:i + 1], lse_i, 1e-5, 1e-4)
        lse_p[:, i] = lse_i[:, 0]
        delta[:, i] = (heads(do, i).float() * o_p.float()).sum(-1)[:, :, 0]
        del o_p, lse_i
    grads_k = fa.flash_bwd(q, k, v, do, lse_p, delta, True, scale)
    design["bwd"] = dict(fa.flash_bwd.launches_by_design)
    for i in range(h):
        grads_p = fa.flash_bwd_plain(heads(q, i), heads(k, i), heads(v, i),
                                     heads(do, i), lse_p[:, i:i + 1],
                                     delta[:, i:i + 1], True, scale)
        for name, got, want in zip(("dq", "dk", "dv"), grads_k, grads_p):
            hold(name, heads(got, i), want, *lims)
        del grads_p
    hold_s = time.perf_counter() - t0
    ok_hold = ok_hold and all(dd["wgmma"] == 1 for dd in design.values())
    plain_head_ms = time_ms(lambda: fa.flash_fwd_plain(
        heads(q, 0), heads(k, 0), heads(v, 0), True, scale), reps=3, warm=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    bf, bb = flash_bounds(b, t, h, d)
    times = {
        "fwd_ms": time_ms(lambda: fa.flash_fwd(q, k, v, True, scale),
                          reps=5),
        "bwd_ms": time_ms(lambda: fa.flash_bwd(q, k, v, do, lse_p, delta,
                                               True, scale), reps=5),
        "fwd_library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=5),
        "bwd_library_ms": time_ms(lambda: torch.autograd.grad(
            lib_o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
            reps=5),
        "fwd_plain_one_head_ms": plain_head_ms,
        "fwd_bound_ms": bf[0], "fwd_bound_by": bf[1],
        "bwd_bound_ms": bb[0], "bwd_bound_by": bb[1]}
    ok = ok_counts and ok_loss and ok_long and ok_hold
    emit("long_32k", tokens_per_s_per_gpu=res["value"],
         step_ms=res["step_ms"], peak_mem_bytes=res["peak_mem_bytes"],
         model=res["model"], steps_run=res["steps_run"], launches=counts,
         launches_by_design=by_design, ok_launches=ok_counts, losses=losses,
         ok_loss_finite_and_falling=ok_loss,
         run_long={k: long8k[k] for k in ("value", "step_ms",
                                          "peak_mem_bytes")},
         ok_run_long_launches=ok_long, no_remat_32k=no_remat,
         kernels_32k={"shape": [b, t, h, d], "launches_by_design": design,
                      "max_abs_err": errs, "margin": margins,
                      "tolerance": tol, "held_head_by_head_s": hold_s,
                      **times, "ok": ok_hold}, ok=ok)
    return ok


def check_serve_rope(results):
    """The slot engine (8 slots, 2048 positions) on a full-width float32
    ``norm="rmsnorm", rope=True`` model: six greedy and two sampled
    ``smoke_requests`` admitted between decode steps, each slot rotating at
    its own position; every request against ``generate()`` alone under the
    tie rule; no kernel launch."""
    from tpu_dist_torch import serve
    from tpu_dist_torch.benchmarks.serve_lm import CONFIG, build

    model = build({**CONFIG, "norm": "rmsnorm", "rope": True},
                  device="cuda")
    reqs = smoke_requests()
    reqs = reqs[:6] + reqs[12:14]
    engine = serve.SlotEngine(model, num_slots=8, max_len=2048,
                              device=model.device)
    outs = {}
    pending = [serve.Request(r["prompt"], r["max_new_tokens"],
                             temperature=r["temperature"], seed=r["seed"],
                             on_token=lambda q, tok: outs.setdefault(
                                 q.id, []).append(tok)) for r in reqs]
    order = [r.id for r in pending]
    zero_launch_counts()
    t0 = time.perf_counter()
    while pending or not engine.idle():
        if pending and engine.free_slots():
            engine.admit(pending.pop(0))
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from tpu_dist_torch.ops import KERNELS
    launches = {k.__name__: k.launches for k in KERNELS}
    got = [outs.get(i, []) for i in order]
    want = [_generate(model, r, torch.float32) for r in reqs]
    vs_gen = _tie_rule(model, reqs, got, want, torch.float32,
                       "generate_rope")
    ok_ties = all(ok for _, ok, _ in vs_gen)
    ok_launches = not any(launches.values())
    ok = ok_ties and ok_launches
    emit("serve_rope", requests=len(reqs),
         prompt_lens=[len(r["prompt"]) for r in reqs],
         max_new_tokens=[r["max_new_tokens"] for r in reqs],
         sampled=[bool(r["temperature"]) for r in reqs],
         generated_tokens=sum(map(len, got)), wall_s=wall,
         tokens_per_s=sum(map(len, got)) / wall,
         divergent_vs_generate=[i for i, _, dv in vs_gen if dv],
         ok_tie_rule=ok_ties, kernel_launches=launches,
         ok_launches_zero=ok_launches, ok=ok)
    return ok


# ---------------------------------------------------------------------------
# ZeRO and elastic training (slice 12)
# ---------------------------------------------------------------------------

ZERO_STEPS = (3, 5)      # zero_ddp.run_mode's kept steps, then timed ones
ADAMW_BYTES_BOUND_MS = 28 * 136_993_280 / PEAK_BYTES_S * 1e3


def _zero_mode(pg, **ddp_kw) -> dict:
    """The dense cell (AdamW, batch 8) under the DDP with ``ddp_kw``
    (``benchmarks/zero_ddp.py``'s ``run_mode``: 3 steps kept, 5 timed),
    with every kernel's launches over the 8 steps."""
    from tpu_dist_torch.benchmarks.zero_ddp import run_mode

    zero_launch_counts()
    out = run_mode(pg, 8, **ddp_kw)
    counts, by_design, ok = path_launches(sum(ZERO_STEPS), {
        "cross_entropy_fwd": 1, "cross_entropy_bwd": 1, "flash_fwd": 12,
        "flash_bwd": 12})
    out.update(launches=counts, launches_by_design=by_design,
               ok_launches=ok)
    return out


def _flat_adamw_ms(n: int = 136_993_280) -> dict:
    """AdamW's update on one flat float32 vector of the dense cell's size
    (ZeRO-1's update at world 1) beside the per-leaf multi-tensor update
    over the cell's 150 tensors, in turns, CUDA events."""
    from tpu_dist_torch import optim
    shapes = dense_shapes()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name in ("flat", "per_leaf", "per_leaf", "flat"):
        if name == "flat":
            params = {"flat": torch.randn(n, device="cuda", generator=g)}
        else:
            params = {k: torch.randn(s, device="cuda", generator=g)
                      for k, s in shapes.items()}
        grads = {k: torch.randn_like(v) for k, v in params.items()}
        opt = optim.AdamW(lr=1e-4)
        st = opt.init(params)
        out.setdefault(name, []).append(time_ms(
            lambda: opt.update(grads, st, params), reps=10, warm=2))
        del params, grads, st
        torch.cuda.empty_cache()
    return {k: statistics.median(v) for k, v in out.items()}


def check_zero_ddp(results):
    """The dense GPT-2-small cell (AdamW, bf16 over float32 masters, fused
    loss, T = 2048, batch 8) on one card under ``shard_optimizer=True``:
    three steps bit for bit the replicated DDP's, exactly 1 K1f/K1b and 12
    K2f/K2b (wgmma) launches a step; ``comm_dtype=bfloat16`` within the
    dense composition limits of the replicated steps; step ms, peak memory
    and optimizer-state bytes beside the replicated DDP's; the flat-shard
    AdamW update against the per-leaf one and its bytes bound."""
    from tpu_dist_torch import dist

    pg = dist.init_process_group(device="cuda")
    try:
        repl = _zero_mode(pg)
        zero = _zero_mode(pg, shard_optimizer=True)
        comp = _zero_mode(pg, comm_dtype=torch.bfloat16)
    finally:
        dist.destroy_process_group()
    p0 = repl["params0"]
    bitwise = all(torch.equal(repl["params"][k], zero["params"][k])
                  for k in p0) and repl["losses"] == zero["losses"]
    num = sum(float((comp["params"][k] - repl["params"][k]).pow(2).sum())
              for k in p0)
    den = sum(float((repl["params"][k] - p0[k]).pow(2).sum()) for k in p0)
    rel = math.sqrt(num / den) if den else math.inf
    tol = COMPOSITION_TOL
    loss_ok = all(abs(a - b) <= tol["loss_rtol"] * abs(b)
                  for a, b in zip(comp["losses"], repl["losses"]))
    ok_comm = loss_ok and rel <= tol["update_rel"]
    upd = _flat_adamw_ms()
    emit("zero_ddp", steps_bitwise=ZERO_STEPS[0],
         zero_equals_replicated_bitwise=bitwise,
         step_ms={"replicated": repl["step_ms"], "zero1": zero["step_ms"],
                  "comm_bf16": comp["step_ms"]},
         peak_mem_bytes={"replicated": repl["peak_mem_bytes"],
                         "zero1": zero["peak_mem_bytes"],
                         "comm_bf16": comp["peak_mem_bytes"]},
         opt_state_bytes={"replicated": repl["opt_state_bytes_per_card"],
                          "zero1": zero["opt_state_bytes_per_card"]},
         losses={"replicated": repl["losses"], "zero1": zero["losses"],
                 "comm_bf16": comp["losses"]},
         comm_bf16_update_rel=rel, comm_bf16_ok=ok_comm,
         tolerance=tol, launches_zero1=zero["launches"],
         launches_by_design_zero1=zero["launches_by_design"],
         ok_launches={"replicated": repl["ok_launches"],
                      "zero1": zero["ok_launches"],
                      "comm_bf16": comp["ok_launches"]},
         adamw_update_ms={"flat_shard": upd["flat"],
                          "per_leaf": upd["per_leaf"],
                          "bytes_bound": ADAMW_BYTES_BOUND_MS})
    return (bitwise and ok_comm and zero["ok_launches"]
            and repl["ok_launches"] and comp["ok_launches"])


def check_zero_opt(results):
    """The ``bench_zero`` twin at world 1 on the card: the JAX benchmark's
    64-leaf tree, replicated (Bucketer + Adam) against ZeroOptimizer;
    the ZeRO parameters bit for bit the replicated ones; steps/s and
    optimizer-state bytes of each."""
    from tpu_dist_torch import dist
    from tpu_dist_torch.benchmarks import bench_zero

    pg = dist.init_process_group(device="cuda")
    try:
        zero_launch_counts()
        rows = bench_zero.bench(pg, bench_zero._leaf_sizes(False), iters=20,
                                check=True)
    finally:
        dist.destroy_process_group()
    emit("zero_opt", rows=rows, bitwise_checked=True)
    return len(rows) == 2 and all(r["value"] > 0 for r in rows)


ELASTIC_ARGV = ["--synthetic", "--max-steps", "40", "--save-every", "10",
                "--batch-size", "100"]
ELASTIC_KILL = "kill:rank=0,step=20"   # after step 20's save: resume at 21
ELASTIC_TIMEOUT = 300


def _elastic_launch(out, name, extra, chaos=None):
    env = dict(os.environ, PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""), PYTHONWARNINGS="ignore")
    for var in ("TPU_DIST_CHAOS", "MASTER_ADDR", "MASTER_PORT", "RANK",
                "WORLD_SIZE", "TPU_DIST_STORE_ADDR"):
        env.pop(var, None)
    if chaos:
        env["TPU_DIST_CHAOS"] = chaos
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         "--nproc_per_node=1", "--max_restarts=1", "--restart_backoff=0",
         "-m", "tpu_dist_torch.examples.elastic_train", *ELASTIC_ARGV,
         "--ckpt-root", os.path.join(out, f"ck_{name}"),
         "--record", os.path.join(out, f"{name}.jsonl"), *extra],
        cwd=out, env=env, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _twin_step_ms(deterministic: bool) -> float:
    """The twin's ConvNet forward and backward at batch 100 with cuDNN's
    deterministic algorithms on or off (CUDA events)."""
    from tpu_dist_torch.models import ConvNet
    from tpu_dist_torch.nn import functional as F
    torch.backends.cudnn.deterministic = deterministic
    try:
        model = ConvNet(device="cuda")
        x = torch.rand(100, 1, 28, 28, device="cuda")
        y = torch.randint(0, 10, (100,), device="cuda")
        params = dict(model.named_parameters())

        def step():
            loss = F.cross_entropy(torch.func.functional_call(
                model, params, (x,)), y)
            torch.autograd.grad(loss, list(params.values()))

        return time_ms(step, reps=50, warm=5)
    finally:
        torch.backends.cudnn.deterministic = False


def check_elastic(results):
    """The ``elastic_train`` twin under ``python -m tpu_dist_torch.launch
    --standalone --nproc_per_node=1 --max_restarts=1`` on the card (batch
    100, synthetic MNIST, 40 steps, a save every 10): with
    ``TPU_DIST_CHAOS=kill:rank=0,step=20`` the launcher restarts once and
    the twin resumes from the step-20 save; the resumed losses (steps
    21-39) and the final parameters equal an uninterrupted run's bit for
    bit.  The same with ``--zero``.  The four runs start together; the
    seconds from the kill to the first resumed step."""
    import tempfile
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="elastic_", dir=os.environ.get("TMPDIR"))
    runs = {"plain": ([], None), "killed": ([], ELASTIC_KILL),
            "zero_plain": (["--zero"], None),
            "zero_killed": (["--zero"], ELASTIC_KILL)}
    t0 = time.time()
    procs = {n: _elastic_launch(out, n, extra, chaos)
             for n, (extra, chaos) in runs.items()}
    errs = {}
    try:
        for n, p in procs.items():
            _, errs[n] = p.communicate(timeout=ELASTIC_TIMEOUT)
    finally:
        for p in procs.values():
            _stop(p, grace=5)
    wall = time.time() - t0
    rec = {}
    for n in runs:
        try:
            with open(os.path.join(out, f"{n}.jsonl")) as f:
                rec[n] = [json.loads(line) for line in f]
        except OSError:
            rec[n] = []
    fields, ok = {}, True
    for plain, killed in (("plain", "killed"), ("zero_plain", "zero_killed")):
        want = {r["step"]: r["loss"] for r in rec[plain] if "step" in r}
        g1 = [r for r in rec[killed] if "step" in r and r["gen"] == 1]
        g0 = {r["step"]: r for r in rec[killed]
              if "step" in r and r["gen"] == 0}
        finals = {r["final"] for r in rec[plain] + rec[killed]
                  if "final" in r}
        resumed = [r["step"] for r in g1]
        same = bool(g1) and all(r["loss"] == want.get(r["step"])
                                for r in g1)
        gen0 = all(r["loss"] == want.get(s) for s, r in g0.items())
        kill_to_step = (g1[0]["t"] - g0[20]["t"]) if g1 and 20 in g0 \
            else None
        good = (procs[plain].returncode == 0
                and procs[killed].returncode == 0
                and resumed == list(range(21, 40)) and same and gen0
                and len(finals) == 1
                and "restart 1/1" in errs[killed])
        ok = ok and good
        fields[killed] = dict(
            rc=procs[killed].returncode, resumed_steps=resumed[:1] +
            resumed[-1:], losses_bitwise=same, pre_kill_bitwise=gen0,
            params_sha256_equal=len(finals) == 1,
            kill_to_first_resumed_step_s=kill_to_step, ok=good,
            stderr_tail=None if good else errs[killed][-2000:])
    fields["twin_step_ms"] = {"cudnn_deterministic": _twin_step_ms(True),
                              "default": _twin_step_ms(False)}
    emit("elastic", chaos=ELASTIC_KILL, argv=ELASTIC_ARGV,
         launcher_wall_s=wall, **fields)
    return ok


# ---------------------------------------------------------------------------
# The host data plane (slice 13)
# ---------------------------------------------------------------------------

HOST_WORLD = 4
HOST_LAYOUT = ("h0", "h0", "h1", "h1")      # 2 hosts x 2 ranks, per rank
# tests/test_quant_collectives.py's int8 bound, a share of max(|exact|, 1)
HOST_INT8_BOUND = 0.05
HOST_RESHARD_TO = 3
HOST_ZERO_STEPS = 2      # ZeroOptimizer steps of the host_zero phase
# host_ring, host_zero and netchaos (obs: blocks 0-3 with the head's
# weight) reduce the gradients of blocks 0..HOST_RING_BLOCKS-1 and every
# leaf outside the blocks but the two 100 MB vocabulary tables
# (host_sync.ring_subset): 63 MB a rank of the 548, every kind of leaf
# (matrices, biases, norms, the odd 32768-long head bias), so their ring
# runs fit the script's time
HOST_RING_BLOCKS = 2
HOST_RING_SKIP = ("tok.weight", "head.weight")


def _host_env(shm: bool, crc: bool = True) -> None:
    """The thread rig's transport knobs (read per send): SHM lanes on or off,
    frame checksums on or off, and the simulated 2 x 2 host layout."""
    os.environ["TPU_DIST_SHM"] = "auto" if shm else "0"
    os.environ["TPU_DIST_FRAME_CRC"] = "1" if crc else "0"
    for r, h in enumerate(HOST_LAYOUT):
        os.environ[f"TPU_DIST_HOST_ID_R{r}"] = h


def _host_ranks(store, n: int, fn, timeout: float = 600):
    """``fn(dp, rank)`` on one thread a rank, each with its own DataPlane
    over ``store`` (the JAX tests' rig, ``tests/test_zero.py:27-54``);
    every plane is closed afterwards and every thread must finish."""
    import threading

    from tpu_dist_torch.collectives import transport as T

    dps = [T.DataPlane(store, r, n) for r in range(n)]
    out, errs = [None] * n, []

    def run(r):
        try:
            out[r] = fn(dps[r], r)
        except Exception as e:  # re-raised below
            errs.append((r, e))

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"a host rank did not finish in {timeout}s")
    finally:
        for dp in dps:
            dp.close()
    if errs:
        raise errs[0][1]
    return out


def _ring_sync(store, grads, wire=None, ef: bool = False, hier: bool = False):
    """One ``Bucketer(dp=, comm_dtype=wire).all_reduce(op="avg")`` of each
    rank's gradient tree over the thread rig (the hierarchical ring: the
    Bucketer over the host-major group view, ``topology.hier_group``).
    Returns ``(results, seconds, staging, shm_active, compression)``."""
    from tpu_dist_torch.collectives import Bucketer
    from tpu_dist_torch.collectives import eager as E
    from tpu_dist_torch.collectives import topology as TO
    from tpu_dist_torch.collectives.quant import ErrorFeedback

    n = len(grads)
    E.reset_transport_counters()

    def body(dp, r):
        plane = TO.hier_group(dp).view(dp) if hier else dp
        b = Bucketer(dp=plane, comm_dtype=wire)
        efo = ErrorFeedback() if ef else None
        if grads[r][next(iter(grads[r]))].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = b.all_reduce(grads[r], op="avg",
                           error_feedback=efo).wait_all(600)
        if grads[r][next(iter(grads[r]))].is_cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        lanes = any(dp.shm_active(p) for p in range(n) if p != r)
        return res, t1 - t0, dict(b.staging), lanes, (
            efo.norm() if efo is not None else None)

    out = _host_ranks(store, n, body)
    c = E.transport_counters().get("bucket_all_reduce/dataplane", {})
    return ([o[0] for o in out], max(o[1] for o in out), out[0][2],
            [o[3] for o in out], c.get("compression"), out[0][4])


def _trees_equal(a: dict, b: dict) -> bool:
    """Bit for bit, leaf by leaf (on the host when the devices differ)."""
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if a[k].device == b[k].device
        else torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def _dense_rank_grads(n: int):
    """The dense cell (``host_sync.dense_cell``: GPT-2-small, T = 2048,
    bf16 over float32 masters, fused loss) and ``n`` ranks' gradients, each
    from its own seeded batch of 2 rows, with every kernel's launches over
    the ``n`` forward and backward passes."""
    from tpu_dist_torch import dist
    from tpu_dist_torch.benchmarks.host_sync import dense_cell, rank_grads
    dist.init_process_group(device="cuda")
    try:
        ddp, state = dense_cell(device="cuda")
        zero_launch_counts()
        grads = [rank_grads(ddp, state, r) for r in range(n)]
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    counts, by_design, ok = path_launches(n, {
        "cross_entropy_fwd": 1, "cross_entropy_bwd": 1, "flash_fwd": 12,
        "flash_bwd": 12})
    return ddp, state, grads, counts, by_design, ok


def check_host_ring(results):
    """The dense cell's gradients (the 63 MB of CUDA leaves a rank that
    :data:`HOST_RING_BLOCKS` keeps) reduced by four thread ranks on the
    host ring: float32, bfloat16 and
    ``int8_block256`` with an ErrorFeedback over the flat TCP ring; float32
    and int8 over SHM lanes and over the hierarchical ring (2 hosts x 2);
    every result byte-identical across ranks and back on the card; hier
    bit for bit the flat ring, SHM the TCP ring; the float32 ring at world
    2 bit for bit ``(g0 + g1) / 2`` on the card; the float32 and int8 rings
    bit for bit the same rings over CPU copies of the gradients; int8
    within ``HOST_INT8_BOUND``.  MB/s per wire and algorithm, compression
    off the wire-byte counters, staging ms, the checksum and its cost."""
    from tpu_dist_torch.collectives import transport as T
    from tpu_dist_torch.dist.store import TCPStore

    from tpu_dist_torch.benchmarks.host_sync import ring_subset

    store = TCPStore(is_master=True, timeout=120)
    _, _, grads, counts, by_design, ok_launch = _dense_rank_grads(
        HOST_WORLD)
    grads = [ring_subset(g, HOST_RING_BLOCKS, HOST_RING_SKIP) for g in grads]
    nbytes = sum(v.numel() * v.element_size() for v in grads[0].values())
    exact = {k: sum(g[k] for g in grads) / HOST_WORLD for k in grads[0]}
    rows, checks = {}, {}
    keep = {}
    try:
        for name, wire, ef, shm, hier in (
                ("f32_flat", None, False, False, False),
                ("bf16_flat", "bfloat16", False, False, False),
                ("int8_ef_flat", "int8_block256", True, False, False),
                ("f32_flat_shm", None, False, True, False),
                ("int8_ef_flat_shm", "int8_block256", True, True, False),
                ("f32_hier", None, False, True, True),
                ("int8_ef_hier", "int8_block256", True, True, True)):
            _host_env(shm)
            res, sec, staging, lanes, comp, efn = _ring_sync(
                store, grads, wire, ef, hier)
            same = all(_trees_equal(res[0], res[r])
                       for r in range(1, HOST_WORLD))
            on_card = all(v.is_cuda for r in res for v in r.values())
            rows[name] = {"mb_s": nbytes / sec / 1e6, "seconds": sec,
                          "compression": comp, "shm_active": lanes,
                          "transport": ("shm" if all(lanes) else "tcp"
                                        if not any(lanes) else "mixed"),
                          "staging_ms": {k[:-2] + "_ms": v * 1e3
                                         for k, v in staging.items()},
                          "ef_residual_norm": efn}
            checks[f"{name}_byte_identical"] = same
            checks[f"{name}_on_card"] = on_card
            if name in ("f32_flat", "int8_ef_flat"):
                keep[name] = res[0]
            elif name.startswith("f32"):
                checks[f"{name}_equals_flat"] = _trees_equal(
                    res[0], keep["f32_flat"])
            elif name.startswith("int8"):
                checks[f"{name}_equals_flat"] = _trees_equal(
                    res[0], keep["int8_ef_flat"])
            if name == "int8_ef_flat":
                err = max(float((res[0][k] - exact[k]).abs().max())
                          for k in exact)
                top = max(float(v.abs().max()) for v in exact.values())
                checks["int8_max_err_within_bound"] = \
                    err <= HOST_INT8_BOUND * max(top, 1.0)
                rows[name]["max_abs_err"] = err
                rows[name]["bound"] = HOST_INT8_BOUND * max(top, 1.0)
            del res
            torch.cuda.empty_cache()
        # the steady D2H snapshot (the pinned buffers of a first one kept)
        from tpu_dist_torch.collectives import Bucketer
        b = Bucketer()
        for _ in range(2):
            b._snapshot(list(grads[0].values()))
        steady_d2h_ms = b.staging["d2h_s"] * 1e3
        del b
        # world 2: two addends have one order
        _host_env(False)
        res2, sec2, _, _, _, _ = _ring_sync(store, grads[:2])
        want2 = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
        checks["f32_w2_equals_card_mean"] = _trees_equal(res2[0], want2)
        rows["f32_flat_w2"] = {"mb_s": nbytes / sec2 / 1e6, "seconds": sec2}
        del res2, want2
        # the checksum's cost: the float32 TCP ring at world 2 with
        # checksums off, against the world-2 run above
        _host_env(False, crc=False)
        _, sec_off, _, _, _, _ = _ring_sync(store, grads[:2])
        crc = {"impl": T.crc_impl(), "world": 2,
               "mb_s_on": rows["f32_flat_w2"]["mb_s"],
               "mb_s_off": nbytes / sec_off / 1e6,
               "overhead": sec2 / sec_off - 1.0}
        # the same rings over CPU copies: the arithmetic is the host's
        # either way, so this holds the staging, dtypes and leaf order
        cpu = [{k: v.cpu() for k, v in g.items()} for g in grads]
        for name, wire, ef in (("f32_flat", None, False),
                               ("int8_ef_flat", "int8_block256", True)):
            res, sec, _, _, _, _ = _ring_sync(store, cpu, wire, ef)
            checks[f"{name}_equals_cpu_copy"] = _trees_equal(
                keep[name], res[0])
            rows[f"{name}_cpu_copy"] = {"mb_s": nbytes / sec / 1e6,
                                        "seconds": sec}
            del res
        del cpu
    finally:
        for k in ("TPU_DIST_SHM", "TPU_DIST_FRAME_CRC"):
            os.environ.pop(k, None)
        for r in range(HOST_WORLD):
            os.environ.pop(f"TPU_DIST_HOST_ID_R{r}", None)
        store.close()
    for name in ("cross_entropy_fwd", "cross_entropy_bwd", "flash_fwd",
                 "flash_bwd"):
        results.setdefault(name, {}).setdefault("launches", counts[name])
    emit("host_ring", world=HOST_WORLD, bytes_per_rank=nbytes,
         leaves=len(grads[0]), host_layout=HOST_LAYOUT, rows=rows,
         checks=checks, crc=crc, steady_d2h_ms=steady_d2h_ms,
         launches=counts,
         launches_by_design=by_design, ok_launches=ok_launch)
    return ok_launch and all(checks.values())


def _owned_shards_equal(z, zs, params) -> bool:
    """This rank's gathered parameters, cut at its owned spans, equal its
    master shards bit for bit (the exact gather)."""
    from tpu_dist_torch.collectives import _tree
    leaves = [t.reshape(-1) for t in _tree.flatten(params)[0]]
    plan = z._plan
    return all(torch.equal(torch.cat([leaves[i][slice(*plan.spans[i])]
                                      for i in idxs]), zs["shards"][key])
               for key, idxs in plan.groups)


def check_host_zero(results):
    """``ZeroOptimizer(dp=, comm_dtype="int8_block256", error_feedback=True)``
    over AdamW on four thread ranks, :data:`HOST_ZERO_STEPS` steps of the
    dense cell's gradients (their ``ring_subset``, as ``host_ring``'s):
    parameters byte-identical across ranks, ``zstate["ef"]``
    shard-shaped on the host, the exact gather equal to the master shards;
    then a sharded save with the residuals (ranks 2 and 3 share a root, the
    others each their own) and a reshard 4 -> 3 in which every fragment a
    new rank's root does not hold is pushed over the data plane, the
    restored shards bit for bit the saved ones."""
    import shutil
    import tempfile

    import numpy as np

    from tpu_dist_torch import checkpoint, optim
    from tpu_dist_torch.benchmarks.host_sync import ring_subset
    from tpu_dist_torch.dist.store import TCPStore
    from tpu_dist_torch.parallel import ZeroOptimizer
    from tpu_dist_torch.resilience import reshard

    _, state, grads, counts, _, ok_launch = _dense_rank_grads(HOST_WORLD)
    grads = [ring_subset(g, HOST_RING_BLOCKS, HOST_RING_SKIP) for g in grads]
    params0 = {k: state.params[k] for k in grads[0]}
    store = TCPStore(is_master=True, timeout=120)
    _host_env(False)
    out = tempfile.mkdtemp(prefix="host_zero_", dir=os.environ.get("TMPDIR"))
    roots = [os.path.join(out, f"root{min(r, 2)}") for r in range(HOST_WORLD)]
    try:
        def train(dp, r):
            z = ZeroOptimizer(optim.AdamW(lr=1e-4), dp=dp,
                              comm_dtype="int8_block256",
                              error_feedback=True)
            params = {k: v.clone() for k, v in params0.items()}
            zs = z.init(params)
            step_s = []
            for _ in range(HOST_ZERO_STEPS):
                t0 = time.perf_counter()
                h, zs = z.update(grads[r], zs, timeout=600)
                params = h.wait(600)
                if params0[next(iter(params0))].is_cuda:
                    torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            exact = _owned_shards_equal(z, zs, params)
            shaped = all(zs["ef"][k].shape == zs["shards"][k].shape
                         and zs["ef"][k].device.type == "cpu"
                         for k in zs["shards"])
            t0 = time.perf_counter()
            checkpoint.save(roots[r], {"zero": zs}, step=HOST_ZERO_STEPS,
                            shard=(r, HOST_WORLD))
            save_s = time.perf_counter() - t0
            saved = {p: v.cpu().numpy().copy() if isinstance(
                v, torch.Tensor) else np.asarray(v).copy()
                for p, v in checkpoint._flatten({"zero": zs}).items()}
            return params, exact, shaped, step_s, save_s, saved, float(
                sum(float(v.norm()) ** 2 for v in zs["ef"].values())) ** .5

        res = _host_ranks(store, HOST_WORLD, train)
        same = all(_trees_equal(res[0][0], res[r][0])
                   for r in range(1, HOST_WORLD))
        finite = all(bool(torch.isfinite(v).all()) for v in
                     res[0][0].values())
        saved = [x[5] for x in res]
        res = [x[1:5] + x[6:] for x in res]    # the parameters go
        plan = reshard.ReshardPlan(
            reshard.load_manifest(roots[0], HOST_ZERO_STEPS, 0),
            HOST_RESHARD_TO)
        vis = {0: {0}, 1: {1}, 2: {2, 3}}
        new_roots = [os.path.join(out, f"root{r}")
                     for r in range(HOST_RESHARD_TO)]

        def restore(dp, r):
            t0 = time.perf_counter()
            arrays, stats = reshard.execute_plan(
                plan, rank=r, root=new_roots[r], step=HOST_ZERO_STEPS,
                visibility=vis, dp=dp, verify=True, timeout=300)
            return arrays, stats, time.perf_counter() - t0

        back = _host_ranks(store, HOST_RESHARD_TO, restore)
        sources = plan.resolve_sources(vis)
        bitwise, frags_peer, bytes_peer = True, 0, 0
        for r, (arrays, stats, _) in enumerate(back):
            want = {p: np.zeros(n[r], plan.new_dtype[p])
                    for p, n in plan.new_len.items()}
            for f in plan.frags_for(r):
                want[f.path][f.new_off:f.new_off + f.length] = \
                    saved[f.old_rank][f.path].reshape(-1)[
                        f.old_off:f.old_off + f.length]
                if sources[f.fid] != r:
                    bytes_peer += f.length * np.dtype(f.dtype).itemsize
            for rp in plan.repl:
                want[rp.path] = saved[0][rp.path]
            bitwise = bitwise and all(
                arrays[p].tobytes() == np.asarray(w).tobytes()
                for p, w in want.items())
            frags_peer += stats.frags_peer
        ef_paths = [p for p in plan.new_len if "['ef']" in p]
    finally:
        for k in ("TPU_DIST_SHM", "TPU_DIST_FRAME_CRC"):
            os.environ.pop(k, None)
        for r in range(HOST_WORLD):
            os.environ.pop(f"TPU_DIST_HOST_ID_R{r}", None)
        store.close()
        shutil.rmtree(out, ignore_errors=True)
    checks = {"params_byte_identical": same, "params_finite": finite,
              "exact_gather_equals_master_shards": all(x[0] for x in res),
              "ef_shard_shaped_on_host": all(x[1] for x in res),
              "ef_rides_the_manifest": bool(ef_paths),
              "reshard_bitwise": bitwise, "frags_pushed": frags_peer > 0}
    emit("host_zero", world=HOST_WORLD, reshard_to=HOST_RESHARD_TO,
         visibility={r: sorted(v) for r, v in vis.items()},
         step_s=[x[2] for x in res], save_s=[x[3] for x in res],
         ef_residual_norm=[x[4] for x in res],
         frags_peer=frags_peer, bytes_pushed=bytes_peer,
         frags_pushed={r: back[r][1].frags_pushed for r in range(len(back))},
         reshard_s=max(b[2] for b in back),
         reshard=[b[1].describe() for b in back], checks=checks,
         launches=counts, ok_launches=ok_launch)
    return ok_launch and all(checks.values())


def check_quant_gate(results):
    """The ``accuracy_run`` twin's ConvNet gate at world 2 (two worker
    processes on this one card, store and data plane only, no NCCL): the
    JAX spec (150 steps, batch 128, lr 0.02), float32 wire against
    ``int8_block256`` with error feedback (the two worlds at once, four
    processes); ``|delta|`` within the ±3 SE band."""
    from tpu_dist_torch.benchmarks.accuracy_run import run_quant_ef_gate
    row = run_quant_ef_gate(model="convnet", device="cuda")
    emit("quant_gate", **row)
    return row["within_noise"]


# ---------------------------------------------------------------------------
# VGG, the recipes to accuracy and the benchmark twins (slice 21)
# ---------------------------------------------------------------------------

VGG_BATCH = 16
VGG_STEP_TOL = dict(
    VISION_STEP_TOL, null_rel=1e-4,
    why_null="a convolution's bias under a BatchNorm (torchvision keeps it "
             "in the _bn variants) has an exact gradient of 0: the batch "
             "mean takes it out; its float32 update is rounding, at most "
             "8.7e-6 of the next BatchNorm bias's update in a CPU step of "
             "the port (1e-15 in float64), so 1e-4 of it bounds both sides")
VGG_TIMED = {"batch": 64, "steps": 10, "warmup": 3}


def check_vgg(results):
    """``vgg11_bn`` and ``vgg16`` (10 classes, 32x32, batch 16, float32,
    TF32 off): one DDP step each against the CPU copy, the BatchNorm
    statistics moved and finite; ``vgg16``'s bf16 forward at 224², batch
    8; images/s and peak memory of its bf16 DDP step at batch 64, 32².  No
    hand-written kernel may launch."""
    import numpy as np

    from tpu_dist_torch import models, nn, optim
    from tpu_dist_torch.benchmarks.transformer_lm import time_steps
    from tpu_dist_torch.parallel import DistributedDataParallel

    zero_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(VGG_BATCH, 3, 32, 32)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 10, VGG_BATCH)).cuda()

    def ddp_of(name, device, **kw):
        return DistributedDataParallel(
            getattr(models, name)(num_classes=10, device=device),
            optimizer=optim.SGD(lr=0.01, momentum=0.9),
            loss_fn=nn.CrossEntropyLoss(), **kw)

    ok_all = True
    for name in ("vgg11_bn", "vgg16"):
        ddp = ddp_of(name, "cuda")
        feats = list(ddp.module.features)
        null = {f"features.{i}.bias": f"features.{i + 1}.bias"
                for i, mod in enumerate(feats[:-1])
                if isinstance(mod, nn.Conv2d)
                and isinstance(feats[i + 1], nn.BatchNorm2d)}
        cmp_ = step_against_cpu(
            ddp, lambda: getattr(models, name)(num_classes=10, device="cpu"),
            x, y, VGG_STEP_TOL, null_leaves=null)
        stats = {p: {"mean": m.running_mean, "var": m.running_var}
                 for p, m in ddp.module.named_modules()
                 if isinstance(m, nn.BatchNorm2d)}
        moved = bn_moved(stats)
        ok = cmp_["ok"] and moved and len(stats) == (
            8 if name == "vgg11_bn" else 0)
        emit("vgg", model=name, step_vs_cpu=cmp_, bn_layers=len(stats),
             bn_stats_moved_and_finite=moved, ok=ok)
        ok_all = ok_all and ok
        del ddp

    big = models.vgg16(num_classes=10, device="cuda").to(
        torch.bfloat16).eval()
    with torch.no_grad():
        out = big(torch.from_numpy(rng.normal(size=(8, 3, 224, 224)).astype(
            np.float32)).cuda().to(torch.bfloat16))
    ok_224 = tuple(out.shape) == (8, 10) and bool(torch.isfinite(out).all())
    del big, out
    torch.cuda.empty_cache()

    b = VGG_TIMED["batch"]
    xb = torch.from_numpy(rng.normal(size=(b, 3, 32, 32)).astype(
        np.float32)).cuda()
    yb = torch.from_numpy(rng.integers(0, 10, b)).cuda()
    with tf32(True):
        res = time_steps(ddp_of("vgg16", "cuda",
                                compute_dtype=torch.bfloat16),
                         xb, yb, VGG_TIMED["steps"], VGG_TIMED["warmup"])
    losses_ok = all(map(math.isfinite, res["losses"]))
    counts = launch_counts()
    ok_launches = not any(counts.values())
    emit("vgg", vgg16_bf16_224={"shape": [8, 3, 224, 224], "finite": ok_224},
         timing={"model": "vgg16", "per_gpu_batch": b, "image_size": 32,
                 "dtype": "bfloat16", "step_ms": res["step_ms"],
                 "images_per_s": b / res["step_ms"] * 1e3,
                 "peak_mem_bytes": res["peak_mem_bytes"],
                 "losses_finite": losses_ok},
         timing_note="torch's default TF32 permissions (cuDNN yes, cuBLAS "
                     "no); images/s/GPU at world 1",
         kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_all and ok_224 and losses_ok and ok_launches


# the low-SNR oracle's band at 10,000 test images (ceiling 0.775 ± 3 SE) and
# the torch-parity bounds at lr 0.05 (tests/test_torch_e2e_parity.py)
ORACLE_BAND = (0.7625, 0.7875)
PARITY_BOUNDS = {"max_step_loss_delta": 4e-3, "mean_step_loss_delta": 4e-4}


def check_accuracy(results):
    """The ``accuracy_run`` twin on the card: the MNIST low-SNR oracle at
    the JAX spec in its band, and the torch-parity row within the JAX
    test's bounds (TF32 off inside the row).  No hand-written kernel may
    launch."""
    from tpu_dist_torch.benchmarks import accuracy_run

    zero_launch_counts()
    t0 = time.perf_counter()
    oracle = accuracy_run.run_noisy_oracle(device="cuda")
    oracle_s = time.perf_counter() - t0
    lo, hi = ORACLE_BAND
    acc = oracle["final_test_accuracy"]
    ok_oracle = (oracle["in_band"] and lo <= acc <= hi
                 and oracle["test_samples"] == 10000
                 and oracle["expected_band"] == [lo, hi])
    emit("accuracy", row="mnist_low_snr_oracle", **oracle,
         seconds=oracle_s, ok=ok_oracle)
    t0 = time.perf_counter()
    parity = accuracy_run.run_torch_parity(device="cuda")
    ok_parity = all(parity[k] < v for k, v in PARITY_BOUNDS.items())
    emit("accuracy", row="torch_e2e_curve_parity",
         **{k: v for k, v in parity.items() if not k.startswith("curve")},
         bounds=PARITY_BOUNDS, seconds=time.perf_counter() - t0,
         ok=ok_parity)
    counts = launch_counts()
    ok_launches = not any(counts.values())
    emit("accuracy", kernel_launches=counts, ok_launches_zero=ok_launches)
    return ok_oracle and ok_parity and ok_launches


TWIN_GEN = {"batch": 2, "prompt_len": 16, "gen_long": 32, "gen_short": 8,
            "reps": 3}
TWIN_ATTN_ROWS = ((1024, True, None), (2048, True, None))
TWIN_PIPELINE = {"batch": 32, "n_images": 64, "workers": (0, 2),
                 "step_batch": 32}


def _flash_against_dense(t: int, tol: dict) -> dict:
    """The attention twin's two routes on one (4, t, 8, 64) bf16 causal
    input, the output and the q/k/v gradients for one seeded upstream
    gradient: flash (K2f/K2b) against the dense composition in float32 on
    the same values, and against flash's plain version (the same route on
    CPU copies).  o, dk and dv must hold to dense within ``tol``; dq no
    further from dense than the plain version's dq is, plus one tolerance:
    at the first causal queries dq is a sum that cancels, and ``delta =
    rowsum(dO·O)`` from the bf16 output leaves its rounding there, in the
    plain version as in the kernel (measured on an H100: both at a margin
    of 26-31 from dense at the second query of a head); and every gradient
    must hold to the plain version within ``tol``."""
    from tpu_dist_torch.nn.attention import scaled_dot_product_attention

    g = torch.Generator(device="cuda").manual_seed(t)
    q, k, v, do = (torch.randn(4, t, 8, 64, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))

    def route(impl, dtype, dev):
        leaves = [a.to(dev, dtype).requires_grad_(True) for a in (q, k, v)]
        o = scaled_dot_product_attention(*leaves, causal=True, impl=impl)
        return (o, *torch.autograd.grad(o, leaves, do.to(dev, dtype)))

    got = route("flash", torch.bfloat16, "cuda")
    dense = route("dense", torch.float32, "cuda")
    plain = route("flash", torch.bfloat16, "cpu")
    lims = (tol["rtol"], tol["atol"], tol["atol_row"], tol["atol_all"])
    out = {}
    for name, a, d, p in zip(("o", "dq", "dk", "dv"), got, dense, plain):
        err, _, margin, ok_d = compare(a, d, *lims)
        m_plain = compare(p, d.cpu(), *lims)[2]
        ok_p = compare(a.cpu(), p, *lims)[3]
        if name == "dq":
            ok_d = margin <= m_plain + 1.0
        out[name] = {"max_abs_err": err, "margin": margin,
                     "plain_margin": m_plain, "kernel_within_plain": ok_p,
                     "ok": ok_d and ok_p}
    return out


def check_twins(results):
    """The benchmark twins at small sizes: ``generate`` (tokens equal
    ``generate()``, the implied bandwidth within the card's rate),
    ``attention`` at T = 1024 and 2048 (flash and dense agree; K2f/K2b
    launches equal each row's flash calls) and ``input_pipeline`` (every
    JAX key, every rate above 0)."""
    from tpu_dist_torch.benchmarks import attention, generate, input_pipeline

    zero_launch_counts()
    row = generate.run(keep_tokens=True, **TWIN_GEN)
    model = generate.build_lm(TWIN_GEN["prompt_len"] + TWIN_GEN["gen_long"],
                              False)
    want = model.generate(torch.tensor(row["prompt"], device="cuda"),
                          TWIN_GEN["gen_long"], cache_dtype=torch.bfloat16)
    del model
    ok_tokens = row.pop("tokens") == want.tolist()
    row.pop("prompt")
    ok_bw = row["implied_weight_read_gb_per_sec"] * 1e9 <= PEAK_BYTES_S
    ok_gen = ok_tokens and ok_bw and row["value"] > 0
    counts_gen = launch_counts()
    emit("twins", twin="generate", **row, tokens_equal_generate=ok_tokens,
         bandwidth_within_peak=ok_bw, kernel_launches=counts_gen, ok=ok_gen)

    agree = {t: _flash_against_dense(t, FLASH_BF16_TOL)
             for t, _, _ in TWIN_ATTN_ROWS}
    ok_agree = all(c["ok"] for case in agree.values() for c in case.values())
    zero_launch_counts()
    attn = attention.run(rows=TWIN_ATTN_ROWS, sweep=(), reps=5)
    ok_calls = all(
        r["flash_launches"] == {"flash_fwd": r["flash_calls"]["fwd"],
                                "flash_bwd": r["flash_calls"]["bwd"]}
        for r in attn["rows"])
    counts_attn = launch_counts()
    ok_attn = ok_agree and ok_calls and all(
        counts_attn[f"flash_{d}"] == sum(r["flash_calls"][d]
                                          for r in attn["rows"])
        for d in ("fwd", "bwd"))
    emit("twins", twin="attention", flash_vs_dense=agree,
         tolerance=FLASH_BF16_TOL, **attn, launches_equal_calls=ok_calls,
         kernel_launches=counts_attn, ok=ok_attn)

    zero_launch_counts()
    pipe = input_pipeline.run(**TWIN_PIPELINE)
    keys = {"metric", "host_augment_images_per_sec",
            "raw_host_images_per_sec", "device_augment_images_per_sec",
            "resnet50_bf16_step_images_per_sec",
            "chip_consume_images_per_sec", "loader_over_step",
            "loader_keeps_chip_fed", "host_cores",
            "host_augment_cores_to_feed_estimate", "batch", "image_size",
            "raw_size", "note"}
    rates = [*pipe["host_augment_images_per_sec"].values(),
             pipe["raw_host_images_per_sec"],
             pipe["device_augment_images_per_sec"],
             pipe["resnet50_bf16_step_images_per_sec"]]
    counts_pipe = launch_counts()
    ok_pipe = (keys <= set(pipe) and all(r > 0 for r in rates)
               and not any(counts_pipe.values())
               and not any(counts_gen.values()))
    emit("twins", twin="input_pipeline", **pipe, kernel_launches=counts_pipe,
         ok=ok_pipe)
    return ok_gen and ok_attn and ok_pipe


# ---------------------------------------------------------------------------
# The control plane: flight recorder, sanitizer, role graphs (slice 14)
# ---------------------------------------------------------------------------

OBS_WORLD = 2
OBS_HB_TIMEOUT = 5           # the launcher's heartbeat deadline, seconds
OBS_STALL = "stall:rank=1,step=3"
OBS_TIMEOUT = 420            # seconds a launched control-plane run may take
OBS_PER_STEP = {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
                "flash_fwd": 12, "flash_bwd": 12, "gmm": 0, "tgmm": 0}

# the worker of the obs and sanitize phases, under ``python -m
# tpu_dist_torch.launch --standalone --nproc_per_node=2``: both ranks on
# cuda:0, the group the store and the host data plane only (a rank shim,
# no torch.distributed group, no NCCL).  A step: the dense cell's
# gradients on the rank's own seeded row (K1 once, K2 12 times), then
# their host_ring subset with the head's weight (221 MB) averaged by a
# Bucketer over the float32 host ring, inside resilience.TrainState.  argv: OUT MODE STEPS.  MODE ``stall``: every
# step as launched.  ``timing`` (launched with --flight-recorder and
# --sanitize): steps 0-7 with the sanitizer off and the recorder armed on
# even steps, disarmed on odd ones (both read their env var per call;
# nothing else changes), steps 8-9 with both on, and at step 10 rank 1
# casts its last gradient leaf to bfloat16.  Each rank writes its steps to
# OUT/r{rank}.json as it goes.
OBS_WORKER = """
import json, os, sys, time
import numpy as np
import torch
from tpu_dist_torch import dist, resilience
from tpu_dist_torch.analysis import sanitizer
from tpu_dist_torch.benchmarks.bench_host_collectives import (
    _Group, attach_store)
from tpu_dist_torch.benchmarks.host_sync import (
    dense_cell, rank_grads, ring_subset)
from tpu_dist_torch.collectives import Bucketer, eager
from tpu_dist_torch.obs import hooks, recorder
from tpu_dist_torch.ops import KERNELS

out, mode, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
san_env = os.environ.get("TPU_DIST_SANITIZE")
hooks.install_from_env()
torch.cuda.set_device(0)
dist.init_process_group(device="cuda:0")    # world 1: the model's group
rec = recorder.get_recorder()
if rec is not None:
    rec.rank, rec.world = rank, world
store = attach_store(os.environ["TPU_DIST_STORE_ADDR"])
group = _Group(rank, world)
ddp, state = dense_cell(device="cuda:0", batch=1)
bucketer = Bucketer()
san = [0.0, 0]
check = sanitizer.check_collective

def timed_check(*a, **k):
    t = time.perf_counter()
    try:
        return check(*a, **k)
    finally:
        san[0] += time.perf_counter() - t
        san[1] += 1

sanitizer.check_collective = timed_check
log = {"rank": rank, "pid": os.getpid(), "steps": []}

def flush():
    with open(os.path.join(out, f"r{rank}.json"), "w") as f:
        json.dump(log, f)

def payload_calls():
    return eager.transport_counters().get(
        "bucket_all_reduce/dataplane", {}).get("calls", 0)

with resilience.TrainState(os.path.join(out, f"ck{rank}"), save_every=0,
                           heartbeat_interval=0.2, monitor=False) as ts:
    st, start = ts.resume({"x": np.zeros(1)})
    for step in range(start, steps):
        if mode == "timing":
            os.environ["TPU_DIST_OBS"] = ("1" if step % 2 == 0 or step >= 8
                                          else "0")
            if step < 8:
                os.environ.pop("TPU_DIST_SANITIZE", None)
            elif san_env is not None:
                os.environ["TPU_DIST_SANITIZE"] = san_env
        for k in KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the head's weight stays: the Bucketer's first bucket is then
        # head.bias alone, the leaf rank 1 casts at step 10, as in the
        # whole tree
        grads = ring_subset(rank_grads(ddp, state, rank, batch=1),
                            skip=("tok.weight",))
        if mode == "timing" and step == 10 and rank == 1:
            last = list(grads)[-1]
            grads[last] = grads[last].to(torch.bfloat16)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s0, before = list(san), payload_calls()
        try:
            bucketer.all_reduce(grads, op="avg", group=group).wait_all(600)
            torch.cuda.synchronize()
        except sanitizer.CollectiveMismatchError as e:
            log["mismatch"] = {"step": step, "error": str(e)[:2000],
                               "seq": e.seq,
                               # sanitized collectives of this step that
                               # passed (and moved) before the refused one
                               "passed_in_step": e.seq - s0[1],
                               "divergent": sorted(e.divergent),
                               "payload_calls_before": before,
                               "payload_calls_after": payload_calls()}
            flush()
            raise
        t2 = time.perf_counter()
        log["steps"].append({
            "step": step, "obs": recorder.enabled(),
            "sanitize": sanitizer.enabled(),
            "grads_ms": (t1 - t0) * 1e3, "sync_ms": (t2 - t1) * 1e3,
            "step_ms": (t2 - t0) * 1e3,
            "san_ms": (san[0] - s0[0]) * 1e3, "san_calls": san[1] - s0[1],
            "payload_calls": payload_calls() - before,
            "launches": {k.__name__: k.launches for k in KERNELS},
            "bytes": sum(v.numel() * v.element_size()
                         for v in grads.values())})
        flush()
        ts.end_step(st, step)
log["done"] = True
flush()
store.barrier(world, tag="obs-exit", timeout=120)
"""


def _ctrl_launch(out: str, args: list, env_extra: dict):
    """``python -m tpu_dist_torch.launch ARGS`` in a session of its own,
    the repo on the path, every worker on one CPU thread."""
    env = dict(os.environ, PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               PYTHONWARNINGS="ignore")
    for var in ("TPU_DIST_CHAOS", "TPU_DIST_OBS", "TPU_DIST_SANITIZE",
                "TPU_DIST_OBS_DIR", "MASTER_ADDR", "MASTER_PORT", "RANK",
                "WORLD_SIZE", "TPU_DIST_STORE_ADDR"):
        env.pop(var, None)
    env.update(env_extra)
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", *args], cwd=out,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        so, se = proc.communicate(timeout=OBS_TIMEOUT)
    finally:
        _stop(proc, grace=5)
    return proc.returncode, so, se, time.time() - t0


def _obs_run(mode: str, steps: int, flags: list, env_extra: dict) -> dict:
    """One launch of :data:`OBS_WORKER`; the ranks' logs, the dumps."""
    import tempfile

    from tpu_dist_torch import obs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # two ranks and this process share the card
    out = tempfile.mkdtemp(prefix=f"obs_{mode}_",
                           dir=os.environ.get("TMPDIR"))
    obs_dir = os.path.join(out, "obs")
    with open(os.path.join(out, "worker.py"), "w") as f:
        f.write(OBS_WORKER)
    rc, _, err, wall = _ctrl_launch(
        out, ["--standalone", f"--nproc_per_node={OBS_WORLD}",
              "--master_port=0", *flags, os.path.join(out, "worker.py"),
              out, mode, str(steps)],
        dict(env_extra, TPU_DIST_OBS_DIR=obs_dir))
    logs = {}
    for r in range(OBS_WORLD):
        try:
            with open(os.path.join(out, f"r{r}.json")) as f:
                logs[r] = json.load(f)
        except OSError:
            logs[r] = {"steps": []}
    files = (sorted(os.listdir(obs_dir)) if os.path.isdir(obs_dir) else [])
    return {"rc": rc, "stderr": err, "wall_s": wall, "logs": logs,
            "obs_dir": obs_dir, "dumps": obs.read_dumps(obs_dir),
            "dump_bytes": {n: os.path.getsize(os.path.join(obs_dir, n))
                           for n in files}}


def _steps_launch_ok(logs: dict) -> bool:
    """Every completed step of every rank launched K1 once and K2 12
    times, and nothing else."""
    steps = [s for lg in logs.values() for s in lg["steps"]]
    return bool(steps) and all(s["launches"] == OBS_PER_STEP for s in steps)


def _obs_cli(*args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "tpu_dist_torch.obs",
                           *args], cwd=_repo(), env=env, capture_output=True,
                          text=True, timeout=120)


def _med(xs):
    return statistics.median(xs) if xs else None


def _obs_stall() -> bool:
    """The flight recorder's stall at world 2 (two ranks on this card, the
    dense cell's real gradients, store and host data plane, no NCCL):
    ``--flight-recorder --heartbeat_timeout=5`` with rank 1
    chaos-stalled at step 3.  The launcher exits non-zero naming
    ``RankLostError`` for rank 1 with its last obs position, prints the
    positions table and the dump directory; both ranks' dumps read; up to
    the stall every collective number has the same op, digest and bytes
    on both ranks, path ``dataplane``; ``diagnose`` names rank 1 the
    straggler, rank 0 pending in the next bucket's span and the ring span
    nested in it, at the worker's line; the CLI exits 3 and ``merge``
    writes a trace with two tracks; every completed step launched K1 once
    and K2 12 times.  A check of function: the launch runs in the
    ``faults`` phase, beside other fault launches."""
    from tpu_dist_torch import obs
    run = _obs_run("stall", 10, ["--flight-recorder",
                                 f"--heartbeat_timeout={OBS_HB_TIMEOUT}"],
                   {"TPU_DIST_CHAOS": OBS_STALL})
    err, dumps = run["stderr"], run["dumps"]
    checks = {
        "launcher_failed": run["rc"] not in (0, None),
        "rank_lost_named": "RankLostError" in err and "rank 1" in err,
        "last_obs_in_error": "last obs:" in err and "all_reduce" in err,
        "positions_table": "last known positions" in err,
        "dump_dir_named": "flight-recorder dumps in" in err,
        "both_dumps": sorted(d["rank"] for d in dumps) == [0, 1]}
    colls = {}
    for d in dumps:
        colls[d["rank"]] = {e["coll"]: e for e in d["events"]
                            if e.get("kind") == "collective"}
    diag = obs.diagnose(dumps) if dumps else {}
    last1 = diag.get("straggler_last_coll")
    if checks["both_dumps"] and last1 is not None:
        keys = range(last1 + 1)
        checks["lockstep_until_stall"] = all(
            k in colls[0] and k in colls[1]
            and all(colls[0][k].get(f) == colls[1][k].get(f)
                    for f in ("op", "digest", "bytes", "path"))
            and colls[0][k].get("path") == "dataplane"
            and colls[0][k]["outcome"] == "ok" for k in keys)
        pend = {k: e["op"] for k, e in colls[0].items()
                if e["outcome"] == "pending"}
        checks["rank0_pending_next"] = pend == {
            last1 + 1: "bucket_all_reduce", last1 + 2: "ring_all_reduce"}
    checks["diagnosis"] = (diag.get("verdict") == "straggler"
                           and diag.get("straggler") == 1
                           and diag.get("stuck_coll") == (last1 or 0) + 2
                           and "worker.py" in (diag.get("stuck_site") or ""))
    cli = _obs_cli("diagnose", "--dir", run["obs_dir"])
    trace_path = os.path.join(run["obs_dir"], "..", "trace.json")
    merged = _obs_cli("merge", "--dir", run["obs_dir"], "--out", trace_path)
    tracks = set()
    if merged.returncode == 0:
        with open(trace_path) as f:
            tracks = {e["pid"] for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"}
    checks["cli_exit_3"] = cli.returncode == 3
    checks["merge_two_tracks"] = tracks == {0, 1}
    checks["launches_per_step"] = _steps_launch_ok(run["logs"])
    checks["steps_before_stall"] = [len(run["logs"][r]["steps"])
                                    for r in range(OBS_WORLD)] == [4, 4]
    # the offline replay over the same dumps, in process
    from tpu_dist_torch.analysis import replay_dir
    t0 = time.perf_counter()
    report = replay_dir(run["obs_dir"])
    replay_s = time.perf_counter() - t0
    td115 = [f for f in report.findings if f.rule == "TD115"]
    checks["replay_no_td110"] = not any(f.rule == "TD110"
                                        for f in report.findings)
    checks["replay_td115_names_rank1"] = (
        len(td115) == 1 and td115[0].severity == "error"
        and "rank 1 " in td115[0].message
        and f"collective #{diag.get('stuck_coll')} " in td115[0].message)
    checks["replay_diagnosis_is_diagnose"] = report.diagnosis == diag

    emit("obs_stall", world=OBS_WORLD, chaos=OBS_STALL,
         heartbeat_timeout=OBS_HB_TIMEOUT, launcher_rc=run["rc"],
         launcher_wall_s=run["wall_s"], diagnosis={
             k: diag.get(k) for k in ("verdict", "straggler",
                                      "straggler_last_coll", "stuck_coll",
                                      "stuck_op", "stuck_site",
                                      "waiting_ranks")},
         events_per_rank={d["rank"]: len(d["events"]) for d in dumps},
         stall_dump_bytes=run["dump_bytes"],
         replay_findings=[[f.rule, f.severity] for f in report.findings],
         replay_td115=[f.message for f in td115], replay_seconds=replay_s,
         checks=checks,
         stderr_tail=None if all(checks.values()) else err[-3000:])
    return all(checks.values())


def check_obs(results):
    """The flight recorder's cost on the dense cell's real gradients at
    world 2 (two ranks on this card, store and host data plane, no NCCL):
    steps 0-7 of the ``timing`` launch, the recorder armed on even steps
    and disarmed on odd ones — step and sync ms of each, and the dumps'
    bytes; every step launched K1 once and K2 12 times.  (The recorder's
    stall and diagnosis: the ``faults`` phase.)"""
    timing = _timing_run(results)
    checks = {}
    steps = [s for r in range(OBS_WORLD)
             for s in timing["logs"][r]["steps"] if s["step"] < 8]
    checks["timing_steps_done"] = len(steps) == 8 * OBS_WORLD
    checks["timing_launches_per_step"] = _steps_launch_ok(timing["logs"])
    # the first step of a run warms up: left out of both arms
    arm = {a: [s for s in steps if s["obs"] == a and s["step"] > 0]
           for a in (True, False)}
    row = {a: {"step_ms": _med([s["step_ms"] for s in arm[a]]),
               "sync_ms": _med([s["sync_ms"] for s in arm[a]]),
               "grads_ms": _med([s["grads_ms"] for s in arm[a]])}
           for a in (True, False)}
    nbytes = steps[0]["bytes"] if steps else None
    emit("obs", world=OBS_WORLD,
         timing={"armed": row[True], "disarmed": row[False],
                 "step_overhead_ms": (row[True]["step_ms"]
                                      - row[False]["step_ms"])
                 if arm[True] and arm[False] else None,
                 "bytes_per_rank": nbytes,
                 "dump_bytes": timing["dump_bytes"],
                 "launcher_wall_s": timing["wall_s"]},
         checks=checks,
         stderr_tail=None if all(checks.values())
         else timing["stderr"][-3000:])
    return all(checks.values())


def _timing_run(results) -> dict:
    """The ``timing`` launch (recorder arms, then the sanitizer), shared by
    the ``obs`` and ``sanitize`` phases: run once, by whichever comes
    first."""
    if "_obs_timing" not in results:
        results["_obs_timing"] = _obs_run(
            "timing", 11, ["--flight-recorder", "--sanitize"], {})
    return results["_obs_timing"]


def check_sanitize(results):
    """The ``timing`` launch under ``--sanitize``: its steps 8-9 pass the
    signature checks (the sanitizer's ms a collective); at step 10 rank 1
    casts its last gradient leaf to bfloat16, and both ranks raise
    ``CollectiveMismatchError`` naming the ``leaves`` divergence of rank
    1, with no payload moved for the refused collective (the buckets
    before it match and move); the launcher exits non-zero with the error
    on stderr."""
    run = _timing_run(results)
    logs = run["logs"]
    steps = [s for r in range(OBS_WORLD) for s in logs[r]["steps"]
             if s["step"] >= 8]
    mism = [logs[r].get("mismatch") or {} for r in range(OBS_WORLD)]
    checks = {
        "launcher_failed": run["rc"] not in (0, None),
        "error_on_stderr": "CollectiveMismatchError" in run["stderr"],
        "steps_before_mismatch": [len(logs[r]["steps"])
                                  for r in range(OBS_WORLD)] == [10, 10],
        "sanitized_steps_checked": len(steps) == 2 * OBS_WORLD and all(
            s["sanitize"] and s["san_calls"] > 0 for s in steps),
        "unsanitized_steps_unchecked": all(
            not s["sanitize"] and s["san_calls"] == 0
            for r in range(OBS_WORLD) for s in logs[r]["steps"]
            if s["step"] < 8),
        "both_ranks_raise_at_step_10": all(m.get("step") == 10
                                           for m in mism),
        "leaves_named": all("leaves:" in m.get("error", "")
                            and "bfloat16" in m.get("error", "")
                            for m in mism),
        "divergent_rank_1": all(m.get("divergent") == [1] for m in mism),
        # the buckets before the bfloat16 one match and move; the refused
        # collective #seq moves nothing: one payload leg a passed check
        "no_payload_moved": all(
            m.get("payload_calls_after", -1) - m.get("payload_calls_before",
                                                     0)
            == m.get("passed_in_step") for m in mism),
        "launches_per_step": _steps_launch_ok(logs)}
    per_coll = [s["san_ms"] / s["san_calls"] for s in steps
                if s["san_calls"]]
    armed = [s for r in range(OBS_WORLD) for s in logs[r]["steps"]
             if s["obs"] and 0 < s["step"] < 8]
    emit("sanitize", world=OBS_WORLD, launcher_rc=run["rc"],
         launcher_wall_s=run["wall_s"],
         ms_per_collective=_med(per_coll),
         collectives_per_step=_med([s["san_calls"] for s in steps]),
         sync_ms=_med([s["sync_ms"] for s in steps]),
         sync_ms_unsanitized=_med([s["sync_ms"] for s in armed]),
         mismatch={r: {k: v for k, v in mism[r].items() if k != "error"}
                   for r in range(OBS_WORLD)},
         error=mism[0].get("error", "")[:600], checks=checks,
         stderr_tail=None if all(checks.values())
         else run["stderr"][-3000:])
    return all(checks.values())


ROLES_TIMEOUT = 420
ROLES_KILL = "kill:rank=2,step=3"
ROLES_ACTOR_THROTTLE = 0.5      # seconds an actor sleeps between batches


def _roles_run(roles: str, module: str, extra: list, obs: bool) -> dict:
    import tempfile
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="roles_", dir=os.environ.get("TMPDIR"))
    env = {"TPU_DIST_CHAOS": ROLES_KILL}
    if obs:
        env.update(TPU_DIST_OBS="1",
                   TPU_DIST_OBS_DIR=os.path.join(out, "obs"))
    rc, so, se, wall = _ctrl_launch(
        out, ["--standalone", "--roles", roles, "--solo_restarts", "2",
              "-m", module, *extra, "--device", "cuda", "--out", out], env)
    return {"rc": rc, "stdout": so, "stderr": se, "wall_s": wall,
            "out": out}


def _role_checks(run, head_key, json_name, n, steps, margin, stats_key):
    out = run["out"]
    try:
        with open(os.path.join(out, json_name)) as f:
            main = json.load(f)
    except OSError:
        main = {}
    try:
        with open(os.path.join(out, f"{head_key}1_i1.json")) as f:
            i1 = json.load(f)
    except OSError:
        i1 = {}
    losses = main.get("losses") or [0.0]
    head = sum(losses[:10]) / max(len(losses[:10]), 1)
    tail = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    checks = {
        "rc_0": run["rc"] == 0,
        "solo_restart_rank_2": "role-solo-restart rank=2" in run["stderr"],
        "no_gang_restart": "gang restart" not in run["stderr"],
        "generation_0": main.get("generation") == 0,
        "all_steps": main.get("steps") == steps,
        "on_card": str(main.get("device", "")).startswith("cuda"),
        "respawn_produced": i1.get("incarnation") == 1,
        "respawn_reached": 1 in main.get("seen_incarnations", {}).get(
            "1", []),
        "loss_falls": tail < head - margin,
        "dp_msgs": main.get(stats_key, {}).get("dp_msgs", 0) > 0,
        "no_kernel_launch": not any(main.get("kernel_launches",
                                             {"?": 1}).values()),
        "no_nccl": main.get("torch_distributed") is False}
    return main, checks, {"head_loss": head, "tail_loss": tail}


def check_roles(results):
    """The role-graph twins on this card.  ``actor_learner`` under
    ``--roles learner:1,actor:4:solo --solo_restarts 2`` (100 steps, the
    recorder armed) with actor[1] (rank 2) killed at its 3rd batch: the
    launcher exits 0, one solo restart of rank 2 and no gang restart, the
    learner (on the card, cuDNN, no hand-written kernel launched, no NCCL)
    stays in generation 0 for 100 steps with its loss falling by the JAX
    test's margin (1.0), the respawned actor's batches reach it, ``traj``
    carried data-plane frames, and the dumps hold channel put, claim and
    ack events.  ``param_server`` likewise (``server:1,worker:4:solo``, 48
    rounds, margin 0.8, all four workers contributing).  Then the
    ``bench_roles`` twin's channel cells (store and data plane, depth 1 and
    8, 64 KiB to 8 MiB, CUDA payloads), every payload equal.  The two
    graphs run at once.  The actors sleep ``ROLES_ACTOR_THROTTLE`` seconds
    a batch: the learner on the card takes 100 batches faster than a
    killed actor's respawn starts."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_dist_torch import obs
    from tpu_dist_torch.benchmarks.bench_roles import bench_channels
    # the two graphs run at once (ten processes on this machine's cores)
    with ThreadPoolExecutor(max_workers=2) as pool:
        al_f = pool.submit(_roles_run, "learner:1,actor:4:solo",
                           "tpu_dist_torch.examples.actor_learner",
                           ["--actors", "4", "--max-steps", "100",
                            "--actor-throttle", str(ROLES_ACTOR_THROTTLE)],
                           True)
        ps_f = pool.submit(_roles_run, "server:1,worker:4:solo",
                           "tpu_dist_torch.examples.param_server",
                           ["--workers", "4", "--max-steps", "48"], False)
        al, ps = al_f.result(), ps_f.result()
    learner, al_checks, al_loss = _role_checks(
        al, "actor", "learner.json", 4, 100, 1.0, "traj_stats")
    dumps = obs.read_dumps(os.path.join(al["out"], "obs"))
    ops = {e.get("op") for d in dumps for e in d["events"]
           if e.get("kind") == "channel"}
    al_checks["channel_events"] = {"put", "claim", "ack"} <= ops
    server, ps_checks, ps_loss = _role_checks(
        ps, "worker", "server.json", 4, 48, 0.8, "grads_stats")
    ps_checks["all_workers"] = set(server.get("seen_incarnations", {})) \
        == {"0", "1", "2", "3"}
    rows = bench_channels(False, "cuda", check=True)
    cells = [r for r in rows if r["metric"] == "roles_channel_mb_s"]
    ch_ok = bool(cells) and all(r["payload_equal"] for r in cells)
    emit("roles", actor_learner={
        "launcher_wall_s": al["wall_s"], "checks": al_checks, **al_loss,
        "steps_per_sec": learner.get("steps_per_sec"),
        "traj_stats": learner.get("traj_stats"),
        "dumps": len(dumps),
        "stderr_tail": None if all(al_checks.values())
        else al["stderr"][-3000:]},
        param_server={
            "launcher_wall_s": ps["wall_s"], "checks": ps_checks, **ps_loss,
            "steps_per_sec": server.get("steps_per_sec"),
            "grads_stats": server.get("grads_stats"),
            "stderr_tail": None if all(ps_checks.values())
            else ps["stderr"][-3000:]},
        channels={f"{r['path']}/{r['payload_bytes']}/d{r['depth']}":
                  r["value"] for r in cells},
        channels_payload_equal=ch_ok)
    return all(al_checks.values()) and all(ps_checks.values()) and ch_ok


# ---------------------------------------------------------------------------
# The control plane's cluster half and the network chaos layer (slice 15)
# ---------------------------------------------------------------------------

# the JAX e2e's fast failover knobs: leases every 0.2 s, the leader
# condemned after 1 s of dead probes, the follower tailing at 20 ms
CLUSTER_KNOBS = {"TPU_DIST_CLUSTER_LEASE_INTERVAL": "0.2",
                 "TPU_DIST_CLUSTER_LEASE_TTL": "1.0",
                 "TPU_DIST_STORE_REPL_POLL": "0.02",
                 "TPU_DIST_STORE_DOWN_AFTER": "1.0"}
CLUSTER_TIMEOUT = 300        # seconds a launched cluster run may take
# the failover run: the launched path's twin at full width, enough steps
# that well over 5 s of training follow a kill after the first step
FAILOVER_STEPS = 80
FAILOVER_ARGV = LAUNCH_ARGV[:-4] + ["--steps", str(FAILOVER_STEPS),
                                    "--log-every", "1"]
FAILOVER_AFTER_KILL_S = 5.0
# the plans JAX's elastic_plan gives for that run's counts (one host, so
# ties go by node id): the shrink, then the grow
CLUSTER_PLANS = ({0: (0, 1), 1: (1, 0)}, {0: (0, 1), 1: (1, 1)})
NETCHAOS_COLL_TIMEOUT = 5

# the failover run's worker, under ``python -m tpu_dist_torch.launch
# --nproc_per_node=1 --store_endpoints=FILE --heartbeat_timeout ...
# --flight-recorder``: the train_lm twin (argv: OUT STEPS_ARGV...) with the
# dense cell's fused loss (K1, as transformer_lm trains it; the twin's own
# is unfused), a heartbeat every 0.2 s (store requests across the kill),
# each step's wall clock and kernel launches, a marker file after the
# first step, and at the end its losses and the parameters' sha256.
# Writes OUT/g{gen}.json.
FAILOVER_WORKER = """
import importlib, json, os, sys, time
import torch
from tpu_dist_torch import nn, resilience
from tpu_dist_torch.examples import train_lm
from tpu_dist_torch.obs import hooks
from tpu_dist_torch.ops import KERNELS
from tpu_dist_torch.parallel import DistributedDataParallel as DDP
from chip_smoke import _digest
fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
out, argv = sys.argv[1], sys.argv[2:]
gen = os.environ["TPU_DIST_RESTART_COUNT"]
hooks.install_from_env()

class FusedCrossEntropyLoss(nn.CrossEntropyLoss):
    def __init__(self, *a, **k):
        super().__init__(*a, fused=True, **k)

nn.CrossEntropyLoss = FusedCrossEntropyLoss
rec = {"pid": os.getpid(), "steps": [], "gen": gen}
hb = resilience.Heartbeat(interval=0.2).start()
step = DDP.train_step

def timed_step(self, *a, **k):
    for kern in KERNELS:
        kern.launches = 0
    fa.flash_fwd.launches_by_design.update(
        dict.fromkeys(fa.flash_fwd.launches_by_design, 0))
    fa.flash_bwd.launches_by_design.update(
        dict.fromkeys(fa.flash_bwd.launches_by_design, 0))
    t0 = time.time()
    res = step(self, *a, **k)
    torch.cuda.synchronize()
    t1 = time.time()
    rec["steps"].append({
        "t0": t0, "t": t1, "ms": (t1 - t0) * 1e3,
        "launches": {kern.__name__: kern.launches for kern in KERNELS},
        "wgmma": all(set(d) <= {"wgmma"} for d in (
            {k: n for k, n in fa.flash_fwd.launches_by_design.items() if n},
            {k: n for k, n in fa.flash_bwd.launches_by_design.items() if n}))})
    if len(rec["steps"]) == 1:
        with open(os.path.join(out, "first_step"), "w") as f:
            f.write(str(t1))
    return res

DDP.train_step = timed_step
res = train_lm.train(train_lm.parse_args(argv))
hb.stop()
rec.update(losses=res["losses"], params_sha256=_digest(res["state"].params))
with open(os.path.join(out, f"g{gen}.json"), "w") as f:
    json.dump(rec, f)
"""


def _cluster_env(extra=None) -> dict:
    env = dict(os.environ, PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""), PYTHONWARNINGS="ignore",
               OMP_NUM_THREADS="1", **CLUSTER_KNOBS)
    for var in ("TPU_DIST_CHAOS", "TPU_DIST_OBS", "TPU_DIST_OBS_DIR",
                "TPU_DIST_SANITIZE", "TPU_DIST_NETCHAOS", "MASTER_ADDR",
                "MASTER_PORT", "RANK", "WORLD_SIZE", "TPU_DIST_STORE_ADDR",
                "TPU_DIST_STORE_ENDPOINTS", "TPU_DIST_STORE_REPLICATE",
                "TPU_DIST_HOST_TRANSPORT", "TPU_DIST_SHM"):
        env.pop(var, None)
    env.update(extra or {})
    return env


def _popen(args, cwd, env, **kw):
    """A process of its own session (stopped with :func:`_stop`)."""
    return subprocess.Popen([sys.executable, *args], cwd=cwd, env=env,
                            start_new_session=True, text=True, **kw)


def _agent(node_id: int, out: str, lead: bool):
    """``python -m tpu_dist_torch.cluster.agent`` for ``node_id``; waits
    for its readiness file and returns ``(proc, {"port": ...})``."""
    ready = os.path.join(out, f"agent{node_id}.json")
    proc = _popen(["-m", "tpu_dist_torch.cluster.agent", "--node_id",
                   str(node_id), "--endpoints", os.path.join(out, "ep.json"),
                   "--ready_file", ready] + (["--lead"] if lead else []),
                  out, _cluster_env(), stdout=subprocess.PIPE,
                  stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 120
    while not os.path.exists(ready):
        if proc.poll() is not None or time.monotonic() > deadline:
            raise RuntimeError(f"agent {node_id} never became ready")
        time.sleep(0.05)
    time.sleep(0.05)  # the file is written in one call; let it land
    with open(ready) as f:
        return proc, json.load(f)


def _failover_launch(out: str, extra: list, name: str):
    """The failover worker under the launcher with ``extra`` flags; its
    standard error goes to ``OUT/NAME/launcher.log``."""
    os.makedirs(os.path.join(out, name), exist_ok=True)
    with open(os.path.join(out, name, "launcher.log"), "w") as log:
        return _popen(["-m", "tpu_dist_torch.launch", "--nproc_per_node=1",
                       "--master_port=0", "--max_restarts=1",
                       "--restart_backoff=0", *extra,
                       os.path.join(out, "worker.py"),
                       os.path.join(out, name), *FAILOVER_ARGV], out,
                      _cluster_env({"TPU_DIST_OBS_DIR":
                                    os.path.join(out, name, "obs")}),
                      stdout=subprocess.DEVNULL, stderr=log)


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _json(path, default=None):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return default


def check_cluster_failover(results):
    """The store leader SIGKILLed under training: two
    ``python -m tpu_dist_torch.cluster.agent`` processes host the
    replicated store (node 0 ``--lead``, node 1 a follower; the JAX e2e's
    fast knobs), the launched train_lm twin at GPT-2-small width (T = 2048,
    batch 8, bf16, 120 steps) runs under ``--nproc_per_node=1
    --store_endpoints=FILE --max_restarts=1 --flight-recorder
    --heartbeat_timeout=10`` with a heartbeat every 0.2 s, and node 0's
    agent is SIGKILLed after the child's first step.  Checks: the endpoints
    file at epoch 1 naming node 1's replica; the launcher exits 0 with the
    child in generation 0 throughout; at least 5 s of training after the
    kill; the parameters' sha256 equal to an unkilled launch of the same
    seed, run at the same time on this card (so every step shares it);
    every step K1 once (the worker trains with the dense cell's fused loss)
    and K2 12 times, all wgmma; the child's
    recorder holds a ``store``/``failover`` event at epoch 1 and
    ``obs.diagnose`` lists it under ``store_failovers``.  Printed: seconds
    from the SIGKILL to epoch 1, the longest step across the failover
    against the median step."""
    import signal
    import tempfile

    from tpu_dist_torch import obs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="failover_", dir=os.environ.get("TMPDIR"))
    with open(os.path.join(out, "worker.py"), "w") as f:
        f.write(FAILOVER_WORKER)
    ep = os.path.join(out, "ep.json")
    procs = []
    try:
        leader, _ = _agent(0, out, lead=True)
        procs.append(leader)
        follower, foll = _agent(1, out, lead=False)
        procs.append(follower)
        t0 = time.time()
        run = _failover_launch(out, [f"--store_endpoints={ep}",
                                     "--heartbeat_timeout=10",
                                     "--flight-recorder"], "killed")
        procs.append(run)
        # the unkilled launch of the same seed, at once (its own store)
        ref = _failover_launch(out, ["--standalone"], "plain")
        procs.append(ref)
        deadline = time.monotonic() + CLUSTER_TIMEOUT
        marker = os.path.join(out, "killed", "first_step")
        while not os.path.exists(marker):
            if run.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("the launched child never took a step")
            time.sleep(0.02)
        os.kill(leader.pid, signal.SIGKILL)
        t_kill = time.time()
        epoch1_s = None
        while run.poll() is None and time.monotonic() < deadline:
            doc = _json(ep, {})
            if epoch1_s is None and doc.get("epoch") == 1:
                epoch1_s = time.time() - t_kill
            time.sleep(0.02)
        run.wait(timeout=max(1, deadline - time.monotonic()))
        if epoch1_s is None and _json(ep, {}).get("epoch") == 1:
            epoch1_s = time.time() - t_kill   # after the run: an upper bound
        ref.wait(timeout=CLUSTER_TIMEOUT)
        follower.send_signal(signal.SIGTERM)
        agent_out = follower.communicate(timeout=60)[0]
        wall = time.time() - t0
    finally:
        for p in procs:
            _stop(p, grace=5)
    err = _read(os.path.join(out, "killed", "launcher.log"))
    ref_err = _read(os.path.join(out, "plain", "launcher.log"))
    rec = _json(os.path.join(out, "killed", "g0.json"), {})
    plain = _json(os.path.join(out, "plain", "g0.json"), {})
    doc = _json(ep, {})
    steps = rec.get("steps", [])
    ms = [s["ms"] for s in steps[1:]]
    across = [s for s in steps if s["t"] >= t_kill and s["t0"] <= t_kill
              + (epoch1_s or 0) + 2.0]
    dumps = obs.read_dumps(os.path.join(out, "killed", "obs"))
    fo_events = [e for d in dumps for e in d["events"]
                 if e.get("kind") == "store" and e.get("op") == "failover"]
    diag = obs.diagnose(dumps) if dumps else {}
    checks = {
        "epoch_1_names_node1": (doc.get("epoch") == 1 and doc.get("leader")
                                == f"127.0.0.1:{foll['port']}"),
        "launcher_exit_0": run.returncode == 0 and ref.returncode == 0,
        "generation_0_only": (not os.path.exists(
            os.path.join(out, "killed", "g1.json")) and rec.get("gen") == "0"
            and "relaunching" not in err),
        "steps_done": len(steps) == FAILOVER_STEPS
        and len(rec.get("losses", [])) == FAILOVER_STEPS,
        "training_after_kill": bool(steps) and steps[-1]["t"] - t_kill
        >= FAILOVER_AFTER_KILL_S,
        "params_sha256_equal_unkilled": bool(rec) and rec.get(
            "params_sha256") == plain.get("params_sha256")
        and rec.get("losses") == plain.get("losses"),
        "launches_per_step": bool(steps) and all(
            s["launches"] == OBS_PER_STEP and s["wgmma"] for s in steps),
        "recorder_failover_epoch_1": any(e.get("epoch") == 1
                                         for e in fo_events),
        "diagnose_lists_failover": bool(diag.get("store_failovers")),
        "a_client_rode_it": "store-failover old=" in err,
        "agent_promoted": "store-failover-promoted" in agent_out}
    for name in ("cross_entropy_fwd", "cross_entropy_bwd", "flash_fwd",
                 "flash_bwd"):
        results.setdefault(name, {}).setdefault(
            "launches", OBS_PER_STEP[name] * len(steps))
    emit("cluster_failover", argv=FAILOVER_ARGV, knobs=CLUSTER_KNOBS,
         kill_to_epoch1_s=epoch1_s, endpoints=doc,
         step_ms_median=_med(ms), step_ms_max_across_failover=max(
             (s["ms"] for s in across), default=None),
         step_ms_max=max(ms, default=None),
         steps_after_kill=sum(1 for s in steps if s["t0"] >= t_kill),
         launches_seen=sorted({json.dumps(s["launches"], sort_keys=True)
                               for s in steps}),
         train_s_after_kill=(steps[-1]["t"] - t_kill) if steps else None,
         recorder_failovers=fo_events[:4],
         diagnose_store_failovers=diag.get("store_failovers"),
         launcher_wall_s=wall, checks=checks,
         stderr_tail=None if all(checks.values()) else
         (err[-2500:] + "\n--- unkilled ---\n" + ref_err[-1500:]))
    return all(checks.values())


def check_cluster_elastic(results):
    """Two launchers, one rank each on this card (``--nnodes=2
    --nproc_per_node=1 --store_endpoints=FILE --store_replica
    --elastic_world=1:2``), the ``elastic_train`` twin with ``--zero
    --exit-on-preempt`` over the host data plane
    (``TPU_DIST_HOST_TRANSPORT=dataplane``: no NCCL communicator, which
    refuses two ranks on one card), ``TPU_DIST_CHAOS=shrink:rank=1,
    step=20;grow:rank=0,step=35,world=2``: node 1 drops to zero ranks and
    idles, then the gang grows back across the node boundary
    (:mod:`tpu_dist_torch.benchmarks.cluster_elastic`).  Checks: both
    launchers exit 0; the plans both launchers act on are JAX's
    ``elastic_plan`` for those counts, ``{0: (0, 1), 1: (1, 0)}`` then
    ``{0: (0, 1), 1: (1, 1)}``; the world-1 and world-2 phases each equal,
    bit for bit, a single launcher at that world resumed from a copy of the
    same tree.  Printed: seconds from the preemption to the first world-1
    step, from the grow to the first world-2 step."""
    from tpu_dist_torch.benchmarks import cluster_elastic
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    row = cluster_elastic.run(world=2, device="cuda")
    row["plans_are_jax"] = row["plans_acted"] == [
        {str(k): list(v) for k, v in p.items()} for p in CLUSTER_PLANS]
    emit("cluster_elastic", **{k: v for k, v in row.items()
                               if k != "metric"})
    return row["ok"] and row["plans_are_jax"]


# the netchaos phase's worker, under ``python -m tpu_dist_torch.launch
# --standalone --nproc_per_node=2``: both ranks on cuda:0, the group the
# store and the host data plane only (a rank shim, no NCCL).  The dense
# cell's gradients on the rank's seeded row (K1 once, K2 12 times), then
# their 63 MB host_ring subset averaged by a Bucketer over the float32
# host ring.  argv:
# OUT MODE.  MODE ``once``: one sync (the launch's --netchaos decides its
# fate; under --flight-recorder a crash leaves each rank's dump).  ``cells``: an unfaulted sync twice (the second timed), then each
# cell with its fault installed in-process — delay on TCP, a lane broken by
# conn-reset on SHM, then a partition on TCP (the --coll_timeout watchdog
# ends it) — and exits.  Each rank writes OUT/r{rank}.json as it goes: per
# cell the outcome, the named error, the seconds to it, the ms and the
# result's sha256.
NETCHAOS_WORKER = """
import hashlib, json, os, sys, time
import torch
from tpu_dist_torch import dist
from tpu_dist_torch.benchmarks.bench_host_collectives import (
    _Group, attach_store)
from tpu_dist_torch.benchmarks.host_sync import (
    dense_cell, rank_grads, ring_subset)
from tpu_dist_torch.collectives import Bucketer
from tpu_dist_torch.collectives import transport as T
from tpu_dist_torch.obs import hooks
from tpu_dist_torch.ops import KERNELS
from tpu_dist_torch.resilience import netchaos

out, mode = sys.argv[1], sys.argv[2]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
rec = hooks.install_from_env()     # --flight-recorder: dumps on a crash
if rec is not None:
    rec.rank, rec.world = rank, world
torch.cuda.set_device(0)
dist.init_process_group(device="cuda:0")    # world 1: the model's group
store = attach_store(os.environ["TPU_DIST_STORE_ADDR"])
group = _Group(rank, world)
ddp, state = dense_cell(device="cuda:0", batch=1)
for k in KERNELS:
    k.launches = 0
# HOST_RING_BLOCKS's subset: blocks 0-1 and the leaves outside the blocks
grads = ring_subset(rank_grads(ddp, state, rank, batch=1), 2)
torch.cuda.synchronize()
log = {"rank": rank, "launches": {k.__name__: k.launches for k in KERNELS},
       "bytes": sum(v.numel() * v.element_size() for v in grads.values()),
       "cells": {}}
bucketer = Bucketer()

def flush():
    with open(os.path.join(out, f"r{rank}.json"), "w") as f:
        json.dump(log, f)

def cell(name, spec=None, shm=False):
    os.environ["TPU_DIST_SHM"] = "auto" if shm else "0"
    if spec:
        netchaos.install(spec, rank=rank)
    else:
        netchaos.uninstall()
    store.barrier(world, tag=f"cell/{name}", timeout=300)
    row = {"spec": spec, "shm": shm}
    t0 = time.perf_counter()
    try:
        res = bucketer.all_reduce(grads, op="avg", group=group).wait_all(600)
        torch.cuda.synchronize()
        row["ms"] = (time.perf_counter() - t0) * 1e3
        h = hashlib.sha256()
        for k in sorted(res):
            h.update(res[k].detach().cpu().contiguous().view(
                torch.uint8).numpy())
        row.update(outcome="completed", sha256=h.hexdigest())
        if shm:
            dp = T.get_data_plane(store, rank, world)
            row["shm_active_after"] = bool(dp.shm_active((rank + 1) % world))
    except Exception as e:
        row.update(outcome="error", error=type(e).__name__,
                   detail=str(e)[:1500], seconds=time.perf_counter() - t0)
        for f in ("peer", "tag", "offset", "expected", "got"):
            if hasattr(e, f):
                row[f] = getattr(e, f)
        log["cells"][name] = row
        flush()
        raise
    finally:
        netchaos.uninstall()
    log["cells"][name] = row
    flush()

if mode == "once":
    cell("once", spec=os.environ.get("TPU_DIST_NETCHAOS"))
    log["result"] = log["cells"]["once"]["sha256"]
    flush()
    store.barrier(world, tag="nc-exit", timeout=120)
    os._exit(0)
cell("warm")
cell("unfaulted")
cell("delay", "delay:surface=tcp,delay=0.002")
cell("shm_conn_reset", "conn-reset:surface=shm,rank=0,frame=1", shm=True)
try:
    cell("partition", "partition:surface=tcp,rank=1,peer=0")
except Exception:
    pass
os._exit(0)
"""


def _netchaos_launch(out: str, name: str, mode: str, flags: list):
    os.makedirs(os.path.join(out, name), exist_ok=True)
    return _popen(["-m", "tpu_dist_torch.launch", "--standalone",
                   "--nproc_per_node=2", "--master_port=0", *flags,
                   os.path.join(out, "worker.py"), os.path.join(out, name),
                   mode], out, _cluster_env({"TPU_DIST_OBS_DIR": os.path.join(
                       out, name, "obs")}), stderr=subprocess.PIPE)


def _corrupt_frames(obs_dir: str) -> list:
    """The corrupt frames the ranks' readers named, from their dumps: the
    reader that refuses a frame marks its peer gone with the
    ``FrameCorruptError`` (a ``transport``/``peer-gone`` event, outcome
    ``error:FrameCorrupt``), whatever error the rank's own thread then
    meets first (in a two-rank ring, usually its next send's reset)."""
    import re
    from tpu_dist_torch import obs
    named = []
    for d in obs.read_dumps(obs_dir):
        for e in d["events"]:
            if (e.get("kind") == "transport" and e.get("op") == "peer-gone"
                    and e.get("outcome") == "error:FrameCorrupt"):
                detail = e.get("detail", "")
                m = re.search(r"corrupt frame from rank (\d+) tag '([^']*)'"
                              r".*stream offset (\d+)", detail)
                if "FrameCorruptError" not in detail:
                    m = None
                named.append({"rank": d["rank"], "src": int(m.group(1))
                              if m else None, "tag": m and m.group(2),
                              "offset": int(m.group(3)) if m else None})
    return named


def _serve_corrupt_cell() -> dict:
    """``corrupt:surface=serve`` on the full-width served model: 8 of
    :func:`smoke_requests` submitted at once through ServeClient → socket →
    Frontend, the first frame (the first submit) flipped on the wire.
    Every request must end in a named error, at its submit or on its
    handle, within the bound; none may be silently dropped."""
    from tpu_dist_torch import serve
    from tpu_dist_torch.resilience import netchaos
    model = _serve_model()
    engine = serve.SlotEngine(model, num_slots=8, max_len=2048,
                              device=model.device)
    sched = serve.Scheduler(engine, batch_window=0.002)
    fe = serve.Frontend(sched, port=0)
    rows = []
    try:
        cli = serve.ServeClient("127.0.0.1", fe.port, connect_retry=10,
                                timeout=60)
        try:
            netchaos.install("corrupt:surface=serve,frame=1")
            t0 = time.perf_counter()
            handles = []
            for r in smoke_requests()[:8]:
                try:
                    handles.append(cli.submit(
                        r["prompt"].tolist(),
                        max_new_tokens=r["max_new_tokens"],
                        temperature=r["temperature"], seed=r["seed"]))
                except Exception as e:
                    handles.append(e)
            for h in handles:
                if isinstance(h, Exception):
                    rows.append({"at": "submit", "error": type(h).__name__,
                                 "s": time.perf_counter() - t0})
                    continue
                try:
                    h.wait_done(30.0)
                    rows.append({"at": "done", "error": None,
                                 "s": time.perf_counter() - t0})
                except Exception as e:
                    rows.append({"at": "handle", "error": type(e).__name__,
                                 "detail": str(e)[:200],
                                 "s": time.perf_counter() - t0})
        finally:
            netchaos.uninstall()
            cli.close()
    finally:
        fe.close()
        sched.close()
    return {"requests": rows}


def _netchaos_corrupt() -> bool:
    """The network chaos layer's corrupt frames, a check of function (the
    ``faults`` phase runs it beside other fault launches):

    - ``corrupt:surface=tcp,rank=1,frame=2`` (``--netchaos``, SHM off) on
      the dense cell's float32 gradients (K1 once, K2 12 times; their 63 MB
      host_ring subset) at world 2, two rank processes on this card: a
      ``FrameCorruptError`` naming src 1, the tag and the offset; the
      launcher exits non-zero and no rank returns a result;
    - beside it, ``corrupt:surface=serve`` on the full-width served model
      with 8 of :func:`smoke_requests`: every request ends in a named
      error.

    Printed: the named errors and the seconds to them."""
    import tempfile
    out = tempfile.mkdtemp(prefix="netchaos_corrupt_",
                           dir=os.environ.get("TMPDIR"))
    with open(os.path.join(out, "worker.py"), "w") as f:
        f.write(NETCHAOS_WORKER)
    corrupt = _netchaos_launch(
        out, "corrupt", "once",
        ["--netchaos=corrupt:surface=tcp,rank=1,frame=2",
         "--flight-recorder"])
    try:
        serve_cell = _serve_corrupt_cell()   # beside the corrupt launch
        _, corrupt_err = corrupt.communicate(timeout=CLUSTER_TIMEOUT)
    finally:
        _stop(corrupt, grace=5)
    cr = [_json(os.path.join(out, "corrupt", f"r{r}.json"), {})
          for r in range(2)]
    named = [c["cells"].get("once", {}) for c in cr if c]
    fce = _corrupt_frames(os.path.join(out, "corrupt", "obs"))
    checks = {
        "corrupt_named": bool(fce) and all(
            r["rank"] == 0 and r["src"] == 1 and r["tag"]
            and r["offset"] is not None and r["offset"] >= 0 for r in fce),
        "corrupt_launcher_failed": corrupt.returncode not in (0, None),
        "corrupt_no_result": not any("result" in c for c in cr),
        "serve_every_request_named": len(serve_cell["requests"]) == 8
        and all(r["error"] in ("ServerGoneError", "RequestFailedError")
                and r["s"] <= 60 for r in serve_cell["requests"]),
        "launches_per_rank": all(c.get("launches") == OBS_PER_STEP
                                 for c in cr if c)}
    emit("netchaos_corrupt", world=2,
         corrupt={"launcher_rc": corrupt.returncode, "named": fce,
                  "ranks": [{k: r.get(k) for k in ("outcome", "error",
                                                   "detail", "seconds")}
                            for r in named]},
         serve=serve_cell, checks=checks,
         stderr_tail=None if all(checks.values())
         else corrupt_err[-3000:])
    return all(checks.values())


def check_netchaos(results):
    """The network chaos layer's cells on the dense cell's float32
    gradients (K1 once, K2 12 times a step; their 63 MB host_ring subset)
    at world 2, two rank processes on this card averaged by a Bucketer on
    the float32 host ring, in one ``--coll_timeout`` launch
    (``NETCHAOS_COLL_TIMEOUT``): after an unfaulted sync (SHM off),
    ``delay:surface=tcp,delay=0.002`` byte-identical;
    ``conn-reset:surface=shm,rank=0,frame=1`` (lanes on) breaks the lane
    and is byte-identical; ``partition:surface=tcp,rank=1,peer=0`` a
    ``CollectiveTimeoutError`` naming the stalled hop within the timeout
    plus 5 s.  (The corrupt frames: the ``faults`` phase.)  Printed: each
    cell's outcome, the named error and the seconds to it, and the
    completed syncs' ms beside the unfaulted one."""
    import tempfile
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="netchaos_", dir=os.environ.get("TMPDIR"))
    with open(os.path.join(out, "worker.py"), "w") as f:
        f.write(NETCHAOS_WORKER)
    t0 = time.time()
    cells = _netchaos_launch(
        out, "cells", "cells", [f"--coll_timeout={NETCHAOS_COLL_TIMEOUT}"])
    try:
        _, cells_err = cells.communicate(timeout=CLUSTER_TIMEOUT)
    finally:
        _stop(cells, grace=5)
    wall = time.time() - t0
    cl = [_json(os.path.join(out, "cells", f"r{r}.json"), {})
          for r in range(2)]
    cells_of = [c.get("cells", {}) for c in cl]

    def cell(name):
        return [c.get(name, {}) for c in cells_of]

    base = cell("unfaulted")
    want = {r.get("sha256") for r in base}

    def identical(name):
        rows = cell(name)
        return (all(r.get("outcome") == "completed" for r in rows)
                and {r.get("sha256") for r in rows} == want
                and len(want) == 1 and None not in want)

    part = cell("partition")
    checks = {
        "unfaulted_ranks_agree": len(want) == 1 and None not in want,
        "delay_byte_identical": identical("delay"),
        "shm_reset_byte_identical": identical("shm_conn_reset"),
        "shm_lane_broken": cell("shm_conn_reset")[0].get(
            "shm_active_after") is False,
        "partition_named": all(
            r.get("error") == "CollectiveTimeoutError"
            and "stalled hop" in r.get("detail", "") for r in part),
        "partition_bounded": all(
            r.get("seconds", 1e9) <= NETCHAOS_COLL_TIMEOUT + 5
            for r in part),
        "launches_per_rank": all(c.get("launches") == OBS_PER_STEP
                                 for c in cl if c)}
    emit("netchaos", world=2, bytes_per_rank=(cl[0] or {}).get("bytes"),
         cells={name: [{k: r.get(k) for k in (
             "spec", "outcome", "error", "seconds", "ms",
             "shm_active_after", "detail")} for r in cell(name)]
             for name in ("unfaulted", "delay", "shm_conn_reset",
                          "partition")},
         sync_ms={name: [r.get("ms") for r in cell(name)]
                  for name in ("unfaulted", "delay", "shm_conn_reset")},
         wall_s=wall, checks=checks,
         stderr_tail=None if all(checks.values()) else cells_err[-3000:])
    return all(checks.values())


# ---------------------------------------------------------------------------
# multi-rank serving: the tensor-parallel group and disaggregated serving
# ---------------------------------------------------------------------------

SHARD_WORLD = 2              # rank processes of the serve_sharded group
SHARD_REQUESTS = 16          # bench_serve's _mixed_requests
SHARD_TIMEOUT = 600          # seconds a shard group's job may take
SHARD_KILL_BOUND_S = 5.0     # follower SIGKILL -> every request failed
SHARD_READ_SLACK = 1 << 20   # bytes a range-read may read beyond its data
DISAGG_KV_TIMEOUT = "1.5"    # TPU_DIST_KV_TIMEOUT of the serve_disagg launch
DISAGG_PREFIX = 36           # tokens the prefix-sharing requests share


def _shard_group(job: dict, kill: bool = False):
    """``job`` (``benchmarks/serve_lm.py``'s shard worker) on
    :data:`SHARD_WORLD` rank processes sharing this card; with ``kill`` the
    follower is SIGKILLed once the leader marks its requests streaming.
    Returns the ranks' records, exit codes, the kill's wall-clock time and
    the job's seconds."""
    from tpu_dist_torch.benchmarks.serve_lm import (_wait_all,
                                                    spawn_shard_world)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the ranks share the card with this process
    t0 = time.time()
    store, procs = spawn_shard_world(job, SHARD_WORLD, job["out"])
    t_kill = None
    try:
        if kill:
            ready = os.path.join(job["out"], "ready.json")
            deadline = time.monotonic() + SHARD_TIMEOUT
            while (not os.path.exists(ready) and procs[0].poll() is None
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            t_kill = time.time()
            procs[1].kill()
        rcs = _wait_all(procs, SHARD_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store.close()
    recs = {}
    for r in range(SHARD_WORLD):
        try:
            with open(os.path.join(job["out"], f"r{r}.json")) as f:
                recs[r] = json.load(f)
        except (OSError, ValueError):
            recs[r] = {}
    return recs, rcs, t_kill, time.time() - t0


def _shard_requests():
    """16 greedy ``_mixed_requests`` and the benchmark's two greedy
    ``long_requests`` (1536- and 768-token prompts, whose prefill partials
    take the ring), and two sampled requests (the first two mixed prompts
    at temperature 0.8, seeds 1 and 2)."""
    from tpu_dist_torch.benchmarks.serve_lm import (CONFIG, long_requests,
                                                    mixed_requests)
    mixed = mixed_requests(SHARD_REQUESTS)
    greedy = mixed + long_requests(CONFIG["max_seq_len"],
                                   CONFIG["vocab_size"])
    sampled = [dict(r, temperature=0.8, seed=i + 1)
               for i, r in enumerate(mixed[:2])]
    return greedy, sampled


def check_serve_sharded(results):
    """The served model as a world-2 tensor-parallel group on this card;
    see the module docstring, item 18."""
    import tempfile

    from tpu_dist_torch import checkpoint, interop, serve
    from tpu_dist_torch.benchmarks.serve_lm import (CONFIG, _requests_json,
                                                    drive_engine)

    model = _serve_model()
    greedy, sampled = _shard_requests()
    out = tempfile.mkdtemp(prefix="serve_sharded_",
                           dir=os.environ.get("TMPDIR"))
    # the single-rank engine on the same requests: its decode step and the
    # sampled requests' streams
    engine = serve.SlotEngine(model, num_slots=8, max_len=2048,
                              device=model.device)
    zero_launch_counts()
    drive_engine(engine, greedy[:2])
    single = drive_engine(engine, greedy)
    single_sampled = drive_engine(engine, sampled)["outputs"]
    del engine
    t0 = time.perf_counter()
    ckpt = os.path.join(out, "ckpt")
    checkpoint.save(ckpt, interop.jax_params(model), step=0)
    save_s = time.perf_counter() - t0
    job = dict(config=CONFIG, device="cuda", slots=8, max_len=2048)
    a, rc_a, _, wall_a = _shard_group(dict(
        job, out=os.path.join(out, "exact"), ckpt=ckpt,
        runs={"greedy": _requests_json(greedy),
              "sampled": _requests_json(sampled)}))
    b, rc_b, t_kill, wall_b = _shard_group(dict(
        job, out=os.path.join(out, "int8"), comm_dtype="int8_block256",
        runs={"int8": _requests_json(greedy[:4])},
        kill=_requests_json([dict(r, max_new_tokens=512)
                             for r in greedy[4:8]])), kill=True)
    lead = a[0].get("runs", {})
    got = lead.get("greedy", {}).get("outputs", [])
    want = [_generate(model, r, torch.float32) for r in greedy]
    vs_gen = _tie_rule(model, greedy, got, want, torch.float32,
                       "sharded_generate") if got else []
    got_s = lead.get("sampled", {}).get("outputs", [])
    vs_single = _tie_rule(model, sampled, got_s, single_sampled,
                          torch.float32, "sharded_single_engine") \
        if got_s else []
    int8 = b[0].get("runs", {}).get("int8", {}).get("outputs", [])
    ends = b[0].get("ends", [])
    end_s = [e["t"] - t_kill for e in ends] if t_kill else []
    checks = {
        "exact_job_exit_codes": rc_a == [0] * SHARD_WORLD,
        "kill_job_exit_codes": rc_b[0] == 0 and rc_b[1] == -9,
        "checkpoint_shards_bit_for_bit": all(
            a[r].get("ckpt_equal") is True for r in range(SHARD_WORLD)),
        "checkpoint_reads_own_bytes": all(
            0 <= a[r].get("ckpt_read_bytes", -1)
            <= a[r].get("shard_bytes", 0) + SHARD_READ_SLACK
            for r in range(SHARD_WORLD)),
        "greedy_equals_generate": len(vs_gen) == len(greedy) and all(
            ok for _, ok, _ in vs_gen),
        "sampled_equals_single_engine": len(vs_single) == len(sampled)
        and all(ok for _, ok, _ in vs_single),
        "follower_streams_equal_leader": bool(a[0].get("finished_all"))
        and a[1].get("streams") == a[0].get("finished_all"),
        # the long prompts' prefill partials (> 128 KiB) took the ring
        "ring_combines_taken": a[0].get("algo_counts", {}).get("ring", 0)
        > 0,
        "int8_full_budgets_in_vocab": [len(t) for t in int8] == [
            r["max_new_tokens"] for r in greedy[:4]] and all(
            0 <= x < CONFIG["vocab_size"] for t in int8 for x in t),
        "int8_follower_streams_equal_leader": bool(
            b[0].get("finished_all"))
        and b[1].get("streams") == b[0].get("finished_all"),
        "kill_named_peer_gone": b[0].get("fatal") == "PeerGoneError"
        and len(ends) == 4 and all(
            "PeerGoneError" in (e["outcome"] + e.get("message", ""))
            for e in ends),
        "kill_within_bound": bool(end_s)
        and max(end_s) <= SHARD_KILL_BOUND_S,
        "no_kernel_launch": all(
            not any(rec.get("kernel_launches", {"x": 1}).values())
            for rec in (a[0], a[1], b[0])),
    }
    g = lead.get("greedy", {})
    algo = a[0].get("algo_counts", {})
    emit("serve_sharded", world=SHARD_WORLD, requests=len(greedy),
         prompt_lens=[len(r["prompt"]) for r in greedy],
         max_new_tokens=[r["max_new_tokens"] for r in greedy],
         checkpoint_save_s=save_s,
         checkpoint={r: {k: a[r].get(k) for k in (
             "ckpt_s", "ckpt_read_bytes", "shard_bytes", "ckpt_leaves")}
             for r in range(SHARD_WORLD)},
         tokens_per_s=g.get("tokens_per_s"),
         decode_step_p50_ms=g.get("decode_step_p50_ms"),
         decode_step_p99_ms=g.get("decode_step_p99_ms"),
         e2e_p50_ms=g.get("e2e_p50_ms"), e2e_p99_ms=g.get("e2e_p99_ms"),
         single_rank=dict(tokens_per_s=single["tokens_per_s"],
                          decode_step_p50_ms=single["decode_step_p50_ms"],
                          decode_step_p99_ms=single["decode_step_p99_ms"]),
         combines=algo, exchange_share=(
             algo.get("exchange", 0) / max(1, sum(algo.values()))),
         int8_combines=b[0].get("algo_counts"),
         divergent_vs_generate=[i for i, _, d in vs_gen if d],
         divergent_sampled=[i for i, _, d in vs_single if d],
         kill_ends=[{k: e.get(k) for k in ("outcome", "message")}
                    for e in ends], kill_to_ended_s=end_s,
         kill_bound_s=SHARD_KILL_BOUND_S,
         kernel_launches={r: a[r].get("kernel_launches")
                          for r in range(SHARD_WORLD)},
         job_seconds=[wall_a, wall_b], exit_codes=[rc_a, rc_b],
         checks=checks)
    return all(checks.values())


def _disagg_requests():
    """Three requests sharing a :data:`DISAGG_PREFIX`-token prefix (12-token
    suffixes) and three of :func:`_gateway_requests`, 32 new tokens each,
    greedy, from ``np.random.default_rng(2)``."""
    import numpy as np

    rng = np.random.default_rng(2)
    shared = rng.integers(0, 32768, DISAGG_PREFIX)
    reqs = [{"prompt": np.concatenate([shared, rng.integers(0, 32768, 12)])
             .astype(np.int32), "max_new_tokens": 32, "temperature": 0.0,
             "seed": 0} for _ in range(3)]
    reqs += [dict(r, max_new_tokens=32) for r in _gateway_requests()[:3]]
    return reqs


def check_serve_disagg(results):
    """``--roles prefill:1:solo,decode:1`` of the serve_lm twin with
    ``--disagg`` on this card, through the gateway; then the disagg
    benchmark's rows in this process; see the module docstring, item
    18."""
    import signal
    import socket
    import tempfile

    from tpu_dist_torch import serve
    from tpu_dist_torch.benchmarks.serve_lm import run_disagg
    from tpu_dist_torch.ops import KERNELS

    model = _serve_model()
    reqs = _disagg_requests()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="serve_disagg_",
                           dir=os.environ.get("TMPDIR"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pid_file = os.path.join(out, "worker.pid")
    log = open(os.path.join(out, "launcher.log"), "w")
    os.environ["TPU_DIST_KV_TIMEOUT"] = DISAGG_KV_TIMEOUT
    try:
        proc = _launcher(["--standalone", "--max_restarts=0", "--serve",
                          f"--serve_port={port}", "--roles",
                          "prefill:1:solo,decode:1", "-m",
                          "tpu_dist_torch.examples.serve_lm", *GATEWAY_ARGV,
                          "--disagg", "--pid-file", pid_file,
                          "--run-seconds", "900"],
                         out, stdout=log, stderr=subprocess.STDOUT)
    finally:
        os.environ.pop("TPU_DIST_KV_TIMEOUT", None)
    cli = None
    got, stats, fail, fail_s, after = [], {}, None, None, {}
    role_counts, t_served = {}, None
    warm, ready_s, served_s = [], None, None
    try:
        t0 = time.perf_counter()
        # each rank writes its pid file once it is up, the prefill rank
        # after its first forward: before that, a request's 1.5 s transfer
        # deadline would pay the process's one-time CUDA costs
        deadline = time.monotonic() + LAUNCH_TIMEOUT
        while not all(os.path.exists(p) for p in (pid_file,
                                                   pid_file + ".r1")):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("the disagg roles never came up")
            time.sleep(0.05)
        cli = serve.ServeClient("127.0.0.1", port, connect_retry=120,
                                timeout=60)
        warm = cli.submit(reqs[3]["prompt"][:16].tolist(),
                          max_new_tokens=4).wait_done(GATEWAY_WAIT)
        ready_s = time.perf_counter() - t0
        # one at a time: the prefix-sharing requests hit what the first
        # of them cached
        t1 = time.perf_counter()
        got = [cli.submit(r["prompt"].tolist(),
                          max_new_tokens=r["max_new_tokens"])
               .wait_done(GATEWAY_WAIT) for r in reqs]
        served_s = time.perf_counter() - t1
        stats = cli.stats(timeout=60)["backends"]["default"]
        # both roles' launch counts, written after the served requests
        t_served = time.time()
        time.sleep(0.6)
        for role, path in (("prefill", pid_file),
                           ("decode", pid_file + ".r1")):
            with open(path + ".kernels") as f:
                role_counts[role] = json.load(f)
        # SIGKILL the prefill rank (rank 0: its solo restart takes longer
        # than the two deadlines), then a request that needs it
        with open(pid_file) as f:
            os.kill(int(f.read()), signal.SIGKILL)
        t_kill = time.perf_counter()
        try:
            cli.submit(reqs[0]["prompt"][::-1].tolist(),
                       max_new_tokens=8).wait_done(GATEWAY_WAIT)
        except serve.RequestFailedError as e:
            fail = {"error": e.error, "message": str(e)[:400]}
        fail_s = time.perf_counter() - t_kill
        after = cli.stats(timeout=60)["backends"].get("default", {})
    except Exception:   # reported with the launcher's log below
        traceback.print_exc()
    finally:
        if cli is not None:
            cli.close()
        _stop(proc)
        log.close()
    with open(os.path.join(out, "launcher.log")) as f:
        log_tail = f.read()[-3000:]
    want = [_generate(model, r, torch.float32) for r in reqs]
    vs_gen = _tie_rule(model, reqs, got, want, torch.float32,
                       "disagg_generate") if got else []
    prompt_tokens = 16 + sum(len(r["prompt"]) for r in reqs)
    kv, pc = stats.get("kv", {}), stats.get("prefix_cache", {})
    # the benchmark's rows on this card, in this process
    zero_launch_counts()
    bench = run_disagg(device="cuda", repeats=1, model=model)
    launches = {k.__name__: k.launches for k in KERNELS}
    rows = {r["metric"] + ("_" + r["mode"] if "mode" in r else ""): r
            for r in bench["rows"]}
    dis = rows.get("serve_disagg_bursty_disagg", {})
    checks = {
        "greedy_equals_generate": len(vs_gen) == len(reqs) and all(
            ok for _, ok, _ in vs_gen),
        "transfers_counted": kv.get("transfers") == len(reqs) + 1,
        "prefix_hits": pc.get("hits", 0) >= 2,
        "fewer_prefilled_than_prompt": 0 < prompt_tokens
        - pc.get("tokens_saved", 0) < prompt_tokens,
        "kill_redispatched_once": after.get("kv", {}).get(
            "redispatches", 0) - kv.get("redispatches", 0) == 1,
        "kill_named_kv_transfer_error": fail is not None
        and fail["error"] == "KVTransferError"
        and "after one re-dispatch" in fail["message"]
        and "request " in fail["message"],
        "no_kernel_launch_roles": len(role_counts) == 2 and all(
            c["t"] >= t_served and c["kernel_launches"]
            and not any(c["kernel_launches"].values())
            for c in role_counts.values()),
        "no_kernel_launch_bench": not any(launches.values()),
    }
    emit("serve_disagg", requests=len(reqs),
         prompt_lens=[len(r["prompt"]) for r in reqs], ready_s=ready_s,
         warm_tokens=len(warm), served_s=served_s,
         kv=kv, prefix_cache=pc, prompt_tokens=prompt_tokens,
         transfer_p50_ms=stats.get("transfer", {}).get("p50", 0) * 1e3,
         transfer_max_ms=stats.get("transfer", {}).get("max", 0) * 1e3,
         divergent_vs_generate=[i for i, _, d in vs_gen if d],
         kill_failure=fail, kill_to_failed_s=fail_s,
         redispatches_after_kill=after.get("kv", {}).get("redispatches"),
         kv_timeout_s=float(DISAGG_KV_TIMEOUT), launcher_rc=proc.returncode,
         bursty_unified=rows.get("serve_disagg_bursty_unified"),
         bursty_disagg=dis,
         bursty_ratio=rows.get("serve_disagg_bursty_vs_unified"),
         send_ms_p50=dis.get("send_ms_p50"),
         send_mb_per_s=dis.get("send_mb_per_s"),
         prefix_heavy=rows.get("serve_disagg_prefix_heavy"),
         role_kernel_launches={k: c["kernel_launches"]
                               for k, c in role_counts.items()},
         kernel_launches=launches, checks=checks,
         launcher_log_tail=None if all(checks.values()) else log_tail)
    return all(checks.values())


# ---------------------------------------------------------------------------
# Expert parallelism (slice 17)
# ---------------------------------------------------------------------------

# world: ((data, expert) mesh, backend): two rank processes on one card
# over gloo (two ranks on one card cannot share an NCCL communicator), or
# four on four cards over NCCL (--ep-world 4)
EP_WORLDS = {2: ((1, 2), "gloo"), 4: ((2, 2), "nccl")}
EP_WORLD = [2]               # set by --ep-world
# the compute dtypes each world's ranks are held to world 1 in: bf16, the
# configuration's, and on four cards also float32 (first: the bf16 split is
# held to its updates by SPLIT_BF16_TOL, ROADMAP C13), where a rank's
# smaller matmuls round alike and no near-tie of the router flips an expert
# choice
EP_DTYPES = {2: ("bfloat16",), 4: ("float32", "bfloat16")}
EP_F32_TOL = {
    "loss_rtol": 1e-5, "update_rel": 1e-3, "attn_leaf_update_rel": 1e-3,
    "leaf_update_rel": 1e-2,
    "why": "float32 compute with TF32 off on both paths: a rank's matmuls "
           "over half the rows may differ from world 1's in the last bits "
           "(float32 epsilon 1.2e-7), and a LayerNorm gain's gradient "
           "cancels over 16384 tokens"}
EP_STEPS = 3
EP_TIMEOUT = 600             # seconds the ranks may take
EP_PER_STEP = {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
               "flash_fwd": 12, "flash_bwd": 12, "gmm": 0, "tgmm": 0}
EP_BANKS = ("w1", "b1", "w2", "b2")

# a rank of the ep_train phase (env:// under a control-plane store this
# process hosts; RANK, WORLD_SIZE, LOCAL_RANK set): the JAX moe_lm
# configuration through benchmarks.moe_lm.ep_steps (the library's
# GSPMD step) on a (data, expert) mesh, gloo with both ranks on cuda:0 or
# NCCL with a card a rank (gloo stages CUDA tensors through the host).
# First the collectives the layer and the step take, each on CUDA tensors;
# then the steps, with the launch counts zeroed just before; then one more
# step with every ops.psum (the combine's collectives, forward and
# backward) timed between card synchronizations.  argv: OUT [MESH, STEPS,
# BANKS, BACKEND, DTYPE].  Writes OUT/r{rank}.json; the ranks of data
# index 0 write the updates of the leaves they report (expert index 0: all
# of its own; the others: their expert banks) to OUT/upd{rank}.pt, and the
# ranks of expert index 0 their shard's step-1 expert choices to
# OUT/gate{rank}.pt.
EP_WORKER = """
import hashlib, json, os, sys, time
import numpy as np
import torch
from tpu_dist_torch import dist
from tpu_dist_torch.benchmarks.moe_lm import ep_steps
from tpu_dist_torch.collectives import ops
from tpu_dist_torch.ops import KERNELS

out = sys.argv[1]
mesh, steps, banks, backend, compute = json.loads(sys.argv[2])
pg = dist.init_process_group(
    backend=backend, init_method="env://", device="cuda",
    axis_names=("data", "expert"), mesh_shape=mesh)
rank, world = pg.rank, pg.size()
data_index = pg.axis_group("data").index
expert_index = pg.axis_group("expert").index
probe = {}
for name, dtype, fn in (
        ("all_reduce_bf16", torch.bfloat16, torch.distributed.all_reduce),
        ("all_reduce_f32", torch.float32, torch.distributed.all_reduce),
        ("all_reduce_i64", torch.int64, torch.distributed.all_reduce),
        ("all_gather_into_tensor_i32", torch.int32, None)):
    t = torch.full((6,), rank + 1, dtype=dtype, device=pg.device)
    try:
        if fn is None:
            o = t.new_empty(6 * world)
            torch.distributed.all_gather_into_tensor(o, t)
            probe[name] = o.tolist() == [r + 1 for r in range(world)
                                         for _ in range(6)]
        else:
            fn(t)
            probe[name] = t.tolist() == [world * (world + 1) // 2] * 6
    except Exception as e:       # recorded: the phase fails on a missing one
        probe[name] = repr(e)[:300]
for k in KERNELS:
    k.launches = 0
    for by in ("launches_by_design", "launches_by_mode"):
        if hasattr(k, by):
            getattr(k, by).update(dict.fromkeys(getattr(k, by), 0))
res = ep_steps(steps=steps, compute_dtype=getattr(torch, compute))
counts = {k.__name__: k.launches for k in KERNELS}
by_design = {k.__name__: dict(k.launches_by_design)
             for k in KERNELS if hasattr(k, "launches_by_design")}
spent = [0.0, 0, 0]
psum = ops.psum

def timed_psum(x, group=None):
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        return psum(x, group)
    finally:
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        spent[1] += 1
        spent[2] += x.numel() * x.element_size()

ops.psum = timed_psum
g = np.random.default_rng(1)
per = 8 // mesh[0]
x = torch.from_numpy(g.integers(0, 32768, (8, 2048))[
    data_index * per:(data_index + 1) * per]).to(pg.device)
torch.cuda.synchronize()
t0 = time.perf_counter()
res["advance"](res["state"], x, x)
torch.cuda.synchronize()
timed_ms = (time.perf_counter() - t0) * 1e3
ops.psum = psum
params = res["state"]["params"]
h = hashlib.sha256()
for k in sorted(params):
    if k.rpartition(".")[2] not in banks:
        h.update(params[k].detach().cpu().numpy().tobytes())
if data_index == 0:
    torch.save({k: v.float().cpu() for k, v in res["updates"].items()
                if expert_index == 0 or k.rpartition(".")[2] in banks},
               os.path.join(out, f"upd{rank}.pt"))
if expert_index == 0:
    torch.save(res["gate_idx_step1"], os.path.join(out, f"gate{rank}.pt"))
model = res["model"]
moe = [m for m in model.modules() if hasattr(m, "local_experts")]
with open(os.path.join(out, f"r{rank}.json"), "w") as f:
    json.dump({"probe": probe, "losses": res["losses"],
               "step_ms": res["step_ms"],
               "dropped_step1": res["dropped_step1"],
               "expert_bytes": res["expert_bytes"],
               "peak_mem_bytes": res["peak_mem_bytes"],
               "aux_losses": res["aux_losses"], "launches": counts,
               "launches_by_design": by_design,
               "experts_held": [moe[0].first_expert, moe[0].local_experts],
               "combine_ms": spent[0] * 1e3, "combine_calls": spent[1],
               "combine_bytes": spent[2], "timed_step_ms": timed_ms,
               "replicated_digest": h.hexdigest()}, f)
dist.destroy_process_group()
"""


def _ep_ranks(out: str, world: int, dtype: str) -> tuple:
    """Start the ep_train ranks and wait for them: ``(return codes,
    seconds, stderr tails)``; every process they started is stopped.  This
    process hosts their control-plane store (``TPU_DIST_STORE_ADDR``), so
    rank 0 binds torch's store on a port the OS picks and publishes it
    there (``dist/process_group._published_store``): no port is picked
    here and bound later by a child."""
    import signal

    from tpu_dist_torch.dist.store import TCPStore

    mesh, backend = EP_WORLDS[world]
    store = TCPStore(is_master=True, timeout=EP_TIMEOUT)
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(store.port), WORLD_SIZE=str(world),
               TPU_DIST_STORE_ADDR=f"127.0.0.1:{store.port}",
               PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", EP_WORKER, out,
         json.dumps([mesh, EP_STEPS, EP_BANKS, backend, dtype])],
        cwd=out, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(world)]
    errs = []
    try:
        for p in procs:
            try:
                errs.append(p.communicate(timeout=EP_TIMEOUT)[1][-3000:])
            except subprocess.TimeoutExpired:
                errs.append("timed out")
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
            p.wait(timeout=30)
        store.close()
    return [p.returncode for p in procs], time.perf_counter() - t0, errs


def _ep_compare(world: int, dtype: str, f32_updates=None) -> tuple:
    """The ``ep_train`` comparison in ``dtype``: 3 steps at world 1 in
    this process, then the same steps on the ranks of ``world``, held to
    ``COMPOSITION_TOL`` (bfloat16) or ``EP_F32_TOL`` (float32); given world
    1's float32 updates (``f32_updates``), the bfloat16 updates are held to
    them by ``SPLIT_BF16_TOL`` in place of ``COMPOSITION_TOL`` (ROADMAP
    C13).  Emits one line (``ep_train``, or ``ep_train_float32``).  Returns
    ``(ok, world 1's updates, the ranks' updates or None)``, on the
    host."""
    import gc
    import tempfile

    from tpu_dist_torch.benchmarks.moe_lm import ep_steps

    (dp, ep), backend = EP_WORLDS[world]
    cards = world if backend == "nccl" else 1
    zero_launch_counts()
    w1 = ep_steps(steps=EP_STEPS, compute_dtype=getattr(torch, dtype))
    counts1, _, ok_counts1 = path_launches(EP_STEPS, EP_PER_STEP)
    if dtype != "bfloat16":      # float32 attention takes the fma design
        ok_counts1 = all(counts1[n] == EP_STEPS * c
                         for n, c in EP_PER_STEP.items())
    upd1 = {k: v.float().cpu() for k, v in w1.pop("updates").items()}
    for k in ("model", "advance", "state"):
        w1.pop(k)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="ep_train_", dir=os.environ.get("TMPDIR"))
    rcs, ranks_s, errs = _ep_ranks(out, world, dtype)
    checks = {"ranks_exit_0": rcs == [0] * world}
    ranks = []
    if checks["ranks_exit_0"]:
        for r in range(world):
            with open(os.path.join(out, f"r{r}.json")) as f:
                ranks.append(json.load(f))
    fields, upd2 = {}, None
    if ranks:
        # the ranks of data index 0 (0 .. ep-1) hold the experts in order
        upd2 = torch.load(os.path.join(out, "upd0.pt"))
        for r in range(1, ep):
            for k, v in torch.load(os.path.join(out, f"upd{r}.pt")).items():
                upd2[k] = torch.cat([upd2[k], v])
        # the shards' step-1 expert choices, in data order, against world
        # 1's: a diagnostic of near-ties that the split rounds otherwise
        gates = [torch.load(os.path.join(out, f"gate{di * ep}.pt"))
                 for di in range(dp)]
        choices_differing = [
            int((torch.cat([g[i] for g in gates]) != want).sum())
            for i, want in enumerate(w1["gate_idx_step1"])]
        rel, leaf, group_worst = _update_diff(dict.fromkeys(upd1, 0.0),
                                              upd2, upd1)
        worst = max(leaf, key=leaf.get)
        attn = {k: e for k, e in leaf.items() if ".attn." in k}
        worst_attn = max(attn, key=attn.get)
        tol = COMPOSITION_TOL if dtype == "bfloat16" else EP_F32_TOL
        loss_err = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r["losses"], w1["losses"]))
        updates_ok = (rel <= tol["update_rel"]
                      and attn[worst_attn] <= tol["attn_leaf_update_rel"]
                      and leaf[worst] <= tol["leaf_update_rel"])
        if dtype == "bfloat16" and f32_updates is not None:
            updates_ok, fields["split_bf16"] = split_bf16_check(
                f32_updates, upd1, upd2)
        per_rank_counts = [{n: r["launches"][n] for n in EP_PER_STEP}
                           for r in ranks]
        checks.update(
            collectives_on_cuda=all(v is True for r in ranks
                                    for v in r["probe"].values()),
            losses=loss_err <= tol["loss_rtol"],
            updates=updates_ok,
            second_loss_moved=all(r["losses"][1] != r["losses"][0]
                                  for r in ranks),
            dropped_step1_equal=all(r["dropped_step1"] == w1["dropped_step1"]
                                    for r in ranks),
            expert_bytes_halved=all(ep * r["expert_bytes"]
                                    == w1["expert_bytes"] for r in ranks),
            experts_split=[r["experts_held"] for r in ranks]
            == [[(r % ep) * 8 // ep, 8 // ep] for r in range(world)],
            replicated_equal=len({r["replicated_digest"]
                                  for r in ranks}) == 1,
            launches=ok_counts1 and all(
                c == {n: EP_STEPS * v for n, v in EP_PER_STEP.items()}
                for c in per_rank_counts),
            wgmma=dtype != "bfloat16" or all(
                r["launches_by_design"][n]["wgmma"] == r["launches"][n]
                for r in ranks for n in ("flash_fwd", "flash_bwd")))
        tokens = 8 * 2048
        p50_n = [statistics.median(r["step_ms"][1:]) for r in ranks]
        p50_1 = statistics.median(w1["step_ms"][1:])
        fields.update(
            losses_ranks=[r["losses"] for r in ranks],
            losses_world1=w1["losses"], loss_rel_err=loss_err,
            update_rel_err=rel, worst_leaf=[worst, leaf[worst]],
            worst_attn_leaf=[worst_attn, attn[worst_attn]],
            worst_leaf_by_group=group_worst,
            dropped_step1_ranks=[r["dropped_step1"] for r in ranks],
            dropped_step1_world1=w1["dropped_step1"],
            step1_choices_differing=choices_differing,
            expert_bytes_ranks=[r["expert_bytes"] for r in ranks],
            expert_bytes_world1=w1["expert_bytes"],
            step_ms_ranks=[r["step_ms"] for r in ranks],
            step_ms_world1=w1["step_ms"],
            step_ms_p50_ranks=max(p50_n), step_ms_p50_world1=p50_1,
            tokens_per_s_per_gpu_ranks=tokens / (max(p50_n) / 1e3)
            / cards,
            tokens_per_s_per_gpu_world1=tokens / (p50_1 / 1e3),
            combine_ms_a_step=[r["combine_ms"] for r in ranks],
            combine_calls_a_step=[r["combine_calls"] for r in ranks],
            combine_mb_a_step=[r["combine_bytes"] / 1e6 for r in ranks],
            timed_step_ms=[r["timed_step_ms"] for r in ranks],
            peak_mem_bytes_ranks=[r["peak_mem_bytes"] for r in ranks],
            peak_mem_bytes_world1=w1["peak_mem_bytes"],
            aux_losses_ranks=ranks[0]["aux_losses"],
            aux_losses_world1=w1["aux_losses"],
            launches_ranks=per_rank_counts, launches_world1=counts1,
            launches_by_design_ranks=[r["launches_by_design"]
                                      for r in ranks],
            collectives_probe=[r["probe"] for r in ranks])
    emit("ep_train" if dtype == "bfloat16" else f"ep_train_{dtype}",
         world=world, mesh=[dp, ep], cards=cards, dtype=dtype,
         steps=EP_STEPS, backend=backend, ranks_seconds=ranks_s,
         ranks_rc=rcs,
         tolerance=COMPOSITION_TOL if dtype == "bfloat16" else EP_F32_TOL,
         split_tolerance=SPLIT_BF16_TOL if dtype == "bfloat16"
         and f32_updates is not None else None,
         **fields, checks=checks,
         rank_stderr_tails=None if all(checks.values()) else errs)
    return all(checks.values()), upd1, upd2


def check_ep_train(results):
    """Expert parallelism at full width: the JAX moe_lm configuration
    (gather dispatch) under the GSPMD step, 3 steps at world 1 in this
    process, then the same steps at world 2 (data 1 x expert 2, two rank
    processes on this card over gloo) or, with ``--ep-world 4``, at world
    4 (data 2 x expert 2, a card a rank over NCCL; in bfloat16, then in
    float32) from the same seed and batches: float32 losses and updates
    within the dtype's limits, step 1's dropped choices per layer equal,
    each rank's expert banks half the bytes, K1f/K1b 1 and K2f/K2b 12
    launches a rank a step (wgmma in bfloat16), K3/K4 none; step ms,
    tokens/s, the combine's collectives and peak memory.  Then
    ``train_lm --parallel ep`` at world 1 at its defaults: the loss falls,
    and the second step's loss differs from the first (the dry run's
    check)."""
    from tpu_dist_torch.examples import train_lm

    world = EP_WORLD[0]
    cards = world if EP_WORLDS[world][1] == "nccl" else 1
    if torch.cuda.device_count() < cards:
        raise RuntimeError(f"--ep-world {world} needs {cards} cards, this "
                           f"machine has {torch.cuda.device_count()}")
    ok, upd = True, {}
    for dtype in EP_DTYPES[world]:
        ok_d, *upd[dtype] = _ep_compare(
            world, dtype, upd["float32"][0] if "float32" in upd else None)
        ok = ok_d and ok
    if "float32" in upd and upd["bfloat16"][1] is not None:
        # how far the bf16 step lies from the float32 one, unsplit and on
        # the ranks: the ranks' bf16 error against world 1's is read
        # beside the bf16 step's own distance from float32
        ref = upd["float32"][0]
        zero = dict.fromkeys(ref, 0.0)
        w1_rel, _, w1_groups = _update_diff(zero, upd["bfloat16"][0], ref)
        n_rel, _, n_groups = _update_diff(zero, upd["bfloat16"][1], ref)
        emit("ep_train_bf16_against_float32", world=world,
             world1_update_rel=w1_rel, world1_worst_by_group=w1_groups,
             ranks_update_rel=n_rel, ranks_worst_by_group=n_groups)
    del upd

    # the entry point at world 1, its defaults, on the card
    args = train_lm.parse_args(["--parallel", "ep"])
    t0 = time.perf_counter()
    r = train_lm.train(args)
    cli_s = time.perf_counter() - t0
    losses = r["losses"]
    cli = {"finite": all(math.isfinite(v) for v in losses),
           "falls": losses[-1] < 0.5 * losses[0],
           "second_loss_moved": losses[1] != losses[0]}
    emit("ep_train_cli", steps=len(losses), first_loss=losses[0],
         last_loss=losses[-1], loss_every_20=losses[::20],
         seconds=cli_s, first_step_seconds=r["first_step_seconds"],
         loop_seconds=r["loop_seconds"], checks=cli)
    return ok and all(cli.values())


# ---------------------------------------------------------------------------
# Tensor parallelism and FSDP
# ---------------------------------------------------------------------------

# world: ({case: (mesh axes, mesh shape)}, backend): two rank processes on
# one card over gloo, or four on four cards over NCCL (--tp-world 4)
TP_WORLDS = {2: ({"tp": (("data", "model"), (1, 2)),
                  "fsdp": (("data",), (2,))}, "gloo"),
             4: ({"tp": (("data", "model"), (2, 2)),
                  "fsdp": (("data", "fsdp", "model"), (1, 2, 2))}, "nccl")}
TP_WORLD = [2]               # set by --tp-world
# each case's compute dtypes on the ranks: on one card bf16, the
# configuration's, held by SPLIT_BF16_TOL to world 1's float32 and bf16
# steps (both run in this process); on four cards float32 too, held by
# TP_F32_TOL (a float32 step over gloo on one H100 takes about 3.2 s)
TP_DTYPES = {2: {"tp": ("bfloat16",), "fsdp": ("bfloat16",)},
             4: {"tp": ("float32", "bfloat16"),
                 "fsdp": ("float32", "bfloat16")}}
TP_F32_TOL = dict(EP_F32_TOL, why=(
    "float32 compute with TF32 off on both paths: a split sums the "
    "row-parallel partials and the vocab slices' lse in another order, "
    "and a rank's matmuls over half the heads or columns may differ from "
    "world 1's in the last bits (float32 epsilon 1.2e-7); a LayerNorm "
    "gain's gradient cancels over 16384 tokens (EP_F32_TOL's limits)"))
TP_STEPS = 3
TP_TIMEOUT = 600
TP_PER_STEP = EP_PER_STEP
TP_FSDP_MIN = 2 ** 12
# greedy generate under the tp placement: two prompts of 16 tokens, 16 new
TP_GEN = {"prompts": 2, "prompt_len": 16, "max_new_tokens": 16}
# the host route: TPTrainer over the socket plane at full width, depth 2,
# batch 2 x 1024, two steps against SerialTPRunner
TP_HOST = {"vocab": 32768, "dim": 768, "heads": 12, "depth": 2, "batch": 2,
           "seq_len": 1024, "steps": 2}

# a rank of the tp_train phase (env:// under a control-plane store this
# process hosts): each case of the world (tp, then fsdp) in each of its
# dtypes through benchmarks.transformer_lm.tp_steps (the library's GSPMD
# step), the launch counts zeroed just before, the mesh collectives of its
# steps counted (ops.all_reduce on the model line, the fsdp gathers and
# reduce-scatters: calls and bytes); then the updates gathered whole
# (interop.jax_params, every rank).  argv: OUT, [CASES, STEPS, BACKEND,
# PROMPTS, MAX_NEW, FSDP_MIN, DIMS]; each case [name, axes, mesh, dtype];
# the first case generates from PROMPTS.
# Writes OUT/{case}_{dtype}_r{rank}.json, and rank 0 the whole updates
# OUT/{case}_{dtype}_upd.pt.
TP_WORKER = """
import contextlib, json, os, sys
import numpy as np
import torch
from tpu_dist_torch import dist, interop
from tpu_dist_torch.benchmarks.transformer_lm import tp_steps
from tpu_dist_torch.collectives import ops
from tpu_dist_torch.ops import KERNELS
from tpu_dist_torch.parallel import fsdp

out = sys.argv[1]
cases, steps, backend, prompts, max_new, fsdp_min, dims = json.loads(
    sys.argv[2])
device = "cpu" if backend == "gloo" and dims else "cuda"
for name, axes, mesh, compute in cases:
    pg = dist.init_process_group(
        backend=backend, init_method="env://", device=device,
        axis_names=axes, mesh_shape=mesh)
    rank = pg.rank
    for k in KERNELS:
        k.launches = 0
        for by in ("launches_by_design", "launches_by_mode"):
            if hasattr(k, by):
                getattr(k, by).update(dict.fromkeys(getattr(k, by), 0))
    seen = {"model": [0, 0], "fsdp": [0, 0]}

    def counted(fn, kind):
        def wrapped(x, *a, **k):
            seen[kind][0] += 1
            seen[kind][1] += x.numel() * x.element_size()
            return fn(x, *a, **k)
        return wrapped

    @contextlib.contextmanager
    def counting():
        saved = (ops.all_reduce, fsdp.gather_dim, fsdp.reduce_scatter_dim)
        ops.all_reduce = counted(ops.all_reduce, "model")
        fsdp.gather_dim = counted(fsdp.gather_dim, "fsdp")
        fsdp.reduce_scatter_dim = counted(fsdp.reduce_scatter_dim, "fsdp")
        try:
            yield
        finally:
            ops.all_reduce, fsdp.gather_dim, fsdp.reduce_scatter_dim = saved

    res = tp_steps(steps=steps, compute_dtype=getattr(torch, compute),
                   fsdp_min_size=fsdp_min,
                   prompts=[np.array(p) for p in prompts]
                   if [name, compute] == [cases[0][0], cases[0][3]] else [],
                   device=device, max_new_tokens=max_new,
                   around_steps=counting(), **dims)
    counts = {k.__name__: k.launches for k in KERNELS}
    by_design = {k.__name__: dict(k.launches_by_design)
                 for k in KERNELS if hasattr(k, "launches_by_design")}
    data = pg.axis_group("data")
    model = res["model"]
    # the elements each leaf should hold here: its model split, then the
    # fsdp axis on every leaf of at least fsdp_min elements after it
    fline = (pg.axis_group("fsdp") if "fsdp" in axes else data
             if list(axes) == ["data"] and pg.size() > 1 else None)
    want = {}
    for k, n in res["full_elements"].items():
        local = model.get_parameter(k).numel()
        ways = (n // local) * (fline.size if fline is not None
                               and local >= fsdp_min else 1)
        want[k] = n // ways
    whole = interop.jax_params(model, params=res["updates"])
    if rank == 0:
        torch.save({f"{p}.{l}": torch.from_numpy(a)
                    for p, d in whole.items() for l, a in d.items()},
                   os.path.join(out, f"{name}_{compute}_upd.pt"))
    with open(os.path.join(out, f"{name}_{compute}_r{rank}.json"), "w") as f:
        json.dump({"losses": res["losses"], "step_ms": res["step_ms"],
                   "generated": res["generated"],
                   "held_elements": sum(res["held_elements"].values()),
                   "full_elements": sum(res["full_elements"].values()),
                   "held_mismatch": sorted(
                       k for k, n in res["held_elements"].items()
                       if n != want[k]),
                   "split_leaves": sum(res["held_elements"][k]
                                       < res["full_elements"][k]
                                       for k in want),
                   "opt_state_elements": res["opt_state_elements"],
                   "peak_mem_bytes": res["peak_mem_bytes"],
                   "launches": counts, "launches_by_design": by_design,
                   "collectives_a_step": {
                       k: {"calls": c / steps, "bytes": n / steps}
                       for k, (c, n) in seen.items()}}, f)
    del res, model, whole
    dist.destroy_process_group()
"""


def _tp_ranks(out: str, world: int, cases: list, prompts: list,
              dims: dict = None) -> tuple:
    """Start the tp_train ranks and wait for them: ``(return codes,
    seconds, stderr tails)``; every process they started is stopped.  This
    process hosts their control-plane store, as ``ep_train``'s does."""
    import signal

    from tpu_dist_torch.dist.store import TCPStore

    backend = TP_WORLDS[world][1]
    store = TCPStore(is_master=True, timeout=TP_TIMEOUT)
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(store.port), WORLD_SIZE=str(world),
               TPU_DIST_STORE_ADDR=f"127.0.0.1:{store.port}",
               PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", TP_WORKER, out,
         json.dumps([cases, TP_STEPS, backend, prompts,
                     TP_GEN["max_new_tokens"], TP_FSDP_MIN, dims or {}])],
        cwd=out, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(world)]
    errs = []
    try:
        for p in procs:
            try:
                errs.append(p.communicate(timeout=TP_TIMEOUT)[1][-3000:])
            except subprocess.TimeoutExpired:
                errs.append("timed out")
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
            p.wait(timeout=30)
        store.close()
    return [p.returncode for p in procs], time.perf_counter() - t0, errs


def _tp_prompts() -> list:
    import numpy as np

    g = np.random.default_rng(2)
    return [g.integers(0, 32768, TP_GEN["prompt_len"]).tolist()
            for _ in range(TP_GEN["prompts"])]


def _world1_tp(dtype: str, prompts=()) -> dict:
    """``tp_steps`` at world 1 in this process: losses, step ms, peak
    memory, launch counts, the generated tokens and the whole updates (on
    the host, by name)."""
    import gc

    import numpy as np

    from tpu_dist_torch.benchmarks.transformer_lm import tp_steps
    from tpu_dist_torch.ops import KERNELS

    zero_launch_counts()
    res = tp_steps(steps=TP_STEPS, compute_dtype=getattr(torch, dtype),
                   prompts=[np.array(p) for p in prompts],
                   max_new_tokens=TP_GEN["max_new_tokens"])
    out = {k: res[k] for k in ("losses", "step_ms", "peak_mem_bytes",
                               "generated")}
    out["launches"] = {k.__name__: k.launches for k in KERNELS}
    out["updates"] = {k: v.float().cpu() for k, v in res["updates"].items()}
    out["elements"] = sum(res["held_elements"].values())
    del res
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _by_jax_name(model_updates: dict) -> dict:
    """World 1's updates (port names, torch layouts) as the ranks report
    them: ``interop.jax_params``'s tree flattened to ``path.leaf``."""
    from tpu_dist_torch.interop import jax_params
    from tpu_dist_torch.models import TransformerLM

    model = TransformerLM(vocab_size=32768, dim=768, depth=12, num_heads=12,
                          max_seq_len=2048, device="meta")
    whole = jax_params(model, params=model_updates)
    return {f"{p}.{k}": torch.from_numpy(a) for p, d in whole.items()
            for k, a in d.items()}


def _tp_host(device: str = "cuda") -> tuple:
    """The host route at full width, depth 2, batch 2 x 1024: TPTrainer
    (dp 1 x tp 2, two thread ranks over socket data planes) against
    SerialTPRunner, two steps: ``(fields, ok)``."""
    import threading

    import numpy as np

    from tpu_dist_torch import nn, optim
    from tpu_dist_torch.collectives.topology import SubGroup
    from tpu_dist_torch.collectives.transport import DataPlane
    from tpu_dist_torch.dist.store import TCPStore
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import SerialTPRunner, TPTrainer

    tp, h = 2, TP_HOST

    def model():
        return TransformerLM(vocab_size=h["vocab"], dim=h["dim"],
                             depth=h["depth"], num_heads=h["heads"],
                             max_seq_len=h["seq_len"], device=device)

    ce = nn.CrossEntropyLoss(fused=True)

    def loss_fn(lg, y):
        return ce(lg.reshape(-1, h["vocab"]), y.reshape(-1))

    oracle = SerialTPRunner(model(), optim.SGD(lr=0.01), loss_fn, tp=tp)
    store = TCPStore(is_master=True)
    planes = [DataPlane(store, r, tp) for r in range(tp)]
    trainers = [None] * tp
    models = [model() for _ in range(tp)]
    g = np.random.default_rng(3)
    batches = [(g.integers(0, h["vocab"], (h["batch"], h["seq_len"])),
                g.integers(0, h["vocab"], (h["batch"], h["seq_len"])))
               for _ in range(h["steps"])]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    got, want, ms_plane, ms_serial = [], [], [], []
    errs = []

    def threads(fn):
        ths = [threading.Thread(target=lambda r=r: _catch(fn, r, errs),
                                daemon=True) for r in range(tp)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(300)
        if errs:
            raise errs[0]

    try:
        def build(r):
            trainers[r] = TPTrainer(
                models[r], optim.SGD(lr=0.01), loss_fn, dp=planes[r], tp=tp,
                tp_group=SubGroup((0, 1), r, tp, instance=0),
                dp_group=SubGroup((r,), r, tp, instance=0))

        threads(build)
        for x, y in batches:
            t0 = time.perf_counter()
            want.append(oracle.step(x, y)[0])
            sync()
            ms_serial.append((time.perf_counter() - t0) * 1e3)
            out = [None] * tp

            def run(r):
                out[r] = trainers[r].step(x, y)

            t0 = time.perf_counter()
            threads(run)
            sync()
            ms_plane.append((time.perf_counter() - t0) * 1e3)
            got.append(out)
        same = all(torch.equal(t, oracle.params[r][p][k])
                   for r in range(tp)
                   for p, d in trainers[r].params.items()
                   for k, t in d.items())
        wire = [tr.tp_bytes_sent for tr in trainers]
    finally:
        for p in planes:
            p.close()
        store.close()
    checks = {"losses_bitwise": all(o == [w] * tp
                                    for o, w in zip(got, want)),
              "params_bitwise": same,
              "loss_finite": all(math.isfinite(w) for w in want)}
    return dict(losses_plane=got, losses_serial=want,
                step_ms_plane=ms_plane, step_ms_serial=ms_serial,
                tp_bytes_sent=wire, config=h, checks=checks), \
        all(checks.values())


def _catch(fn, r, errs):
    try:
        fn(r)
    except BaseException as e:  # noqa: BLE001 — re-raised by the caller
        errs.append(e)


def _tp_case(world: int, name: str, dtypes, w1: dict, out: str) -> tuple:
    """One case's comparison from the ranks' files: ``(fields, checks)``
    for each dtype, held to world 1's."""
    (cases, backend) = TP_WORLDS[world]
    axes, mesh = cases[name]
    sizes = dict(zip(axes, mesh))
    ways = sizes.get("model", 1) * (sizes.get("fsdp", 1) if "fsdp" in axes
                                    else sizes["data"] if name == "fsdp"
                                    else 1)
    fields, checks = {}, {}
    ranks_bf16 = None
    for dtype in dtypes:
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"{name}_{dtype}_r{r}.json")) as f:
                ranks.append(json.load(f))
        upd = torch.load(os.path.join(out, f"{name}_{dtype}_upd.pt"))
        ref = w1[dtype]
        loss_err = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r["losses"], ref["losses"]))
        zero = dict.fromkeys(ref["updates_jax"], 0.0)
        rel, leaf, groups = _update_diff(zero, upd, ref["updates_jax"])
        worst = max(leaf, key=leaf.get)
        attn = {k: e for k, e in leaf.items() if ".attn." in k}
        worst_attn = max(attn, key=attn.get)
        tag = f"{name}_{dtype}"
        if dtype == "float32":
            tol = TP_F32_TOL
            checks[f"{tag}_losses"] = loss_err <= tol["loss_rtol"]
            checks[f"{tag}_updates"] = (
                rel <= tol["update_rel"]
                and attn[worst_attn] <= tol["attn_leaf_update_rel"]
                and leaf[worst] <= tol["leaf_update_rel"])
        else:
            checks[f"{tag}_losses"] = \
                loss_err <= SPLIT_BF16_TOL["loss_rtol"]
            checks[f"{tag}_updates"], fields[f"{tag}_split"] = \
                split_bf16_check(w1["float32"]["updates_jax"],
                                 ref["updates_jax"], upd)
            ranks_bf16 = ranks
        checks[f"{tag}_second_loss_moved"] = all(
            r["losses"][1] != r["losses"][0] for r in ranks)
        checks[f"{tag}_held"] = all(
            not r["held_mismatch"] and r["split_leaves"] > 0
            and r["held_elements"] < r["full_elements"] for r in ranks)
        per_rank = [{n: r["launches"][n] for n in TP_PER_STEP}
                    for r in ranks]
        checks[f"{tag}_launches"] = all(
            c == {n: TP_STEPS * v for n, v in TP_PER_STEP.items()}
            for c in per_rank)
        if dtype == "bfloat16":
            checks[f"{tag}_wgmma"] = all(
                r["launches_by_design"][n]["wgmma"] == r["launches"][n]
                for r in ranks for n in ("flash_fwd", "flash_bwd"))
        p50 = max(statistics.median(r["step_ms"][1:]) for r in ranks)
        p50_1 = statistics.median(ref["step_ms"][1:])
        cards = world if backend == "nccl" else 1
        fields[tag] = dict(
            mesh=dict(zip(axes, mesh)), losses_ranks=[r["losses"]
                                                      for r in ranks],
            losses_world1=ref["losses"], loss_rel_err=loss_err,
            update_rel_err=rel, worst_leaf=[worst, leaf[worst]],
            worst_attn_leaf=[worst_attn, attn[worst_attn]],
            worst_leaf_by_group=groups,
            step_ms_ranks=[r["step_ms"] for r in ranks],
            step_ms_world1=ref["step_ms"], step_ms_p50_ranks=p50,
            step_ms_p50_world1=p50_1,
            tokens_per_s_per_rank=8 * 2048 / max(
                sizes.get("data", 1), 1) / (p50 / 1e3),
            tokens_per_s_per_gpu=8 * 2048 / (p50 / 1e3) / cards,
            tokens_per_s_world1=8 * 2048 / (p50_1 / 1e3),
            collectives_a_step=[r["collectives_a_step"] for r in ranks],
            held_elements_ranks=[r["held_elements"] for r in ranks],
            full_elements=ranks[0]["full_elements"], split_ways=ways,
            split_leaves=[r["split_leaves"] for r in ranks],
            opt_state_elements=[r["opt_state_elements"] for r in ranks],
            peak_mem_bytes_ranks=[r["peak_mem_bytes"] for r in ranks],
            peak_mem_bytes_world1=ref["peak_mem_bytes"],
            launches_ranks=per_rank)
    return fields, checks, ranks_bf16


def check_tp_train(results):
    """Tensor parallelism and FSDP at full width: the dense GPT-2-small
    cell (vocab 32768, dim 768, 12 layers, 12 heads, T 2048, batch 8, SGD)
    through the library's GSPMD step (``benchmarks.transformer_lm.
    tp_steps``), 3 steps at world 1 in this process (float32 and bf16),
    then the same steps on two rank processes on this card over gloo at
    data 1 x model 2 (float32 and bf16) and FSDP at data 2 (1-D, bf16)
    or, with ``--tp-world 4``, a card a rank over NCCL at data 2 x model 2
    and data 1 x fsdp 2 x model 2 (both dtypes).  Float32 losses and
    updates within ``TP_F32_TOL``; bf16 by ``SPLIT_BF16_TOL`` (ROADMAP
    C13); every leaf split as the rules place it (1/model, and
    1/(fsdp x model) under FSDP, of its elements a rank); K1f/K1b 1 and
    K2f/K2b 12 launches a rank a step (wgmma in bf16), K3/K4 none; greedy
    ``generate`` under the tp placement equal to world 1's (the serve
    phases' tie rule); step ms, tokens/s a rank, the model line's and the fsdp line's
    collectives and peak memory a rank, against world 1 and the
    replicated DDP step.  Then the host route (``TPTrainer`` over socket
    planes against ``SerialTPRunner``, bit for bit) and ``train_lm
    --parallel tp`` at world 1 at its defaults: the loss falls."""
    import gc
    import tempfile

    import numpy as np

    from tpu_dist_torch.examples import train_lm

    world = TP_WORLD[0]
    cases, backend = TP_WORLDS[world]
    cards = world if backend == "nccl" else 1
    if torch.cuda.device_count() < cards:
        raise RuntimeError(f"--tp-world {world} needs {cards} cards, this "
                           f"machine has {torch.cuda.device_count()}")
    prompts = _tp_prompts()
    w1, parts_s = {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        w1[dtype] = _world1_tp(dtype, prompts if dtype == "float32" else ())
        w1[dtype]["updates_jax"] = _by_jax_name(w1[dtype].pop("updates"))
        parts_s[f"world1_{dtype}"] = time.perf_counter() - t0
    # pp_train holds its ranks to the same world-1 steps
    results["_world1_dense"] = w1
    ok_w1_launches = all(
        w1["bfloat16"]["launches"][n] == TP_STEPS * c
        for n, c in TP_PER_STEP.items())
    gc.collect()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="tp_train_", dir=os.environ.get("TMPDIR"))
    run = [[name, *cases[name], dtype] for name in ("tp", "fsdp")
           for dtype in TP_DTYPES[world][name]]
    rcs, ranks_s, errs = _tp_ranks(
        out, world, [[n, list(a), list(m), d] for n, a, m, d in run],
        prompts)
    checks = {"ranks_exit_0": rcs == [0] * world,
              "world1_launches": ok_w1_launches}
    parts_s["ranks"] = ranks_s
    fields = {}
    if checks["ranks_exit_0"]:
        for name in ("tp", "fsdp"):
            f, c, bf16_ranks = _tp_case(world, name, TP_DTYPES[world][name],
                                        w1, out)
            fields.update(f)
            checks.update(c)
        # greedy generate under the tp placement (the first tp case's rank
        # 0) against world 1's, under the serve phases' tie rule
        first = TP_DTYPES[world]["tp"][0]
        with open(os.path.join(out, f"tp_{first}_r0.json")) as f:
            got = json.load(f)["generated"]
        want = w1["float32"]["generated"]
        checks["generate"] = got == want
        if got != want:
            from tpu_dist_torch.examples.train_lm import tp_trainer
            from tpu_dist_torch.models import TransformerLM
            model = TransformerLM(vocab_size=32768, dim=768, depth=12,
                                  num_heads=12, max_seq_len=2048,
                                  device="cuda")
            tp_trainer(model, 32768, 0.01)      # the seeded weights
            reqs = [{"prompt": np.array(p), "temperature": 0, "seed": 0,
                     "max_new_tokens": TP_GEN["max_new_tokens"]}
                    for p in prompts]
            verdicts = _tie_rule(model, reqs, got, want, torch.float32,
                                 "tp_train")
            checks["generate"] = all(ok for _, ok, _ in verdicts)
            del model
        fields["generate_equal"] = got == want
    ddp = results.get("_slice")
    emit("tp_train", world=world, cards=cards, backend=backend,
         steps=TP_STEPS, cases={n: dict(zip(*cases[n])) for n in cases},
         ranks_seconds=ranks_s, ranks_rc=rcs,
         tolerance={"float32": TP_F32_TOL, "bfloat16": SPLIT_BF16_TOL},
         world1={d: {k: w1[d][k] for k in ("losses", "step_ms",
                                           "peak_mem_bytes", "launches")}
                 for d in w1},
         replicated_ddp_step=ddp, seconds=parts_s, **fields, checks=checks,
         rank_stderr_tails=None if all(checks.values()) else errs)
    ok = all(checks.values())
    del w1
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fields, ok_host = _tp_host()
    emit("tp_train_host", **fields, seconds=time.perf_counter() - t0)
    ok = ok and ok_host
    gc.collect()
    torch.cuda.empty_cache()

    # the entry point at world 1, its defaults, on the card
    args = train_lm.parse_args(["--parallel", "tp"])
    t0 = time.perf_counter()
    r = train_lm.train(args)
    cli_s = time.perf_counter() - t0
    losses = r["losses"]
    cli = {"finite": all(math.isfinite(v) for v in losses),
           "falls": losses[-1] < 0.5 * losses[0],
           "second_loss_moved": losses[1] != losses[0]}
    emit("tp_train_cli", steps=len(losses), first_loss=losses[0],
         last_loss=losses[-1], loss_every_20=losses[::20],
         seconds=cli_s, first_step_seconds=r["first_step_seconds"],
         loop_seconds=r["loop_seconds"], checks=cli)
    return ok and all(cli.values())


# ---------------------------------------------------------------------------
# pipeline parallelism: the mesh pipeline (pp_train) and the host route
# (pp_host), ROADMAP A9.6b
# ---------------------------------------------------------------------------

# each world's cases [name, axes, mesh, dtype, schedule]: on one card two
# gloo ranks at pipe 2 (GPipe in float32 and bf16, 1F1B in bf16); on four
# cards a card a rank over NCCL at data 2 x pipe 2 (GPipe, train_lm's mesh
# rule) and data 1 x pipe 4 (1F1B), both dtypes
PP_WORLDS = {
    2: ([["gpipe", ["data", "pipe"], [1, 2], "float32", "gpipe"],
         ["gpipe", ["data", "pipe"], [1, 2], "bfloat16", "gpipe"],
         ["1f1b", ["data", "pipe"], [1, 2], "bfloat16", "1f1b"]], "gloo"),
    4: ([["gpipe", ["data", "pipe"], [2, 2], "float32", "gpipe"],
         ["gpipe", ["data", "pipe"], [2, 2], "bfloat16", "gpipe"],
         ["1f1b", ["data", "pipe"], [1, 4], "float32", "1f1b"],
         ["1f1b", ["data", "pipe"], [1, 4], "bfloat16", "1f1b"]], "nccl")}
PP_WORLD = [2]               # set by --pp-world
PP_M = 4                     # microbatches a step
PP_STEPS = 3
PP_TIMEOUT = 600
PP_F32_TOL = dict(EP_F32_TOL, why=(
    "float32 compute with TF32 off on both paths: the pipeline sums M "
    "microbatches' gradients (attention and the MLPs on 2-row "
    "microbatches) where world 1 takes one 8-row batch, so a matmul may "
    "round in the last bits (float32 epsilon 1.2e-7); a LayerNorm gain's "
    "gradient cancels over 16384 tokens (EP_F32_TOL's limits)"))
# a pp rank's device bytes once its state is built may exceed its state's
# bytes by no more than this: its small tensors and the allocator's
# 512-byte rounding; the whole float32 model (548 MB) is far outside
PP_HELD_SLACK = 16 << 20
# BatchNorm under the GSPMD step: ResNet-18/CIFAR-10 at batch 256, SGD 0.1,
# data 2 (the pp_train launch's two ranks) against world 1 on the global
# batch: float32 over one step, float64 over two.  Over two steps float32
# is no witness of the implementation: its own rounding moves world 1's
# two-step update by several percent (the phase prints world 1's float32
# against its float64), while float64 holds data 2 to world 1 to rounding
BN_CELL = {"batch": 256, "steps": 1, "lr": 0.1, "float64_steps": 2}
BN_TOL = {
    "loss_rtol": 1e-4, "stats_rel": 1e-4, "update_rel": 1e-2,
    "leaf_update_rel": 5e-2,
    "why": "float32 convolutions with TF32 off: cuDNN may take another "
           "algorithm at 128 images than at 256 and the global statistics "
           "are a mean of two ranks' means (last-bit differences); a "
           "BatchNorm gain's or bias's update is a sum whose terms cancel, "
           "so its rounding is large against its own norm (the vision "
           "phases' ResNet-18 leaves, 3e-3 card against CPU)"}
BN_F64_TOL = {
    "loss_rtol": 1e-6, "stats_rel": 1e-9, "update_rel": 1e-9,
    "leaf_update_rel": 1e-7,
    "why": "float64 (epsilon 2.2e-16): the split's rounding, amplified by "
           "the second step as float32's is, stays many orders below "
           "these limits, while a gradient that misses the statistics' "
           "all-reduce or counts it twice moves updates by 1e-3 or more; "
           "the losses are printed in float32"}
# the host route at full width: the in-process rig (a thread a stage),
# 2 stages, M = 4, batch 8 x 2048, float32, two steps (the first warms up)
PP_HOST = {"stages": 2, "M": 4, "steps": 2, "batch": 8,
           "dims": {"vocab": 32768, "dim": 768, "depth": 12, "heads": 12,
                    "seq": 2048}}
PP_INT8 = {"compress": "int8_block256", "loss_rtol": 1e-2,
           "why": "activations block-quantized to int8 (a 1/254 step of "
                  "each 256-value block's largest magnitude) on the way to "
                  "stage 1 and their cotangents on the way back: the loss "
                  "moves by far less than 1%"}
PP_KILL = "kill:rank=1,step=4"   # after step 4's save: generation 1 at 5
PP_TWIN_STEPS = 7

# a rank of the pp_train phase (env:// under the port's launcher): each
# case through benchmarks.transformer_lm.pp_steps (PipelineParallel), the
# launch counts zeroed just before the steps; then, with BN, ResNet-18
# under the GSPMD step at data = world (benchmarks.resnet_cifar.
# gspmd_steps).  argv: OUT, [CASES, STEPS, BACKEND, M, PROMPTS, MAX_NEW,
# BN, DIMS]; the first case generates from PROMPTS; DIMS (pp_steps' sizes)
# put the ranks on the CPU, for a rehearsal.  Writes OUT/{case}_{dtype}
# _r{rank}.json, rank 0 the whole updates OUT/{case}_{dtype}_upd.pt, and
# with BN every rank OUT/bn_{float32,float64}_r{rank}.pt.
PP_WORKER = """
import json, os, sys
import numpy as np
import torch
from tpu_dist_torch import dist
from tpu_dist_torch.benchmarks.transformer_lm import pp_steps
from tpu_dist_torch.ops import KERNELS

out = sys.argv[1]
cases, steps, backend, m, prompts, max_new, bn, dims = json.loads(
    sys.argv[2])
device = "cpu" if dims else None
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def zero():
    for k in KERNELS:
        k.launches = 0
        for by in ("launches_by_design", "launches_by_mode"):
            if hasattr(k, by):
                getattr(k, by).update(dict.fromkeys(getattr(k, by), 0))


for i, (name, axes, mesh, compute, schedule) in enumerate(cases):
    pg = dist.init_process_group(backend=backend, init_method="env://",
                                 axis_names=axes, mesh_shape=mesh,
                                 device=device)
    rank = pg.rank
    res = pp_steps(steps=steps, compute_dtype=getattr(torch, compute),
                   schedule=schedule, microbatches=m,
                   prompts=[np.array(p) for p in prompts] if i == 0
                   else [], max_new_tokens=max_new, before_steps=zero,
                   **dims)
    tag = f"{name}_{compute}"
    if rank == 0:
        torch.save({k: v.float().cpu() for k, v in res["updates"].items()},
                   os.path.join(out, f"{tag}_upd.pt"))
    with open(os.path.join(out, f"{tag}_r{rank}.json"), "w") as f:
        json.dump({
            "losses": res["losses"], "step_ms": res["step_ms"],
            "stats": res["stats"], "generated": res["generated"],
            "held_elements": res["held_elements"],
            "full_elements": res["full_elements"],
            "held_bytes": res["held_bytes"],
            "state_bytes": res["state_bytes"],
            "peak_mem_bytes": res["peak_mem_bytes"],
            "stage": res["stage_index"],
            "data": dist.axis_group("data").index,
            "repl_digest": res["repl_digest"],
            "launches": {k.__name__: k.launches for k in KERNELS},
            "launches_by_design": {
                k.__name__: dict(k.launches_by_design) for k in KERNELS
                if hasattr(k, "launches_by_design")}}, f)
    del res
    torch.cuda.empty_cache()
    dist.destroy_process_group()

if bn:
    from tpu_dist_torch.benchmarks.resnet_cifar import gspmd_steps
    pg = dist.init_process_group(backend=backend, init_method="env://",
                                 axis_names=["data"],
                                 mesh_shape=[int(os.environ["WORLD_SIZE"])],
                                 device=device)
    for dtype, steps in (("float32", bn["steps"]),
                         ("float64", bn["float64_steps"])):
        res = gspmd_steps(batch=bn["batch"], steps=steps, lr=bn["lr"],
                          dtype=getattr(torch, dtype))
        torch.save({"losses": res["losses"], "step_ms": res["step_ms"],
                    "updates": {k: v.cpu()
                                for k, v in res["updates"].items()},
                    "stats": {p: {k: v.cpu() for k, v in st.items()}
                              for p, st in res["stats"].items()}},
                   os.path.join(out, f"bn_{dtype}_r{pg.rank}.pt"))
    dist.destroy_process_group()
"""


def _pp_ranks(out: str, world: int, cases: list, prompts: list,
              bn, dims: dict = None) -> tuple:
    """The pp_train ranks through the port's launcher (``--standalone
    --nproc_per_node=world``): ``(return code, seconds, stderr tail)``;
    every process it started is stopped."""
    import signal

    backend = PP_WORLDS[world][1]
    with open(os.path.join(out, "pp_worker.py"), "w") as f:
        f.write(PP_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "TPU_DIST_STORE_ADDR"):
        env.pop(var, None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         f"--nproc_per_node={world}", os.path.join(out, "pp_worker.py"),
         out, json.dumps([cases, PP_STEPS, backend, PP_M, prompts,
                          TP_GEN["max_new_tokens"], bn, dims or {}])],
        cwd=out, env=env, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        err = proc.communicate(timeout=PP_TIMEOUT)[1][-4000:]
    except subprocess.TimeoutExpired:
        err = "timed out"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait(timeout=30)
    return proc.returncode, time.perf_counter() - t0, err


def pp_per_step(schedule: str, stage: int, stages: int,
                depth: int = 12) -> dict:
    """K1/K2 launches a rank a step, as the code implies: every schedule
    runs the stage's blocks on M microbatches (K2f, K2b each a block a
    microbatch); GPipe's last stage takes the head and loss once over the
    M trunk outputs (K1f, K1b once); 1F1B's last stage a microbatch (M
    each), and its other stages run each forward again in the backward's
    recompute (K2f twice)."""
    bps = depth // stages
    last = stage == stages - 1
    k2f = bps * PP_M * (2 if schedule == "1f1b" and not last else 1)
    k1 = (1 if schedule == "gpipe" else PP_M) if last else 0
    return {"cross_entropy_fwd": k1, "cross_entropy_bwd": k1,
            "flash_fwd": k2f, "flash_bwd": bps * PP_M, "gmm": 0, "tgmm": 0}


def _pp_case(world: int, name: str, dtype: str, axes, mesh, w1: dict,
             out: str, dims: dict = None) -> tuple:
    """One case's comparison from the ranks' files: ``(fields, checks)``,
    held to world 1's (``dims``: the rehearsal's sizes, else the
    cell's)."""
    d = {"vocab": 32768, "dim": 768, "depth": 12, "seq_len": 2048,
         "batch": 8, **(dims or {})}
    sizes = dict(zip(axes, mesh))
    stages, dp = sizes["pipe"], sizes["data"]
    backend = PP_WORLDS[world][1]
    tag = f"{name}_{dtype}"
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"{tag}_r{r}.json")) as f:
            ranks.append(json.load(f))
    upd = _by_jax_name(torch.load(os.path.join(out, f"{tag}_upd.pt")))
    ref = w1[dtype]
    checks = {}
    fields = {}
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], ref["losses"]))
    if dtype == "float32":
        zero = dict.fromkeys(ref["updates_jax"], 0.0)
        rel, leaf, groups = _update_diff(zero, upd, ref["updates_jax"])
        worst = max(leaf, key=leaf.get)
        attn = {k: e for k, e in leaf.items() if ".attn." in k}
        worst_attn = max(attn, key=attn.get)
        checks[f"{tag}_losses"] = loss_err <= PP_F32_TOL["loss_rtol"]
        checks[f"{tag}_updates"] = (
            rel <= PP_F32_TOL["update_rel"]
            and attn[worst_attn] <= PP_F32_TOL["attn_leaf_update_rel"]
            and leaf[worst] <= PP_F32_TOL["leaf_update_rel"])
        fields.update(update_rel_err=rel, worst_leaf=[worst, leaf[worst]],
                      worst_attn_leaf=[worst_attn, attn[worst_attn]],
                      worst_leaf_by_group=groups)
    else:
        checks[f"{tag}_losses"] = loss_err <= SPLIT_BF16_TOL["loss_rtol"]
        checks[f"{tag}_updates"], fields["split"] = split_bf16_check(
            w1["float32"]["updates_jax"], ref["updates_jax"], upd)
    checks[f"{tag}_second_loss_moved"] = all(
        r["losses"][1] != r["losses"][0] for r in ranks)
    checks[f"{tag}_repl_bitwise"] = len({r["repl_digest"]
                                         for r in ranks}) == 1
    full = ranks[0]["full_elements"]
    # tok, pos, ln_f and head (weight and bias)
    repl = (2 * d["vocab"] * d["dim"] + d["vocab"]
            + d["seq_len"] * d["dim"] + 2 * d["dim"])
    want_held = repl + (full - repl) // stages
    # and on the card: the bytes the rank holds once its state is built
    # are its state's, not the whole model's (None in a CPU rehearsal)
    checks[f"{tag}_held"] = all(
        r["held_elements"] == want_held
        and (r["held_bytes"] is None
             or r["held_bytes"] <= r["state_bytes"] + PP_HELD_SLACK)
        for r in ranks)
    per_rank = [{n: r["launches"][n] for n in EP_PER_STEP} for r in ranks]
    want = [{n: PP_STEPS * v for n, v in pp_per_step(
        name, r["stage"], stages, d["depth"]).items()} for r in ranks]
    checks[f"{tag}_launches"] = per_rank == want
    if dtype == "bfloat16":
        checks[f"{tag}_wgmma"] = all(
            r["launches_by_design"][n]["wgmma"] == r["launches"][n]
            for r in ranks for n in ("flash_fwd", "flash_bwd"))
    p50 = max(statistics.median(r["step_ms"][1:]) for r in ranks)
    p50_1 = statistics.median(ref["step_ms"][1:])
    cards = world if backend == "nccl" else 1
    steady = [[s for s in r["stats"][1:]] for r in ranks]
    fields.update(
        mesh=sizes, schedule=name, losses_ranks=[r["losses"]
                                                 for r in ranks],
        losses_world1=ref["losses"], loss_rel_err=loss_err,
        step_ms_ranks=[r["step_ms"] for r in ranks],
        step_ms_world1=ref["step_ms"], step_ms_p50_ranks=p50,
        step_ms_p50_world1=p50_1,
        tokens_per_s_per_rank=d["batch"] * d["seq_len"] / dp / (p50 / 1e3),
        tokens_per_s_per_gpu=d["batch"] * d["seq_len"] / (p50 / 1e3)
        / cards,
        tokens_per_s_world1=d["batch"] * d["seq_len"] / (p50_1 / 1e3),
        hop_bytes_a_step=[s[-1]["hop_bytes"] for s in steady],
        repl_sync_ms=[statistics.median(x["sync_ms"] for x in s)
                      for s in steady],
        bubble_measured=[statistics.median(
            1 - x["busy_ms"] / x["step_ms"] for x in s) for s in steady],
        held_elements_ranks=[r["held_elements"] for r in ranks],
        full_elements=full, want_held=want_held,
        held_bytes_ranks=[r["held_bytes"] for r in ranks],
        state_bytes_ranks=[r["state_bytes"] for r in ranks],
        held_slack_bytes=PP_HELD_SLACK,
        peak_mem_bytes_ranks=[r["peak_mem_bytes"] for r in ranks],
        peak_mem_bytes_world1=ref["peak_mem_bytes"],
        launches_ranks=per_rank, launches_want=want)
    return {tag: fields}, checks, ranks


def _bn_check(world: int, out: str, w1) -> tuple:
    """BatchNorm under the GSPMD step: the ranks' files against world 1's
    runs (``resnet_cifar.gspmd_steps`` on the global batch), float32 by
    ``BN_TOL`` and float64 by ``BN_F64_TOL``."""
    zero = dict.fromkeys(w1["float32"]["updates"], 0.0)

    def diff(ranks, ref):
        loss = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], ref["losses"]))
        stats = max(
            float((r["stats"][p][k] - ref["stats"][p][k]).abs().max())
            / max(float(ref["stats"][p][k].abs().max()), 1e-12)
            for r in ranks for p in ref["stats"] for k in ("mean", "var"))
        rel, leaf, _ = _update_diff(zero, ranks[0]["updates"],
                                    ref["updates"])
        worst = max(leaf, key=leaf.get)
        return loss, stats, rel, [worst, leaf[worst]]

    fields, checks = {}, {}
    for dtype, tol in (("float32", BN_TOL), ("float64", BN_F64_TOL)):
        ranks = [torch.load(os.path.join(out, f"bn_{dtype}_r{r}.pt"))
                 for r in range(world)]
        ref = w1[dtype]
        loss, stats, rel, worst = diff(ranks, ref)
        tag = "bn" if dtype == "float32" else "bn_float64"
        checks.update({
            f"{tag}_losses": loss <= tol["loss_rtol"],
            f"{tag}_stats": stats <= tol["stats_rel"],
            f"{tag}_updates": rel <= tol["update_rel"]
            and worst[1] <= tol["leaf_update_rel"],
            f"{tag}_ranks_equal": all(
                torch.equal(ranks[0]["updates"][k], r["updates"][k])
                for r in ranks[1:] for k in ref["updates"])})
        fields[dtype] = {
            "steps": len(ref["losses"]),
            "losses_ranks": [r["losses"] for r in ranks],
            "losses_world1": ref["losses"], "loss_rel_err": loss,
            "stats_rel_err": stats, "update_rel_err": rel,
            "worst_leaf": worst,
            "step_ms_ranks": [r["step_ms"] for r in ranks],
            "step_ms_world1": ref["step_ms"], "tolerance": tol}
    checks["bn_stats_moved"] = any(
        float((w1["float32"]["stats"][p]["mean"]).abs().max()) > 0
        for p in w1["float32"]["stats"])
    # world 1 against itself (the spread of two identical float32 runs),
    # and float32 against float64 over the float64 run's steps: how far
    # float32's rounding alone moves the updates
    _, _, rep_rel, rep_worst = diff([w1["repeat"]], w1["float32"])
    _, _, f32_rel, f32_worst = diff([w1["float32_long"]], w1["float64"])
    fields["world1_repeat"] = {"update_rel_err": rep_rel,
                               "worst_leaf": rep_worst}
    fields["world1_float32_vs_float64"] = {
        "steps": len(w1["float64"]["losses"]), "update_rel_err": f32_rel,
        "worst_leaf": f32_worst}
    return fields, checks


def check_pp_train(results):
    """Pipeline parallelism at full width: the dense GPT-2-small cell
    (vocab 32768, dim 768, 12 layers, 12 heads, T 2048, batch 8, SGD 0.01,
    fused loss), 3 steps.  World 1: the plain step (the GSPMD step of the
    unsplit model, ``tp_steps``) in this process, float32 and bf16.  Then
    ``PipelineParallel`` (``transformer_lm.pp_steps``) on two gloo rank
    processes on this card through the port's launcher at pipe 2, M = 4:
    GPipe in float32 and bf16, 1F1B in bf16 (``--pp-world 4``: a card a
    rank over NCCL, data 2 x pipe 2 GPipe and data 1 x pipe 4 1F1B, both
    dtypes).  Float32 losses and updates within ``PP_F32_TOL``, bf16 by
    ``SPLIT_BF16_TOL`` (C13); the repl leaves bit for bit across the
    ranks; each rank holding its blocks plus the repl leaves; K1f/K1b and
    K2f/K2b launches a rank a step as :func:`pp_per_step` says (wgmma in
    bf16), K3/K4 none; greedy ``generate`` from the unpacked seeded state
    equal to world 1's (the serve phases' tie rule).  Step ms p50, tokens/s
    a rank and a card, hop bytes a step, the repl reduction's ms, the
    measured bubble, peak memory a rank and the device bytes a rank holds
    once its state is built (its state's, ``PP_HELD_SLACK``).  With two
    ranks, ResNet-18 under the GSPMD step at data 2 against world 1
    (float32 over one step by ``BN_TOL``, float64 over two by
    ``BN_F64_TOL``, and world 1's float32 against its float64).  Then
    ``train_lm --parallel pp`` at world 1 at its defaults: the loss
    falls."""
    import gc
    import tempfile

    from tpu_dist_torch.benchmarks.resnet_cifar import gspmd_steps
    from tpu_dist_torch.examples import train_lm

    world = PP_WORLD[0]
    cases, backend = PP_WORLDS[world]
    cards = world if backend == "nccl" else 1
    if torch.cuda.device_count() < cards:
        raise RuntimeError(f"--pp-world {world} needs {cards} cards, this "
                           f"machine has {torch.cuda.device_count()}")
    prompts = _tp_prompts()
    # world 1: tp_train's steps when it ran in this call (the same steps)
    w1, parts_s = results.pop("_world1_dense", None), {}
    if w1 is None:
        w1 = {}
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            w1[dtype] = _world1_tp(dtype,
                                   prompts if dtype == "float32" else ())
            w1[dtype]["updates_jax"] = _by_jax_name(w1[dtype].pop("updates"))
            parts_s[f"world1_{dtype}"] = time.perf_counter() - t0
    bn = dict(BN_CELL) if world == 2 else None
    w1_bn = None
    if bn:
        t0 = time.perf_counter()

        def bn_run(dtype, steps):
            r = gspmd_steps(batch=bn["batch"], steps=steps, lr=bn["lr"],
                            dtype=getattr(torch, dtype))
            r["updates"] = {k: v.cpu() for k, v in r["updates"].items()}
            r["stats"] = {p: {k: v.cpu() for k, v in st.items()}
                          for p, st in r["stats"].items()}
            return r

        # float32 twice (world 1's own run-to-run spread); float64 over
        # the two steps, and float32 over them for its distance from it
        w1_bn = {"float32": bn_run("float32", bn["steps"]),
                 "repeat": bn_run("float32", bn["steps"]),
                 "float64": bn_run("float64", bn["float64_steps"]),
                 "float32_long": bn_run("float32", bn["float64_steps"])}
        parts_s["world1_bn"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="pp_train_", dir=os.environ.get("TMPDIR"))
    rc, ranks_s, err = _pp_ranks(out, world, cases, prompts, bn)
    parts_s["ranks"] = ranks_s
    checks = {"ranks_exit_0": rc == 0}
    fields = {}
    if rc == 0:
        for name, axes, mesh, dtype, _ in cases:
            f, c, ranks = _pp_case(world, name, dtype, axes, mesh, w1, out)
            fields.update(f)
            checks.update(c)
        first = cases[0]
        with open(os.path.join(out, f"{first[0]}_{first[3]}_r0.json")) as f:
            got = json.load(f)["generated"]
        want = w1["float32"]["generated"]
        checks["generate"] = got == want
        if got != want:
            import numpy as np

            from tpu_dist_torch.examples.train_lm import tp_trainer
            from tpu_dist_torch.models import TransformerLM
            model = TransformerLM(vocab_size=32768, dim=768, depth=12,
                                  num_heads=12, max_seq_len=2048,
                                  device="cuda")
            tp_trainer(model, 32768, 0.01)      # the seeded weights
            reqs = [{"prompt": np.array(p), "temperature": 0, "seed": 0,
                     "max_new_tokens": TP_GEN["max_new_tokens"]}
                    for p in prompts]
            verdicts = _tie_rule(model, reqs, got, want, torch.float32,
                                 "pp_train")
            checks["generate"] = all(ok for _, ok, _ in verdicts)
            del model
        fields["generate_equal"] = got == want
        if bn:
            fields["batchnorm_gspmd"], c = _bn_check(world, out, w1_bn)
            checks.update(c)
    emit("pp_train", world=world, cards=cards, backend=backend,
         steps=PP_STEPS, microbatches=PP_M,
         cases=[{"name": n, "mesh": dict(zip(a, m)), "dtype": d,
                 "schedule": s} for n, a, m, d, s in cases],
         ranks_seconds=ranks_s, ranks_rc=rc,
         tolerance={"float32": PP_F32_TOL, "bfloat16": SPLIT_BF16_TOL},
         world1={d: {k: w1[d][k] for k in ("losses", "step_ms",
                                           "peak_mem_bytes", "launches")}
                 for d in w1},
         seconds=parts_s, **fields, checks=checks,
         rank_stderr_tail=None if all(checks.values()) else err)
    ok = all(checks.values())
    del w1, w1_bn
    gc.collect()
    torch.cuda.empty_cache()

    # the entry point at world 1, its defaults, on the card
    args = train_lm.parse_args(["--parallel", "pp"])
    t0 = time.perf_counter()
    r = train_lm.train(args)
    cli_s = time.perf_counter() - t0
    losses = r["losses"]
    cli = {"finite": all(math.isfinite(v) for v in losses),
           "falls": losses[-1] < 0.5 * losses[0],
           "second_loss_moved": losses[1] != losses[0]}
    emit("pp_train_cli", steps=len(losses), first_loss=losses[0],
         last_loss=losses[-1], loss_every_20=losses[::20],
         seconds=cli_s, first_step_seconds=r["first_step_seconds"],
         loop_seconds=r["loop_seconds"], checks=cli)
    return ok and all(cli.values())


def _trees_bitwise(a: list, b: list) -> bool:
    """Two stage lists of ``{path: {leaf: tensor}}`` equal bit for bit."""
    return all(torch.equal(x[p][k], y[p][k]) for x, y in zip(a, b)
               for p in x for k in x[p])


def _pp_twin(out: str, device: str = "cuda") -> tuple:
    """The ``pipeline_train`` twin under the launcher on the card
    (``stage0:1,stage1:1``, ``PP_KILL``, a save every step): ``(fields,
    checks)`` — one gang restart, generation 1 resuming at step 5 with
    losses equal to the serial oracle's on the card float for float."""
    import signal

    from tpu_dist_torch import nn, optim
    from tpu_dist_torch.examples import pipeline_train as ex
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.pipeline import SerialPipelineRunner

    env = dict(os.environ, TPU_DIST_CHAOS=PP_KILL, OMP_NUM_THREADS="1",
               PYTHONPATH=_repo() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--roles",
         "stage0:1,stage1:1", "--max_restarts", "1", "-m",
         "tpu_dist_torch.examples.pipeline_train", "--device", device,
         "--steps", str(PP_TWIN_STEPS), "--out", os.path.join(out, "twin"),
         "--state-root", os.path.join(out, "twin_ckpt"), "--save-every",
         "1"], cwd=out, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        err = "timed out"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait(timeout=30)
    seconds = time.perf_counter() - t0
    g1 = _json(os.path.join(out, "twin", "stage1_l0_g1.json"), {})
    model = TransformerLM(vocab_size=ex.VOCAB, dim=ex.DIM, depth=ex.DEPTH,
                          num_heads=ex.HEADS, max_seq_len=ex.SEQ,
                          device=device)
    runner = SerialPipelineRunner(model, optim.SGD(lr=1e-2),
                                  nn.CrossEntropyLoss(), 2, 4)
    ref = {}
    for step in range(PP_TWIN_STEPS):
        x, y = ex.batch_for_step(step, 0, 8)
        ref[str(step)] = runner.step(torch.from_numpy(x).long(),
                                     torch.from_numpy(y).long())
    got = g1.get("losses", {})
    checks = {"twin_exit_0": proc.returncode == 0,
              "twin_gang_restart": "gang restart" in err,
              "twin_generation_1": g1.get("generation") == 1
              and g1.get("start") == 5,
              "twin_resumes_bitwise": bool(got) and got == {
                  k: ref[k] for k in got} and set(got) == {"5", "6"},
              "twin_preflight_ran":
                  "--verify_graph: note: graph from the --roles spec" in err,
              "twin_no_missing_preflight_note":
                  "without the verifier's pre-flight" not in err}
    return {"seconds": seconds, "losses_g1": got, "serial": ref,
            "stderr_tail": None if all(checks.values()) else err[-3000:]}, \
        checks


def _pp_tp_grid(steps: int = 2, cell: dict = None,
                device: str = "cuda") -> tuple:
    """dp x tp x pp on the host route at full width, depth 2 (TP_HOST's
    cell): ``build_tp_stage_fns`` for each (stage, tp rank) of a pp 2 x tp
    2 grid as ``PipelineStage`` threads (GPipe, M = 1) against
    ``SerialTPRunner`` at tp 2 (the serial composition), ``steps`` SGD
    steps: ``(fields, checks)``."""
    import queue
    import threading

    import numpy as np

    from tpu_dist_torch import nn, optim
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import tensor as ttensor
    from tpu_dist_torch.parallel.rules import DEFAULT_RULES
    from tpu_dist_torch.pipeline import PipelineStage, partition_model

    class Q:
        def __init__(self):
            self.q = queue.Queue()

        def put(self, tree, timeout=None):
            self.q.put(tree)

        def get(self, timeout=None):
            return self.q.get(timeout=timeout)

    h = cell or TP_HOST
    vocab = h["vocab"]

    def lm():
        return TransformerLM(vocab_size=vocab, dim=h["dim"],
                             depth=h["depth"], num_heads=h["heads"],
                             max_seq_len=h["seq_len"], device=device)

    def loss_fn(logits, y):
        return ce(logits.reshape(-1, vocab), y.reshape(-1))

    ce = nn.CrossEntropyLoss()
    model = lm()
    full = ttensor._full_params(model, 0)
    oracle = ttensor.SerialTPRunner(lm(), optim.SGD(lr=0.1), loss_fn, tp=2,
                                    seed=0)
    part = partition_model(model, 2)
    combiners = [ttensor.LocalCombiner(2) for _ in range(2)]
    act, grad = [Q(), Q()], [Q(), Q()]
    opt = optim.SGD(lr=0.1)
    stages, params, opt_states = {}, {}, {}
    for s in range(2):
        for t in range(2):
            stages[(s, t)] = PipelineStage(
                ttensor.build_tp_stage_fns(part, s, loss_fn,
                                           combiners[s].bound(t),
                                           rules=DEFAULT_RULES),
                s, 2, num_microbatches=1,
                out_act=act[t] if s == 0 else None,
                in_act=act[t] if s == 1 else None,
                in_grad=grad[t] if s == 0 else None,
                out_grad=grad[t] if s == 1 else None)
            params[(s, t)] = ttensor._to_device(ttensor.tp_shard_params(
                model, part.stage_params(full, s), t, 2, DEFAULT_RULES),
                device)
            opt_states[(s, t)] = opt.init(ttensor._flat_keys(
                params[(s, t)]))
    losses, want, ms = [], [], []
    rng = np.random.default_rng(0)
    try:
        for _ in range(steps):
            x = rng.integers(0, vocab, (h["batch"], h["seq_len"]))
            y = rng.integers(0, vocab, (h["batch"], h["seq_len"]))
            results, errs = {}, []

            def run(s, t):
                try:
                    results[(s, t)] = stages[(s, t)].run_step(
                        params[(s, t)], x_mb=[xt] if s == 0 else None,
                        y_mb=[yt] if s == 1 else None)
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            xt, yt = x, y         # the engine takes the host's ids
            t0 = time.perf_counter()
            ths = [threading.Thread(target=run, args=(s, t), daemon=True)
                   for s in range(2) for t in range(2)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(300)
            if errs:
                raise errs[0]
            for key, res in results.items():
                opt.update(ttensor._flat_keys(res.grads), opt_states[key],
                           ttensor._flat_keys(params[key]))
            if device == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append([float(results[(1, t)].losses[0])
                           for t in range(2)])
            want.append(oracle.step(x, y)[0])
    finally:
        for st in stages.values():
            st.close()
    shards_equal = all(
        torch.equal(v, oracle.params[t][p][k])
        for (s, t), tree in params.items() for p, lv in tree.items()
        for k, v in lv.items())
    checks = {"grid_losses_bitwise": all(l == [w, w] for l, w in
                                         zip(losses, want)),
              "grid_shards_bitwise": shards_equal,
              "grid_second_loss_moved": want[1] != want[0]}
    return {"losses": losses, "serial": want, "step_ms": ms}, checks


def _pp_rig() -> tuple:
    """``PP_HOST``'s rig runs and checks: ``(seconds, fields, checks)``."""
    import gc

    from tpu_dist_torch.benchmarks import bench_pipeline as bp
    from tpu_dist_torch.pipeline import stash_bound

    h = PP_HOST
    args = (h["stages"], h["M"], h["steps"], h["batch"])
    parts_s, checks, fields = {}, {}, {}
    t0 = time.perf_counter()
    serial = bp.serial_run(*args, dims=h["dims"])
    parts_s["serial"] = time.perf_counter() - t0
    cells = {}
    for name, sched, comp in (("gpipe", "gpipe", None),
                              ("1f1b", "1f1b", None),
                              ("gpipe_int8", "gpipe", PP_INT8["compress"])):
        t0 = time.perf_counter()
        cells[name] = bp.run_cell(sched, *args, compress=comp,
                                  dims=h["dims"])
        parts_s[name] = time.perf_counter() - t0
        fields[name] = cells[name]["row"]
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("gpipe", "1f1b"):
        checks[f"{name}_losses_bitwise"] = \
            cells[name]["losses"] == serial["losses"]
        checks[f"{name}_params_bitwise"] = _trees_bitwise(
            cells[name]["params"], serial["params"])
    gp, f1 = cells["gpipe"]["row"], cells["1f1b"]["row"]
    checks["stash_within_bound"] = all(
        f1["stash_peak_count"][i] <= stash_bound("1f1b", i, h["stages"],
                                                 h["M"])
        and gp["stash_peak_count"][i] == h["M"] for i in range(h["stages"]))
    checks["stash_1f1b_below_gpipe"] = (f1["stash_peak_bytes"][0]
                                        < gp["stash_peak_bytes"][0])
    int8_err = max(abs(a - b) / abs(b) for a, b in zip(
        cells["gpipe_int8"]["losses"], serial["losses"]))
    checks["int8_loss_within"] = int8_err <= PP_INT8["loss_rtol"]
    fields.update(serial_losses=serial["losses"], int8=dict(
        PP_INT8, losses=cells["gpipe_int8"]["losses"], rel_err=int8_err))
    del cells, serial
    gc.collect()
    torch.cuda.empty_cache()
    return parts_s, fields, checks


def check_pp_host(results):
    """The host route at full width (``PP_HOST``): the in-process rig
    (``benchmarks.bench_pipeline.run_cell``: a thread and a data plane a
    stage) runs GPipe, 1F1B and GPipe with the int8_block256 wire; their
    losses and final parameters against ``SerialPipelineRunner`` bit for
    bit (the int8 wire's losses within ``PP_INT8``), 1F1B's stash within
    its bound and below GPipe's; tokens/s, the closed-form and the measured
    bubble.  Then dp x tp x pp at depth 2 (``build_tp_stage_fns`` on a pp
    2 x tp 2 grid against ``SerialTPRunner``, bit for bit).  (The
    ``pipeline_train`` twin's gang restart: the ``faults`` phase.)  No
    kernel counts are asserted here: the rig runs float32 (K2's fma
    design) and the unfused loss, as the JAX bench does."""
    parts_s, fields, checks = _pp_rig()
    emit("pp_host", cell=PP_HOST, seconds=parts_s, **fields, checks=checks)
    ok = all(checks.values())
    t0 = time.perf_counter()
    grid, c = _pp_tp_grid()
    emit("pp_host_grid", cell=TP_HOST, **grid,
         seconds=time.perf_counter() - t0, checks=c)
    return ok and all(c.values())


def check_faults(results):
    """The launches that wait on an injected fault, run at once: the
    flight recorder's stall to the heartbeat deadline (:func:`_obs_stall`),
    the network chaos layer's corrupt frames (:func:`_netchaos_corrupt`)
    and the ``pipeline_train`` twin's SIGKILL and gang restart
    (:func:`_pp_twin`).  Each check is of function (an error named, a
    diagnosis, a resume bit for bit); the seconds they print share the
    host and are no metric, and no other phase's timed window runs beside
    them."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    def twin() -> bool:
        out = tempfile.mkdtemp(prefix="pp_twin_",
                               dir=os.environ.get("TMPDIR"))
        fields, c = _pp_twin(out)
        emit("pp_host_twin", **fields, checks=c)
        return all(c.values())

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with ThreadPoolExecutor(max_workers=3) as pool:
        runs = [pool.submit(fn) for fn in (_obs_stall, _netchaos_corrupt,
                                           twin)]
    oks = []
    for f in runs:
        try:
            oks.append(f.result())
        except Exception:  # report every launch, then fail
            traceback.print_exc()
            oks.append(False)
    return all(oks)

PHASES = (("cross_entropy", check_cross_entropy), ("flash", check_flash),
          ("gmm", check_gmm), ("slice", check_slice),
          ("composition", check_composition), ("moe_slice", check_moe_slice),
          ("moe_layer", check_moe_layer),
          ("moe_composition", check_moe_composition),
          ("serve", check_serve), ("serve_int8", check_serve_int8),
          ("quant", check_quant), ("convnet", check_convnet),
          ("resnet", check_resnet), ("optim", check_optim),
          ("resume", check_resume), ("flash_offdiag", check_flash_offdiag),
          ("split_diag", check_split_diag), ("ring", check_ring),
          ("sp_train", check_sp_train), ("augment", check_augment),
          ("imagenet", check_imagenet), ("vit", check_vit),
          ("launch", check_launch), ("launch_restart", check_launch_restart),
          ("gateway", check_gateway), ("store", check_store),
          ("moe_dispatch", check_moe_dispatch), ("llama", check_llama),
          ("long_32k", check_long_32k), ("serve_rope", check_serve_rope),
          ("zero_ddp", check_zero_ddp), ("zero_opt", check_zero_opt),
          ("elastic", check_elastic), ("host_ring", check_host_ring),
          ("host_zero", check_host_zero), ("quant_gate", check_quant_gate),
          ("vgg", check_vgg), ("accuracy", check_accuracy),
          ("twins", check_twins), ("obs", check_obs),
          ("sanitize", check_sanitize),
          ("roles", check_roles), ("cluster_failover", check_cluster_failover),
          ("cluster_elastic", check_cluster_elastic),
          ("netchaos", check_netchaos),
          ("serve_sharded", check_serve_sharded),
          ("serve_disagg", check_serve_disagg),
          ("ep_train", check_ep_train), ("tp_train", check_tp_train),
          ("pp_train", check_pp_train), ("pp_host", check_pp_host),
          ("faults", check_faults))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run; prints no result "
                         "line")
    ap.add_argument("--ep-world", type=int, default=2,
                    choices=sorted(EP_WORLDS),
                    help="ep_train's ranks: 2 on one card (the default) or "
                         "4 on four cards")
    ap.add_argument("--tp-world", type=int, default=2,
                    choices=sorted(TP_WORLDS),
                    help="tp_train's ranks: 2 on one card (the default) or "
                         "4 on four cards")
    ap.add_argument("--pp-world", type=int, default=2,
                    choices=sorted(PP_WORLDS),
                    help="pp_train's ranks: 2 on one card (the default) or "
                         "4 on four cards")
    args = ap.parse_args()
    EP_WORLD[0] = args.ep_world
    TP_WORLD[0] = args.tp_world
    PP_WORLD[0] = args.pp_world
    only = [p for p in args.only.split(",") if p]
    unknown = set(only) - {name for name, _ in PHASES}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to smoke-test",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import tpu_dist_torch  # noqa: F401  (fails alone, without the repo)
    from tpu_dist_torch.ops import _build
    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    gm = importlib.import_module("tpu_dist_torch.ops.gmm")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    t0 = time.perf_counter()
    # one nvcc per CUDA source and g++ for the store's library, all at once
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as pool:
        host = pool.submit(_build.build_host, "tcpstore")
        _build.build_all()
        store_lib = host.result()
    fa._lib()
    gm._lib()
    emit("build", seconds=time.perf_counter() - t0,
         store_library=os.path.basename(store_lib),
         ptxas={name: [ln.strip() for ln in
                       _build.compile_log(name).splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling" in ln]
                for name in _build.SOURCES})

    results: dict = {}
    failed = []
    for name, fn in PHASES:
        if only and name not in only:
            continue
        t_phase = time.perf_counter()
        try:
            ok = fn(results)
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            ok = False
        emit("phase_seconds", name=name,
             seconds=time.perf_counter() - t_phase, ok=bool(ok))
        if not ok:
            failed.append(name)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if only:
        print(f"chip_smoke: phases {only}: "
              f"{'FAILED ' + str(failed) if failed else 'passed'}",
              file=sys.stderr)
        return 1 if failed else 0

    kernels = []
    for name, (kid, route, source, replaces) in KERNEL_INFO.items():
        r = results.get(name, {})
        kernels.append({"name": name, "id": kid, "route": route,
                        "source": source, "replaces": replaces,
                        "launches": r.get("launches"),
                        "max_abs_err": r.get("max_abs_err"),
                        "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                        "bound_ms": r.get("bound_ms"),
                        "bound_by": r.get("bound_by"),
                        "library_ms": r.get("library_ms")})
        if any(kernels[-1][k] is None for k in
               ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms")):
            failed.append(f"{name}: missing numbers")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
