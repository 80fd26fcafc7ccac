#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``fedml_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-split   # only: serving's round split

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases,
each printed as it ends; any failure exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — ``nvcc`` builds every kernel under ``fedml_tpu_torch/csrc/``;
3. kernel robust_agg — the fused clip + noise + mean kernel (K1) against
   its plain PyTorch version, leaf by leaf (a one-leaf table) at every
   leaf size of the FEMNIST CNN and one odd size, sigma 0 and 0.025: max
   abs error, bit-equal noise uniforms, kernel / plain / ``torch.addmv``
   times and the bound (bytes; f32, integer and special-function
   operations at their lanes per SM a clock); then the path's form, one
   norm launch and one aggregate launch over a table of the CNN's leaves,
   the odd size and an unaligned leaf, at clip 5.0 and none, sigma 0 and
   0.025, within 1e-5 of the plain versions, two launches bit-equal, the
   SFU Gaussians of all 16.9 M (leaf, client, element) samples within
   K1_GAUSS_TOL of the precise ones; the table launch's and the norm
   pass's times beside the plain aggregate and the eager clip pass;
4. slice — defended FedAvg (weak DP, fused CUDA backend) on the FEMNIST
   CNN at full width, 3400 clients, 10 per round, B=20, lr 0.1, E=1, 3
   rounds, through the CLI's runner; exactly one norm launch and one
   aggregate launch a round.  Then one round from the same init and seed
   words with TF32 off, held against the port on the CPU;
5. kernel secagg_mask — the fused quantize + pairwise-mask kernel (K3)
   against its plain PyTorch version leaf by leaf (the pair seeds given)
   at every leaf size of the CNN and one odd size, groups of 5 and 10:
   bit-equal ring values, the masks cancelling on the card, times and
   bounds; then the path's form, one launch over a table of the CNN's
   leaves, the odd size and an unaligned leaf with the pair keys derived
   in the launch (each pair once), bit-equal leaf by leaf, its one-buffer
   ring sum equal to the per-leaf sums, the per-row walk (one row, two
   rows) equal to the group's rows, the launch's salts bit-equal to
   ``pair_seeds`` + ``leaf_seeds``; its time at a group of 5;
6. turboaggregate slice — secure FedAvg (two groups of 5, cuda backend) on
   the same CNN, data and widths, 3 rounds through the CLI's runner: the
   kernel launches exactly once per group and round (2 x 3); a per-part
   split of a round and the device's idle share; one round with TF32 off
   against the CPU (limit clients_per_group / scale + 1e-4); one round
   with group 1 recovered from its LCC shares against the direct round
   (limit 1e-3);
7. kernel shard_finalize — the fused shard finalize (K2) against its plain
   PyTorch version at the FEMNIST CNN's four shard sizes at S=4, at S=1,
   at sizes 3, 1 and 0 mod 4, at 3 elements (less than one float4) and on
   a view 4 bytes past a 16-byte boundary (the unaligned path), sigma 0
   (bit-equal) and 0.025 (bit-equal noise uniforms; the output within
   1e-6 abs), with a non-zero step and shard salt: device time per launch,
   the wrapper's host cost, the plain version's time and ``torch.div``'s
   by a device scalar (the same function, bit for bit) and by a Python
   float (a multiply by the reciprocal), the bytes and operations bounds;
   the path's shards at sigma 0 timed again in reverse order, the
   divisions first;
8. cross-silo slice — live cross-silo FedAvg over the in-process hub with
   the sharded spine (S=4, K2 on, clip 5.0, sigma 0.025) on the same CNN,
   data and widths, 3 rounds through the CLI's runner: K2 launches exactly
   4 x 3 times and K1 and K3 never; a per-part split of 3 rounds
   (broadcast, wire, silo training, admission, fold, finalize, eval), the
   kernel launches per round and the device's idle share; one round with
   TF32 off against the CPU (limit 1e-4);
9. kernel flash_attention — what the compiler made of K4 (each kernel's
   registers, spills and shared memory from ptxas and the library; with
   ``cuobjdump``, its tensor-core instructions in SASS: every kernel must
   have some at every head size); then K4's forward (K4f) and its
   backward's dK/dV (K4dkv) and dQ (K4dq) kernels against their plain
   PyTorch versions (TF32 off; o, m, l within 1e-5 x max|ref|, dq, dk, dv
   within 1e-4 x max|ref|) at [B, T, H, d] = [2, 2048, 8, 32] (bench.py's
   step), [8, 2048, 8, 32] (4 clients x B=2 folded by vmap), T=128, T=384
   and at d=16 and d=64 ([2, 256, 4, d]): device time per launch (CUDA
   events, median of 20), the plain versions' times,
   ``scaled_dot_product_attention``'s forward, forward + backward and
   backward alone (a yardstick), the bounds (bytes, TF32 products, exps at
   the SM's maximum clock; the f32 SIMT bound beside them) and the
   wrappers' host cost; a NaN in q and one in dO come out as NaN in every
   row they reach;
8a. device round — plain FedAvg on the same CNN, data and widths: the
   train split resident on the card, 3 rounds of the graphed device round
   (one CUDA-graph capture, one replay a round, counted exactly) against 3
   rounds of the host-gather loop, bit-equal with cuDNN deterministic and
   TF32 off (the default mode's difference recorded), one round against
   the port on the CPU (limit 1e-4); the host loop, the K=1 graph and the
   K=10 scanned graph profiled over 10 rounds each: host µs, wall ms,
   device kernels and host launch calls a round, busy time, idle share,
   capture time;
8b. scanned rounds — 21 rounds, evaluation every 10, through the CLI's
   runner: the host loop, the K=1 graph and ``--rounds_per_dispatch 10``;
   evaluation at rounds 0, 10 and 20 on each, the final params bit-equal
   in deterministic mode, steady rounds/s and capture time in both modes;
8c. byzantine — ``--algo fedavg_robust --defense <rule>`` for the five
   rules (Krum with f=2, multi-Krum with f=2, m=3): one round on the card
   (TF32 off) against the CPU (limit 1e-4), Krum's selections equal;
8d. cross_silo robust — one round on the hub, card against CPU, of the
   defended stack (trimmed mean, clip 5) and of a rule over the stream's
   reservoir (coordinate median, K=8); the defended mean in stack and in
   stream mode (clip 5, sigma 0.025, 2 rounds) bit-equal on the card;
8e. checkpoint — a 4-round run against a run stopped after round 2 and
   resumed from its checkpoint, through the CLI's runner, bit-equal on
   the card (deterministic mode);
8f. cross_silo crash resume — the cross-silo slice (S=4, K2 on) with
   ``--checkpoint_dir`` and ``--journal_dir`` (a snapshot every fold),
   killed in round 1 by a ``Faultline`` at ``post_admission_pre_fold``
   (hit 2), ``post_fold_pre_ack`` (hit 2), ``barrier_close`` and
   ``mid_checkpoint_write``, respawned and resumed in the same process:
   each resumed global bit-equal on the card to the uncrashed run's
   (deterministic mode), 4 K2 launches a round closed after the resume,
   the silos re-tasked; a journal with a tampered opening crc abandoned
   and the run still equal; each snapshot's device->host, encode, write
   and fsync times; the journaled round beside the plain one;
8g. cross_silo chaos threaded — the same federation, each actor on its
   own thread, 4 rounds under ``--chaos_drop/dup/reorder/delay 0.1
   --chaos_corrupt 0.05`` (silo 1's links clean) with the drop policy,
   heartbeats every 0.05 s and the failure detector (T and D from the
   measured round): every round closes, faults by kind, no upload folded
   twice, none non-finite, 4 K2 launches a round, each round's global
   against its replay from the server's record (limit 1e-4); rounds/s and
   the device's idle share;
8h. cross_silo mqtt — the same federation over the repo's MQTT broker on
   the loopback (10 silo threads, ``MiniMqttClient`` in
   ``ResilientTransport``), 3 rounds: 4 K2 launches a round, the global
   against the pumped hub run (limit 1e-4), rounds/s, the broker's bytes
   a round, the MQTT round beside the hub round;
8i. live secagg — ``--secagg pairwise`` over the hub, 10 silos, threshold
   6 (the majority rule), 3 rounds on the same CNN, data and widths, the
   drop policy with the straggler timeout delivered by hand: silo 4 dies
   after its round-2 advert and the round recovers through the
   pair-secret shares.  Each unmasked ring sum equal, word for word, to
   the ring sum of the survivors' unmasked quantized uploads; each global
   within 1e-3 of the plaintext stream run with the same loss; a kill at
   ``mid_unmask`` in round 2 leaves the boundary checkpoint and the
   server's global at round 1's, and the re-run equals the clean run bit
   for bit (deterministic mode); a run losing 5 of 10 uploads fails the
   unmask loudly with the global kept.  Prints a round's split (advert,
   agreement, masking on the card, ring fold, unmask with its
   reconstructions, finalize, training, wire), rounds/s and one silo's
   masking on the card beside the same code on CPU tensors (frames
   bit-equal);
8j. live server_opt — ``--server_opt adam`` on the sharded spine (S=4, K2
   on; exactly 4 x 3 K2 launches, counted from 0 just before the run),
   ``momentum`` and ``fedac`` on the replicated stream, 3 rounds each;
   one round of each with TF32 off against the CPU (limit 1e-4; adam's
   round at its finalized mean, and its step on the same inputs within
   1e-6); a kill at ``post_fold_pre_ack`` in round 2 resumed from the
   journal bit-equal, the optimizer's state too; a resume under
   ``--server_opt momentum`` refused;
8k. algorithm zoo — ``--algo fedopt|fedprox|fednova|scaffold|feddyn|
   ditto|fedac|dp_fedavg``, 3 rounds each through the CLI's runner on the
   CNN (SCAFFOLD, FedDyn and Ditto keep a host model per client and run
   at 200 clients; the rest at 3400): the path taken (graphed device
   round or host loop), host launch calls and device kernels a round,
   the round's ms and the device's idle share over 3 more rounds; one
   round with TF32 off against the CPU (limit 1e-4; DP-FedAvg's ε equal);
8l. cross-device — ``--algo cross_device`` on the CNN at 3400 clients,
   1000 a round in waves of 256 (the last 232 live), 2 rounds each of
   ``--local_alg sgd``, ``fedprox`` (mu 0.1), ``fednova``, ``sgd
   --server_opt adam`` and ``scaffold`` (200 clients, 100 a round, waves
   of 32): rounds/s, peak memory, one round's split a wave (gather,
   training, admission, fold; SCAFFOLD's state gather and scatter) and,
   for sgd and scaffold, one profiled round (host launch calls, device
   kernels, idle share); one
   round of each local algorithm with TF32 off against the CPU at 16 a
   round in waves of 8 (limit 1e-4; FedNova at its finalized mean, its
   tau_eff step scaling that difference and nothing more); one round in
   waves of 256 against one wave of 1000 (deterministic mode, limit
   ``WAVE_CHUNK_TOL``; bit-equality reported); ``--sampler jax``'s waves
   equal to ``prng.permutation``'s first 1000; ``--model cnn`` (dropout
   on) in waves of 32 against one wave of 100, and against another seed's
   masks; a resume from round 1's checkpoint bit-equal to the straight
   run; BASELINE config 4 (``resnet18_gn`` on ``fed_cifar100``, 500
   clients, 10 a round) with fedprox and fednova, 2 rounds, fedprox
   profiled the same way and its round against the CPU on 4 clients; one
   round of
   ``resnet56`` on the
   ``cifar10`` twin; the phase's seconds;
8m. zoo_models — BASELINE config 5's LSTMs through FedAvg (``--model
   rnn``: Shakespeare, 715 clients, 10 a round, B=4, lr 1; StackOverflow,
   342,477 clients, 50 a round, B=16, lr 10^-0.5), and the BatchNorm
   ResNet-56 and MobileNet (``stateful=True``, the cifar10 twin, 10
   clients, B=64, lr 0.1), each in deterministic mode: 2 host-loop rounds
   and 2 graphed rounds from one init, bit-equal; a cohort step of round
   0's first 2 clients against the CPU (limit 1e-4); rounds/s and round
   ms of each path, one profiled
   graphed round (host launch calls, device kernels, idle share), peak
   memory, the running statistics moved; config 3's live cross-silo federation (S=4,
   K2 on; E=1, cut from 20) on ``resnet56`` and ``mobilenet``, 2 rounds
   each through the runner: exactly 4 K2 launches a round, one round of 2
   silos against the CPU at
   ``CONFIG3_PARITY_EPOCHS`` (1); the
   BatchNorm ResNet-56 through the defended mean (weak DP, fused
   backend): K1n's and K1's launches a round counted on the main path,
   both held against their plain versions over its 292-leaf table at
   clip 5 and at a bound under every update norm (every statistics leaf
   the unclipped weighted mean), timed beside their bounds; ``--algo
   centralized`` through the runner, and the full-batch oracle on LR
   over the mnist twin (full-participation FedAvg against centralized
   training, rtol 2e-4, atol 2e-5, accuracy 1e-3);
8n. live machinery — on the CNN at config 2's widths (3400 clients, 10
   silos or 10 a round, B=20, lr 0.1, E=1), each run through the CLI's
   runners on the card, one ``live <run>`` line each: (1) the sharded
   spine (S=4, K2 on, clip 5, sigma 0.025), 3 rounds inline and with
   ``--ingest_pipeline``: the globals bit-equal, K2 exactly 4 x 3 in each
   and K1 and K3 never, one pinned-arena copy per upload and shard
   (and, where the profiler names its memcpys, that many pinned H2D
   copies in a profiled pipelined round), the admission ms a round on
   each path; (2) the same spine with ``--straggler_policy drop
   --round_timeout_s 30 --adaptive_deadline --min_quorum 0.6
   --adversary 2:scale:20,3:nan_bomb`` for 4 rounds: silo 3's NaN never
   reaches the global, silo 2 struck and quarantined, the tracker's
   deadlines and verdicts; its first round against the CPU (TF32 off,
   1e-4); (3) flat ``--wire_compression topk --error_feedback`` and
   ``int8``, 3 rounds each: wire bytes against the uncompressed bytes,
   one round of each against the CPU (1e-4); (4) ``--algo async_fl``, 10
   silos, goal 5, stream, clip 5, adam (lr 0.01), journaled, 6 versions:
   versions/s, the mean staleness, a kill at the last version's barrier
   close resumed bit-equal to the straight run, the first version's
   finalize (1e-4) and Adam step (1e-6) against the CPU; (5)
   ``--edge_aggregators 2`` plaintext and ``--secagg grouped``, 3 rounds:
   grouped against plaintext within ``SECAGG_TOL``, an edge killed after
   a fold in round 1 resumed from its journal bit-equal; (6) ``--algo
   hierarchical --group_num 2 --group_comm_round 2``, 3 rounds: round ms,
   ``group_num 1 / group_comm_round 1`` against ``--algo fedavg`` (1e-5),
   one round of 4 clients against the CPU (1e-4), these without their
   evaluation; (7) phase 8l's wave engine (1000 a
   round in waves of 256), 2 rounds inline and with ``--ingest_pipeline``,
   both with ``--wave_adversary 1:0:nan_bomb``: bit-equal, the poisoned
   wave rejected; one API round with a `ReliabilityTracker` merging the
   indebted clients into the next round's cohort; the phase's seconds;
8o. observability — the spine of 8n (S=4, K2 on, clip 5, sigma 0.025), 3
   rounds with ``--perf --perf_strict --device_obs --health --telemetry``
   and the span tracer, in ABBA turns with every instrument off (globals
   bit-equal, K2 exactly 4 x 3 in each, the round ms on and off: the
   instruments' overhead), then ``--ingest_pipeline`` and ``--adaptive``
   with ``--slo`` thresholds; the stacked defended cross-silo round
   (``--agg_mode stack``, clip 5, sigma 0.025; 2 rounds on and off,
   globals bit-equal; no hand-written kernel runs in it, and K1 and K1n
   have no instrumented path in either package); the wave engine (1000
   a round, waves of 256, 2 rounds) with perf, health, the SLOs and the
   controller;
   ``--algo async_fl`` (goal 5, 3 versions) and the edge tier (2 x 5
   silos, 2 rounds) with perf and health.  Every ledger line passes the
   port's ``trend.validate_ledger``, ``critical_path.validate_record``
   and ``validate_health_ledger``; each device section has backend cuda,
   memory in use, a peak under the limit, 0 < mfu <= 1 (flops complete
   on the spine) and compile entries in its first round only; the trace
   has one root span a round with ``recv:`` children on every silo's
   track; ``obs.report`` renders the run dir;
10. transformer slice — FedAvg through the API on bench.py's long-context
   TransformerLM (vocab 256, d_model 256, 8 heads, 2 layers, d_ff 1024,
   T=2048, flash on), 16 clients, 4 per round, B=2, lr 0.1, E=1, 3
   rounds, as replays of one captured CUDA graph: the graph holds
   n_layers x S launches of each K4 kernel (the wrappers' counts during
   the capture and the graph's own kernel nodes, from its Graphviz dump),
   it replays once a round, the warm-up round launches n_layers x S of
   each, and evaluation launches K4f only; a per-part split of a
   host-loop round, its launches and the device's idle share; one round
   with TF32 off against the same round with flash off (auto-blockwise,
   limit 1e-4); bench.py's long-context grad step (B=2, T=2048, 10
   steps), flash on and off;
11. transformer cli — 3 rounds of the dense Shakespeare transformer (the
   JAX CLI's widths, 715 clients, 10 per round, B=4, SGD lr 1) through
   the CLI's runner (graphed device rounds): rounds/s and a finite loss;
8p. mixed precision — the bf16 K4f, K4dkv and K4dq (their registers,
   spills and tensor-core instructions in phase 9's build report) against
   their plain versions (cuBLAS without bf16 reductions, TF32 off) at
   [8, 2048, 8, 32] and at d = 16 and 64 (T=256): o, dq, dk, dv within
   2^-7 x max|ref|, m and l within 1e-5 x max|ref|; their times, the
   plain versions', the bounds (bf16 products at 989.4 TF/s, bytes, exps)
   and SDPA's bf16 forward and backward; phase 10's transformer under
   ``--compute_dtype bfloat16`` through the API, graphed, its bf16 K4
   launches counted as phase 10 counts the f32 ones, its round ms and
   peak memory beside the f32 slice's, one step of 1 client against the
   CPU (limit ``BF16_ROUND_TOL`` x the step's move); bench.py's
   transformer_T2048_moe8 (8 Switch experts, blockwise attention) in bf16
   and f32 the same way, the tokens its routing drops over capacity, the
   f32 step against the CPU (1e-4); one bf16 run of 2 rounds each of the
   FEMNIST CNN (graphed), the BatchNorm ResNet-56 (running statistics
   f32) and the defended FedAvg (K1n and K1 once a round, on f32 leaves),
   and EfficientNet-B0 and VGG-11 on the cifar10 twin in f32, each
   leaf f32 and a cohort step of 2 clients against the CPU; the phase's
   seconds;
8q. serving — (a) the live cross-silo slice (S=4, K2 on, clip 5, sigma
   0.025, TF32 off) with ``--release_gate true`` and an ephemeral
   ``--serve_port``, 3 rounds, while 4 client threads POST test rows to
   ``/predict`` and one polls ``/version``: each answer within 1e-4 x
   max|y| of the CPU forward under the version it names, per client
   versions never going down and only promoted ones answering,
   ``/version`` advancing to the last promoted version, every other
   answer a 429 with a named shed reason or a 503 ``no_model`` (anything
   else fails), K2 exactly 4 a round, the verdicts equal to the same
   run's on the CPU (its gate fed the shadow snapshots the card's took),
   sheds by reason, ``/predict`` p50
   and p99, round ms against the same run with serving off; then 2
   rounds with ``--serve_workers 2`` (the pool), the same checks; (b) the
   cross-device engine on the JAX package's poisoned fixture
   (``--wave_adversary 3:0:scale:1000000``, 4 rounds) from JAX's init
   (``tests/data/release_fixture_init.npz``) through
   ``ReleaseController``: verdicts and divergences equal to the CPU's
   and to JAX's (0.46875, 0.46875, 0.484375), version 4 never live; (c) continuous-batching decode at phase 10's
   width (8 slots, cache 2048, 96 requests of 4 prompt tokens and 44 new
   tokens for every 4th, 4 for the rest), a hot swap after step 60: one
   CUDA-graph capture in all, every step's logits within 1e-4 x
   max|logit| of the dense full forward under the version its request
   names, the tokens greedy by it (near-ties listed), the graphed step
   bit-equal to the eager one; step ms graphed and eager, tokens/s and
   occupancy continuous and drain, peak GB;
8r. mesh — data parallelism over ``torch.distributed`` (run after 8o):
   the FEMNIST CNN at config 2's widths (10 a round, B=20, lr 0.1, E=1;
   340 of its 3400 clients), ``--deterministic true`` (cuDNN's
   deterministic algorithms, TF32 off), each run's globals checkpointed
   by rank 0 every round; the runs on 2 ranks are ``python -m
   fedml_tpu_torch`` subprocesses, the others ``main(argv)`` in this
   process.  FedAvg over 6 rounds, each run alone: in one process, in one
   process training its cohort as the 2-rank mesh's two blocks of 5, with
   ``--mesh_clients 1`` (one rank, NCCL) and ``--mesh_clients 2`` (two
   ranks sharing the card, gloo); then together, over 2 rounds,
   ``--algo scaffold`` (200 clients) in one process and on 2 ranks,
   ``--algo hierarchical --group_num 2`` in one process and on the
   ``--mesh_groups 2 --mesh_clients 1`` two-level mesh.  Every rank's
   params byte-equal (their sha256), the written globals rank 0's, each
   mesh run within ``MESH_TOL`` x max|w| of its references after every
   round (``MESH_HELD``: the 2-rank FedAvg run of its blocked run, and of
   the plain run after round 1), every run on the card with the
   backend its layout picks; the round ms and the ms a round spent in
   collectives of each run (mean, median, least, largest of the steady
   rounds); no hand-written kernel runs on this path;
8s. parallel — sequence and pipeline parallelism and the wave mesh (run
   after 8r), deterministic (TF32 off): (a) dp x sp FedAvg on phase 10's
   T=2048 LM (4 clients a round, B=2, f32) on the ``[1, 2]`` mesh, two
   gloo ranks sharing the card (``spawn_ranks``), over 3 rounds, each
   round's globals within ``PAR_SP_TOL`` x max|w| of one process running
   the same rounds with blockwise attention (block 256), the ranks
   byte-equal; the round ms, the ring's ms (its shifts' CUDA events) and
   each rank's peak GB beside the reference's; (b) on the same ranks the
   CLI's ``--mesh_sequence 2 --num_processes 2 --attn_flash`` runner on
   the LM twin at the CLI's widths (the Shakespeare twin's 80 tokens are
   below K4's 128), 2 rounds, K4f counted in its evaluation and no K4
   backward; (c) ``--algo cross_silo --mesh_stages 2`` on the Shakespeare
   twin, dense and ``--moe_experts 4``, both stages on the card, against
   ``--mesh_stages 1`` at the same 2 microbatches every round
   (``PAR_PP_TOL`` x max|w|); (d) ``--algo cross_device --mesh_clients
   2`` on the FEMNIST CNN (340 clients, 100 a round in waves of 32), 2
   rounds, the ranks byte-equal and within ``PAR_WAVE_TOL`` x max|w| of
   the one-rank engine every round, the gather's ms a round;
8u. data layer — (a) LEAF MNIST at config 1's 1000 users (10 train
   samples a user), written as ``train/`` and ``test/all_data.json`` and
   read by the CLI's loader (``--data_dir``), 2 rounds of ``--algo
   fedavg_robust --model lr --defense weak_dp --defense_backend cuda``,
   10 clients a round: K1n and K1 once a round each, the globals within
   ``ROUND_TOL`` of the same run on the CPU (TF32 off); (b) that split
   saved with ``save_stacked``, memory-mapped back, 2 FedAvg rounds from
   the map over the device-data budget (the host gather) bit-equal to 2
   from memory; (c) CIFAR-10's pickles at full size (50,000 + 10,000),
   the CLI's ``--partition_method hetero --partition_alpha 0.5`` over 10
   clients (each >= 10 samples) and one ResNet-56 round at E=1, B=64, 2
   clients a round (``DATA_CIFAR_PER_ROUND``, cut from 10) on the host
   gather (a graphed one-round run is mostly its capture):
   the load and partition seconds, each client's count, the round's ms,
   rounds/s and the peak GB; (d) ``cifar_train_augment`` and
   ``fed_cifar100_train_augment`` on a [10, 64, 32, 32, 3] tensor on the
   card bit-equal to the CPU with one key, and their ms a call;
8v. long tail — each run on the card against the same run on the CPU
   from the same init, TF32 off: (a) ``--algo decentralized`` on the
   FEMNIST CNN at full width (1,690,046 parameters a node), 10 nodes,
   ``--neighbor_num 4``, B=20, 3 rounds, every round's stacked nodes
   within ``LT_TOL`` x max|w|, the round's and the mix's ms and the peak
   GB; (b) ``--algo decentralized_online`` at the CLI's defaults (128
   nodes, T=100, the synthetic stream) in DOL, PUSHSUM and time-varying
   PUSHSUM, the final regret and z within ``LT_ONLINE_TOL`` relative,
   steps/s; (c) ``--algo split_nn`` on the FEMNIST twin, 4 clients, 2
   sweeps, and one client's epoch over the hub actors against the
   simulator's; (d) ``--algo vfl``, 2 parties, ``fit`` and the wire
   protocol against the joint step; (e) ``--algo fedgkt`` at full width
   (client ResNet-8, server layers (9, 9), GroupNorm) on the CIFAR-10
   twin, 4 clients, B=64, 2 rounds, the round's ms by part and the peak
   GB; (f) ``--algo fedavg_robust --backdoor --attacker_num 1 --defense
   weak_dp --defense_backend cuda`` on the FEMNIST CNN (100 clients, 10 a
   round, 2 rounds): K1n and K1 once a round each, the globals within
   ``ROUND_TOL`` of the CPU's, ``backdoor_acc`` equal; (g)
   ``--completion_signal`` writes the summary line;
12. a JSON line with each kernel's numbers (K1's norm pass beside K1; K1
   and K2 also at their library call's configuration, sigma 0; K2's
   launches are phase 8j's adam run's, phase 8's and 8q's beside them; K4's
   launches are the warm-up's and evaluation's plus the captured ones
   times the replays; the bf16 K4's those of phase 8p's bf16
   transformer), and a last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Exits non-zero, printing no result, when there is
no CUDA device or when the checkout around this file is missing.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

try:
    # the kernels' work (bytes and operations): one table, which the
    # device observatory's FLOP count reads too
    from fedml_tpu_torch.obs.device import (clip_norm_work, flash_work,
                                            robust_agg_work,
                                            secagg_mask_work,
                                            shard_finalize_bounds)
except ImportError:   # outside a checkout: main() says so and fails
    pass

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, non-tensor fp32
TF32_OPS_PER_S = 495e12        # H100 SXM data sheet, dense TF32 tensor cores
SFU_EXPS_PER_CLOCK = 16 * 132  # ex2 on the special-function units: 16 a
                               # clock on each of the H100 SXM's 132 SMs
# lanes a clock on the H100 SXM's 132 SMs, by kind of operation (CUDA
# programming guide, arithmetic instruction throughput, compute capability
# 9.0): f32 add and multiply (the kernels are built with -fmad=false, so no
# fused multiply-add counts twice), 32-bit integer add, multiply, shift and
# logic, and the special-function units (lg2, rsqrt, cos and the
# int <-> float conversions); every instruction passes the 4 dispatchers
OP_LANES_PER_CLOCK = {"fp32": 128 * 132, "int": 64 * 132, "sfu": 16 * 132}
DISPATCH_LANES_PER_CLOCK = 128 * 132
N_CLIENTS = 10
SIGMA = 0.025                  # the weak-DP stddev of the slice
KERNEL_TOL = 1e-5              # kernel vs plain, same device
ROUND_TOL = 1e-4               # GPU round (TF32 off) vs CPU round
COMMON_ARGS = ["--model", "cnn_fedavg", "--dataset", "femnist",
               "--client_num_in_total", "3400",
               "--client_num_per_round", str(N_CLIENTS), "--batch_size", "20",
               "--lr", "0.1", "--epochs", "1", "--comm_round", "3",
               "--frequency_of_the_test", "1000", "--log_stdout", "false"]
SLICE_ARGS = ["--algo", "fedavg_robust", "--defense", "weak_dp",
              "--defense_backend", "cuda", *COMMON_ARGS]
TURBO_ARGS = ["--algo", "turboaggregate", "--group_num", "2",
              "--secagg_backend", "cuda", *COMMON_ARGS]
GROUP_SIZES = (5, 10)          # secagg_mask check: the slice's group, 2x
DROPOUT_TOL = 1e-3             # tests/test_secure.py's recovery limit
SILO_ARGS = ["--algo", "cross_silo", "--silo_backend", "local",
             "--agg_mode", "stream", "--model_shards", "4",
             "--fused_finalize", "on", "--norm_clip", "5.0",
             "--agg_noise_std", str(SIGMA), *COMMON_ARGS]
K1_GAUSS_TOL = 2e-5            # K1's SFU Gaussian vs the precise one, abs
# K1's clip scales vs the plain version's, relative: both sum ~3.7 M squares
# in f32, in different orders (7.2e-8 apart on an H100 at phase 3's tree);
# a leaf left out of the norm moves a scale by 8e-6 or more
K1_SCALE_TOL = 4e-7
K1_UNCLIPPED = 2               # clients of phase 3's tree under the bound
CLIP_BOUND = 5.0               # the defended slice's norm bound
K2_STEP = 7                    # shard_finalize check: a non-zero round step
K2_NOISE_TOL = 1e-6            # K2 vs plain at sigma > 0 if not bit-equal
# profiler windows per time in phases 3 and 5's leaf-by-leaf rows: one
# (each window is a torch.profiler session of host time, and the script's
# time limit must hold every phase); the path's table rows keep 5
LEAF_WINDOWS = 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# the script's clock: each phase line carries its seconds since the start
_T0 = time.perf_counter()


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields,
                      "at_s": time.perf_counter() - _T0}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, trials: int = 5) -> float:
    """Per-call time of ``fn`` on the card: CUDA events around ``reps``
    back-to-back calls, after a warm-up; the median of ``trials`` such
    runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int, name: str = "", windows: int = 3):
    """Device time (ms) per call of ``fn``: the kernels it launches (those
    whose name contains ``name``), summed, from torch.profiler over
    ``reps`` calls; the median of ``windows`` such windows (one window can
    lose or garble launches), None if no window shows device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(_self_device_us(e) for e in prof.key_averages()
                       if name in e.key)
        if total_us > 0:
            per_call.append(total_us / reps / 1e3)
    return statistics.median(per_call) if per_call else None


def launch_device_ms(fn, reps: int = 20, name: str = "",
                     windows: int = 3):
    """Device time (ms) of one call of ``fn`` from torch.profiler: for each
    kernel (a row of ``key_averages()`` whose name contains ``name``) its
    mean over the launches the window recorded, times its launches a
    call; the median of ``windows`` windows that recorded one (at most
    twice as many tried), None if none did.  The profiler drops launches
    now and then, late in a long process (all of them in some windows):
    a partial window leaves the means right, where its sum over ``reps``
    calls would read low."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(2 * windows):
        if len(per_call) == windows:
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if name in e.key and _self_device_us(e) > 0]
        if rows:
            per_call.append(sum(_self_device_us(e) / e.count
                                * math.ceil(e.count / reps)
                                for e in rows) / 1e3)
    return statistics.median(per_call) if per_call else None


def call_profile(fn, reps: int = 5):
    """What one call of ``fn`` costs: its host time (µs, the device drained
    before and after), and from torch.profiler its kernel launches, their
    device time (µs) and the four largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {"host_us": host_us(fn, reps)}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    out["launches"] = sum(e.count for e in events) / reps
    out["device_us"] = sum(_self_device_us(e) for e in events) / reps
    top = sorted(events, key=_self_device_us, reverse=True)[:4]
    out["top_device_us"] = {e.key[:50]: _self_device_us(e) / reps
                            for e in top}
    return out


def _self_device_us(event) -> float:
    """Device time of a kernel row of ``key_averages()``; 0 for the rows of
    host operators, whose device time repeats their kernels'."""
    from torch.autograd import DeviceType
    if getattr(event, "device_type", None) != DeviceType.CUDA:
        return 0.0
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def op_bound(nbytes: float, ops, sm_hz: float):
    """The least time (ms) the card could take for work that moves
    ``nbytes`` and does ``ops`` ({"fp32": n, "int": n, "sfu": n}): the
    largest of the bytes over 3.35 TB/s and each kind of operation over
    its lanes at the SM clock ``sm_hz``.  ``bound_term`` names the term,
    ``bound_by`` says "bytes" or "operations"; ``dispatch_ms`` (every
    operation through the SMs' 128 dispatch lanes a clock) stays beside
    them, outside the bound."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    for kind, lanes in OP_LANES_PER_CLOCK.items():
        terms[kind] = ops.get(kind, 0) / (lanes * sm_hz) * 1e3
    term = max(terms, key=terms.get)
    dispatch_s = sum(ops.values()) / (DISPATCH_LANES_PER_CLOCK * sm_hz)
    return dict(bound_ms=terms[term],
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, **{f"{k}_ms": v for k, v in terms.items()},
                dispatch_ms=dispatch_s * 1e3)


def k1_inputs(n: int, d: int, gen):
    """x [n, d], g [d] (unit normal) and the clip scales and ratios of
    phase 3, on the card."""
    import torch
    dev = torch.device("cuda")
    x = torch.randn(n, d, generator=gen, device=dev)
    g = torch.randn(d, generator=gen, device=dev)
    scales = torch.rand(n, generator=gen, device=dev)
    scales[: n // 2] = 1.0
    w = torch.rand(n, generator=gen, device=dev) + 0.5
    w[-1] = 0.0
    return x, g, scales, (w / w.sum()).contiguous()


def offset_copy(t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` floats past the
    start of its allocation (4 bytes past a 16-byte boundary for 1)."""
    import torch
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def check_kernel(leaf_sizes, seed_words, sm_hz):
    """Phase 3: robust_agg (a one-leaf table) against robust_agg_plain on
    the card, leaf by leaf."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    s0, s1 = seed_words
    sizes = dict(leaf_sizes, odd=1_000_003)
    rows, worst = [], 0.0
    for name, d in sizes.items():
        x, g, scales, ratios = k1_inputs(N_CLIENTS, d, gen)
        for sigma in (0.0, SIGMA):
            args = (x, g, scales, ratios, s0, s1, sigma)
            got = fa.robust_agg(*args)
            want = fa.robust_agg_plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not err <= KERNEL_TOL:
                fail(f"robust_agg {name} (D={d}, sigma={sigma}): max abs "
                     f"err {err} > {KERNEL_TOL}")
            bits_equal = True
            if sigma:
                for client in (0, N_CLIENTS - 1):
                    ku = fa.noise_uniforms(d, s0, s1, client, dev)
                    pu = fa.noise_uniforms_plain(d, s0, s1, client, dev)
                    bits_equal &= all(
                        torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(ku, pu))
                if not bits_equal:
                    fail(f"robust_agg {name}: noise uniforms differ from "
                         f"the plain version")
            kernel = lambda: fa.robust_agg(*args)
            plain = lambda: fa.robust_agg_plain(*args)
            call_ms = time_ms(kernel, reps=50)
            ms = device_ms(kernel, 20, "robust_agg_kernel",
                           LEAF_WINDOWS) or call_ms
            plain_ms = (device_ms(plain, 3, windows=LEAF_WINDOWS)
                        or time_ms(plain, 3, trials=3))
            library_ms = None
            if not sigma:
                beta = float((ratios * (1 - scales)).sum())
                coef = ratios * scales
                library = lambda: torch.addmv(g, x.T, coef, beta=beta)
                library_ms = (device_ms(library, 20, windows=LEAF_WINDOWS)
                              or time_ms(library, 50))
            bound = op_bound(*robust_agg_work(N_CLIENTS, [d], sigma), sm_hz)
            row = dict(leaf=name, d=d, sigma=sigma, max_abs_err=err,
                       uniforms_bit_equal=bits_equal, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_us=bound["bound_ms"] * 1e3,
                       bound_by=bound["bound_by"],
                       bound_term=bound["bound_term"])
            phase("kernel robust_agg", **row)
            rows.append(row)
        del x, g
    return rows, worst


def k1_tree(leaf_sizes, gen):
    """Phase 3's tree: the CNN's leaves, the odd size and an unaligned
    leaf (x and g 4 bytes past a 16-byte boundary), stacked for
    N_CLIENTS, with the global and the weights.  The first K1_UNCLIPPED
    clients' updates have a norm near 1, under CLIP_BOUND (scale 1); the
    others' near 96 (scale near 0.05)."""
    import torch
    stacked, glob = {}, {}
    sizes = dict(leaf_sizes, odd=1_000_003, unaligned=1_000_002)
    spread = torch.full((N_CLIENTS, 1), 0.05, device="cuda")
    spread[:K1_UNCLIPPED] = 0.0005
    for name, d in sizes.items():
        x, g, _, _ = k1_inputs(N_CLIENTS, d, gen)
        off = 1 if name == "unaligned" else 0
        stacked[name] = offset_copy(x * spread + g, off)
        glob[name] = offset_copy(g, off)
    w = k1_inputs(N_CLIENTS, 1, gen)[3] * 300
    return stacked, glob, w


def check_k1_table(leaf_sizes, seed_words, sm_hz):
    """Phase 3, the path's form: the fused aggregate over the CNN's
    leaves, the odd size and the unaligned leaf, one norm launch and one
    aggregate launch, at clip 5.0 and none, sigma 0 and 0.025, within
    KERNEL_TOL of the plain versions leaf by leaf; two launches bit-equal;
    the norm pass's scales within K1_SCALE_TOL of the plain ones (exactly
    1 under the bound), with every leaf's last element read and a NaN
    kept; CPU weights with the card's leaves refused; the Gaussians of
    every (leaf, client) of the CNN within K1_GAUSS_TOL of the precise
    ones; times of the aggregate launch and of the norm pass over the
    CNN's leaves, beside the eager clip pass and the plain aggregate."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa
    from fedml_tpu_torch.core.pytree import tree_keys

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    stacked, glob, w = k1_tree(leaf_sizes, gen)
    keys = tree_keys(stacked)
    ratios = (w / w.sum()).contiguous()
    out = {}
    for bound in (CLIP_BOUND, None):
        want_scales = (fa.clip_scales_plain(stacked, glob, bound,
                                            lambda k: True)
                       if bound is not None else None)
        for sigma in (0.0, SIGMA):
            agg = fa.make_fused_robust_aggregate(norm_bound=bound,
                                                 noise_std=sigma,
                                                 is_weight=lambda k: True)
            fa.reset_launch_counts()
            got = agg(stacked, w, glob, seed_words)
            again = agg(stacked, w, glob, seed_words)
            torch.cuda.synchronize()
            launches = dict(fa.launch_counts)
            if launches["robust_agg"] != 2 or launches["clip_norm"] != (
                    2 if bound is not None else 0):
                fail(f"the fused aggregate launched {launches} in two calls")
            same = all(torch.equal(got[k].view(torch.int32),
                                   again[k].view(torch.int32)) for k in keys)
            if not same:
                fail(f"two fused aggregates (clip {bound}, sigma {sigma}) "
                     f"differ")
            ones = torch.ones(N_CLIENTS, device=dev)
            err = 0.0
            for li, k in enumerate(keys):
                want = fa.robust_agg_plain(
                    stacked[k], glob[k],
                    want_scales if bound is not None else ones, ratios,
                    fa.leaf_seed(seed_words[0], li),
                    fa.leaf_seed(seed_words[1], li), sigma)
                err = max(err, float((got[k] - want).abs().max()))
            if not err <= KERNEL_TOL:
                fail(f"fused aggregate (clip {bound}, sigma {sigma}): max "
                     f"abs err {err} > {KERNEL_TOL}")
            out[(bound, sigma)] = err
    # no fallback: CPU weights with the card's leaves are refused
    for bound in (CLIP_BOUND, None):
        agg = fa.make_fused_robust_aggregate(norm_bound=bound,
                                             is_weight=lambda k: True)
        try:
            agg(stacked, w.cpu(), glob, seed_words)
        except ValueError:
            pass
        else:
            fail(f"the fused aggregate (clip {bound}) took CPU weights "
                 f"with the card's leaves")

    layout = fa.LeafLayout(keys, [glob[k].numel() for k in keys],
                           range(len(keys)), [True] * len(keys))
    xs = [stacked[k] for k in keys]
    gs = [glob[k] for k in keys]
    scale_check = check_clip_norm(layout, stacked, glob, ratios)
    scales = fa.clip_norm(layout, xs, gs, CLIP_BOUND)

    # the Gaussians of every CNN leaf and client: SFU against precise
    gauss_err = 0.0
    samples = 0
    for li, (name, d) in enumerate(leaf_sizes.items()):
        s0 = fa.leaf_seed(seed_words[0], li)
        s1 = fa.leaf_seed(seed_words[1], li)
        for client in range(N_CLIENTS):
            u1, u2, gk = fa.noise_probe(d, s0, s1, client, dev)
            pu1, pu2 = fa.noise_uniforms_plain(d, s0, s1, client, dev)
            if not (torch.equal(u1.view(torch.int32), pu1.view(torch.int32))
                    and torch.equal(u2.view(torch.int32),
                                    pu2.view(torch.int32))):
                fail(f"noise uniforms of {name}, client {client} differ "
                     f"from the plain version")
            gauss_err = max(gauss_err, float(
                (gk - fa._gaussian(pu1, pu2)).abs().max()))
            samples += d
    if not gauss_err <= K1_GAUSS_TOL:
        fail(f"K1's Gaussians differ from the precise ones by {gauss_err} "
             f"> {K1_GAUSS_TOL}")

    # times over the CNN's leaves (the path's table)
    cnn = [k for k in keys if k in leaf_sizes]
    layout = fa.LeafLayout(cnn, [leaf_sizes[k] for k in cnn],
                           range(len(cnn)), [True] * len(cnn))
    xs = [stacked[k] for k in cnn]
    gs = [glob[k] for k in cnn]
    sub = {k: stacked[k] for k in cnn}
    subg = {k: glob[k] for k in cnn}
    times = {}
    for sigma in (0.0, SIGMA):
        call = lambda: fa.robust_agg_table(layout, xs, gs, scales, ratios,
                                           *seed_words, sigma)
        plain = lambda: [fa.robust_agg_plain(
            x, g, scales, ratios, fa.leaf_seed(seed_words[0], li),
            fa.leaf_seed(seed_words[1], li), sigma)
            for li, (x, g) in enumerate(zip(xs, gs))]
        bound = op_bound(*robust_agg_work(N_CLIENTS, layout.sizes, sigma),
                         sm_hz)
        times[sigma] = dict(
            ms=(device_ms(call, 20, "robust_agg_kernel", windows=5)
                or time_ms(call, 50)),
            call_ms=time_ms(call, 50), host_us=host_us(call),
            plain_ms=device_ms(plain, 3) or time_ms(plain, 3, trials=3),
            **bound)
    norm = lambda: fa.clip_norm(layout, xs, gs, CLIP_BOUND)
    eager = lambda: fa.clip_scales_plain(sub, subg, CLIP_BOUND,
                                         lambda k: True)
    norm_row = dict(ms=(device_ms(norm, 20, "clip_norm_kernel", windows=5)
                        or time_ms(norm, 50)),
                    call_ms=time_ms(norm, 50), host_us=host_us(norm),
                    plain_ms=device_ms(eager, 20) or time_ms(eager, 20),
                    plain_host_us=host_us(eager),
                    **op_bound(*clip_norm_work(N_CLIENTS, layout.sizes),
                               sm_hz))
    result = dict(max_abs_err={f"clip={b},sigma={s}": e
                               for (b, s), e in out.items()},
                  bit_equal_twice=True, **scale_check,
                  gauss_max_abs_err=gauss_err, gauss_tol=K1_GAUSS_TOL,
                  gauss_samples=samples, table=times, clip_norm=norm_row)
    phase("kernel robust_agg table", **result)
    return result


def check_clip_norm(layout, stacked, glob, ratios):
    """Phase 3's norm pass: the scales against clip_scales_plain, within
    K1_SCALE_TOL (relative), the clients under the bound at exactly 1; then
    with client j % N's update spiked at leaf j's last element (so each
    client's scale hangs on one leaf's tail being read); then with a NaN in
    one client's update: its scale NaN, as in the plain version, and the
    aggregate over it NaN at every element, the others' scales as before."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa

    keys = layout.keys
    xs = [stacked[k] for k in keys]
    gs = [glob[k] for k in keys]

    def compare(what):
        got = fa.clip_norm(layout, xs, gs, CLIP_BOUND)
        want = fa.clip_scales_plain(stacked, glob, CLIP_BOUND,
                                    lambda k: True)
        torch.cuda.synchronize()
        if not torch.equal(got.isnan(), want.isnan()):
            fail(f"clip_norm ({what}): NaN scales {got.tolist()} against "
                 f"the plain version's {want.tolist()}")
        ok = ~want.isnan()
        diff = (got[ok] - want[ok]).abs()
        rel = float((diff / want[ok]).max())
        if not rel <= K1_SCALE_TOL:
            fail(f"clip_norm ({what}): scales {got.tolist()} differ from "
                 f"the plain version's {want.tolist()} by {rel} relative > "
                 f"{K1_SCALE_TOL}")
        return got, want, float(diff.max()), rel

    got, want, abs_err, rel_err = compare("as drawn")
    under = slice(None, K1_UNCLIPPED)
    if not ((got[under] == 1).all() and (want[under] == 1).all()
            and (want[K1_UNCLIPPED:] < 1).all()):
        fail(f"clip_norm: scales {got.tolist()} (plain {want.tolist()}), "
             f"need exactly 1 for the first {K1_UNCLIPPED} clients only")

    # every leaf's last element (its D % 4 tail, where it has one)
    saved = []
    for j, x in enumerate(xs):
        c = j % N_CLIENTS
        saved.append((x, c, x[c, -1].clone()))
        x[c, -1] = gs[j][-1] + 1000.0
    spiked, _, spike_abs, spike_rel = compare("spiked tails")
    for x, c, v in saved:
        x[c, -1] = v
    if not (spiked < 0.01).all():
        fail(f"clip_norm: spiked scales {spiked.tolist()}, a leaf's last "
             f"element was not read")

    # a NaN in client 3's update
    big = max(range(len(xs)), key=lambda j: xs[j].shape[1])
    at = xs[big].shape[1] // 2
    kept = xs[big][3, at].clone()
    xs[big][3, at] = float("nan")
    nan_scales, _, _, _ = compare("a NaN in client 3")
    flat = fa.robust_agg_table(layout, xs, gs, nan_scales, ratios, 1, 2, 0.0)
    torch.cuda.synchronize()
    xs[big][3, at] = kept
    if not (nan_scales[3].isnan() and all(
            v.isnan().all() for v in layout.views(
                flat, [(d,) for d in layout.sizes]))):
        fail("clip_norm / robust_agg: a NaN in client 3's update did not "
             "reach its scale and every element of the aggregate")
    return dict(scales_max_abs_diff=abs_err, scales_max_rel_diff=rel_err,
                scale_tol=K1_SCALE_TOL, unclipped_scales_exactly_1=True,
                spiked_scales_max_rel_diff=spike_rel,
                spiked_scales_max_abs_diff=spike_abs, nan_scale_kept=True)


def run_slice(data_cfg):
    """Phase 4: the full-width main path through the CLI's runner."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa
    from fedml_tpu_torch.experiments.main import (load_experiment_data,
                                                  run_fedavg_robust)
    from fedml_tpu_torch.utils.metrics import MetricsSink

    t0 = time.perf_counter()
    data = load_experiment_data(data_cfg)
    data_s = time.perf_counter() - t0
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    with MetricsSink(None) as sink:
        summary = run_fedavg_robust(data_cfg, data, sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fa.launch_counts["robust_agg"]
    norm_launches = fa.launch_counts["clip_norm"]
    need = data_cfg.comm_round
    if launches != need or norm_launches != need:
        fail(f"slice launched robust_agg {launches} and clip_norm "
             f"{norm_launches} times, need exactly {need} each (one of each "
             f"a round)")
    if not summary.get("params_finite"):
        fail("slice produced non-finite parameters")
    phase("slice", launches=launches, clip_norm_launches=norm_launches,
          data_s=data_s, run_s=run_s,
          rounds_per_s=summary["rounds_per_s"],
          test_acc=summary["test_acc"], test_loss=summary["test_loss"],
          train_acc=summary["train_acc"], params_finite=True,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return data, (launches, norm_launches), summary


def profile_rounds(data_cfg, data, rounds: int = 3):
    """Where a round's time goes, on the slice's configuration: host
    timers (synchronised) around the cohort gather, the local training and
    the fused aggregate, for each client axis; then torch.profiler over
    ``rounds`` whole rounds for the device's busy share and its top
    kernels.  Launches here come after the main path's counts were read."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobust,
                                                          FedAvgRobustConfig)
    from fedml_tpu_torch.core.fused_agg import make_fused_robust_aggregate
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.experiments.main import (_fedavg_cfg_kwargs,
                                                  _make_workload)
    from fedml_tpu_torch.parallel.cohort import train_cohort

    aggregate = make_fused_robust_aggregate(norm_bound=data_cfg.norm_bound,
                                            noise_std=data_cfg.stddev)
    m = data_cfg.client_num_per_round
    result = {}
    for axis in ("vmap", "scan"):
        cfg = dataclasses.replace(data_cfg, client_axis=axis)
        algo = FedAvgRobust(_make_workload(cfg, data), data,
                            FedAvgRobustConfig(
                                defense=cfg.defense,
                                norm_bound=cfg.norm_bound, stddev=cfg.stddev,
                                defense_backend=cfg.defense_backend,
                                **_fedavg_cfg_kwargs(cfg)), device="cuda")
        params = algo.init_params()
        parts = {"gather_ms": [], "train_ms": [], "aggregate_ms": []}
        for r in range(rounds + 1):               # round 0 is warm-up
            words = round_seed_words(cfg.seed, r)
            t0 = time.perf_counter()
            cohort = gather_cohort(data.train,
                                   sample_clients(r, data.client_num, m),
                                   pad_to=m, device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            stacked, _ = train_cohort(algo._local_train, params, cohort,
                                      words, client_axis=axis)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            params = aggregate(stacked, cohort["num_samples"], params, words)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if r:
                parts["gather_ms"].append((t1 - t0) * 1e3)
                parts["train_ms"].append((t2 - t1) * 1e3)
                parts["aggregate_ms"].append((t3 - t2) * 1e3)
        row = {k: statistics.median(v) for k, v in parts.items()}
        row["round_ms"] = sum(row.values())
        # the aggregate part alone: its host time, launches and kernels
        row["aggregate_call"] = call_profile(
            lambda: aggregate(stacked, cohort["num_samples"], params, words))
        row["stacked_contiguous"] = all(v.is_contiguous()
                                        for v in stacked.values())

        def run_rounds():
            p = params
            for r in range(rounds):
                cohort = gather_cohort(
                    data.train, sample_clients(r, data.client_num, m),
                    pad_to=m, device="cuda")
                p, _ = algo.cohort_step(p, cohort,
                                        round_seed_words(cfg.seed, r))
            torch.cuda.synchronize()

        run_rounds()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_rounds()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
        busy_us = sum(_self_device_us(e) for e in events)
        row["profiled_round_ms"] = wall_us / rounds / 1e3
        row["device_busy_ms_per_round"] = busy_us / rounds / 1e3
        row["device_idle_share"] = (1 - busy_us / wall_us) if busy_us else None
        row["kernel_launches_per_round"] = sum(
            e.count for e in events) / rounds
        for name in ("robust_agg_kernel", "clip_norm_kernel"):
            k1 = [e for e in events if name in e.key]
            row[f"{name}_launches_per_round"] = sum(
                e.count for e in k1) / rounds
            row[f"{name}_device_ms_per_round"] = sum(
                _self_device_us(e) for e in k1) / rounds / 1e3
        top = sorted(events, key=_self_device_us, reverse=True)[:6]
        row["top_device_us_per_round"] = {
            e.key[:60]: _self_device_us(e) / rounds for e in top}
        phase(f"profile client_axis={axis}", **row)
        result[axis] = row
    return result


@contextlib.contextmanager
def tf32_off():
    """Full-f32 convolutions and matmuls inside the block, the previous
    settings after it."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def round_parity(data_cfg, data):
    """One round on the GPU with TF32 off against the same round on the
    CPU: same init, same cohort, same seed words."""
    import dataclasses
    import torch
    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobust,
                                                          FedAvgRobustConfig)
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.experiments.main import (_fedavg_cfg_kwargs,
                                                  _make_workload)

    cfg = dataclasses.replace(data_cfg, comm_round=1)
    ids = sample_clients(0, data.client_num, cfg.client_num_per_round)
    words = round_seed_words(cfg.seed, 0)
    out = {}
    with tf32_off():
        for dev in ("cuda", "cpu"):
            algo = FedAvgRobust(_make_workload(cfg, data), data,
                                FedAvgRobustConfig(
                                    defense=cfg.defense,
                                    norm_bound=cfg.norm_bound,
                                    stddev=cfg.stddev,
                                    defense_backend=cfg.defense_backend,
                                    **_fedavg_cfg_kwargs(cfg)), device=dev)
            cohort = gather_cohort(data.train, ids,
                                   pad_to=cfg.client_num_per_round,
                                   device=dev)
            params, _ = algo.cohort_step(algo.init_params(), cohort, words)
            out[dev] = {k: v.cpu() for k, v in params.items()}
    diff = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
               for k in out["cpu"])
    phase("slice round vs cpu", max_abs_diff=diff, tol=ROUND_TOL, tf32=False)
    if not diff <= ROUND_TOL:
        fail(f"GPU round differs from the CPU round by {diff} > {ROUND_TOL}")
    return diff


def host_us(fn, reps: int = 50) -> float:
    """Host time of one call of ``fn`` (µs): the enqueue cost, with the
    device drained before and after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def check_secagg_kernel(leaf_sizes, sm_hz):
    """Phase 5: secagg_mask (a one-leaf table, the pair seeds given)
    against quantize_mask_plain on the card, leaf by leaf."""
    import torch
    from fedml_tpu_torch.core import prng
    from fedml_tpu_torch.secure import fused_mask as fm
    from fedml_tpu_torch.secure.secagg import (quantize, ring_budget_scale,
                                               ring_sum)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    clip = 2.0**14
    sizes = dict(leaf_sizes, odd=1_000_003)
    rows_out, worst = [], 0
    for n in GROUP_SIZES:
        scale = ring_budget_scale(n, clip)
        base = fm.pair_seeds(prng.fold_in(prng.key(0), n), 0, n, n)
        for li, (name, d) in enumerate(sizes.items()):
            x = torch.randn(n, d, generator=gen, device=dev) * 3
            w = torch.rand(n, generator=gen, device=dev) + 0.5
            w[-1] = 0.0
            w = (w / w.sum()).contiguous()
            seeds = torch.as_tensor(fm.leaf_seeds(base, li)).to(dev)
            args = (x, w, seeds, 0, scale, clip)
            got = fm.quantize_mask(*args)
            want = fm.quantize_mask_plain(*args)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want):
                fail(f"secagg_mask {name} (D={d}, N={n}): ring values differ "
                     f"from the plain version (max abs {err})")
            q = quantize({"x": x * w[:, None]}, scale, clip)["x"]
            cancel = torch.equal(ring_sum({"x": got})["x"],
                                 ring_sum({"x": q})["x"])
            if not cancel:
                fail(f"secagg_mask {name} (D={d}, N={n}): the masks do not "
                     f"cancel in the ring sum")
            kernel = lambda: fm.quantize_mask(*args)
            plain = lambda: fm.quantize_mask_plain(*args)
            call_ms = time_ms(kernel, reps=50)
            if n == GROUP_SIZES[0]:           # the main path's group size
                ms = device_ms(kernel, 20, "secagg_", LEAF_WINDOWS) or call_ms
                plain_ms = (device_ms(plain, 3, windows=LEAF_WINDOWS)
                            or time_ms(plain, 3, trials=3))
            else:                             # CUDA events only
                ms, plain_ms = call_ms, time_ms(plain, 3, trials=3)
            bound = op_bound(*secagg_mask_work(n, n, d), sm_hz)
            row = dict(leaf=name, d=d, n=n, bit_equal=True,
                       masks_cancel=cancel, max_abs_err=err, ms=ms,
                       call_ms=call_ms, host_us=host_us(kernel),
                       plain_ms=plain_ms, bound_us=bound["bound_ms"] * 1e3,
                       bytes_us=bound["bytes_ms"] * 1e3,
                       int_us=bound["int_ms"] * 1e3,
                       bound_by=bound["bound_by"],
                       bound_term=bound["bound_term"])
            phase("kernel secagg_mask", **row)
            rows_out.append(row)
            del x, got, want, q
    return rows_out, worst


def check_k3_table(leaf_sizes, sm_hz):
    """Phase 5, the path's form: one launch over the CNN's leaves, the odd
    size and an unaligned leaf for a whole group of 5 and of 10 (each pair
    once, the pair keys derived in the launch), bit-equal to the plain
    version leaf by leaf, the masks cancelling in one ring sum over the
    buffer, bit-equal to the per-leaf ring sums; the per-row walk (one
    client's row, two rows of a group) bit-equal; the launch's salts
    bit-equal to pair_seeds + leaf_seeds; CPU weights with the card's
    leaves refused; the launch's time over the CNN's leaves at the slice's
    group of 5."""
    import torch
    from fedml_tpu_torch.core import prng
    from fedml_tpu_torch.secure import fused_mask as fm
    from fedml_tpu_torch.secure.secagg import (quantize, ring_budget_scale,
                                               ring_sum)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    clip = 2.0**14
    sizes = dict(leaf_sizes, odd=1_000_003, unaligned=1_000_002)
    keys = list(sizes)
    layout = fm.mask_layout(keys, list(sizes.values()))
    result = {}
    for n in GROUP_SIZES:
        scale = ring_budget_scale(n, clip)
        key = prng.fold_in(prng.key(7), n)
        xs = [offset_copy(torch.randn(n, d, generator=gen, device=dev) * 3,
                          1 if k == "unaligned" else 0)
              for k, d in sizes.items()]
        w = torch.rand(n, generator=gen, device=dev) + 0.5
        w[-1] = 0.0
        w = (w / w.sum()).contiguous()
        fm.reset_launch_counts()
        buf = fm.quantize_mask_table(layout, xs, w, key, 0, n, scale, clip)
        torch.cuda.synchronize()
        if fm.launch_counts["secagg_mask"] != 1:
            fail(f"the K3 table launched {fm.launch_counts} for one group")
        try:        # no fallback: CPU weights with the card's leaves
            fm.quantize_mask_table(layout, xs, w.cpu(), key, 0, n, scale,
                                   clip)
        except ValueError:
            pass
        else:
            fail("the K3 table took CPU weights with the card's leaves")
        base = fm.pair_seeds(key, 0, n, n)
        flat_sum = ring_sum({"": buf})[""]
        for li, (name, d) in enumerate(sizes.items()):
            seeds = torch.as_tensor(fm.leaf_seeds(base, li)).to(dev)
            c = layout.offsets[li]
            got = buf[:, c:c + d]
            want = fm.quantize_mask_plain(xs[li], w, seeds, 0, scale, clip)
            if not torch.equal(got, want):
                fail(f"K3 table {name} (D={d}, N={n}): ring values differ "
                     f"from the plain version")
            q = quantize({"x": xs[li] * w[:, None]}, scale, clip)["x"]
            per_leaf = ring_sum({"x": got})["x"]
            if not (torch.equal(per_leaf, ring_sum({"x": q})["x"])
                    and torch.equal(flat_sum[c:c + d], per_leaf)):
                fail(f"K3 table {name} (N={n}): the masks do not cancel, or "
                     f"the buffer's ring sum differs from the leaf's")
            salts = fm.pair_salts(key, n, li, dev)
            if not torch.equal(salts, fm.pair_salts_plain(key, n, li, dev)):
                fail(f"K3's in-launch salts (leaf {li}, N={n}) differ from "
                     f"pair_seeds + leaf_seeds")
        # the per-row walk: one client's row, and two rows of the group
        for first, rows in ((2, 1), (1, 2)):
            sub = [x[first:first + rows].contiguous() for x in xs]
            part = fm.quantize_mask_table(layout, sub,
                                          w[first:first + rows].contiguous(),
                                          key, first, n, scale, clip)
            if not all(torch.equal(p, b) for p, b in zip(
                    layout.views(part, [(d,) for d in layout.sizes]),
                    layout.views(buf[first:first + rows],
                                 [(d,) for d in layout.sizes]))):
                fail(f"K3's per-row walk (rows {first}..{first + rows - 1} "
                     f"of {n}) differs from the group's launch")
        result[f"n={n}"] = dict(bit_equal=True, masks_cancel=True,
                                salts_bit_equal=True, rows_walk_equal=True)
        del xs, buf

    # the path's launch: the CNN's leaves, a group of 5
    n = GROUP_SIZES[0]
    scale = ring_budget_scale(n, clip)
    key = prng.fold_in(prng.key(8), n)
    cnn = fm.mask_layout(list(leaf_sizes), list(leaf_sizes.values()))
    xs = [torch.randn(n, d, generator=gen, device=dev) * 3
          for d in leaf_sizes.values()]
    w = torch.full((n,), 1.0 / n, device=dev)
    call = lambda: fm.quantize_mask_table(cnn, xs, w, key, 0, n, scale, clip)
    base = fm.pair_seeds(key, 0, n, n)
    seeds = [torch.as_tensor(fm.leaf_seeds(base, li)).to(dev)
             for li in range(len(leaf_sizes))]
    plain = lambda: [fm.quantize_mask_plain(x, w, s, 0, scale, clip)
                     for x, s in zip(xs, seeds)]
    ring = lambda: ring_sum({"": call()})
    bound = op_bound(*secagg_mask_work(n, n, sum(leaf_sizes.values())),
                     sm_hz)
    result["path"] = dict(
        # 3 profiler windows (cut from 5 for the time limit)
        n=n, ms=(device_ms(call, 20, "secagg_", windows=3)
                or time_ms(call, 50)),
        call_ms=time_ms(call, 50), host_us=host_us(call),
        plain_ms=device_ms(plain, 3) or time_ms(plain, 3, trials=3),
        mask_and_ring_sum_ms=time_ms(ring, 20), **bound)
    phase("kernel secagg_mask table", **result)
    return result


def _turbo(cfg, data, device):
    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregate
    from fedml_tpu_torch.experiments.main import (_make_workload,
                                                  turboaggregate_config)
    return TurboAggregate(_make_workload(cfg, data), data,
                          turboaggregate_config(cfg), device=device)


def run_turbo_slice(turbo_cfg, data):
    """Phase 6: secure FedAvg at full width through the CLI's runner."""
    import torch
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.experiments.main import run_turboaggregate
    from fedml_tpu_torch.secure import fused_mask
    from fedml_tpu_torch.utils.metrics import MetricsSink

    fused_agg.reset_launch_counts()
    fused_mask.reset_launch_counts()
    t0 = time.perf_counter()
    with MetricsSink(None) as sink:
        summary = run_turboaggregate(turbo_cfg, data, sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fused_mask.launch_counts["secagg_mask"]
    need = turbo_cfg.group_num * turbo_cfg.comm_round
    if launches != need:
        fail(f"turboaggregate launched secagg_mask {launches} times, need "
             f"exactly {need} (one launch x {turbo_cfg.group_num} groups x "
             f"{turbo_cfg.comm_round} rounds)")
    if fused_agg.launch_counts["robust_agg"]:
        fail("turboaggregate launched robust_agg")
    if not summary.get("params_finite"):
        fail("turboaggregate produced non-finite parameters")
    phase("turboaggregate slice", launches=launches, run_s=run_s,
          rounds_per_s=summary["rounds_per_s"],
          test_acc=summary["test_acc"], test_loss=summary["test_loss"],
          train_acc=summary["train_acc"], params_finite=True)
    return launches, summary


def profile_turbo(turbo_cfg, data, rounds: int = 3):
    """Where a secure round's time goes: host timers (synchronised) around
    the gather, local SGD, the mask launch (``aggregate_stacked``'s cuda
    path: the layout, the launch), the ring sum + dequantize over its
    buffer and the group combine, summed over the groups of a round; then
    torch.profiler over ``rounds`` whole rounds for the device's idle
    share.  Launches here come after the main path's counts were read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.core.pytree import tree_weighted_mean
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.parallel.cohort import train_cohort
    from fedml_tpu_torch.secure.secagg import ring_sum

    algo = _turbo(turbo_cfg, data, "cuda")
    agg = algo.secagg
    params = algo.init_params()
    names = ("gather_ms", "train_ms", "mask_ms", "ring_sum_dequant_ms",
             "combine_ms")
    parts = {k: [] for k in names}
    by_group = [[] for _ in range(turbo_cfg.group_num)]

    def tick(t):
        torch.cuda.synchronize()
        now = time.perf_counter()
        return now, (now - t) * 1e3

    for r in range(rounds + 1):                   # round 0 is warm-up
        acc = dict.fromkeys(names, 0.0)
        means, weights = [], []
        keys = algo.group_keys(r)
        for g, gids in enumerate(algo.group_ids(r)):
            t = time.perf_counter()
            cohort = gather_cohort(data.train, gids,
                                   pad_to=agg.num_clients, device="cuda")
            t, dt = tick(t)
            acc["gather_ms"] += dt
            trained, _ = train_cohort(algo._local_train, params, cohort)
            t, dt = tick(t)
            acc["train_ms"] += dt
            if r:
                by_group[g].append(dt)
            num = cohort["num_samples"].to(torch.float32)
            w = num / torch.clamp(num.sum(), min=1e-12)
            buf, layout = agg.mask_flat(trained, w, 0, keys[g])
            t, dt = tick(t)
            acc["mask_ms"] += dt
            flat = agg.unmask_sum(ring_sum({"": buf}), 1.0)[""]
            means.append(dict(zip(layout.keys, layout.views(
                flat, [trained[k].shape[1:] for k in layout.keys]))))
            weights.append(float(num.sum()))
            t, dt = tick(t)
            acc["ring_sum_dequant_ms"] += dt
        t = time.perf_counter()
        params = tree_weighted_mean(means, torch.tensor(weights))
        _, acc["combine_ms"] = tick(t)
        if r:
            for k in names:
                parts[k].append(acc[k])
    row = {k: statistics.median(v) for k, v in parts.items()}
    row["round_ms"] = sum(row.values())
    # one group's mask launch and ring sum alone: host time, launches
    row["mask_call"] = call_profile(
        lambda: agg.mask_flat(trained, w, 0, keys[-1]))
    row["ring_sum_dequant_call"] = call_profile(
        lambda: agg.unmask_sum(ring_sum({"": buf}), 1.0))
    row["trained_contiguous"] = all(v.is_contiguous()
                                    for v in trained.values())
    row["train_ms_by_group"] = [statistics.median(v) for v in by_group]
    alone = []                  # one group's local SGD, back to back
    for _ in range(5):
        t = time.perf_counter()
        train_cohort(algo._local_train, params, cohort)
        alone.append(tick(t)[1])
    row["train_ms_one_group_alone"] = statistics.median(alone)

    def run_rounds():
        p = params
        for r in range(rounds):
            p = algo.train_round(p, r)
        torch.cuda.synchronize()

    run_rounds()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_rounds()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in events)
    row["profiled_round_ms"] = wall_us / rounds / 1e3
    row["device_busy_ms_per_round"] = busy_us / rounds / 1e3
    row["device_idle_share"] = (1 - busy_us / wall_us) if busy_us else None
    row["kernel_launches_per_round"] = sum(e.count for e in events) / rounds
    row["mask_kernel_device_ms_per_round"] = sum(
        _self_device_us(e) for e in events
        if "secagg_" in e.key) / rounds / 1e3
    top = sorted(events, key=_self_device_us, reverse=True)[:6]
    row["top_device_us_per_round"] = {
        e.key[:60]: _self_device_us(e) / rounds for e in top}
    phase("profile turboaggregate", **row)
    return row


def turbo_round_parity(turbo_cfg, data):
    """One secure round with TF32 off on the GPU against the same round on
    the CPU, from the same carried init: each client's quantized value may
    flip by one quantum."""
    algo = {dev: _turbo(turbo_cfg, data, dev) for dev in ("cuda", "cpu")}
    init = algo["cpu"].init_params()
    out = {}
    with tf32_off():
        for dev, a in algo.items():
            params = a.train_round({k: v.to(dev) for k, v in init.items()},
                                   0)
            out[dev] = {k: v.cpu() for k, v in params.items()}
    tol = algo["cpu"].cfg.clients_per_group / algo["cpu"].quant_scale + 1e-4
    diff = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
               for k in out["cpu"])
    phase("turboaggregate round vs cpu", max_abs_diff=diff, tol=tol,
          tf32=False)
    if not diff <= tol:
        fail(f"GPU secure round differs from the CPU round by {diff} > {tol}")
    return diff


def turbo_dropout(turbo_cfg, data):
    """One round with group 1's partial recovered from its LCC shares,
    against the direct round, on the GPU."""
    a = _turbo(turbo_cfg, data, "cuda")
    init = a.init_params()
    direct = a.train_round(init, 0)
    recovered = a.train_round(init, 0, dropped_groups=[1])
    diff = max(float((direct[k] - recovered[k]).abs().max()) for k in direct)
    phase("turboaggregate dropout", max_abs_diff=diff, tol=DROPOUT_TOL,
          dropped_groups=[1])
    if not diff < DROPOUT_TOL:
        fail(f"LCC-recovered round differs from the direct one by {diff}")
    return diff


def shard_finalize_cases(shard_sizes):
    """K2's phase: (name, D, offset in floats) for the path's shards, the
    whole model (S=1), sizes 3, 1 and 0 mod 4, one of 3 elements (no whole
    float4) and a view one float past a 16-byte boundary (the kernel's
    unaligned path)."""
    return ([(name, d, 0) for name, d in shard_sizes.items()]
            + [("full", sum(shard_sizes.values()), 0),
               ("odd", 1_000_003, 0), ("one", 1_000_001, 0),
               ("four", 1_000_004, 0), ("three", 3, 0),
               ("unaligned", 1_000_003, 1)])


def k2_divisions(acc, wsum: float):
    """K2's yardsticks at sigma = 0: ``torch.div`` by a device scalar, the
    IEEE quotient (the same function, bit for bit); and ``torch.div`` by a
    Python float, which PyTorch computes as a multiply by the reciprocal
    (not the same function: about half the quotients differ in the last
    bit)."""
    import torch
    wsum_t = torch.tensor(wsum, dtype=torch.float32, device=acc.device)
    return lambda: torch.div(acc, wsum_t), lambda: torch.div(acc, wsum)


def check_shard_finalize(shard_sizes):
    """Phase 7: shard_finalize against shard_finalize_plain on the card."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rows, worst = [], 0.0
    for salt, (name, d, off) in enumerate(shard_finalize_cases(shard_sizes),
                                          start=1):
        acc = (torch.randn(d + off, generator=gen, device=dev) * 40)[off:]
        aligned = acc.data_ptr() % 16 == 0
        if aligned != (off == 0):
            fail(f"shard_finalize {name}: the input starts "
                 f"{acc.data_ptr() % 16} bytes past a 16-byte boundary")
        wsum = 123.0
        seed_word = fa.shard_seed_word(0, salt)
        for sigma in (0.0, SIGMA):
            args = (acc, wsum, seed_word, K2_STEP, sigma)
            got = fa.shard_finalize(*args)
            want = fa.shard_finalize_plain(*args)
            torch.cuda.synchronize()
            bit_equal = torch.equal(got.view(torch.int32),
                                    want.view(torch.int32))
            err = float((got - want).abs().max())
            ulps = int((got.view(torch.int32).to(torch.int64)
                        - want.view(torch.int32).to(torch.int64))
                       .abs().max())
            worst = max(worst, err)
            if not sigma and not bit_equal:
                fail(f"shard_finalize {name} (D={d}): sigma=0 is not "
                     f"bit-equal to the plain division (max abs {err})")
            if sigma and not err <= K2_NOISE_TOL:
                fail(f"shard_finalize {name} (D={d}, sigma={sigma}): max "
                     f"abs err {err} ({ulps} ulps) > {K2_NOISE_TOL}")
            uniforms_equal = None
            if sigma:
                ku = fa.shard_uniforms(d, seed_word, K2_STEP, dev)
                pu = fa.shard_uniforms_plain(d, seed_word, K2_STEP, dev)
                uniforms_equal = all(
                    torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(ku, pu))
                if not uniforms_equal:
                    fail(f"shard_finalize {name}: noise uniforms differ "
                         f"from the plain version")
            kernel = lambda: fa.shard_finalize(*args)
            plain = lambda: fa.shard_finalize_plain(*args)
            call_ms = time_ms(kernel, reps=50)
            ms = device_ms(kernel, 20, "shard_finalize_kernel") or call_ms
            plain_ms = device_ms(plain, 5) or time_ms(plain, 5, trials=3)
            library_ms = div_by_float_ms = None
            library_bit_equal = div_by_float_differs = None
            if not sigma:
                library, by_float = k2_divisions(acc, wsum)
                library_bit_equal = torch.equal(
                    library().view(torch.int32), want.view(torch.int32))
                div_by_float_differs = int(
                    (by_float().view(torch.int32)
                     != want.view(torch.int32)).sum())
                library_ms = device_ms(library, 20) or time_ms(library, 50)
                div_by_float_ms = (device_ms(by_float, 20)
                                   or time_ms(by_float, 50))
            nbytes, work = shard_finalize_bounds(d, sigma)
            # every operation at the f32 rate: integer and special-function
            # lanes are fewer, so this stays a lower bound
            ops = sum(work.values())
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           ops / FP32_OPS_PER_S) * 1e3
            row = dict(shard=name, d=d, aligned=aligned, sigma=sigma,
                       bit_equal=bit_equal,
                       max_ulps=ulps, max_abs_err=err,
                       uniforms_bit_equal=uniforms_equal, ms=ms,
                       call_ms=call_ms, host_us=host_us(kernel),
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_bit_equal=library_bit_equal,
                       div_by_float_ms=div_by_float_ms,
                       div_by_float_differs=div_by_float_differs,
                       bound_us=bound_ms * 1e3,
                       bytes_us=nbytes / HBM_BYTES_PER_S * 1e6,
                       ops_us=ops / FP32_OPS_PER_S * 1e6,
                       bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                                 >= ops / FP32_OPS_PER_S else "operations"))
            phase("kernel shard_finalize", **row)
            rows.append(row)
            del got, want
        del acc
    # sigma = 0 once more, the path's shards in reverse order and both
    # divisions timed before the kernel: does a gap seen in the first shard
    # timed follow the shard or the order?
    again = {}
    for name, d in reversed(list(shard_sizes.items())):
        acc = torch.randn(d, generator=gen, device=dev) * 40
        args = (acc, 123.0, fa.shard_seed_word(0, 1), K2_STEP, 0.0)
        library, by_float = k2_divisions(acc, 123.0)
        kernel = lambda: fa.shard_finalize(*args)
        library_ms = device_ms(library, 20) or time_ms(library, 50)
        div_by_float_ms = device_ms(by_float, 20) or time_ms(by_float, 50)
        ms = (device_ms(kernel, 20, "shard_finalize_kernel")
              or time_ms(kernel, 50))
        again[name] = dict(d=d, ms=ms, library_ms=library_ms,
                           div_by_float_ms=div_by_float_ms)
        del acc
    phase("kernel shard_finalize retimed", sigma=0.0, order=list(again),
          shards=again, **{k: sum(r[k] for r in again.values())
                           for k in ("ms", "library_ms", "div_by_float_ms")})
    return rows, worst


def run_silo_slice(silo_cfg, data):
    """Phase 8: live cross-silo FedAvg with the sharded spine at full
    width through the CLI's runner."""
    import torch
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.experiments.main import run_cross_silo
    from fedml_tpu_torch.secure import fused_mask
    from fedml_tpu_torch.utils.metrics import MetricsSink

    fused_agg.reset_launch_counts()
    fused_mask.reset_launch_counts()
    t0 = time.perf_counter()
    with MetricsSink(None) as sink:
        summary = run_cross_silo(silo_cfg, data, sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fused_agg.launch_counts["shard_finalize"]
    need = silo_cfg.model_shards * silo_cfg.comm_round
    if launches != need:
        fail(f"cross_silo launched shard_finalize {launches} times, need "
             f"exactly {need} ({silo_cfg.model_shards} shards x "
             f"{silo_cfg.comm_round} rounds)")
    if fused_agg.launch_counts["robust_agg"] \
            or fused_mask.launch_counts["secagg_mask"]:
        fail("cross_silo launched robust_agg or secagg_mask")
    if not summary.get("params_finite"):
        fail("cross_silo produced non-finite parameters")
    phase("cross_silo slice", launches=launches, run_s=run_s,
          rounds_per_s=summary["rounds_per_s"],
          test_acc=summary["test_acc"], test_loss=summary["test_loss"],
          train_acc=summary["train_acc"], params_finite=True)
    return launches, summary


class PartTimer:
    """Exclusive host time (synchronised) of wrapped methods, by part:
    time spent in a wrapped call nested inside another is charged to the
    inner part only."""

    def __init__(self):
        self.totals = {}
        self._stack = []

    def wrap(self, owner, attr: str, part: str) -> None:
        import torch
        fn = getattr(owner, attr)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                inner = self._stack.pop()
                self.totals[part] = self.totals.get(part, 0.0) + dt - inner
                if self._stack:
                    self._stack[-1] += dt

        setattr(owner, attr, timed)


def profile_silo(silo_cfg, data, rounds: int = 3):
    """Where a cross-silo round's time goes: exclusive host time
    (synchronised) of each part over ``rounds`` rounds after a warm-up
    round, evaluating every round; then torch.profiler over ``rounds``
    whole rounds (no evaluation inside the window) for the device's busy
    share, its launches and K2's device time.  Launches here come after
    the main path's counts were read."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.experiments.main import CrossSiloFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink

    cfg = dataclasses.replace(silo_cfg, comm_round=rounds + 1,
                              frequency_of_the_test=1)
    timer = PartTimer()
    per_round = []
    with MetricsSink(None) as sink:
        fed = CrossSiloFederation(cfg, data, sink)
        server = fed.server
        timer.wrap(server, "_broadcast", "broadcast_ms")
        timer.wrap(fed.hub, "route", "wire_encode_decode_ms")
        for silo in fed.silos:
            timer.wrap(silo, "_train", "silo_train_ms")
            timer.wrap(silo, "_on_shard_sync", "silo_join_split_ms")
        timer.wrap(server.shard_wire.admission, "offer", "admission_ms")
        timer.wrap(server.stream_agg, "fold_slices", "fold_ms")
        timer.wrap(server.stream_agg, "finalize", "finalize_ms")
        timer.wrap(server, "on_round_done", "eval_ms")
        done = server.on_round_done
        mark = {"t": time.perf_counter(), "totals": {}}

        def on_round_done(r, params):
            done(r, params)
            now = time.perf_counter()
            row = {k: (v - mark["totals"].get(k, 0.0)) * 1e3
                   for k, v in timer.totals.items()}
            row["round_ms"] = (now - mark["t"]) * 1e3
            row["other_ms"] = row["round_ms"] - sum(
                v for k, v in row.items() if k != "round_ms")
            per_round.append(row)
            mark.update(t=now, totals=dict(timer.totals))

        server.on_round_done = on_round_done
        fed.run()
    steady = per_round[1:]
    row = {k: statistics.median(r.get(k, 0.0) for r in steady)
           for k in steady[0]}

    # the device's view: rounds 1..rounds, started after round 0's
    # evaluation and stopped before the last round's
    cfg = dataclasses.replace(silo_cfg, comm_round=rounds + 1,
                              frequency_of_the_test=1000)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}
    with MetricsSink(None) as sink:
        fed = CrossSiloFederation(cfg, data, sink)
        done = fed.server.on_round_done

        def on_round_done(r, params):
            if r == rounds:
                torch.cuda.synchronize()
                window["wall_us"] = (time.perf_counter() - window["t0"]) * 1e6
                prof.stop()
            done(r, params)
            if r == 0:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()

        fed.server.on_round_done = on_round_done
        fed.run()
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in events)
    wall_us = window["wall_us"]
    row["profiled_round_ms"] = wall_us / rounds / 1e3
    row["device_busy_ms_per_round"] = busy_us / rounds / 1e3
    row["device_idle_share"] = (1 - busy_us / wall_us) if busy_us else None
    row["kernel_launches_per_round"] = sum(e.count for e in events) / rounds
    k2 = [e for e in events if "shard_finalize_kernel" in e.key]
    row["k2_launches_per_round"] = sum(e.count for e in k2) / rounds
    row["k2_device_ms_per_round"] = sum(
        _self_device_us(e) for e in k2) / rounds / 1e3
    row["k2_share_of_round"] = (row["k2_device_ms_per_round"]
                                / row["profiled_round_ms"])
    top = sorted(events, key=_self_device_us, reverse=True)[:6]
    row["top_device_us_per_round"] = {
        e.key[:60]: _self_device_us(e) / rounds for e in top}
    phase("profile cross_silo", **row)
    return row


def silo_round_parity(silo_cfg, data, min_move: float = 10 * ROUND_TOL):
    """One cross-silo round with TF32 off on the GPU against the same
    round on the CPU, from one init (no evaluation); the round must move
    the global by more than ``min_move``."""
    import dataclasses
    import torch
    from fedml_tpu_torch.experiments.main import CrossSiloFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink

    out = {}
    with MetricsSink(None) as sink:
        cpu = CrossSiloFederation(dataclasses.replace(
            silo_cfg, comm_round=1, platform="cpu"), data, sink)
        init = {k: v.clone() for k, v in cpu.server.params.items()}
        gpu = CrossSiloFederation(dataclasses.replace(
            silo_cfg, comm_round=1, platform=CARD), data, sink,
            init_params=init)
        with tf32_off():
            for name, fed in (("cuda", gpu), ("cpu", cpu)):
                fed.server.on_round_done = None
                fed.run()
                out[name] = {k: v.cpu() for k, v in fed.server.params.items()}
    diff = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
               for k in out["cpu"])
    moved = max(float((out["cpu"][k] - init[k]).abs().max()) for k in init)
    phase("cross_silo round vs cpu", max_abs_diff=diff, tol=ROUND_TOL,
          tf32=False, moved_from_init=moved)
    if not moved > min_move:
        fail(f"the cross-silo round left the global where it was "
             f"(moved {moved})")
    if not diff <= ROUND_TOL:
        fail(f"GPU cross-silo round differs from the CPU round by {diff} > "
             f"{ROUND_TOL}")
    return diff


# ---------------------------------------------------------------------------
# the device-resident round, scanned rounds, the Byzantine rules, the
# defended cross-silo aggregate and round checkpoints (the CNN's widths)
# ---------------------------------------------------------------------------

FEDAVG_ARGS = ["--algo", "fedavg", *COMMON_ARGS]
DEVICE_ROUNDS = 3              # graphed rounds held against the host loop
PATH_ROUNDS = 10               # rounds a profile of each path covers (= K)
SCAN_ARGS = [*FEDAVG_ARGS, "--comm_round", "21", "--frequency_of_the_test",
             "10"]
SCAN_K = 10
BYZ_ARGS = {"coordinate_median": [], "trimmed_mean": [],
            "krum": ["--byz_f", "2"],
            "multi_krum": ["--byz_f", "2", "--krum_m", "3"],
            "geometric_median": []}
SILO_ROBUST_ARGS = {
    "stack trimmed_mean": ["--agg_mode", "stack", "--robust_agg",
                           "trimmed_mean", "--norm_clip", "5.0"],
    "stream coordinate_median": ["--agg_mode", "stream", "--robust_agg",
                                 "coordinate_median", "--stream_reservoir",
                                 "8"]}
SILO_MEAN_ARGS = ["--algo", "cross_silo", "--silo_backend", "local",
                  "--norm_clip", "5.0", "--agg_noise_std", str(SIGMA),
                  *COMMON_ARGS, "--comm_round", "2"]
CKPT_ROUNDS, CKPT_STOP = 4, 2
# host-side CUDA runtime calls that put work on the device
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms (no atomics in the grouped-conv
    backward) and TF32 off inside the block: the CLI's
    ``--deterministic``."""
    from fedml_tpu_torch.experiments.main import deterministic_flags
    with deterministic_flags(True):
        yield


def fedavg_algo(cfg, data, device="cuda", workload=None):
    """The CLI runner's FedAvg for ``cfg``, with ``workload`` in place of
    the CLI factory's when given."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    from fedml_tpu_torch.experiments.main import (_fedavg_cfg_kwargs,
                                                  _make_workload)
    wl = workload if workload is not None else _make_workload(cfg, data)
    return FedAvg(wl, data, FedAvgConfig(**_fedavg_cfg_kwargs(cfg)),
                  device=device)


def round_plan(data, m: int, rounds: int, start: int = 0):
    """``[rounds, m]`` padded ids and live masks of rounds ``start``.."""
    import numpy as np
    from fedml_tpu_torch.algorithms.fedavg import pad_ids
    from fedml_tpu_torch.core.sampling import sample_clients
    pairs = [pad_ids(sample_clients(r, data.client_num, m), m)
             for r in range(start, start + rounds)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def max_diff(a, b) -> float:
    return max(float((a[k].double().cpu() - b[k].double().cpu()).abs().max())
               for k in a)


def bit_equal(a, b) -> bool:
    return all(a[k].cpu().numpy().tobytes() == b[k].cpu().numpy().tobytes()
               for k in a)


def host_loop_rounds(algo, data, params, rounds: int, start: int = 0):
    """``rounds`` rounds of the host-gather loop (the cohort copied to the
    card each round), the device not drained at the end."""
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    m = algo.cfg.client_num_per_round
    for r in range(start, start + rounds):
        cohort = gather_cohort(data.train,
                               sample_clients(r, data.client_num, m),
                               pad_to=m, device="cuda")
        params, _ = algo.cohort_step(params, cohort)
    return params


def graph_rounds(algo, data, params, rounds: int, start: int = 0):
    """``rounds`` rounds through the algorithm's device round (one replay
    of its captured graph each)."""
    ids, live = round_plan(data, algo.cfg.client_num_per_round, rounds,
                           start)
    for r in range(rounds):
        params, _ = algo._device_round(params, algo._train_dev, ids[r],
                                       live[r])
    return params


def staged(algo):
    """Stage the algorithm's train split on the card; fail unless the
    device path is taken."""
    import torch
    if not algo._stage_train_on_device():
        fail("the FEMNIST train split did not take the device path")
    if algo._train_dev["x"].device.type != "cuda":
        fail(f"the train split is on {algo._train_dev['x'].device}")
    return sum(v.numel() * v.element_size()
               for v in algo._train_dev.values()) / 1e9


def path_profile(run, rounds: int):
    """One path's cost a round: ``run()`` enqueues ``rounds`` rounds.  Host
    µs (the enqueue, before the device is drained) and wall ms, each
    after a warm-up call; then torch.profiler over one more call: the
    device's kernels and busy time, the host's launch calls (kernel
    launches, graph launches, copies) and the idle share."""
    import torch
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(host_us_per_round=(t1 - t0) / rounds * 1e6,
                round_ms=(t2 - t0) / rounds * 1e3,
                **profile_once(run, rounds))


def profile_once(run, rounds: int):
    """torch.profiler over one call of ``run()`` (``rounds`` rounds), the
    device drained before and after: the device's kernels and busy time,
    the host's launch calls (kernel launches, graph launches, copies) and
    the idle share, per round."""
    from torch.profiler import ProfilerActivity, profile
    sync(CARD)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if CARD == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        sync(CARD)
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    events = [e for e in averages if _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in events)
    apis = {e.key: e.count / rounds for e in averages
            if e.key in LAUNCH_APIS}
    return dict(profiled_round_ms=wall_us / rounds / 1e3,
                device_kernels_per_round=sum(e.count for e in events)
                / rounds,
                host_launch_calls_per_round=sum(apis.values()),
                host_launch_calls=apis,
                device_busy_ms_per_round=busy_us / rounds / 1e3,
                device_idle_share=(1 - busy_us / wall_us) if busy_us
                else None)


def check_device_round(data):
    """Phase 12: plain FedAvg's device-resident round, captured as a CUDA
    graph, against the port's host-gather loop on the card (bit-equal in
    deterministic mode, TF32 off; the difference in the default mode
    recorded) and against the port on the CPU (one round, ROUND_TOL);
    captures and replays counted exactly; then the host loop, the K=1
    graph and the K=10 scanned graph profiled."""
    import dataclasses
    import torch
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.parallel.cohort import make_scanned_rounds

    cfg = config_from_argv(FEDAVG_ARGS)
    m = cfg.client_num_per_round
    out = {}
    for mode, ctx in (("deterministic", deterministic),
                      ("default", contextlib.nullcontext)):
        with ctx():
            host = fedavg_algo(cfg, data)
            init = host.init_params()
            want = host_loop_rounds(host, data, init, DEVICE_ROUNDS)
            graphed = fedavg_algo(cfg, data)
            resident_gb = staged(graphed)
            got = graph_rounds(graphed, data, init, DEVICE_ROUNDS)
            torch.cuda.synchronize()
            graph = graphed._device_round.graph
            if graph is None or graph.captures != 1 \
                    or graph.replays != DEVICE_ROUNDS:
                fail(f"the device round captured "
                     f"{getattr(graph, 'captures', 0)} graphs and replayed "
                     f"{getattr(graph, 'replays', 0)} times; need 1 and "
                     f"{DEVICE_ROUNDS}")
            out[mode] = dict(bit_equal=bit_equal(got, want),
                             max_abs_diff=max_diff(got, want),
                             moved_from_init=max_diff(want, init),
                             capture_ms=graph.capture_s * 1e3,
                             captured_launches=graph.captured_launches)
            del host, graphed, graph
    if not out["deterministic"]["bit_equal"]:
        fail(f"the graphed device round differs from the host loop in "
             f"deterministic mode by {out['deterministic']['max_abs_diff']}")
    if not out["deterministic"]["moved_from_init"] > 10 * ROUND_TOL:
        fail("the device rounds left the global where it was")
    with deterministic():
        cpu = fedavg_algo(dataclasses.replace(cfg, platform="cpu"), data,
                          "cpu")
        cpu._stage_train_on_device()
        init = cpu.init_params()
        cpu_round = graph_rounds(cpu, data, init, 1)
        gpu = fedavg_algo(cfg, data)
        staged(gpu)
        gpu_round = graph_rounds(gpu, data,
                                 {k: v.cuda() for k, v in init.items()}, 1)
        cpu_diff = max_diff(gpu_round, cpu_round)
        del cpu, gpu
    if not cpu_diff <= ROUND_TOL:
        fail(f"the graphed round differs from the CPU round by {cpu_diff} "
             f"> {ROUND_TOL}")
    torch.cuda.empty_cache()

    # the three paths' costs, default mode
    host = fedavg_algo(cfg, data)
    graphed = fedavg_algo(cfg, data)
    staged(graphed)
    scanned = make_scanned_rounds(graphed._local_train, m,
                                  client_axis=cfg.client_axis,
                                  max_rounds=PATH_ROUNDS)
    ids, live = round_plan(data, m, PATH_ROUNDS)
    state = {"host": host.init_params(), "k1": None, "k10": None}
    state["k1"] = state["k10"] = state["host"]

    def run_host():
        state["host"] = host_loop_rounds(host, data, state["host"],
                                         PATH_ROUNDS)

    def run_k1():
        state["k1"] = graph_rounds(graphed, data, state["k1"], PATH_ROUNDS)

    def run_k10():
        state["k10"], _ = scanned(state["k10"], graphed._train_dev, ids, live)

    paths = {"host_loop": path_profile(run_host, PATH_ROUNDS),
             "graph_k1": path_profile(run_k1, PATH_ROUNDS),
             "graph_k10": path_profile(run_k10, PATH_ROUNDS)}
    paths["graph_k1"]["capture_ms"] = graphed._device_round.graph.capture_s \
        * 1e3
    paths["graph_k10"]["capture_ms"] = scanned.graph.capture_s * 1e3
    paths["graph_k10"]["replays_per_call"] = PATH_ROUNDS
    # the host loop's parts (synchronised host timers, 5 rounds)
    parts = {"gather_ms": [], "train_ms": [], "aggregate_ms": []}
    from fedml_tpu_torch.core.pytree import tree_weighted_mean
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.parallel.cohort import train_cohort
    params = host.init_params()
    for r in range(6):
        t0 = time.perf_counter()
        cohort = gather_cohort(data.train,
                               sample_clients(r, data.client_num, m),
                               pad_to=m, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stacked, _ = train_cohort(host._local_train, params, cohort)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params = tree_weighted_mean(stacked, cohort["num_samples"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if r:
            parts["gather_ms"].append((t1 - t0) * 1e3)
            parts["train_ms"].append((t2 - t1) * 1e3)
            parts["aggregate_ms"].append((t3 - t2) * 1e3)
    paths["host_loop"].update({k: statistics.median(v)
                               for k, v in parts.items()})
    phase("device round", resident_train_gb=resident_gb,
          rounds=DEVICE_ROUNDS, vs_host_loop=out, vs_cpu_max_abs_diff=cpu_diff,
          tol=ROUND_TOL, paths=paths,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del host, graphed, scanned, state
    torch.cuda.empty_cache()
    return out, cpu_diff, paths


@contextlib.contextmanager
def recording_runs():
    """Record each ``FedAvg.run``'s algorithm and returned params (the CLI
    runner keeps neither)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvg
    real = FedAvg.run
    runs = []

    def run(self, *a, **kw):
        params = real(self, *a, **kw)
        runs.append((self, {k: v.clone() for k, v in params.items()}))
        return params

    FedAvg.run = run
    try:
        yield runs
    finally:
        FedAvg.run = real


@contextlib.contextmanager
def env(name: str, value):
    import os
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def run_scanned(data):
    """Phase 13: 21 rounds, evaluation every 10, through the CLI's runner:
    the host loop (device-data budget 0), the K=1 graph and
    ``--rounds_per_dispatch 10``; eval rounds [0, 10, 20] on each, the
    final params bit-equal in deterministic mode; steady rounds/s and the
    capture time in the default mode."""
    import torch
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config, run_fedavg
    from fedml_tpu_torch.utils.metrics import MetricsSink

    variants = {"host_loop": ("0", 1), "graph_k1": (None, 1),
                "graph_k10": (None, SCAN_K)}
    result = {}
    for mode, ctx in (("deterministic", deterministic),
                      ("default", contextlib.nullcontext)):
        finals, rows = {}, {}
        for name, (budget, k) in variants.items():
            cfg = config_from_argv(SCAN_ARGS + ["--rounds_per_dispatch",
                                                str(k)])
            check_config(cfg)
            with ctx(), env("FEDML_TPU_DEVICE_DATA_BYTES", budget), \
                    recording_runs() as runs, MetricsSink(None) as sink:
                t0 = time.perf_counter()
                summary = run_fedavg(cfg, data, sink)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
            algo, finals[name] = runs[-1]
            graph = (getattr(algo._scanned_rounds, "graph", None)
                     or getattr(algo._device_round, "graph", None))
            evals = [h["round"] for h in algo.history]
            if evals != [0, 10, 20]:
                fail(f"{name} evaluated at rounds {evals}, need [0, 10, 20]")
            if (graph is None) != (name == "host_loop"):
                fail(f"{name} ran {'a' if graph else 'no'} graph")
            if graph is not None and (graph.captures, graph.replays) \
                    != (1, cfg.comm_round):
                fail(f"{name} captured {graph.captures} graphs and replayed "
                     f"{graph.replays} times; need 1 and {cfg.comm_round}")
            rows[name] = dict(
                rounds_per_s=summary["rounds_per_s"], run_s=run_s,
                capture_ms=graph.capture_s * 1e3 if graph else None,
                replays=graph.replays if graph else 0,
                test_acc=summary["test_acc"], eval_rounds=evals)
            del algo, graph, runs
            torch.cuda.empty_cache()
        for name in ("graph_k1", "graph_k10"):
            rows[name]["bit_equal_to_host_loop"] = bit_equal(
                finals[name], finals["host_loop"])
            rows[name]["max_abs_diff_to_host_loop"] = max_diff(
                finals[name], finals["host_loop"])
        if mode == "deterministic" and not all(
                rows[n]["bit_equal_to_host_loop"]
                for n in ("graph_k1", "graph_k10")):
            fail(f"scanned rounds differ from the host loop in "
                 f"deterministic mode: {rows}")
        result[mode] = rows
    phase("scanned rounds", rounds=21, k=SCAN_K, **result)
    return result


def check_byzantine(data):
    """Phase 14: ``--algo fedavg_robust --defense <rule>`` for each of the
    five rules: one round on the card (TF32 off) against the same round on
    the CPU (ROUND_TOL); Krum and multi-Krum pick the same clients on
    both."""
    import dataclasses
    import torch
    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobust
    from fedml_tpu_torch.core.byzantine import krum_weights
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (_make_workload,
                                                  fedavg_robust_config)
    from fedml_tpu_torch.parallel.cohort import train_cohort

    rows = {}
    with tf32_off():
        for rule, extra in BYZ_ARGS.items():
            cfg = config_from_argv(["--algo", "fedavg_robust", "--defense",
                                    rule, *extra, *COMMON_ARGS])
            m = cfg.client_num_per_round
            ids = sample_clients(0, data.client_num, m)
            out, sel = {}, {}
            for dev in ("cuda", "cpu"):
                algo = FedAvgRobust(_make_workload(cfg, data), data,
                                    fedavg_robust_config(
                                        dataclasses.replace(cfg,
                                                            platform=dev)),
                                    device=dev)
                init = algo.init_params()
                cohort = gather_cohort(data.train, ids, pad_to=m, device=dev)
                t0 = time.perf_counter()
                params, _ = algo.cohort_step(init, cohort)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    round_ms = (time.perf_counter() - t0) * 1e3
                out[dev] = {k: v.cpu() for k, v in params.items()}
                if rule in ("krum", "multi_krum"):
                    stacked, _ = train_cohort(algo._local_train, init, cohort)
                    w = krum_weights(stacked, cohort["num_samples"],
                                     cfg.byz_f,
                                     cfg.krum_m if rule == "multi_krum"
                                     else 1)
                    sel[dev] = [int(i) for i in torch.nonzero(w.cpu())]
            diff = max_diff(out["cuda"], out["cpu"])
            rows[rule] = dict(max_abs_diff=diff, round_ms=round_ms)
            if sel:
                rows[rule]["selected"] = sel
                if sel["cuda"] != sel["cpu"]:
                    fail(f"{rule} selected {sel['cuda']} on the card and "
                         f"{sel['cpu']} on the CPU")
            if not diff <= ROUND_TOL:
                fail(f"the {rule} round differs from the CPU round by "
                     f"{diff} > {ROUND_TOL}")
    phase("byzantine", tol=ROUND_TOL, tf32=False, rules=rows)
    return rows


def silo_fed(argv, data, device, init=None):
    import dataclasses
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (CrossSiloFederation,
                                                  check_config)
    from fedml_tpu_torch.utils.metrics import MetricsSink
    cfg = dataclasses.replace(config_from_argv(argv), platform=device)
    check_config(cfg)
    with MetricsSink(None) as sink:
        fed = CrossSiloFederation(cfg, data, sink, init_params=init)
    fed.server.on_round_done = None      # no evaluation
    return fed


def check_silo_robust(data):
    """Phase 15: the live cross-silo server's ``--robust_agg`` on the
    in-process hub, one round on the card (TF32 off) against the CPU:
    the defended stack (trimmed mean, clip 5) and the stream's reservoir
    (coordinate median, K=8); then, on the card, the defended mean in
    stack mode against stream mode (clip 5, sigma 0.025, 2 rounds), bit
    for bit."""
    import torch
    base = ["--algo", "cross_silo", "--silo_backend", "local", *COMMON_ARGS,
            "--comm_round", "1"]
    rows = {}
    with tf32_off():
        for name, extra in SILO_ROBUST_ARGS.items():
            cpu = silo_fed(base + extra, data, "cpu")
            init = {k: v.clone() for k, v in cpu.server.params.items()}
            gpu = silo_fed(base + extra, data, "cuda", init)
            out = {}
            for dev, fed in (("cuda", gpu), ("cpu", cpu)):
                t0 = time.perf_counter()
                fed.run()
                out[dev] = {k: v.cpu() for k, v in fed.server.params.items()}
                if dev == "cuda":
                    round_ms = (time.perf_counter() - t0) * 1e3
            diff = max_diff(out["cuda"], out["cpu"])
            moved = max_diff(out["cpu"], init)
            rows[name] = dict(max_abs_diff=diff, moved_from_init=moved,
                              round_ms=round_ms,
                              stack=gpu.server.aggregate_fn is not None)
            if not moved > 2 * ROUND_TOL or not diff <= ROUND_TOL:
                fail(f"cross-silo {name}: moved {moved}, differs from the "
                     f"CPU by {diff} (limit {ROUND_TOL})")
    means = {}
    init = None
    for mode in ("stack", "stream"):
        fed = silo_fed(SILO_MEAN_ARGS + ["--agg_mode", mode], data, "cuda",
                       init)
        if init is None:
            init = {k: v.clone() for k, v in fed.server.params.items()}
        fed.run()
        means[mode] = {k: v.clone() for k, v in fed.server.params.items()}
    same = bit_equal(means["stack"], means["stream"])
    phase("cross_silo robust", tol=ROUND_TOL, tf32=False, rules=rows,
          stack_mean_bit_equal_stream_mean=same,
          stack_vs_stream_max_abs_diff=max_diff(means["stack"],
                                                means["stream"]))
    if not same:
        fail("the defended stack mean differs from the stream mean on the "
             "card")
    return rows, same


def check_checkpoint(data, root: Path):
    """Phase 16: plain FedAvg through the CLI's runner with
    ``--checkpoint_dir``, stopped after round 2 and resumed, against an
    uninterrupted 4-round run: bit for bit on the card (deterministic
    mode; both runs take the graphed device round)."""
    import torch
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config, run_fedavg
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
    from fedml_tpu_torch.utils.metrics import MetricsSink

    ckpt = root / "build" / "checkpoint_phase"
    shutil.rmtree(ckpt, ignore_errors=True)
    finals = {}
    runs_spec = {"straight": [],
                 "stopped": ["--checkpoint_dir", str(ckpt),
                             "--checkpoint_every", "1", "--comm_round",
                             str(CKPT_STOP)],
                 "resumed": ["--checkpoint_dir", str(ckpt),
                             "--checkpoint_every", "1"]}
    with deterministic():
        for name, extra in runs_spec.items():
            cfg = config_from_argv([*FEDAVG_ARGS, "--comm_round",
                                    str(CKPT_ROUNDS), *extra])
            check_config(cfg)
            t0 = time.perf_counter()
            with recording_runs() as runs, MetricsSink(None) as sink:
                run_fedavg(cfg, data, sink)
            torch.cuda.synchronize()
            algo, finals[name] = runs[-1]
            if name != "straight" and algo._device_round.graph is None:
                fail(f"the {name} run did not take the graphed device round")
            finals[name + "_rounds"] = len(algo.round_times)
            finals[name + "_s"] = time.perf_counter() - t0
            del algo, runs
    latest = RoundCheckpointer(str(ckpt)).latest_round()
    same = bit_equal(finals["resumed"], finals["straight"])
    phase("checkpoint", rounds=CKPT_ROUNDS, stopped_after=CKPT_STOP,
          resumed_rounds_run=finals["resumed_rounds"], latest_step=latest,
          bit_equal=same,
          max_abs_diff=max_diff(finals["resumed"], finals["straight"]),
          seconds={k: finals[k + "_s"] for k in runs_spec})
    if not same or latest != CKPT_ROUNDS - 1 \
            or finals["resumed_rounds"] != CKPT_ROUNDS - CKPT_STOP:
        fail("the resumed run does not continue the uninterrupted one")
    shutil.rmtree(ckpt, ignore_errors=True)
    return same


# ---------------------------------------------------------------------------
# live cross-silo fault tolerance and transports: crash -> resume through
# the round journal, chaos on the threaded drive, MQTT over the repo's own
# broker (the sharded slice's configuration, K2 in every closed round)
# ---------------------------------------------------------------------------

FT_ROUNDS = 3                  # rounds of the crash-resume and MQTT runs
CRASH_AT = (("post_admission_pre_fold", 2), ("post_fold_pre_ack", 2),
            ("barrier_close", 1), ("mid_checkpoint_write", 1))
CRASH_ROUND = 1                # the round each kill lands in
CHAOS_ROUNDS = 4
CHAOS_RATES = ["--chaos_drop", "0.1", "--chaos_dup", "0.1",
               "--chaos_reorder", "0.1", "--chaos_delay", "0.1",
               "--chaos_corrupt", "0.05"]
# the straggler timeout T and the detector's dead_after_s D are picked from
# the pumped round the crash-resume phase measures: T = CHAOS_T_ROUNDS x
# that round (at least CHAOS_T_MIN_S), D = CHAOS_D_OVER_T x T
CHAOS_T_ROUNDS, CHAOS_T_MIN_S, CHAOS_D_OVER_T = 5, 1.0, 3
# per round: the server's global against the replay of that round from the
# server's previous global (the server's fold order, the plain finalize);
# and each admitted upload the chaos did not touch against its replayed
# training
CHAOS_REPLAY_TOL = ROUND_TOL
MQTT_TOL = ROUND_TOL           # MQTT global vs the pumped hub's: the fold
#                                adds in arrival order, which threads do
#                                not fix, and training carries the ulps on


def ft_cfg(extra, rounds: int):
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    cfg = config_from_argv([*SILO_ARGS, "--comm_round", str(rounds),
                            *extra])
    check_config(cfg)
    return cfg


def ft_fed(cfg, data, init=None, **kw):
    """The runner's federation for ``cfg`` (no evaluation), recording each
    closed round's wall time and global."""
    from fedml_tpu_torch.experiments.main import CrossSiloFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink
    with MetricsSink(None) as sink:
        fed = CrossSiloFederation(cfg, data, sink, init_params=init, **kw)
    fed.closed = []
    mark = {"t": None}

    def on_round_done(r, params):
        import torch
        torch.cuda.synchronize()
        now = time.perf_counter()
        fed.closed.append((r, now - (mark["t"] or fed.t_start),
                           {k: v.clone() for k, v in params.items()}))
        mark["t"] = now

    fed.server.on_round_done = on_round_done
    fed.t_start = None
    return fed


def ft_run(fed):
    import torch
    torch.cuda.synchronize()
    fed.t_start = time.perf_counter()
    return fed.run()


def rounds_per_s(fed) -> float:
    """Closed rounds after the first (which carries the warm-up) per
    second."""
    times = [dt for _, dt, _ in fed.closed][1:]
    return len(times) / sum(times) if times else 0.0


def steady_round_ms(fed) -> float:
    times = [dt for _, dt, _ in fed.closed][1:] or \
        [dt for _, dt, _ in fed.closed]
    return statistics.median(times) * 1e3


def check_silo_crash_resume(data, root: Path):
    """Phase 17: the sharded cross-silo slice killed in round 1 at four
    crash points and resumed in the same process from its checkpoint and
    journal under ``build/``: each resumed global bit-equal on the card to
    the uncrashed run's (the sharded fold state device -> host -> disk ->
    device, and the resumed K2 finalize; deterministic mode).  A journal
    whose opening-global crc was tampered with is abandoned and the run
    still ends equal.  Snapshot costs and the journaled round beside the
    plain one."""
    import torch
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                                  Faultline)
    base = root / "build" / "silo_crash"
    shutil.rmtree(base, ignore_errors=True)

    def durable(tag):
        return ["--checkpoint_dir", str(base / tag / "ck"),
                "--checkpoint_every", "1",
                "--journal_dir", str(base / tag / "j"),
                "--journal_snapshot_every", "1"]

    out = {}
    with deterministic():
        plain = ft_fed(ft_cfg([], FT_ROUNDS), data)
        init = {k: v.clone() for k, v in plain.server.params.items()}
        ft_run(plain)
        ref = ft_fed(ft_cfg(durable("ref"), FT_ROUNDS), data, init)
        snaps = []
        real_snapshot = ref.journal.snapshot

        def snapshot(*a, **kw):
            ok = real_snapshot(*a, **kw)
            if ok:
                snaps.append(dict(ref.journal.last_snapshot_ms))
            return ok

        ref.journal.snapshot = snapshot
        ft_run(ref)
        want = ref.server.params
        if not bit_equal(plain.server.params, want):
            fail("the journaled cross-silo run differs from the plain run")
        points = {}
        for point, hit in CRASH_AT:
            cfg = ft_cfg(durable(point), FT_ROUNDS)
            fl = Faultline(crashes=[CrashSpec(point=point, hit=hit,
                                              round_idx=CRASH_ROUND)])
            killed = ft_fed(cfg, data, init, faultline=fl)
            try:
                ft_run(killed)
                fail(f"the {point} kill never fired")
            except ActorKilled:
                pass
            fl.respawn()
            resumed = ft_fed(cfg, data, init)
            trained = []
            for silo in resumed.silos:
                real_fn = silo.train_fn

                def train_fn(params, client_idx, round_idx, _fn=real_fn,
                             _silo=silo.node_id):
                    trained.append((round_idx, _silo))
                    return _fn(params, client_idx, round_idx)
                silo.train_fn = train_fn
            fused_agg.reset_launch_counts()
            ft_run(resumed)
            torch.cuda.synchronize()
            k2 = fused_agg.launch_counts["shard_finalize"]
            rounds_after = len(resumed.closed)
            same = bit_equal(resumed.server.params, want)
            points[point] = dict(
                hit=hit, retasked=sorted(s for r, s in trained
                                         if r == CRASH_ROUND),
                rounds_after_resume=rounds_after, k2_launches=k2,
                bit_equal=same,
                max_abs_diff=max_diff(resumed.server.params, want))
            if not same:
                fail(f"the run resumed after a kill at {point} differs from "
                     f"the uncrashed run on the card")
            need = plain.cfg.model_shards * rounds_after
            if k2 != need or rounds_after != FT_ROUNDS - CRASH_ROUND:
                fail(f"after the {point} resume: {rounds_after} rounds "
                     f"closed, {k2} K2 launches (need "
                     f"{FT_ROUNDS - CRASH_ROUND} and {need})")
        # a journal whose opening crc disagrees with the restored global
        cfg = ft_cfg(durable("tampered"), FT_ROUNDS)
        fl = Faultline(crashes=[CrashSpec(point="barrier_close",
                                          round_idx=CRASH_ROUND)])
        try:
            ft_run(ft_fed(cfg, data, init, faultline=fl))
            fail("the tampered-journal kill never fired")
        except ActorKilled:
            pass
        path = base / "tampered" / "j" / "journal.jsonl"
        lines = path.read_text().splitlines()
        start = json.loads(lines[0])
        start["global_crc"] = (start["global_crc"] + 1) % 2 ** 32
        lines[0] = json.dumps(start, sort_keys=True)
        path.write_text("\n".join(lines) + "\n")
        tampered = ft_fed(cfg, data, init)
        abandoned = []
        real_abandon = tampered.journal.abandon
        tampered.journal.abandon = lambda r, why: (abandoned.append(
            [r, why]), real_abandon(r, why))
        ft_run(tampered)
        tampered_same = bit_equal(tampered.server.params, want)
        if abandoned != [[CRASH_ROUND, "global crc mismatch"]] \
                or not tampered_same:
            fail(f"the tampered journal: abandoned {abandoned}, bit-equal "
                 f"{tampered_same}")
    snap = {k: statistics.median(s[k] for s in snaps)
            for k in ("state_ms", "encode_ms", "write_ms", "fsync_ms",
                      "bytes")}
    out = dict(
        rounds=FT_ROUNDS, crash_round=CRASH_ROUND, snapshot_every=1,
        points=points, tampered_crc=dict(abandoned=abandoned,
                                         bit_equal=tampered_same),
        snapshots=len(snaps), snapshot_median=snap,
        snapshot_ms=[[s["state_ms"], s["encode_ms"], s["write_ms"],
                      s["fsync_ms"]] for s in snaps],
        snapshot_max_ms=max(s["state_ms"] + s["encode_ms"] + s["write_ms"]
                            + s["fsync_ms"] for s in snaps),
        plain_round_ms=steady_round_ms(plain),
        journaled_round_ms=steady_round_ms(ref),
        snapshot_ms_per_round=sum(
            s["state_ms"] + s["encode_ms"] + s["write_ms"] + s["fsync_ms"]
            for s in snaps) / FT_ROUNDS,
        bit_equal=all(p["bit_equal"] for p in points.values()))
    phase("cross_silo crash resume", **out)
    shutil.rmtree(base, ignore_errors=True)
    return out


def _tree_leaves(tree):
    from fedml_tpu_torch.comm.chaos import _array_leaves
    return _array_leaves(tree, [])


def _copy_tree(tree):
    import numpy as np
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def check_silo_chaos(data, round_ms: float):
    """Phase 18: the sharded slice on the threaded drive (each actor on
    its own thread) for 4 rounds under seeded chaos on every link but
    silo 1's (it stays clean, so a round always has a report to close on):
    every round closes, faults were injected, no upload is folded twice,
    every folded upload is finite (a NaN corruption never reaches the
    fold), K2 launches 4 times a closed round, and each round's global
    equals its replay from the server's previous global: the admitted
    silos, in the server's fold order, trained again from that global (an
    upload the chaos did not touch must match the server's within
    CHAOS_REPLAY_TOL) and folded and finalized with K2's plain version.
    An upload of a silo whose frames the chaos corrupted that round is
    replayed as the server admitted it, and those unlike their clean
    replay are counted: a flipped low-order byte leaves a valid float near
    the true one, which no screen can tell from an honest update."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.comm import chaos as chaos_mod
    from fedml_tpu_torch.comm.chaos import LinkChaos
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.core.pytree import (flatten_nested, nest, to_host,
                                             tree_keys)
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.experiments.main import (_make_workload,
                                                  _silo_training_setup)
    from fedml_tpu_torch.shard_spine import build_shard_spine
    from fedml_tpu_torch.shard_spine.plan import SiloShardCodec

    t_s = max(CHAOS_T_MIN_S, math.ceil(CHAOS_T_ROUNDS * round_ms / 500) / 2)
    d_s = CHAOS_D_OVER_T * t_s
    cfg = ft_cfg([*CHAOS_RATES, "--straggler_policy", "drop",
                  "--round_timeout_s", str(t_s), "--heartbeat_s", "0.05",
                  "--dead_after_s", str(d_s), "--min_silo_frac", "0.1"],
                 CHAOS_ROUNDS)
    corrupted = []
    real_corrupt = chaos_mod._corrupt_payload

    def corrupt(msg, u_leaf, u_mode, u_pos):
        out = real_corrupt(msg, u_leaf, u_mode, u_pos)
        if out is not None:
            corrupted.append(dict(
                src=msg.sender_id, dst=msg.receiver_id,
                round=msg.get(Message.ARG_ROUND),
                shard=msg.get(Message.ARG_SHARD),
                mode="nan" if u_mode < 0.5 else "flip"))
        return out

    with deterministic():
        fed = ft_fed(cfg, data)
        if fed.drive != "threaded":
            fail(f"--chaos_* took the {fed.drive} drive")
        init = {k: v.clone() for k, v in fed.server.params.items()}
        fed.chaos_plan.links[(0, 1)] = LinkChaos()
        fed.chaos_plan.links[(1, 0)] = LinkChaos()
        server = fed.server
        folds = {}
        rejected = {}
        real_note = server._note_upload

        def note_upload(silo, entry):
            if entry is None:
                rejected.setdefault(server.round_idx, []).append(silo)
            else:
                folds.setdefault(server.round_idx, []).append(
                    (silo, [_copy_tree(s) for s in entry[0]],
                     float(entry[1])))
            return real_note(silo, entry)

        server._note_upload = note_upload
        chaos_mod._corrupt_payload = corrupt
        fused_agg.reset_launch_counts()
        prof = profile(activities=[ProfilerActivity.CUDA])
        try:
            with prof:
                summary = ft_run(fed)
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - fed.t_start
        finally:
            chaos_mod._corrupt_payload = real_corrupt
        k2 = fused_agg.launch_counts["shard_finalize"]
        closed = [r for r, _, _ in fed.closed]
        faults = {}
        for t in [server.transport] + [s.transport for s in fed.silos]:
            for kind, n in t.faults.items():
                faults[kind] = faults.get(kind, 0) + n
        if server.aborted or closed != list(range(CHAOS_ROUNDS)):
            fail(f"chaos: rounds closed {closed}, aborted {server.aborted}")
        if not sum(faults.values()):
            fail("chaos: the plan injected no fault")
        if k2 != cfg.model_shards * len(closed):
            fail(f"chaos: {k2} K2 launches for {len(closed)} rounds")
        for r, row in folds.items():
            silos = [s for s, _, _ in row]
            if len(set(silos)) != len(silos):
                fail(f"chaos: round {r} folded a silo twice: {silos}")
            for _, slices, _ in row:
                if not all(np.isfinite(a).all() for sl in slices
                           for a in _tree_leaves(sl)):
                    fail(f"chaos: round {r} folded a non-finite upload")
        if not summary.get("params_finite"):
            fail("chaos: the global is not finite")
        # the replay, round by round from the server's own record
        wl = _make_workload(cfg, data)
        device = server.device
        globals_ = [init] + [p for _, _, p in fed.closed]
        _, make_train_fn = _silo_training_setup(cfg, data, wl, device, init)
        # the slice's spine, its finalize swapped for K2's plain version
        spine = build_shard_spine(init, num_shards=cfg.model_shards,
                                  norm_clip=cfg.norm_clip,
                                  noise_std=cfg.agg_noise_std, seed=cfg.seed,
                                  fused="on")
        codec = SiloShardCodec(spine.spec())
        touched = {(c["round"], c["dst"] if c["src"] == 0 else c["src"])
                   for c in corrupted}
        upload_diff, round_diff, replayed = 0.0, 0.0, 0
        touched_folded, touched_differ = 0, 0
        for r in range(CHAOS_ROUNDS):
            g = globals_[r]
            params = codec.join(spine.broadcast_slices(to_host(nest(g))))
            ids = sample_clients(r, data.client_num, len(fed.silos))
            spine.agg.reset(g)
            for silo, slices, weight in folds.get(r, []):
                new, _ = make_train_fn(silo)(flatten_nested(params),
                                             int(ids[silo - 1]), r)
                mine = codec.split(to_host(nest(
                    {k: new[k] for k in tree_keys(new)})))
                diff = max(float(np.abs(np.asarray(a, np.float64) - b).max())
                           for a_sl, b_sl in zip(mine, slices)
                           for a, b in zip(_tree_leaves(a_sl),
                                           _tree_leaves(b_sl)))
                if (r, silo) in touched:
                    # a frame of this silo's round was corrupted: the
                    # replay folds what the server admitted
                    touched_folded += 1
                    touched_differ += diff > 0
                    spine.agg.fold_slices(slices, weight)
                    continue
                upload_diff = max(upload_diff, diff)
                replayed += 1
                spine.agg.fold_slices(mine, weight)
            if folds.get(r):
                real_k2 = fused_agg.shard_finalize
                fused_agg.shard_finalize = fused_agg.shard_finalize_plain
                try:
                    out = spine.agg.finalize(r)
                finally:
                    fused_agg.shard_finalize = real_k2
                round_diff = max(round_diff, max_diff(out, globals_[r + 1]))
        if upload_diff > CHAOS_REPLAY_TOL or round_diff > CHAOS_REPLAY_TOL:
            fail(f"chaos: the replay differs (uploads {upload_diff}, rounds "
                 f"{round_diff}; limit {CHAOS_REPLAY_TOL})")
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    busy_s = sum(_self_device_us(e) for e in events) / 1e6
    up = [c for c in corrupted if c["src"] != 0]
    row = dict(
        rounds=CHAOS_ROUNDS, round_timeout_s=t_s, dead_after_s=d_s,
        measured_pumped_round_ms=round_ms, heartbeat_s=cfg.heartbeat_s,
        min_silo_frac=cfg.min_silo_frac, faults=faults,
        corrupted_frames={"down": sum(c["src"] == 0 for c in corrupted),
                          "up_nan": sum(c["mode"] == "nan" for c in up),
                          "up_flip": sum(c["mode"] == "flip" for c in up)},
        rejected_reports={r: sorted(v) for r, v in rejected.items()},
        rejected_by_reason=dict(server.shard_wire.admission.rejected),
        folded_per_round=[len(folds.get(r, [])) for r in range(
            CHAOS_ROUNDS)],
        dropped_silos={r: v for r, v in server.dropped_silos.items()},
        k2_launches=k2, replayed_uploads=replayed,
        touched_uploads_folded=touched_folded,
        touched_uploads_folded_unlike_replay=touched_differ,
        upload_max_abs_diff=upload_diff,
        round_max_abs_diff=round_diff, tol=CHAOS_REPLAY_TOL,
        rounds_per_s=rounds_per_s(fed), wall_s=wall_s,
        device_busy_s=busy_s, device_idle_share=1 - busy_s / wall_s)
    phase("cross_silo chaos threaded", **row)
    return row


def in_silo_order(fed, timeout_s: float = 120.0) -> None:
    """Hold each silo's upload until every lower-numbered silo has
    reported this round, so the server folds in the pumped hub's order
    (silo 1, 2, ...) while the silos still train at once on their own
    threads."""
    server = fed.server
    for silo in fed.silos:
        real_fn, before = silo.train_fn, set(range(1, silo.node_id))

        def train_fn(params, client_idx, round_idx, _fn=real_fn,
                     _before=before):
            out = _fn(params, client_idx, round_idx)
            deadline = time.monotonic() + timeout_s
            while server.round_idx == round_idx \
                    and not _before <= set(server._received):
                if time.monotonic() > deadline:
                    fail(f"silo order: round {round_idx} never got silos "
                         f"{sorted(_before)}")
                time.sleep(0.001)
            return out
        silo.train_fn = train_fn


def check_silo_mqtt(data):
    """Phase 19: the sharded slice over the repo's MQTT broker on the
    loopback, the server and 10 silo threads each on a `MiniMqttClient`
    wrapped in `ResilientTransport`, 3 rounds: K2 launches 4 times a
    round, and the global agrees with the pumped hub run of the same seeds
    within MQTT_TOL (the uploads are held to the hub's arrival order, so
    bit for bit is expected and reported); rounds/s, the bytes through
    the broker and the MQTT round beside the hub round."""
    import torch
    from fedml_tpu_torch.comm import mqtt_transport
    from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
    from fedml_tpu_torch.comm.resilient import ResilientTransport, RetryPolicy
    from fedml_tpu_torch.core import fused_agg

    cfg = ft_cfg([], FT_ROUNDS)
    with deterministic():
        hub = ft_fed(cfg, data)
        init = {k: v.clone() for k, v in hub.server.params.items()}
        ft_run(hub)
        broker = MqttBroker()
        try:
            def transport(node):
                return ResilientTransport(
                    mqtt_transport.MqttTransport(node, "127.0.0.1",
                                                 broker.port),
                    RetryPolicy(max_attempts=4), seed=cfg.seed)

            fed = ft_fed(cfg, data, init, transport_factory=transport)
            if fed.drive != "threaded":
                fail(f"the MQTT federation took the {fed.drive} drive")
            in_silo_order(fed)
            fused_agg.reset_launch_counts()
            summary = ft_run(fed)
            torch.cuda.synchronize()
            k2 = fused_agg.launch_counts["shard_finalize"]
        finally:
            broker.stop()
    diff = max_diff(fed.server.params, hub.server.params)
    row = dict(
        rounds=FT_ROUNDS, client=type(fed.server.transport.inner._client)
        .__name__, k2_launches=k2, max_abs_diff_vs_hub=diff, tol=MQTT_TOL,
        bit_equal_hub=bit_equal(fed.server.params, hub.server.params),
        rounds_per_s=rounds_per_s(fed), hub_rounds_per_s=rounds_per_s(hub),
        round_ms=steady_round_ms(fed), hub_round_ms=steady_round_ms(hub),
        broker_bytes_in_per_round=broker.bytes_in / FT_ROUNDS,
        broker_bytes_out_per_round=broker.bytes_out / FT_ROUNDS,
        dead_letters=fed.server.transport.dead_letters + sum(
            s.transport.dead_letters for s in fed.silos))
    row["mqtt_over_hub_ms"] = row["round_ms"] - row["hub_round_ms"]
    phase("cross_silo mqtt", **row)
    if k2 != cfg.model_shards * FT_ROUNDS or fed.server.round_idx != FT_ROUNDS:
        fail(f"mqtt: {fed.server.round_idx} rounds, {k2} K2 launches")
    if not summary.get("params_finite") or not diff <= MQTT_TOL:
        fail(f"mqtt: the global differs from the hub's by {diff} (limit "
             f"{MQTT_TOL})")
    return row


# ---------------------------------------------------------------------------
# slice 4: FedAvg on the transformer LM, through K4 (flash attention)
# ---------------------------------------------------------------------------

FLASH_SHAPES = {               # [B, T, H, d], as the model calls the kernels
    "bench": (2, 2048, 8, 32),     # bench.py's long-context step
    "vmap": (8, 2048, 8, 32),      # 4 clients x B=2, the vmap fold
    "t128": (2, 128, 8, 32),       # one 128 block: diagonal tiles only
    "t384": (2, 384, 8, 32),       # three blocks
    "d16": (2, 256, 4, 16),        # the other head sizes the kernels take
    "d64": (2, 256, 4, 64),
}
FLASH_O_TOL = 1e-5             # x max|ref|: o, m, l against the plain version
FLASH_GRAD_TOL = 1e-4          # x max|ref|: dq, dk, dv
# bench.py:514-521's model, trained through the FedAvg API
LM = dict(vocab_size=256, d_model=256, n_heads=8, n_layers=2, d_ff=1024,
          max_len=2048)
LM_DATA = dict(sample_shape=(2048,), sequence_vocab=256, class_num=256,
               num_clients=16, samples_per_client=4, batch_size=2)
LM_FEDAVG = dict(client_num_per_round=4, batch_size=2, lr=0.1, epochs=1,
                 client_axis="vmap")
LM_ROUNDS = 3
LM_BENCH_STEPS = 10
LM_BENCH_BLOCK = 256           # bench.py's blockwise attention block
# the dense CLI path: the JAX CLI's transformer widths on the Shakespeare
# twin, BASELINE.md row 20's clients (715, 10 per round, B=4, SGD lr 1, E=1)
CLI_LM_ARGS = ["--algo", "fedavg", "--model", "transformer", "--dataset",
               "shakespeare", "--client_num_in_total", "715",
               "--client_num_per_round", "10", "--batch_size", "4", "--lr",
               "1.0", "--epochs", "1", "--comm_round", "3",
               "--frequency_of_the_test", "1000", "--log_stdout", "false"]
# the library's kernel bodies: _flash_attention_kernel,
# _flash_attention_dkv_kernel and _flash_attention_dq_kernel
K4_REPLACES = {"flash_fwd": 331, "flash_bwd_dkv": 796, "flash_bwd_dq": 1146}


def launch_ms(fn, n: int = 20) -> float:
    """Median device time (ms) of one call of ``fn``: CUDA events around
    each of ``n`` calls, after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def sm_clocks_hz():
    """The SM clock now and its maximum (``nvidia-smi``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    now, top = out.stdout.strip().splitlines()[0].split(",")
    return float(now) * 1e6, float(top) * 1e6


def flash_bounds(b: int, h: int, t: int, d: int, sm_hz: float):
    """Per kernel, the least time the card could take (ms): the largest of
    its bytes over 3.35 TB/s (each input read once, each output written
    once: [B, H, T, d] rows, [B, H, T] m, l, di), its multiply-adds over
    the 495 TFLOP/s TF32 tensor-core rate (the causal half, 2 operations
    each: 4 d per visible (query, key) pair forward, 8 d for dK/dV, 6 d
    for dQ) and its exps (one per visible pair) at the SFU's 16 per clock
    per SM at the SM clock ``sm_hz``.  ``bound_by`` is "bytes" or
    "operations" (products or exps; ``bound_term`` says which).  The same
    operations over the 67 TFLOP/s f32 rate outside the tensor cores stay
    beside them as ``f32_simt_bound_ms``."""
    out = {}
    for name, (nbytes, ops, pairs) in flash_work(b, h, t, d).items():
        terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "tf32": ops / TF32_OPS_PER_S * 1e3,
                 "exp": pairs / (SFU_EXPS_PER_CLOCK * sm_hz) * 1e3}
        term = max(terms, key=terms.get)
        out[name] = dict(bound_ms=terms[term],
                         bound_by="bytes" if term == "bytes"
                         else "operations",
                         bound_term=term,
                         **{f"{k}_ms": v for k, v in terms.items()},
                         f32_simt_bound_ms=ops / FP32_OPS_PER_S * 1e3)
    return out


def ptxas_report(log: str):
    """Registers, spills and static shared memory of each entry function,
    from ``nvcc -Xptxas -v``'s log."""
    out, fn = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            fn = hit.group(1)
            out[fn] = {}
        elif fn is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("smem_static", r"(\d+) bytes smem")):
                hit = re.search(pat, line)
                if hit:
                    out[fn][key] = int(hit.group(1))
    return out


def sass_tensor_core_counts(lib_path: Path):
    """Tensor-core instructions (HMMA, HGMMA) in each kernel's SASS, by
    entry function; None when the toolkit has no ``cuobjdump``."""
    from fedml_tpu_torch.utils import cuda_build
    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()[:500]}")
    return tensor_core_kinds(out.stdout)


def tensor_core_counts(sass: str):
    """HMMA and HGMMA instructions in each function of ``cuobjdump -sass``
    output, by function name."""
    return {fn: sum(kinds.values())
            for fn, kinds in tensor_core_kinds(sass).items()}


def tensor_core_kinds(sass: str):
    """HMMA (``mma.sync``) and HGMMA (``wgmma``) instructions apart, in
    each function of ``cuobjdump -sass`` output, by function name."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            hit = re.search(r"\b(HG?MMA)\b", line)
            if hit:
                counts[fn][hit.group(1)] += 1
    return counts


def flash_smem_bytes(kernel: str, d: int) -> int:
    """The dynamic shared memory (bytes) a launch of ``kernel`` takes at
    head size ``d``: ``kv_smem_bytes`` and ``dkv_smem_bytes`` of
    ``csrc/flash_attention.cu``, two buffers of 64-row f32 tiles padded to
    d + 4 floats (K4f and K4dq: K and V; K4dkv: Q and dO, then m, l and
    di).  The bf16 kernels (``FwdSmem``, ``DkvSmem``, ``DqSmem``) keep
    unpadded, swizzled 64-row bf16 tiles: K4f its 128 Q rows and a ring of
    K4_STAGES K and V tiles, K4dkv its K and V tiles and a ring of Q and
    dO tiles with -m log2 e, 1 / l and di (f32), K4dq its Q and dO tiles
    and a ring of K and V tiles, each with K4_STAGES pairs of 8-byte
    mbarriers and 1024 bytes to align the base."""
    if kernel.endswith("_bf16"):
        tile = 64 * 2 * d
        ring = 2 * K4_STAGES * tile
        if kernel == "flash_bwd_dkv_bf16":
            ring += K4_STAGES * 3 * 64 * 4
        return 2 * tile + ring + 2 * K4_STAGES * 8 + 1024
    tile = 64 * (d + 4) * 4
    per_buffer = {"flash_fwd": 2 * tile,
                  "flash_bwd_dkv": 2 * tile + 3 * 64 * 4,
                  "flash_bwd_dq": 2 * tile}[kernel]
    return 2 * per_buffer


def check_flash_build(lib_path: Path):
    """What the compiler made of K4: each kernel's registers, spills and
    shared memory (static from ptxas, dynamic from the kernels' formula),
    and its tensor-core instructions in SASS.  Fails if an instantiation of
    any of them has none."""
    from fedml_tpu_torch.models import flash_attention as fa
    from fedml_tpu_torch.utils import cuda_build
    ptxas = ptxas_report(cuda_build.build_log("flash_attention"))
    sass = sass_tensor_core_counts(lib_path)
    if sass is None:
        print("cuobjdump not found: tensor-core instructions not counted",
              flush=True)
    report = {}
    for kernel in fa.launch_counts:      # the f32 and the bf16 kernels
        for d in fa.KERNEL_HEAD_DIMS:
            key = f"{kernel}_kernelILi{d}E"
            [fn] = [f for f in ptxas if key in f]
            row = dict(ptxas[fn], smem_dynamic=flash_smem_bytes(kernel, d))
            if sass is not None:
                for kind in ("HMMA", "HGMMA"):
                    row[f"{kind.lower()}_sass"] = sum(
                        n[kind] for f, n in sass.items() if key in f)
                row["tensor_core_sass"] = row["hmma_sass"] + row["hgmma_sass"]
                if not row["tensor_core_sass"]:
                    fail(f"{kernel} (d={d}) has no tensor-core instruction "
                         f"in its SASS")
                if kernel in K4_WGMMA and (row["hmma_sass"]
                                           or not row["hgmma_sass"]):
                    fail(f"{kernel} (d={d}): {row['hgmma_sass']} HGMMA and "
                         f"{row['hmma_sass']} HMMA in its SASS; its products "
                         f"are wgmma's")
            if kernel in K4_WGMMA and d == 32 and (row.get("spill_stores")
                                                   or row.get("spill_loads")):
                fail(f"{kernel} (d=32) spills: {row}")
            report[f"{kernel}/d{d}"] = row
    for name in K4_WGMMA:
        print(f"ptxas/sass {name}: " + json.dumps(
            {d: report[f"{name}/d{d}"] for d in fa.KERNEL_HEAD_DIMS}),
            flush=True)
    phase("kernel flash_attention build", kernels=report,
          sass_checked=sass is not None)
    return report


def check_flash_kernel():
    """Phase: K4f, K4dkv and K4dq against their plain versions on the card
    (TF32 off), at every shape of FLASH_SHAPES; their times, the plain
    versions', scaled_dot_product_attention's (a yardstick the port never
    calls: its forward, and its backward alone as forward + backward less
    forward), the bounds at the SM's maximum clock and the wrappers' host
    cost."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from fedml_tpu_torch.models import flash_attention as fa

    rows, worst = {}, {n: 0.0 for n in fa.launch_counts}
    sm_now_hz, sm_hz = sm_clocks_hz()
    phase("kernel flash_attention clocks", sm_clock_mhz=sm_now_hz / 1e6,
          sm_clock_max_mhz=sm_hz / 1e6)
    with tf32_off():
        for shape_name, (b, t, h, d) in FLASH_SHAPES.items():
            rng = np.random.RandomState(b * 10000 + t)
            q, k, v, do = (torch.tensor(rng.randn(b, h, t, d)
                                        .astype(np.float32)).cuda()
                           for _ in range(4))
            o, m, l = fa.flash_fwd(q, k, v)
            po, pm, pl = fa.flash_fwd_plain(q, k, v)
            di = (po * do).sum(-1)
            bwd = (q, k, v, do, pm, pl, di)
            dk, dv = fa.flash_bwd_dkv(*bwd)
            pdk, pdv = fa.flash_bwd_dkv_plain(*bwd)
            dq = fa.flash_bwd_dq(*bwd)
            pdq = fa.flash_bwd_dq_plain(*bwd)
            torch.cuda.synchronize()
            errs, rel = {}, {}
            for key, kernel, got, want, tol in (
                    ("o", "flash_fwd", o, po, FLASH_O_TOL),
                    ("m", "flash_fwd", m, pm, FLASH_O_TOL),
                    ("l", "flash_fwd", l, pl, FLASH_O_TOL),
                    ("dk", "flash_bwd_dkv", dk, pdk, FLASH_GRAD_TOL),
                    ("dv", "flash_bwd_dkv", dv, pdv, FLASH_GRAD_TOL),
                    ("dq", "flash_bwd_dq", dq, pdq, FLASH_GRAD_TOL)):
                err = float((got - want).abs().max())
                limit = tol * float(want.abs().max())
                errs[key] = err
                rel[key] = err / float(want.abs().max())
                if key not in ("m", "l"):
                    worst[kernel] = max(worst[kernel], err)
                if not err <= limit:
                    fail(f"{kernel} {shape_name} {(b, t, h, d)}: {key} max "
                         f"abs err {err} > {limit} ({tol} x max|ref|)")
            calls = {
                "flash_fwd": (lambda: fa.flash_fwd(q, k, v),
                              lambda: fa.flash_fwd_plain(q, k, v)),
                "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd),
                                  lambda: fa.flash_bwd_dkv_plain(*bwd)),
                "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd),
                                 lambda: fa.flash_bwd_dq_plain(*bwd)),
            }
            bounds = flash_bounds(b, h, t, d, sm_hz)
            row = {"shape_BTHd": [b, t, h, d], "max_abs_err": errs,
                   "err_over_max_ref": rel}
            for name, (kernel, plain) in calls.items():
                row[name] = dict(ms=launch_ms(kernel, 20),
                                 plain_ms=launch_ms(plain, 5),
                                 host_us=host_us(kernel, 20), **bounds[name])
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qg, kg, vg,
                                                     is_causal=True)
                torch.autograd.grad(out, (qg, kg, vg), do)

            row["sdpa_fwd_ms"] = launch_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True), 20)
            row["sdpa_fwd_bwd_ms"] = launch_ms(sdpa_fwd_bwd, 10)
            row["sdpa_bwd_ms"] = row["sdpa_fwd_bwd_ms"] - row["sdpa_fwd_ms"]
            row["k4_fwd_bwd_ms"] = sum(row[n]["ms"] for n in calls)
            row["k4_bwd_ms"] = (row["flash_bwd_dkv"]["ms"]
                                + row["flash_bwd_dq"]["ms"])
            phase("kernel flash_attention", shape=shape_name, **row)
            rows[shape_name] = row
            del q, k, v, do, qg, kg, vg
    return rows, worst


# a NaN in q and one in dO at (b, h, row) of the t384 shape
FLASH_NAN_AT = {"q": (0, 1, 200), "do": (1, 5, 70)}


def flash_nan_inputs(device, dtype=None):
    """q, k, v, dO [B, H, T, d] of the t384 shape, unit normal from a
    seed, with one NaN in the q row and one in the dO row of
    FLASH_NAN_AT; rounded to ``dtype`` when one is given (bf16 keeps the
    NaNs)."""
    import numpy as np
    import torch
    b, t, h, d = FLASH_SHAPES["t384"]
    rng = np.random.RandomState(384)
    q, k, v, do = (torch.tensor(rng.randn(b, h, t, d).astype(np.float32),
                                device=device) for _ in range(4))
    q[(*FLASH_NAN_AT["q"], 3)] = float("nan")
    do[(*FLASH_NAN_AT["do"], 5)] = float("nan")
    if dtype is not None:
        q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    return q, k, v, do


def flash_chain(q, k, v, do, fwd, dkv, dq):
    """The model's chain through three attention functions: the forward,
    di = sum(o dO) in f32, then both backward halves on the forward's m
    and l."""
    o, m, l = fwd(q, k, v)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = dkv(q, k, v, do, m, l, di)
    return {"o": o, "dk": dk, "dv": dv, "dq": dq(q, k, v, do, m, l, di)}


def flash_nan_rows(shape):
    """[B, H, T] masks of the output rows that depend on FLASH_NAN_AT's
    NaNs through visible (query, key) pairs and so must be NaN: q's row r
    reaches o and dq at r and dk, dv at keys <= r; dO's row r reaches dq
    at r and dk, dv at keys <= r."""
    import torch
    b, h, t = shape
    must = {n: torch.zeros(b, h, t, dtype=torch.bool)
            for n in ("o", "dk", "dv", "dq")}
    for src, (bi, hi, r) in FLASH_NAN_AT.items():
        if src == "q":
            must["o"][bi, hi, r] = True
        must["dq"][bi, hi, r] = True
        must["dk"][bi, hi, :r + 1] = True
        must["dv"][bi, hi, :r + 1] = True
    return must


def flash_nan_tols(dtype=None):
    """The chip limits (x max|ref|) on o and on the gradients of the
    kernels of ``dtype``: 1e-5 and 1e-4 in f32, BF16_KERNEL_TOL on every
    bf16 output."""
    if dtype is None:
        return FLASH_O_TOL, FLASH_GRAD_TOL
    return BF16_KERNEL_TOL, BF16_KERNEL_TOL


def flash_nan_problems(got, want, tols=(FLASH_O_TOL, FLASH_GRAD_TOL)):
    """What is wrong with the outputs ``got`` of a chain through
    FLASH_NAN_AT's inputs against the plain chain's ``want``: a row that
    must be NaN and is not, or, on the rows where ``want`` is finite, an
    error over the chip limits ``tols`` (on o and on the gradients; the
    f32 kernels' by default).  The plain versions' dense products spread a
    NaN further (0 x NaN past the diagonal), so rows outside the dependent
    ones may be NaN on either side only where ``want`` has them."""
    problems = []
    must = flash_nan_rows(want["o"].shape[:3])
    for name, ref in want.items():
        out = got[name]
        nan_rows = out.isnan().any(-1).cpu()
        missing = int((must[name] & ~nan_rows).sum())
        if missing:
            problems.append(f"{name}: {missing} rows that depend on a NaN "
                            f"input are not NaN")
        finite = ~ref.isnan().any(-1)
        tol = tols[0] if name == "o" else tols[1]
        err = float((out[finite].float() - ref[finite].float()).abs().max())
        limit = tol * float(ref[finite].float().abs().max())
        if not err <= limit:
            problems.append(f"{name}: max abs err {err} > {limit} on the "
                            f"rows the plain version keeps finite")
    return problems


def flash_nan_plains(dtype=None):
    """The plain versions of the kernels of ``dtype`` (None: f32), in
    flash_chain's order."""
    from fedml_tpu_torch.models import flash_attention as fa
    if dtype is None:
        return fa.flash_fwd_plain, fa.flash_bwd_dkv_plain, \
            fa.flash_bwd_dq_plain
    return fa.flash_fwd_bf16_plain, fa.flash_bwd_dkv_bf16_plain, \
        fa.flash_bwd_dq_bf16_plain


def check_flash_nan():
    """Phase: a NaN in q and in dO comes out of K4f, K4dkv and K4dq, f32
    and bf16, as NaN wherever it reaches through a visible pair (the plain
    versions' behaviour), and the other rows keep to the chip limits."""
    import torch
    from fedml_tpu_torch.models import flash_attention as fa
    failed = {}
    for dtype in (None, torch.bfloat16):
        with bf16_exact_reductions():
            inputs = flash_nan_inputs("cuda", dtype)
            got = flash_chain(*inputs, fa.flash_fwd, fa.flash_bwd_dkv,
                              fa.flash_bwd_dq)
            want = flash_chain(*inputs, *flash_nan_plains(dtype))
            torch.cuda.synchronize()
        problems = flash_nan_problems(got, want, flash_nan_tols(dtype))
        label = "" if dtype is None else " bf16"
        phase(f"kernel flash_attention nan{label}", nan_at=FLASH_NAN_AT,
              nan_rows={n: int(x.isnan().any(-1).sum())
                        for n, x in got.items()},
              plain_nan_rows={n: int(x.isnan().any(-1).sum())
                              for n, x in want.items()},
              problems=problems)
        if problems:
            failed[label.strip() or "f32"] = problems
    if failed:
        fail(f"flash attention with NaN inputs: {failed}")


def lm_data():
    from fedml_tpu_torch.data.synthetic import synthetic_federated_dataset
    return synthetic_federated_dataset(**LM_DATA)


def lm_fedavg(data, use_flash: bool, comm_round: int = LM_ROUNDS):
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.trainer.workload import NWPWorkload
    return FedAvg(NWPWorkload(TransformerLM(**LM, use_flash=use_flash)),
                  data, FedAvgConfig(comm_round=comm_round,
                                     frequency_of_the_test=comm_round,
                                     **LM_FEDAVG), device="cuda")


K4_NAMES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
K4_BF16_NAMES = tuple(f"{n}_bf16" for n in K4_NAMES)
# each wrapper's CUDA kernel, as a captured graph's nodes name it
K4_KERNELS = {n: f"{n}_kernel" for n in K4_NAMES}


def graph_kernel_counts(dot: str, names) -> dict:
    """Kernel nodes of a CUDA graph's Graphviz dump
    (``cudaGraphDebugDotPrint``) whose label names each of ``names``: the
    text split at each node's definition, each node counted once."""
    nodes = re.split(r'\n\s*"?graph_\d+_node_\d+"?\s*\[', dot)[1:]
    return {n: sum(1 for node in nodes if n in node) for n in names}


def run_lm_slice(data, root: Path, algo=None, names=K4_NAMES,
                 label: str = "transformer slice"):
    """The transformer slice's main path: FedAvg through the API on the
    flash model, LM_ROUNDS rounds with an evaluation at the first and the
    last.  The rounds run as replays of one captured CUDA graph, so the
    kernels launched in training are those of the warm-up round (through
    the wrappers) and the captured ones once per replay: the capture must
    hold n_layers x S launches of each K4 kernel of ``names`` (the f32
    kernels, or the bf16 ones under bf16), by the wrappers' counts during
    the capture and by the graph's own kernel nodes, and the graph must
    replay once a round; evaluation launches only K4f (counted apart).
    ``algo`` (default the f32 flash model's) may be a model without K4
    (``names=()``: the MoE runs); then only the graph is checked.
    Returns (launches, launches a round, a row: rounds/s, steady ms a
    round, peak GB; the final global)."""
    import torch
    from fedml_tpu_torch.models import flash_attention as fa
    from fedml_tpu_torch.parallel import cohort

    algo = algo or lm_fedavg(data, use_flash=True)
    reset_peak()
    evaluate, eval_counts = algo.evaluate_global, dict.fromkeys(names, 0)

    def counted_eval(params):
        before = dict(fa.launch_counts)
        out = evaluate(params)
        for k in names:
            eval_counts[k] += fa.launch_counts[k] - before[k]
        return out

    algo.evaluate_global = counted_eval
    dot_dir = root / "build" / "graphs"
    shutil.rmtree(dot_dir, ignore_errors=True)
    cohort.GRAPH_DOT_DIR = str(dot_dir)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        params = algo.run()
        torch.cuda.synchronize()
    finally:
        cohort.GRAPH_DOT_DIR = None
    run_s = time.perf_counter() - t0
    total = {k: fa.launch_counts[k] for k in names}
    graph = getattr(algo._device_round, "graph", None)
    if graph is None:
        fail(f"the {label} did not run the graphed device round")
    steps = int(data.train["mask"].shape[1]) * LM_FEDAVG["epochs"]
    per_round = LM["n_layers"] * steps
    captured = {k: graph.captured_launches.get(k, 0) for k in total}
    warmup = {k: graph.warmup_launches.get(k, 0) for k in total}
    wrapper_train = {k: total[k] - eval_counts[k] for k in total}
    nodes = graph_kernel_counts(Path(graph.dot_path).read_text(),
                                [f"{k}_kernel" for k in names])
    nodes = {k: nodes[f"{k}_kernel"] for k in names}
    if graph.captures != 1 or graph.replays != LM_ROUNDS:
        fail(f"the {label} captured {graph.captures} graphs and "
             f"replayed {graph.replays} times; need 1 and {LM_ROUNDS}")
    if any(captured[k] != per_round or nodes[k] != per_round
           or warmup[k] != per_round * graph.warmup_rounds
           or wrapper_train[k] != warmup[k] + captured[k] for k in total):
        fail(f"the {label}'s graph holds {nodes} K4 kernel nodes "
             f"and its capture launched {captured} (warm-up {warmup}, "
             f"wrapper calls in training {wrapper_train}); each K4 kernel "
             f"must appear n_layers x S = {per_round} times a round")
    if names and (eval_counts[names[1]] or eval_counts[names[2]]
                  or not eval_counts[names[0]]):
        fail(f"evaluation launched {eval_counts}; it runs K4f only")
    # launches on the main path: the eager ones (warm-up, evaluation) and
    # the captured ones once per replay
    train = {k: warmup[k] + captured[k] * graph.replays for k in total}
    launches = {k: train[k] + eval_counts[k] for k in total}
    last = algo.history[-1]
    finite = all(bool(v.isfinite().all()) for v in params.values())
    if not finite or not all(
            float(last[k]) == float(last[k]) for k in ("train_loss",
                                                       "test_loss")):
        fail(f"the {label} produced non-finite values: {last}")
    if not all(v.dtype == torch.float32 for v in params.values()):
        fail(f"the {label}'s global is not f32 (master parameters)")
    steady = algo.round_times[1:]
    row = dict(rounds_per_s=len(steady) / sum(steady),
               steady_round_ms=sum(steady) / len(steady) * 1e3,
               peak_mem_gb=peak_gb())
    phase(label, graph_kernel_nodes=nodes,
          captured_launches=captured, warmup_launches=warmup,
          replays=graph.replays, train_launches=train,
          eval_launches=eval_counts, launches_per_round=per_round,
          steps_per_round=steps, capture_ms=graph.capture_s * 1e3,
          run_s=run_s, train_loss=last["train_loss"],
          test_loss=last["test_loss"], test_acc=last["test_acc"],
          params_finite=finite, **row)
    return launches, per_round, row, params


def profile_lm(data, rounds: int = 5):
    """Where a transformer round's time goes: host timers (synchronised)
    around the cohort gather, the local SGD and the weighted mean; then
    torch.profiler over ``rounds`` whole rounds for the device's busy
    share, the launches per round and K4's share of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.core.pytree import tree_weighted_mean
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.parallel.cohort import train_cohort

    algo = lm_fedavg(data, use_flash=True)
    m = LM_FEDAVG["client_num_per_round"]
    params = algo.init_params()
    parts = {"gather_ms": [], "train_ms": [], "aggregate_ms": []}
    for r in range(rounds + 1):                  # round 0 is warm-up
        t0 = time.perf_counter()
        cohort = gather_cohort(data.train,
                               sample_clients(r, data.client_num, m),
                               pad_to=m, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stacked, _ = train_cohort(algo._local_train, params, cohort,
                                  client_axis="vmap")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params = tree_weighted_mean(stacked, cohort["num_samples"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if r:
            parts["gather_ms"].append((t1 - t0) * 1e3)
            parts["train_ms"].append((t2 - t1) * 1e3)
            parts["aggregate_ms"].append((t3 - t2) * 1e3)
    row = {k: statistics.median(v) for k, v in parts.items()}
    row["round_ms"] = sum(row.values())

    def run_rounds():
        p = params
        for r in range(rounds):
            cohort = gather_cohort(data.train,
                                   sample_clients(r, data.client_num, m),
                                   pad_to=m, device="cuda")
            p, _ = algo.cohort_step(p, cohort)
        torch.cuda.synchronize()

    run_rounds()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_rounds()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in events)
    k4_us = sum(_self_device_us(e) for e in events if "flash_" in e.key)
    row["profiled_round_ms"] = wall_us / rounds / 1e3
    row["device_busy_ms_per_round"] = busy_us / rounds / 1e3
    row["k4_device_ms_per_round"] = k4_us / rounds / 1e3
    row["device_idle_share"] = (1 - busy_us / wall_us) if busy_us else None
    row["kernel_launches_per_round"] = sum(e.count for e in events) / rounds
    top = sorted(events, key=_self_device_us, reverse=True)[:6]
    row["top_device_us_per_round"] = {
        e.key[:60]: _self_device_us(e) / rounds for e in top}
    phase("profile transformer", **row)
    return row


def lm_round_parity(data):
    """One round with TF32 off through K4 against the same round with
    ``use_flash=False`` (at T=2048 the JAX package's non-flash path:
    auto-blockwise attention, block 512), from one init and one cohort."""
    import torch
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort

    m = LM_FEDAVG["client_num_per_round"]
    cohort = gather_cohort(data.train, sample_clients(0, data.client_num, m),
                           pad_to=m, device="cuda")
    out = {}
    with tf32_off():
        for use_flash in (True, False):
            algo = lm_fedavg(data, use_flash, comm_round=1)
            init = algo.init_params()
            params, _ = algo.cohort_step(init, cohort)
            out[use_flash] = {k: v.cpu() for k, v in params.items()}
    init = {k: v.cpu() for k, v in init.items()}
    diff = max(float((out[True][k] - out[False][k]).abs().max())
               for k in init)
    moved = max(float((out[False][k] - init[k]).abs().max()) for k in init)
    phase("transformer round flash vs blockwise", max_abs_diff=diff,
          tol=ROUND_TOL, tf32=False, moved_from_init=moved)
    if not moved > 10 * ROUND_TOL:
        fail(f"the transformer round left the global where it was "
             f"(moved {moved})")
    if not diff <= ROUND_TOL:
        fail(f"the flash round differs from the blockwise round by {diff} "
             f"> {ROUND_TOL}")
    return diff


def lm_bench_step():
    """bench.py's long-context grad step (B=2, T=2048, LM_BENCH_STEPS
    steps): the gradient of the mean next-token cross-entropy, flash on
    and off (off is bench.py's blockwise attention, block 256)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.func import grad
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.trainer.workload import NWPWorkload, apply_model

    b, t = 2, LM["max_len"]
    toks = torch.tensor(np.random.RandomState(0).randint(
        0, LM["vocab_size"], (b, t)))
    toks = toks.cuda()
    y = torch.cat([toks[:, 1:], toks[:, :1]], dim=1).reshape(-1)
    out = {}
    for use_flash in (True, False):
        model = TransformerLM(**LM, use_flash=use_flash,
                              block_size=None if use_flash
                              else LM_BENCH_BLOCK)
        params = NWPWorkload(model).init(torch.Generator().manual_seed(0),
                                         "cuda")

        def loss_fn(p):
            logits = apply_model(model, p, toks).float()
            return F.cross_entropy(logits.reshape(b * t, -1), y)

        step = grad(loss_fn)
        step(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_BENCH_STEPS):
            g = step(params)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / LM_BENCH_STEPS
        if not all(bool(v.isfinite().all()) for v in g.values()):
            fail(f"the long-context grad step (flash={use_flash}) is not "
                 f"finite")
        out["flash" if use_flash else "blockwise"] = dict(
            step_ms=step_s * 1e3, steps_per_s=1 / step_s,
            tokens_per_s=b * t / step_s)
    phase("transformer long-context grad step", **out)
    return out


def run_lm_cli():
    """The dense CLI path: 3 rounds of the Shakespeare transformer through
    the CLI's runner."""
    import torch
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (load_experiment_data,
                                                  run_fedavg)
    from fedml_tpu_torch.utils.metrics import MetricsSink

    cfg = config_from_argv(CLI_LM_ARGS)
    t0 = time.perf_counter()
    data = load_experiment_data(cfg)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with MetricsSink(None) as sink:
        summary = run_fedavg(cfg, data, sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    loss = float(summary["train_loss"])
    if not summary.get("params_finite") or not loss == loss:
        fail(f"the transformer CLI run is not finite: {summary}")
    phase("transformer cli", data_s=data_s, run_s=run_s,
          rounds_per_s=summary["rounds_per_s"], train_loss=loss,
          test_loss=summary["test_loss"], test_acc=summary["test_acc"],
          params_finite=True)
    return summary


# ---------------------------------------------------------------------------
# live SecAgg over the wire, the server-optimizer seam and the stateful
# cohort algorithms (the CNN's widths)
# ---------------------------------------------------------------------------

# the device the phases below run on (a rehearsal on the CPU sets "cpu")
CARD = "cuda"
PLAIN_STREAM_ARGS = ["--algo", "cross_silo", "--silo_backend", "local",
                     "--agg_mode", "stream", *COMMON_ARGS]
SECAGG_ARGS = [*PLAIN_STREAM_ARGS, "--secagg", "pairwise",
               "--secagg_threshold", "0"]
# the straggler policy that lets a round close over a lost upload; the
# timeout is sent by hand once the pumped barrier stalls, so its length
# only has to outlast the run
SECAGG_DROP = ["--straggler_policy", "drop", "--round_timeout_s", "600"]
SECAGG_DEAD = 4                # the silo that dies after its advert ...
SECAGG_DEAD_ROUND = 1          # ... in round 2 of 3, and is back for round 3
SECAGG_TOL = 1e-3              # a secure global vs the plaintext stream's
#                                (tests/test_secagg_live.py's limit)
SECAGG_OVER = (1, 2, 3, 4, 5)  # silos lost in the over-threshold run: 5
#                                survivors of 10 under t = 6
SECAGG_MASK_REPS = 5
SRVOPT_ARGS = {
    "adam": [*SILO_ARGS, "--server_opt", "adam", "--server_lr", "0.01"],
    "momentum": [*PLAIN_STREAM_ARGS, "--server_opt", "momentum",
                 "--server_lr", "1.0", "--server_momentum", "0.9"],
    "fedac": [*PLAIN_STREAM_ARGS, "--server_opt", "fedac",
              "--server_lr", "1.0", "--fedac_gamma", "0.5",
              "--fedac_alpha", "2.0", "--fedac_beta", "3.0"]}
SRVOPT_ROUNDS = 3
SRVOPT_STEP_TOL = 1e-6         # adam's step on the same inputs, card vs CPU
SRVOPT_KILL = ("post_fold_pre_ack", 2)
# the eight --algo runners, 3 rounds each; SCAFFOLD, FedDyn and Ditto keep
# a host copy of the model per client (3400 x 6.76 MB = 23 GB each), so
# they run at ZOO_SMALL_CLIENTS
ZOO_ARGS = {
    # sgd with momentum: adam's first step, lr·Δ/(|Δ| + eps), moves an
    # element whose Δ is within the card's and the CPU's difference of 0
    # by up to lr, so no round-level limit holds it (phase 8j holds adam's
    # step on the same inputs instead)
    "fedopt": ["--server_optimizer", "sgd", "--server_lr", "1.0",
               "--server_momentum", "0.9"],
    "fedprox": ["--mu", "0.1"],
    "fednova": ["--gmf", "0.5"],
    "scaffold": [],
    "feddyn": ["--feddyn_alpha", "0.01"],
    "ditto": ["--ditto_lambda", "0.1"],
    "fedac": ["--fedac_mu", "0.5"],
    "dp_fedavg": ["--dp_clip", "1.0", "--dp_noise_multiplier", "1.0"]}
ZOO_SMALL = ("scaffold", "feddyn", "ditto")
ZOO_SMALL_CLIENTS = 200
ZOO_PROFILE_ROUNDS = 3


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def live_cfg(argv, rounds: int, device: str = None):
    """A valid CLI config of the live federation on ``device`` (the
    card's by default)."""
    import dataclasses
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    cfg = config_from_argv([*argv, "--comm_round", str(rounds)])
    check_config(cfg)
    return dataclasses.replace(cfg, platform=device or CARD)


class LoseUploads:
    """A silo's sends with its uploads of ``rounds`` lost: the silo dies
    after its advert (its shares of the round are already with the
    server) and is back for the next round."""

    def __init__(self, inner, rounds):
        self._inner = inner
        self._rounds = set(rounds)

    def send_message(self, msg):
        from fedml_tpu_torch.algorithms.cross_silo import MsgType
        from fedml_tpu_torch.comm.message import Message
        if msg.type == MsgType.C2S_MODEL \
                and msg.get(Message.ARG_ROUND) in self._rounds:
            return
        self._inner.send_message(msg)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def live_fed(cfg, data, init=None, lose=None, **kw):
    """The runner's pumped federation for ``cfg`` (no evaluation),
    recording each closed round's wall time and global; ``lose``: {silo:
    rounds} whose uploads are lost."""
    from fedml_tpu_torch.experiments.main import CrossSiloFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink
    with MetricsSink(None) as sink:
        fed = CrossSiloFederation(cfg, data, sink, init_params=init, **kw)
    for silo in fed.silos:
        if lose and silo.node_id in lose:
            silo.transport = LoseUploads(silo.transport, lose[silo.node_id])
    fed.closed = []
    mark = {"t": None}

    def on_round_done(r, params):
        sync(cfg.platform)
        now = time.perf_counter()
        fed.closed.append((r, now - (mark["t"] or fed.t_start),
                           {k: v.clone() for k, v in params.items()}))
        mark["t"] = now

    fed.server.on_round_done = on_round_done
    fed.t_start = None
    return fed


def live_drive(fed, max_timeouts: int = 8) -> None:
    """Pump the federation to its end; whenever the barrier stalls on a
    lost upload, deliver the straggler timeout by hand."""
    from fedml_tpu_torch.algorithms.cross_silo import MsgType
    from fedml_tpu_torch.comm.message import Message
    server = fed.server
    sync(fed.cfg.platform)
    fed.t_start = time.perf_counter()
    try:
        server.start()
        fed.hub.pump()
        sent = 0
        while not server._finished and server.round_idx < fed.cfg.comm_round:
            if sent == max_timeouts:
                fail(f"the federation stalled at round {server.round_idx}")
            server.send(MsgType.ROUND_TIMEOUT, 0,
                        **{Message.ARG_ROUND: server.round_idx})
            sent += 1
            fed.hub.pump()
    finally:
        server.finish()
        if fed.checkpointer is not None:
            fed.checkpointer.close()


def ring_sum_recorder(fed):
    """Hold every unmask to the ring sum of the survivors' unmasked
    quantized uploads: each silo's `SecAggClient.quantize` words are kept
    per round, and the server's unmasked ring sum is compared word for
    word.  Returns the list of (round, survivors, equal)."""
    import torch
    from fedml_tpu_torch.core.murmur import M32
    words, checks = {}, []
    for silo in fed.silos:
        client = silo.secagg
        real_mask = client.mask

        def mask(round_idx, update, num_samples, _c=client, _m=real_mask):
            words[(round_idx, _c.node_id)] = _c.quantize(round_idx, update,
                                                         num_samples)
            return _m(round_idx, update, num_samples)
        client.mask = mask
    secagg = fed.server.secagg
    real_unmask = secagg.unmasked_ring_sum

    def unmasked_ring_sum():
        r = secagg._round
        folded = sorted(r.folded)
        got = real_unmask()
        want = sum(words[(r.round_idx, s)] for s in folded) & M32
        checks.append((r.round_idx, folded,
                       bool(torch.equal(got, want.to(got.device)))))
        for s in list(words):
            if s[0] <= r.round_idx:
                del words[s]
        return got
    secagg.unmasked_ring_sum = unmasked_ring_sum
    return checks


def secagg_split(fed):
    """Exclusive host time of each part of a secure round (synchronised),
    by round: the silos' advert and masking, the server's agreement
    handling, the ring fold, the unmask with its reconstructions, the
    finalize, the silos' training and the wire."""
    timer = PartTimer()
    server = fed.server
    for silo in fed.silos:
        timer.wrap(silo, "_train", "silo_train_ms")
        timer.wrap(silo.secagg, "begin_round", "advert_ms")
        timer.wrap(silo.secagg, "mask", "masking_ms")
        timer.wrap(silo.secagg, "reveal", "reveal_ms")
    timer.wrap(server.secagg, "note_advert", "agreement_ms")
    timer.wrap(server.secagg, "flush_roster", "agreement_ms")
    timer.wrap(server.secagg, "fold", "ring_fold_ms")
    timer.wrap(server.secagg, "unmasked_ring_sum", "unmask_ms")
    timer.wrap(server.secagg, "finalize", "finalize_ms")
    timer.wrap(server, "_broadcast", "broadcast_ms")
    timer.wrap(fed.hub, "route", "wire_ms")
    return timer


def mask_times(fed, update, num_samples: float):
    """One silo's masking of ``update`` on the card and the same code on
    CPU tensors (the same round state), bit-equal, each the median of
    SECAGG_MASK_REPS calls."""
    from fedml_tpu_torch.secure.protocol import SecAggClient, _canon_leaves
    card = fed.silos[0].secagg
    round_idx = card._round.round_idx
    cpu = SecAggClient(card.node_id, device="cpu")
    cpu._round = card._round
    out = {}
    for name, client, upd in (
            ("card", card, update),
            ("cpu", cpu, _cpu_tree(update))):
        times = []
        for _ in range(SECAGG_MASK_REPS):
            frame = client.mask(round_idx, upd, num_samples)
            times.append(client.mask_s * 1e3)
        out[name] = (statistics.median(times),
                     [l.tobytes() for l in _canon_leaves(frame)])
    if out["card"][1] != out["cpu"][1]:
        fail("the masked frame made on the card differs from the CPU's")
    return {"card_ms": out["card"][0], "cpu_ms": out["cpu"][0],
            "streams": len(card._round.roster),
            "words": sum(len(b) for b in out["card"][1]) // 4}


def _cpu_tree(tree):
    if hasattr(tree, "items"):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    return tree.cpu() if hasattr(tree, "cpu") else tree


def check_live_secagg(data, root: Path):
    """Phase 12: live SecAgg over the hub, 10 silos, threshold 6, 3 rounds
    on the CNN; silo 4 dies after its round-2 advert and the round
    recovers through the pair-secret shares.  Holds each unmasked ring sum
    to the survivors' quantized uploads (bit for bit), each global to the
    plaintext stream run's with the same loss (1e-3), a mid_unmask kill to
    the boundary (global unchanged) with a re-run equal to the clean run,
    and a run with 5 of 10 uploads lost to a loud failure.  Prints the
    split of a round, rounds/s and one silo's masking on the card beside
    the CPU."""
    import torch
    from fedml_tpu_torch.experiments.main import check_config
    from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                                  Faultline)
    from fedml_tpu_torch.secure.protocol import SecAggError
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
    from fedml_tpu_torch.utils.journal import RoundJournal
    base = root / "build" / "secagg"
    shutil.rmtree(base, ignore_errors=True)
    lose = {SECAGG_DEAD: [SECAGG_DEAD_ROUND]}
    out = {}
    with deterministic():
        cfg = live_cfg(SECAGG_ARGS + SECAGG_DROP, 3)
        fed = live_fed(cfg, data, lose=lose)
        init = {k: v.clone() for k, v in fed.server.params.items()}
        timer = secagg_split(fed)
        checks = ring_sum_recorder(fed)
        for silo in fed.silos:    # the check's own quantize pass, apart
            timer.wrap(silo.secagg, "quantize", "ring_sum_check_ms")
        last = {}
        real_mask = fed.silos[0].secagg.mask

        def mask_first(round_idx, update, num_samples):
            last.update(update=update, n=num_samples)
            return real_mask(round_idx, update, num_samples)
        fed.silos[0].secagg.mask = mask_first
        marks = []
        real_done = fed.server.on_round_done

        def on_round_done(r, params):
            real_done(r, params)
            marks.append(dict(timer.totals))
        fed.server.on_round_done = on_round_done
        live_drive(fed)
        if fed.server.round_idx != 3 or len(fed.closed) != 3:
            fail(f"the secure federation closed {len(fed.closed)} rounds")
        if not all(ok for _, _, ok in checks) or len(checks) != 3:
            fail(f"an unmasked ring sum differs from the ring sum of the "
                 f"survivors' quantized uploads: {checks}")
        survivors = {r: s for r, s, _ in checks}
        if SECAGG_DEAD in survivors[SECAGG_DEAD_ROUND] \
                or len(survivors[SECAGG_DEAD_ROUND]) != 9:
            fail(f"round {SECAGG_DEAD_ROUND} folded {survivors}")
        dropped = fed.server.dropped_silos.get(SECAGG_DEAD_ROUND, [])
        plain = live_fed(live_cfg(PLAIN_STREAM_ARGS + SECAGG_DROP, 3), data,
                         init=init, lose=lose)
        live_drive(plain)
        diffs = [max_diff(a[2], b[2]) for a, b in zip(fed.closed,
                                                      plain.closed)]
        if len(diffs) != 3 or not max(diffs) <= SECAGG_TOL:
            fail(f"a secure global differs from the plaintext stream's by "
                 f"{diffs} (limit {SECAGG_TOL})")
        finite = all(bool(v.isfinite().all())
                     for v in fed.server.params.values())
        if not finite:
            fail("the secure federation's global is not finite")
        masking = mask_times(fed, last["update"], last["n"])

        # abort-only: a kill mid-unmask in round 2 leaves the boundary
        # checkpoint holding round 1's global, and the re-run from it
        # lands on the clean run's global
        clean = live_fed(live_cfg(SECAGG_ARGS, 3), data, init=init)
        live_drive(clean)
        durable = ["--checkpoint_dir", str(base / "ck"),
                   "--checkpoint_every", "1",
                   "--journal_dir", str(base / "j")]
        kcfg = live_cfg(SECAGG_ARGS + durable, 3)
        fl = Faultline(crashes=[CrashSpec(point="mid_unmask",
                                          round_idx=SECAGG_DEAD_ROUND)])
        killed = live_fed(kcfg, data, init=init, faultline=fl)
        try:
            live_drive(killed)
            fail("the mid_unmask kill never fired")
        except ActorKilled:
            pass
        state = RoundCheckpointer(str(base / "ck")).restore()
        boundary = {k: torch.as_tensor(v) for k, v in state["params"].items()}
        unchanged = (int(state["round_idx"]) == SECAGG_DEAD_ROUND - 1
                     and bit_equal(boundary, clean.closed[0][2])
                     and bit_equal(killed.server.params,
                                   clean.closed[0][2]))
        rec = RoundJournal(str(base / "j")).recover()
        if not unchanged or rec is None or rec.mode != "secagg" \
                or rec.resumable:
            fail(f"the mid_unmask kill: boundary unchanged {unchanged}, "
                 f"journal {rec and (rec.mode, rec.resumable)}")
        resumed = live_fed(kcfg, data, init=init)
        live_drive(resumed)
        rerun_equal = bit_equal(resumed.server.params, clean.server.params)
        if not rerun_equal:
            fail("the secure re-run after the mid_unmask kill differs from "
                 "the clean run")

        # more dropouts than the threshold allows: the unmask fails loudly
        # and the global stays where it was
        ocfg = live_cfg(SECAGG_ARGS + SECAGG_DROP, 1)
        over = live_fed(ocfg, data, init=init,
                        lose={s: [0] for s in SECAGG_OVER})
        errors = []
        real_fin = over.server.secagg.finalize

        def finalize(*a, **kw):
            try:
                return real_fin(*a, **kw)
            except SecAggError as e:
                errors.append(str(e))
                raise
        over.server.secagg.finalize = finalize
        live_drive(over)
        kept = bit_equal(over.server.params, init)
        if not errors or "threshold" not in errors[0] or not kept:
            fail(f"{len(SECAGG_OVER)} lost uploads of 10 at t = 6: errors "
                 f"{errors}, global kept {kept}")
    rows = []
    prev = {}
    for m in marks:
        rows.append({k: (v - prev.get(k, 0.0)) * 1e3 for k, v in m.items()})
        prev = m
    steady = rows[1:]
    split = {k: statistics.median(r.get(k, 0.0) for r in steady)
             for k in steady[0]}
    times = [dt for _, dt, _ in fed.closed]
    split["round_ms"] = statistics.median(times[1:]) * 1e3
    out = dict(
        rounds=3, silos=cfg.client_num_per_round,
        threshold=fed.server.secagg._threshold_for(cfg.client_num_per_round),
        dead_silo=SECAGG_DEAD, dead_round=SECAGG_DEAD_ROUND,
        dropped=dropped, ring_sums_bit_equal=[ok for _, _, ok in checks],
        vs_plaintext_max_abs_diff=diffs, tol=SECAGG_TOL,
        rounds_per_s=len(times[1:]) / sum(times[1:]),
        plaintext_rounds_per_s=rounds_per_s(plain),
        split_ms_per_round=split, per_round_split_ms=rows,
        masking=masking, mid_unmask_boundary_unchanged=unchanged,
        mid_unmask_rerun_bit_equal=rerun_equal,
        over_threshold_error=errors[0], over_threshold_global_kept=kept,
        params_finite=finite)
    phase("live secagg", **out)
    shutil.rmtree(base, ignore_errors=True)
    return out


def srvopt_fed(name, data, rounds=SRVOPT_ROUNDS, extra=(), init=None,
               device=None, **kw):
    return live_fed(live_cfg([*SRVOPT_ARGS[name], *extra], rounds, device),
                    data, init=init, **kw)


def srvopt_round_parity(name, data):
    """One round of ``name`` with TF32 off on the card against the CPU,
    from one init.  Adam's first step is ``lr·Δ/(|Δ| + eps)``, so an
    element whose Δ is within the two devices' difference of 0 moves by up
    to lr; its round is held at the finalized mean (1e-4) and its step on
    the same inputs, card against CPU (1e-6)."""
    from fedml_tpu_torch.server_opt import ServerOptimizer
    runs = {}
    for label, device in (("cpu", "cpu"), ("card", CARD)):
        init = runs.get("cpu", {}).get("init")
        fed = srvopt_fed(name, data, rounds=1, device=device, init=init)
        seen = {}
        real = fed.server.server_opt.apply

        def apply(params, finalized, round_idx=0, _real=real, _seen=seen):
            _seen.update(before={k: v.clone() for k, v in params.items()},
                         finalized={k: v.clone()
                                    for k, v in finalized.items()})
            return _real(params, finalized, round_idx)
        fed.server.server_opt.apply = apply
        runs[label] = dict(init={k: v.cpu().clone() for k, v in
                                 fed.server.params.items()})
        with tf32_off():
            live_drive(fed)
        runs[label].update(seen, after=fed.server.params)
    cpu, card = runs["cpu"], runs["card"]
    out = {"finalize_max_abs_diff": max_diff(card["finalized"],
                                             cpu["finalized"]),
           "round_max_abs_diff": max_diff(card["after"], cpu["after"])}
    if name == "adam":
        opt = ServerOptimizer("adam", cpu["before"],
                              **{k: v for k, v in srvopt_kw(name).items()})
        stepped = opt.apply({k: v.cpu() for k, v in card["before"].items()},
                            {k: v.cpu() for k, v in
                             card["finalized"].items()})
        out["step_max_abs_diff"] = max_diff(card["after"], stepped)
        ok = (out["finalize_max_abs_diff"] <= ROUND_TOL
              and out["step_max_abs_diff"] <= SRVOPT_STEP_TOL)
    else:
        ok = out["round_max_abs_diff"] <= ROUND_TOL
    if not ok:
        fail(f"--server_opt {name}: one round on the card against the CPU "
             f"{out}")
    return out


def srvopt_kw(name):
    cfg = live_cfg(SRVOPT_ARGS[name], 1, "cpu")
    return dict(lr=cfg.server_lr, momentum=cfg.server_momentum,
                beta1=cfg.server_adam_beta1, beta2=cfg.server_adam_beta2,
                eps=cfg.server_adam_eps)


def check_live_server_opt(data, root: Path):
    """Phase 13: the live server-optimizer seam on the CNN, 3 rounds each:
    adam on the sharded spine (S=4, K2 on; exactly 4 x 3 K2 launches,
    counted from 0 just before), momentum and fedac on the replicated
    stream; one round of each with TF32 off against the CPU; a journaled
    kill in round 2 resumed bit-equal with the optimizer's state restored;
    a resume under another --server_opt refused."""
    import torch
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                                  Faultline)
    from fedml_tpu_torch.server_opt import ServerOptMismatchError
    base = root / "build" / "srvopt"
    shutil.rmtree(base, ignore_errors=True)
    runs = {}
    k2 = None
    for name in SRVOPT_ARGS:
        fed = srvopt_fed(name, data)
        if name == "adam":
            fused_agg.reset_launch_counts()
        live_drive(fed)
        if name == "adam":
            sync(CARD)
            k2 = fused_agg.launch_counts["shard_finalize"]
            need = fed.cfg.model_shards * SRVOPT_ROUNDS
            if k2 != need:
                fail(f"--server_opt adam on the sharded spine launched K2 "
                     f"{k2} times, need exactly {need}")
        finite = all(bool(v.isfinite().all())
                     for v in fed.server.params.values())
        if len(fed.closed) != SRVOPT_ROUNDS or not finite \
                or fed.server.server_opt.step_count != SRVOPT_ROUNDS:
            fail(f"--server_opt {name}: {len(fed.closed)} rounds, "
                 f"{fed.server.server_opt.step_count} steps, finite {finite}")
        runs[name] = dict(rounds_per_s=rounds_per_s(fed),
                          round_ms=steady_round_ms(fed),
                          journal_mode=fed.server._journal_mode())
    for name in SRVOPT_ARGS:
        runs[name].update(srvopt_round_parity(name, data))

    def durable(tag):
        return ["--checkpoint_dir", str(base / tag / "ck"),
                "--checkpoint_every", "1",
                "--journal_dir", str(base / tag / "j"),
                "--journal_snapshot_every", "1"]
    with deterministic():
        ref = srvopt_fed("adam", data, extra=durable("ref"))
        init = {k: v.clone() for k, v in ref.server.params.items()}
        live_drive(ref)
        point, hit = SRVOPT_KILL
        fl = Faultline(crashes=[CrashSpec(point=point, hit=hit,
                                          round_idx=CRASH_ROUND)])
        killed = srvopt_fed("adam", data, extra=durable("kill"), init=init,
                            faultline=fl)
        try:
            live_drive(killed)
            fail(f"the {point} kill never fired")
        except ActorKilled:
            pass
        resumed = srvopt_fed("adam", data, extra=durable("kill"), init=init)
        live_drive(resumed)
        same = bit_equal(resumed.server.params, ref.server.params)
        a = resumed.server.server_opt.state_dict()
        b = ref.server.server_opt.state_dict()
        state_same = all(
            bit_equal({"x": torch.as_tensor(x)}, {"x": torch.as_tensor(y)})
            for x, y in zip(_state_leaves(a), _state_leaves(b)))
        if not (same and state_same):
            fail(f"the adam run resumed after a {point} kill: params "
                 f"bit-equal {same}, optimizer state bit-equal {state_same}")
        refused = None
        other = srvopt_fed("momentum", data, extra=durable("kill"),
                           init=init)
        try:
            live_drive(other)
        except ServerOptMismatchError as e:
            refused = str(e)
        if not refused:
            fail("a resume under another --server_opt was not refused")
    out = dict(rounds=SRVOPT_ROUNDS, k2_launches=k2, runs=runs,
               kill=dict(point=point, hit=hit, round=CRASH_ROUND,
                         params_bit_equal=same, state_bit_equal=state_same),
               other_optimizer_refused=refused[:120])
    phase("live server_opt", **out)
    shutil.rmtree(base, ignore_errors=True)
    return out


def _state_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _state_leaves(tree[k])]
    return [tree]


def zoo_cfg(name: str, device: str = None, rounds: int = 3):
    import dataclasses
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    extra = list(ZOO_ARGS[name])
    if name in ZOO_SMALL:
        extra += ["--client_num_in_total", str(ZOO_SMALL_CLIENTS)]
    cfg = config_from_argv(["--algo", name, *COMMON_ARGS, *extra,
                            "--comm_round", str(rounds)])
    check_config(cfg)
    return dataclasses.replace(cfg, platform=device or CARD)


def zoo_path(algo) -> str:
    graph = getattr(algo._device_round, "graph", None)
    if algo._uses_device_data():
        return "graphed device round" if graph is not None \
            else "device round"
    return "host loop"


def zoo_parity(cfg, data):
    """One round of the algorithm with TF32 off on the card against the
    CPU from one init, evaluation off; DP-FedAvg's ε on both."""
    import dataclasses
    from fedml_tpu_torch.experiments.main import build_algo
    devices = {"cpu": "cpu", "card": CARD}
    algos = {label: build_algo(dataclasses.replace(cfg, platform=d,
                                                   comm_round=1), data)
             for label, d in devices.items()}
    init = algos["cpu"].init_params()
    out = {}
    with tf32_off():
        for label, algo in algos.items():
            algo.evaluate_global = lambda params: {}
            params = algo.run(params={k: v.to(devices[label])
                                      for k, v in init.items()})
            out[label] = {k: v.cpu() for k, v in params.items()}
    diff = max_diff(out["card"], out["cpu"])
    moved = max_diff(out["cpu"], init)
    eps = {d: getattr(a, "accountant", None) and a.accountant.epsilon()
           for d, a in algos.items()}
    if not diff <= ROUND_TOL or not moved > 10 * ROUND_TOL \
            or eps["card"] != eps["cpu"]:
        fail(f"--algo {cfg.algo}: one round on the card against the CPU "
             f"differs by {diff} (moved {moved}), eps {eps}")
    return diff, eps["card"]


def check_algorithm_zoo(data):
    """Phase 14: each of the eight --algo runners for 3 rounds on the CNN
    (SCAFFOLD, FedDyn and Ditto at 200 clients): the path it took, the
    host launch calls and device kernels a round, the round and the idle
    share (torch.profiler over 3 more rounds); one round with TF32 off
    against the CPU (1e-4; DP-FedAvg's ε equal)."""
    import dataclasses
    import gc
    import torch
    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    from fedml_tpu_torch.experiments.main import (build_algo,
                                                  load_experiment_data)
    from fedml_tpu_torch.utils.metrics import MetricsSink
    small = None
    rows = {}
    for name in ZOO_ARGS:
        cfg = zoo_cfg(name)
        if name in ZOO_SMALL:
            if small is None:
                small = load_experiment_data(cfg)
            zdata = small
        else:
            zdata = data
        t0 = time.perf_counter()
        with MetricsSink(None) as sink:
            algo = build_algo(cfg, zdata, sink)
            params = algo.run()
        sync(CARD)
        run_s = time.perf_counter() - t0
        finite = all(bool(v.isfinite().all()) for v in params.values())
        if not finite or len(algo.round_times) != cfg.comm_round:
            fail(f"--algo {name}: {len(algo.round_times)} rounds, finite "
                 f"{finite}")
        steady = algo.round_times[1:]
        row = dict(clients=zdata.client_num, path=zoo_path(algo),
                   run_s=run_s, rounds_per_s=len(steady) / sum(steady),
                   test_acc=algo.history[-1].get("test_acc"))
        if name == "dp_fedavg":
            row["dp_epsilon"] = algo.accountant.epsilon()
        graph = getattr(algo._device_round, "graph", None)
        if graph is not None:
            row.update(captures=graph.captures, replays=graph.replays)
        use = algo._uses_device_data()
        state = {"params": params, "r": cfg.comm_round}

        def run(_algo=algo, _state=state, _use=use, _seed=cfg.seed):
            p = _state["params"]
            for _ in range(ZOO_PROFILE_ROUNDS):
                p = _algo.run_round(p, _state["r"],
                                    round_seed_words(_seed, _state["r"]),
                                    _use)
                _state["r"] += 1
            _state["params"] = p
        row.update(path_profile(run, ZOO_PROFILE_ROUNDS))
        row["vs_cpu_max_abs_diff"], eps = zoo_parity(
            dataclasses.replace(cfg), zdata)
        if eps is not None:
            row["dp_epsilon_cpu_equal"] = True
        rows[name] = row
        phase(f"algorithm {name}", **row)
        # the algorithm's resident split, graph and state leave the card
        del algo, params, state, run
        gc.collect()
        torch.cuda.empty_cache()
    return rows



# ---------------------------------------------------------------------------
# the cross-device wave engine: the sampled cohort trained in waves on the
# card and folded into the streaming mean, its four local algorithms, both
# samplers, CNNDropOut, and the GroupNorm ResNets of BASELINE config 4
# ---------------------------------------------------------------------------

CD_ARGS = ["--algo", "cross_device", "--model", "cnn_fedavg", "--dataset",
           "femnist", "--client_num_in_total", "3400",
           "--client_num_per_round", "1000", "--wave_size", "256",
           "--batch_size", "20", "--lr", "0.1", "--epochs", "1",
           "--comm_round", "2", "--frequency_of_the_test", "1000",
           "--log_stdout", "false"]
# (cut to 2 rounds from 3 to fit phase 8p: the steady round is round 2)
# 4 waves a round, the last 232 live and 24 pads; SCAFFOLD keeps a host
# model per client (3400 x 6.76 MB = 23 GB), so it runs at 200 clients
CD_RUNS = {
    "sgd": [],
    "fedprox": ["--local_alg", "fedprox", "--mu", "0.1"],
    "fednova": ["--local_alg", "fednova"],
    "sgd_adam": ["--server_opt", "adam", "--server_lr", "0.01"],
    "scaffold": ["--local_alg", "scaffold", "--client_num_in_total", "200",
                 "--client_num_per_round", "100", "--wave_size", "32"]}
# the CPU reference rounds' cohort: 16 clients in 2 waves (cut from 40 in
# waves of 16 to fit phase 8p; the CPU rounds were most of the phase)
CD_PARITY = ["--client_num_per_round", "16", "--wave_size", "8"]
# the runs profiled (a profiled round costs ~7 s of host time): plain SGD,
# SCAFFOLD (its host state) and config 4's fedprox; fedprox, fednova and
# adam run sgd's path with another local step or server step (cut to fit
# phase 8p)
CD_PROFILED = ("sgd", "scaffold", "config4 fedprox")
CD_SMALL = ["--client_num_per_round", "100", "--wave_size", "32"]
CD_SMALL_SINGLE = 100          # CD_SMALL's cohort as one wave
CD_SINGLE_WAVE = 1000          # the chunking check's one wave
# one round of W=256 waves against one W=1000 wave, deterministic cuDNN and
# TF32 off: the grouped convs' algorithms differ with the group count, so
# the card's bits may differ; within this limit (the CPU round limit)
WAVE_CHUNK_TOL = ROUND_TOL
CONFIG4_ARGS = ["--algo", "cross_device", "--model", "resnet18_gn",
                "--dataset", "fed_cifar100", "--client_num_in_total", "500",
                "--client_num_per_round", "10", "--batch_size", "20",
                "--lr", "0.1", "--epochs", "1", "--comm_round", "2",
                "--frequency_of_the_test", "1000", "--log_stdout", "false"]
CONFIG4_RUNS = {"fedprox": ["--local_alg", "fedprox", "--mu", "0.1"],
                "fednova": ["--local_alg", "fednova"]}
CONFIG4_PARITY = "fedprox"     # the config-4 run held against the CPU ...
CONFIG4_PARITY_COHORT = ["--client_num_per_round", "4"]   # ... on 4 clients
GN_ROUND_TOL = ROUND_TOL       # ResNet-18-GN round, card (TF32 off) vs CPU
RESNET56_ARGS = ["--algo", "cross_device", "--model", "resnet56",
                 "--dataset", "cifar10", "--client_num_in_total", "10",
                 "--client_num_per_round", "10", "--batch_size", "20",
                 "--lr", "0.1", "--epochs", "1", "--comm_round", "1",
                 "--frequency_of_the_test", "1000", "--log_stdout", "false"]


def cd_cfg(argv, device: str = None, **replace):
    """A valid CLI config of the wave engine on ``device`` (the card's by
    default)."""
    import dataclasses
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (check_config,
                                                  resolve_cross_device)
    cfg = resolve_cross_device(config_from_argv(list(argv)))
    check_config(cfg)
    return dataclasses.replace(cfg, platform=device or CARD, **replace)


def cd_data(cfg, cache: dict):
    """The twin ``cfg`` names, loaded once per (dataset, clients)."""
    from fedml_tpu_torch.experiments.main import load_experiment_data
    key = (cfg.dataset, cfg.client_num_in_total, cfg.batch_size, cfg.seed)
    if key not in cache:
        cache[key] = load_experiment_data(cfg)
    return cache[key]


def cd_algo(cfg, data):
    from fedml_tpu_torch.experiments.main import cross_device_algo
    return cross_device_algo(cfg, data)


def peak_gb():
    import torch
    if CARD != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 1e9


def reset_peak() -> None:
    import torch
    if CARD == "cuda":
        torch.cuda.reset_peak_memory_stats()


def cd_round(algo, params, round_idx: int):
    """One round of the engine outside its run loop (the run's key
    chain)."""
    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    ids = algo._sample_round(round_idx)
    return algo._run_round(params, ids,
                           round_seed_words(algo.cfg.seed, round_idx),
                           round_idx)[0]


def wave_split(algo, params, round_idx: int):
    """Where one round's waves spend their time: exclusive synchronised
    host time of the gather, the wave's training (with its summary), the
    admission screen and the fold (and SCAFFOLD's state gather and
    scatter), per wave in ms, and the finalize."""
    from fedml_tpu_torch.algorithms import cross_device
    timer = PartTimer()
    timer.wrap(algo, "_gather_wave", "gather")
    timer.wrap(algo, "_wave_fn", "training")
    timer.wrap(algo.admission, "screen", "admission")
    timer.wrap(algo.stream, "fold_wave", "fold")
    timer.wrap(algo.stream, "finalize", "finalize")
    # SCAFFOLD's host-stacked variates, gathered and scattered per wave
    saved = {name: getattr(cross_device, name)
             for name in ("gather_client_rows", "scatter_client_rows")}
    timer.wrap(cross_device, "gather_client_rows", "state_gather")
    timer.wrap(cross_device, "scatter_client_rows", "state_scatter")
    t0 = time.perf_counter()
    try:
        params = cd_round(algo, params, round_idx)
        sync(CARD)
    finally:
        for name, fn in saved.items():
            setattr(cross_device, name, fn)
    round_ms = (time.perf_counter() - t0) * 1e3
    waves = -(-algo.cfg.client_num_per_round // algo.cfg.wave_size)
    out = {f"{k}_ms_per_wave": v * 1e3 / waves
           for k, v in timer.totals.items() if k != "finalize"}
    out.update(finalize_ms=timer.totals.get("finalize", 0.0) * 1e3,
               split_round_ms=round_ms, waves=waves)
    return params, out


def cd_run(name: str, cfg, data, profiled: bool = True):
    """``cfg`` through the runner's engine: its rounds, rounds/s after the
    first, peak memory; then one round's split by part and, when
    ``profiled``, one profiled round (host launch calls, device kernels,
    idle share)."""
    import gc
    import torch
    reset_peak()
    t0 = time.perf_counter()
    algo = cd_algo(cfg, data)
    params = algo.run()
    sync(CARD)
    run_s = time.perf_counter() - t0
    finite = all(bool(v.isfinite().all()) for v in params.values())
    last = algo.history[-1] if algo.history else {}
    width = algo.cfg.wave_size            # 0 resolves to min(cohort, 256)
    waves = -(-cfg.client_num_per_round // width)
    if not finite or len(algo.round_times) != cfg.comm_round \
            or last.get("waves") != waves \
            or last.get("folded_waves") != waves:
        fail(f"cross_device {name}: {len(algo.round_times)} rounds, finite "
             f"{finite}, last row {last}")
    steady = algo.round_times[1:]
    row = dict(clients=data.client_num, cohort=cfg.client_num_per_round,
               wave_size=width, waves=waves, run_s=run_s,
               rounds_per_s=len(steady) / sum(steady),
               round_ms=1e3 * sum(steady) / len(steady),
               test_acc=last.get("test_acc"), peak_gb=peak_gb())
    state = {"params": params, "r": cfg.comm_round}
    state["params"], split = wave_split(algo, state["params"], state["r"])
    state["r"] += 1
    row.update(split)

    def run(_algo=algo, _state=state):
        _state["params"] = cd_round(_algo, _state["params"], _state["r"])
        _state["r"] += 1
    if profiled:
        row.update(path_profile(run, 1))
    del algo, params, state, run
    gc.collect()
    if CARD == "cuda":
        torch.cuda.empty_cache()
    return row


def cd_parity(name: str, argv, data, tol: float = ROUND_TOL):
    """One round of the engine with TF32 off on the card against the
    same round on CPU tensors, from one init, evaluation off: the global,
    and the stream's finalized mean before the local algorithm's server
    step (FedNova's tau_eff step, SCAFFOLD's variates, the optimizer)."""
    from fedml_tpu_torch.core.stream_agg import StreamingAggregator
    devices = {"cpu": "cpu", "card": CARD}
    algos = {label: cd_algo(cd_cfg(argv, d, comm_round=1), data)
             for label, d in devices.items()}
    init = algos["cpu"].init_params()
    out, means = {}, {}
    real = StreamingAggregator.finalize
    try:
        with tf32_off():
            for label, algo in algos.items():
                def spy(agg, step, _label=label):
                    mean = real(agg, step)
                    means[_label] = {k: v.cpu() for k, v in mean.items()}
                    return mean
                StreamingAggregator.finalize = spy
                algo.evaluate_global = lambda params: {}
                params = algo.run(params={k: v.to(devices[label])
                                          for k, v in init.items()})
                out[label] = {k: v.cpu() for k, v in params.items()}
    finally:
        StreamingAggregator.finalize = real
    row = dict(max_abs_diff=max_diff(out["card"], out["cpu"]),
               finalize_max_abs_diff=max_diff(means["card"], means["cpu"]),
               moved=max_diff(out["cpu"], init),
               max_abs_param=max(float(v.abs().max())
                                 for v in out["cpu"].values()))
    row["ok"] = row["max_abs_diff"] <= tol and row["moved"] > 10 * tol
    if algos["cpu"].cfg.local_alg == "fednova":
        # x+ = x − tau_eff·(x − mean) scales the devices' difference in the
        # mean by tau_eff (the clients' average local steps): FedNova is
        # held at its finalized mean, and its step may add nothing beyond
        # that scaling
        row["tau_eff"] = fednova_tau(init, means["cpu"], out["cpu"])
        row["ok"] = (row["finalize_max_abs_diff"] <= tol
                     and row["max_abs_diff"] <= row["tau_eff"]
                     * row["finalize_max_abs_diff"] * (1 + 1e-3) + 1e-7
                     and row["moved"] > 10 * tol)
    return row


def fednova_tau(init, mean, new) -> float:
    """FedNova's tau_eff, read back from one round: ``(x − x+) / (x −
    mean)`` at the element where ``x − mean`` is largest."""
    k = max(mean, key=lambda n: float((init[n] - mean[n]).abs().max()))
    d = (init[k].double() - mean[k].double()).flatten()
    j = int(d.abs().argmax())
    return float((init[k].double().flatten()[j]
                  - new[k].double().flatten()[j]) / d[j])


def cd_one_round(argv, data, init, **replace):
    """One round of the engine from ``init``, evaluation off; the algo
    and its global."""
    algo = cd_algo(cd_cfg(argv, comm_round=1, **replace), data)
    algo.evaluate_global = lambda params: {}
    params = algo.run(params={k: v.clone() for k, v in init.items()})
    sync(CARD)
    return algo, params


def check_wave_chunking(data):
    """One round of ``--wave_size 256`` against one ``--wave_size 1000``
    wave from one init: deterministic mode (TF32 off) within
    WAVE_CHUNK_TOL, bit-equal if it is; the default mode's difference
    recorded."""
    init = cd_algo(cd_cfg(CD_ARGS), data).init_params()
    out = {}
    for mode, ctx in (("deterministic", deterministic),
                      ("default", contextlib.nullcontext)):
        with ctx():
            _, chunked = cd_one_round(CD_ARGS, data, init)
            _, single = cd_one_round(CD_ARGS, data, init,
                                     wave_size=CD_SINGLE_WAVE)
        out[mode] = dict(bit_equal=bit_equal(chunked, single),
                         max_abs_diff=max_diff(chunked, single))
    if not out["deterministic"]["max_abs_diff"] <= WAVE_CHUNK_TOL:
        fail(f"cross_device: wave-chunked against single-wave "
             f"{out['deterministic']} (limit {WAVE_CHUNK_TOL})")
    return out


def check_jax_sampler(data):
    """``--sampler jax``: the waves of round 0 train exactly the first
    1000 of ``prng.permutation(fold_in(fold_in(key(seed), 0x5A4D50), 0),
    3400)``, in order."""
    import numpy as np
    from fedml_tpu_torch.core import prng
    from fedml_tpu_torch.core.sampling import sample_clients
    cfg = cd_cfg([*CD_ARGS, "--sampler", "jax"], comm_round=1)
    algo = cd_algo(cfg, data)
    algo.evaluate_global = lambda params: {}
    seen = []
    inner = algo._gather_wave

    def record(wave, width):
        seen.append(np.asarray(wave.ids))
        return inner(wave, width)
    algo._gather_wave = record
    params = algo.run()
    sync(CARD)
    key = prng.fold_in(prng.fold_in(prng.key(cfg.seed), 0x5A4D50), 0)
    want = prng.permutation(key, data.client_num)[:cfg.client_num_per_round]
    got = np.concatenate(seen)
    equal = bool(np.array_equal(got, want))
    numpy_ids = sample_clients(0, data.client_num, cfg.client_num_per_round)
    if not equal or len(seen) != -(-cfg.client_num_per_round
                                   // cfg.wave_size) \
            or not all(bool(v.isfinite().all()) for v in params.values()):
        fail(f"--sampler jax: the waves trained {got[:8]}..., the "
             f"permutation gives {want[:8]}...")
    return dict(ids_equal_permutation=equal, waves=len(seen),
                differs_from_numpy=not np.array_equal(np.sort(got),
                                                      np.sort(numpy_ids)))


def check_dropout_chunking(data):
    """``--model cnn`` (CNNDropOut) in train mode: one round of W=32
    waves against one W=100 wave (deterministic mode), and against the
    same round under another seed (other masks, same cohort and init)."""
    argv = [*CD_ARGS, *CD_SMALL, "--model", "cnn"]
    algo = cd_algo(cd_cfg(argv), data)
    if not algo.workload.stochastic:
        fail("--model cnn is not stochastic")
    init = algo.init_params()
    with deterministic():
        _, chunked = cd_one_round(argv, data, init)
        _, single = cd_one_round(argv, data, init,
                                 wave_size=CD_SMALL_SINGLE)
        _, reseeded = cd_one_round(argv, data, init, seed=1)
    out = dict(bit_equal=bit_equal(chunked, single),
               max_abs_diff=max_diff(chunked, single),
               other_seed_max_abs_diff=max_diff(chunked, reseeded))
    # other masks move the global far more than the chunking does
    if not out["max_abs_diff"] <= WAVE_CHUNK_TOL \
            or not out["other_seed_max_abs_diff"] > max(
                10 * out["max_abs_diff"], 1e-5):
        fail(f"--model cnn: chunked against single-wave {out}")
    return out


def check_cd_resume(data, root: Path):
    """A 2-round run against a run stopped after round 1 with its
    checkpoint and resumed: the round-2 global bit-equal (deterministic
    mode)."""
    from fedml_tpu_torch.experiments.main import make_checkpointer
    ckpt = root / "build" / "cross_device_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = [*CD_ARGS, *CD_SMALL]
    finals = {}
    with deterministic():
        for name, rounds, ck in (("straight", 2, None), ("stopped", 1, ckpt),
                                 ("resumed", 2, ckpt)):
            cfg = cd_cfg(argv, comm_round=rounds,
                         checkpoint_dir=None if ck is None else str(ck),
                         checkpoint_every=1)
            algo = cd_algo(cfg, data)
            checkpointer = make_checkpointer(cfg)
            try:
                finals[name] = algo.run(checkpointer=checkpointer)
            finally:
                if checkpointer is not None:
                    checkpointer.close()
            sync(CARD)
            finals[name + "_rounds"] = len(algo.round_times)
    same = bit_equal(finals["resumed"], finals["straight"])
    if not same or finals["resumed_rounds"] != 1:
        fail(f"cross_device resume: bit-equal {same}, "
             f"{finals['resumed_rounds']} rounds run after the resume")
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(bit_equal=same,
                max_abs_diff=max_diff(finals["resumed"], finals["straight"]))


def check_cross_device(data, root: Path):
    """Phase 8l: the wave engine at BASELINE config 2's widths and config
    4's model.  Every run, every check and the phase's seconds."""
    t_phase = time.perf_counter()
    main_cfg = cd_cfg(CD_ARGS)
    cache = {(main_cfg.dataset, main_cfg.client_num_in_total,
              main_cfg.batch_size, main_cfg.seed): data}
    runs = {}
    for name, extra in CD_RUNS.items():
        cfg = cd_cfg([*CD_ARGS, *extra])
        runs[name] = cd_run(name, cfg, cd_data(cfg, cache),
                            profiled=name in CD_PROFILED)
        phase(f"cross_device {name}", **runs[name])
    parity = {}
    for name in ("sgd", "fedprox", "fednova", "scaffold"):
        # CD_PARITY's cohort and wave size override the run's
        argv = [*CD_ARGS, *CD_RUNS[name], *CD_PARITY]
        parity[name] = cd_parity(name, argv, cd_data(cd_cfg(argv), cache))
    phase("cross_device vs cpu", limit=ROUND_TOL, cohort=CD_PARITY,
          **parity)
    bad = {k: v for k, v in parity.items() if not v["ok"]}
    if bad:
        fail(f"cross_device: one round on the card against the CPU: {bad} "
             f"(limit {ROUND_TOL})")
    chunking = check_wave_chunking(data)
    phase("cross_device wave chunking", limit=WAVE_CHUNK_TOL, **chunking)
    sampler = check_jax_sampler(data)
    phase("cross_device sampler jax", **sampler)
    drop = check_dropout_chunking(data)
    phase("cross_device cnn dropout", limit=WAVE_CHUNK_TOL, **drop)
    resume = check_cd_resume(data, root)
    phase("cross_device resume", **resume)
    config4 = {}
    for name, extra in CONFIG4_RUNS.items():
        cfg = cd_cfg([*CONFIG4_ARGS, *extra])
        config4[name] = cd_run(name, cfg, cd_data(cfg, cache),
                               profiled=f"config4 {name}" in CD_PROFILED)
        phase(f"cross_device config4 {name}", **config4[name])
    argv = [*CONFIG4_ARGS, *CONFIG4_RUNS[CONFIG4_PARITY],
            *CONFIG4_PARITY_COHORT]
    gn = cd_parity(f"config4 {CONFIG4_PARITY}", argv,
                   cd_data(cd_cfg(argv), cache), GN_ROUND_TOL)
    phase("cross_device config4 vs cpu", local_alg=CONFIG4_PARITY,
          limit=GN_ROUND_TOL, **gn)
    if not gn["ok"]:
        fail(f"cross_device config4: one round on the card against the "
             f"CPU: {gn} (limit {GN_ROUND_TOL})")
    gn_diff = gn["max_abs_diff"]
    r56_cfg = cd_cfg(RESNET56_ARGS)
    r56 = cd_algo(r56_cfg, cd_data(r56_cfg, cache))
    t0 = time.perf_counter()
    r56_params = r56.run()
    sync(CARD)
    r56_row = dict(round_s=time.perf_counter() - t0,
                   params=sum(v.numel() for v in r56_params.values()),
                   finite=all(bool(v.isfinite().all())
                              for v in r56_params.values()),
                   test_acc=r56.history[-1].get("test_acc"))
    if not r56_row["finite"]:
        fail(f"resnet56 on the cifar10 twin: {r56_row}")
    phase("cross_device resnet56", **r56_row)
    seconds = time.perf_counter() - t_phase
    phase("cross_device done", seconds=seconds)
    return dict(runs=runs, parity=parity, chunking=chunking,
                sampler=sampler, dropout=drop, resume=resume,
                config4=config4, config4_vs_cpu=gn_diff, resnet56=r56_row,
                seconds=seconds)


# ---------------------------------------------------------------------------
# the model zoo of BASELINE configs 3 and 5 (phase 8m): the LSTMs through
# FedAvg, config 3's live cross-silo runs on ResNet-56 and MobileNet, the
# BatchNorm (stateful) workloads through FedAvg and the defended mean, the
# centralized runner and the full-batch oracle
# ---------------------------------------------------------------------------

_NWP_COMMON = ["--algo", "fedavg", "--model", "rnn", "--epochs", "1",
               "--comm_round", "3", "--frequency_of_the_test", "1000",
               "--log_stdout", "false"]
ZOO_NWP_ARGS = {
    # BASELINE.md config 5: Shakespeare next-char, RNNOriginalFedAvg
    "config5a": [*_NWP_COMMON, "--dataset", "shakespeare",
                 "--client_num_in_total", "715", "--client_num_per_round",
                 "10", "--batch_size", "4", "--lr", "1"],
    # ... and StackOverflow next-word, RNNStackOverflow, lr 10^-0.5
    "config5b": [*_NWP_COMMON, "--dataset", "stackoverflow_nwp",
                 "--client_num_in_total", "342477",
                 "--client_num_per_round", "50", "--batch_size", "16",
                 "--lr", "0.31623"]}
ZOO_ROUNDS = 2                 # rounds of each FedAvg path (cut from 3 to
#                                fit phase 8p: the steady round is round 2)
# the CPU reference round of each FedAvg configuration: round 0's first
# ZOO_PARITY_CLIENTS clients as one cohort step on the card and on the CPU
# (cut from the whole cohort: the CPU rounds took 10-32 s each)
ZOO_PARITY_CLIENTS = 2
CONFIG3_ARGS = ["--algo", "cross_silo", "--silo_backend", "local",
                "--agg_mode", "stream", "--model_shards", "4",
                "--fused_finalize", "on", "--dataset", "cifar10",
                "--client_num_in_total", "10", "--client_num_per_round",
                "10", "--batch_size", "64", "--lr", "0.001", "--wd", "0.001",
                "--epochs", "1", "--comm_round", "2",
                "--frequency_of_the_test", "1000", "--log_stdout", "false"]
# cut: E=1 of the published E=20.  Each silo trains eagerly, one step an
# epoch on the twin; at E=20 a ResNet-56 round took 25.1 s on an H100
# (877,248 launches), and the whole script took 1076 s of its 1200 s
# limit with these runs and their profiled round at E=2
CONFIG3_MODELS = ("resnet56", "mobilenet")
# the CPU reference round runs 1 epoch: at E=2 a ResNet-56 round took
# ~75 s on the host cores of an H100 machine
CONFIG3_PARITY_EPOCHS = 1
# ... and 2 of the 10 silos (cut from 10 to fit phase 8p)
CONFIG3_PARITY_SILOS = 2
BN_ARGS = ["--algo", "fedavg", "--model", "resnet56", "--dataset",
           "cifar10", "--client_num_in_total", "10",
           "--client_num_per_round", "10", "--batch_size", "64", "--lr",
           "0.1", "--epochs", "1", "--comm_round", "3",
           "--frequency_of_the_test", "1000", "--log_stdout", "false"]
BN_ROBUST_MODEL = "resnet56_bn"    # the model of the defended run
# the defended run: 2 rounds (cut from 3 for the time limit)
BN_ROBUST_ARGS = [*BN_ARGS, "--algo", "fedavg_robust", "--defense",
                  "weak_dp", "--defense_backend", "cuda", "--norm_bound",
                  str(CLIP_BOUND), "--stddev", str(SIGMA), "--comm_round",
                  "2"]
CENTRAL_ARGS = ["--algo", "centralized", "--model", "cnn_fedavg",
                "--dataset", "femnist", "--client_num_in_total", "100",
                "--batch_size", "20", "--lr", "0.1", "--epochs", "1",
                "--comm_round", "2", "--frequency_of_the_test", "1",
                "--log_stdout", "false"]
# the oracle on LR over the mnist twin, as tests/test_fedavg_oracle.py
# holds it: the FEMNIST CNN without grad clipping is chaotic at lr 0.1 (a
# 1e-6 change of its init moved its 3-step trajectory by 3.7e-4 on the
# CPU), so f32 summation order alone took it past these limits (6.6e-5
# on an H100)
ORACLE_CLIENTS, ORACLE_ROUNDS, ORACLE_LR = 10, 3, 0.5
# tests/test_fedavg_oracle.py's limits: params, and train accuracy
ORACLE_RTOL, ORACLE_ATOL, ORACLE_ACC_TOL = 2e-4, 2e-5, 1e-3


def bn_models():
    """The BatchNorm models run through the API (no CLI flag builds
    one)."""
    from fedml_tpu_torch.models import mobilenet, resnet56
    return {"resnet56_bn": lambda: resnet56(10, norm="batch"),
            "mobilenet_bn": lambda: mobilenet(10, norm="batch")}


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def timed_host_rounds(algo, data, params, rounds: int):
    """``rounds`` host-gather rounds on the algorithm's device, each
    timed (device drained); the params after the first and the last."""
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    m = algo.cfg.client_num_per_round
    times, first = [], None
    for r in range(rounds):
        t0 = time.perf_counter()
        cohort = gather_cohort(data.train,
                               sample_clients(r, data.client_num, m),
                               pad_to=m, device=algo.device)
        params, _ = algo.cohort_step(params, cohort)
        sync(algo.device)
        times.append(time.perf_counter() - t0)
        if first is None:
            first = _clone(params)
    return first, params, times


def timed_graph_rounds(algo, data, params, rounds: int):
    """``rounds`` rounds of the device round (on the card one capture,
    then one replay a round), each timed (device drained)."""
    ids, live = round_plan(data, algo.cfg.client_num_per_round, rounds)
    times = []
    for r in range(rounds):
        t0 = time.perf_counter()
        params, _ = algo._device_round(params, algo._train_dev, ids[r],
                                       live[r])
        sync(algo.device)
        times.append(time.perf_counter() - t0)
    return _clone(params), times


def steady(times):
    """Rounds/s and ms a round over the rounds after the first."""
    rest = times[1:] or times
    return dict(rounds_per_s=len(rest) / sum(rest),
                round_ms=1e3 * sum(rest) / len(rest))


def cohort_parity(card_algo, cpu_algo, data, init, clients: int):
    """Round 0's first ``clients`` sampled clients as one cohort step
    from ``init`` on the card's algorithm and on the CPU's: (the card's
    new global on the host, the CPU's, the CPU step's seconds)."""
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    ids = sample_clients(0, data.client_num,
                         card_algo.cfg.client_num_per_round)[:clients]
    out, cpu_s = [], 0.0
    for algo in (card_algo, cpu_algo):
        cohort = gather_cohort(data.train, ids, pad_to=clients,
                               device=algo.device)
        t0 = time.perf_counter()
        params, _ = algo.cohort_step(
            {k: v.to(algo.device) for k, v in init.items()}, cohort)
        sync(algo.device)
        cpu_s = time.perf_counter() - t0
        out.append({k: v.cpu() for k, v in params.items()})
    return out[0], out[1], cpu_s


def zoo_fedavg(name: str, cfg, data, workload_fn=None):
    """One FedAvg configuration on the card in deterministic mode (cuDNN
    deterministic, TF32 off): ZOO_ROUNDS rounds of the host-gather loop
    and of the graphed device round from one init, bit-equal; a cohort
    step of round 0's first ZOO_PARITY_CLIENTS clients held against the
    port on the CPU (ROUND_TOL); rounds/s and
    round ms of each path, one profiled round of the graph (the main
    path; a host-loop round of the LSTM, ~94,000 launches, costs the
    profiler tens of seconds); the peak memory; a stateful workload's
    running statistics moved."""
    import dataclasses
    import gc
    import torch
    t_run = time.perf_counter()
    wl_fn = workload_fn or (lambda: None)
    row = dict(clients=data.client_num, cohort=cfg.client_num_per_round,
               batch_size=cfg.batch_size, lr=cfg.lr, mode="deterministic")
    with deterministic():
        reset_peak()
        host = fedavg_algo(cfg, data, cfg.platform, wl_fn())
        init = host.init_params()
        row["params"] = sum(v.numel() for v in init.values())
        first, want, host_times = timed_host_rounds(host, data, init,
                                                    ZOO_ROUNDS)
        graphed = fedavg_algo(cfg, data, cfg.platform, wl_fn())
        if not graphed._stage_train_on_device():
            fail(f"zoo {name}: the train split did not take the device path")
        row["resident_train_gb"] = sum(
            v.numel() * v.element_size()
            for v in graphed._train_dev.values()) / 1e9
        got, graph_times = timed_graph_rounds(graphed, data, init,
                                              ZOO_ROUNDS)
        graph = graphed._device_round.graph
        if CARD == "cuda" and (graph is None or graph.captures != 1
                               or graph.replays != ZOO_ROUNDS):
            fail(f"zoo {name}: the device round captured "
                 f"{getattr(graph, 'captures', 0)} graphs and replayed "
                 f"{getattr(graph, 'replays', 0)} times; need 1 and "
                 f"{ZOO_ROUNDS}")
        row.update(graph_vs_host_bit_equal=bit_equal(got, want),
                   graph_vs_host_max_abs_diff=max_diff(got, want),
                   moved_from_init=max_diff(want, init),
                   capture_ms=graph.capture_s * 1e3 if graph else None,
                   peak_gb=peak_gb())
        if not row["graph_vs_host_bit_equal"]:
            fail(f"zoo {name}: the graphed rounds differ from the host loop "
                 f"by {row['graph_vs_host_max_abs_diff']} in deterministic "
                 f"mode")
        if not row["moved_from_init"] > 10 * ROUND_TOL:
            fail(f"zoo {name}: the rounds left the global where it was")
        stats = [k for k in init if k.startswith("batch_stats/")]
        if stats:
            row["stats_moved"] = max(float((want[k] - init[k]).abs().max())
                                     for k in stats)
            if not row["stats_moved"] > 1e-3:
                fail(f"zoo {name}: the running statistics did not move "
                     f"({row['stats_moved']})")
        row["host_loop"] = steady(host_times)
        row["graph"] = steady(graph_times)
        state = {"graph": got}

        def run_graph():
            state["graph"], _ = timed_graph_rounds(graphed, data,
                                                   state["graph"], 1)

        row["graph"].update(profile_once(run_graph, 1))
        cpu = fedavg_algo(dataclasses.replace(cfg, platform="cpu"), data,
                          "cpu", wl_fn())
        card_part, cpu_part, cpu_s = cohort_parity(host, cpu, data, init,
                                                   ZOO_PARITY_CLIENTS)
        row.update(vs_cpu_max_abs_diff=max_diff(card_part, cpu_part),
                   vs_cpu_tol=ROUND_TOL, vs_cpu_clients=ZOO_PARITY_CLIENTS,
                   cpu_round_s=cpu_s)
    del host, graphed, graph, cpu, state, got, want, first, card_part, \
        cpu_part
    gc.collect()
    if CARD == "cuda":
        torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_run
    phase(f"zoo {name}", **row)
    if not row["vs_cpu_max_abs_diff"] <= ROUND_TOL:
        fail(f"zoo {name}: the card's round differs from the CPU's by "
             f"{row['vs_cpu_max_abs_diff']} > {ROUND_TOL}")
    return row


def zoo_silo(model: str, cache: dict):
    """Config 3's live cross-silo federation (stream fold, S=4 shards, K2
    on) on ``model`` through the CLI's runner: exactly one K2 launch per
    shard a round and no K1 or K3; rounds/s; one round of
    CONFIG3_PARITY_SILOS silos against the CPU at CONFIG3_PARITY_EPOCHS
    epochs.  (Its profiled round went to fit phase 8p: profiling the
    ~44,000 eager launches of a round cost ~20 s of host time.)"""
    import dataclasses
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.experiments.main import run_cross_silo
    from fedml_tpu_torch.secure import fused_mask
    from fedml_tpu_torch.utils.metrics import MetricsSink

    t_run = time.perf_counter()
    cfg = cd_cfg([*CONFIG3_ARGS, "--model", model])
    data = cd_data(cfg, cache)
    reset_peak()
    fused_agg.reset_launch_counts()
    fused_mask.reset_launch_counts()
    t0 = time.perf_counter()
    with MetricsSink(None) as sink:
        summary = run_cross_silo(cfg, data, sink)
    sync(CARD)
    run_s = time.perf_counter() - t0
    k2 = fused_agg.launch_counts["shard_finalize"]
    need = cfg.model_shards * cfg.comm_round
    if k2 != need or fused_agg.launch_counts["robust_agg"] \
            or fused_mask.launch_counts["secagg_mask"]:
        fail(f"config3 {model}: shard_finalize launched {k2} times (need "
             f"{need}), robust_agg "
             f"{fused_agg.launch_counts['robust_agg']}, secagg_mask "
             f"{fused_mask.launch_counts['secagg_mask']} (need 0)")
    if not summary.get("params_finite"):
        fail(f"config3 {model}: non-finite parameters")
    row = dict(model=model, k2_launches=k2, run_s=run_s,
               rounds_per_s=summary["rounds_per_s"],
               round_ms=1e3 / summary["rounds_per_s"],
               test_acc=summary.get("test_acc"), peak_gb=peak_gb())
    # lr 0.001 moves the global by little in a round: the round must move
    # it, by any amount
    row["vs_cpu_max_abs_diff"] = silo_round_parity(dataclasses.replace(
        cfg, epochs=CONFIG3_PARITY_EPOCHS,
        client_num_per_round=CONFIG3_PARITY_SILOS), data, min_move=0.0)
    row.update(vs_cpu_tol=ROUND_TOL, vs_cpu_epochs=CONFIG3_PARITY_EPOCHS,
               vs_cpu_silos=CONFIG3_PARITY_SILOS,
               seconds=time.perf_counter() - t_run)
    phase(f"zoo config3 {model}", **row)
    return row


def check_k1_bn_table(stacked, weights, glob, seed_words, sm_hz):
    """K1n and K1 over the BatchNorm ResNet-56's 292-leaf table, on the
    inputs the defended round gave its aggregate: the kernels' scales
    within K1_SCALE_TOL (relative) of the plain version's and their
    aggregate within KERNEL_TOL of the plain version leaf by leaf, at
    clip 5 with sigma 0 and SIGMA; at a bound under every client's update
    norm (sigma 0) every weight leaf is clipped and every statistics leaf
    comes out as the unclipped weighted mean; times and bounds of the
    table's launches."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa
    from fedml_tpu_torch.core.pytree import tree_keys
    from fedml_tpu_torch.core.robust import (_masked_global_norm,
                                             default_is_weight_param)

    keys = tree_keys(stacked)
    n = int(weights.shape[0])
    ratios = (weights / weights.sum()).contiguous()
    layout = fa.LeafLayout(keys, [glob[k].numel() for k in keys],
                           range(len(keys)),
                           [default_is_weight_param(k) for k in keys])
    xs = [stacked[k].reshape(n, -1).contiguous() for k in keys]
    gs = [glob[k].reshape(-1).contiguous() for k in keys]
    ones = torch.ones(n, device=weights.device)
    norms = _masked_global_norm({k: stacked[k] - glob[k] for k in keys},
                                default_is_weight_param, batch_dims=1)
    tight = float(norms.min()) / 2        # every client clipped
    out = dict(leaves=len(keys), weight_leaves=len(layout.norm_rows),
               elements=sum(layout.sizes), update_norms=norms.tolist())
    err, rel = 0.0, 0.0
    for bound, sigmas in ((CLIP_BOUND, (0.0, SIGMA)), (tight, (0.0,))):
        want_scales = fa.clip_scales_plain(stacked, glob, bound,
                                           default_is_weight_param)
        got_scales = fa.clip_norm(layout, xs, gs, bound)
        sync(CARD)
        rel = max(rel, float(((got_scales - want_scales).abs()
                              / want_scales).max()))
        for sigma in sigmas:
            agg = fa.make_fused_robust_aggregate(norm_bound=bound,
                                                 noise_std=sigma)
            got = agg(stacked, weights, glob, seed_words)
            for li, k in enumerate(keys):
                s = want_scales if layout.weight[li] else ones
                want = fa.robust_agg_plain(
                    xs[li], gs[li], s, ratios,
                    fa.leaf_seed(seed_words[0], li),
                    fa.leaf_seed(seed_words[1], li), sigma)
                err = max(err, float((got[k].reshape(-1) - want)
                                     .abs().max()))
                if bound == tight and not sigma:
                    mean = fa.robust_agg_plain(xs[li], gs[li], ones, ratios,
                                               0, 0, 0.0)
                    moved = float((got[k].reshape(-1) - mean).abs().max())
                    if layout.weight[li]:
                        out["clipped_weight_max_move"] = max(
                            out.get("clipped_weight_max_move", 0.0), moved)
                    elif not moved <= KERNEL_TOL:
                        fail(f"K1 clipped the statistics leaf {k} (moved "
                             f"{moved} from the weighted mean)")
    if not err <= KERNEL_TOL or not rel <= K1_SCALE_TOL:
        fail(f"K1 over the BatchNorm table: aggregate max abs err {err} "
             f"(limit {KERNEL_TOL}), scales max rel err {rel} (limit "
             f"{K1_SCALE_TOL})")
    if not out.get("clipped_weight_max_move", 0.0) > KERNEL_TOL:
        fail("K1 over the BatchNorm table: a bound under every update norm "
             "left the weight leaves unclipped")
    out.update(max_abs_err=err, scales_max_rel_err=rel,
               tight_bound=tight, stats_unclipped=True)
    scales = fa.clip_norm(layout, xs, gs, CLIP_BOUND)
    call = lambda: fa.robust_agg_table(layout, xs, gs, scales, ratios,
                                       *seed_words, SIGMA)
    plain = lambda: [fa.robust_agg_plain(
        x, g, scales, ratios, fa.leaf_seed(seed_words[0], li),
        fa.leaf_seed(seed_words[1], li), SIGMA)
        for li, (x, g) in enumerate(zip(xs, gs))]
    library = lambda: [torch.mv(x.T, ratios) for x in xs]
    norm = lambda: fa.clip_norm(layout, xs, gs, CLIP_BOUND)
    eager = lambda: fa.clip_scales_plain(
        stacked, glob, CLIP_BOUND, default_is_weight_param)
    weight_sizes = [layout.sizes[j] for j in layout.norm_rows]
    if CARD == "cuda":
        out["table"] = dict(
            ms=device_ms(call, 20, "robust_agg_kernel")
            or time_ms(call, 50),
            # CUDA events: ~117k small ops a call would swamp the profiler;
            # one timed call after the warm-up (each takes ~2.5 s)
            plain_ms=time_ms(plain, 1, trials=1),
            library_ms=device_ms(library, 20) or time_ms(library, 50),
            **op_bound(*robust_agg_work(n, layout.sizes, SIGMA), sm_hz))
        out["clip_norm"] = dict(
            ms=device_ms(norm, 20, "clip_norm_kernel")
            or time_ms(norm, 50),
            plain_ms=device_ms(eager, 20) or time_ms(eager, 20),
            **op_bound(*clip_norm_work(n, weight_sizes), sm_hz))
    return out


def zoo_bn_robust(cfg, data, sm_hz):
    """The BatchNorm ResNet-56 through FedAvgRobust (weak DP, the fused
    CUDA backend, clip 5, sigma 0.025), 2 rounds: K1n and K1 launched by
    the main path each round (their counts from zero); then both held
    against their plain versions over the round's 292-leaf table."""
    import torch
    from fedml_tpu_torch.algorithms import fedavg_robust as fr
    from fedml_tpu_torch.core import fused_agg as fa
    from fedml_tpu_torch.experiments.main import fedavg_robust_config
    from fedml_tpu_torch.trainer.workload import ClassificationWorkload

    seen = []
    real = fr.make_fused_robust_aggregate

    def recording(**kw):
        agg = real(**kw)

        def aggregate(stacked, weights, global_params, seed_words):
            if not seen:
                seen.append((_clone(stacked), weights.clone(),
                             _clone(global_params), tuple(seed_words)))
            return agg(stacked, weights, global_params, seed_words)
        aggregate.needs_global = True
        return aggregate

    fr.make_fused_robust_aggregate = recording
    try:
        algo = fr.FedAvgRobust(
            ClassificationWorkload(bn_models()[BN_ROBUST_MODEL](), 10,
                                   stateful=True),
            data, fedavg_robust_config(cfg), device=cfg.platform)
    finally:
        fr.make_fused_robust_aggregate = real
    reset_peak()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    params = algo.run()
    sync(CARD)
    run_s = time.perf_counter() - t0
    launches = dict(fa.launch_counts)
    stacked, weights, glob, words = seen[0]
    fa.reset_launch_counts()
    real(norm_bound=cfg.norm_bound, noise_std=cfg.stddev)(
        stacked, weights, glob, words)
    per_call = dict(fa.launch_counts)
    need = {k: per_call[k] * cfg.comm_round
            for k in ("robust_agg", "clip_norm")}
    if CARD == "cuda" and any(launches[k] != need[k] for k in need):
        fail(f"zoo bn defended: the main path launched {launches}, need "
             f"{need} ({per_call} a round)")
    if not all(bool(v.isfinite().all()) for v in params.values()):
        fail("zoo bn defended: non-finite parameters")
    row = dict(launches={k: launches[k] for k in need},
               launches_per_round=per_call, run_s=run_s,
               rounds_per_s=steady(algo.round_times)["rounds_per_s"],
               peak_gb=peak_gb())
    row["k1"] = check_k1_bn_table(stacked, weights, glob, words, sm_hz)
    phase("zoo bn defended", **row)
    del algo, params, seen
    if CARD == "cuda":
        torch.cuda.empty_cache()
    return row


def zoo_centralized(cache: dict):
    """``--algo centralized`` through the CLI's runner on the card:
    rounds/s, one profiled round, the logged rows."""
    import dataclasses
    from fedml_tpu_torch.experiments.main import run_centralized
    from fedml_tpu_torch.utils.metrics import MetricsSink

    cfg = cd_cfg(CENTRAL_ARGS)
    data = cd_data(cfg, cache)
    reset_peak()
    with MetricsSink(None) as sink:
        summary = run_centralized(cfg, data, sink)
    if not summary["params_finite"] or summary["round"] != cfg.comm_round - 1:
        fail(f"zoo centralized: {summary}")
    row = dict(rounds_per_s=summary["rounds_per_s"],
               round_ms=1e3 / summary["rounds_per_s"],
               train_acc=summary["train_acc"], test_acc=summary["test_acc"],
               peak_gb=peak_gb())
    with MetricsSink(None) as sink:
        row.update(profile_once(lambda: run_centralized(
            dataclasses.replace(cfg, comm_round=1), data, sink), 1))
    phase("zoo centralized", **row)
    return row


def zoo_oracle():
    """BASELINE.md's oracle on the card, TF32 off: full-batch (one batch a
    client), E=1, full-participation FedAvg (the graphed device round) of
    logistic regression on the mnist twin, without grad clipping, against
    the centralized trainer on the pooled data in one batch,
    ORACLE_ROUNDS rounds from one init; parameters within
    ORACLE_RTOL/ORACLE_ATOL, train accuracy within ORACLE_ACC_TOL."""
    import torch
    from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    from fedml_tpu_torch.data import load_data
    from fedml_tpu_torch.data.stacking import batch_global
    from fedml_tpu_torch.models import LogisticRegression
    from fedml_tpu_torch.trainer.workload import ClassificationWorkload

    data = load_data("mnist", num_clients=ORACLE_CLIENTS, batch_size=64,
                     seed=0)
    if data.train["mask"].shape[1] != 1:
        fail("zoo oracle: a client has more than one batch")
    wl = ClassificationWorkload(LogisticRegression(784, 10), 10,
                                grad_clip_norm=None)
    keep = data.train["mask"] > 0
    pooled = batch_global(data.train["x"][keep], data.train["y"][keep],
                          batch_size=int(keep.sum()))
    with tf32_off():
        fed = FedAvg(wl, data, FedAvgConfig(
            comm_round=ORACLE_ROUNDS, client_num_per_round=ORACLE_CLIENTS,
            batch_size=64, lr=ORACLE_LR, frequency_of_the_test=1000),
            device=CARD)
        init = wl.init(torch.Generator().manual_seed(0), CARD)
        got = fed.run(params=_clone(init))
        central = CentralizedTrainer(wl, lr=ORACLE_LR)
        want = central.train_rounds(_clone(init), pooled, ORACLE_ROUNDS)
        fed_acc = fed.evaluate_global(got)["train_acc"]
        cen_acc = central.metrics(want, pooled)["acc"]
    excess = max(float(((got[k] - want[k]).abs()
                        - (ORACLE_ATOL + ORACLE_RTOL * want[k].abs()))
                       .max()) for k in want)
    row = dict(clients=ORACLE_CLIENTS, samples=int(keep.sum()),
               rounds=ORACLE_ROUNDS, max_abs_diff=max_diff(got, want),
               allclose_excess=excess, rtol=ORACLE_RTOL, atol=ORACLE_ATOL,
               fedavg_train_acc=fed_acc, centralized_train_acc=cen_acc,
               acc_tol=ORACLE_ACC_TOL,
               moved_from_init=max_diff(want, init),
               graphed=getattr(fed._device_round, "graph", None) is not None)
    phase("zoo oracle", **row)
    if not (excess <= 0 and abs(fed_acc - cen_acc) <= ORACLE_ACC_TOL
            and row["moved_from_init"] > 10 * ORACLE_ATOL):
        fail(f"zoo oracle: FedAvg against centralized training: {row}")
    return row


def check_zoo_models(sm_hz):
    """Phase 8m: BASELINE configs 5 (the LSTMs) and 3 (ResNet-56 and
    MobileNet over the live cross-silo spine), the BatchNorm workloads
    through FedAvg and the defended mean (K1n and K1 over the 292-leaf
    table), the centralized runner and the full-batch oracle.  Every
    run's row and the phase's seconds."""
    t_phase = time.perf_counter()
    cache = {}
    nwp = {}
    for name, argv in ZOO_NWP_ARGS.items():
        cfg = cd_cfg(argv)
        t0 = time.perf_counter()
        data = cd_data(cfg, cache)
        phase(f"zoo {name} twin", clients=data.client_num,
              seconds=time.perf_counter() - t0)
        nwp[name] = zoo_fedavg(name, cfg, data)
        cache.clear()
    silo = {m: zoo_silo(m, cache) for m in CONFIG3_MODELS}
    from fedml_tpu_torch.trainer.workload import ClassificationWorkload
    bn_cfg = cd_cfg(BN_ARGS)
    bn_data = cd_data(bn_cfg, cache)
    bn = {name: zoo_fedavg(name, bn_cfg, bn_data,
                           lambda fn=fn: ClassificationWorkload(
                               fn(), 10, stateful=True))
          for name, fn in bn_models().items()}
    robust = zoo_bn_robust(cd_cfg(BN_ROBUST_ARGS), bn_data, sm_hz)
    central = zoo_centralized(cache)
    oracle = zoo_oracle()
    seconds = time.perf_counter() - t_phase
    phase("zoo_models done", seconds=seconds)
    return dict(nwp=nwp, silo=silo, bn=bn, robust=robust, central=central,
                oracle=oracle, seconds=seconds)


# ---------------------------------------------------------------------------
# the live machinery (phase 8n): the pipelined ingest on the sharded spine,
# the reliability tracker and the adversary harness, wire compression,
# async_fl, the edge tier with grouped SecAgg, hierarchical FL and the
# wave engine's seams
# ---------------------------------------------------------------------------

MACH_ROUNDS = 3                  # rounds of the ingest, compression, edges
MACH_DEGRADE = ["--straggler_policy", "drop", "--round_timeout_s", "30",
              "--adaptive_deadline", "true", "--min_quorum", "0.6",
              "--adversary", "2:scale:20,3:nan_bomb",
              "--strikes_to_quarantine", "2", "--norm_screen_min_history",
              "3"]
MACH_DEGRADE_ROUNDS = 4
MACH_COMPRESS = {"topk": ["--wire_compression", "topk", "--error_feedback",
                        "true"],
               "int8": ["--wire_compression", "int8"]}
MACH_ASYNC = ["--algo", "async_fl", "--silo_backend", "local",
              "--async_goal", "5", "--agg_mode", "stream", "--norm_clip",
              "5.0", "--server_opt", "adam", "--server_lr", "0.01",
              *COMMON_ARGS]
MACH_ASYNC_DURABLE = ["--journal", "true", "--checkpoint_every", "1",
                      "--journal_snapshot_every", "1"]
MACH_ASYNC_VERSIONS = 6
MACH_EDGES = ["--edge_aggregators", "2"]
MACH_EDGE_KILL = ("post_fold_pre_ack", 2)   # edge 1's second fold, round 1
MACH_HIER = ["--algo", "hierarchical", "--group_num", "2",
           "--group_comm_round", "2", *COMMON_ARGS]
MACH_ORACLE_TOL = 1e-5           # group_num 1 / group_comm_round 1 vs fedavg
MACH_HIER_CPU_CLIENTS = 4        # the round held against the CPU (time)
MACH_WAVES = ["--wave_adversary", "1:0:nan_bomb", "--comm_round", "2"]


def mach_drive(fed, max_timeouts: int = 8) -> None:
    """`live_drive` with the ingest pipeline's drain as the pump's idle
    hook."""
    from fedml_tpu_torch.algorithms.cross_silo import MsgType
    from fedml_tpu_torch.comm.message import Message
    server = fed.server
    hook = fed.ingest.drain if fed.ingest is not None else None
    sync(fed.cfg.platform)
    fed.t_start = time.perf_counter()
    try:
        for edge in fed.edges:
            edge.resume()
        server.start()
        fed.hub.pump(idle_hook=hook)
        sent = 0
        while not server._finished and server.round_idx < fed.cfg.comm_round:
            if sent == max_timeouts:
                fail(f"the federation stalled at round {server.round_idx}")
            server.send(MsgType.ROUND_TIMEOUT, 0,
                        **{Message.ARG_ROUND: server.round_idx})
            sent += 1
            fed.hub.pump(idle_hook=hook)
    finally:
        server.finish()
        if fed.checkpointer is not None:
            fed.checkpointer.close()


def mach_counts():
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.secure import fused_mask
    return {**fused_agg.launch_counts, **fused_mask.launch_counts}


def mach_reset_counts() -> None:
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.secure import fused_mask
    fused_agg.reset_launch_counts()
    fused_mask.reset_launch_counts()


def mach_timed(obj, name: str, acc: list) -> None:
    """Add each call's host seconds of ``obj.name`` to ``acc``."""
    real = getattr(obj, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            acc.append(time.perf_counter() - t0)
    setattr(obj, name, timed)


def mach_pinned_copies(fed) -> dict:
    """One more pipelined round, profiled: the memcpy kinds the profiler
    names (pinned host-to-device copies are the arenas')."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import dataclasses
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if CARD == "cuda" else [])
    with profile(activities=acts) as prof:
        mach_drive(fed)
        sync(CARD)
    names = {}
    for ev in prof.key_averages():
        if "Memcpy" in ev.key or "memcpy" in ev.key:
            names[ev.key] = int(ev.count)
    pinned = sum(n for k, n in names.items()
                 if "HtoD" in k and "Pinned" in k)
    return dict(memcpy_events=names, pinned_htod=pinned if names else None)


def check_mach_ingest(data):
    """Run 1: the sharded spine inline and pipelined, in turns (inline,
    pipelined, pipelined, inline); each turn's round ms is kept."""
    runs, init, turns = {}, None, {"inline": [], "ingest": []}
    for label in ("inline", "ingest", "ingest", "inline"):
        extra = ["--ingest_pipeline", "true"] if label == "ingest" else []
        c = live_cfg([*SILO_ARGS, *extra], MACH_ROUNDS)
        fed = live_fed(c, data, init=init)
        init = init or {k: v.clone() for k, v in fed.server.params.items()}
        adm_s = []
        mach_timed(fed.server.shard_wire.admission, "offer", adm_s)
        stage_s = []
        if fed.ingest is not None:
            for s in range(fed.ingest.num_shards):
                mach_timed(fed.ingest.arena_for(s), "stage_message", stage_s)
        mach_reset_counts()
        with deterministic():
            mach_drive(fed)
        sync(CARD)
        counts = mach_counts()
        need = c.model_shards * MACH_ROUNDS
        if counts["shard_finalize"] != need or counts["robust_agg"] \
                or counts["clip_norm"] or counts["secagg_mask"]:
            fail(f"live ingest {label}: launches {counts}, need exactly "
                 f"{need} K2 and no K1/K3")
        row = dict(rounds_per_s=rounds_per_s(fed),
                   round_ms=steady_round_ms(fed), k2_launches=need,
                   admission_ms_per_round=sum(adm_s) * 1e3 / MACH_ROUNDS)
        row["admission_share"] = row["admission_ms_per_round"] / \
            row["round_ms"]
        if fed.ingest is not None:
            uploads = MACH_ROUNDS * c.client_num_per_round
            copies = [fed.ingest.arena_for(s).copies
                      for s in range(fed.ingest.num_shards)]
            if copies != [uploads] * c.model_shards:
                fail(f"live ingest: arena copies {copies}, need one per "
                     f"upload per shard ({uploads})")
            row.update(arena_copies=copies,
                       stage_ms_per_round=sum(stage_s) * 1e3 / MACH_ROUNDS)
        turns[label].append(row["round_ms"])
        if label in runs and not bit_equal(fed.server.params,
                                           runs[label][1].server.params):
            fail(f"live ingest {label}: two turns' globals differ")
        runs[label] = (row, fed)
    same = bit_equal(runs["ingest"][1].server.params,
                     runs["inline"][1].server.params)
    if not same:
        fail(f"live ingest: the pipelined global differs from the inline "
             f"one by {max_diff(runs['ingest'][1].server.params, runs['inline'][1].server.params)}")
    prof_cfg = live_cfg([*SILO_ARGS, "--ingest_pipeline", "true"], 1)
    prof = mach_pinned_copies(live_fed(prof_cfg, data, init=init))
    need = prof_cfg.client_num_per_round * prof_cfg.model_shards
    if prof["pinned_htod"] is not None and prof["pinned_htod"] != need:
        fail(f"live ingest: {prof['pinned_htod']} pinned H2D copies in a "
             f"pipelined round, need one per upload per shard ({need})")
    out = {label: row for label, (row, _) in runs.items()}
    out.update(bit_equal=same, profiled_round=prof, turns_round_ms=turns,
               copies_per_round_need=need)
    phase("live ingest", **out)
    return out, init


def mach_cpu_round(argv, data, init, wrap=None, runner="silo"):
    """One round (version) of ``argv`` on the card with TF32 off and on
    the CPU from ``init``; ``wrap(fed, label)`` installs recorders before
    the drive.  Returns the two federations."""
    from fedml_tpu_torch.experiments.main import AsyncFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink
    feds = {}
    for label, device in (("card", CARD), ("cpu", "cpu")):
        cfg = live_cfg(argv, 1, device)
        if runner == "async":
            with MetricsSink(None) as sink:
                fed = AsyncFederation(cfg, data, sink, init_params=init)
            fed.server.on_version = None
        else:
            fed = live_fed(cfg, data, init=init)
        if wrap is not None:
            wrap(fed, label)
        with tf32_off():
            if runner == "async":
                fed.run()
            else:
                mach_drive(fed)
        feds[label] = fed
    return feds["card"], feds["cpu"]


def check_mach_degrade(data, init):
    """Run 2: the tracker and the adversary harness on the spine."""
    from fedml_tpu_torch.robust import TrustTracker
    argv = [*SILO_ARGS, *MACH_DEGRADE]
    fed = live_fed(live_cfg(argv, MACH_DEGRADE_ROUNDS), data, init=init)
    ledgers = []
    real = fed.server.on_round_done

    def on_round_done(r, params):
        real(r, params)
        ledgers.append(fed.degrade.as_ledger())
    fed.server.on_round_done = on_round_done
    mach_drive(fed)
    adm = fed.server.shard_wire.admission
    finite = all(bool(v.isfinite().all()) for v in fed.server.params.values())
    quarantined = adm.trust.state(2, MACH_DEGRADE_ROUNDS) == \
        TrustTracker.QUARANTINED
    excluded = sorted(s for s, v in fed.server.dropped_silos.items()
                      if 2 in v)
    row = dict(rounds=MACH_DEGRADE_ROUNDS, rounds_per_s=rounds_per_s(fed),
               round_ms=steady_round_ms(fed), params_finite=finite,
               rejected={k: v for k, v in adm.rejected.items() if v},
               silo2_quarantined=quarantined, silo2_excluded_rounds=excluded,
               silo3_state=adm.trust.state(3, MACH_DEGRADE_ROUNDS),
               deadlines_s=[led["deadline_s"] for led in ledgers],
               verdicts=[led.get("verdict") for led in ledgers],
               faults=ledgers[-1]["faults"] if ledgers else None,
               strike_faults=adm.trust.strike_fault_totals())
    if not finite or adm.rejected["nonfinite"] < 1 or not quarantined \
            or row["strike_faults"]["network"]:
        fail(f"live degrade: {row}")
    card, cpu = mach_cpu_round(argv, data, init)
    row["vs_cpu_max_abs_diff"] = max_diff(card.server.params,
                                          cpu.server.params)
    if not row["vs_cpu_max_abs_diff"] <= ROUND_TOL:
        fail(f"live degrade: one round on the card against the CPU "
             f"{row['vs_cpu_max_abs_diff']} > {ROUND_TOL}")
    phase("live degrade", limit=ROUND_TOL, **row)
    return row


def check_mach_compression(data, init):
    """Run 3: flat cross-silo with topk + EF and with int8."""
    out = {}
    raw_params = sum(v.numel() * v.element_size() for v in init.values())
    for name, extra in MACH_COMPRESS.items():
        argv = [*PLAIN_STREAM_ARGS, *extra]
        fed = live_fed(live_cfg(argv, MACH_ROUNDS), data, init=init)
        mach_drive(fed)
        wire = fed.wire_stats
        uploads = MACH_ROUNDS * fed.cfg.client_num_per_round
        row = dict(rounds_per_s=rounds_per_s(fed),
                   round_ms=steady_round_ms(fed),
                   wire_bytes=wire["bytes"], decoded_bytes=wire["raw_bytes"],
                   uncompressed_bytes=uploads * raw_params,
                   ratio=wire["bytes"] / (uploads * raw_params),
                   params_finite=all(bool(v.isfinite().all())
                                     for v in fed.server.params.values()))
        if wire["raw_bytes"] != uploads * raw_params or not \
                row["params_finite"]:
            fail(f"live compression {name}: {row}")
        card, cpu = mach_cpu_round(argv, data, init)
        row["vs_cpu_max_abs_diff"] = max_diff(card.server.params,
                                              cpu.server.params)
        if not row["vs_cpu_max_abs_diff"] <= ROUND_TOL:
            fail(f"live compression {name}: one round against the CPU "
                 f"{row['vs_cpu_max_abs_diff']} > {ROUND_TOL}")
        out[name] = row
        phase(f"live compression {name}", limit=ROUND_TOL, **row)
    return out


def mach_async(data, base: Path, tag: str, init=None, faultline=None,
             versions: int = MACH_ASYNC_VERSIONS):
    import dataclasses
    from fedml_tpu_torch.experiments.main import AsyncFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink
    cfg = dataclasses.replace(
        live_cfg([*MACH_ASYNC, *MACH_ASYNC_DURABLE], versions),
        checkpoint_dir=str(base / tag / "ck"),
        journal_dir=str(base / tag / "j"))
    with MetricsSink(None) as sink:
        fed = AsyncFederation(cfg, data, sink, init_params=init,
                              faultline=faultline)
    fed.server.on_version = None           # no evaluation
    return fed


def check_mach_async(data, root: Path):
    """Run 4: async_fl, its kill at the last barrier close, and its first
    version against the CPU."""
    from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                                  Faultline)
    from fedml_tpu_torch.server_opt import ServerOptimizer
    base = root / "build" / "machinery_async"
    shutil.rmtree(base, ignore_errors=True)
    with deterministic():
        straight = mach_async(data, base, "straight")
        init = {k: v.clone() for k, v in straight.server.params.items()}
        sync(CARD)
        t0 = time.perf_counter()
        out = straight.run()
        sync(CARD)
        seconds = time.perf_counter() - t0
        fl = Faultline(crashes=[CrashSpec(point="barrier_close", hit=1,
                                          round_idx=MACH_ASYNC_VERSIONS - 1)])
        killed = mach_async(data, base, "kill", init=init, faultline=fl)
        try:
            killed.run()
            fail("the async barrier_close kill never fired")
        except ActorKilled:
            pass
        resumed = mach_async(data, base, "kill", init=init)
        resumed.run()
        same = bit_equal(resumed.server.params, straight.server.params)
    row = dict(versions=straight.server.version,
               versions_per_s=straight.server.version / seconds,
               version_ms=seconds * 1e3 / straight.server.version,
               mean_staleness=out.get("mean_staleness"),
               params_finite=out["params_finite"],
               kill=dict(point="barrier_close",
                         version=MACH_ASYNC_VERSIONS - 1,
                         killed_at=killed.server.version,
                         resumed_to=resumed.server.version,
                         bit_equal=same))
    if straight.server.version != MACH_ASYNC_VERSIONS or not same \
            or not out["params_finite"]:
        fail(f"live async: {row}")

    seen = {}

    def wrap(fed, label):
        real_fin = fed.server.stream_agg.finalize
        real_step = fed.server.server_opt.apply_delta

        def finalize(step):
            out = real_fin(step)
            seen[label, "finalized"] = {k: v.clone() for k, v in out.items()}
            return out

        def apply_delta(params, delta, version=0):
            seen[label, "before"] = {k: v.clone() for k, v in params.items()}
            seen[label, "delta"] = {k: v.clone() for k, v in delta.items()}
            return real_step(params, delta, version)
        fed.server.stream_agg.finalize = finalize
        fed.server.server_opt.apply_delta = apply_delta
    card_fed, _ = mach_cpu_round(MACH_ASYNC, data, init, wrap=wrap,
                                 runner="async")
    fin = max_diff(seen["card", "finalized"], seen["cpu", "finalized"])
    cfg = live_cfg(MACH_ASYNC, 1, "cpu")
    opt = ServerOptimizer("adam", {k: v.cpu() for k, v in init.items()},
                          lr=cfg.server_lr, beta1=cfg.server_adam_beta1,
                          beta2=cfg.server_adam_beta2,
                          eps=cfg.server_adam_eps)
    stepped = opt.apply_delta(
        {k: v.cpu() for k, v in seen["card", "before"].items()},
        {k: v.cpu() for k, v in seen["card", "delta"].items()})
    step = max_diff(card_fed.server.params, stepped)
    row.update(finalize_vs_cpu_max_abs_diff=fin,
               step_vs_cpu_max_abs_diff=step)
    if not (fin <= ROUND_TOL and step <= SRVOPT_STEP_TOL):
        fail(f"live async: the first version against the CPU: finalize "
             f"{fin} (limit {ROUND_TOL}), step {step} (limit "
             f"{SRVOPT_STEP_TOL})")
    phase("live async", limit=ROUND_TOL, step_limit=SRVOPT_STEP_TOL, **row)
    shutil.rmtree(base, ignore_errors=True)
    return row


def check_mach_edges(data, init, root: Path):
    """Run 5: the edge tier, plaintext and grouped SecAgg, and an edge
    killed after a fold."""
    from fedml_tpu_torch.algorithms.hierarchical import EdgeAggregatorActor
    from fedml_tpu_torch.core.stream_agg import StreamingAggregator
    from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                                  Faultline, kill_actor)
    from fedml_tpu_torch.utils.journal import RoundJournal
    out = {}
    globals_ = {}
    with deterministic():
        for name, extra in (("plaintext", []),
                            ("grouped", ["--secagg", "grouped"])):
            fed = live_fed(live_cfg([*PLAIN_STREAM_ARGS, *MACH_EDGES, *extra],
                                    MACH_ROUNDS), data, init=init)
            mach_drive(fed)
            out[name] = dict(rounds_per_s=rounds_per_s(fed),
                             round_ms=steady_round_ms(fed),
                             edges=len(fed.edges))
            globals_[name] = fed.closed
        diffs = [max_diff(a[2], b[2]) for a, b in
                 zip(globals_["grouped"], globals_["plaintext"])]
        out["grouped_vs_plaintext_max_abs_diff"] = diffs
        if len(diffs) != MACH_ROUNDS or not max(diffs) <= SECAGG_TOL:
            fail(f"live edges: grouped against plaintext {diffs} (limit "
                 f"{SECAGG_TOL})")
        base = root / "build" / "machinery_edges"
        shutil.rmtree(base, ignore_errors=True)
        argv = [*PLAIN_STREAM_ARGS, *MACH_EDGES, "--journal", "true",
                "--journal_dir", str(base / "j"),
                "--journal_snapshot_every", "1"]
        fed = live_fed(live_cfg(argv, MACH_ROUNDS), data, init=init)
        point, hit = MACH_EDGE_KILL
        edge = fed.edges[0]
        edge.faultline = Faultline(crashes=[CrashSpec(
            point=point, hit=hit, round_idx=CRASH_ROUND)])
        fed.t_start = time.perf_counter()
        fed.server.start()
        try:
            fed.hub.pump()
            fail(f"the edge {point} kill never fired")
        except ActorKilled:
            pass
        kill_actor(edge)
        respawned = EdgeAggregatorActor(
            edge.node_id, fed.hub.transport(edge.node_id), edge.silos,
            cohort_total=edge.cohort_total,
            client_num_in_total=edge.client_num_in_total,
            stream_agg=StreamingAggregator(
                init, method="mean", kind="params",
                norm_clip=fed.cfg.norm_clip, seed=fed.cfg.seed),
            admission=edge.admission,
            journal=RoundJournal(str(base / "j" / "edge1"),
                                 snapshot_every=1),
            timeout_s=edge.timeout_s)
        respawned.register_handlers()
        resumed = respawned.resume()
        fed.hub.pump()
        fed.server.finish()
        same = bit_equal(fed.server.params, globals_["plaintext"][-1][2])
        out["edge_kill"] = dict(point=point, hit=hit, round=CRASH_ROUND,
                                resumed=resumed,
                                rounds=fed.server.round_idx, bit_equal=same)
        if not (resumed and same and fed.server.round_idx == MACH_ROUNDS):
            fail(f"live edges: the killed edge's resume {out['edge_kill']}")
        shutil.rmtree(base, ignore_errors=True)
    phase("live edges", limit=SECAGG_TOL, **out)
    return out


def _no_eval(algo):
    """``algo`` with its evaluation a no-op: a parity run compares the
    params, and a CPU evaluation of the 3400-client split takes ~40 s."""
    algo.evaluate_global = lambda params: {}
    return algo


def check_mach_hierarchical(data):
    """Run 6: hierarchical FL, its oracle and a round against the CPU (the
    oracle and parity runs without their evaluation)."""
    import dataclasses
    from fedml_tpu_torch.experiments.main import hierarchical_algo
    cfg = cd_cfg(MACH_HIER)
    algo = hierarchical_algo(cfg, data)
    init = algo.init_params()
    sync(CARD)
    algo.run(params={k: v.clone() for k, v in init.items()})
    row = dict(rounds=len(algo.round_times), **steady(algo.round_times))
    with deterministic():
        one = dataclasses.replace(cfg, comm_round=1, group_num=1,
                                  group_comm_round=1)
        hier = _no_eval(hierarchical_algo(one, data)).run(
            params={k: v.clone() for k, v in init.items()})
        fa = _no_eval(fedavg_algo(cd_cfg(["--algo", "fedavg", *COMMON_ARGS,
                                          "--comm_round", "1"]), data, CARD))
        fedavg = fa.run(params={k: v.clone() for k, v in init.items()})
        row["oracle_vs_fedavg_max_abs_diff"] = max_diff(hier, fedavg)
        one_round = dataclasses.replace(
            cfg, comm_round=1, client_num_per_round=MACH_HIER_CPU_CLIENTS)
        card = _no_eval(hierarchical_algo(one_round, data)).run(
            params={k: v.clone() for k, v in init.items()})
        cpu = _no_eval(hierarchical_algo(
            dataclasses.replace(one_round, platform="cpu"), data)).run(
            params={k: v.cpu().clone() for k, v in init.items()})
        row["vs_cpu_max_abs_diff"] = max_diff(card, cpu)
    if not (row["oracle_vs_fedavg_max_abs_diff"] <= MACH_ORACLE_TOL
            and row["vs_cpu_max_abs_diff"] <= ROUND_TOL):
        fail(f"live hierarchical: {row} (limits {MACH_ORACLE_TOL}, "
             f"{ROUND_TOL})")
    phase("live hierarchical", oracle_limit=MACH_ORACLE_TOL,
          limit=ROUND_TOL, **row)
    return row


def check_mach_waves(data):
    """Run 7: the wave engine inline and pipelined with a poisoned wave,
    and the degrade seam's priority merge."""
    from fedml_tpu_torch.robust.degrade import ReliabilityTracker
    out, params = {}, {}
    with deterministic():
        for label, extra in (("inline", []),
                             ("ingest", ["--ingest_pipeline", "true"])):
            cfg = cd_cfg([*CD_ARGS, *MACH_WAVES, *extra])
            algo = cd_algo(cfg, data)
            params[label] = algo.run()
            out[label] = dict(**steady(algo.round_times),
                              rejected={k: v for k, v in
                                        algo.admission.rejected.items()
                                        if v},
                              folded_waves=algo.history[-1]["folded_waves"]
                              if algo.history else None)
            if algo.admission.rejected.get("nonfinite") != 1:
                fail(f"live waves {label}: the poisoned wave was not "
                     f"rejected exactly once: {algo.admission.rejected}")
    same = bit_equal(params["ingest"], params["inline"])
    if not same:
        fail(f"live waves: pipelined against inline "
             f"{max_diff(params['ingest'], params['inline'])}")
    cfg = cd_cfg([*CD_ARGS, "--comm_round", "1"])
    tracker = ReliabilityTracker(data.client_num)
    indebted = [int(c) for c in cd_algo(cfg, data)._sample_round(1)[-3:]]
    for cid in indebted:
        tracker.note_drop(cid + 1)
    algo = cd_algo(cfg, data)
    algo.degrade = tracker
    merged = [int(c) for c in algo._sample_round(1)[:3]]
    algo.run()
    out.update(bit_equal=same, indebted=indebted, merged_head=merged,
               debt_after_round=tracker.max_debt())
    if sorted(merged) != sorted(indebted):
        fail(f"live waves: the indebted clients {indebted} do not head the "
             f"next cohort {merged}")
    phase("live waves", **out)
    return out


def check_live_machinery(data, root: Path):
    """Phase 8n: every run of the slice, its checks and the phase's
    seconds."""
    t_phase = time.perf_counter()
    ingest, init = check_mach_ingest(data)
    degrade = check_mach_degrade(data, init)
    compression = check_mach_compression(data, init)
    async_ = check_mach_async(data, root)
    edges = check_mach_edges(data, init, root)
    hier = check_mach_hierarchical(data)
    waves = check_mach_waves(data)
    seconds = time.perf_counter() - t_phase
    phase("live machinery done", seconds=seconds)
    return dict(ingest=ingest, degrade=degrade, compression=compression,
                async_fl=async_, edges=edges, hierarchical=hier,
                waves=waves, seconds=seconds)


OBS_ROUNDS = 3                   # rounds of each spine run of phase 8o
OBS_FLAGS = ["--perf", "true", "--perf_strict", "true", "--device_obs",
             "true", "--health", "true", "--telemetry", "true"]
OBS_ADAPTIVE = ["--adaptive", "true", "--slo",
                "health_misalignment_ratio=0.5,"
                "round_duration_p95_seconds=30"]
OBS_STACK = ["--agg_mode", "stack", "--norm_clip", "5.0", "--agg_noise_std",
             str(SIGMA)]
OBS_DEFENDED_ROUNDS = 2
OBS_CD_ROUNDS = 2
OBS_ASYNC_VERSIONS = 3
OBS_EDGE_ROUNDS = 2


def obs_dirs(base: Path, tag: str):
    run = base / tag
    shutil.rmtree(run, ignore_errors=True)
    return run, ["--run_dir", str(run), "--trace_dir", str(run / "trace")]


@contextlib.contextmanager
def obs_enabled(run: Path, trace_node="node0"):
    """The process telemetry registry and span tracer of one instrumented
    run (enabled before its actors are built, as the CLI does), exported
    into ``run`` and disabled at the end."""
    from fedml_tpu_torch.obs import telemetry, trace
    reg = telemetry.enable()
    tracer = trace.enable(node=trace_node)
    try:
        yield tracer
    finally:
        run.mkdir(parents=True, exist_ok=True)
        tracer.export(str(run / "trace" / "trace-node0.json"))
        reg.save(str(run / "telemetry.json"))
        (run / "telemetry.prom").write_text(reg.render_prometheus())
        trace.disable()
        telemetry.disable()


def obs_check_ledgers(run: Path, label: str, spine: bool = False) -> dict:
    """Every line of ``run``'s perf and health ledgers through the port's
    validators; the device section on the card: backend cuda, memory in
    use, a peak under the limit, 0 < mfu <= 1 (flops complete on the
    spine), compile entries in round 0 only."""
    from fedml_tpu_torch.obs import critical_path, trend
    rows = trend.load_ledger(str(run / "perf.jsonl"))
    health = trend.load_ledger(str(run / "health.jsonl"))
    problems = trend.validate_ledger(rows) + [
        f"health: {p}" for p in trend.validate_health_ledger(health)]
    for r in rows:
        problems += critical_path.validate_record(r.get("critical_path"))
    mfus, compiles = [], []
    for r in rows:
        dev = r.get("device") or {}
        mem = dev.get("memory") or []
        if dev.get("backend") != CARD or (CARD == "cuda" and not mem):
            problems.append(f"round {r['round']}: device section {dev}")
        for e in mem:
            if not e.get("bytes_in_use") or e.get("peak_bytes") is None \
                    or e["peak_bytes"] > e["bytes_limit"]:
                problems.append(f"round {r['round']}: memory entry {e}")
        mfu = dev.get("mfu")
        if mfu is None or not 0 < mfu <= 1:
            problems.append(f"round {r['round']}: mfu {mfu}")
        if spine and dev.get("flops_complete") is not True:
            problems.append(f"round {r['round']}: flops incomplete")
        if r["round"] != rows[0]["round"] and dev.get("compiles"):
            problems.append(f"round {r['round']}: compiles after the "
                            f"first round {dev['compiles']}")
        if r.get("recompiles"):
            problems.append(f"round {r['round']}: {r['recompiles']} "
                            f"recompiles")
        mfus.append(mfu)
        compiles.append([(c["fn"], c["wall_s"]) for c in
                         dev.get("compiles") or []])
    if not rows or not health:
        problems.append("empty ledger")
    if problems:
        fail(f"observability {label}: {problems}")
    dev0 = rows[0].get("device") or {}
    return dict(rounds=len(rows), mfu=mfus, compiles=compiles,
                flops=[(r.get("device") or {}).get("flops") for r in rows],
                peak_tflops=dev0.get("peak_tflops"),
                peak_source=dev0.get("peak_source"),
                mem_in_use_mb=[e["bytes_in_use"] / 2 ** 20
                               for e in dev0.get("memory") or []],
                phases_ms={k: v * 1e3 for k, v in rows[-1]["phases"].items()},
                binding=[r["critical_path"]["binding"] for r in rows],
                alarms=[{k: v["ok"] for k, v in h["alarms"].items()}
                        for h in health])


def obs_spine(data, base: Path, tag: str, extra, init, instruments: bool):
    """One spine run (S = 4, K2 on, clip and noise) of ``OBS_ROUNDS``
    rounds, instrumented or with every instrument off; its K2 launches,
    round ms, spans, run dir and initial global."""
    from fedml_tpu_torch.core import fused_agg
    run, dirs = obs_dirs(base, tag)
    argv = [*SILO_ARGS, *extra] + ([*OBS_FLAGS, *dirs] if instruments
                                   else [])
    ctx = obs_enabled(run) if instruments else contextlib.nullcontext()
    with ctx as tracer:
        fed = live_fed(live_cfg(argv, OBS_ROUNDS), data, init=init)
        start = {k: v.clone() for k, v in fed.server.params.items()}
        mach_reset_counts()
        try:
            mach_drive(fed)
        finally:
            if fed.perf is not None:
                fed.perf.close()
        sync(CARD)
        spans = tracer.spans if tracer is not None else []
    k2 = fused_agg.launch_counts["shard_finalize"]
    need = 4 * OBS_ROUNDS
    if k2 != need or len(fed.closed) != OBS_ROUNDS:
        fail(f"observability {tag}: {k2} K2 launches in {len(fed.closed)} "
             f"rounds, need {need} in {OBS_ROUNDS}")
    row = dict(k2_launches=k2, round_ms=steady_round_ms(fed))
    if instruments:
        row.update(obs_check_ledgers(run, tag, spine=True))
    return fed, row, spans, run, start


def obs_trace_check(spans, n_silos: int) -> dict:
    """One root span a round, each with ``recv:`` children on every
    silo's track."""
    roots = [s for s in spans if s["parent_id"] is None]
    per_round = []
    for root in roots:
        members = [s for s in spans if s["trace_id"] == root["trace_id"]]
        per_round.append(sorted({s["node"] for s in members
                                 if s["name"].startswith("recv:")
                                 and s["node"] != 0}))
    want = list(range(1, n_silos + 1))
    if [r["name"] for r in roots] != ["round"] * OBS_ROUNDS \
            or any(nodes != want for nodes in per_round):
        fail(f"observability trace: roots {[r['name'] for r in roots]}, "
             f"recv tracks {per_round}")
    return dict(spans=len(spans), roots=len(roots),
                recv_tracks_per_round=[len(n) for n in per_round])


def obs_defended(data, base: Path, init) -> dict:
    """The stacked defended cross-silo round (``--agg_mode stack``, clip 5
    and sigma 0.025: ``defended_aggregate[mean]``, the eager fold of
    ``robust/defense.py``), ``OBS_DEFENDED_ROUNDS`` rounds with the
    instruments on, then off: the same globals, every ledger line valid,
    the aggregate ledgered once a round with its FLOPs from the work
    table and its compile in round 0.  No hand-written kernel runs here;
    K1 and K1n have no instrumented path in either package (the
    fedavg_robust runner takes no recorder), so phase 1 holds them."""
    params = {}
    with deterministic():
        for on in (True, False):
            run, dirs = obs_dirs(base, "defended" if on else "defended_off")
            argv = [*PLAIN_STREAM_ARGS, *OBS_STACK] + (
                [*OBS_FLAGS, *dirs] if on else [])
            ctx = obs_enabled(run) if on else contextlib.nullcontext()
            with ctx:
                fed = live_fed(live_cfg(argv, OBS_DEFENDED_ROUNDS), data,
                               init=init)
                try:
                    mach_drive(fed)
                finally:
                    if fed.perf is not None:
                        fed.perf.close()
                sync(CARD)
            if fed.server.aggregate_fn is None \
                    or len(fed.closed) != OBS_DEFENDED_ROUNDS:
                fail(f"observability defended: {len(fed.closed)} rounds, "
                     f"stacked aggregate {fed.server.aggregate_fn}")
            params[on] = fed.server.params
            if on:
                row = obs_check_ledgers(run, "defended", spine=True)
                rows = [json.loads(x) for x in
                        (run / "perf.jsonl").read_text().splitlines()]
    name = "defended_aggregate[mean]"
    calls = [r["device"]["jit_calls"].get(name) for r in rows]
    first = [c["fn"] for c in rows[0]["device"]["compiles"]]
    same = bit_equal(params[True], params[False])
    if calls != [1] * OBS_DEFENDED_ROUNDS or name not in first or not same:
        fail(f"observability defended: {name} calls {calls}, round-0 "
             f"compiles {first}, globals equal on/off: {same}")
    row.update(aggregate_calls=calls, bit_equal=same)
    return row


def obs_waves(data, base: Path) -> dict:
    """The wave engine (1000 a round, waves of 256) with perf, health,
    the SLO evaluator and the controller."""
    run, dirs = obs_dirs(base, "waves")
    cfg = cd_cfg([*CD_ARGS, "--comm_round", str(OBS_CD_ROUNDS), *OBS_FLAGS,
                  *OBS_ADAPTIVE, *dirs])
    with obs_enabled(run):
        algo = cd_algo(cfg, data)
        try:
            algo.run()
        finally:
            algo.perf.close()
    row = obs_check_ledgers(run, "waves")
    rows = [json.loads(x) for x in
            (run / "perf.jsonl").read_text().splitlines()]
    if any("adapt" not in r or "wave" not in r["phases"] for r in rows):
        fail(f"observability waves: lines without the controller's "
             f"decision or the wave phase: {rows}")
    row.update(adapt=[r["adapt"] for r in rows],
               round_s=[r["round_s"] for r in rows])
    return row


def obs_async_edges(data, base: Path, init) -> dict:
    """async_fl (goal 5, 3 versions) and the edge tier (2 edges of 5
    silos), each with perf and health."""
    from fedml_tpu_torch.experiments.main import AsyncFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink
    out = {}
    run, dirs = obs_dirs(base, "async")
    with obs_enabled(run):
        with MetricsSink(None) as sink:
            fed = AsyncFederation(live_cfg([*MACH_ASYNC, *OBS_FLAGS, *dirs],
                                           OBS_ASYNC_VERSIONS),
                                  data, sink, init_params=init)
        fed.server.on_version = None
        fed.run()
    out["async_fl"] = obs_check_ledgers(run, "async_fl")
    run, dirs = obs_dirs(base, "edges")
    with obs_enabled(run):
        fed = live_fed(live_cfg([*PLAIN_STREAM_ARGS, *MACH_EDGES,
                                 *OBS_FLAGS, *dirs], OBS_EDGE_ROUNDS),
                       data, init=init)
        try:
            mach_drive(fed)
        finally:
            fed.perf.close()
    row = obs_check_ledgers(run, "edges")
    health = [json.loads(x) for x in
              (run / "health.jsonl").read_text().splitlines()]
    if any(len(h.get("edges") or {}) != len(fed.edges) for h in health):
        fail(f"observability edges: rollups {[h.get('edges') for h in health]}")
    row["edge_rollup"] = [h["edge_rollup"] for h in health]
    out["edges"] = row
    return out


def check_observability(data, root: Path):
    """Phase 8o: the observatories on the card (spans, perf.jsonl with the
    critical path and the device section, health.jsonl, SLOs, the
    controller) over the spine inline, pipelined and adaptive, the
    stacked defended round, the wave engine, async_fl and the edge tier;
    the spine's globals with every instrument off bit-equal to them on,
    and the round ms on and off in ABBA turns (the instruments'
    overhead)."""
    from fedml_tpu_torch.obs import report
    t_phase = time.perf_counter()
    base = root / "build" / "observability"
    shutil.rmtree(base, ignore_errors=True)
    out, turns, globals_ = {}, {"on": [], "off": []}, {}
    init = None
    with deterministic():
        for i, on in enumerate((True, False, False, True)):
            fed, row, spans, run, start = obs_spine(
                data, base, f"inline_{i}", [], init, instruments=on)
            init = init or start
            label = "on" if on else "off"
            turns[label].append(row["round_ms"])
            globals_.setdefault(label, fed.server.params)
            if i == 0:
                out["inline"] = row
                out["trace"] = obs_trace_check(spans, len(fed.silos))
                text = report.render_report(str(run), str(run / "trace"))
                for section in ("perf ledger", "device observatory",
                                "learning health", "round timelines"):
                    if section not in text:
                        fail(f"observability report: no {section!r}")
                out["report_lines"] = len(text.splitlines())
        same = bit_equal(globals_["on"], globals_["off"])
        if not same:
            fail(f"observability: globals with the instruments on differ "
                 f"from off by {max_diff(globals_['on'], globals_['off'])}")
        out["ingest"] = obs_spine(
            data, base, "ingest", ["--ingest_pipeline", "true"], init,
            True)[1]
        _, out["adaptive"], _, run, _ = obs_spine(
            data, base, "adaptive", OBS_ADAPTIVE, init, True)
        rows = [json.loads(x) for x in
                (run / "perf.jsonl").read_text().splitlines()]
        if any("adapt" not in r for r in rows):
            fail("observability adaptive: a line without its decision")
        out["adaptive"]["adapt"] = [r["adapt"] for r in rows]
    out["defended"] = obs_defended(data, base, init)
    out["waves"] = obs_waves(data, base)
    out.update(obs_async_edges(data, base, init))
    on, off = statistics.median(turns["on"]), statistics.median(turns["off"])
    out.update(bit_equal_on_off=same, turns_round_ms=turns,
               overhead_ms=on - off, overhead_ratio=on / off - 1.0,
               seconds=time.perf_counter() - t_phase)
    phase("observability", **out)
    shutil.rmtree(base, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# data parallelism over torch.distributed (phase 8r)
# ---------------------------------------------------------------------------

# config 2's model, cohort and widths, evaluation at round 0 and the
# last, over 340 of its 3400 clients (each run is a new process: loading
# and evaluating all 3400 took ~5 s a run); every round's globals kept
MESH_ARGS = [*COMMON_ARGS, "--client_num_in_total", "340",
             "--deterministic", "true", "--checkpoint_every", "1",
             "--checkpoint_keep_last_n", "8"]
# the FedAvg runs take 6 rounds, so 5 steady rounds give each round-ms and
# collective-ms figure its median and spread; the others 2
MESH_FEDAVG_ROUNDS = ["--comm_round", "6"]
MESH_ROUNDS = ["--comm_round", "2"]
# x max|w|: a mesh run's globals after each round vs its reference's
MESH_TOL = 1e-5
# the JAX package's FedAvg oracle tolerance (tests/test_fedavg_oracle.py),
# element by element: each comparison reports its largest ratio to it
MESH_ORACLE_RTOL, MESH_ORACLE_ATOL = 1e-4, 1e-5
# SCAFFOLD keeps a host model per client: phase 8k's 200 clients
MESH_SCAFFOLD = ["--algo", "scaffold", "--client_num_in_total", "200",
                 *MESH_ROUNDS]
MESH_HIER = ["--algo", "hierarchical", "--group_num", "2", *MESH_ROUNDS]
MESH_FEDAVG = ["--algo", "fedavg", *MESH_FEDAVG_ROUNDS]
# name -> (argv, its backend, ranks); "fedavg blocks 2" is the reference
# the 2-rank FedAvg run is held to: one process whose cohort step trains
# the cohort as the two ranks do (two vmaps of 5, each its partial sum,
# the two added)
MESH_RUNS = {
    "fedavg": (MESH_FEDAVG, None, 1),
    "fedavg blocks 2": (MESH_FEDAVG, None, 1),
    "fedavg nccl 1": ([*MESH_FEDAVG, "--mesh_clients", "1"], "nccl", 1),
    "fedavg gloo 2": ([*MESH_FEDAVG, "--mesh_clients", "2"], "gloo", 2),
    "scaffold": (MESH_SCAFFOLD, None, 1),
    "scaffold gloo 2": ([*MESH_SCAFFOLD, "--mesh_clients", "2"], "gloo", 2),
    "hierarchical": (MESH_HIER, None, 1),
    "hierarchical gloo 2x1": ([*MESH_HIER, "--mesh_groups", "2",
                               "--mesh_clients", "1"], "gloo", 2),
}
MESH_BLOCKED = {"fedavg blocks 2": 2}
# run -> its references: (reference, how many first rounds are held to
# MESH_TOL x max|w|; None: every round).  The 2-rank FedAvg run is held
# on every round to its own arithmetic in one process ("fedavg blocks
# 2"), and after round 1 to the plain single-process run.  Its 5-client
# vmaps run other cuDNN algorithms than the 10-client one, and the CNN's
# training at lr 0.1 grows that difference over the rounds (on an H100,
# 1.5e-6 after round 1 to 9.2e-5 after round 6; the blocked run in one
# process shows the same differences, bit for bit: PERF.md §6), so a
# later round against the plain run measures that growth, not the mesh
MESH_HELD = {
    "fedavg nccl 1": (("fedavg", None),),
    "fedavg gloo 2": (("fedavg blocks 2", None), ("fedavg", 1)),
    "scaffold gloo 2": (("scaffold", None),),
    "hierarchical gloo 2x1": (("hierarchical", None),),
}
# the runs in turns: the three FedAvg runs each alone (their round ms are
# the phase's numbers), then the other four together.  The one-process
# runs and the one-rank run are ``main(argv)`` in this process (a new
# process takes ~20 s on the card's host to import torch and reach its
# first gradient); the two-rank runs are ``python -m fedml_tpu_torch``.
MESH_TURNS = (("fedavg",), ("fedavg blocks 2",), ("fedavg nccl 1",),
              ("fedavg gloo 2",),
              ("scaffold gloo 2", "hierarchical gloo 2x1", "scaffold",
               "hierarchical"))
MESH_IN_PROCESS = ("fedavg", "fedavg blocks 2", "fedavg nccl 1", "scaffold",
                   "hierarchical")
MESH_RUN_TIMEOUT_S = 300


def oracle_ratio(a, b) -> float:
    """The largest |a - b| / (ATOL + RTOL |b|) over every element: <= 1
    is inside the JAX package's FedAvg oracle tolerance."""
    return max(float(((a[k].double().cpu() - b[k].double().cpu()).abs()
                      / (MESH_ORACLE_ATOL + MESH_ORACLE_RTOL
                         * b[k].double().cpu().abs())).max())
               for k in a)


def mesh_held(rounds, ref_rounds, tol_rounds) -> dict:
    """One run's globals after each round against its reference's: the
    max |diff| and the MESH_TOL x max|w| limit a round, the oracle ratio
    a round (reported), and the rounds that fail (the first
    ``tol_rounds`` held to the limit; None: all of them)."""
    out = dict(max_abs_diff=[], limit=[], oracle_ratio=[], failed=[])
    if rounds is None or ref_rounds is None \
            or len(rounds) != len(ref_rounds):
        out["failed"].append("globals missing or a round short")
        return out
    for r, (got, want) in enumerate(zip(rounds, ref_rounds)):
        diff = max_diff(got, want)
        limit = MESH_TOL * max(float(v.abs().max()) for v in want.values())
        out["max_abs_diff"].append(diff)
        out["limit"].append(limit)
        out["oracle_ratio"].append(oracle_ratio(got, want))
        if (tol_rounds is None or r < tol_rounds) and not diff <= limit:
            out["failed"].append(f"round {r}: {diff} > {limit}")
    return out


def mesh_problems(name: str, rc, summary, expect, last=None,
                  held=None) -> list:
    """What is wrong with one run of phase 8r: a non-zero exit (a rank
    that died fails its launch), a missing summary, another backend or
    world than ``expect`` (backend, ranks), a run off the card, ranks
    whose params are not byte-equal, the written globals (``last``) not
    rank 0's, or a round that misses its reference (``held``: reference
    name -> `mesh_held`'s result)."""
    if rc != 0:
        return [f"{name}: exited {rc}"]
    if summary is None:
        return [f"{name}: printed no summary"]
    out = []
    backend, world = expect
    if CARD != "cuda" and backend is not None:    # a rehearsal on the CPU
        backend = "gloo"
    if not str(summary.get("device", "")).startswith(CARD):
        out.append(f"{name}: ran on {summary.get('device')}, not the card")
    if backend is not None:
        if summary.get("dist_backend") != backend \
                or summary.get("world_size") != world:
            out.append(f"{name}: backend {summary.get('dist_backend')} on "
                       f"{summary.get('world_size')} ranks, not {backend} "
                       f"on {world}")
        hashes = str(summary.get("rank_params_sha256", "")).split(",")
        if len(hashes) != world or len(set(hashes)) != 1:
            out.append(f"{name}: the ranks' params differ ({hashes})")
    if last is not None:
        from fedml_tpu_torch.parallel.mesh import params_sha256
        if params_sha256(last) != summary.get("params_sha256"):
            out.append(f"{name}: the written globals are not rank 0's")
    for ref, res in (held or {}).items():
        out += [f"{name} vs {ref}: {f}" for f in res["failed"]]
    return out


def mesh_dir(base: Path, name: str) -> Path:
    return base / name.replace(" ", "_")


def mesh_argv(name: str, base: Path) -> list:
    on_cpu = ([] if CARD == "cuda"      # a rehearsal on the CPU
              else ["--platform", "cpu", "--host_device_count", "2"])
    return [*MESH_ARGS, *MESH_RUNS[name][0], *on_cpu, "--checkpoint_dir",
            str(mesh_dir(base, name))]


def mesh_start(name: str, root: Path, base: Path):
    """One run of phase 8r as its own ``python -m fedml_tpu_torch``, its
    globals checkpointed by rank 0 every round; returns the process and
    its log."""
    log = open(f"{mesh_dir(base, name)}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fedml_tpu_torch", *mesh_argv(name, base)],
        cwd=root, stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, log


def blocked_cohort_step(local_train, blocks: int):
    """The cohort step of a ``blocks``-rank clients mesh in one process:
    each block of rows trained as its own vmap (its clients keyed by
    their cohort slots), its weighted partial sum taken, the partial sums
    added in block order."""
    import torch
    from fedml_tpu_torch.parallel.cohort import bcast, train_cohort

    def step(params, cohort, words):
        n = cohort["num_samples"].shape[0] // blocks
        w = cohort["num_samples"].to(torch.float32)
        total = sum(torch.sum(w[b * n:(b + 1) * n]) for b in range(blocks))
        out = None
        for b in range(blocks):
            rows = {k: v[b * n:(b + 1) * n] for k, v in cohort.items()}
            stacked, _ = train_cohort(local_train, params, rows, words,
                                      index_offset=b * n)
            ratio = w[b * n:(b + 1) * n] / total
            part = {k: torch.sum(x * bcast(ratio, x.dim()).to(x.dtype), 0)
                    for k, x in stacked.items()}
            out = part if out is None else {k: out[k] + part[k]
                                            for k in out}
        return out, None

    return step


def mesh_in_process(name: str, base: Path):
    """A run of phase 8r in this process: ``main(argv)`` (``--mesh_clients
    1`` joins and leaves a one-rank group there), its summary line in its
    log; or, for a MESH_BLOCKED reference, the CLI's FedAvg with its
    cohort step trained in blocks.  Its exit code and summary."""
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (load_experiment_data,
                                                  main, make_checkpointer)
    argv = mesh_argv(name, base)
    if name not in MESH_BLOCKED:
        # the run's summary line and its warnings go to its log
        with open(f"{mesh_dir(base, name)}.log", "w") as log, \
                contextlib.redirect_stdout(log):
            handler = logging.StreamHandler(log)
            logging.getLogger().addHandler(handler)
            try:
                return 0, main(argv)
            finally:
                logging.getLogger().removeHandler(handler)
    cfg = config_from_argv(argv)
    algo = fedavg_algo(cfg, load_experiment_data(cfg), device=CARD)
    algo.cohort_step = blocked_cohort_step(algo._local_train,
                                           MESH_BLOCKED[name])
    ckpt = make_checkpointer(cfg)
    try:
        with deterministic():
            algo.run(checkpointer=ckpt)
    finally:
        ckpt.close()
    return 0, {"device": str(algo.device)}


def mesh_finish(name: str, proc, log):
    """Wait for a run of phase 8r: its exit code and summary line."""
    try:
        rc = proc.wait(timeout=MESH_RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    log.close()
    text = Path(log.name).read_text()
    lines = [line for line in text.splitlines() if line.startswith("{")]
    if rc != 0:
        print(f"--- {name} (exit {rc}), the end of its log:\n"
              f"{text[-3000:]}", flush=True)
    return rc, json.loads(lines[-1]) if lines else None


def mesh_globals(ckpt: Path):
    """A run's checkpointed globals after each round, or None."""
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
    if not ckpt.is_dir():
        return None
    ck = RoundCheckpointer(str(ckpt), keep_last_n=8)
    last = ck.latest_round()
    if last is None:
        return None
    try:
        return [ck.restore(r)["params"] for r in range(last + 1)]
    except FileNotFoundError:
        return None


def check_mesh(root: Path):
    """Phase 8r: data parallelism over torch.distributed on the FEMNIST CNN
    at config 2's widths (340 of its 3400 clients), deterministic (TF32
    off).  FedAvg over 6 rounds: in one process, in one process with the
    2-rank mesh's blocks, on 1 rank over NCCL (both ``main(argv)`` in this
    process), on 2 ranks sharing the card over gloo (``python -m
    fedml_tpu_torch``); then over 2 rounds SCAFFOLD (200 clients) on 2
    ranks and hierarchical FL on the [2, 1] two-level mesh as ``python -m
    fedml_tpu_torch``, each beside its single-process run.  Every rank's
    globals byte-equal; each mesh run held to its references after every
    round (MESH_HELD); the backend, and the round ms and the ms a round
    spent in collectives (mean, median, least, largest) of each run.  No
    hand-written kernel runs on this path (the JAX package refuses its
    kernels on a mesh)."""
    t_phase = time.perf_counter()
    base = root / "build" / "mesh"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    runs = {}
    for turn in MESH_TURNS:
        t0 = time.perf_counter()
        started = {name: mesh_start(name, root, base) for name in turn
                   if name not in MESH_IN_PROCESS}
        for name in turn:
            if name in MESH_IN_PROCESS:
                runs[name] = (*mesh_in_process(name, base),
                              time.perf_counter() - t0)
        for name, (proc, log) in started.items():
            runs[name] = (*mesh_finish(name, proc, log),
                          time.perf_counter() - t0)
    rounds = {name: mesh_globals(mesh_dir(base, name)) for name in MESH_RUNS}
    out, problems = {}, []
    for name, (argv, backend, world) in MESH_RUNS.items():
        rc, summary, run_s = runs[name]
        held = {ref: mesh_held(rounds[name], rounds[ref], tol)
                for ref, tol in MESH_HELD.get(name, ())}
        if name in MESH_BLOCKED:    # how far the blocks alone move it
            held["fedavg"] = mesh_held(rounds[name], rounds["fedavg"], 0)
        last = rounds[name][-1] if rounds[name] else None
        problems += mesh_problems(name, rc, summary, (backend, world),
                                  None if name in MESH_BLOCKED else last,
                                  held)
        s = summary or {}
        row = dict(
            backend=s.get("dist_backend", "none"), ranks=world,
            device=s.get("device"), rounds=len(rounds[name] or ()),
            run_s=run_s, subprocess=name not in MESH_IN_PROCESS,
            alone=any(t == (name,) for t in MESH_TURNS),
            rank_hashes_equal=len(set(str(s.get(
                "rank_params_sha256", s.get("params_sha256"))).split(",")))
            == 1,
            **{k: v for k, v in s.items() if k.startswith(
                ("round_ms", "collective_ms", "rounds_per_s"))},
            **{f"vs {ref}": res for ref, res in held.items()})
        phase(f"mesh {name}", **row)
        out[name] = row
    if problems:
        fail("phase 8r: " + "; ".join(problems))
    out["seconds"] = time.perf_counter() - t_phase
    phase("mesh", seconds=out["seconds"], hand_written_kernels=0)
    return out


# ---------------------------------------------------------------------------
# phase 8s: sequence and pipeline parallelism, the wave mesh
# ---------------------------------------------------------------------------

# (a) dp x sp FedAvg on the T=2048 LM (LM, LM_DATA, LM_FEDAVG's 4 clients
# a round, B=2, f32) on the [1, 2] mesh: two gloo ranks sharing the card,
# each holding half the sequence, its clients trained one after another
PAR_SP_ROUNDS = 3
PAR_SP_SEED = 0
# its reference: one process, the same rounds with blockwise attention
# (bench.py's block 256), its clients one after another too (the ranks'
# order), so the peak memory compares T against T/2 of the activations
PAR_SP_BLOCK = LM_BENCH_BLOCK
# x max|w|: the sp globals after each round against the reference's.  On
# the CPU the same three rounds at T=256 (the rehearsal: d_model 64, 2
# heads, vocab 64) differ by PAR_SP_CPU_DIFF x max|w| after each round
# (the ring's two blocks against the blockwise scan's keys, the loss's
# sum split at the ranks); T=2048 sums rows 8x as long, and the limit is
# the mesh phase's, about 80 times the CPU's distance
PAR_SP_CPU_DIFF = 1.2e-7
PAR_SP_TOL = MESH_TOL
# (b) the CLI's --mesh_sequence runner with --attn_flash at the CLI's
# widths (d_model 128, 4 heads, d=32), over 2 rounds.  The Shakespeare
# twin's 80 tokens are below K4's 128-token block (both packages refuse
# flash there), so the runner takes the T=2048 LM twin; evaluation runs
# the dense workload, whose attention is K4f
PAR_CLI_ARGS = ["--algo", "fedavg", "--model", "transformer", "--dataset",
                "shakespeare", "--client_num_in_total", "16",
                "--client_num_per_round", "4", "--batch_size", "2",
                "--lr", "0.1", "--comm_round", "2",
                "--frequency_of_the_test", "1", "--mesh_sequence", "2",
                "--num_processes", "2", "--attn_flash", "true",
                "--deterministic", "true", "--log_stdout", "false"]
# (c) silo-local GPipe on the Shakespeare twin, dense and --moe_experts 4,
# every stage on the one card; S=2 against S=1 at the same 2 microbatches
# (MoE routing is per microbatch), from the same init, every round's
# global checkpointed
PAR_PP_ARGS = ["--algo", "cross_silo", "--silo_backend", "local",
               "--model", "transformer", "--dataset", "shakespeare",
               "--client_num_in_total", "40", "--client_num_per_round", "4",
               "--batch_size", "8", "--lr", "1.0", "--comm_round", "3",
               "--pp_microbatches", "2", "--frequency_of_the_test", "3",
               "--deterministic", "true", "--checkpoint_every", "1",
               "--checkpoint_keep_last_n", "8", "--log_stdout", "false"]
PAR_PP_RUNS = {"dense": [], "moe4": ["--moe_experts", "4"]}
PAR_PP_TOL = MESH_TOL          # x max|w|, S=2 against S=1 every round
# (d) the wave mesh: the FEMNIST CNN at 8l's cut (340 clients, 100 a
# round in waves of 32), 2 rounds, 2 ranks against the one-rank engine
PAR_WAVE_ARGS = [*CD_ARGS, "--client_num_in_total", "340", *CD_SMALL,
                 "--deterministic", "true", "--checkpoint_every", "1",
                 "--checkpoint_keep_last_n", "8"]
PAR_WAVE_TOL = WAVE_CHUNK_TOL  # x max|w|: 16-client vmaps against 32
PAR_JOIN_S = 600


def sp_lm_reference(data, init, rounds: int):
    """The one-process reference of 8s (a): FedAvg on the LM with
    blockwise attention, its clients one after another; each round's
    globals, its round ms and its peak GB."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg import (FedAvg, FedAvgConfig,
                                                   round_seed_words)
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.trainer.workload import NWPWorkload
    algo = FedAvg(NWPWorkload(TransformerLM(**LM, block_size=PAR_SP_BLOCK)),
                  data, FedAvgConfig(comm_round=rounds, seed=PAR_SP_SEED,
                                     **{**LM_FEDAVG, "client_axis": "scan"}),
                  device=CARD)
    reset_peak()
    params = {k: v.to(CARD) for k, v in init.items()}
    out = {"rounds": [], "round_ms": []}
    with deterministic():
        for r in range(rounds):
            t0 = time.perf_counter()
            params = algo.run_round(params, r,
                                    round_seed_words(PAR_SP_SEED, r), False)
            sync(CARD)
            out["round_ms"].append(1e3 * (time.perf_counter() - t0))
            out["rounds"].append({k: v.detach().cpu().clone()
                                  for k, v in params.items()})
    out["peak_gb"] = peak_gb()
    return out


def rank_settings() -> dict:
    """The settings a spawned rank takes from this process (a rehearsal
    on the CPU changes them here)."""
    return {"CARD": CARD, "LM": LM, "LM_DATA": LM_DATA,
            "LM_FEDAVG": LM_FEDAVG}


def sp_rank_job(settings, init, rounds: int, cli_argv):
    """8s (a) and (b) on one rank of the two, under the parent's
    ``settings`` (`rank_settings`): (a) the LM's dp x sp rounds on the
    [1, 2] mesh (each round's globals on rank 0, the round, ring and
    collective ms, the rank's peak GB, every rank's params sha256); (b)
    the CLI's --mesh_sequence runner (``cli_argv``) on the LM twin on the
    same group, K4's launches counted over it."""
    import dataclasses
    import torch
    from fedml_tpu_torch.algorithms.fedavg import (FedAvg, FedAvgConfig,
                                                   round_seed_words)
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (build_mesh, check_config,
                                                  deterministic_flags,
                                                  run_fedavg)
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.models import flash_attention as fa
    from fedml_tpu_torch.parallel.mesh import make_sp_mesh
    from fedml_tpu_torch.parallel.sequence import (make_sp_cohort_step,
                                                   make_sp_nwp_workload)
    from fedml_tpu_torch.trainer.workload import (NWPWorkload,
                                                  make_client_optimizer)
    from fedml_tpu_torch.utils.metrics import MetricsSink
    globals().update(settings)
    mesh = make_sp_mesh(1, 2, device=CARD)
    data = lm_data()
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "backend": mesh.backend, "rounds": [], "round_ms": [],
           "collective_ms": [], "ring_ms": []}
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    wl = NWPWorkload(TransformerLM(**LM))
    algo = FedAvg(wl, data, FedAvgConfig(comm_round=rounds, seed=PAR_SP_SEED,
                                         **LM_FEDAVG), device=mesh.device)
    algo.cohort_step = make_sp_cohort_step(
        make_sp_nwp_workload(wl.model, mesh),
        make_client_optimizer("sgd", LM_FEDAVG["lr"]), 1, mesh)
    params = {k: v.to(mesh.device) for k, v in init.items()}
    with deterministic_flags(True):
        for r in range(rounds):
            t0 = time.perf_counter()
            c0, p0 = mesh.collective_ms(), mesh.collective_ms("p2p")
            params = algo.run_round(params, r,
                                    round_seed_words(PAR_SP_SEED, r), False)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            out["round_ms"].append(1e3 * (time.perf_counter() - t0))
            out["collective_ms"].append(mesh.collective_ms() - c0)
            out["ring_ms"].append(mesh.collective_ms("p2p") - p0)
            if mesh.rank == 0:
                out["rounds"].append({k: v.detach().cpu().clone()
                                      for k, v in params.items()})
    out["hashes"] = mesh.gather_hashes(params)
    out["peak_gb"] = (torch.cuda.max_memory_allocated(mesh.device) / 1e9
                      if mesh.device.type == "cuda" else None)

    # (b): the CLI's runner on this group, on the LM twin
    cfg = config_from_argv(list(cli_argv) + (
        [] if CARD == "cuda" else ["--platform", "cpu"]))
    check_config(cfg)
    cfg = dataclasses.replace(cfg, platform=str(mesh.device))
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    with deterministic_flags(True), MetricsSink(None) as sink:
        out["cli"] = run_fedavg(cfg, data, sink, mesh=build_mesh(cfg))
    out["cli_s"] = time.perf_counter() - t0
    out["cli_launches"] = dict(fa.launch_counts)
    return out


def par_sp(root: Path) -> dict:
    """8s (a) and (b): the two ranks' job against the one-process
    reference."""
    import torch
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.parallel.launch import spawn_ranks
    from fedml_tpu_torch.trainer.workload import NWPWorkload
    data = lm_data()
    init = NWPWorkload(TransformerLM(**LM)).init(
        torch.Generator().manual_seed(PAR_SP_SEED))
    t0 = time.perf_counter()
    ranks = spawn_ranks(sp_rank_job, 2,
                        (rank_settings(), init, PAR_SP_ROUNDS, PAR_CLI_ARGS),
                        platform=None if CARD == "cuda" else "cpu",
                        join_timeout_s=PAR_JOIN_S)
    ranks_s = time.perf_counter() - t0
    ref = sp_lm_reference(data, init, PAR_SP_ROUNDS)
    problems = []
    held = dict(max_abs_diff=[], limit=[])
    for r, (got, want) in enumerate(zip(ranks[0]["rounds"], ref["rounds"])):
        diff = max_diff(got, want)
        limit = PAR_SP_TOL * max(float(v.abs().max()) for v in want.values())
        held["max_abs_diff"].append(diff)
        held["limit"].append(limit)
        if not diff <= limit:
            problems.append(f"sp round {r}: {diff} > {limit}")
    if len(ranks[0]["rounds"]) != PAR_SP_ROUNDS:
        problems.append("sp: a round short")
    for rk in ranks:
        if len(set(rk["hashes"])) != 1:
            problems.append(f"sp: the ranks' params differ {rk['hashes']}")
        if not rk["device"].startswith(CARD):
            problems.append(f"sp: rank {rk['rank']} ran on {rk['device']}")
        if CARD == "cuda" and rk["backend"] != "gloo":
            problems.append(f"sp: backend {rk['backend']}, not gloo")
        if not all(ms > 0 for ms in rk["ring_ms"]):
            problems.append(f"sp: rank {rk['rank']} timed no ring shift")
    cli = ranks[0]["cli"]
    hashes = str(cli.get("rank_params_sha256", "")).split(",")
    if len(hashes) != 2 or len(set(hashes)) != 1 \
            or not cli.get("params_finite"):
        problems.append(f"sp cli: ranks {hashes}, finite "
                        f"{cli.get('params_finite')}")
    launches = [rk["cli_launches"] for rk in ranks]
    if CARD == "cuda" and not all(c["flash_fwd"] > 0 and c["flash_bwd_dkv"]
                                  == 0 and c["flash_bwd_dq"] == 0
                                  for c in launches):
        problems.append(f"sp cli: K4 launches {launches} (K4f in eval "
                        f"only)")
    steady = lambda xs: statistics.median(xs[1:] or xs)  # noqa: E731
    row = dict(
        ranks_s=ranks_s, vs_reference=held,
        round_ms=[rk["round_ms"] for rk in ranks],
        round_ms_median=steady(ranks[0]["round_ms"]),
        ring_ms=[rk["ring_ms"] for rk in ranks],
        ring_ms_median=steady(ranks[0]["ring_ms"]),
        collective_ms_median=steady(ranks[0]["collective_ms"]),
        rank_peak_gb=[rk["peak_gb"] for rk in ranks],
        reference_round_ms=ref["round_ms"],
        reference_round_ms_median=steady(ref["round_ms"]),
        reference_peak_gb=ref["peak_gb"],
        rank_hashes_equal=len(set(ranks[0]["hashes"])) == 1)
    phase("parallel sp", **row)
    cli_row = dict(
        run_s=ranks[0]["cli_s"], train_loss=cli.get("train_loss"),
        round_ms_median=cli.get("round_ms_median"),
        collective_ms_median=cli.get("collective_ms_median"),
        ring_ms_median=cli.get("collective_ms_p2p_median"),
        k4_launches=launches, rank_hashes_equal=len(set(hashes)) == 1)
    phase("parallel sp cli", **cli_row)
    return {"sp": row, "cli": cli_row, "problems": problems}


def par_main(argv, log: Path):
    """``main(argv)`` in this process, its summary line and warnings in
    ``log``."""
    from fedml_tpu_torch.experiments.main import main
    on_cpu = [] if CARD == "cuda" else ["--platform", "cpu"]
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        handler = logging.StreamHandler(f)
        logging.getLogger().addHandler(handler)
        try:
            return main(list(argv) + on_cpu)
        finally:
            logging.getLogger().removeHandler(handler)


def par_held(name: str, rounds, ref_rounds, tol: float) -> dict:
    """Each round's globals against the reference's: max |diff| and the
    ``tol`` x max|w| limit a round, and the rounds that miss it."""
    out = dict(max_abs_diff=[], limit=[], failed=[])
    if rounds is None or ref_rounds is None \
            or len(rounds) != len(ref_rounds):
        out["failed"].append(f"{name}: globals missing or a round short")
        return out
    for r, (got, want) in enumerate(zip(rounds, ref_rounds)):
        diff = max_diff(got, want)
        limit = tol * max(float(v.abs().max()) for v in want.values())
        out["max_abs_diff"].append(diff)
        out["limit"].append(limit)
        if not diff <= limit:
            out["failed"].append(f"{name} round {r}: {diff} > {limit}")
    return out


def par_pp(base: Path) -> dict:
    """8s (c): --mesh_stages 2 against --mesh_stages 1, dense and MoE."""
    out, problems = {}, []
    for name, extra in PAR_PP_RUNS.items():
        runs = {}
        for stages in (1, 2):
            tag = f"pp_{name}_{stages}"
            shutil.rmtree(base / tag, ignore_errors=True)
            reset_peak()
            t0 = time.perf_counter()
            summary = par_main([*PAR_PP_ARGS, *extra, "--mesh_stages",
                                str(stages), "--checkpoint_dir",
                                str(base / tag)], base / f"{tag}.log")
            runs[stages] = dict(summary=summary,
                                run_s=time.perf_counter() - t0,
                                peak_gb=peak_gb(),
                                rounds=mesh_globals(base / tag))
        held = par_held(f"pp {name}", runs[2]["rounds"], runs[1]["rounds"],
                        PAR_PP_TOL)
        problems += held["failed"]
        s1, s2 = runs[1]["summary"], runs[2]["summary"]
        want = ",".join([CARD if CARD == "cpu" else "cuda:0"] * 2)
        if s2.get("stage_devices") != want:
            problems.append(f"pp {name}: stages on {s2.get('stage_devices')}")
        if not (s1.get("params_finite") and s2.get("params_finite")):
            problems.append(f"pp {name}: a global is not finite")
        n_micro = 2
        row = dict(
            round_ms_median=s2.get("round_ms_median"),
            stages1_round_ms_median=s1.get("round_ms_median"),
            round_ms=[s2.get("round_ms_min"), s2.get("round_ms_max")],
            bubble_share=(2 - 1) / (n_micro + 2 - 1),
            stage_devices=s2.get("stage_devices"),
            train_loss=s2.get("train_loss"), peak_gb=runs[2]["peak_gb"],
            stages1_peak_gb=runs[1]["peak_gb"],
            run_s=[runs[1]["run_s"], runs[2]["run_s"]],
            vs_stages1=held)
        phase(f"parallel pp {name}", **row)
        out[name] = row
    return {"runs": out, "problems": problems}


def par_waves(base: Path) -> dict:
    """8s (d): the wave mesh on 2 ranks against the one-rank engine."""
    runs, problems = {}, []
    mesh_args = ["--mesh_clients", "2"] + (
        [] if CARD == "cuda" else ["--host_device_count", "2"])
    for tag, extra in (("waves_1", []), ("waves_2", mesh_args)):
        shutil.rmtree(base / tag, ignore_errors=True)
        t0 = time.perf_counter()
        summary = par_main([*PAR_WAVE_ARGS, *extra, "--checkpoint_dir",
                            str(base / tag)], base / f"{tag}.log")
        runs[tag] = dict(summary=summary, run_s=time.perf_counter() - t0,
                         rounds=mesh_globals(base / tag))
    held = par_held("waves", runs["waves_2"]["rounds"],
                    runs["waves_1"]["rounds"], PAR_WAVE_TOL)
    problems += held["failed"]
    s = runs["waves_2"]["summary"]
    hashes = str(s.get("rank_params_sha256", "")).split(",")
    if len(hashes) != 2 or len(set(hashes)) != 1:
        problems.append(f"waves: the ranks' params differ ({hashes})")
    if not str(s.get("device", "")).startswith(CARD):
        problems.append(f"waves: ran on {s.get('device')}")
    one = runs["waves_1"]["summary"]
    row = dict(
        backend=s.get("dist_backend"), world=s.get("world_size"),
        round_ms_median=s.get("round_ms_median"),
        one_rank_round_ms_median=one.get("round_ms_median"),
        gather_ms_median=s.get("collective_ms_median"),
        gather_ms=[s.get("collective_ms_min"), s.get("collective_ms_max")],
        run_s=[runs["waves_1"]["run_s"], runs["waves_2"]["run_s"]],
        rank_hashes_equal=len(set(hashes)) == 1, vs_one_rank=held)
    phase("parallel waves", **row)
    return {"row": row, "problems": problems}


def check_parallel(root: Path) -> dict:
    """Phase 8s: sequence and pipeline parallelism and the wave mesh, each
    deterministic (TF32 off).  (a) dp x sp FedAvg on the T=2048 LM on the
    [1, 2] mesh (two gloo ranks on the card) over 3 rounds, against one
    process with blockwise attention after every round; (b) the CLI's
    --mesh_sequence runner with --attn_flash on the same ranks (K4f in
    its evaluation); (c) --mesh_stages 2 cross-silo on the Shakespeare
    twin, dense and --moe_experts 4, against --mesh_stages 1 every round;
    (d) --algo cross_device --mesh_clients 2 on the FEMNIST CNN against
    the one-rank engine every round.  Ranks byte-equal; a failed p2p op
    or a rank that dies fails the launch and the phase."""
    t_phase = time.perf_counter()
    base = root / "build" / "parallel"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    sp = par_sp(root)
    pp = par_pp(base)
    waves = par_waves(base)
    problems = sp["problems"] + pp["problems"] + waves["problems"]
    if problems:
        fail("phase 8s: " + "; ".join(problems))
    out = {"sp": sp["sp"], "cli": sp["cli"], "pp": pp["runs"],
           "waves": waves["row"], "seconds": time.perf_counter() - t_phase}
    phase("parallel", seconds=out["seconds"], hand_written_kernels=[
        "flash_fwd (the sp CLI run's evaluation)"])
    return out


# ---------------------------------------------------------------------------
# phase 8p: mixed precision (--compute_dtype bfloat16) with K4 in bf16, the
# Switch MoE transformer (--moe_experts), EfficientNet and VGG
# ---------------------------------------------------------------------------

BF16_SHAPES = {                # [B, T, H, d], as the bf16 model calls K4
    "vmap": (8, 2048, 8, 32),      # 4 clients x B=2, the vmap fold
    "d16": (2, 256, 4, 16),        # the other head sizes the kernels take
    "d64": (2, 256, 4, 64),
    "t128": (2, 128, 4, 32),       # one 128 block: the library's one-step form
}
# the bf16 kernels, whose products are wgmma's, and the depth of their
# rings of tiles (kStages in csrc/flash_attention.cu)
K4_WGMMA = ("flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16")
K4_STAGES = 3
BF16_KERNEL_TOL = 2.0 ** -7    # x max|ref|: o, dq, dk, dv (two bf16 ulps at
#                                the top of the range)
BF16_ML_TOL = 1e-5             # x max|ref|: m and l (f32), as the f32
#                                kernels' (a row max near 0 has no useful
#                                relative error: its scores are f32 sums)
BF16_OPS_PER_S = 989.4e12      # H100 SXM data sheet, dense bf16 tensor cores
# a bf16 step on the card against the same step on CPU tensors, relative
# to the step's largest move: max|card - cpu| <= BF16_ROUND_TOL x
# max|cpu - init|, the step moving some weight by more than 10 x ROUND_TOL.
# cuBLAS and the CPU round bf16 products at other places (a bias added
# before or after the output's rounding), and the forward kernel rounds P
# against the running max of its 64-key tile where the plain version uses
# the row's final max; each such difference is one bf16 ulp (2^-8) of an
# activation or gradient.  Relative, because the slices move their
# weights by 0.01 (the LM) to 2.6 (the BatchNorm ResNet) in a step; the
# CPU tests saw the port's bf16 rounds within 1.5% of the JAX package's
BF16_ROUND_TOL = 5e-2
K4_BF16_REPLACES = {f"{k}_bf16": v for k, v in K4_REPLACES.items()}
MOE_EXPERTS = 8                # bench.py's transformer_T2048_moe8 ...
MOE_BLOCK = LM_BENCH_BLOCK     # ... with its blockwise attention (block 256)
LM_PARITY_CLIENTS = 1          # the LM rounds' CPU reference cohort (a
#                                bf16 step of 2 clients took 36 s there)
BF16_PARITY_CLIENTS = 2        # the image rounds' CPU reference cohort
BF16_ROUNDS = 2                # rounds of each image run (steady: round 2)
_BF16 = ["--compute_dtype", "bfloat16"]
_CIFAR = ["--algo", "fedavg", "--dataset", "cifar10",
          "--client_num_in_total", "10", "--client_num_per_round", "10",
          "--batch_size", "64", "--lr", "0.1", "--epochs", "1",
          "--comm_round", str(BF16_ROUNDS), "--frequency_of_the_test",
          "1000", "--log_stdout", "false"]
# (name, CLI args, the BatchNorm model's `bn_models` key or None); a bf16
# run is held at BF16_ROUND_TOL x its move, an f32 one at ROUND_TOL
BF16_IMAGE_RUNS = (
    ("cnn bf16", [*FEDAVG_ARGS, *_BF16, "--comm_round", str(BF16_ROUNDS)],
     None),
    ("resnet56_bn bf16", [*_CIFAR, "--model", "resnet56", *_BF16],
     "resnet56_bn"),
    ("fedavg_robust bf16", [*SLICE_ARGS, *_BF16, "--comm_round",
                            str(BF16_ROUNDS)], None),
    ("efficientnet", [*_CIFAR, "--model", "efficientnet"], None),
    ("vgg11", [*_CIFAR, "--model", "vgg11"], None))


def flash_bf16_bounds(b: int, h: int, t: int, d: int, sm_hz: float):
    """Per bf16 K4 kernel, the least time the card could take (ms): the
    largest of its bytes over 3.35 TB/s (bf16 rows, f32 m, l, di), its
    products over the 989.4 TF/s bf16 tensor-core rate and its exps at
    the SFU's 16 per clock per SM (``obs.device.flash_bf16_work``)."""
    from fedml_tpu_torch.obs.device import flash_bf16_work
    out = {}
    for name, (nbytes, ops, pairs) in flash_bf16_work(b, h, t, d).items():
        terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "bf16": ops / BF16_OPS_PER_S * 1e3,
                 "exp": pairs / (SFU_EXPS_PER_CLOCK * sm_hz) * 1e3}
        term = max(terms, key=terms.get)
        out[name] = dict(bound_ms=terms[term],
                         bound_by="bytes" if term == "bytes"
                         else "operations", bound_term=term,
                         **{f"{k}_ms": v for k, v in terms.items()})
    return out


@contextlib.contextmanager
def bf16_exact_reductions():
    """cuBLAS may not reduce bf16 products in bf16 inside the block (the
    plain versions' products then accumulate in f32, as the kernels'),
    and TF32 is off."""
    import torch
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with tf32_off():
            yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = saved


def check_flash_bf16_kernel(sm_hz: float):
    """Phase 8p, step 1: the bf16 K4f, K4dkv and K4dq against their plain
    versions on the card at BF16_SHAPES (o, dq, dk, dv within
    BF16_KERNEL_TOL x max|ref|; m and l within BF16_ML_TOL x max|ref|), their
    times (CUDA events around a call, which count the wrapper's host work
    too), the wrappers' host µs, the plain versions', the bounds (at the
    SM's maximum clock) and scaled_dot_product_attention's bf16 forward and
    backward at the same shape (a yardstick the port never calls); at the
    vmapped shape also each kernel's and SDPA's forward's device-only time
    from torch.profiler."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from fedml_tpu_torch.models import flash_attention as fa

    rows, worst = {}, dict.fromkeys(K4_BF16_NAMES, 0.0)
    bf = torch.bfloat16
    with bf16_exact_reductions():
        for shape_name, (b, t, h, d) in BF16_SHAPES.items():
            rng = np.random.RandomState(b * 10000 + t + d)
            q, k, v, do = (torch.tensor(rng.randn(b, h, t, d).astype(
                np.float32)).to(CARD).to(bf) for _ in range(4))
            o, m, l = fa.flash_fwd(q, k, v)
            po, pm, pl = fa.flash_fwd_bf16_plain(q, k, v)
            di = (po.float() * do.float()).sum(-1)
            bwd = (q, k, v, do, pm, pl, di)
            dk, dv = fa.flash_bwd_dkv(*bwd)
            pdk, pdv = fa.flash_bwd_dkv_bf16_plain(*bwd)
            dq = fa.flash_bwd_dq(*bwd)
            pdq = fa.flash_bwd_dq_bf16_plain(*bwd)
            sync(CARD)
            errs = {}
            for key, kernel, got, want in (
                    ("o", "flash_fwd_bf16", o, po),
                    ("dk", "flash_bwd_dkv_bf16", dk, pdk),
                    ("dv", "flash_bwd_dkv_bf16", dv, pdv),
                    ("dq", "flash_bwd_dq_bf16", dq, pdq)):
                if got.dtype != bf:
                    fail(f"{kernel}: {key} is {got.dtype}, not bf16")
                err = float((got.float() - want.float()).abs().max())
                limit = BF16_KERNEL_TOL * float(want.float().abs().max())
                errs[key] = err
                worst[kernel] = max(worst[kernel], err)
                if not err <= limit:
                    fail(f"{kernel} {shape_name} {(b, t, h, d)}: {key} max "
                         f"abs err {err} > {limit} ({BF16_KERNEL_TOL} x "
                         f"max|ref|)")
            for key, got, want in (("m", m, pm), ("l", l, pl)):
                err = float((got - want).abs().max())
                errs[key] = err
                limit = BF16_ML_TOL * float(want.abs().max())
                if got.dtype != torch.float32 or not err <= limit:
                    fail(f"flash_fwd_bf16 {shape_name}: {key} ({got.dtype}) "
                         f"max abs err {err} > {limit} ({BF16_ML_TOL} x "
                         f"max|ref|)")
            calls = {
                "flash_fwd_bf16": (lambda: fa.flash_fwd(q, k, v),
                                   lambda: fa.flash_fwd_bf16_plain(q, k, v)),
                "flash_bwd_dkv_bf16": (
                    lambda: fa.flash_bwd_dkv(*bwd),
                    lambda: fa.flash_bwd_dkv_bf16_plain(*bwd)),
                "flash_bwd_dq_bf16": (
                    lambda: fa.flash_bwd_dq(*bwd),
                    lambda: fa.flash_bwd_dq_bf16_plain(*bwd)),
            }
            bounds = flash_bf16_bounds(b, h, t, d, sm_hz)
            row = {"shape_BTHd": [b, t, h, d], "max_abs_err": errs}
            for name, (kernel, plain) in calls.items():
                row[name] = dict(ms=launch_ms(kernel, 20),
                                 plain_ms=launch_ms(plain, 5),
                                 host_us=host_us(kernel, 20),
                                 **bounds[name])
                if shape_name == "vmap":
                    row[name]["device_ms"] = launch_device_ms(
                        kernel, 20, name=f"{name}_kernel")
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True)
            if shape_name == "vmap":
                row["sdpa_fwd_device_ms"] = launch_device_ms(sdpa, 20)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qg, kg, vg,
                                                     is_causal=True)
                torch.autograd.grad(out, (qg, kg, vg), do)

            row["sdpa_fwd_ms"] = launch_ms(sdpa, 20)
            row["sdpa_fwd_bwd_ms"] = launch_ms(sdpa_fwd_bwd, 10)
            row["sdpa_bwd_ms"] = row["sdpa_fwd_bwd_ms"] - row["sdpa_fwd_ms"]
            row["k4_bwd_ms"] = (row["flash_bwd_dkv_bf16"]["ms"]
                                + row["flash_bwd_dq_bf16"]["ms"])
            phase("kernel flash_attention bf16", shape=shape_name, **row)
            rows[shape_name] = row
            del q, k, v, do, qg, kg, vg
    return rows, worst


def lm_bf16_fedavg(data, device: str = None, dtype=None,
                   moe: bool = False, comm_round: int = LM_ROUNDS):
    """FedAvg on bench.py's T=2048 model: the flash model, or with
    ``moe`` the transformer_T2048_moe8 variant (8 Switch experts,
    blockwise attention at block 256), under ``dtype`` (bf16 mixed
    precision, or f32 for None)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.trainer.workload import NWPWorkload
    kw = (dict(moe_experts=MOE_EXPERTS, block_size=MOE_BLOCK) if moe
          else dict(use_flash=True))
    return FedAvg(NWPWorkload(TransformerLM(**LM, dtype=dtype, **kw),
                              compute_dtype=dtype),
                  data, FedAvgConfig(comm_round=comm_round,
                                     frequency_of_the_test=comm_round,
                                     **LM_FEDAVG), device=device or CARD)


def moe_dropped(algo, params, data) -> dict:
    """Tokens the MoE layers drop over capacity on the first client's
    first batch under ``params``: counted inside each layer's forward,
    where its router holds these weights (a forward hook)."""
    import torch
    from fedml_tpu_torch.models.moe import SwitchFFN
    from fedml_tpu_torch.trainer.workload import apply_model
    counts, real = [], []

    def hook(mod, args, kwargs, out):
        mask = kwargs.get("mask")
        counts.append(float(mod.dropped(args[0], mask)))
        real.append(float(mask.sum()))

    model = algo.workload.model
    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in model.modules() if isinstance(m, SwitchFFN)]
    try:
        x = torch.as_tensor(data.train["x"][0, 0]).to(algo.device)
        with torch.no_grad():
            apply_model(model, params, x)
    finally:
        for h in hooks:
            h.remove()
    return dict(dropped_by_layer=counts, real_tokens_by_layer=real,
                dropped_share=sum(counts) / max(sum(real), 1.0))


def parity_row(got, want, init, dtype) -> dict:
    """A card step against the CPU's from ``init``: its difference, its
    largest move, and the limit (BF16_ROUND_TOL x the move under bf16,
    ROUND_TOL in f32); ``ok`` when within it and the step moved."""
    row = dict(max_abs_diff=max_diff(got, want), moved=max_diff(want, init))
    row["tol"] = (BF16_ROUND_TOL * row["moved"] if dtype is not None
                  else ROUND_TOL)
    row["ok"] = (row["max_abs_diff"] <= row["tol"]
                 and row["moved"] > 10 * ROUND_TOL)
    return row


def lm_parity(data, dtype, moe: bool) -> dict:
    """One cohort step of round 0's first LM_PARITY_CLIENTS clients from
    one init on the card and on CPU tensors (cuBLAS without bf16
    reductions, TF32 off), held by `parity_row`."""
    card = lm_bf16_fedavg(data, CARD, dtype, moe, comm_round=1)
    cpu = lm_bf16_fedavg(data, "cpu", dtype, moe, comm_round=1)
    init = cpu.init_params()
    with bf16_exact_reductions():
        got, want, cpu_s = cohort_parity(card, cpu, data, init,
                                         LM_PARITY_CLIENTS)
    row = dict(parity_row(got, want, init, dtype),
               clients=LM_PARITY_CLIENTS, cpu_step_s=cpu_s)
    if not row["ok"]:
        fail(f"the LM step on the card against the CPU's: {row}")
    return row


def image_run(name: str, argv, bn_model, cache: dict) -> dict:
    """One image configuration of phase 8p through the FedAvg API (or the
    defended runner for ``fedavg_robust``): BF16_ROUNDS rounds on the
    card (graphed when the path graphs), every global leaf f32 (a
    stateful model's running statistics too), K1n and K1 once a round on
    the defended path; then round 0's first BF16_PARITY_CLIENTS clients
    as one cohort step on the card and on the CPU from one init,
    deterministic mode, held by `parity_row`."""
    import dataclasses
    import torch
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobust,
                                                          FedAvgRobustConfig)
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (_fedavg_cfg_kwargs,
                                                  check_config)
    from fedml_tpu_torch.trainer.workload import ClassificationWorkload

    t_run = time.perf_counter()
    cfg = config_from_argv(list(argv))
    check_config(cfg)
    cfg = dataclasses.replace(cfg, platform=CARD)
    data = cd_data(cfg, cache)

    def build(device):
        wl = None
        if bn_model is not None:
            wl = ClassificationWorkload(bn_models()[bn_model](), 10,
                                        stateful=True,
                                        compute_dtype=cfg.compute_dtype)
        if cfg.algo != "fedavg_robust":
            return fedavg_algo(cfg, data, device, wl)
        from fedml_tpu_torch.experiments.main import _make_workload
        return FedAvgRobust(
            _make_workload(cfg, data), data, FedAvgRobustConfig(
                defense=cfg.defense, norm_bound=cfg.norm_bound,
                stddev=cfg.stddev, defense_backend=cfg.defense_backend,
                **_fedavg_cfg_kwargs(cfg)), device=device)

    reset_peak()
    fused_agg.reset_launch_counts()
    algo = build(CARD)
    algo.evaluate_global = lambda params: {}
    params = algo.run()
    sync(CARD)
    steady_ms = 1e3 * sum(algo.round_times[1:]) / max(
        len(algo.round_times) - 1, 1)
    graph = getattr(algo._device_round, "graph", None)
    row = dict(compute_dtype=cfg.compute_dtype or "float32",
               params=sum(v.numel() for v in params.values()),
               steady_round_ms=steady_ms, graphed=graph is not None,
               peak_gb=peak_gb(),
               all_leaves_f32=all(v.dtype == torch.float32
                                  for v in params.values()),
               finite=all(bool(v.isfinite().all())
                          for v in params.values()))
    if cfg.algo == "fedavg_robust":
        row["k1_launches"] = fused_agg.launch_counts["robust_agg"]
        row["k1n_launches"] = fused_agg.launch_counts["clip_norm"]
        if row["k1_launches"] != BF16_ROUNDS \
                or row["k1n_launches"] != BF16_ROUNDS:
            fail(f"{name}: K1 launched {row['k1_launches']} and K1n "
                 f"{row['k1n_launches']} times; need {BF16_ROUNDS} each")
    if not row["all_leaves_f32"] or not row["finite"]:
        fail(f"{name}: the global is not f32 and finite: {row}")
    cpu = build("cpu")
    init = cpu.init_params()
    with deterministic():
        got, want, cpu_s = cohort_parity(algo, cpu, data, init,
                                         BF16_PARITY_CLIENTS)
    held = parity_row(got, want, init, cfg.compute_dtype or None)
    row.update(vs_cpu_max_abs_diff=held["max_abs_diff"],
               vs_cpu_tol=held["tol"], moved=held["moved"],
               vs_cpu_clients=BF16_PARITY_CLIENTS, cpu_step_s=cpu_s,
               seconds=time.perf_counter() - t_run)
    phase(f"mixed precision {name}", **row)
    if not held["ok"]:
        fail(f"{name}: the card's step against the CPU's: {held}")
    return row


def check_mixed_precision(data, data_lm, root: Path, sm_hz: float,
                          f32_round_ms: float) -> dict:
    """Phase 8p: the bf16 K4 kernels against their plain versions; bench's
    T=2048 flash transformer under bf16 through the FedAvg API, graphed,
    its K4 bf16 launches counted and one step held against the CPU; the
    transformer_T2048_moe8 variant in bf16 and in f32 (the f32 step held
    against the CPU), its dropped tokens; one bf16 round each of the
    FEMNIST CNN, the BatchNorm ResNet-56 and the defended FedAvg (K1n and
    K1 on f32 leaves), and EfficientNet-B0 and VGG-11 in f32, each held
    against the CPU."""
    import torch
    t_phase = time.perf_counter()
    kernels, worst = check_flash_bf16_kernel(sm_hz)
    bf = torch.bfloat16
    launches, per_round, lm, _ = run_lm_slice(
        data_lm, root, algo=lm_bf16_fedavg(data_lm, dtype=bf),
        names=K4_BF16_NAMES, label="transformer bf16")
    lm["vs_f32_slice_round_ms"] = f32_round_ms
    lm["vs_cpu"] = lm_parity(data_lm, bf, False)
    phase("transformer bf16 vs cpu", **lm["vs_cpu"])
    moe = {}
    for label, dtype in (("bf16", bf), ("f32", None)):
        algo = lm_bf16_fedavg(data_lm, dtype=dtype, moe=True)
        _, _, row, params = run_lm_slice(data_lm, root, algo=algo, names=(),
                                         label=f"transformer moe8 {label}")
        row.update(moe_dropped(algo, params, data_lm))
        phase(f"transformer moe8 {label} dropped", **row)
        moe[label] = row
    moe["f32"]["vs_cpu"] = lm_parity(data_lm, None, True)
    phase("transformer moe8 f32 vs cpu", **moe["f32"]["vs_cpu"])
    from fedml_tpu_torch.experiments.config import config_from_argv
    femnist = config_from_argv(SLICE_ARGS)      # the twin main() loaded
    cache = {(femnist.dataset, femnist.client_num_in_total,
              femnist.batch_size, femnist.seed): data}
    images = {}
    for name, argv, bn_model in BF16_IMAGE_RUNS:
        images[name] = image_run(name, argv, bn_model, cache)
    seconds = time.perf_counter() - t_phase
    phase("mixed precision done", seconds=seconds)
    return dict(kernels=kernels, worst=worst, launches=launches,
                per_round=per_round, lm=lm, moe=moe, images=images,
                seconds=seconds)


# ---------------------------------------------------------------------------
# phase 8q: serving — the live cross-silo slice published through the
# release gate into a hot-swap registry behind the HTTP frontend (K2 on the
# path), the poisoned cross-device round contained, continuous-batching
# decode of the long-context LM as one CUDA-graph step
# ---------------------------------------------------------------------------

SERVE_ROUNDS = 3
SERVE_POOL_ROUNDS = 2
SERVE_POOL_WORKERS = 2
SERVE_CLIENTS = 4              # threads POSTing test rows through the run
SERVE_TOL = 1e-4               # x max|y|: an answer vs the CPU forward
SERVE_EVAL_TOL = 1e-3          # card vs CPU held-out accuracy of a version
SERVE_ARGS = [*SILO_ARGS, "--release_gate", "true"]
# the CNN's first globals move most shadow argmaxes from one round to the
# next (the gate rolls them back at the default budget of 0.1, as run
# (a)'s frontend shows), so the pool's run opens the shadow budget: its
# versions then swap live under the workers' load, still gated on eval
SERVE_POOL_ARGS = ["--release_divergence_budget", "1.0"]
# the JAX package's poisoned fixture (tests/test_release.py), from the
# JAX engine's own init carried in a file (tests/test_torch_release.py
# writes it and holds it to JAX's), so the verdicts are JAX's on any host:
# the shadow divergences of versions 2-4 from version 1 that the JAX
# package reads on that fixture (budget 0.1)
CONTAIN_INIT = Path(__file__).resolve().parent / "tests" / "data" / \
    "release_fixture_init.npz"
CONTAIN_JAX_DIVERGENCE = {2: 0.46875, 3: 0.46875, 4: 0.484375}
CONTAIN = dict(comm_round=4, client_num_per_round=12, epochs=1,
               batch_size=4, wave_size=6, seed=0, frequency_of_the_test=10,
               wave_adversary="3:0:scale:1000000", admission="off")
CONTAIN_SHADOW = 64
CONTAIN_BUDGET = 0.1
DECODE_LM = dict(LM)           # bench.py's long-context width
DECODE_SLOTS, DECODE_CACHE = 8, 2048
DECODE_REQUESTS, DECODE_PROMPT = 96, 4
DECODE_LONG, DECODE_SHORT = 44, 4   # max_new of every 4th request / rest
DECODE_SWAP_AT = 60            # the step after which version 1 publishes
DECODE_TOL = 1e-4              # x max|logit|: a step vs the full forward
SERVE_DIR = Path(__file__).resolve().parent / "build" / "serving"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_post(conn, x):
    conn.request("POST", "/predict", json.dumps({"x": x.tolist()}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


class TrafficThreads:
    """``SERVE_CLIENTS`` keep-alive client threads POSTing ``rows`` to
    ``/predict`` until stopped (each answer kept as (row, status,
    version, y, shed reason or error, seconds); a connection error as
    status ``"error"`` with its text), and one thread polling
    ``/version``."""

    def __init__(self, port: int, rows):
        import threading
        self.port, self.rows = port, rows
        self.stop_event = threading.Event()
        self.answers = [[] for _ in range(SERVE_CLIENTS)]
        self.versions = []
        self.threads = [threading.Thread(target=self._client, args=(t,),
                                         daemon=True)
                        for t in range(SERVE_CLIENTS)]
        self.threads.append(threading.Thread(target=self._poll, daemon=True))

    def _conn(self):
        import http.client
        return http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=30)

    def _client(self, t: int) -> None:
        conn, k = self._conn(), t
        while not self.stop_event.is_set():
            i = k % len(self.rows)
            k += SERVE_CLIENTS
            t0 = time.perf_counter()
            try:
                status, body = serve_post(conn, self.rows[i])
            except (OSError, ValueError) as e:
                conn.close()
                conn = self._conn()
                self.answers[t].append((i, "error", None, None, repr(e),
                                        None))
                continue
            self.answers[t].append((i, status, body.get("version"),
                                    body.get("y"),
                                    body.get("reason", body.get("error")),
                                    time.perf_counter() - t0))
            if status != 200:
                time.sleep(0.005)    # no model yet, or shed: back off
        conn.close()

    def _poll(self) -> None:
        conn = self._conn()
        while not self.stop_event.wait(0.05):
            try:
                conn.request("GET", "/version")
                body = json.loads(conn.getresponse().read())
            except (OSError, ValueError):
                conn.close()
                conn = self._conn()
                continue
            self.versions.append(body["version"])
        conn.close()

    def start(self) -> None:
        for th in self.threads:
            th.start()

    def stop(self) -> bool:
        """Stop and join the threads; whether one is stuck."""
        self.stop_event.set()
        for th in self.threads:
            th.join(timeout=60)
        return any(th.is_alive() for th in self.threads)


def traffic_main() -> None:
    """The client side in a process of its own (its threads' JSON and
    HTTP work must not share the served process's interpreter lock):
    ``(port, rows)`` pickled on stdin, then any byte to stop; the
    answers, the ``/version`` readings and whether a thread stuck
    pickled on stdout."""
    import pickle
    port, rows = pickle.load(sys.stdin.buffer)
    traffic = TrafficThreads(port, rows)
    traffic.start()
    sys.stdin.buffer.read(1)
    stuck = traffic.stop()
    pickle.dump((traffic.answers, traffic.versions, stuck),
                sys.stdout.buffer)
    sys.stdout.buffer.flush()


class ServeTraffic:
    """`traffic_main` in a child process for the block's duration;
    ``answers`` and ``versions`` after it."""

    def __init__(self, port: int, rows):
        self._args = (port, rows)

    def __enter__(self):
        import pickle
        self._proc = subprocess.Popen(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.traffic_main()"],
            cwd=str(Path(__file__).resolve().parent),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self._proc.stdin.write(pickle.dumps(self._args))
        self._proc.stdin.flush()
        return self

    def __exit__(self, *exc):
        import pickle
        try:
            self._proc.stdin.write(b"s")
            self._proc.stdin.close()
            out = self._proc.stdout.read()
            self._proc.wait(timeout=120)
        finally:
            if self._proc.poll() is None:
                self._proc.kill()
                self._proc.wait()
        if self._proc.returncode != 0:
            fail(f"serve: the client process exited "
                 f"{self._proc.returncode}")
        self.answers, self.versions, stuck = pickle.loads(out)
        if stuck:
            fail("serve: a client thread did not stop")


def serve_fed(data, rounds: int, workers: int, device: str,
              extra=()):
    """The live cross-silo slice (S=4, K2 on, clip 5, sigma 0.025) on
    ``device`` behind the release-gated frontend on a free port with
    ``workers`` accept loops.  Every version the registry takes is kept
    on the host (``fed.published``), every shadow snapshot the gate takes
    is recorded as it read it (``fed.shadow_seen``; the request threads
    keep adding rows meanwhile), and every reading of the gate's clock is
    logged (``fed.clock_reads``)."""
    argv = [*SERVE_ARGS, *extra, "--serve_port", str(free_port()),
            "--serve_workers", str(workers),
            "--run_dir", str(SERVE_DIR)]      # the release journal
    fed = live_fed(live_cfg(argv, rounds, device), data)
    serving = fed.serving
    fed.published, fed.shadow_seen, fed.clock_reads = {}, [], []
    fed.offer_ms = []
    real_publish, real_offer = serving.registry.publish, serving.release.offer
    real_snapshot = serving.shadow.snapshot

    def clock():
        fed.clock_reads.append(time.monotonic())
        return fed.clock_reads[-1]

    serving.release.clock = clock

    def publish(params, version, canary=False):
        fed.published[int(version)] = _flat_host(params)
        return real_publish(params, version, canary=canary)

    def snapshot():
        rows = real_snapshot()
        fed.shadow_seen.append([r.copy() for r in rows])
        return rows

    def offer(params, version, round_idx=None):
        t0 = time.perf_counter()
        try:
            return real_offer(params, version, round_idx=round_idx)
        finally:
            fed.offer_ms.append(1e3 * (time.perf_counter() - t0))

    serving.registry.publish = publish
    serving.release.offer = offer
    serving.shadow.snapshot = snapshot
    return fed


def serve_replay_cpu(data, rounds: int, workers: int, card, extra=()):
    """The same run on the CPU, from the same init: its gate read the
    shadow rows the card's read, snapshot by snapshot, and the card's
    clock (a cooldown refuses the same offers).  Returns its verdicts."""
    fed = serve_fed(data, rounds, workers, "cpu", extra)
    release = fed.serving.release
    snapshots = iter(card.shadow_seen)
    reads = iter(card.clock_reads)
    release.clock = lambda: next(reads)
    fed.serving.shadow.snapshot = lambda: next(snapshots)
    try:
        live_drive(fed)
    finally:
        fed.serving.stop()
    return release.verdicts


def verdict_rows(verdicts):
    """(version, decision, failed signals, shadow divergence) a verdict;
    a cooldown refusal has no signals."""
    return [(v["version"], v["decision"], v.get("failed_signals"),
             v.get("signals", {}).get("shadow", {}).get("divergence"))
            for v in verdicts]


def serve_answers_check(traffic, fed, rows, label: str) -> dict:
    """Every answer a 200, a 429 with a named shed reason or a 503 shed
    for want of a model (counted by status and reason; a connection
    error, a 500, a 400, a 503 timeout or any other answer fails); each
    200 within SERVE_TOL x max|y| of the CPU forward under the version
    it names; per client, versions never going down; the versions named
    all promoted."""
    import numpy as np
    import torch
    from fedml_tpu_torch.experiments.models import (create_workload,
                                                    sample_shape_of)
    from fedml_tpu_torch.serve.batcher import SHED_REASONS
    from fedml_tpu_torch.serve.registry import module_apply
    data, cfg = fed.data, fed.cfg
    apply_fn = module_apply(create_workload(
        cfg.model, cfg.dataset, data.class_num,
        sample_shape_of(data)).model)
    promoted = {v["version"] for v in fed.serving.release.verdicts
                if v.get("decision") == "promote"}
    by_version, statuses, lat = {}, {}, []
    for t, answers in enumerate(traffic.answers):
        last = -1
        for i, status, version, y, reason, dt in answers:
            key = "200" if status == 200 else f"{status} {reason}"
            statuses[key] = statuses.get(key, 0) + 1
            if status != 200:
                if not ((status == 429 and reason in SHED_REASONS
                         and reason != "no_model")
                        or (status == 503 and reason == "no_model")):
                    fail(f"{label}: client {t} got {key} for row {i}")
                continue
            lat.append(dt)
            if version < last:
                fail(f"{label}: client {t} saw version {version} after "
                     f"{last}")
            if version not in promoted:
                fail(f"{label}: an answer from version {version}, never "
                     f"promoted ({sorted(promoted)})")
            last = version
            by_version.setdefault(version, []).append((i, y))
    if not lat:
        fail(f"{label}: no request was answered ({statuses})")
    worst = 0.0
    for version, got in by_version.items():
        params = {k: torch.as_tensor(v)
                  for k, v in fed.published[version].items()}
        with torch.no_grad():
            ref = apply_fn(params, torch.as_tensor(
                rows[[i for i, _ in got]])).numpy()
        y = np.asarray([g for _, g in got], np.float32)
        err = np.abs(y - ref).max(axis=1) / np.abs(ref).max(axis=1)
        worst = max(worst, float(err.max()))
        if err.max() > SERVE_TOL:
            fail(f"{label}: an answer of version {version} is "
                 f"{err.max():.3g} x max|y| from the CPU forward")
    lat_ms = sorted(1e3 * d for d in lat)
    return {"answers": len(lat_ms), "statuses": statuses,
            "versions_answered": sorted(by_version),
            "max_rel_err_vs_cpu": worst,
            "p50_ms": lat_ms[len(lat_ms) // 2],
            "p99_ms": lat_ms[min(len(lat_ms) - 1,
                                 int(0.99 * len(lat_ms)))]}


def _flat_host(tree):
    """A params tree (nested or flat, numpy or tensors) as a flat dict of
    host copies."""
    import numpy as np
    from fedml_tpu_torch.core.pytree import flatten_nested
    return {k: v.detach().cpu().numpy().copy() if hasattr(v, "detach")
            else np.array(v) for k, v in flatten_nested(tree).items()}


def serve_run(data, rounds: int, workers: int, label: str,
              extra=()) -> dict:
    """Phase 8q (a): one serve-while-train run on the card under client
    traffic, its checks, and the same run on the CPU for the verdicts."""
    import numpy as np
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.obs import telemetry
    telemetry.enable()
    try:
        fed = serve_fed(data, rounds, workers, CARD, extra)
        # 512 test rows: the first 8 of each of 64 clients
        rows = np.asarray(data.test["x"])[:64, 0, :8].reshape(
            -1, *data.test["x"].shape[3:])
        fused_agg.reset_launch_counts()
        try:
            with ServeTraffic(fed.serving.port, rows) as traffic:
                t0 = time.perf_counter()
                live_drive(fed)
                drive_s = time.perf_counter() - t0
                time.sleep(0.2)      # a last poll of the final version
        finally:
            fed.serving.stop()
        launches = fused_agg.launch_counts["shard_finalize"]
        counters = telemetry.get_registry().snapshot()["counters"]
    finally:
        telemetry.disable()
    if launches != 4 * rounds:
        fail(f"{label}: shard_finalize launched {launches} times, need "
             f"exactly {4 * rounds} (4 shards x {rounds} rounds)")
    verdicts = fed.serving.release.verdicts
    promoted = [v["version"] for v in verdicts
                if v.get("decision") == "promote"]
    if not promoted:
        fail(f"{label}: no version was promoted")
    out = serve_answers_check(traffic, fed, rows, label)
    seen = [v for v in traffic.versions if v is not None]
    if not seen or seen[-1] != promoted[-1] or seen != sorted(seen):
        fail(f"{label}: /version read {seen[-5:]}, need it advancing to "
             f"the last promoted version {promoted[-1]}")
    cpu = serve_replay_cpu(data, rounds, workers, fed, extra)
    if verdict_rows(verdicts) != verdict_rows(cpu):
        fail(f"{label}: the card's verdicts {verdict_rows(verdicts)} "
             f"differ from the CPU's {verdict_rows(cpu)}")
    scores = [(v["signals"]["eval"]["score"], c["signals"]["eval"]["score"])
              for v, c in zip(verdicts, cpu) if "signals" in v]
    eval_diff = max(abs(a - b) for a, b in scores)
    if eval_diff > SERVE_EVAL_TOL:
        fail(f"{label}: held-out accuracy card vs CPU {scores}")
    sheds = {k.split("{", 1)[1].rstrip("}"): v for k, v in counters.items()
             if k.startswith("fedml_serve_shed_total") and v}
    round_ms = [1e3 * dt for _, dt, _ in fed.closed]
    out["answers_per_s"] = out["answers"] / drive_s
    return {**out, "k2_launches": launches, "rounds": rounds,
            "gate_offer_ms": fed.offer_ms,
            "workers": workers, "extra_flags": list(extra),
            "verdicts": verdict_rows(verdicts),
            "decisions": [v["decision"] for v in verdicts],
            "eval_card_vs_cpu": scores, "promoted": promoted,
            "version_polls": len(seen), "sheds": sheds,
            "round_ms": round_ms,
            "steady_round_ms": statistics.median(round_ms[1:] or round_ms)}


def serve_containment(device: str):
    """Phase 8q (b): the cross-device engine on the JAX package's poisoned
    fixture from JAX's init, every round offered to the gate with 64 test
    rows as shadow traffic; the verdicts and the registry after the
    run."""
    import numpy as np
    import torch
    from fedml_tpu_torch.algorithms.cross_device import (CrossDevice,
                                                         CrossDeviceConfig)
    from fedml_tpu_torch.data import load_data
    from fedml_tpu_torch.experiments.models import (create_workload,
                                                    sample_shape_of)
    from fedml_tpu_torch.serve import (ModelRegistry, ReleaseController,
                                       ShadowSampler)
    from fedml_tpu_torch.serve.registry import module_apply
    data = load_data("mnist", batch_size=4, num_clients=24, seed=0)
    wl = create_workload("lr", "mnist", data.class_num,
                         sample_shape_of(data))
    reg = ModelRegistry(module_apply(wl.model), history=8, device=device)
    shadow = ShadowSampler(every=1, slots=CONTAIN_SHADOW)
    xt = np.asarray(data.test["x"])
    for row in xt.reshape(-1, xt.shape[-1])[:CONTAIN_SHADOW]:
        shadow.offer(row)
    rc = ReleaseController(reg, shadow=shadow,
                           divergence_budget=CONTAIN_BUDGET,
                           cooldown_s=0.0, max_cooldown_s=0.0)
    live = []

    def publish(params, version):
        rc.offer(params, version, round_idx=version - 1)
        live.append(reg.version)

    with np.load(CONTAIN_INIT) as f:
        init = {k: torch.as_tensor(f[k]).to(device) for k in f.files}
    CrossDevice(wl, data, CrossDeviceConfig(**CONTAIN), device=device,
                publish=publish).run(params=init)
    return rc.verdicts, reg, live


def check_containment() -> dict:
    card, reg, live = serve_containment(CARD)
    cpu, _, _ = serve_containment("cpu")
    if verdict_rows(card) != verdict_rows(cpu):
        fail(f"containment: the card's verdicts {verdict_rows(card)} "
             f"differ from the CPU's {verdict_rows(cpu)}")
    got = {v: d for v, _, _, d in verdict_rows(card) if d is not None}
    if got != CONTAIN_JAX_DIVERGENCE:
        fail(f"containment: shadow divergences {got}, the JAX package's "
             f"on the fixture are {CONTAIN_JAX_DIVERGENCE}")
    poisoned = card[-1]
    if poisoned["version"] != 4 or poisoned["decision"] != "rollback" \
            or poisoned.get("failed_signals") != ["shadow"]:
        fail(f"containment: version 4's verdict {verdict_rows(card)[-1]}")
    if 4 in reg.versions() or 4 in live \
            or any(v.get("live_version") == 4 for v in card):
        fail("containment: the poisoned version 4 went live")
    return {"verdicts": verdict_rows(card), "live_after_each": live,
            "live": reg.version}


def decode_requests():
    import numpy as np
    rng = np.random.RandomState(0)
    return [([int(t) for t in rng.randint(1, DECODE_LM["vocab_size"],
                                          DECODE_PROMPT)],
             DECODE_LONG if i % 4 == 0 else DECODE_SHORT)
            for i in range(DECODE_REQUESTS)]


def decode_run(model, params, continuous: bool, graph: bool,
               record: bool, swap=None) -> dict:
    """One scheduler over all ``decode_requests()`` (queued before the
    worker starts, so the admission order is fixed): results, the step
    times, and with ``record`` each live slot's logits a step; ``swap``
    publishes version 1 right after step ``DECODE_SWAP_AT``."""
    import torch
    from fedml_tpu_torch.serve import DecodeScheduler, ModelRegistry
    reg = ModelRegistry(lambda p, x: x, history=4, device=CARD)
    reg.publish(params, 0)
    sched = DecodeScheduler(reg, model, slots=DECODE_SLOTS,
                            cache_len=DECODE_CACHE, max_new=DECODE_LONG,
                            continuous=continuous, graph=graph)
    if not sched.warmup():
        fail("decode: warmup found no model")
    reqs = decode_requests()
    futs = [sched.submit(p, max_new=m) for p, m in reqs]
    index = {id(f): k for k, f in enumerate(futs)}
    real, times, rec = sched._step_fn, [], []

    def step(tokens, positions):
        t0 = time.perf_counter()
        out = real(tokens, positions)
        times.append(time.perf_counter() - t0)
        if record:
            live = [i for i, s in enumerate(sched._slots) if s is not None]
            logits = sched._step.logits[live].cpu()
            for j, i in enumerate(live):
                rec.append((index[id(sched._slots[i].req.future)],
                            int(positions[i]), logits[j]))
        if swap is not None and len(times) == DECODE_SWAP_AT:
            reg.publish(swap, 1)
        return out

    sched._step_fn = step
    t0 = time.perf_counter()
    sched.start()
    results = [f.result(600) for f in futs]
    wall = time.perf_counter() - t0
    sched.stop()
    torch.cuda.synchronize()
    tokens = sum(len(r.tokens) for r in results)
    return {"results": results, "rec": rec, "captures": sched._cache_size(),
            "steps": sched.steps, "occupancy": sched.occupancy(),
            "step_ms": 1e3 * statistics.median(times),
            "tokens_per_s": tokens / wall, "wall_s": wall,
            "tokens": tokens}


def decode_reference(model, versions, run) -> dict:
    """Every recorded step's logits against the dense full forward on the
    card under the version its request names, for the same prefix; the
    tokens against greedy decoding by that forward (a mismatch allowed,
    and listed, only where its top-2 gap is under the limit)."""
    import torch
    from fedml_tpu_torch.trainer.workload import apply_model
    reqs = decode_requests()
    by_req = {}
    for k, pos, logits in run["rec"]:
        by_req.setdefault(k, {})[pos] = logits
    worst, near_ties = 0.0, []
    for k, (prompt, _) in enumerate(reqs):
        r = run["results"][k]
        seq = prompt + r.tokens[:-1]
        with torch.no_grad():
            full = apply_model(model, versions[r.version], torch.tensor(
                [seq], device=CARD))[0].cpu()
        rows = by_req.get(k, {})
        if sorted(rows) != list(range(len(seq))):
            fail(f"decode: request {k} stepped positions {sorted(rows)}")
        for pos, logits in rows.items():
            ref = full[pos]
            scale = float(ref.abs().max())
            err = float((logits - ref).abs().max()) / scale
            worst = max(worst, err)
            if err > DECODE_TOL:
                fail(f"decode: request {k} position {pos} is {err:.3g} x "
                     f"max|logit| from the full forward")
        for j, tok in enumerate(r.tokens):
            ref = full[len(prompt) - 1 + j]
            want = int(torch.argmax(ref))
            if tok != want:
                top2 = torch.topk(ref, 2).values
                gap = float(top2[0] - top2[1])
                if gap >= DECODE_TOL * float(ref.abs().max()):
                    fail(f"decode: request {k} token {j} is {tok}, the "
                         f"full forward's greedy {want} (gap {gap:.3g})")
                near_ties.append((k, j, tok, want, gap))
    return {"max_rel_err_vs_full": worst, "near_ties": near_ties}


def check_decode() -> dict:
    """Phase 8q (c): continuous-batching decode at the long-context
    width, graphed, against the full forward, the eager step and the
    drain baseline."""
    import torch
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.trainer.workload import NWPWorkload
    model = TransformerLM(**DECODE_LM)
    wl = NWPWorkload(model)
    versions = {v: wl.init(torch.Generator().manual_seed(v), CARD)
                for v in (0, 1)}
    torch.cuda.reset_peak_memory_stats()
    with tf32_off():
        graphed = decode_run(model, versions[0], True, True, True,
                             swap=versions[1])
        if graphed["captures"] != 1:
            fail(f"decode: {graphed['captures']} captures, need exactly 1 "
                 f"across the hot swap")
        got = sorted({r.version for r in graphed["results"]})
        if got != [0, 1]:
            fail(f"decode: the hot swap left results of versions {got}")
        ref = decode_reference(model, versions, graphed)
        eager = decode_run(model, versions[0], True, False, True,
                           swap=versions[1])
        same = (len(eager["rec"]) == len(graphed["rec"]) and all(
            a[:2] == b[:2] and torch.equal(a[2], b[2])
            for a, b in zip(graphed["rec"], eager["rec"])))
        if not same:
            fail("decode: the graphed step's logits are not bit-equal to "
                 "the eager step's")
        cont = decode_run(model, versions[0], True, True, False)
        drain = decode_run(model, versions[0], False, True, False)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if [r.tokens for r in cont["results"]] \
            != [r.tokens for r in drain["results"]]:
        fail("decode: drain mode decoded other tokens than continuous")
    for label, r in (("continuous", cont), ("drain", drain)):
        print(f"decode {label}: {r['steps']} steps, occupancy "
              f"{r['occupancy']:.3f}, {r['tokens_per_s']:.1f} tokens/s",
              flush=True)
    return {**ref, "captures": graphed["captures"],
            "swap_versions": [0, 1], "graph_bit_equal_eager": same,
            "step_ms": {"graph": cont["step_ms"],
                        "eager": eager["step_ms"]},
            "tokens_per_s": {"continuous": cont["tokens_per_s"],
                             "drain": drain["tokens_per_s"]},
            "occupancy": {"continuous": cont["occupancy"],
                          "drain": drain["occupancy"]},
            "steps": {"continuous": cont["steps"], "drain": drain["steps"]},
            "tokens": cont["tokens"], "peak_gb": peak_gb}


def check_serving(data) -> dict:
    """Phase 8q: serve-while-train (the frontend, then the pool) behind
    the release gate with K2 on the path, the poisoned round contained,
    continuous-batching decode."""
    t_phase = time.perf_counter()
    out = {}
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    with tf32_off():
        off = live_fed(live_cfg(SILO_ARGS, SERVE_ROUNDS), data)
        live_drive(off)
        off_ms = [1e3 * dt for _, dt, _ in off.closed]
        out["frontend"] = serve_run(data, SERVE_ROUNDS, 1, "serve")
        out["pool"] = serve_run(data, SERVE_POOL_ROUNDS, SERVE_POOL_WORKERS,
                                "serve pool", SERVE_POOL_ARGS)
        out["serving_off_round_ms"] = off_ms
        out["serving_off_steady_round_ms"] = statistics.median(
            off_ms[1:] or off_ms)
        out["containment"] = check_containment()
    out["decode"] = check_decode()
    out["seconds"] = time.perf_counter() - t_phase
    phase("serving", **out)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 8t: dropout keys through the stateful and live runners, serving a
# PipelineLM, tensor and expert parallelism over torch.distributed
# ---------------------------------------------------------------------------

# (a) the keyed runners on the FEMNIST dropout CNN (CNNDropOut), card
# against CPU after every round (their masks are hashed from the keys, so
# the same on both)
KEYED_COMMON = ["--model", "cnn", "--dataset", "femnist",
                "--client_num_in_total", "40", "--client_num_per_round", "4",
                "--batch_size", "20", "--lr", "0.1", "--epochs", "1",
                "--comm_round", "2", "--frequency_of_the_test", "1000",
                "--deterministic", "true", "--checkpoint_every", "1",
                "--checkpoint_keep_last_n", "8", "--log_stdout", "false"]
KEYED_RUNS = {"ditto": ["--algo", "ditto", "--ditto_lambda", "0.1"],
              "cross_silo": ["--algo", "cross_silo", "--silo_backend",
                             "local"]}
KEYED_TOL = ROUND_TOL          # every round, card vs CPU (f32, TF32 off)
# (b) --serve_port with --mesh_stages 2 on the Shakespeare twin: each
# closed round's /predict answer against the CPU forward of that round's
# published tree
PP_SERVE_ARGS = ["--algo", "cross_silo", "--silo_backend", "local",
                 "--model", "transformer", "--dataset", "shakespeare",
                 "--client_num_in_total", "8", "--client_num_per_round", "2",
                 "--batch_size", "4", "--lr", "1.0", "--comm_round", "2",
                 "--mesh_stages", "2", "--frequency_of_the_test", "1000",
                 "--deterministic", "true", "--log_stdout", "false"]
PP_SERVE_TOL = 1e-5            # x max|logit|: an answer vs the CPU forward
# (c), (d): the T=2048 LM with K4, dp x tp on [1, 2] (the model axis: 4 of
# the 8 heads a rank) and dp x ep moe8 on [1, 2] (4 of the 8 experts a
# rank), two gloo ranks sharing the card; one process as reference, its
# clients one after another as on the ranks
TP_ROUNDS = 3
EP_ROUNDS = 2
TP_SEED = 0
TP_TOL = MESH_TOL              # x max|w|, every round against one process
TP_RUNS = {"tp": {}, "ep": {"moe_experts": MOE_EXPERTS}}


def keyed_run(name: str, argv, base: Path, platform) -> dict:
    """One keyed run's summary, checkpointed globals, the keyed trainer
    calls it made (`core.prng.step_keys`, where every keyed trainer's
    chain starts) and its seconds."""
    from fedml_tpu_torch.core import prng
    tag = f"{name}_{platform}"
    shutil.rmtree(base / tag, ignore_errors=True)
    real, calls = prng.step_keys, []

    def counted(keys, n):
        calls.append(int(keys.shape[0]))
        return real(keys, n)

    prng.step_keys = counted
    t0 = time.perf_counter()
    try:
        summary = par_main([*argv, *KEYED_COMMON, "--checkpoint_dir",
                            str(base / tag), "--platform", platform],
                           base / f"{tag}.log")
    finally:
        prng.step_keys = real
    return dict(summary=summary, rounds=mesh_globals(base / tag),
                keyed_calls=len(calls), run_s=time.perf_counter() - t0)


def tp_keyed(base: Path) -> dict:
    """8t (a): ditto and cross_silo on the dropout CNN, card and CPU."""
    out, problems = {}, []
    for name, argv in KEYED_RUNS.items():
        card = keyed_run(name, argv, base, CARD)
        cpu = keyed_run(name, argv, base, "cpu")
        # an absolute limit every round, as every f32 round against the CPU
        held = dict(max_abs_diff=[], limit=KEYED_TOL)
        if card["rounds"] is None or cpu["rounds"] is None \
                or len(card["rounds"]) != len(cpu["rounds"]):
            problems.append(f"keyed {name}: globals missing or a round "
                            f"short")
        else:
            held["max_abs_diff"] = [max_diff(a, b) for a, b in
                                    zip(card["rounds"], cpu["rounds"])]
            problems += [f"keyed {name} round {r}: {d} > {KEYED_TOL}"
                         for r, d in enumerate(held["max_abs_diff"])
                         if not d <= KEYED_TOL]
        if not card["keyed_calls"]:
            problems.append(f"keyed {name}: the trainers took no key")
        if not card["summary"].get("params_finite"):
            problems.append(f"keyed {name}: a global is not finite")
        row = dict(keyed_calls=card["keyed_calls"],
                   round_ms_median=card["summary"].get("round_ms_median"),
                   train_loss=card["summary"].get("train_loss"),
                   run_s=[card["run_s"], cpu["run_s"]], vs_cpu=held)
        phase(f"tp_ep keyed {name}", **row)
        out[name] = row
    return {"runs": out, "problems": problems}


def pp_serve_check(answers, refs, tol: float) -> list:
    """The problems of the pipeline's /predict answers: each must be a 200
    with its round's version and logits within ``tol`` x max|logit| of the
    CPU forward of that version's tree."""
    import numpy as np
    problems = []
    if len(answers) != len(refs) or not answers:
        return [f"pp serve: {len(answers)} answers for {len(refs)} "
                f"published rounds"]
    for v, ((status, body), ref) in enumerate(zip(answers, refs)):
        if status != 200 or body.get("version") != v:
            problems.append(f"pp serve round {v}: {status} "
                            f"{str(body)[:120]}")
            continue
        got = np.asarray(body["y"], np.float64)
        limit = tol * float(np.abs(ref).max())
        diff = float(np.abs(got - ref).max()) if got.shape == ref.shape \
            else float("inf")
        if not diff <= limit:
            problems.append(f"pp serve round {v}: {diff} > {limit}")
    return problems


def tp_pp_serve(base: Path) -> dict:
    """8t (b): the 2-stage PipelineLM served while it trains; each closed
    round's /predict over HTTP against the CPU forward of its tree."""
    import http.client
    import numpy as np
    import torch
    from fedml_tpu_torch.core.pytree import flatten_nested
    from fedml_tpu_torch.experiments import main as t_main
    from fedml_tpu_torch.experiments.config import config_from_argv
    answers, published = [], []
    real = t_main.ServeWhileTrain.publish

    def publish(self, params, version):
        real(self, params, version)
        published.append(({k: torch.as_tensor(np.asarray(
            v.detach().cpu() if torch.is_tensor(v) else v)).clone()
            for k, v in flatten_nested(params).items()},
            np.asarray(self._sample_x)))
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=60)
        t0 = time.perf_counter()
        conn.request("POST", "/predict", json.dumps(
            {"x": np.asarray(self._sample_x).tolist(),
             "deadline_ms": 60000}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        answers.append((resp.status, json.loads(resp.read())))
        answer_ms.append(1e3 * (time.perf_counter() - t0))
        conn.close()

    answer_ms = []
    t_main.ServeWhileTrain.publish = publish
    t0 = time.perf_counter()
    try:
        summary = par_main([*PP_SERVE_ARGS, "--serve_port",
                            str(free_port())], base / "pp_serve.log")
    finally:
        t_main.ServeWhileTrain.publish = real
    run_s = time.perf_counter() - t0
    cfg = config_from_argv(PP_SERVE_ARGS + ["--platform", "cpu"])
    data = t_main.load_experiment_data(cfg)
    plm = t_main.silo_workload(cfg, data, "cpu").model
    refs = []
    with torch.no_grad():
        for params, x in published:
            refs.append(plm.apply_seq(params, torch.as_tensor(x)[None])
                        [0].double().numpy())
    problems = pp_serve_check(answers, refs, PP_SERVE_TOL)
    if summary.get("stage_devices") != ",".join(
            [CARD if CARD == "cpu" else "cuda:0"] * 2):
        problems.append(f"pp serve: stages {summary.get('stage_devices')}")
    row = dict(statuses=[s for s, _ in answers],
               versions=[b.get("version") for _, b in answers],
               answer_ms=answer_ms, stage_devices=summary.get("stage_devices"),
               round_ms_median=summary.get("round_ms_median"), run_s=run_s,
               max_abs_diff=[float(np.abs(np.asarray(b["y"]) - r).max())
                             for (s, b), r in zip(answers, refs)
                             if s == 200],
               limit=[PP_SERVE_TOL * float(np.abs(r).max()) for r in refs])
    phase("tp_ep pp serve", **row)
    return {"row": row, "problems": problems}


def tp_model(kind: str):
    from fedml_tpu_torch.models import TransformerLM
    return TransformerLM(**LM, use_flash=True, **TP_RUNS[kind])


def tp_rounds(algo, params, rounds: int, mesh=None) -> dict:
    """``rounds`` host-loop rounds of ``algo`` from ``params``: each
    round's globals, its ms, its collective ms (all, and the tp layers'),
    its K4 launches (the wrappers' counts, reset before each round) and
    the peak GB."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    from fedml_tpu_torch.models import flash_attention as fa
    out = {"rounds": [], "round_ms": [], "collective_ms": [], "tp_ms": [],
           "k4_launches": []}
    device = mesh.device if mesh is not None else torch.device(CARD)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with deterministic():
        for r in range(rounds):
            c0 = mesh.collective_ms() if mesh is not None else 0.0
            t0 = mesh.collective_ms("tp") if mesh is not None else 0.0
            fa.reset_launch_counts()
            start = time.perf_counter()
            params = algo.run_round(params, r, round_seed_words(TP_SEED, r),
                                    False)
            sync(device)
            out["round_ms"].append(1e3 * (time.perf_counter() - start))
            out["k4_launches"].append({n: fa.launch_counts[n]
                                       for n in K4_NAMES})
            if mesh is not None:
                out["collective_ms"].append(mesh.collective_ms() - c0)
                out["tp_ms"].append(mesh.collective_ms("tp") - t0)
            out["rounds"].append({k: v.detach().cpu().clone()
                                  for k, v in params.items()})
    out["peak_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                      if device.type == "cuda" else None)
    out["params"] = params
    return out


def tp_fedavg(wl, data, rounds: int, device):
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    return FedAvg(wl, data, FedAvgConfig(
        comm_round=rounds, seed=TP_SEED,
        **{**LM_FEDAVG, "client_axis": "scan"}), device=device)


def tp_rank_job(settings, inits):
    """8t (c) and (d) on one rank of the two, under the parent's
    ``settings``: the LM's dp x tp rounds on [clients 1, model 2], then
    the moe8 LM's dp x ep rounds on [clients 1, experts 2]; each run's
    rounds (globals on rank 0), ms, collective ms, K4 launches, peak GB
    and every rank's params sha256."""
    from fedml_tpu_torch.parallel.cohort import make_cohort_step
    from fedml_tpu_torch.parallel.expert import (ep_shard_params,
                                                 make_dp_ep_mesh)
    from fedml_tpu_torch.parallel.mesh import make_mesh, tp_shard_params
    from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
    from fedml_tpu_torch.trainer.workload import (NWPWorkload,
                                                  make_client_optimizer)
    globals().update(settings)
    meshes = {"tp": (make_mesh(client_axis=1, model_axis=2, device=CARD),
                     "model"),
              "ep": (make_dp_ep_mesh(1, 2, device=CARD), "experts")}
    data = lm_data()
    out = {}
    for kind, rounds in (("tp", TP_ROUNDS), ("ep", EP_ROUNDS)):
        mesh, axis = meshes[kind]
        init = {k: v.to(mesh.device) for k, v in inits[kind].items()}
        _, placement = (tp_shard_params(init, mesh) if kind == "tp" else
                        ep_shard_params(init, mesh, MOE_EXPERTS))
        wl = NWPWorkload(tp_model(kind),
                         forward_kwargs={"tp_axis": mesh.axis(axis)})
        algo = tp_fedavg(wl, data, rounds, mesh.device)
        algo.cohort_step = make_cohort_step(
            make_local_trainer(wl, make_client_optimizer(
                "sgd", LM_FEDAVG["lr"]), 1, placement=placement),
            mesh=mesh, placement=placement)
        run = tp_rounds(algo, init, rounds, mesh)
        run["hashes"] = mesh.gather_hashes(run.pop("params"))
        run["sharded"] = placement.sharded
        run["rank"], run["device"] = mesh.rank, str(mesh.device)
        run["backend"] = mesh.backend
        if mesh.rank != 0:
            run["rounds"] = None
        out[kind] = run
    return out


def tp_ep_problems(kind: str, ranks, ref, tol: float) -> dict:
    """8t (c)/(d)'s verdict: rank 0's globals after every round within
    ``tol`` x max|w| of the one-process reference, every rank's sha256
    equal, the layers' collectives timed, K4 launched a rank a round as
    in the reference (the tp run) and some leaf sharded."""
    held = par_held(kind, ranks[0][kind]["rounds"], ref["rounds"], tol)
    problems = list(held["failed"])
    for rk in ranks:
        run = rk[kind]
        if len(set(run["hashes"])) != 1:
            problems.append(f"{kind}: the ranks' params differ "
                            f"{run['hashes']}")
        if not run["sharded"]:
            problems.append(f"{kind}: the placement sharded no leaf")
        if not all(ms > 0 for ms in run["tp_ms"]):
            problems.append(f"{kind}: rank {run['rank']} timed no tp "
                            f"collective")
        if kind == "tp" and not all(
                (CARD != "cuda" or all(c[n] > 0 for n in K4_NAMES))
                and c == want for c, want in zip(run["k4_launches"],
                                                 ref["k4_launches"])):
            problems.append(f"{kind}: K4 launches {run['k4_launches']} "
                            f"against one process's "
                            f"{ref['k4_launches']}")
    return {"held": held, "problems": problems}


def tp_parallel() -> dict:
    """8t (c) and (d): the two ranks' job against one process."""
    import torch
    from fedml_tpu_torch.parallel.launch import spawn_ranks
    from fedml_tpu_torch.trainer.workload import NWPWorkload
    inits = {kind: NWPWorkload(tp_model(kind)).init(
        torch.Generator().manual_seed(TP_SEED)) for kind in TP_RUNS}
    t0 = time.perf_counter()
    ranks = spawn_ranks(tp_rank_job, 2, (rank_settings(), inits),
                        platform=None if CARD == "cuda" else "cpu",
                        join_timeout_s=PAR_JOIN_S)
    ranks_s = time.perf_counter() - t0
    data = lm_data()
    out, problems = {"ranks_s": ranks_s}, []
    steady = lambda xs: statistics.median(xs[1:] or xs)  # noqa: E731
    for kind, rounds in (("tp", TP_ROUNDS), ("ep", EP_ROUNDS)):
        from fedml_tpu_torch.trainer.workload import NWPWorkload as W
        ref = tp_rounds(tp_fedavg(W(tp_model(kind)), data, rounds, CARD),
                        {k: v.to(CARD) for k, v in inits[kind].items()},
                        rounds)
        verdict = tp_ep_problems(kind, ranks, ref, TP_TOL)
        problems += verdict["problems"]
        runs = [rk[kind] for rk in ranks]
        row = dict(
            backend=runs[0]["backend"], devices=[r["device"] for r in runs],
            sharded_leaves=len(runs[0]["sharded"]),
            round_ms=[r["round_ms"] for r in runs],
            round_ms_median=steady(runs[0]["round_ms"]),
            tp_ms_median=steady(runs[0]["tp_ms"]),
            collective_ms_median=steady(runs[0]["collective_ms"]),
            rank_peak_gb=[r["peak_gb"] for r in runs],
            reference_round_ms=ref["round_ms"],
            reference_round_ms_median=steady(ref["round_ms"]),
            reference_peak_gb=ref["peak_gb"],
            k4_launches_per_rank_round=runs[0]["k4_launches"][-1],
            reference_k4_launches_per_round=ref["k4_launches"][-1],
            rank_hashes_equal=len(set(runs[0]["hashes"])) == 1,
            vs_one_process=verdict["held"])
        phase(f"tp_ep {kind}", **row)
        out[kind] = row
    return {"rows": out, "problems": problems}


def check_tp_ep(root: Path) -> dict:
    """Phase 8t, deterministic (TF32 off): (a) ditto and cross_silo train
    the dropout CNN with their keys, every round against the CPU; (b) a
    2-stage PipelineLM serves /predict while it trains, each answer
    against the CPU forward of its round's tree; (c) dp x tp on the T=2048
    LM with K4 on [1, 2] (two gloo ranks on the card) and (d) dp x ep on
    its moe8 twin on [1, 2], each against one process after every round,
    ranks byte-equal, K4's launches counted a rank a round."""
    t_phase = time.perf_counter()
    base = root / "build" / "tp_ep"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    keyed = tp_keyed(base)
    pp = tp_pp_serve(base)
    par = tp_parallel()
    problems = keyed["problems"] + pp["problems"] + par["problems"]
    if problems:
        fail("phase 8t: " + "; ".join(problems))
    out = {"keyed": keyed["runs"], "pp_serve": pp["row"], **par["rows"],
           "seconds": time.perf_counter() - t_phase}
    phase("tp_ep", seconds=out["seconds"], hand_written_kernels=[
        "flash_fwd, flash_bwd_dkv, flash_bwd_dq (the tp and ep ranks' "
        "training, H/n heads a rank on tp)"])
    return out


# phase 8u: the data layer — config 1's LEAF MNIST and config 3's CIFAR-10
# read from files in their own layouts (written here from the seed), the
# hetero partition, augmentation on the card, memmap staging
DATA_SEED = 0
DATA_LEAF_USERS = 1000         # LEAF MNIST's users (BASELINE config 1)
# train samples a user, cut from LEAF MNIST's ~69: the json write and
# load of 1000 users take ~5 s at 10 (a user's test split: 2)
DATA_LEAF_SAMPLES = 10
DATA_LEAF_ARGS = ["--algo", "fedavg_robust", "--model", "lr", "--dataset",
                  "mnist", "--defense", "weak_dp", "--defense_backend",
                  "cuda", "--norm_bound", str(CLIP_BOUND), "--stddev",
                  str(SIGMA), "--client_num_per_round", str(N_CLIENTS),
                  "--batch_size", "10", "--lr", "0.03", "--epochs", "1",
                  "--comm_round", "2", "--frequency_of_the_test", "1000",
                  "--log_stdout", "false"]
DATA_CIFAR_TRAIN = 50_000      # CIFAR-10's files at full size
DATA_CIFAR_TEST = 10_000
# cut: 2 of the 10 clients a round, on the host gather (the device-data
# budget set to 0).  The hetero split's largest client pads every client
# to ~100 steps of 64, and a graphed run's one round is its warm-up, the
# capture of every step's kernels and the replay: 77.8 s at 2 clients a
# round on an H100, where the eager round takes ~13 s
DATA_CIFAR_PER_ROUND = 2
DATA_CIFAR_ARGS = ["--algo", "fedavg", "--model", "resnet56", "--dataset",
                   "cifar10", "--partition_method", "hetero",
                   "--partition_alpha", "0.5", "--client_num_in_total", "10",
                   "--client_num_per_round", str(DATA_CIFAR_PER_ROUND),
                   "--batch_size", "64",
                   "--lr", "0.001", "--epochs", "1", "--comm_round", "1",
                   "--frequency_of_the_test", "1000", "--log_stdout",
                   "false"]
DATA_MIN_CLIENT = 10           # the hetero partition's min-size floor
DATA_AUG_SHAPE = (10, 64, 32, 32, 3)   # a round's cohort of CIFAR batches
DATA_AUG_REPS = 20
DATA_MEMMAP_ROUNDS = 2


def write_leaf_mnist(root: Path, users: int = DATA_LEAF_USERS,
                     samples: int = DATA_LEAF_SAMPLES,
                     seed: int = DATA_SEED) -> Path:
    """LEAF MNIST's layout under ``root``: ``train/all_data.json`` and
    ``test/all_data.json`` ({users, num_samples, user_data}), ``samples``
    train and ``max(2, samples // 4)`` test rows a user of 784 pixels in
    [0, 1] (8 in 10 zero, the rest in hundredths), labels 0-9.  The json
    text is laid out from a table of the pixels' printed forms (each
    padded to 4 characters, which json allows), not printed float by
    float."""
    import numpy as np
    rng = np.random.RandomState(seed)
    names = [f"f_{u:05d}" for u in range(users)]
    table = np.array([list((repr(v / 100).ljust(4) + ",").encode())
                      for v in range(101)], np.uint8)
    for split, n in (("train", samples), ("test", max(2, samples // 4))):
        hundredths = np.where(rng.rand(users, n, 784) < 0.8, 0,
                              rng.randint(1, 101, (users, n, 784)))
        y = rng.randint(0, 10, (users, n))
        rows = np.empty((users, n, 2 + 784 * 5), np.uint8)
        rows[..., 0] = ord("[")
        rows[..., 1:-1] = table[hundredths].reshape(users, n, -1)
        rows[..., -2] = ord("]")         # the last pixel's comma
        rows[..., -1] = ord(",")
        parts = [f'{{"users": {json.dumps(names)}, "num_samples": '
                 f'{json.dumps([n] * users)}, "user_data": {{'.encode()]
        for i, u in enumerate(names):
            parts.append(b"%s\"%s\": {\"x\": [%s], \"y\": %s}" % (
                b", " if i else b"", u.encode(), rows[i].tobytes()[:-1],
                json.dumps(y[i].tolist()).encode()))
        parts.append(b"}}")
        out = root / split
        out.mkdir(parents=True, exist_ok=True)
        (out / "all_data.json").write_bytes(b"".join(parts))
    return root


def write_cifar10(root: Path, n_train: int = DATA_CIFAR_TRAIN,
                  n_test: int = DATA_CIFAR_TEST,
                  seed: int = DATA_SEED) -> Path:
    """CIFAR-10's python layout under ``root``:
    ``cifar-10-batches-py/data_batch_1..5`` and ``test_batch``, each a
    latin1-readable pickle of {batch_label, data: [n, 3072] uint8
    (channel-major rows), labels: list of 0-9}."""
    import pickle
    import numpy as np
    rng = np.random.RandomState(seed)
    out = root / "cifar-10-batches-py"
    out.mkdir(parents=True, exist_ok=True)
    per = n_train // 5
    batches = [(f"data_batch_{b}", f"training batch {b} of 5", per)
               for b in range(1, 6)]
    for name, label, n in batches + [("test_batch", "testing batch 1 of 1",
                                      n_test)]:
        data = rng.randint(0, 256, (n, 3072), dtype=np.uint8)
        labels = rng.randint(0, 10, n).tolist()
        with open(out / name, "wb") as f:
            pickle.dump({"batch_label": label, "data": data,
                         "labels": labels}, f, protocol=2)
    return root


def data_cfg(argv, data_dir: Path, device: str = None):
    from fedml_tpu_torch.experiments.config import config_from_argv
    cfg = config_from_argv([*argv, "--data_dir", str(data_dir)])
    if device is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, platform=device)
    return cfg


def data_leaf(root: Path) -> dict:
    """8u (a): LEAF MNIST through the CLI's loader and the defended runner
    (K1n + K1) on the card, against the same run on the CPU."""
    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobust
    from fedml_tpu_torch.core import fused_agg as fa
    from fedml_tpu_torch.experiments.main import (_make_workload,
                                                  _summary,
                                                  fedavg_robust_config,
                                                  load_experiment_data)
    t0 = time.perf_counter()
    write_leaf_mnist(root)
    write_s = time.perf_counter() - t0
    cfg = data_cfg(DATA_LEAF_ARGS, root)
    t0 = time.perf_counter()
    data = load_experiment_data(cfg)
    load_s = time.perf_counter() - t0
    out, launches = {}, {}
    with deterministic():
        for dev in (CARD, "cpu"):
            fa.reset_launch_counts()
            algo = FedAvgRobust(_make_workload(cfg, data), data,
                                fedavg_robust_config(cfg), device=dev)
            params = algo.run()
            sync(dev)
            if dev == CARD:
                summary = _summary(algo, params)
                launches = {k: fa.launch_counts[k]
                            for k in ("clip_norm", "robust_agg")}
            out[dev] = {k: v.cpu() for k, v in params.items()}
    return {"data": data, "cfg": cfg, "write_s": write_s, "load_s": load_s,
            "clients": data.client_num,
            "train_samples": int(data.train["num_samples"].sum()),
            "launches": launches, "rounds": cfg.comm_round,
            "vs_cpu_max_abs_diff": max_diff(out[CARD], out["cpu"]),
            "round_ms": summary["round_ms"],
            "params_finite": summary["params_finite"]}


def data_cifar(root: Path) -> dict:
    """8u (b): CIFAR-10's files at full size, loaded and partitioned
    (hetero, alpha 0.5) by the CLI's loader; one round of ResNet-56 at
    E=1 through the CLI's runner, on the host gather."""
    from fedml_tpu_torch.experiments.main import (load_experiment_data,
                                                  run_fedavg)
    from fedml_tpu_torch.utils.metrics import MetricsSink
    t0 = time.perf_counter()
    write_cifar10(root)
    write_s = time.perf_counter() - t0
    cfg = data_cfg(DATA_CIFAR_ARGS, root, CARD)
    t0 = time.perf_counter()
    data = load_experiment_data(cfg)
    load_s = time.perf_counter() - t0
    counts = [int(n) for n in data.train["num_samples"]]
    reset_peak()
    t0 = time.perf_counter()
    with MetricsSink(None) as sink, env("FEDML_TPU_DEVICE_DATA_BYTES", "0"):
        summary = run_fedavg(cfg, data, sink)
    sync(CARD)
    return {"write_s": write_s, "load_partition_s": load_s,
            "client_counts": counts, "test_samples": int(
                data.test["num_samples"].sum()),
            "steps": int(data.train["x"].shape[1]),
            "run_s": time.perf_counter() - t0,
            "round_ms": summary["round_ms"],
            "rounds_per_s": summary["rounds_per_s"], "peak_gb": peak_gb(),
            "params_finite": summary["params_finite"],
            "clients_per_round": cfg.client_num_per_round}


def ulps(a, b) -> int:
    """The largest distance in units of the last place between two f32
    tensors of one shape (0: bit-equal)."""
    import numpy as np
    ia = a.cpu().numpy().view(np.int32).astype(np.int64)
    ib = b.cpu().numpy().view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def data_augment() -> dict:
    """8u (c): the two train pipelines on a cohort of CIFAR batches on the
    card against the same tensor on the CPU, one key; ``normalize``
    alone too."""
    import numpy as np
    import torch
    from fedml_tpu_torch.core import prng
    from fedml_tpu_torch.data import augment as aug
    x = torch.from_numpy(np.random.RandomState(DATA_SEED).rand(
        *DATA_AUG_SHAPE).astype(np.float32))
    xc = x.to(CARD)
    key = prng.key(DATA_SEED)
    pipes = {
        "cifar_train_augment": lambda v: aug.cifar_train_augment(
            key, v, aug.CIFAR10_MEAN, aug.CIFAR10_STD),
        "fed_cifar100_train_augment": lambda v:
            aug.fed_cifar100_train_augment(key, v, aug.CIFAR100_MEAN,
                                           aug.CIFAR100_STD),
        "normalize": lambda v: aug.normalize(v, aug.CIFAR10_MEAN,
                                             aug.CIFAR10_STD)}
    rows = {}
    for name, fn in pipes.items():
        want, got = fn(x), fn(xc)
        rows[name] = {"shape": list(got.shape), "ulps": ulps(got, want),
                      "ms": (time_ms(lambda: fn(xc), DATA_AUG_REPS)
                             if CARD == "cuda" else None)}
    return rows


def data_memmap(data, cfg, root: Path) -> dict:
    """8u (d): the LEAF split saved with `save_stacked` and memory-mapped
    back; FedAvg's rounds from the map (over the device budget: the host
    gather) against the same rounds from the split in memory."""
    import dataclasses
    import numpy as np
    from fedml_tpu_torch.data.stacking import (FederatedData,
                                               load_stacked_memmap,
                                               save_stacked)
    cfg = dataclasses.replace(cfg, algo="fedavg",
                              comm_round=DATA_MEMMAP_ROUNDS)
    t0 = time.perf_counter()
    for split in ("train", "test"):
        save_stacked(getattr(data, split), str(root / split))
    mapped = FederatedData(
        client_num=data.client_num, class_num=data.class_num,
        train=load_stacked_memmap(str(root / "train")),
        test=load_stacked_memmap(str(root / "test")))
    stage_s = time.perf_counter() - t0
    out, host_gather = {}, {}
    with deterministic(), env("FEDML_TPU_DEVICE_DATA_BYTES", "0"):
        for name, src in (("memmap", mapped), ("ram", data)):
            algo = fedavg_algo(cfg, src, device=CARD)
            params = algo.run()
            sync(CARD)
            host_gather[name] = algo._train_dev is None
            out[name] = {k: v.cpu() for k, v in params.items()}
    return {"stage_s": stage_s, "rounds": DATA_MEMMAP_ROUNDS,
            "host_gather": host_gather,
            "still_mapped": all(isinstance(v, np.memmap)
                                for v in mapped.train.values()),
            "bit_equal": bit_equal(out["memmap"], out["ram"]),
            "max_abs_diff": max_diff(out["memmap"], out["ram"])}


def data_problems(leaf: dict, cifar: dict, augment: dict,
                  memmap: dict) -> list:
    """What the data-layer phase got wrong (empty: it passed)."""
    problems = []
    for k in ("clip_norm", "robust_agg"):
        if leaf["launches"].get(k) != leaf["rounds"]:
            problems.append(f"LEAF MNIST launched {k} "
                            f"{leaf['launches'].get(k)} times, need "
                            f"{leaf['rounds']} (one a round)")
    if leaf["clients"] != DATA_LEAF_USERS:
        problems.append(f"LEAF MNIST loaded {leaf['clients']} users, "
                        f"wrote {DATA_LEAF_USERS}")
    if not leaf["vs_cpu_max_abs_diff"] <= ROUND_TOL:
        problems.append(f"LEAF MNIST run {leaf['vs_cpu_max_abs_diff']} "
                        f"from the CPU's > {ROUND_TOL}")
    if not (leaf["params_finite"] and cifar["params_finite"]):
        problems.append("a data-layer run ended with non-finite params")
    counts = cifar["client_counts"]
    if sum(counts) != DATA_CIFAR_TRAIN or min(counts) < DATA_MIN_CLIENT:
        problems.append(f"the hetero partition gave {counts}: need "
                        f"{DATA_CIFAR_TRAIN} in all, each >= "
                        f"{DATA_MIN_CLIENT}")
    if len(set(counts)) == 1:
        problems.append(f"the hetero partition is even: {counts}")
    if cifar["test_samples"] != DATA_CIFAR_TEST:
        problems.append(f"CIFAR-10's test split holds "
                        f"{cifar['test_samples']}, wrote {DATA_CIFAR_TEST}")
    norm_ulps = augment["normalize"]["ulps"]
    for name, row in augment.items():
        # a pipeline may sit 1 ulp off only where the card's divide is
        if row["ulps"] and (norm_ulps == 0 or row["ulps"] > 1):
            problems.append(f"{name} on the card is {row['ulps']} ulps "
                            f"from the CPU's (normalize alone: "
                            f"{norm_ulps})")
    if not memmap["bit_equal"]:
        problems.append(f"memmap rounds {memmap['max_abs_diff']} from the "
                        f"in-memory rounds, not bit-equal")
    if not (memmap["still_mapped"] and all(memmap["host_gather"].values())):
        problems.append(f"memmap staging left the host gather: "
                        f"{memmap['host_gather']}, mapped "
                        f"{memmap['still_mapped']}")
    return problems


def check_data_layer(root: Path) -> dict:
    """Phase 8u, deterministic (TF32 off where held to the CPU): (a) LEAF
    MNIST at config 1's 1000 users, written as json and read by the CLI's
    loader, 2 defended rounds (weak DP, K1n + K1) on the card against the
    CPU; (b) CIFAR-10's pickles at full size, the hetero partition over 10
    clients and one ResNet-56 round at E=1 (2 clients a round); (c) the
    two augmentation pipelines bit-equal to the CPU; (d) FedAvg from the
    memmapped LEAF split bit-equal to FedAvg from memory."""
    t_phase = time.perf_counter()
    base = root / "build" / "data_layer"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    leaf = data_leaf(base / "leaf")
    phase("data layer leaf mnist", **{k: v for k, v in leaf.items()
                                      if k not in ("data", "cfg")})
    memmap = data_memmap(leaf["data"], leaf["cfg"], base / "memmap")
    phase("data layer memmap", **memmap)
    cifar = data_cifar(base / "cifar")
    phase("data layer cifar10", **cifar)
    augment = data_augment()
    phase("data layer augment", **augment)
    shutil.rmtree(base, ignore_errors=True)
    problems = data_problems(leaf, cifar, augment, memmap)
    if problems:
        fail("phase 8u: " + "; ".join(problems))
    out = {"leaf": {k: v for k, v in leaf.items() if k not in ("data",
                                                               "cfg")},
           "cifar": cifar, "augment": augment, "memmap": memmap,
           "seconds": time.perf_counter() - t_phase}
    phase("data layer", seconds=out["seconds"], hand_written_kernels=[
        "clip_norm, robust_agg (the defended rounds on LEAF MNIST)"])
    return out


# phase 8v: the decentralized, split and vertical long tail, each run on
# the card against the same run on the CPU from the same init (TF32 off)
LT_TOL = 1e-4                  # x max|w|: a card run vs the CPU's
LT_ONLINE_TOL = 1e-5           # relative: final regret and z vs the CPU's
LT_CNN_PARAMS = 1_690_046      # the FEMNIST CNN, each gossip node
LT_GOSSIP_ARGS = ["--algo", "decentralized", "--model", "cnn_fedavg",
                  "--dataset", "femnist", "--client_num_in_total", "10",
                  "--neighbor_num", "4", "--batch_size", "20", "--lr", "0.1",
                  "--epochs", "1", "--comm_round", "3",
                  "--frequency_of_the_test", "1000", "--log_stdout", "false"]
LT_MIX_REPS = 50
# the CLI's defaults: 128 nodes (1000 clients capped), T = 100, the
# synthetic stream
LT_ONLINE_ARGS = ["--algo", "decentralized_online", "--log_stdout", "false"]
LT_ONLINE_RUNS = {"DOL": [], "PUSHSUM": ["--mode", "PUSHSUM"],
                  "PUSHSUM time-varying": ["--mode", "PUSHSUM",
                                           "--time_varying", "true"]}
LT_SPLIT_ARGS = ["--algo", "split_nn", "--model", "lr", "--dataset",
                 "femnist", "--client_num_in_total", "10",
                 "--client_num_per_round", "4", "--batch_size", "20", "--lr",
                 "0.05", "--comm_round", "2", "--log_stdout", "false"]
LT_VFL_ARGS = ["--algo", "vfl", "--batch_size", "64", "--lr", "0.1",
               "--comm_round", "20", "--frequency_of_the_test", "10",
               "--client_num_in_total", "2", "--log_stdout", "false"]
LT_GKT_ARGS = ["--algo", "fedgkt", "--dataset", "cifar10",
               "--client_num_in_total", "4", "--client_num_per_round", "4",
               "--batch_size", "64", "--comm_round", "2", "--log_stdout",
               "false"]
# cut: 100 clients of FEMNIST's 3400 (the poisoning copies the whole
# stacked train split, the targeted set takes every honest client's eval
# rows)
LT_BACKDOOR_ARGS = ["--algo", "fedavg_robust", "--backdoor", "true",
                    "--attacker_num", "1", "--defense", "weak_dp",
                    "--defense_backend", "cuda", "--norm_bound",
                    str(CLIP_BOUND), "--stddev", str(SIGMA), "--model",
                    "cnn_fedavg", "--dataset", "femnist",
                    "--client_num_in_total", "100", "--client_num_per_round",
                    str(N_CLIENTS), "--batch_size", "20", "--lr", "0.1",
                    "--epochs", "1", "--comm_round", "2",
                    "--frequency_of_the_test", "1000", "--log_stdout",
                    "false"]


def lt_cfg(argv, device=None):
    import dataclasses
    from fedml_tpu_torch.experiments.config import config_from_argv
    cfg = config_from_argv(argv)
    return cfg if device is None else dataclasses.replace(cfg,
                                                          platform=device)


def rel_diff(a, b) -> float:
    """max|a − b| over every leaf, over max|b|."""
    scale = max(float(b[k].double().abs().max()) for k in b)
    return max_diff(a, b) / max(scale, 1e-30)


def lt_gossip() -> dict:
    """8v (a): `--algo decentralized` on the FEMNIST CNN at full width,
    10 nodes, each round's stacked nodes against the CPU's."""
    from fedml_tpu_torch.algorithms.decentralized import mix_stacked
    from fedml_tpu_torch.experiments.main import (decentralized_algo,
                                                  load_experiment_data)
    cfg = lt_cfg(LT_GOSSIP_ARGS)
    data = load_experiment_data(cfg)
    rounds, out = {}, {}
    with deterministic():
        for dev in (CARD, "cpu"):
            algo = decentralized_algo(lt_cfg(LT_GOSSIP_ARGS, dev), data)
            per = rounds[dev] = []
            reset_peak()
            stacked = algo.run(on_round=lambda r, s: per.append(
                _cpu_tree(s)))
            sync(dev)
            if dev == CARD:
                out.update(round_ms=steady(algo.round_times)["round_ms"],
                           peak_gb=peak_gb(), history=algo.history,
                           node_params=sum(v[0].numel()
                                           for v in stacked.values()),
                           mix_ms=(time_ms(lambda: mix_stacked(
                               stacked, algo.W), LT_MIX_REPS)
                               if CARD == "cuda" else None))
    out["nodes"] = data.client_num
    out["rounds_vs_cpu"] = [rel_diff(a, b) for a, b in
                            zip(rounds[CARD], rounds["cpu"])]
    out["rounds"] = len(rounds[CARD])
    return out


def lt_online() -> dict:
    """8v (b): `--algo decentralized_online` at the CLI's defaults in DOL,
    PUSHSUM and time-varying PUSHSUM, the card's final regret and z
    against the CPU's."""
    import numpy as np
    from fedml_tpu_torch.algorithms.decentralized_online import (
        DecentralizedOnline, _topology_bank)
    from fedml_tpu_torch.experiments.main import online_setup
    out = {}
    for name, extra in LT_ONLINE_RUNS.items():
        stream, config = online_setup(lt_cfg(LT_ONLINE_ARGS + extra))
        runs = {}
        for dev in (CARD, "cpu"):
            algo = DecentralizedOnline(stream, config, device=dev)
            if dev == CARD:     # warm: the kernels' first use, untimed
                algo.run()
                sync(dev)
            t0 = time.perf_counter()
            res = algo.run()
            sync(dev)
            runs[dev] = (res, time.perf_counter() - t0)
            if dev == CARD:
                graph = {"graph_captures": algo._run.captures,
                         "capture_s": algo._run.capture_s,
                         "replay_ms": algo._run.replay_ms}
        (card, card_s), (cpu, _) = runs[CARD], runs["cpu"]
        t0 = time.perf_counter()
        _topology_bank(config, algo.n, algo.T * max(config.epochs, 1))
        bank_s = time.perf_counter() - t0
        z_rel = max(float(np.abs(card["params_z"][k].cpu().numpy()
                                 - cpu["params_z"][k].numpy()).max())
                    / max(float(np.abs(cpu["params_z"][k].numpy()).max()),
                          1e-30) for k in ("w", "b"))
        out[name] = {
            "nodes": algo.n, "steps": len(card["losses"]),
            "final_regret": card["final_regret"],
            "final_regret_cpu": cpu["final_regret"],
            "regret_rel_diff": abs(card["final_regret"]
                                   - cpu["final_regret"])
            / abs(cpu["final_regret"]),
            "z_rel_diff": z_rel, "run_s": card_s, "bank_s": bank_s,
            **graph, "steps_per_s": len(card["losses"]) / card_s,
            "replay_steps_per_s": (
                1e3 * len(card["losses"]) / graph["replay_ms"]
                if graph["replay_ms"] else None)}
    return out


def lt_split() -> dict:
    """8v (c): `--algo split_nn` on the FEMNIST twin, 4 clients, 2 sweeps,
    card against CPU from one init; one client's epoch over the hub
    actors on the card against the simulator's."""
    import torch
    from fedml_tpu_torch.algorithms.split_nn import (SplitNNClientActor,
                                                     SplitNNServerActor)
    from fedml_tpu_torch.comm.local import LocalHub
    from fedml_tpu_torch.experiments.main import (load_experiment_data,
                                                  split_nn_sim)
    cfg = lt_cfg(LT_SPLIT_ARGS)
    data = load_experiment_data(cfg)
    outs = {}
    with deterministic():
        for dev in (CARD, "cpu"):
            sim, client_data = split_nn_sim(lt_cfg(LT_SPLIT_ARGS, dev), data)
            init = sim.split.init(cfg.seed, device=dev)
            t0 = time.perf_counter()
            res = sim.run(client_data, params=init)
            sync(dev)
            outs[dev] = (res, time.perf_counter() - t0, sim, init,
                         client_data)
        res, card_s, sim, init, client_data = outs[CARD]
        cpu = outs["cpu"][0]
        body, head = init
        d0 = {k: torch.as_tensor(v).to(CARD)
              for k, v in client_data[0].items()}
        ref = sim._epoch_step(body, head, sim.client_opt.init(body),
                              sim.server_opt.init(head), d0)
        hub = LocalHub()
        server = SplitNNServerActor(0, hub.transport(0), sim.split, head,
                                    sim.cfg, device=CARD)
        client = SplitNNClientActor(1, hub.transport(1), sim.split, body,
                                    client_data[0], server_id=0,
                                    cfg=sim.cfg, device=CARD)
        server.register_handlers()
        client.register_handlers()
        client.start_epoch()
        hub.pump()
    return {"clients": len(client_data), "sweeps": cfg.comm_round,
            "steps": len(res["history"]) * int(data.train["x"].shape[1]),
            "run_s": card_s,
            "body_vs_cpu": rel_diff(_cpu_tree(res["body_params"]),
                                    _cpu_tree(cpu["body_params"])),
            "head_vs_cpu": rel_diff(_cpu_tree(res["head_params"]),
                                    _cpu_tree(cpu["head_params"])),
            "actors_vs_simulator": max(
                rel_diff(_cpu_tree(client.body_params), _cpu_tree(ref[0])),
                rel_diff(_cpu_tree(server.head_params), _cpu_tree(ref[1]))),
            "history_loss": [h["loss"] for h in res["history"]]}


def lt_vfl() -> dict:
    """8v (d): `--algo vfl`, 2 parties: `fit` on the card against the CPU
    from one seed, and the wire protocol on the card against the joint
    step's parties."""
    from fedml_tpu_torch.algorithms.vertical_fl import (VFLGuest, VFLHost,
                                                        run_vfl_protocol)
    from fedml_tpu_torch.experiments.main import vfl_setup
    cfg = lt_cfg(LT_VFL_ARGS)
    fits = {}
    with deterministic():
        for dev in (CARD, "cpu"):
            vfl, train, test = vfl_setup(lt_cfg(LT_VFL_ARGS, dev))
            t0 = time.perf_counter()
            fits[dev] = vfl.fit(train, test, cfg.seed)
            sync(dev)
            if dev == CARD:
                card_s, models = time.perf_counter() - t0, vfl.party_models
        guest = VFLGuest(models[0], train[0], train[-1], vfl.cfg,
                         device=CARD)
        host = VFLHost(models[1], train[1], vfl.cfg, device=CARD)
        losses = run_vfl_protocol(guest, [host], cfg.comm_round,
                                  cfg.batch_size, rng=cfg.seed)
    card, cpu = fits[CARD], fits["cpu"]
    return {"parties": len(models), "rounds": cfg.comm_round,
            "fit_s": card_s,
            "fit_vs_cpu": max(rel_diff(_cpu_tree(a), _cpu_tree(b))
                              for a, b in zip(card["params"],
                                              cpu["params"])),
            "wire_vs_joint": max(
                rel_diff(_cpu_tree(p.params), _cpu_tree(q))
                for p, q in zip((guest, host), card["params"])),
            "test_acc": card["history"][-1]["test_acc"],
            "test_acc_cpu": cpu["history"][-1]["test_acc"],
            "wire_last_loss": losses[-1]}


def lt_gkt() -> dict:
    """8v (e): `--algo fedgkt` at full width (client ResNet-8, server
    layers (9, 9), GroupNorm) on the CIFAR-10 twin, 4 clients, B=64, 2
    rounds, card against CPU from one init."""
    from fedml_tpu_torch.experiments.main import (fedgkt_algo,
                                                  load_experiment_data)
    cfg = lt_cfg(LT_GKT_ARGS)
    data = load_experiment_data(cfg)
    outs = {}
    with deterministic():
        for dev in (CARD, "cpu"):
            algo, cohort = fedgkt_algo(lt_cfg(LT_GKT_ARGS, dev), data)
            if dev == CARD:
                cp, _, sp, _ = algo.init(cfg.seed, cohort)
                init = (_cpu_tree(cp), _cpu_tree(sp))
            reset_peak()
            res = algo.run(cohort, params=init)
            sync(dev)
            outs[dev] = res
            if dev == CARD:
                phases = algo.phase_times
                peak = peak_gb()
                n_client = sum(v[0].numel() for v in cp.values())
                n_server = sum(v.numel() for v in sp.values())
    card, cpu = outs[CARD], outs["cpu"]
    steady = phases[1:] or phases
    return {"clients": int(cohort["x"].shape[0]),
            "steps": int(cohort["x"].shape[1]), "rounds": len(phases),
            "client_params": n_client, "server_params": n_server,
            "round_ms": {k: 1e3 * statistics.median(p[k] for p in steady)
                         for k in ("clients", "server", "distil")},
            "peak_gb": peak,
            "clients_vs_cpu": rel_diff(_cpu_tree(card["client_params"]),
                                       _cpu_tree(cpu["client_params"])),
            "server_vs_cpu": rel_diff(_cpu_tree(card["server_params"]),
                                      _cpu_tree(cpu["server_params"])),
            "server_loss": card["history"][-1]["server_loss"]}


def lt_backdoor() -> dict:
    """8v (f): `--algo fedavg_robust --backdoor --attacker_num 1 --defense
    weak_dp --defense_backend cuda` on the FEMNIST CNN, 10 a round, 2
    rounds: K1n's and K1's launches on the card, the globals and the
    backdoor's accuracy against the CPU's."""
    from fedml_tpu_torch.algorithms.backdoor import targeted_accuracy
    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobust
    from fedml_tpu_torch.core import fused_agg as fa
    from fedml_tpu_torch.experiments.main import (_make_workload, _summary,
                                                  backdoor_data,
                                                  fedavg_robust_config,
                                                  load_experiment_data)
    cfg = lt_cfg(LT_BACKDOOR_ARGS)
    data, targeted = backdoor_data(cfg, load_experiment_data(cfg))
    out, acc, launches = {}, {}, {}
    with deterministic():
        for dev in (CARD, "cpu"):
            fa.reset_launch_counts()
            wl = _make_workload(cfg, data)
            algo = FedAvgRobust(wl, data, fedavg_robust_config(cfg),
                                device=dev)
            params = algo.run()
            sync(dev)
            if dev == CARD:
                summary = _summary(algo, params)
                launches = {k: fa.launch_counts[k]
                            for k in ("clip_norm", "robust_agg")}
            acc[dev] = targeted_accuracy(wl, params, targeted)
            out[dev] = _cpu_tree(params)
    return {"launches": launches, "rounds": cfg.comm_round,
            "targeted_rows": int(len(targeted["y"])),
            "backdoor_acc": acc[CARD], "backdoor_acc_cpu": acc["cpu"],
            "vs_cpu_max_abs_diff": max_diff(out[CARD], out["cpu"]),
            "round_ms": summary["round_ms"],
            "params_finite": summary["params_finite"]}


def lt_signal(root: Path) -> dict:
    """8v (g): `--completion_signal` through the CLI's `main` (the vfl
    runner, 2 rounds on the card): the file holds the summary line."""
    from fedml_tpu_torch.experiments.main import main as cli_main
    path = root / "completion_signal.json"
    path.unlink(missing_ok=True)
    summary = cli_main([*LT_VFL_ARGS, "--comm_round", "2", "--platform",
                        CARD, "--completion_signal", str(path)])
    line = json.loads(path.read_text()) if path.exists() else {}
    return {"written": path.exists(),
            "matches": bool(line) and line.get("algo") == "vfl"
            and all(line.get(k) == v for k, v in summary.items()
                    if isinstance(v, (int, float, str)))}


def long_tail_problems(r: dict) -> list:
    """What the long-tail phase got wrong (empty: it passed)."""
    problems = []
    g = r["gossip"]
    if g["node_params"] != LT_CNN_PARAMS or g["rounds"] != 3:
        problems.append(f"gossip ran {g['rounds']} rounds of "
                        f"{g['node_params']} parameters a node, need 3 of "
                        f"{LT_CNN_PARAMS}")
    worst = max(g["rounds_vs_cpu"], default=float("inf"))
    if not worst <= LT_TOL:
        problems.append(f"gossip rounds {g['rounds_vs_cpu']} x max|w| from "
                        f"the CPU's > {LT_TOL}")
    for name, o in r["online"].items():
        if CARD == "cuda" and not o["graph_captures"]:
            problems.append(f"{name}: the card's run took the host loop, "
                            f"not its CUDA graph")
        if not (o["regret_rel_diff"] <= LT_ONLINE_TOL
                and o["z_rel_diff"] <= LT_ONLINE_TOL):
            problems.append(f"{name}: regret {o['regret_rel_diff']} and z "
                            f"{o['z_rel_diff']} relative from the CPU's > "
                            f"{LT_ONLINE_TOL}")
    s = r["split"]
    for k in ("body_vs_cpu", "head_vs_cpu", "actors_vs_simulator"):
        if not s[k] <= LT_TOL:
            problems.append(f"split_nn {k} {s[k]} x max|w| > {LT_TOL}")
    v = r["vfl"]
    for k in ("fit_vs_cpu", "wire_vs_joint"):
        if not v[k] <= LT_TOL:
            problems.append(f"vfl {k} {v[k]} x max|w| > {LT_TOL}")
    k = r["gkt"]
    for key in ("clients_vs_cpu", "server_vs_cpu"):
        if not k[key] <= LT_TOL:
            problems.append(f"fedgkt {key} {k[key]} x max|w| > {LT_TOL}")
    b = r["backdoor"]
    for name in ("clip_norm", "robust_agg"):
        if b["launches"].get(name) != b["rounds"]:
            problems.append(f"the backdoor run launched {name} "
                            f"{b['launches'].get(name)} times, need "
                            f"{b['rounds']} (one a round)")
    if not b["vs_cpu_max_abs_diff"] <= ROUND_TOL:
        problems.append(f"the backdoor run {b['vs_cpu_max_abs_diff']} from "
                        f"the CPU's > {ROUND_TOL}")
    if b["backdoor_acc"] != b["backdoor_acc_cpu"]:
        problems.append(f"backdoor_acc {b['backdoor_acc']} on the card, "
                        f"{b['backdoor_acc_cpu']} on the CPU")
    if not b["params_finite"]:
        problems.append("the backdoor run ended with non-finite params")
    if not (r["signal"]["written"] and r["signal"]["matches"]):
        problems.append(f"--completion_signal: {r['signal']}")
    return problems


def check_long_tail(root: Path) -> dict:
    """Phase 8v, deterministic (TF32 off): (a) gossip on the FEMNIST CNN,
    (b) online DSGD / PushSum, (c) SplitNN and its hub actors, (d)
    vertical FL and its wire protocol, (e) FedGKT at full width, (f) the
    backdoor on the defended mean (K1n + K1), (g) the completion signal;
    each on the card against the CPU."""
    t_phase = time.perf_counter()
    base = root / "build" / "long_tail"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    r = {}
    for name, fn in (("gossip", lt_gossip), ("online", lt_online),
                     ("split", lt_split), ("vfl", lt_vfl), ("gkt", lt_gkt),
                     ("backdoor", lt_backdoor),
                     ("signal", lambda: lt_signal(base))):
        t0 = time.perf_counter()
        r[name] = fn()
        if name == "online":
            for run, row in r[name].items():
                phase(f"long tail online {run}", **row)
        else:
            phase(f"long tail {name}", **r[name])
        r[name + "_s"] = time.perf_counter() - t0
    shutil.rmtree(base, ignore_errors=True)
    problems = long_tail_problems(r)
    if problems:
        fail("phase 8v: " + "; ".join(problems))
    r["seconds"] = time.perf_counter() - t_phase
    phase("long tail", seconds=r["seconds"],
          part_seconds={k[:-2]: v for k, v in r.items()
                        if k.endswith("_s") and k != "seconds"},
          hand_written_kernels=[
              "clip_norm, robust_agg (the --backdoor defended rounds)"])
    return r


# serving's extra round time, split (``--serve-split``): rounds an arm,
# the first a warm-up
SPLIT_ROUNDS = 4


class HostForward:
    """A registry as a batcher sees it, each snapshot's forward a host
    stub of zeros: the requests' whole path (HTTP, JSON, the queue, the
    batcher) without their device work."""

    def __init__(self, registry, classes: int):
        self._registry, self._classes = registry, classes

    def current(self):
        import types
        import numpy as np
        m = self._registry.current()
        if m is None:
            return None
        return types.SimpleNamespace(
            version=m.version, predict=lambda rows: np.zeros(
                (len(rows), self._classes), np.float32))

    def __getattr__(self, name):
        return getattr(self._registry, name)


def split_arm(data, arm: str, profiled: bool) -> dict:
    """One arm of the spine's ``SPLIT_ROUNDS`` rounds with the perf
    ledger on: ``off`` (no serving), ``idle`` (the gated frontend, no
    traffic), ``host`` (client traffic, the forward a host stub),
    ``full`` (client traffic, the real forward).  Unprofiled: the rounds'
    ms, the gate's offers, the ledger's phases and critical path, the
    answers; profiled (torch.profiler): the device's busy ms a round."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    ledger = SERVE_DIR / f"split_{arm}_{int(profiled)}.jsonl"
    perf = ["--perf", "true", "--perf_ledger", str(ledger)]
    if arm == "off":
        fed = live_fed(live_cfg([*SILO_ARGS, *perf], SPLIT_ROUNDS), data)
    else:
        fed = serve_fed(data, SPLIT_ROUNDS, 1, CARD, perf)
        if arm == "host":
            batcher = fed.serving._warm.__self__
            batcher.registry = HostForward(batcher.registry, data.class_num)
    rows = np.asarray(data.test["x"])[:64, 0, :8].reshape(
        -1, *data.test["x"].shape[3:])
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                   ) if profiled else contextlib.nullcontext()
    traffic = (ServeTraffic(fed.serving.port, rows) if arm in ("host", "full")
               else contextlib.nullcontext())
    try:
        with traffic, prof:
            t0 = time.perf_counter()
            live_drive(fed)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        if fed.serving is not None:
            fed.serving.stop()
        fed.perf.close()
    round_ms = [1e3 * dt for _, dt, _ in fed.closed]
    out = {"round_ms": round_ms,
           "steady_round_ms": statistics.median(round_ms[1:])}
    if profiled:
        busy_us = sum(_self_device_us(e) for e in prof.key_averages())
        out["device_busy_ms_per_round"] = busy_us / 1e3 / SPLIT_ROUNDS
        out["device_idle_share"] = 1 - busy_us / (wall_s * 1e6)
        return out
    lines = [json.loads(line) for line in ledger.read_text().splitlines()]
    steady = [x for x in lines if x.get("round", 0) >= 1]
    phases = {}
    for x in steady:
        for k, v in x["phases"].items():
            phases.setdefault(k, []).append(1e3 * v)
    out["phase_ms"] = {k: statistics.median(v) for k, v in phases.items()}
    cpath = {}
    for x in steady:
        for k, v in x["critical_path"]["attribution"].items():
            cpath.setdefault(k, []).append(1e3 * v)
    out["critical_path_ms"] = {k: statistics.median(v)
                               for k, v in cpath.items()}
    if arm != "off":
        out["gate_offer_ms"] = fed.offer_ms
    if arm in ("host", "full"):
        statuses = {}
        for answers in traffic.answers:
            for _, status, _, _, reason, _ in answers:
                key = "200" if status == 200 else f"{status} {reason}"
                statuses[key] = statuses.get(key, 0) + 1
        out["statuses"] = statuses
        out["answers_per_round"] = statuses.get("200", 0) / SPLIT_ROUNDS
    return out


def serve_split(data) -> dict:
    """Where serving's extra round time goes: the four arms of
    `split_arm`, each unprofiled then profiled, TF32 off.  ``idle`` -
    ``off`` is the gate and the serving machinery, ``host`` - ``idle``
    the requests' host path, ``full`` - ``host`` their device work (the
    predicts on the training's stream and their synchronisations)."""
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    arms = ("off", "idle", "host", "full")
    out = {}
    with tf32_off():
        for arm in arms:
            out[arm] = split_arm(data, arm, False)
        for arm in arms:
            out[arm]["profiled"] = split_arm(data, arm, True)
    ms = {arm: out[arm]["steady_round_ms"] for arm in arms}
    out["split_ms"] = {"gate_and_machinery": ms["idle"] - ms["off"],
                       "requests_host": ms["host"] - ms["idle"],
                       "requests_device": ms["full"] - ms["host"]}
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    return out


def serve_split_main() -> None:
    """``python3 chip_smoke.py --serve-split``: the K2 library built, the
    live slice's data, `serve_split`, one JSON line."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this check needs a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import load_experiment_data
    from fedml_tpu_torch.utils import cuda_build
    print(nvidia_smi(), flush=True)
    cuda_build.build(["shard_finalize"])
    data = load_experiment_data(config_from_argv(SILO_ARGS))
    phase("serve split", **serve_split(data))


def main() -> None:
    root = Path(__file__).resolve().parent
    if not (root / "fedml_tpu_torch" / "csrc").is_dir():
        fail(f"no fedml_tpu_torch/ beside {Path(__file__).name}; run it "
             f"from the root of a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this check needs a GPU")
    sys.path.insert(0, str(root))
    t_start = time.perf_counter()

    smi = nvidia_smi()
    print(smi, flush=True)
    phase("device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    from fedml_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    libs = cuda_build.build(cuda_build.all_kernel_sources())
    phase("build", seconds=time.perf_counter() - t0,
          libraries=sorted(p.name for p in libs.values()))
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    ptxas = {name: ptxas_report(cuda_build.build_log(name))
             for name in ("robust_agg", "secagg_mask")}
    phase("kernel build K1 K3", ptxas=ptxas)
    _, sm_hz = sm_clocks_hz()

    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.models import CNNOriginalFedAvg
    from fedml_tpu_torch.core.pytree import tree_keys

    cnn = dict(CNNOriginalFedAvg(only_digits=False).named_parameters())
    leaf_sizes = {k.replace(".", "/"): p.numel() for k, p in cnn.items()}
    leaf_sizes = {k: leaf_sizes[k] for k in tree_keys(leaf_sizes)}
    rows, worst = check_kernel(leaf_sizes, round_seed_words(0, 0), sm_hz)
    k1_table = check_k1_table(leaf_sizes, round_seed_words(0, 1), sm_hz)

    cfg = config_from_argv(SLICE_ARGS)
    data, (launches, norm_launches), summary = run_slice(cfg)
    profile_rounds(cfg, data)
    round_diff = round_parity(cfg, data)

    mask_rows, mask_worst = check_secagg_kernel(leaf_sizes, sm_hz)
    k3_table = check_k3_table(leaf_sizes, sm_hz)
    turbo_cfg = config_from_argv(TURBO_ARGS)
    mask_launches, turbo = run_turbo_slice(turbo_cfg, data)
    profile_turbo(turbo_cfg, data)
    turbo_diff = turbo_round_parity(turbo_cfg, data)
    dropout_diff = turbo_dropout(turbo_cfg, data)

    from fedml_tpu_torch.shard_spine import build_shard_plan
    silo_cfg = config_from_argv(SILO_ARGS)
    plan = build_shard_plan({k.replace(".", "/"): p.detach()
                             for k, p in cnn.items()}, silo_cfg.model_shards)
    shard_sizes = {f"s{i}": plan.slice_numel(i)
                   for i in range(plan.num_shards)}
    k2_rows, k2_worst = check_shard_finalize(shard_sizes)
    k2_launches, silo = run_silo_slice(silo_cfg, data)
    profile_silo(silo_cfg, data)
    silo_diff = silo_round_parity(silo_cfg, data)

    _, device_round_cpu_diff, paths = check_device_round(data)
    scanned = run_scanned(data)
    check_byzantine(data)
    check_silo_robust(data)
    check_checkpoint(data, root)
    crash = check_silo_crash_resume(data, root)
    chaos = check_silo_chaos(data, crash["plain_round_ms"])
    mqtt = check_silo_mqtt(data)
    secagg = check_live_secagg(data, root)
    srvopt = check_live_server_opt(data, root)
    zoo = check_algorithm_zoo(data)
    cross_device = check_cross_device(data, root)
    models = check_zoo_models(sm_hz)
    machinery = check_live_machinery(data, root)
    observability = check_observability(data, root)
    mesh = check_mesh(root)
    parallel = check_parallel(root)

    flash_build = check_flash_build(libs["flash_attention"])
    flash_rows, flash_worst = check_flash_kernel()
    check_flash_nan()
    data_lm = lm_data()
    k4_launches, k4_per_round, lm_row, _ = run_lm_slice(data_lm, root)
    lm_rounds_per_s = lm_row["rounds_per_s"]
    profile_lm(data_lm)
    lm_diff = lm_round_parity(data_lm)
    lm_bench = lm_bench_step()
    lm_cli = run_lm_cli()
    mixed = check_mixed_precision(data, data_lm, root, sm_hz,
                                  lm_row["steady_round_ms"])
    serving = check_serving(data)
    tp_ep = check_tp_ep(root)
    data_layer = check_data_layer(root)
    long_tail = check_long_tail(root)

    # one round of the defended slice: the norm pass and one aggregate
    # launch over the CNN's leaves
    clean = [r for r in rows if r["leaf"] in leaf_sizes and not r["sigma"]]
    noisy, quiet = k1_table["table"][SIGMA], k1_table["table"][0.0]
    norm = k1_table["clip_norm"]
    kernels = [{
        "name": "robust_agg", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/robust_agg.cu",
        "replaces": "fedml_tpu/core/pallas_agg.py:79",
        "launches": launches,
        "max_abs_err": max(worst, *k1_table["max_abs_err"].values()),
        "ms": noisy["ms"], "plain_ms": noisy["plain_ms"],
        "bound_ms": noisy["bound_ms"], "bound_by": noisy["bound_by"],
        "bound_term": noisy["bound_term"],
        "library_ms": sum(r["library_ms"] for r in clean),
        # the kernel at the library call's configuration (sigma = 0): no
        # single PyTorch call computes the noisy function
        "ms_at_library_config": quiet["ms"],
        "gauss_max_abs_err": k1_table["gauss_max_abs_err"],
        "gauss_tol": K1_GAUSS_TOL,
        # phase 8m: the defended round of the BatchNorm ResNet-56, its
        # 292-leaf table (statistics unclipped)
        "launches_bn_defended": models["robust"]["launches"]["robust_agg"],
        # phase 8u: the defended rounds on LEAF MNIST read from its files
        "launches_leaf_mnist": data_layer["leaf"]["launches"]["robust_agg"],
        # phase 8v: the --backdoor run's defended rounds
        "launches_backdoor": long_tail["backdoor"]["launches"]["robust_agg"],
        "max_abs_err_bn_table": models["robust"]["k1"]["max_abs_err"],
        **{f"{k}_bn_table": models["robust"]["k1"]["table"][k]
           for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by")},
    }, {
        "name": "clip_norm", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/robust_agg.cu",
        "replaces": "fedml_tpu/core/pallas_agg.py:250",
        "launches": norm_launches,
        "max_abs_err": k1_table["scales_max_abs_diff"],
        "ms": norm["ms"], "plain_ms": norm["plain_ms"],
        "bound_ms": norm["bound_ms"], "bound_by": norm["bound_by"],
        # no single PyTorch call computes the per-client norm over all the
        # leaves; plain_ms is the eager clip pass the kernel replaced
        "library_ms": None,
        "launches_bn_defended": models["robust"]["launches"]["clip_norm"],
        "launches_leaf_mnist": data_layer["leaf"]["launches"]["clip_norm"],
        "launches_backdoor": long_tail["backdoor"]["launches"]["clip_norm"],
        "max_rel_err_bn_table": models["robust"]["k1"]["scales_max_rel_err"],
        **{f"{k}_bn_table": models["robust"]["k1"]["clip_norm"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
    }]
    # one round of the secure slice: one launch per group of 5
    per_round = turbo_cfg.group_num
    path = k3_table["path"]
    kernels.append({
        "name": "secagg_mask", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/secagg_mask.cu",
        "replaces": "fedml_tpu/secure/pallas_mask.py:72",
        "launches": mask_launches, "max_abs_err": mask_worst,
        "ms": per_round * path["ms"],
        "plain_ms": per_round * path["plain_ms"],
        "bound_ms": per_round * path["bound_ms"],
        "bound_by": path["bound_by"], "bound_term": path["bound_term"],
        "library_ms": None,
    })
    # one round of the cross-silo slice: one launch per S=4 shard; the
    # launches are the live server_opt phase's (adam on the sharded spine)
    shards = [r for r in k2_rows if r["shard"] in shard_sizes
              and r["sigma"]]
    clean = [r for r in k2_rows if r["shard"] in shard_sizes
             and not r["sigma"]]
    kernels.append({
        "name": "shard_finalize", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/shard_finalize.cu",
        "replaces": "fedml_tpu/core/pallas_agg.py:140",
        "launches": srvopt["k2_launches"],
        "launches_cross_silo_slice": k2_launches,
        "launches_config3": {m: r["k2_launches"]
                             for m, r in models["silo"].items()},
        # phase 8n: the sharded spine inline and with --ingest_pipeline
        "launches_live_machinery": {
            k: machinery["ingest"][k]["k2_launches"]
            for k in ("inline", "ingest")},
        # phase 8o: the spine under the instruments
        "launches_observability": {
            k: observability[k]["k2_launches"]
            for k in ("inline", "ingest", "adaptive")},
        # phase 8q: serve-while-train behind the release gate
        "launches_serve_while_train": {
            k: serving[k]["k2_launches"] for k in ("frontend", "pool")},
        "max_abs_err": k2_worst,
        "ms": sum(r["ms"] for r in shards),
        "plain_ms": sum(r["plain_ms"] for r in shards),
        "bound_ms": sum(r["bound_us"] for r in shards) / 1e3,
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in shards) else "operations"),
        "library_ms": sum(r["library_ms"] for r in clean),
        "ms_at_library_config": sum(r["ms"] for r in clean),
        "div_by_float_ms": sum(r["div_by_float_ms"] for r in clean),
    })
    # one training round of the transformer slice: n_layers x S launches of
    # each K4 kernel at the vmapped shape (4 clients x B=2)
    vmapped = flash_rows["vmap"]
    for name, line in K4_REPLACES.items():
        row = vmapped[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fedml_tpu_torch/csrc/flash_attention.cu",
            "replaces": ("jax/experimental/pallas/ops/tpu/flash_attention.py"
                         f":{line} (via fedml_tpu/models/transformer.py:55)"),
            "launches": k4_launches[name], "max_abs_err": flash_worst[name],
            "ms": k4_per_round * row["ms"],
            "plain_ms": k4_per_round * row["plain_ms"],
            "bound_ms": k4_per_round * row["bound_ms"],
            "bound_by": row["bound_by"], "bound_term": row["bound_term"],
            "tensor_core_sass": flash_build[f"{name}/d32"].get(
                "tensor_core_sass"),
            "library_ms": (k4_per_round * vmapped["sdpa_fwd_ms"]
                           if name == "flash_fwd" else None),
            # phase 8t: a rank's launches a round on the dp x tp path (its
            # H/n heads) and on the dp x ep moe8 path
            "launches_tp_per_rank_round":
                tp_ep["tp"]["k4_launches_per_rank_round"][name],
            "launches_ep_per_rank_round":
                tp_ep["ep"]["k4_launches_per_rank_round"][name],
        })
        if name == "flash_bwd_dq":
            # no single call computes dQ alone: SDPA's backward (dq, dk,
            # dv) against K4dkv + K4dq, per round
            kernels[-1]["sdpa_bwd_ms"] = k4_per_round * vmapped["sdpa_bwd_ms"]
            kernels[-1]["k4_bwd_ms"] = k4_per_round * vmapped["k4_bwd_ms"]
    # one training round of the bf16 transformer (phase 8p): n_layers x S
    # launches of each bf16 K4 kernel at the vmapped shape
    bf_rows = mixed["kernels"]["vmap"]
    for name, line in K4_BF16_REPLACES.items():
        row = bf_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fedml_tpu_torch/csrc/flash_attention.cu",
            "replaces": ("jax/experimental/pallas/ops/tpu/flash_attention.py"
                         f":{line} (via fedml_tpu/models/transformer.py:55, "
                         f"bf16 under --compute_dtype bfloat16)"),
            "launches": mixed["launches"][name],
            "max_abs_err": mixed["worst"][name],
            "ms": mixed["per_round"] * row["ms"],
            "plain_ms": mixed["per_round"] * row["plain_ms"],
            "bound_ms": mixed["per_round"] * row["bound_ms"],
            "bound_by": row["bound_by"], "bound_term": row["bound_term"],
            "tensor_core_sass": flash_build[f"{name}/d32"].get(
                "tensor_core_sass"),
            "hgmma_sass": flash_build[f"{name}/d32"].get("hgmma_sass"),
            "hmma_sass": flash_build[f"{name}/d32"].get("hmma_sass"),
            "library_ms": (mixed["per_round"] * bf_rows["sdpa_fwd_ms"]
                           if name == "flash_fwd_bf16" else None),
            # torch.profiler's kernel time (the event ms above also count
            # the wrapper's host work) and the wrapper's host µs a call
            "device_ms": (None if row["device_ms"] is None
                          else mixed["per_round"] * row["device_ms"]),
            "host_us": row["host_us"],
        })
        if name == "flash_fwd_bf16":
            sdpa_device = bf_rows["sdpa_fwd_device_ms"]
            kernels[-1]["library_device_ms"] = (
                None if sdpa_device is None
                else mixed["per_round"] * sdpa_device)
        if name == "flash_bwd_dq_bf16":
            kernels[-1]["sdpa_bwd_ms"] = (mixed["per_round"]
                                          * bf_rows["sdpa_bwd_ms"])
            kernels[-1]["k4_bwd_ms"] = (mixed["per_round"]
                                        * bf_rows["k4_bwd_ms"])
    phase("done", seconds=time.perf_counter() - t_start,
          round_vs_cpu_max_abs_diff=round_diff,
          rounds_per_s=summary["rounds_per_s"],
          turbo_round_vs_cpu_max_abs_diff=turbo_diff,
          turbo_dropout_max_abs_diff=dropout_diff,
          turbo_rounds_per_s=turbo["rounds_per_s"],
          silo_round_vs_cpu_max_abs_diff=silo_diff,
          silo_rounds_per_s=silo["rounds_per_s"],
          silo_resume_bit_equal=crash["bit_equal"],
          silo_chaos_rounds_per_s=chaos["rounds_per_s"],
          silo_mqtt_rounds_per_s=mqtt["rounds_per_s"],
          secagg_rounds_per_s=secagg["rounds_per_s"],
          secagg_vs_plaintext_max_abs_diff=max(
              secagg["vs_plaintext_max_abs_diff"]),
          server_opt_rounds_per_s={k: v["rounds_per_s"]
                                   for k, v in srvopt["runs"].items()},
          algo_rounds_per_s={k: v["rounds_per_s"] for k, v in zoo.items()},
          algo_vs_cpu_max_abs_diff={k: v["vs_cpu_max_abs_diff"]
                                    for k, v in zoo.items()},
          cross_device_rounds_per_s={
              k: v["rounds_per_s"] for k, v in cross_device["runs"].items()},
          cross_device_vs_cpu_max_abs_diff={
              k: v["max_abs_diff"] for k, v in cross_device["parity"].items()},
          cross_device_chunking=cross_device["chunking"],
          config4_rounds_per_s={k: v["rounds_per_s"] for k, v in
                                cross_device["config4"].items()},
          config4_vs_cpu_max_abs_diff=cross_device["config4_vs_cpu"],
          cross_device_seconds=cross_device["seconds"],
          zoo_rounds_per_s={
              **{f"{k} {p}": v[p]["rounds_per_s"]
                 for k, v in {**models["nwp"], **models["bn"]}.items()
                 for p in ("host_loop", "graph")},
              **{f"config3 {k}": v["rounds_per_s"]
                 for k, v in models["silo"].items()},
              "bn defended": models["robust"]["rounds_per_s"],
              "centralized": models["central"]["rounds_per_s"]},
          zoo_vs_cpu_max_abs_diff={
              k: v["vs_cpu_max_abs_diff"] for k, v in
              {**models["nwp"], **models["bn"],
               **{f"config3 {m}": r for m, r in models["silo"].items()}
               }.items()},
          zoo_graph_bit_equal=all(
              v["graph_vs_host_bit_equal"]
              for v in {**models["nwp"], **models["bn"]}.values()),
          zoo_oracle_max_abs_diff=models["oracle"]["max_abs_diff"],
          zoo_seconds=models["seconds"],
          machinery_rounds_per_s={
              "ingest inline": machinery["ingest"]["inline"]["rounds_per_s"],
              "ingest pipelined":
                  machinery["ingest"]["ingest"]["rounds_per_s"],
              "degrade": machinery["degrade"]["rounds_per_s"],
              **{f"compression {k}": v["rounds_per_s"]
                 for k, v in machinery["compression"].items()},
              "async versions": machinery["async_fl"]["versions_per_s"],
              **{f"edges {k}": machinery["edges"][k]["rounds_per_s"]
                 for k in ("plaintext", "grouped")},
              "hierarchical": machinery["hierarchical"]["rounds_per_s"]},
          machinery_seconds=machinery["seconds"],
          observability_mfu={
              k: observability[k]["mfu"]
              for k in ("inline", "ingest", "adaptive", "defended",
                        "waves", "async_fl", "edges")},
          observability_overhead_ms=observability["overhead_ms"],
          observability_seconds=observability["seconds"],
          mesh_round_ms_median={k: v.get("round_ms_median")
                                for k, v in mesh.items()
                                if k != "seconds"},
          mesh_collective_ms_median={
              k: v.get("collective_ms_median", 0.0)
              for k, v in mesh.items() if k != "seconds"},
          mesh_seconds=mesh["seconds"],
          sp_round_ms_median=parallel["sp"]["round_ms_median"],
          sp_ring_ms_median=parallel["sp"]["ring_ms_median"],
          sp_rank_peak_gb=parallel["sp"]["rank_peak_gb"],
          sp_reference_peak_gb=parallel["sp"]["reference_peak_gb"],
          pp_round_ms_median={k: v["round_ms_median"]
                              for k, v in parallel["pp"].items()},
          wave_mesh_round_ms_median=parallel["waves"]["round_ms_median"],
          wave_mesh_gather_ms_median=parallel["waves"]["gather_ms_median"],
          parallel_seconds=parallel["seconds"],
          lm_flash_vs_blockwise_max_abs_diff=lm_diff,
          lm_rounds_per_s=lm_rounds_per_s,
          lm_bench_tokens_per_s={k: v["tokens_per_s"]
                                 for k, v in lm_bench.items()},
          lm_cli_rounds_per_s=lm_cli["rounds_per_s"],
          bf16_lm_round_ms=mixed["lm"]["steady_round_ms"],
          f32_lm_round_ms=lm_row["steady_round_ms"],
          bf16_lm_vs_cpu_max_abs_diff=mixed["lm"]["vs_cpu"]["max_abs_diff"],
          moe8_round_ms={k: v["steady_round_ms"]
                         for k, v in mixed["moe"].items()},
          moe8_dropped_share={k: v["dropped_share"]
                              for k, v in mixed["moe"].items()},
          mixed_precision_vs_cpu_max_abs_diff={
              k: v["vs_cpu_max_abs_diff"]
              for k, v in mixed["images"].items()},
          mixed_precision_seconds=mixed["seconds"],
          serve_p50_ms={k: serving[k]["p50_ms"]
                        for k in ("frontend", "pool")},
          serve_p99_ms={k: serving[k]["p99_ms"]
                        for k in ("frontend", "pool")},
          serve_steady_round_ms={
              "on": serving["frontend"]["steady_round_ms"],
              "off": serving["serving_off_steady_round_ms"]},
          containment_verdicts=serving["containment"]["verdicts"],
          decode_step_ms=serving["decode"]["step_ms"],
          decode_tokens_per_s=serving["decode"]["tokens_per_s"],
          decode_occupancy=serving["decode"]["occupancy"],
          serving_seconds=serving["seconds"],
          keyed_vs_cpu_max_abs_diff={
              k: v["vs_cpu"]["max_abs_diff"]
              for k, v in tp_ep["keyed"].items()},
          pp_serve_statuses=tp_ep["pp_serve"]["statuses"],
          tp_ep_round_ms_median={k: tp_ep[k]["round_ms_median"]
                                 for k in ("tp", "ep")},
          tp_ep_collective_ms_median={k: tp_ep[k]["tp_ms_median"]
                                      for k in ("tp", "ep")},
          tp_ep_rank_peak_gb={k: tp_ep[k]["rank_peak_gb"]
                              for k in ("tp", "ep")},
          tp_ep_seconds=tp_ep["seconds"],
          data_leaf_vs_cpu_max_abs_diff=data_layer["leaf"][
              "vs_cpu_max_abs_diff"],
          data_cifar_load_partition_s=data_layer["cifar"][
              "load_partition_s"],
          data_cifar_round_ms=data_layer["cifar"]["round_ms"],
          data_augment_ms={k: v["ms"]
                           for k, v in data_layer["augment"].items()},
          data_memmap_bit_equal=data_layer["memmap"]["bit_equal"],
          data_layer_seconds=data_layer["seconds"],
          gossip_round_ms=long_tail["gossip"]["round_ms"],
          gossip_mix_ms=long_tail["gossip"]["mix_ms"],
          gossip_vs_cpu=max(long_tail["gossip"]["rounds_vs_cpu"]),
          online_steps_per_s={k: v["steps_per_s"]
                              for k, v in long_tail["online"].items()},
          online_replay_steps_per_s={
              k: v["replay_steps_per_s"]
              for k, v in long_tail["online"].items()},
          gkt_round_ms=long_tail["gkt"]["round_ms"],
          backdoor_acc=long_tail["backdoor"]["backdoor_acc"],
          long_tail_seconds=long_tail["seconds"],
          device_round_vs_cpu_max_abs_diff=device_round_cpu_diff,
          fedavg_round_ms={k: v["round_ms"] for k, v in paths.items()},
          fedavg_rounds_per_s={k: v["rounds_per_s"]
                               for k, v in scanned["default"].items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--serve-split"]:
        serve_split_main()
    else:
        main()
