"""Drive the PyTorch/H100 port (``deeplearning4j_tpu_torch``) on one card.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one Hopper GPU and the CUDA toolkit (nvcc). It exits non-zero, and
prints no result, without a CUDA device.

Phases, each an uncaught exception on failure:

1. environment: torch/CUDA versions, capability (9, 0), the card's name
   and power limit; TF32 off for the plain references.
2. build: every kernel library from ``deeplearning4j_tpu_torch/csrc``
   with nvcc for sm_90a, one nvcc each, all started together.
3. kernel checks: each forward kernel against its plain PyTorch version
   on the card at the main path's shapes (o max-abs <= 5e-2, lse max-abs
   <= 1e-2), and each backward kernel against the plain backward (dq, dk,
   dv rel-L2 <= 2e-2 in bf16, and bitwise equal over two calls); fully
   masked batch rows are checked for finiteness only. Each with its time,
   the plain version's, scaled_dot_product_attention's (forward, or its
   backward of all three gradients through ``torch.autograd.grad`` on a
   saved graph, with a boolean mask and, unmasked, with ``is_causal``; the
   faster is the yardstick) (CUDA events, median of 20 samples of 10
   back-to-back launches), and the data-sheet bound. B1 is also checked
   and timed at the flagship train step's shape (B 32, no key mask) and a
   serving admission's (8 rows, bucket 512); those lines are repeated
   before the ``kernels`` line. The biased pair (SwinV2's windows:
   ``check_bias_kernels``) at SwinV2-B's first stage (B·nW 4096, H 4,
   T 256, D 32, P 16), dbias within rel-L2 1e-3, timed beside SDPA with
   the bias as a float ``attn_mask``; its two rows join the ``kernels``
   line with phase 11c's launches.
4. serving: the flagship LM (vocab 32000, d 768, 12 heads, 12 layers,
   max_length 577, bf16, random seeded weights) behind a
   SlotGenerationEngine (8 slots, K = 4) answering 16 greedy requests;
   the short-sequence kernel must launch on every admission, at most one
   readback per decode block, and the card's prefill logits must match
   the same weights run in f32 on the CPU.
4b. paged serving and speculation, on the same net with the engine at
   t_max 576 (pages of 16, 36 a slot). Prefix sharing: 8 slots, K = 4,
   the default pool (289 pages); after one warm request, 16 requests of
   one 256-token prefix plus 64-256-token tails, 64 new tokens each: at
   least 15 x 256 prefix hit tokens, at most one readback per decode
   block, the page audit clean and nothing mapped after the drain, and a
   hit's first-token logits (prefix in pages, tail on top) against the
   whole prompt in f32 on the CPU; then the prefill of 8 tails on the
   shared pages timed against the slab's prefill of the whole prompts,
   and each of them, a paged and a slab decode block profiled.
   Concurrency: 32 slots on the 8-slot slab's bytes (289 pages), 32
   requests of 32-64 prompt tokens: at least 24 slots active at once.
   Speculation (spec_k 4), slab and paged, against the same 8 requests
   (256-token prompts repeating a 32-token motif) decoded without it,
   with the default fallback and with none (spec_threshold 0): one
   readback per verify block, the audit clean, and verify_block's window
   logits against decode_block's at the same positions.
4c. the scheduling and resilience tier, on the same net, engine t_max
   576, every timed engine with EDF, adaptive K and the numerics sentinel
   (checked in (d) to change no token). (a) chunked prefill, slab and
   paged, windows of 128: 8 short requests (32-64 tokens, 256 new)
   decoding when 4 long ones (448-512 tokens) arrive, with and without
   chunking: the longest gap between decode-block retirements of the
   short lanes and the long requests' time to first token, at most one
   readback a decode block; a 480-token prompt's final-window logits
   (slab and paged) against the whole-prompt prefill on the card and the
   CPU f32 twin (rel-L2 <= 5e-2). (b) recompute_logits on 8 rows of 512:
   12 B1 launches, logits against the prefill's. (c) 32 requests with
   mixed deadlines under headroom shedding, 4 cancelled mid-decode: every
   request ends, no slot or page left held; the K adaptive block chose
   and the block latency against its target. (d) the sentinel: a clean
   run token-identical to a sentinel-off engine's in the same call (and
   both rates), a NaN injection failing exactly its request with
   NumericalFault and none of its block's tokens, a flipped shared-prefix
   page caught by the verifier at rate 1.0. (e) EngineSupervisor: a crash
   at engine.step mid-decode; every request completes once at full
   length, with no nvcc build and no weight cast after the restart. The
   phase prints its wall time.
4d. the serving host tier (``phase_serving_host``), on the same net and
   engine shape as phase 4 (8 slots, K = 4, 64 greedy tokens): (a) the 16
   prompts through ``GenerationServingRoute`` over ``memory://`` and then
   over a ``TcpBrokerServer`` on 127.0.0.1 (an ephemeral port), tracing,
   SLO, flight recorder and profiler on: every result published once and
   equal to phase 4's direct-engine tokens, one finished trace per request
   from consume to publish, one SLO record per request, at most one
   ``engine.decode`` readback per decode block, B1 launched >= 12 x the
   admissions; the route's generated tok/s. (b) decode tok/s with every
   hook on and off, 3 alternating runs each (medians logged; no gate).
   (c) two injected ``engine.step`` crashes under EngineSupervisor with
   a post-mortem directory (``tools/chaos_soak.run_soak``), first on the
   bf16 net, then on its f32 twin: nothing stranded or failed, every
   request once at full length, one trace per request with takeover
   spans, one post-mortem per crash whose trace ids are the recovered
   ids, no kernel build or weight cast after a restart; tokens equal a
   clean run's up to each request's first crash point in bf16 (a
   recovered request re-prefills, and bf16 rounding may then part its
   greedy tokens from the uninterrupted run's, as in the JAX engine) and
   throughout on the f32 twin. (d) the
   process kill, on the f32 twin: the net written with ``write_model``;
   10 requests (16-64 new tokens, 4 slots) served by ``python -m
   deeplearning4j_tpu_torch.tools.chaos_soak --process-kill-child`` on
   the card with the journal on, SIGKILLed
   mid-stream and restarted, SIGTERMed for a ``PreemptionHandler`` drain
   that writes its handoff manifest, restarted to completion: nothing
   lost or duplicated (``FleetLedger``), tokens equal to the parent's
   uninterrupted run, SLO queue waits continuous across both outages;
   recovery and drain times and the journal-on / -off tok/s logged. (e)
   ``ParallelInference.generate`` from 4 threads: one shared engine,
   outputs equal to phase 4's.
4e. the in-process fleet (``phase_fleet``), on the same net, engines at
   t_max 576 with pages of 16, 4 slots and K = 4, every router on one
   shared decoder, 24 greedy requests (16-256 prompt tokens, 16-64 new)
   queued before the router starts: a fresh paged admission through B1
   against the plain window path (logits rel-L2 <= 5e-2). (a)
   ``EngineFleetRouter`` with 3 replicas, r0 crashed at its 6th
   ``engine.step``: every request once at full length (ledger: no
   duplicate), r0 DEAD and its requests migrated, page audits clean,
   decode readbacks <= decode blocks, B1 >= 12 launches an admission
   (re-prefills included); tokens equal to the direct paged engine's on
   the f32 twin (TF32 off), in bf16 compared and reported (a bf16
   prefill rounds by its admission wave's shape, and a fleet's waves are
   not the direct engine's). (b) aggregate generated tok/s of 1 against
   3 replicas in alternating pairs (reported). (c) ``PhaseRouter`` (1
   prefill, 2 decode workers): bf16 in process (against the direct
   engine, reported), bf16 over the per-page serialized transport
   (token-identical to the in-process run: the pages move bit-exactly)
   and the f32 twin in process (token-identical to its direct engine);
   payload bytes equal to pages x one page of every layer's pool + the
   context tokens, 2 x 12 ``kv_handoff`` readbacks an export, B1 on the
   prefill worker's admissions; then a decode worker killed mid-stream:
   its streams re-prefill, nothing lost or duplicated. (d) on the f32
   twin, a silent sign flip in r1's pool under the canary prefix: the
   next canary round quarantines r1 CORRUPT, its streams migrate, every
   result equals the direct engine's. (e) a ``BurnRateAutoscaler`` grows
   a 1-replica fleet under the burst and retires back to one (its
   decisions printed). A ``TelemetryServer`` on 127.0.0.1 over the runs'
   registry, scraped during the first disagg run: every endpoint 200,
   the fleet and disagg series in ``/metrics``, both routers' documents
   in ``/snapshot``, ``/healthz`` ok. The phase prints its wall time and
   fails past 150 s; its B1 launches join the ``kernels`` line.
4f. the process-per-replica fleet (``phase_remote``): every replica its
   own OS process (``streaming/remote.py``, started with ``python -m
   deeplearning4j_tpu_torch.streaming.remote``), serving on the card the
   flagship at full width in f32 (the model dict ``REMOTE_MODEL``: each
   worker builds the weights from its seed; pages of 16 where paged,
   t_max 576, 4 slots, K = 4) on the first 12 of phase 4e's requests,
   unpaced. ``tools/chaos_soak.run_remote_soak`` rounds A (w0 SIGKILLed
   mid-stream, respawned, re-adopted at epoch 2), B (1 prefill + 2
   decode workers, the KV pages across the wire, a decode worker
   killed; wire bytes equal the prefill worker's count when nothing was
   fenced), C (w0 SIGSTOPped until DEAD; after SIGCONT its late results
   fenced, never served) and D (the router process SIGKILLed, its
   orphans reaped, a fresh one serving the rest, exit 0, first line
   wins; D runs beside A-C, whose endpoints boot together): nothing
   lost or duplicated (ledger), tokens identical to the
   parent's in-process engine built as the workers build theirs, every
   worker on the card (its hello names ``torch.cuda.get_device_name``)
   with the parent's weights digest, no nvcc run and no weight cast on
   any live worker after recovery, B1 launched by the workers (their
   reported counts join the ``kernels`` line), no worker left alive and
   the card's free memory back within 1 GB of the phase's start. Then
   aggregate generated tok/s on the same requests, unpaced, of 1 worker
   process, 3 worker processes and the in-process ``EngineFleetRouter``
   of 3 replicas on the same f32 net, in alternating pairs (reported;
   the two endpoints boot beside the rounds and wait idle). A worker
   that sends no hello in time fails the phase with its log.
   The phase prints its wall time and fails past 180 s.
4g. mesh-sharded serving (``phase_mesh``): the flagship (a fresh bf16 net
   and its f32 twin) behind engines whose decoder shards over a (data,
   tp) mesh with every coordinate on the card (``generation_mesh(data,
   tp, devices=[cuda:0] * n)``). First B1 checked and timed against its
   plain version at the mesh's local head counts (8 admission rows,
   bucket 512, 6 and 3 heads). (1) f32 twin, TF32 off, phase 4's 16
   requests x 64 tokens, 8 slots, K = 4: meshes 2x1, 1x2, 2x2 and 1x4
   each token-identical to the unsharded engine, B1 launched exactly
   sum(min(row bucket, data)) x tp x 12 times over the admissions (the
   flight recorder's buckets), one readback a decode block gathering
   data x tp shards; generated tok/s of each mesh beside the unsharded
   engine (one card: host dispatch, not scaling); fixed-seed sampled
   tokens (8 requests x 32, T 0.8) identical across the meshes. (2) on
   2x2: the paged engine (pages of 16, t_max 576) and the speculative
   one (spec_k 4, threshold 0) token-identical to their unsharded runs,
   B1 as predicted, the pool's data copies equal outside the null page.
   (3) bf16 on 1x2: first-prefill logits within rel-L2 5e-2 of the
   unsharded decoder (tokens reported). (4) ``GenerationServingRoute``
   and ``ParallelInference(generation_mesh=)`` on 2x1, 2 requests each,
   token-identical to (1). The phase's B1 launches (the kernel checks
   aside) join the ``kernels`` line; it prints its wall time and fails
   past 120 s.
5. long prompt: the same width at 2 layers, max_length 2048,
   TransformerDecoder.generate on 4 prompts of 1536 tokens (bucket
   T = 2048 > 512): the flash kernel must launch.
6. flagship training: ``bench.py``'s training configuration (vocab 32000,
   d 768, 12 heads, 12 layers, T 512, B 32, bf16, adam lr 3e-4) through
   ``ComputationGraph.fit_batch`` on seeded random tokens: the first-step
   loss and four gradients against the same weights in f32 on the CPU (2
   rows), then 2 warm and 8 timed steps on one batch; the short-sequence
   forward and backward kernels must launch 12 times a step and the loss
   must fall.
7. long-context training: the same width at 2 layers, T 2048, B 4, 3
   steps; the flash forward, dq and dkv kernels must launch 2 times a step
   and the loss must fall.
8. char-RNN training: ``bench.py``'s char-RNN configuration (GravesLSTM
   2 x 512, vocab 80, B 64, T 128, bf16, rmsprop, l2 1e-3; lr 0.002, see
   CHARRNN_LR) through ``MultiLayerNetwork._fit_batch`` on seeded one-hot
   sequences: the first-step loss and four gradients against the same
   weights in f32 on the CPU (2 rows), then 2 warm and 8 timed steps; the
   LSTM kernel must launch 2 times a step, on its cluster route, and the
   loss must fall.
9. truncated BPTT: ``fit`` with the example's 50-step window over the same
   T 128 batch (3 windows): 2 launches per window, the (h, c) carry handed
   from each window to the next.
10. sampling: ``CharacterIterator.sample`` of 100 characters through
   ``rnn_time_step`` on the trained net: 2 launches and one readback per
   character; the card's next-character probabilities match the CPU f32
   twin's.
10b. the char-RNN as a ``ComputationGraph`` (``phase_graph_rnn``, the
   same width, bf16, TBPTT window 50): ``fit_batch`` (3 windows, 2 x 3
   B6 launches a step), ``evaluate`` and ``evaluate_roc_multi_class``
   over 4 batches (one readback a batch), 16 steps of ``rnn_time_step``
   against the twin's full sequence, and 200 sampled characters (one B6
   launch a layer and one readback a character); the first window's loss
   and gradients and the evaluation's accuracy against the CPU f32 twin.
11. ResNet-50: ``bench.py``'s configuration (``resnet50_conf(1000, 224,
   224, 3)``, nesterovs lr 0.1, l2 1e-4, bf16 on f32 masters) through
   ``ComputationGraph.fit_batch`` on seeded synthetic images: against the
   CPU f32 twin, the bf16 net's inference logits at B 4 (rel-L2 <= 5e-2)
   and first-step loss at B 8 (rel 2e-2), and the same weights in f32 on
   the card for the first step's loss, gradients (rel-L2 5e-2) and
   running statistics after it (rel-L2 2e-2); then 2 warm and 8 timed
   steps at B 128 in which every batch norm runs its kernel (16
   batchnorm_add_act_train tails and 37 batchnorm_train a step, each with
   its backward), the step floor from the configuration's FLOPs and bytes,
   peak memory, and a profiled step with no layout-transpose kernel, 106
   batch-norm kernels (one a direction for each of the 53 BN layers) and
   no ReLU operator outside them, its launches and device time logged
   beside those of the earlier three-kernel batch-norm design (PERF.md);
   from a fresh init at lr 0.01 the loss must fall over 6 steps.
11c. SwinV2-B (``phase_swin``: ``swinv2_conf()``, 256², window 16,
   depths 2 / 2 / 18 / 2, Adam, bf16 on f32 masters) through
   ``ComputationGraph.fit_batch`` on B 16 seeded noise images: 2 warm and
   3 counted steps, stages 1-2 shifting every other block and stages 3-4
   clipping the window to the resolution; every block's attention on the
   biased pair (one forward and one backward launch a block and step),
   none on the unbiased B1 / B2, the loss finite. Its counts are the
   biased rows' launches.
12. LeNet (``lenet_conf``, lr 0.02, f32, B 128) through
   ``MultiLayerNetwork.fit`` on synthetic MNIST: ms a step; VGG16
   (``vgg16_conf``, 224 x 224, B 4) forward against its CPU f32 twin
   (rel-L2 <= 5e-2).
12b. evaluation (``phase_evaluate``): ResNet-50's ``evaluate`` over 4
   synthetic batches of 128 in bf16 (one readback a batch, its counts
   equal to argmax of ``output()``); LeNet's ``evaluate`` and
   ``score_examples`` (f32, B 128) against its CPU f32 twin; a LeNet with
   a batch norm after each conv (C 20, 50) trained 4 steps in bf16 and
   f32 with every BN on its kernel, against its twin.
13. the training API (``phase_training_api``, within 90 s): (a) the
   char-RNN (2 x 512, vocab 80, B 64, T 128, bf16, TBPTT 50) trained 2
   batches, then ``TransferLearning.Builder`` freezes layer 0 and puts a
   new head on, and an ``EarlyStoppingTrainer`` (3 epochs at most,
   patience 1, ``LocalFileModelSaver`` in a temporary directory) fits 4
   batches that ``AsyncDataSetIterator`` stages in bf16 on the card,
   scored on 2 held out: layer 0 bit-identical to the source, layer 1
   moved, the restored best model's score equal to the recorded one, B6
   launched 2 times a window and a scored batch, on its cluster route;
   (b) an encoder / decoder graph (GravesLSTM 512 over a masked one-hot
   input, ``LastTimeStepVertex``, ``DuplicateToTimeSeriesVertex``,
   ``MergeVertex`` with the decoder input, GravesLSTM 512, softmax head;
   bf16, B 64, T 128): logits (rel-L2 5e-2) and first-step loss (rel
   2e-2) against the CPU f32 twin on 2 rows, 1 warm and 4 timed steps,
   2 B6 launches a step; (c) plain torch, no kernel: 784 → AutoEncoder
   (500) → RBM(250) → VAE(32) → Output(10) pretrained over 8 synthetic
   batches of 128 (every layer's loss finite and falling, the
   AutoEncoder's and RBM's first-batch losses within 1e-4 of the CPU f32
   twin) and fitted, and 3 steps of a center-loss head (losses within
   1e-4 of the twin, the centers moved); (d) ResNet-50 (bf16, B 128)
   frozen below avgpool with a new 10-class head: 1 warm and 3 timed
   steps, the frozen vertices bit-identical, 106 batch-norm kernel
   launches a step, then ``GraphTransferLearningHelper``'s featurize and
   3 ``fit_featurized`` epochs moving only the head.
14. data-parallel training (``phase_data_parallel``, within 120 s), every
   data shard on the card (``make_mesh(devices=[cuda:0] * n)``): (1) the
   flagship LM (vocab 32000, d 768, 12 heads, 12 layers, T 512). Its f32
   twin (TF32 off), 2 steps each of ``GraphDataParallelTrainer`` and
   ``ParallelWrapper`` at data 2 and 4 on B 8, and both at data 4 on a
   ragged B 6 (padded to 8 with zero-weight rows), against 2 solo
   ``fit_batch`` steps from the same weights: each step's loss within rel
   1e-6, the parameters within rel-L2 1e-5, B1 and B2 each 12 x data x 2.
   In bf16, global B 32, 2 warm + 4 timed steps of the graph trainer at
   data 2 and 4 beside the solo step: the loss finite and falling, the
   first-step loss within rel 2e-2 of the solo step's, B1 and B2 each
   exactly 12 x data x 6, ms a step beside the solo step's (one card:
   host dispatch over the shards, not scaling; reported). (2) local steps
   on the bf16 net, data 2, k 2, 2 rounds: the replicas bitwise equal
   after each round, the round score falling, B1 = B2 = 96; then one
   round with ``gradient_compression`` 5e-4: its sent fraction in (0,
   1]. (3) a masked LSTM (32 units, f32, 7 ragged rows) under sync DP at
   data 2 against a solo step: parameters within rel-L2 1e-5, B6 once a
   shard. (4) sync DP at data 2 of a net with a batch norm (f32) against
   a solo step: parameters and running statistics within rel-L2 1e-5, the
   batch norm across the shards. (5) on small nets on the card:
   ``ParameterServerParallelWrapper(backend="native")`` with 2 workers
   (the native store built and used, pushes >= the batches),
   ``EarlyStoppingParallelTrainer``, the CLI
   (``parallel/main.py --workers 2``) and ``ClusterDl4jMultiLayer`` with 2
   executors, each with its held-out loss falling. The phase's B1, B2 and
   B6 launches join the ``kernels`` line; it prints its wall time and
   fails past 120 s.
15. model parallelism (``phase_model_parallel``, within 120 s), every
   shard on the card: (1) the flagship LM (vocab 32000, d 768, 12 heads,
   12 layers, T 512) through ``GraphSequenceParallelTrainer`` (the
   vertex-synchronous walk of ``parallel/sharded.py``, attention on the
   ring over B3 / B4 / B5, each shard's embedding at its absolute
   positions): its f32 twin (TF32 off), 2 steps at sp 2, sp 4 and (data
   2, sp 2) on B 4 against 2 solo steps (each step's loss within rel
   1e-5, the parameters within rel-L2 1e-4); in bf16 on B 8, 1 warm and 3
   timed steps a mesh beside the solo step (first-step loss within rel
   2e-2, ms a step); the long context (the same width at 2 layers, B 4,
   T 2048, sp 4: shards of 512) the same way. B3, B4 and B5 launch
   exactly layers x data x sp(sp+1)/2 times a step (the causal ring skips
   strictly-future pairs), B1 and B2 never. (2) ResNet-50 (``bench.py``'s
   configuration) under sync DP at data 2, every batch norm across the
   shards (``batchnorm.cu``'s ``batchnorm_xs_*`` phases): the f32 twin
   (B 8) within phase 11's gradient bar of the solo step's update and
   its running statistics within rel-L2 1e-4; bf16 at global B 128, 1
   warm and 2 timed steps beside the solo step: the first-step loss
   within rel 2e-2, the running statistics after it within 2e-2, every
   phase launched 53 x (2, 1, 2) times a direction a step and no
   single-shard BN kernel; a center-loss head after a batch norm (f32,
   data 2) against a solo step (its centers moved by the global batch's
   class means). (3) ``TensorParallelTrainer`` on LeNet (f32, B 128) at
   (1, 2) and (2, 2), (4) ``ExpertParallelTrainer`` on a Switch MoE (d
   768, 8 experts, hidden 3072, 512 tokens) at ep 2 and 4, (5)
   ``PipelineParallelTrainer`` (8 tanh Dense 768 blocks and a head, pipe
   4, M 4, B 256) against the one-stage stack: the parameters within
   rel-L2 1e-5 after 2 steps, each shard's local shape, ms a step beside
   the unsharded run. The phase's B3 / B4 / B5 and cross-shard BN
   launches join the ``kernels`` line; it prints its wall time and fails
   past 120 s.
16. data and Keras models to the card (``phase_data_and_keras``, within
   120 s; every file it reads it writes first, into a temporary
   directory). (a) IDX files of 60,000 + 10,000 synthetic glyphs (uint8,
   ``datasets/mnist.py``'s stand-in): ``MnistDataSetIterator`` finds them
   through ``MNIST_DIR``; with shuffle off the native loader
   (``csrc/dataloader.cpp``, built by g++) gives the Python iterator's
   batches bit for bit (flattened, B 64); LeNet (``lenet_conf``) trains
   one epoch at B 64 from the native loader through
   ``AsyncDataSetIterator(device=cuda)``: the loss falls, the test
   accuracy reaches 0.95; ms a step, each loader's batches/s alone and
   the device's busy share over 100 profiled steps. (b) the 10,000 test
   rows as a 785-column CSV: ``NativeCSVDataSetIterator`` and
   ``RecordReaderDataSetIterator(CSVRecordReader)`` give equal batches;
   rows/s of each. (c) ``export_resnet50_keras_h5`` (224 x 224 x 3, 1000
   classes) imported by ``KerasModelImport`` on the card: f32 logits (TF32
   off, B 8) within rel-L2 1e-5 of ``resnet50_conf`` carrying the same
   arrays; bf16 at B 128, 1 warm and 2 timed steps of the imported and
   the native graph in turns, twice: 106 batch-norm kernel launches a step
   each (the fusion plan takes the import's 16 BN -> add -> Activation
   tails) and ms a step; then ``examples/transfer_learning.py``'s
   workflow: frozen below avgpool, a new 4-way head, 6 steps at B 32, the
   frozen parameters bit-identical and the loss falling. (d) the native
   VGG16's initialized weights written as a Keras 2 Sequential file
   (about 0.55 GB) and loaded by ``TrainedModels.vgg16(weights_h5=)`` on
   the card: f32 logits at B 4 within rel-L2 1e-5 of the native net;
   ``ImageNetLabels.decode_predictions`` over a labels JSON. (e) a Keras
   Sequential of 2 LSTM(512) with hard_sigmoid gates and a
   TimeDistributed softmax Dense over 80 classes (B 64, T 128): f32
   logits on B6 within rel-L2 1e-5 of the plain recurrence (the same file
   imported on the CPU), one B6 launch a layer; a warm and a counted bf16
   step, 2 B6 launches, its loss finite. (f)
   ``KerasBackendServer(device=cuda)`` over HTTP on (c)'s file:
   ``/predict`` at B 2 equal to the direct import's output (max-abs
   1e-6), ``/fit``, ``/evaluate``, ``/save``, ``/load``, and the reloaded
   net predicting as the saved one. Its BN and B6
   launches join the ``kernels`` line.
17. word and graph embeddings (``phase_nlp_graph``, within 120 s) on a
   corpus made from the seed: 2,000,000 tokens in sentences of 8-24, a
   Zipf(1.0) vocabulary of 50,000 types in 20 topic blocks (``NLP_SHAPES``).
   (a) Word2Vec with Word2VecRawTextExample's settings (layer 100, window
   5, min count 5, seed 42, HS, one epoch) through the corpus scan: V
   after min count, each table's segment-update route, tokens/s, the
   busy share and launches a step of the fit's first 64 steps, profiled
   again on copies of its tables; in-topic cosine above cross-topic. (b) the NS scan at layer 300, 5 negatives,
   shared, over the corpus, and per pair over a 200,000-token prefix:
   tokens/s each, the loss finite. (c) on the prefix, the seeded NS scan
   twice: syn0 bitwise equal; the HS per-batch fit on the card against
   the CPU's plain path (the rel-L2 of the change to syn0 / syn1 <=
   NLP_CPU_BF16_TOL on the one-hot route, NLP_CPU_TOL on the f32 route;
   the CPU side runs in a thread beside (c)'s card runs and (d), after
   the timed scans). (d) (b)'s
   vectors through ``Word2VecDataSetIterator`` (2-topic documents, B 64,
   cut at T 256, masked) into GravesLSTM(256) -> RnnOutputLayer(2,
   mcxent), 2 epochs of 3 batches in f32 and in bf16: B6 once a step,
   the epoch loss falling, B6 on the first batch with the trained
   weights against ``lstm_recurrence_plain`` within LSTM_TOL (those
   launches not counted). (e) ParagraphVectors DBOW (2,000 documents of
   100 tokens, 5 epochs) with ``infer_vector`` on 100 held out, their
   topic by the nearest training centroid at 3x chance or better; GloVe
   over the prefix (in-topic cosine above cross-topic); DeepWalk (d 128,
   window 10, walk length 40, 2 walks a vertex, cut from the paper's 80)
   on a 10,312-vertex, 333,983-edge graph of 39 planted groups (in-group
   cosine above across). (f) (c)'s vectors as text and binary files and
   DeepWalk's as a graph-vector file, read back (max-abs NLP_TXT_TOL,
   the binary bitwise). Its B6 launches join the ``kernels`` line.
18. clustering and the UI: (a) ``BarnesHutTsne`` at its defaults
   (perplexity 30, 1000 iterations, 64 negatives) over phase 17's HS
   syn0 at unit length, twice: bitwise equal, one segment-update launch
   an iteration (the attractive sum), the kNN and iteration times, a
   profiled window's launches and busy share, and the share of each
   topic word's 10 nearest 2-D neighbours from its own topic
   (TOPIC_2D_BAR) beside the same share in 100-D; (b) the exact route on
   the 8,192 most frequent words (20 iterations after 300, card against
   CPU, rel-L2 TSNE_EXACT_TOL) and the dense f64 ``Tsne`` on the 2,000
   most frequent (50 iterations, TSNE_DENSE_TOL); (c) ``KMeansClustering``
   (k 20) twice, bitwise, one cost readback an iteration, the CPU's
   assignments on KMEANS_AGREE_BAR of the rows; (d) LeNet 8 steps under
   ``StatsListener`` (readbacks counted) into sqlite with the flow and
   convolutional listeners, ``UIServer`` serving the updates, a remote
   push, the activation PNG and a ``profiler_trace`` with CUDA kernels;
   (e) ``NormalizerStage`` + ``NetworkClassifier`` on the Iris data
   (IRIS_ACC_BAR). Within CLUSTER_LIMIT_S; its segment-update launches
   join the ``kernels`` line.
19. the analysis tier (``phase_analysis``, within ANALYSIS_LIMIT_S), on
   phase 4's flagship (vocab 32000, d 768, 12 heads, 12 layers, bf16,
   the same seeded weights): (a) ``scripts/torch_lint.py``'s gate — the
   port's linter over ``deeplearning4j_tpu_torch`` and this script on
   the card's host: its seconds, its findings and those beyond the
   port's baseline (must be 0); (b) ``SlotGenerationEngine`` (8 slots,
   K 4) under ``EngineSupervisor``, both with their locks wrapped by
   ``LockAudit.instrument`` (the inherited ``_lock`` pinned to
   ``HeartbeatMonitor._lock``): a warm request, then 8 requests (64-256
   prompt tokens, 32 new) with an ``engine.step`` crash injected
   mid-decode, served under a ``LockAudit(patch=True)`` that audits the
   engine the takeover builds: every request once at full length, one
   restart, no observed cycle, and against the static lock-order graph
   (``lock_order_edges``) no inversion and no novel edge, with
   ``EngineSupervisor._sup_lock -> SlotGenerationEngine._lock``
   explained; the same for a ``TcpMessageBroker`` client
   (``_sub_lock -> _send_lock`` explained); (c) ``TransferAudit`` over
   the served part: at most one ``engine.decode`` readback a decode
   block, its ``report()``; (d) ``CompileAudit`` over the served part:
   ``check(total=0)`` (no nvcc run and no library load after warmup),
   and the whole process's builds and loads so far, each library built
   and loaded at most once, no duplicate signature; (e) B1's launches in
   the phase (>= 12 an admission), which join the ``kernels`` line.
20. the ``kernels`` JSON line, then the ``ok`` JSON line last.

Phase 3 also holds the ring (``parallel/sequence.py``'s ``_RingFlash``:
causal bf16 q / k / v at phase 15's shapes, B 8 x T 512 at sp 4 and 2,
B 4 x T 2048 at sp 4) against the plain streaming ring in f32 (o max-abs
<= 5e-2, dq / dk / dv rel-L2 <= 2e-2, B3 / B4 / B5 each sp(sp+1)/2
launches), timed forward + backward beside the plain ring, SDPA on the
unsharded q / k / v and the bound; and the batch norm across 2 shards
(``bn_train_shards``) at every ResNet-50 site and variant a step runs
against the plain version on the whole batch, each phase launched once a
shard (the finalize once) a direction, timed beside the plain version and
F.batch_norm on the whole batch, summed over the step's sites. Both are
rows of the ``kernels`` line (``ring_attention``, ``batchnorm_cross_shard``).

Phase 3 also holds the three batch-norm variants of ``csrc/batchnorm.cu``
(an identity BN, a BN with its ReLU folded in, the fused BN -> add ->
ReLU tail) against their plain versions at every (M, C) site of the
ResNet-50 step (bf16: y / dx rel-L2 <= 1e-2; f32: <= 1e-5; mean / var /
dgamma / dbeta <= 1e-5 in both; bitwise equal over two runs; the tail's
dres exact; the folded ReLU's recomputed mask equal to the forward's y >
0), times each where the step runs it (its two kernels' device time,
and the wrapper calls' back to back) beside its bytes bound, the plain
version and its yardstick
(``F.batch_norm``'s forward + backward, composed with relu, or with the
add and relu, for the variants no single PyTorch call computes), sums
those over one step's sites for the ``kernels`` line. Its C4 rows
(``check_c4_variants``) hold the shapes the card used to refuse (fault
C4) against their plain versions and time them, printed in a
``c4_variants`` JSON line: batch norms of C 3, 20 and 50 in bf16, f32
and f16 and of C 8192 bf16 / 4096 f32 (the general route, where the
fused one does not take them); LSTMs with hardsigmoid / softsign and
relu / identity, in f16, in f32 at H 2048 (the streamed route), and with
the row-wise softmax gate / tanh cell and sigmoid gate / logsoftmax cell
(f32 and bf16, T 32, N 64, H 512, and softmax / tanh at H 2048 on the
streamed route; held against the plain loop run in f64, within the
dtype's tolerance times each output's largest value, a limit the plain
loop in the dtype must meet too; the logsoftmax-cell inputs are scaled
by 0.05, below which the recurrence contracts); attention
at D 36 (zero-padded), D 256 (the CUDA-core DMAX 256 instance) and D 264,
320, 512 (the output's columns split over the grid), short and flash,
forward and backward; and a sweep that no head dim and no activation of
``ops/activations.py`` (as gate and as cell) raises on the card.

The LSTM kernel (B6) is checked in phase 3 against its plain version on
both of its routes (``LSTM_CASES``): the cluster route at the char-RNN's
shape (T 128, N 64, H 512, bf16) with and without peepholes, masked, and
at N 61; the cooperative route in f32 and in bf16 at H 600. Each launch
must take the route named; each route is timed, beside the cuDNN LSTM
layer (``torch.nn.LSTM``, the same weights) as the yardstick. Phases 8
and 9 must run every LSTM launch on the cluster route, phase 10 (f32) on
the cooperative one. The B4 + B5 line before the ``kernels`` line sets
the flash backward's two kernels against SDPA's whole backward.
"""

import copy
import gc
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis import (CompileAudit, LintRunner,
                                               LockAudit, TransferAudit,
                                               load_baseline, new_findings)
from deeplearning4j_tpu_torch.analysis.concurrency import lock_order_edges
from deeplearning4j_tpu_torch.clustering import (BarnesHutTsne,
                                                 KMeansClustering, Tsne)
from deeplearning4j_tpu_torch.clustering.bhtsne import _knn_chunked as bh_knn
from deeplearning4j_tpu_torch.clustering.bhtsne import \
    _iteration_exact as bh_iter_exact
from deeplearning4j_tpu_torch.clustering.bhtsne import \
    _iteration_ns as bh_iter_ns
from deeplearning4j_tpu_torch.cluster import (
    ClusterDl4jMultiLayer, DistributedDataSet, NetworkClassifier,
    NormalizerStage, ParameterAveragingTrainingMaster, Pipeline)
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.kernels import cuda_lib
from deeplearning4j_tpu_torch.kernels.flash_backward import (
    flash_backward, flash_backward_dkv, flash_backward_dq)
from deeplearning4j_tpu_torch.kernels.flash_forward import (
    flash_forward, flash_forward_plain)
from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
from deeplearning4j_tpu_torch.kernels import lstm as lk
from deeplearning4j_tpu_torch.kernels import segment_update as sgk
from deeplearning4j_tpu_torch.kernels.shortseq_attention import (
    attention_bwd_plain, attention_fwd_plain, row_delta,
    short_attention_bias_bwd, short_attention_bias_fwd, short_attention_bwd,
    short_attention_fwd)
from deeplearning4j_tpu_torch.models import (CharacterIterator,
                                             ImageNetLabels,
                                             SlotGenerationEngine,
                                             TrainedModels,
                                             TransformerDecoder,
                                             char_rnn_conf, lenet_conf,
                                             lm_batch_sparse, resnet50_conf,
                                             swinv2_conf,
                                             transformer_lm_conf, vgg16_conf)
from deeplearning4j_tpu_torch.datasets import (AsyncDataSetIterator,
                                               CSVRecordReader,
                                               DataSetIterator,
                                               ListDataSetIterator,
                                               MnistDataSetIterator,
                                               RecordReaderDataSetIterator)
from deeplearning4j_tpu_torch.datasets.mnist import (IrisDataSetIterator,
                                                     _read_idx)
from deeplearning4j_tpu_torch.datasets.mnist import \
    _synthetic as mnist_synthetic
from deeplearning4j_tpu_torch.datasets.native_loader import (
    NativeCSVDataSetIterator, NativeMnistDataSetIterator, native_available)
from deeplearning4j_tpu_torch.keras import (KerasBackendServer,
                                            KerasModelImport)
from deeplearning4j_tpu_torch.keras.export import (export_resnet50_keras_h5,
                                                   write_keras_h5)
from deeplearning4j_tpu_torch.earlystopping import (
    DataSetLossCalculator, EarlyStoppingConfiguration, EarlyStoppingTrainer,
    LocalFileModelSaver, MaxEpochsTerminationCondition,
    ScoreImprovementEpochTerminationCondition)
from deeplearning4j_tpu_torch.graph_embeddings import (DeepWalk, Graph,
                                                       GraphVectorSerializer)
from deeplearning4j_tpu_torch.nlp import (Glove, ParagraphVectors,
                                          StaticWord2Vec, Word2Vec,
                                          Word2VecDataSetIterator,
                                          WordVectorSerializer)
from deeplearning4j_tpu_torch.nlp import skipgram as psg
from deeplearning4j_tpu_torch.nlp.huffman import build_huffman
from deeplearning4j_tpu_torch.nlp.skipgram import (segment_route,
                                                   skipgram_hs_corpus_scan,
                                                   skipgram_ns_corpus_scan)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, RBM, AutoEncoder, BatchNormalization, CenterLossOutputLayer,
    ConvolutionLayer, DenseLayer, GravesLSTM, OutputLayer, PatchMerging,
    RnnOutputLayer, SwinV2Block, VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.conf.layers.swin import window_of
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               DuplicateToTimeSeriesVertex,
                                               LastTimeStepVertex,
                                               MergeVertex,
                                               infer_graph_shapes)
from deeplearning4j_tpu_torch.nn.transfer import (FineTuneConfiguration,
                                                  GraphTransferLearningHelper,
                                                  TransferLearning)
from deeplearning4j_tpu_torch.nn.graph.vertices import LayerVertex
from deeplearning4j_tpu_torch.observability import (IntegrityConfig,
                                                    NumericalFault)
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.dataset import (DataSet, MultiDataSet,
                                                  NormalizerStandardize)
from deeplearning4j_tpu_torch.ops.rng import fold_in, generator
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts, fetch_shards
from deeplearning4j_tpu_torch.parallel import (
    EarlyStoppingParallelTrainer, EngineSupervisor, ExpertParallelTrainer,
    FaultInjector, GraphDataParallelTrainer, GraphSequenceParallelTrainer,
    MixtureOfExpertsLayer, ParallelInference, ParallelWrapper,
    ParameterServerParallelWrapper, PipelineParallelTrainer,
    TensorParallelTrainer, generation_mesh, make_mesh, mesh_tag)
from deeplearning4j_tpu_torch.parallel.main import main as dp_main
from deeplearning4j_tpu_torch.parallel.native_ps import NativeParameterServer
from deeplearning4j_tpu_torch.parallel.sequence import ring_attend
from deeplearning4j_tpu_torch.parallel.wrapper import tree_leaves
from deeplearning4j_tpu_torch.observability import (FlightRecorder,
                                                    MetricsRegistry,
                                                    PhaseProfiler, SLOTracker,
                                                    TraceRing)
from deeplearning4j_tpu_torch.observability import TelemetryServer
from deeplearning4j_tpu_torch.streaming import (BurnRateAutoscaler,
                                                EngineFleetRouter,
                                                GenerationServingRoute,
                                                InProcessKVTransport,
                                                NDArrayPublisher,
                                                NDArraySubscriber,
                                                PhaseRouter,
                                                SerializedKVTransport,
                                                TcpBrokerServer,
                                                create_broker)
from deeplearning4j_tpu_torch.streaming.tcp_broker import TcpMessageBroker
from deeplearning4j_tpu_torch.tools import chaos_soak
from deeplearning4j_tpu_torch.ui import (ConvolutionalIterationListener,
                                         FlowIterationListener,
                                         RemoteStatsRouter,
                                         SqliteStatsStorage, StatsListener,
                                         UIServer, profiler_trace)
from deeplearning4j_tpu_torch.tools.bn_probe import device_ms
from deeplearning4j_tpu_torch.utils import (ModelSerializer,
                                            graph_from_numpy,
                                            network_from_numpy)

#: H100 SXM data-sheet peaks (not measured): HBM bytes/s, dense bf16
#: (and f16) FLOP/s on the tensor cores, f32 FLOP/s on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
O_TOL, LSE_TOL = 5e-2, 1e-2
#: relative L2 of a bf16 backward kernel's dq / dk / dv against the plain
#: f32 backward: p and ds round to bf16 (~0.4%) before their products
GRAD_TOL = 2e-2
#: card bf16 train step against the CPU f32 twin on the same 2 rows: the
#: first-step loss (relative) and the relative L2 of four gradients
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 2e-2, 5e-2
#: relative L2 of the card's bf16 kernel-path logits against the CPU f32
#: plain path: bf16 rounds activations and weights (~0.4% each) through
#: every layer; 5e-2 bounds that drift with margin and still catches a
#: wrong attention (which moves the logits by O(1))
LOGIT_REL_TOL = 5e-2
#: max-abs of the LSTM kernel's y, hT and cT against the plain version: in
#: f32 the two sum a gate's H products in other orders (~1e-6 per step,
#: carried through 128 dependent steps); in bf16 both round h and c to
#: bf16 every step, so an order difference can flip a rounding (4e-3 at
#: |h| ~ 1), and the flip carries forward
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
#: max-abs of the cuDNN LSTM layer against the port's in f32 (TF32 off):
#: a semantics check of the yardstick (gate order, weights), not a bound
CUDNN_AGREE_TOL = 1e-3
#: the char-RNN phases' learning rate. bench.py keeps char_rnn_conf's 0.1:
#: there rmsprop's first step moves every weight by ~0.45 and inflates the
#: l2 term, so the loss cannot be seen to fall in 10 steps; the step's
#: cost does not depend on it
CHARRNN_LR = 0.002
#: next-character probabilities of the card (kernel path, f32) against the
#: CPU f32 twin: summation order only
SAMPLE_PROB_TOL = 1e-4

#: every kernel of the port: its library (csrc/<lib>.cu), the TPU kernel
#: it replaces, its wrapper (which counts launches) and its plain version
KERNELS = {
    "shortseq_attention": {
        "lib": "shortseq_attention",
        "replaces": "deeplearning4j_tpu/kernels/pallas_shortseq.py:127",
        "wrapper": short_attention_fwd, "plain": attention_fwd_plain},
    "flash_forward": {
        "lib": "flash_forward",
        "replaces": "deeplearning4j_tpu/kernels/pallas_attention.py:67",
        "wrapper": flash_forward, "plain": flash_forward_plain},
    "shortseq_attention_bwd": {
        "lib": "shortseq_attention_bwd",
        "replaces": "deeplearning4j_tpu/kernels/pallas_shortseq.py:160",
        "wrapper": short_attention_bwd, "grads": (0, 1, 2)},
    # B1 / B2 with an additive f32 logit bias (SwinV2's windows; no TPU
    # kernel): checked by check_bias_kernels
    "shortseq_attention_bias": {
        "lib": "shortseq_attention", "replaces": None,
        "wrapper": short_attention_bias_fwd, "plain": attention_fwd_plain},
    "shortseq_attention_bias_bwd": {
        "lib": "shortseq_attention_bwd", "replaces": None,
        "wrapper": short_attention_bias_bwd, "grads": (0, 1, 2, 3)},
    "flash_backward_dq": {
        "lib": "flash_backward",
        "replaces": "deeplearning4j_tpu/kernels/pallas_attention.py:114",
        "wrapper": flash_backward_dq, "grads": (0,)},
    "flash_backward_dkv": {
        "lib": "flash_backward",
        "replaces": "deeplearning4j_tpu/kernels/pallas_attention.py:153",
        "wrapper": flash_backward_dkv, "grads": (1, 2)},
    "lstm_recurrence": {
        "lib": "lstm",
        "replaces": "deeplearning4j_tpu/kernels/lstm.py:42",
        "wrapper": lk.lstm_recurrence_fwd, "plain": lk.lstm_recurrence_plain},
    # the JAX package's fused batch-norm helpers (jnp custom VJPs, not
    # Pallas): "wrapper" counts forward launches, "bwd" backward ones
    "batchnorm_train": {
        "lib": "batchnorm",
        "replaces": "deeplearning4j_tpu/kernels/batchnorm.py:44",
        "wrapper": bnk.bn_train_fwd, "bwd": bnk.bn_train_bwd},
    "batchnorm_add_act_train": {
        "lib": "batchnorm",
        "replaces": "deeplearning4j_tpu/kernels/batchnorm.py:120",
        "wrapper": bnk.bn_add_act_fwd, "bwd": bnk.bn_add_act_bwd},
    # the embedding tables' segment update (a jnp one-hot matmul or
    # scatter-add in the JAX package, not Pallas): deterministic on the card
    "segment_update": {
        "lib": "segment_update",
        "replaces": "deeplearning4j_tpu/nlp/skipgram.py:150",
        "wrapper": sgk.segment_update, "plain": sgk.segment_update_plain},
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, reps: int = 20, batch: int = 10) -> float:
    """Median over ``reps`` samples of the device time per ``fn()`` call in
    ms; each sample brackets ``batch`` back-to-back warm calls with CUDA
    events, so the host's enqueue time hides behind the device's work
    (``batch=1`` keeps host dispatch in, for host-bound paths)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


#: the cross-shard batch norm's three phases (``csrc/batchnorm.cu``'s
#: ``batchnorm_xs_*``), each counting forward and backward launches
XS_WRAPPERS = {"batchnorm_xs_stats": bnk.bn_xs_stats,
               "batchnorm_xs_finalize": bnk.bn_xs_finalize,
               "batchnorm_xs_apply": bnk.bn_xs_apply}


def reset_launches():
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
        if "bwd" in spec:
            spec["bwd"].launches = 0
    for fn in XS_WRAPPERS.values():
        fn.launches = fn.bwd_launches = 0
    lk.lstm_recurrence_fwd.routes = dict.fromkeys(lk.ROUTES, 0)


def read_launches():
    """Launches by kernel since the last reset_launches(); a kernel with a
    backward wrapper also as "<name>.bwd", and each cross-shard batch-norm
    phase as "batchnorm_xs_<phase>" and "...bwd"."""
    out = {n: s["wrapper"].launches for n, s in KERNELS.items()}
    out.update({f"{n}.bwd": s["bwd"].launches for n, s in KERNELS.items()
                if "bwd" in s})
    for n, fn in XS_WRAPPERS.items():
        out[n], out[f"{n}.bwd"] = fn.launches, fn.bwd_launches
    return out


def lstm_routes():
    """B6's launches by route since the last reset_launches()."""
    return dict(lk.lstm_recurrence_fwd.routes)


# ----------------------------------------------------------------- phase 1
def phase_environment() -> str:
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"capability {cap}")
    log(f"card: {card}")
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"the port's kernels are built for sm_90a; "
                           f"device capability is {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------- phase 2
def phase_build():
    t0 = time.perf_counter()
    libs = sorted({spec["lib"] for spec in KERNELS.values()})
    logs = cuda_lib.build(libs)
    log(f"build: {time.perf_counter() - t0:.1f}s wall for {libs} "
        f"(nvcc {' '.join(cuda_lib.NVCC_FLAGS)})")
    for name, info in logs.items():
        log(f"  {name}: nvcc {info['seconds']:.1f}s")
        for kernel, usage in _ptxas_usage(info["log"]):
            log(f"    {kernel}: {usage}")


def _kernel_name(mangled):
    """A mangled kernel symbol as ``name<dtype, int args>``: the first
    length-prefixed identifier ending in "kernel", its 16-bit element type
    and its integer template arguments."""
    idents, i = [], 0
    while i < len(mangled):
        digits = re.match(r"\d+", mangled[i:])
        if digits:
            j = i + len(digits.group())
            idents.append(mangled[j:j + int(digits.group())])
            i = j + int(digits.group())
        else:
            i += 1
    name = next((w for w in idents if w.endswith("kernel")), mangled)
    args = [t for key, t in (("__nv_bfloat16", "bf16"), ("__half", "f16"))
            if key in mangled] + re.findall(r"Li(\d+)E", mangled)
    return f"{name}<{', '.join(args)}>"


def _ptxas_usage(text):
    """(kernel, "registers; spills") per kernel in nvcc's -Xptxas -v
    output."""
    out, kernel, spills = [], "?", ""
    for line in text.splitlines():
        if "Function properties for" in line:
            kernel = _kernel_name(line.split("Function properties for")[-1]
                                  .strip())
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((kernel, f"{line.split(':', 1)[-1].strip()}; "
                                f"{spills}"))
    return out


# ----------------------------------------------------------------- phase 3
def _attention_case(b, h, t, d, lengths, seed):
    """bf16 q/k/v [B*H, T, D] and a prefix key mask [B, T] on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b * h, t, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lengths = np.asarray(lengths)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return q, k, v, torch.from_numpy(mask).cuda()


def _visible_pairs(h, lengths, t):
    """Causal query-key pairs whose key is real, over every head."""
    return sum(int(np.minimum(np.arange(1, t + 1), int(n)).sum())
               for n in lengths) * h


def _bound(q3, h, lengths, t, tensors=4, flop_per_pair=4, row_terms=1,
           masked=True):
    """(bound_ms, bound_by) at the data-sheet peaks: ``tensors`` [BH, T, D]
    tensors, ``row_terms`` [BH, T] f32 rows (lse, delta) and the [B, T]
    mask moved once each, against ``flop_per_pair`` * D FLOP per visible
    query-key pair. The forward moves q, k, v, o and lse and does 4 * D."""
    bh, _, d = q3.shape
    nbytes = tensors * q3.numel() * q3.element_size() + \
        row_terms * bh * t * 4 + (bh // h) * t * 4 * masked
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flop_per_pair * d * _visible_pairs(h, lengths, t) / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernel(name, b, h, t, d, lengths, seed, masked=True):
    """A forward kernel against its plain version on causal bf16 inputs
    with the prefix key mask of ``lengths`` (or none), with its times,
    SDPA's and the bound."""
    spec = KERNELS[name]
    q3, k3, v3, km = _attention_case(b, h, t, d, lengths, seed)
    km = km if masked else None
    o_k, lse_k = spec["wrapper"](q3, k3, v3, km, h, True)
    o_p, lse_p = spec["plain"](q3, k3, v3, km, h, True)
    torch.cuda.synchronize()
    dead = torch.from_numpy(np.repeat(np.asarray(lengths) == 0, h)).cuda()
    live = ~dead
    if not (torch.isfinite(o_k).all() and torch.isfinite(lse_k).all()):
        raise AssertionError(f"{name}: non-finite output")
    err_o = (o_k[live].float() - o_p[live].float()).abs().max().item()
    err_l = (lse_k[live] - lse_p[live]).abs().max().item()
    what = (f"lengths [{min(lengths)}..{max(lengths)}] fully-masked rows "
            f"{int(dead.sum()) * t}" if masked else "unmasked")
    log(f"{name} B={b} H={h} T={t} D={d} bf16 causal {what}: o max-abs "
        f"{err_o:.3e} (tol {O_TOL}), lse max-abs {err_l:.3e} (tol "
        f"{LSE_TOL})")
    if not (err_o <= O_TOL and err_l <= LSE_TOL):
        raise AssertionError(f"{name}: disagrees with its plain version")
    ms = time_ms(lambda: spec["wrapper"](q3, k3, v3, km, h, True))
    plain_ms = time_ms(lambda: spec["plain"](q3, k3, v3, km, h, True))
    q4, k4, v4 = (x.view(b, h, t, d) for x in (q3, k3, v3))
    if masked:
        allowed = (torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
                   [None, None] & (km > 0)[:, None, None, :])
        sdpa = dict(attn_mask=allowed)
    else:
        sdpa = dict(is_causal=True)
    library_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q4, k4, v4, **sdpa))
    bound_ms, bound_by = _bound(q3, h, lengths, t, masked=masked)
    log(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (scaled_dot_product_attention"
        f"{'' if masked else ', is_causal'}) bound_us "
        f"{bound_ms * 1e3:.1f} ({bound_by})")
    return {"max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


#: per backward kernel: [BH, T, D] tensors moved (inputs q, k, v, dO and
#: its gradients), and FLOP per visible pair in units of D
BWD_WORK = {"shortseq_attention_bwd": (7, 10), "flash_backward_dq": (5, 6),
            "flash_backward_dkv": (6, 8)}


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() /
            want.float().norm().clamp_min(1e-30)).item()


def _sdpa_bwd_ms(q3, k3, v3, km, do, b, h, masked):
    """Time of scaled_dot_product_attention's backward (one
    ``torch.autograd.grad`` of q, k and v on a saved graph) on the same
    inputs: with the causal-and-key mask as a boolean ``attn_mask`` and,
    when there is no key mask, also with ``is_causal=True``, which lets
    SDPA take its flash backward. {"attn_mask" / "is_causal": ms}."""
    bh, t, d = q3.shape
    q4, k4, v4 = (x.view(b, h, t, d).detach().requires_grad_(True)
                  for x in (q3, k3, v3))
    do4 = do.view(b, h, t, d)
    allowed = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    if masked:
        allowed = allowed[None, None] & (km > 0)[:, None, None, :]
    calls = {"attn_mask": dict(attn_mask=allowed)}
    if not masked:
        calls["is_causal"] = dict(is_causal=True)
    out = {}
    for what, kw in calls.items():
        o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                              **kw)
        out[what] = time_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True))
    return out


def check_bwd_kernel(name, b, h, t, d, lengths, seed, masked):
    """A backward kernel against the plain backward on the same (q, k, v,
    o, lse, dO, delta), bitwise equal over two calls, with its times, the
    library backward's (the faster of its two forms, see _sdpa_bwd_ms) and
    the bound."""
    spec = KERNELS[name]
    q3, k3, v3, km = _attention_case(b, h, t, d, lengths, seed)
    km = km if masked else None
    o, lse = attention_fwd_plain(q3, k3, v3, km, h, True)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    do = torch.randn(q3.shape, generator=g, device="cuda").to(q3.dtype)
    delta = row_delta(do, o)
    args = (q3, k3, v3, km, h, True)
    if name == "shortseq_attention_bwd":
        run = lambda: spec["wrapper"](*args, o, lse, do, delta)
    else:
        run = lambda: spec["wrapper"](*args, do, lse, delta)
    got = run()
    got = got if isinstance(got, tuple) else (got,)
    again = run()
    again = again if isinstance(again, tuple) else (again,)
    want = attention_bwd_plain(*args, o, lse, do, delta)
    torch.cuda.synchronize()
    if not all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(got, again)):
        raise AssertionError(f"{name}: two calls gave different bits")
    live = torch.from_numpy(np.repeat(np.asarray(lengths) > 0, h)).cuda()
    errs = {}
    for gi, x in zip(spec["grads"], got):
        gname = "dq dk dv".split()[gi]
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name}: non-finite {gname}")
        errs[gname] = _rel_l2(x[live], want[gi][live])
    log(f"{name} B={b} H={h} T={t} D={d} bf16 causal "
        f"{'lengths [%d..%d]' % (min(lengths), max(lengths)) if masked else 'unmasked'}"
        f": rel-L2 {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} "
        f"(tol {GRAD_TOL})")
    if not all(e <= GRAD_TOL for e in errs.values()):
        raise AssertionError(f"{name}: disagrees with the plain backward")
    ms = time_ms(run)
    plain_ms = time_ms(lambda: attention_bwd_plain(*args, o, lse, do,
                                                   delta))
    library = _sdpa_bwd_ms(q3, k3, v3, km, do, b, h, masked)
    library_ms = min(library.values())
    tensors, per_pair = BWD_WORK[name]
    bound_ms, bound_by = _bound(q3, h, lengths, t, tensors, per_pair, 2,
                                masked)
    log(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (scaled_dot_product_attention backward, all "
        f"three gradients: "
        f"{', '.join(f'{k} {v:.4f}' for k, v in library.items())}) "
        f"bound_us {bound_ms * 1e3:.1f} ({bound_by}); bitwise equal over "
        f"two calls")
    return {"max_abs_err": max(
                (x[live].float() - want[gi][live].float()).abs().max().item()
                for gi, x in zip(spec["grads"], got)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _lstm_inputs(t, n, h, dtype, peephole, masked, seed):
    """B6's inputs on the card: xw_t [T, N, 4H], R [H, 4H] (scaled so the
    gates stay in range), h0 / c0, peepholes and a [T, N] mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    xw, r = rnd(t, n, 4 * h), rnd(h, 4 * h) / h ** 0.5
    h0, c0 = rnd(n, h) * 0.5, rnd(n, h) * 0.5
    peep = tuple(rnd(h) * 0.1 for _ in range(3)) if peephole else None
    mask = (torch.rand(t, n, generator=g, device="cuda") > 0.2).float() \
        if masked else None
    return (xw.to(dtype), r.to(dtype), h0.to(dtype), c0.to(dtype),
            None if peep is None else tuple(p.to(dtype) for p in peep), mask)


def _lstm_bound(t, n, h, dtype, peephole, masked):
    """(bound_ms, bound_by): xw in, y out, R, h0 / c0 / hT / cT and the
    peepholes (and the f32 mask) moved once, against 2·T·N·H·4H FLOP of
    recurrent products at the dtype's peak (bf16 and f16: the 16-bit
    tensor cores' dense rate; f32: the CUDA cores); the gate math is not
    counted."""
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = es * (t * n * 4 * h + t * n * h + h * 4 * h + 4 * n * h +
                   3 * h * peephole) + 4 * t * n * masked
    t_bytes = nbytes / HBM_BYTES_PER_S
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    t_ops = 2 * t * n * h * 4 * h / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _cudnn_twin(params, n_in, h, dtype):
    """torch.nn.LSTM (cuDNN; no peepholes, gate order [i, f, g, o] as the
    port's) loaded with an LSTM layer's W, R and b."""
    ref = torch.nn.LSTM(n_in, h, batch_first=True).cuda()
    with torch.no_grad():
        ref.weight_ih_l0.copy_(params["W"].T)
        ref.weight_hh_l0.copy_(params["R"].T)
        ref.bias_ih_l0.copy_(params["b"])
        ref.bias_hh_l0.zero_()
    ref = ref.to(dtype)
    ref.flatten_parameters()      # one weight buffer, as cuDNN wants it
    return ref


def _lstm_check(t, n, h, dtype, peep, masked, seed, route, acts=None,
                scale=1.0):
    """B6 on one case against its plain version; the launch must take
    ``route``. ``acts`` (gate, cell) names the activations (sigmoid /
    tanh by default); ``scale`` multiplies xw and R. Returns the max-abs
    error."""
    args = _lstm_inputs(t, n, h, dtype, peep, masked, seed)
    if scale != 1.0:
        args = (args[0] * scale, args[1] * scale) + args[2:]
    acts = acts or lk.DEFAULT_ACTS
    fns = [get_activation(a) for a in acts]
    before = lstm_routes()
    got = lk.lstm_recurrence_fwd(*args, *acts)
    took = [r for r, c in lstm_routes().items() if c != before[r]]
    want = lk.lstm_recurrence_plain(*args, *fns)
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in got):
        raise AssertionError("lstm_recurrence: non-finite output")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    tol, against = LSTM_TOL[dtype], "plain"
    ratio = err / tol
    if any(a in lk.ROW_WISE for a in acts):
        # a row-wise pair is held against the plain loop in f64, at the
        # dtype's tolerance times each output's largest |value| (a
        # logsoftmax cell's h and c run to tens). The plain loop in the
        # dtype must meet the same limit: an ill-conditioned case (an
        # expanding recurrence) raises here rather than loosen the check
        as64 = lambda x: None if x is None else \
            tuple(p.double() for p in x) if isinstance(x, tuple) \
            else x.double()
        ref = lk.lstm_recurrence_plain(*(as64(a) for a in args), *fns)
        lims = [tol * r.abs().max().item() for r in ref]
        off = lambda outs: max((a.double() - r).abs().max().item() / lim
                               for a, r, lim in zip(outs, ref, lims))
        own = off(want)
        if not own <= 1:
            raise AssertionError(
                f"lstm_recurrence {acts[0]}/{acts[1]}: the plain loop in "
                f"{str(dtype)[6:]} is {own:.3e}x its limit off f64; the "
                "case is ill-conditioned")
        err = max((a.double() - r).abs().max().item()
                  for a, r in zip(got, ref))
        ratio, tol = off(got), max(lims)
        against = (f"plain in f64 within {LSTM_TOL[dtype]:g} x max|ref| "
                   f"an output, {ratio:.3f} of it; the plain loop's own "
                   f"error {own:.3f} of it")
    log(f"lstm_recurrence T={t} N={n} H={h} {str(dtype)[6:]} "
        f"peepholes {peep} masked {masked} gate/cell {acts[0]}/{acts[1]}: "
        f"route {took}, y/hT/cT max-abs {err:.3e} against {against} "
        f"(tol {tol:.3e})")
    if route is not None and took != [route]:
        raise AssertionError(f"lstm_recurrence took route {took}, expected "
                             f"{route}")
    if not ratio <= 1:
        raise AssertionError("lstm_recurrence: disagrees with its plain "
                             "version")
    return err


#: B6's cases: (T, N, H, dtype, peepholes, masked, route). The cluster
#: route at the char-RNN shape (bf16), with and without peepholes, masked,
#: and with N not a multiple of a cluster's rows; the cooperative route in
#: f32 and at a bf16 width the cluster route does not take (H > 512)
LSTM_CASES = [
    (128, 64, 512, torch.bfloat16, False, False, "cluster"),
    (128, 64, 512, torch.bfloat16, True, False, "cluster"),
    (128, 64, 512, torch.bfloat16, True, True, "cluster"),
    (128, 61, 512, torch.bfloat16, True, True, "cluster"),
    (128, 64, 512, torch.float32, False, False, "cooperative"),
    (128, 64, 512, torch.float32, True, False, "cooperative"),
    (128, 64, 600, torch.bfloat16, True, False, "cooperative"),
]


def check_lstm_kernel(t=128, n=64, h=512):
    """B6 against its plain version on both routes (LSTM_CASES), then its
    time on each route, the plain version's and the layer-level
    comparison with cuDNN."""
    errs = {}
    for i, case in enumerate(LSTM_CASES):
        errs[case[:6]] = _lstm_check(*case[:6], 31 + i, case[6])
    log(f"  launch plans: {lk.lstm_plan(n, h, torch.bfloat16)} (bf16), "
        f"{lk.lstm_plan(n, 600, torch.bfloat16)} (bf16, H 600), "
        f"{lk.lstm_plan(1, h, torch.float32)} (f32, N=1)")
    # the main path's case: the char-RNN's GravesLSTM, bf16, unmasked
    args = _lstm_inputs(t, n, h, torch.bfloat16, True, False, 32)
    ms = time_ms(lambda: lk.lstm_recurrence_fwd(*args))
    plain_ms = time_ms(lambda: lk.lstm_recurrence_plain(*args), warmup=1,
                       reps=5, batch=2)
    f32_args = _lstm_inputs(t, n, h, torch.float32, True, False, 33)
    f32_ms = time_ms(lambda: lk.lstm_recurrence_fwd(*f32_args))
    wide_args = _lstm_inputs(t, n, 600, torch.bfloat16, True, False, 36)
    wide_ms = time_ms(lambda: lk.lstm_recurrence_fwd(*wide_args))
    bound_ms, bound_by = _lstm_bound(t, n, h, torch.bfloat16, True, False)
    f32_bound, _ = _lstm_bound(t, n, h, torch.float32, True, False)
    wide_bound, _ = _lstm_bound(t, n, 600, torch.bfloat16, True, False)
    # layer level: the port's LSTM layer (input projection + B6) against
    # cuDNN's with the same weights; agreement checked in f32
    layer = GravesLSTM(n_in=h, n_out=h, activation="tanh", peephole=False)
    params = layer.init_params(torch.Generator(device="cuda").manual_seed(34))
    x = torch.randn(n, t, h, generator=torch.Generator(device="cuda")
                    .manual_seed(35), device="cuda")
    with torch.no_grad():
        ref32 = _cudnn_twin(params, h, h, torch.float32)
        agree = (ref32(x)[0] - layer.forward(params, {}, x)[0]).abs().max() \
            .item()
        library_f32_ms = time_ms(lambda: ref32(x))
        layer_f32_ms = time_ms(lambda: layer.forward(params, {}, x))
        ref = _cudnn_twin(params, h, h, torch.bfloat16)
        p16 = {k: v.bfloat16() for k, v in params.items()}
        x16 = x.bfloat16()
        library_ms = time_ms(lambda: ref(x16))
        layer_ms = time_ms(lambda: layer.forward(p16, {}, x16))
        peep_layer = GravesLSTM(n_in=h, n_out=h, activation="tanh")
        pp16 = dict(p16, **{k: torch.zeros(h, device="cuda",
                                           dtype=torch.bfloat16)
                            for k in ("pi", "pf", "po")})
        peep_layer_ms = time_ms(lambda: peep_layer.forward(pp16, {}, x16))
    log(f"  cuDNN LSTM layer vs the port's LSTM layer, f32: max-abs "
        f"{agree:.3e} (tol {CUDNN_AGREE_TOL})")
    if not agree <= CUDNN_AGREE_TOL:
        raise AssertionError("the cuDNN yardstick computes another function")
    log(f"  kernel_ms {ms:.4f} (cluster route, bf16, {ms / t * 1e3:.2f} us "
        f"a step; cooperative route: f32 {f32_ms:.4f}, bf16 H 600 "
        f"{wide_ms:.4f}) plain_ms {plain_ms:.4f} bound_us "
        f"{bound_ms * 1e3:.1f} ({bound_by}; f32 {f32_bound * 1e3:.1f}, bf16 "
        f"H 600 {wide_bound * 1e3:.1f}) | layer (projection + recurrence, "
        f"nIn {h}, bf16): cuDNN {library_ms:.4f} ms, port {layer_ms:.4f} ms "
        f"(peepholes {peep_layer_ms:.4f} ms); f32: cuDNN "
        f"{library_f32_ms:.4f} ms, port {layer_f32_ms:.4f} ms")
    return {"max_abs_err": errs[(t, n, h, torch.bfloat16, True, False)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms}


def time_short_main_shapes():
    """B1 at the two other shapes the main path gives it, checked and timed
    as in check_kernel: the flagship train step's (B 32, T 512, no key
    mask, as fit_batch runs it) and a serving admission's (8 rows, bucket
    512, prefix key mask of 200-512 tokens). Returns a summary line each."""
    lines = []
    for what, b, lengths, masked in (
            ("train step (B 32, unmasked)", 32, [512] * 32, False),
            ("serving admission (8 rows, bucket 512)", 8,
             np.random.default_rng(7).integers(200, 513, 8), True)):
        r = check_kernel("shortseq_attention", b, 12, 512, 64, lengths, 8,
                         masked)
        lines.append(f"shortseq_attention at the {what}: kernel_ms "
                     f"{r['ms']:.4f} library_ms {r['library_ms']:.4f} "
                     f"bound_us {r['bound_ms'] * 1e3:.1f} ({r['bound_by']})")
    return lines


def _bias_attention_case(rows, h, t, d, p, seed):
    """SwinV2's biased attention on the card: bf16 q̂ (unit rows times a
    temperature of 10), k̂ (unit rows), v, dO [rows·h, T, D] and an f32
    bias [P, h, T, T] of 16·σ(noise), minus 100 on a quarter of the keys
    of each block's rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q3, k3, v3, do = (torch.randn(rows * h, t, d, generator=g,
                                  device="cuda") for _ in range(4))
    q3 = torch.nn.functional.normalize(q3, dim=-1) * 10.0
    k3 = torch.nn.functional.normalize(k3, dim=-1)
    bias = 16.0 * torch.sigmoid(torch.randn(p, h, t, t, generator=g,
                                            device="cuda"))
    bias = bias - 100.0 * (torch.rand(p, 1, t, t, generator=g,
                                      device="cuda") < 0.25).float()
    return (*(x.to(torch.bfloat16) for x in (q3, k3, v3, do)),
            bias.contiguous())


def check_bias_kernels(images=256, windows=16, h=4, t=256, d=32):
    """The biased pair at SwinV2-B's first stage (B 256 x 16 windows x 4
    heads, T 256, D 32, P 16): each against the plain version (o / lse as
    B1, dq / dk / dv as B2, dbias within rel-L2 1e-3), each timed beside
    the plain version, SDPA with a float ``attn_mask`` (the bias expanded
    to the batch rows), and the bound: the forward moves q, k, v, o, lse
    and the bias once and does 4·D a pair, the backward q, k, v, dO, dq,
    dk, dv, lse, δ, the bias and dbias and does 10·D. Returns the
    measurements of the ``kernels`` line's rows "shortseq_attention_bias"
    and "..._bwd"."""
    rows = images * windows
    q3, k3, v3, do, bias = _bias_attention_case(rows, h, t, d, windows, 9)
    o_k, lse_k = short_attention_bias_fwd(q3, k3, v3, bias, h, 1.0)
    o_p, lse_p = attention_fwd_plain(q3, k3, v3, None, h, False, 1.0, bias)
    delta = row_delta(do, o_p)
    got = short_attention_bias_bwd(q3, k3, v3, bias, h, 1.0, o_p, lse_p, do,
                                   delta)
    torch.cuda.synchronize()
    err_o = (o_k.float() - o_p.float()).abs().max().item()
    err_l = (lse_k - lse_p).abs().max().item()
    del o_k, lse_k
    want = attention_bwd_plain(q3, k3, v3, None, h, False, o_p, lse_p, do,
                               delta, 1.0, bias)
    errs = {n: _rel_l2(x, y) for n, x, y in zip(("dq", "dk", "dv", "dbias"),
                                                got, want)}
    del got, want
    log(f"biased attention B={rows} x H={h} T={t} D={d} P={windows} bf16: "
        f"o max-abs {err_o:.3e} (tol {O_TOL}), lse max-abs {err_l:.3e} "
        f"(tol {LSE_TOL}), rel-L2 "
        f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol "
        f"{GRAD_TOL}, dbias 1e-3)")
    if not (err_o <= O_TOL and err_l <= LSE_TOL and errs["dbias"] <= 1e-3
            and all(errs[n] <= GRAD_TOL for n in ("dq", "dk", "dv"))):
        raise AssertionError("biased attention: disagrees with its plain "
                             "version")
    fwd = lambda: short_attention_bias_fwd(q3, k3, v3, bias, h, 1.0)
    bwd = lambda: short_attention_bias_bwd(q3, k3, v3, bias, h, 1.0, o_p,
                                           lse_p, do, delta)
    ms = {"fwd": time_ms(fwd), "bwd": time_ms(bwd)}
    plain_ms = {"fwd": time_ms(lambda: attention_fwd_plain(
                    q3, k3, v3, None, h, False, 1.0, bias), reps=5),
                "bwd": time_ms(lambda: attention_bwd_plain(
                    q3, k3, v3, None, h, False, o_p, lse_p, do, delta, 1.0,
                    bias), reps=5)}
    q4, k4, v4 = (x.view(rows, h, t, d).detach().requires_grad_(True)
                  for x in (q3, k3, v3))
    mask = bias.repeat(images, 1, 1, 1).to(torch.bfloat16)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, scale=1.0)
    o4 = sdpa()
    library_ms = {"fwd": time_ms(sdpa), "bwd": time_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), do.view(rows, h, t, d),
                                    retain_graph=True))}
    bh, pairs = rows * h, rows * h * t * t
    bias_bytes = bias.numel() * 4
    out = {}
    for key, tensors, row_terms, biases, per_pair in (
            ("fwd", 4, 1, 1, 4), ("bwd", 7, 2, 2, 10)):
        t_bytes = (tensors * bh * t * d * 2 + row_terms * bh * t * 4 +
                   biases * bias_bytes) / HBM_BYTES_PER_S
        t_ops = per_pair * d * pairs / BF16_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {key}: kernel_ms {ms[key]:.4f} plain_ms {plain_ms[key]:.4f} "
            f"library_ms {library_ms[key]:.4f} (scaled_dot_product_attention"
            f", float attn_mask [B·nW, H, T, T] bf16) bound_ms "
            f"{bound_ms:.4f} ({by}), roofline {100 * bound_ms / ms[key]:.1f}%")
        out["shortseq_attention_bias" + ("" if key == "fwd" else "_bwd")] = {
            "max_abs_err": err_o if key == "fwd" else max(
                errs[g] for g in ("dq", "dk", "dv")),
            "ms": ms[key], "plain_ms": plain_ms[key],
            "library_ms": library_ms[key], "bound_ms": bound_ms,
            "bound_by": by}
    return out


def phase_kernel_checks():
    rng = np.random.default_rng(0)
    # B1 at the flagship prefill: one length-1 row, one fully masked row
    lens = rng.integers(2, 513, 32)
    lens[0], lens[1] = 1, 0
    short = check_kernel("shortseq_attention", 32, 12, 512, 64, lens, 1)
    short["main_shapes"] = time_short_main_shapes()
    # B3 at T = 2048 and at the ragged T = 577 (one fully masked row)
    flash = check_kernel("flash_forward", 4, 12, 2048, 64,
                         [2048, 1536, 777, 1], 2)
    check_kernel("flash_forward", 4, 12, 577, 64, [577, 300, 1, 0], 3)
    measured = {"shortseq_attention": short, "flash_forward": flash}
    # B2 at the flagship train step (unmasked, timed) and ragged with a
    # length-1 and a fully masked row; B4 / B5 at the long-context train
    # step (unmasked, timed) and at the ragged T = 577
    measured["shortseq_attention_bwd"] = check_bwd_kernel(
        "shortseq_attention_bwd", 32, 12, 512, 64, [512] * 32, 4, False)
    check_bwd_kernel("shortseq_attention_bwd", 32, 12, 512, 64, lens, 5,
                     True)
    for name in ("flash_backward_dq", "flash_backward_dkv"):
        measured[name] = check_bwd_kernel(name, 4, 12, 2048, 64,
                                          [2048] * 4, 6, False)
        check_bwd_kernel(name, 4, 12, 577, 64, [577, 300, 1, 0], 7, True)
    dq, dkv = measured["flash_backward_dq"], measured["flash_backward_dkv"]
    short["main_shapes"].append(
        f"flash backward at B 4, H 12, T 2048, D 64 causal: B4 "
        f"{dq['ms']:.4f} ms + B5 {dkv['ms']:.4f} ms = "
        f"{dq['ms'] + dkv['ms']:.4f} ms; SDPA's whole backward in this run "
        f"{dq['library_ms']:.4f} / {dkv['library_ms']:.4f} ms (B4 alone "
        f"{dq['ms'] / dq['library_ms']:.2f}x, B4 + B5 "
        f"{(dq['ms'] + dkv['ms']) / dkv['library_ms']:.2f}x)")
    measured["lstm_recurrence"] = check_lstm_kernel()
    measured.update(check_bn_kernels())
    measured["segment_update"] = check_segment_update_kernel()
    check_segment_update_tsne()
    measured["ring_attention"] = check_ring_kernels()
    measured["batchnorm_cross_shard"] = check_bn_cross_shard()
    measured.update(check_bias_kernels())
    rows = check_c4_variants()
    log(json.dumps({"c4_variants": rows}))
    return measured


#: max-abs of the segment-update kernel's change to the table against its
#: plain version's on the card (index_add_'s float atomics), relative to
#: the largest change: both sum the same f32 values in other orders
SEGMENT_UPDATE_TOL = 1e-5


def _segment_case(v, targets, window, d, seed):
    """Phase 17's HS-scan syn1 update: the Huffman points (padding zeros
    included) of 2·window·targets Zipf-drawn targets over a Zipf
    vocabulary of ``v`` words, random f32 updates [B·L, d], weights 0 / 1
    and a table on the card."""
    rng = np.random.default_rng(seed)
    _, points = build_huffman(1.0 / np.arange(1, v + 1))
    depth = max(len(x) for x in points)
    tab = np.zeros((v, depth), np.int64)
    for i, x in enumerate(points):
        tab[i, :len(x)] = x
    cdf = np.cumsum(1.0 / np.arange(1, v + 1))
    tgt = np.minimum(np.searchsorted(cdf, rng.random(targets * 2 * window) *
                                     cdf[-1]), v - 1)
    idx = torch.from_numpy(tab[tgt].reshape(-1)).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    upd = torch.randn(idx.shape[0], d, generator=g, device="cuda")
    w = (torch.rand(idx.shape[0], generator=g, device="cuda") > 0.1).float()
    table = torch.randn(v - 1, d, generator=g, device="cuda") * 0.1
    return idx, upd, w, table, depth


def _update_err(idx, upd, w, table, bf16):
    """Max-abs of the kernel's change against the plain version's, the
    largest change, and whether two kernel calls agree bitwise."""
    got = sgk.segment_update(table.clone(), idx, upd, w, 0.025, bf16)
    again = sgk.segment_update(table.clone(), idx, upd, w, 0.025, bf16)
    want = sgk.segment_update_plain(table.clone(), idx, upd, w, 0.025, bf16)
    torch.cuda.synchronize()
    delta = want - table
    return ((got - want).abs().max().item(), delta.abs().max().item(),
            bool(torch.equal(got, again)))


def _zipf_rows(v, n, seed, power=1.0):
    """``n`` row indices over ``v`` rows on the card, row r drawn with
    weight (r + 1)^-power (Zipf ranks; 0.75 is negative sampling's
    unigram^0.75)."""
    cdf = np.cumsum(np.arange(1, v + 1, dtype=np.float64) ** -power)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.minimum(np.searchsorted(
        cdf, rng.random(n) * cdf[-1]), v - 1)).cuda()


def _prefix_vocab(s=None):
    """Words of at least min count in phase 17's prefix (the vocabulary
    its per-pair scan and per-batch fit build)."""
    s = s or NLP_SHAPES
    _, prefix = nlp_corpus(s)
    counts = np.unique(np.concatenate([np.asarray(x) for x in prefix]),
                       return_counts=True)[1]
    return int((counts >= s["min_count"]).sum())


def check_segment_update_kernel(v=37166, p=204, window=5, d=100,
                                d_ns=300, k=5):
    """The segment-update kernel at phase 17's shapes against its plain
    version, bitwise over two calls: the HS corpus scan's syn1 update
    ((a): V - 1 rows, 204 centers x 10 contexts x the Huffman depth
    updates of 100 columns, the f32 route), the bf16 route at 3000 rows,
    and the NS scans' width 300 ((b): syn0 and the shared syn1neg
    positives, 2,040 updates of V rows on the f32 route; the per-pair
    scan over the prefix's vocabulary on the bf16 route, syn0's 2,040
    updates and syn1neg's 2,040 x (1 + k)), where 301 columns take two
    column blocks of the kernel's pass 1. Timed at (a)'s syn1 shape beside
    its bytes bound and the plain version (no single PyTorch call
    computes the update; index_put_(accumulate=True), the library's
    deterministic sum alone, is logged)."""
    idx, upd, w, table, depth = _segment_case(v, p, window, d, 41)
    err, scale, same = _update_err(idx, upd, w, table, False)
    hot = int(torch.bincount(idx).max())
    c0 = torch.from_numpy(np.random.default_rng(42).integers(
        0, 3000, p * 2 * window)).cuda()
    err0, scale0, same0 = _update_err(c0, upd[:len(c0)], w[:len(c0)],
                                      table[:3000], True)
    n_pairs, v_pre = p * 2 * window, _prefix_vocab()
    g = torch.Generator(device="cuda").manual_seed(43)
    wide = []
    for what, rows, n_upd, power, bf16 in (
            ("NS scan syn0 / syn1neg positives", v, n_pairs, 1.0, False),
            ("per-pair syn0", v_pre, n_pairs, 1.0, True),
            ("per-pair syn1neg", v_pre, n_pairs * (1 + k), 0.75, True)):
        i = _zipf_rows(rows, n_upd, 44 + len(wide), power)
        u = torch.randn(n_upd, d_ns, generator=g, device="cuda") * 0.01
        wt = (torch.rand(n_upd, generator=g, device="cuda") > 0.1).float()
        tab = torch.randn(rows, d_ns, generator=g, device="cuda") * 0.01
        route = segment_route(rows, n_upd)
        if route != ("onehot" if bf16 else "scatter"):
            raise AssertionError(f"{what}: route {route} at {rows} rows")
        wide.append((what, rows, n_upd, route) +
                    _update_err(i, u, wt, tab, bf16))
    ms = time_ms(lambda: sgk.segment_update(table, idx, upd, w, 0.025,
                                            False))
    plain_ms = time_ms(lambda: sgk.segment_update_plain(table, idx, upd, w,
                                                        0.025, False))
    u = torch.cat([upd, w[:, None]], dim=1)
    put_ms = time_ms(lambda: torch.zeros(v - 1, d + 1, device="cuda")
                     .index_put_((idx,), u, accumulate=True))
    n, touched = idx.shape[0], int(torch.unique(idx).numel())
    bytes_ = n * (d + 1) * 4 + n * 8 + 2 * touched * d * 4
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, 3 * n * d / F32_FLOPS) * 1e3
    log(f"segment_update N={n} (Huffman depth {depth}, the hottest row "
        f"{hot} times, {touched} rows named) rows={v - 1} D={d} f32 route: "
        f"max-abs {err:.3e} against the plain version (tol "
        f"{SEGMENT_UPDATE_TOL} x the largest change {scale:.3e}), bitwise "
        f"over two calls {same}; bf16 route (N={len(c0)}, 3000 rows) "
        f"max-abs {err0:.3e} (of {scale0:.3e}), bitwise {same0}; D={d_ns}: "
        + "; ".join(f"{what} N={n_upd} rows={rows} {route} max-abs "
                    f"{e:.3e} (of {sc:.3e}), bitwise {b}"
                    for what, rows, n_upd, route, e, sc, b in wide) +
        f" | kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_us "
        f"{bound_ms * 1e3:.1f} (bytes); index_put_(accumulate=True) of the "
        f"sums alone {put_ms:.4f} ms")
    cases = [(err, scale, same), (err0, scale0, same0)] + \
        [c[4:] for c in wide]
    if not all(b and e <= SEGMENT_UPDATE_TOL * sc for e, sc, b in cases):
        raise AssertionError("segment_update disagrees with its plain "
                             "version or is not reproducible")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def check_segment_update_tsne(n=37166, k=90):
    """The segment update as phase 18's t-SNE attractive sum: width 2, a
    zero table, zero weights and lr 1 (a segment sum) over 2·N·k edges
    (each row k times as a source, then N·k kNN-like columns), against
    its plain version and bitwise over two calls; timed beside its bytes
    bound, the plain version, ``index_add_`` (the library's segment sum:
    float atomics) and the wrapper's stable sort of the indices alone."""
    g = torch.Generator(device="cuda").manual_seed(45)
    rows = torch.arange(n, device="cuda").repeat_interleave(k)
    src = torch.cat([rows, torch.randint(0, n, (n * k,), generator=g,
                                         device="cuda")])
    e = src.shape[0]
    vals = torch.randn(e, 2, generator=g, device="cuda") * 1e-4
    zero = torch.zeros(e, device="cuda")
    upd = lambda: sgk.segment_update(torch.zeros(n, 2, device="cuda"), src,
                                     vals, zero, 1.0, False)
    got, again = upd(), upd()
    want = sgk.segment_update_plain(torch.zeros(n, 2, device="cuda"), src,
                                    vals, zero, 1.0, False)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    same = bool(torch.equal(got, again))
    ms = time_ms(upd)
    plain_ms = time_ms(lambda: sgk.segment_update_plain(
        torch.zeros(n, 2, device="cuda"), src, vals, zero, 1.0, False))
    add_ms = time_ms(lambda: torch.zeros(n, 2, device="cuda").index_add_(
        0, src, vals))
    sort_ms = time_ms(lambda: torch.sort(src, stable=True))
    bytes_ = e * 3 * 4 + e * 8 + 2 * n * 2 * 4
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, 3 * e * 2 / F32_FLOPS) * 1e3
    log(f"segment_update as the t-SNE segment sum (D=2, N={e} = 2 x {n} x "
        f"{k}, rows={n}): max-abs {err:.3e} against the plain version (tol "
        f"{SEGMENT_UPDATE_TOL} x the largest sum {scale:.3e}), bitwise over "
        f"two calls {same} | kernel_ms {ms:.4f} (of which the wrapper's "
        f"stable sort alone {sort_ms:.4f}) plain_ms {plain_ms:.4f} "
        f"index_add_ {add_ms:.4f} bound_us {bound_ms * 1e3:.1f} (bytes)")
    if not (same and err <= SEGMENT_UPDATE_TOL * scale):
        raise AssertionError("segment_update at width 2 disagrees with its "
                             "plain version or is not reproducible")
    return {"ms": ms, "sort_ms": sort_ms, "plain_ms": plain_ms,
            "library_ms": add_ms, "bound_ms": bound_ms}


# ----------------------------------------------------------------- phase 4
def _cpu_twin(net):
    """The same configuration, weights and layer state on the CPU in f32
    (plain path)."""
    numpy = lambda tree: {v: {k: a.float().cpu().numpy()
                              for k, a in p.items()}
                          for v, p in tree.items()}
    return graph_from_numpy(net.conf, numpy(net.params), device="cpu",
                            state=numpy(net.state))


def _padded(prompts, tp):
    tokens = np.zeros((len(prompts), tp), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    return tokens, np.asarray([len(p) for p in prompts], np.int64)


def check_logits(net, prompts, tp, what):
    """Prefill next-token logits on the card (kernel path, bf16) against
    the CPU f32 plain path; raises above LOGIT_REL_TOL."""
    tokens, lengths = _padded(prompts, tp)
    dec = TransformerDecoder(net)
    _, got, _ = dec.prefill(dec.init_cache(len(prompts)), tokens, lengths)
    ref_dec = TransformerDecoder(_cpu_twin(net))
    _, want, _ = ref_dec.prefill(ref_dec.init_cache(len(prompts)), tokens,
                                 lengths)
    got = got.cpu().double()
    want = want.double()
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    log(f"{what}: prefill logits rel-L2 card bf16 vs CPU f32 = {rel:.3e} "
        f"(tol {LOGIT_REL_TOL}), argmax agree {same}")
    if not (np.isfinite(rel) and rel <= LOGIT_REL_TOL):
        raise AssertionError(f"{what}: card logits disagree with the CPU "
                             "reference")


#: phase 4's prompts and its direct-engine outputs, phase 4d's reference
SERVED = {}
#: phase 17's HS-scan model (its syn0 and vocabulary), for phase 18
HS_VECTORS = {}


def _stats_delta(engine, stats0):
    """The engine's counters since ``stats0`` (its ``mesh_shape`` tag and
    other non-counters left out)."""
    return {k: v - stats0.get(k, 0) for k, v in engine.stats().items()
            if isinstance(v, int) and not isinstance(v, bool)}


def phase_serving(card):
    conf = transformer_lm_conf(vocab_size=32000, d_model=768, num_heads=12,
                               num_layers=12, max_length=577)
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(200, 513, 16)]
    new_tokens = 64
    engine = SlotGenerationEngine(net, num_slots=8, block_size=4)
    # warm the engine's programs once, outside the counted run
    engine.submit(prompts[0][:64], 4)
    engine.run_until_drained()
    torch.cuda.synchronize()

    reset_launches()
    fetched0 = fetch_counts("engine.decode")["engine.decode"]
    stats0 = engine.stats()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = _stats_delta(engine, stats0)
    fetched = fetch_counts("engine.decode")["engine.decode"] - fetched0

    for p, r in zip(prompts, reqs):
        out = r.result(timeout=0)
        if len(out) != len(p) + new_tokens or not (out[:len(p)] == p).all():
            raise AssertionError(f"request returned {len(out)} tokens, "
                                 f"expected {len(p) + new_tokens}")
    SERVED["prompts"] = prompts
    SERVED["outputs"] = [r.result(timeout=0) for r in reqs]
    SERVED["new_tokens"] = new_tokens
    n_layers = 12
    log(f"serving: {len(reqs)} requests completed, {stats['completed']} "
        f"counted; admissions {stats['prefill_batches']}, decode blocks "
        f"{stats['decode_blocks']}, decode readbacks {fetched}, kernel "
        f"launches {launches}")
    if launches["shortseq_attention"] < n_layers * stats["prefill_batches"]:
        raise AssertionError("the short-sequence kernel did not launch on "
                             "every admission")
    if fetched > stats["decode_blocks"]:
        raise AssertionError("more than one readback per decode block")
    gen_tokens = len(reqs) * new_tokens
    log(f"serving [{card}]: engine end-to-end {gen_tokens / wall:.1f} "
        f"generated tok/s ({wall:.2f}s for {len(reqs)} requests)")

    # prefill and decode rates of the decoder alone, 8 rows
    dec = engine.decoder
    tokens, lengths = _padded(prompts[:8], 512)
    caches = dec.init_cache(8)
    pre_ms = time_ms(lambda: dec.prefill(caches, tokens, lengths),
                     warmup=2, reps=5, batch=1)
    log(f"serving [{card}]: prefill {lengths.sum() / pre_ms * 1e3:.0f} "
        f"prompt tok/s (8 prompts, bucket 512, {pre_ms:.2f} ms)")
    ids = np.zeros(8, np.int64)
    pos = lengths.copy()

    def blocks():
        for i in range(16):
            dec.decode_block(caches, ids, pos + 4 * i, block_size=4)
    dec_ms = time_ms(blocks, warmup=1, reps=3, batch=1)
    log(f"serving [{card}]: decode {8 * 64 / dec_ms * 1e3:.0f} tok/s "
        f"(8 slots, 16 blocks of K=4, {dec_ms / 64:.2f} ms per step)")

    check_logits(net, [prompts[1], prompts[2]], 512, "flagship 12-layer")
    return launches["shortseq_attention"], net


# ---------------------------------------------------------------- phase 4b
#: the paged phase's engine context: page_size 16 divides it, 36 pages a
#: slot; the embedding's max_length is 577
PAGED_T_MAX = 576
PAGE_SIZE = 16


def _rel_l2_rows(got, want):
    got, want = got.cpu().double(), want.cpu().double()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def _drive(engine, prompts, new_tokens):
    """Serve ``prompts`` to the end, sampling before every decode cycle
    the active slots and (paged) the page accounting. Returns (requests,
    wall s, stats delta, decode readbacks, peak active slots, page stats
    at the most pages mapped)."""
    peak = {"active": 0, "kv": None}
    step = engine._step

    def sampling_step():
        peak["active"] = max(peak["active"], engine.stats()["active_slots"])
        kv = engine.kv_page_stats()
        if kv is not None and (peak["kv"] is None or
                               kv["mapped"] > peak["kv"]["mapped"]):
            peak["kv"] = kv
        step()

    engine._step = sampling_step
    stats0 = engine.stats()
    fetched0 = fetch_counts("engine.decode")["engine.decode"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine._step = step
    stats = _stats_delta(engine, stats0)
    fetched = fetch_counts("engine.decode")["engine.decode"] - fetched0
    for p, r in zip(prompts, reqs):
        out = r.result(timeout=0)
        if len(out) != len(p) + new_tokens or not (out[:len(p)] == p).all():
            raise AssertionError(f"request returned {len(out)} tokens, "
                                 f"expected {len(p) + new_tokens}")
    if fetched > stats["decode_blocks"]:
        raise AssertionError(f"{fetched} decode readbacks for "
                             f"{stats['decode_blocks']} decode blocks")
    return reqs, wall, stats, fetched, peak["active"], peak["kv"]


def _audit(engine, what):
    problems = engine._pager.audit(engine._slot_pages)
    if problems:
        raise AssertionError(f"{what}: page audit failed: {problems[:4]}")
    if engine.kv_page_stats()["mapped"]:
        raise AssertionError(f"{what}: pages left mapped after the drain")


def check_paged_hit_logits(net, prefix, tail):
    """First-token logits of a prefix-cache hit on the card (the prefix
    prefilled into pages, then the tail on top of them; bf16, plain
    paged attention) against the whole prompt through the CPU f32 twin;
    raises above LOGIT_REL_TOL."""
    dec = TransformerDecoder(net, t_max=PAGED_T_MAX)
    pool = dec.init_paged_pool(PAGED_T_MAX // PAGE_SIZE + 1, PAGE_SIZE)
    ptab = np.arange(1, PAGED_T_MAX // PAGE_SIZE + 1)[None]
    dec.paged_prefill(pool, prefix[None], [0], [len(prefix)], ptab)
    tokens = np.zeros((1, 256), np.int64)
    tokens[0, :len(tail)] = tail
    _, got, _ = dec.paged_prefill(pool, tokens, [len(prefix)], [len(tail)],
                                  ptab)
    prompt = np.concatenate([prefix, tail])
    ref = TransformerDecoder(_cpu_twin(net), t_max=PAGED_T_MAX)
    full, lengths = _padded([prompt], 512)
    _, want, _ = ref.prefill(ref.init_cache(1), full, lengths)
    rel = _rel_l2_rows(got, want)
    same = bool(got.argmax(-1).item() == want.argmax(-1).item())
    log(f"paged prefix hit: first-token logits rel-L2 card bf16 vs CPU "
        f"f32 = {rel:.3e} (tol {LOGIT_REL_TOL}), argmax agree {same}")
    if not (np.isfinite(rel) and rel <= LOGIT_REL_TOL):
        raise AssertionError("paged hit logits disagree with the CPU "
                             "reference")


def check_verify_logits(net, prompts):
    """verify_block's window logits against decode_block's (decode_step
    after decode_step) at the same positions, from identical slab caches;
    raises above LOGIT_REL_TOL."""
    dec = TransformerDecoder(net, t_max=PAGED_T_MAX)
    tokens, lengths = _padded(prompts, 256)
    ids0, _, caches = dec.prefill(dec.init_cache(len(prompts)), tokens,
                                  lengths)
    twin = {n: {kk: t.clone() for kk, t in kv.items()}
            for n, kv in caches.items()}
    ids, steps, emitted = ids0, [], []
    for j in range(5):
        ids, logits, caches = dec.decode_step(caches, ids, lengths + j)
        steps.append(logits)
        emitted.append(ids)
    draft = torch.stack(emitted[:4], dim=1)
    window = torch.cat([ids0[:, None], draft], dim=1)
    pos = torch.as_tensor(lengths, device=ids0.device)
    with torch.no_grad():
        got = dec._walk_window(dec._device_params(),
                               net._inference_state(), twin, window, pos,
                               torch.full_like(pos, 5))
    rel = max(_rel_l2_rows(got[:, j], steps[j]) for j in range(5))
    log(f"speculation: verify window logits vs decode_block's, rel-L2 "
        f"{rel:.3e} over 5 positions x {len(prompts)} rows (tol "
        f"{LOGIT_REL_TOL})")
    if not (np.isfinite(rel) and rel <= LOGIT_REL_TOL):
        raise AssertionError("verify window logits disagree with "
                             "decode_block's")


def phase_paged_serving(card, net):
    """The flagship net behind paged and speculative engines: prefix
    sharing, concurrency at the slab's bytes, speculation slab and paged
    with the same requests decoded plainly in the same call."""
    rng = np.random.default_rng(21)
    new_tokens = 64
    reset_launches()

    # -- prefix sharing: one 256-token prefix (16 full pages), 16 tails
    prefix = rng.integers(0, 32000, 256)
    prompts = [np.concatenate([prefix, rng.integers(0, 32000, int(n))])
               for n in rng.integers(64, 257, 16)]
    engine = SlotGenerationEngine(net, num_slots=8, block_size=4,
                                  t_max=PAGED_T_MAX, paged=True,
                                  page_size=PAGE_SIZE)
    engine.submit(np.concatenate([prefix, rng.integers(0, 32000, 64)]), 4)
    engine.run_until_drained()              # warm: publishes the prefix
    _, wall, st, fetched, _, kv = _drive(engine, prompts, new_tokens)
    log(f"paged prefix [{card}]: 16 requests (256-token shared prefix + "
        f"64-256-token tails, 64 new, 8 slots, K=4, {engine.num_pages} "
        f"pages of {PAGE_SIZE}): prefix hits {st['prefix_cache_hits']}, "
        f"misses {st['prefix_cache_misses']}, hit tokens "
        f"{st['prefix_cache_hit_tokens']}; engine "
        f"{16 * new_tokens / wall:.1f} generated tok/s ({wall:.2f}s); "
        f"readbacks {fetched} for {st['decode_blocks']} decode blocks "
        f"({fetched / st['decode_blocks']:.3f} a block); at the most pages "
        f"mapped: {kv['mapped']} mapped, {kv['shared']} shared, "
        f"fragmentation {kv['fragmentation']}, pool "
        f"{kv['pool_bytes'] / 2**20:.1f} MiB")
    if st["prefix_cache_hit_tokens"] < 15 * 256:
        raise AssertionError(f"prefix hit tokens "
                             f"{st['prefix_cache_hit_tokens']} < 15 x 256")
    _audit(engine, "paged prefix")
    check_paged_hit_logits(net, prefix, prompts[0][256:])

    # prefill rates in this call: 8 tails of 256 on the shared prefix's
    # pages against the slab's prefill of the same 8 whole prompts
    dec = engine.decoder
    n_pp = PAGED_T_MAX // PAGE_SIZE
    pool = dec.init_paged_pool(8 * n_pp + 1, PAGE_SIZE)
    dec.paged_prefill(pool, prefix[None], [0], [256],
                      np.arange(1, n_pp + 1)[None])
    tails = np.stack([rng.integers(0, 32000, 256) for _ in range(8)])
    ptab = np.zeros((8, n_pp), np.int64)
    ptab[:, :16] = np.arange(1, 17)
    ptab[:, 16:32] = n_pp + 1 + np.arange(8 * 16).reshape(8, 16)
    full = np.concatenate([np.tile(prefix, (8, 1)), tails], axis=1)
    tail_ms = time_ms(lambda: dec.paged_prefill(
        pool, tails, np.full(8, 256), np.full(8, 256), ptab),
        warmup=2, reps=5, batch=1)
    slab_caches = dec.init_cache(8)
    slab_ms = time_ms(lambda: dec.prefill(slab_caches, full,
                                          np.full(8, 512)),
                      warmup=2, reps=5, batch=1)
    log(f"paged prefix [{card}]: prefill of 8 x 256-token tails on the "
        f"shared pages {tail_ms:.2f} ms ({8 * 256 / tail_ms * 1e3:.0f} "
        f"tail tok/s, {8 * 512 / tail_ms * 1e3:.0f} prompt tok/s served); "
        f"slab prefill of the 8 whole 512-token prompts {slab_ms:.2f} ms "
        f"({8 * 512 / slab_ms * 1e3:.0f} prompt tok/s)")
    profile_step(lambda: dec.paged_prefill(
        pool, tails, np.full(8, 256), np.full(8, 256), ptab),
        "paged tail prefill (8 x 256 tokens on 256 shared)")
    profile_step(lambda: dec.prefill(slab_caches, full, np.full(8, 512)),
                 "slab prefill (8 x 512 tokens)")
    ids = np.zeros(8, np.int64)
    profile_step(lambda: dec.paged_decode_block(
        pool, ptab, ids, np.full(8, 500), block_size=4),
        "paged decode block (8 lanes at 500, K=4)")
    profile_step(lambda: dec.decode_block(
        slab_caches, ids, np.full(8, 500), block_size=4),
        "slab decode block (8 lanes at 500, K=4)")

    # -- concurrency at the 8-slot slab's bytes
    engine = SlotGenerationEngine(net, num_slots=32, block_size=4,
                                  t_max=PAGED_T_MAX, paged=True,
                                  page_size=PAGE_SIZE,
                                  num_pages=8 * n_pp + 1)
    slab_bytes = sum(t.numel() * t.element_size()
                     for kv_ in slab_caches.values() for t in kv_.values())
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(32, 65, 32)]
    _, wall, st, fetched, peak, kv = _drive(engine, prompts, new_tokens)
    log(f"paged concurrency [{card}]: 32 requests (32-64-token prompts, "
        f"64 new) on {engine.num_pages} pages ({engine._pool_bytes()} "
        f"bytes; the 8-slot slab {slab_bytes}): peak active slots {peak} "
        f"(bar 24 = 3 x the slab's 8), most pages mapped {kv['mapped']}, "
        f"preempted {st['page_preempted']}; engine "
        f"{32 * new_tokens / wall:.1f} generated tok/s ({wall:.2f}s); "
        f"readbacks {fetched} for {st['decode_blocks']} blocks")
    if peak < 24:
        raise AssertionError(f"peak active slots {peak} < 24")
    _audit(engine, "paged concurrency")

    # -- speculation: 256-token prompts repeating a 32-token motif
    prompts = [np.tile(rng.integers(0, 32000, 32), 8) for _ in range(8)]
    # each cache: plain blocks, the default speculative engine (with
    # random weights acceptance is low, so it soon falls back to plain
    # blocks), and one that never falls back (spec_threshold 0: every
    # block is a verify block)
    rates, outs = {}, {}
    for paged in (False, True):
        for mode in ("off", "on", "always"):
            kw = dict(paged=True, page_size=PAGE_SIZE) if paged else {}
            if mode != "off":
                kw.update(speculative=True, spec_k=4)
            if mode == "always":
                kw.update(spec_threshold=0.0)
            engine = SlotGenerationEngine(net, num_slots=8, block_size=4,
                                          t_max=PAGED_T_MAX, **kw)
            engine.submit(prompts[0][:64], 4)
            engine.run_until_drained()          # warm
            reqs, wall, st, fetched, _, _ = _drive(engine, prompts,
                                                   new_tokens)
            what = f"{'paged' if paged else 'slab'} spec {mode}"
            rates[what] = 8 * new_tokens / wall
            outs[what] = [r.result(0) for r in reqs]
            line = (f"speculation [{card}]: {what}: "
                    f"{rates[what]:.1f} generated tok/s ({wall:.2f}s), "
                    f"{st['decode_blocks']} decode blocks, readbacks "
                    f"{fetched}")
            if mode != "off":
                if not st["spec_blocks"]:
                    raise AssertionError(f"{what}: no verify block ran")
                line += (f"; {st['spec_blocks']} verify blocks, acceptance "
                         f"{st['spec_accepted_tokens']}/"
                         f"{st['spec_drafted']} = "
                         f"{st['spec_accepted_tokens'] / st['spec_drafted']:.3f}"
                         f", {st['spec_emitted_tokens'] / st['spec_blocks']:.2f}"
                         f" tokens emitted a verify block (8 lanes), "
                         f"fallback blocks {st['spec_fallbacks']}")
            log(line)
            if paged:
                _audit(engine, what)
    for paged in ("slab", "paged"):
        for mode in ("on", "always"):
            same = sum((a == b).all() for a, b in zip(
                outs[f"{paged} spec {mode}"], outs[f"{paged} spec off"]))
            log(f"speculation [{card}]: {paged} spec {mode} / off "
                f"{rates[f'{paged} spec {mode}'] / rates[f'{paged} spec off']:.3f}"
                f"x generated tok/s; {same}/8 outputs identical (bf16 "
                "verify windows and decode steps round differently: not a "
                "gate)")
    check_verify_logits(net, prompts)
    launches = read_launches()
    log(f"paged phase: kernel launches {launches} (paged admissions of "
        "fresh prompts and the slab engines' admissions run the "
        "short-sequence kernel; prefix-hit tails and every cache seam "
        "plain attention)")
    if launches["shortseq_attention"] < 12:
        raise AssertionError("the slab engines' admissions did not launch "
                             "the short-sequence kernel")


# ---------------------------------------------------------------- phase 4c
#: phase 4c's window and the sentinel its timed engines run with (no page
#: verification: its readbacks would sit in the timings)
TIER_CHUNK = 128
SENTINEL = IntegrityConfig(kv_verify=False)


def _tier_engine(net, dec, **kw):
    """An engine of the tier as phase 4c times it: EDF, adaptive K and
    the sentinel (``dec`` must be a sentinel decoder)."""
    kw.setdefault("num_slots", 8)
    kw.setdefault("integrity", SENTINEL)
    return SlotGenerationEngine(net, decoder=dec, t_max=PAGED_T_MAX,
                                scheduling="edf", adaptive_block=True, **kw)


def _serve(engine, hook=None):
    """run_until_drained's loop with ``hook()`` after every admission and
    every cycle."""
    while True:
        engine._sweep_pending()
        engine._admit()
        if hook is not None:
            hook()
        if not engine._any_active():
            if not engine._pending:
                return
            continue
        engine._step()
        if hook is not None:
            hook()


def _stall_run(net, dec, paged, chunk, shorts, longs, warm):
    """8 short requests decoding (256 new tokens) when 4 long ones (16
    new) arrive, after the ``warm`` prompts (a long and a short one, no
    prefix shared with the measured ones). Returns (longest and median gap between decode-block
    retirements that carried a short lane, from the longs' arrival until
    the last long's first token; the longs' times to first token; decode
    readbacks, decode blocks)."""
    kw = dict(paged=True, page_size=PAGE_SIZE) if paged else {}
    engine = _tier_engine(net, dec, num_slots=12, prefill_chunk=chunk, **kw)
    for p in warm:
        engine.submit(p, 4)
    engine.run_until_drained()              # warm both prefill paths
    short_reqs = [engine.submit(p, 256) for p in shorts]
    retires = []
    retire = engine._retire_block

    def timed_retire(block):
        retire(block)
        if any(r in short_reqs for _, r in block[1]):
            retires.append(time.perf_counter())
    engine._retire_block = timed_retire
    engine._sweep_pending()
    engine._admit()
    for _ in range(4):                      # the shorts are decoding
        engine._step()
    torch.cuda.synchronize()
    stats0 = engine.stats()
    fetched0 = fetch_counts("engine.decode")["engine.decode"]
    t_sub = time.perf_counter()
    long_reqs = [engine.submit(p, 16) for p in longs]
    ttft = {}

    def first_tokens():
        now = time.perf_counter()
        for i, r in enumerate(long_reqs):
            if i not in ttft and r.generated:
                ttft[i] = now - t_sub
    _serve(engine, first_tokens)
    torch.cuda.synchronize()
    for p, r in zip(shorts + longs, short_reqs + long_reqs):
        want = len(p) + (256 if r in short_reqs else 16)
        if len(r.result(timeout=0)) != want:
            raise AssertionError(f"a request returned "
                                 f"{len(r.result(timeout=0))} tokens, "
                                 f"expected {want}")
    st = _stats_delta(engine, stats0)
    fetched = fetch_counts("engine.decode")["engine.decode"] - fetched0
    if fetched > st["decode_blocks"]:
        raise AssertionError(f"{fetched} decode readbacks for "
                             f"{st['decode_blocks']} decode blocks")
    if paged:
        _audit(engine, "stall run")
    t_last = t_sub + max(ttft.values())
    window = [t_sub] + [t for t in retires if t_sub < t]
    window = [t for t in window if t <= t_last] + \
        [t for t in window if t > t_last][:1]
    gaps = np.diff(window) * 1e3
    return (float(gaps.max()), float(np.median(gaps)),
            sorted(v * 1e3 for v in ttft.values()), fetched,
            st["decode_blocks"], st["prefill_chunks"])


def check_chunk_logits(net, dec, prompt):
    """A prompt's next-token logits after windows of TIER_CHUNK (one slab
    row through ``prefill_chunk``, and pages through ``paged_prefill``)
    against the whole prompt's prefill on the card (B1) and through the
    CPU f32 twin; raises above LOGIT_REL_TOL."""
    n = len(prompt)
    full, lengths = _padded([prompt], 512)
    _, whole, _ = dec.prefill(dec.init_cache(1), full, lengths)
    ref = TransformerDecoder(_cpu_twin(net), t_max=PAGED_T_MAX)
    _, twin, _ = ref.prefill(ref.init_cache(1), full, lengths)
    slab = dec.init_cache(1)
    n_pp = PAGED_T_MAX // PAGE_SIZE
    pool = dec.init_paged_pool(n_pp + 1, PAGE_SIZE)
    ptab = np.arange(1, n_pp + 1)[None]
    for pos0 in range(0, n, TIER_CHUNK):
        window = np.zeros((1, TIER_CHUNK), np.int64)
        valid = min(TIER_CHUNK, n - pos0)
        window[0, :valid] = prompt[pos0:pos0 + valid]
        _, got_slab, slab = dec.prefill_chunk(slab, window, pos0, valid, 0)
        _, got_paged, pool = dec.paged_prefill(pool, window, [pos0],
                                               [valid], ptab)
    errs = {f"{what} vs {against}": _rel_l2_rows(got, want)
            for what, got in (("slab windows", got_slab),
                              ("paged windows", got_paged))
            for against, want in (("card whole", whole),
                                  ("CPU f32", twin))}
    log(f"chunked prefill: final-window logits rel-L2 "
        f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol "
        f"{LOGIT_REL_TOL}; {n} tokens, windows of {TIER_CHUNK})")
    if not all(np.isfinite(v) and v <= LOGIT_REL_TOL
               for v in errs.values()):
        raise AssertionError("chunked-prefill logits disagree")


def check_recompute(net, dec, rng):
    """recompute_logits on 8 rows of 512: one B1 launch a layer, logits
    as the cached prefill's."""
    tokens = rng.integers(0, 32000, (8, 512))
    lengths = np.full(8, 512)
    torch.cuda.synchronize()
    reset_launches()
    _, got = dec.recompute_logits(tokens, lengths)
    torch.cuda.synchronize()
    launched = read_launches()["shortseq_attention"]
    _, want, _ = dec.prefill(dec.init_cache(8), tokens, lengths)
    rel = _rel_l2_rows(got, want)
    rec_ms = time_ms(lambda: dec.recompute_logits(tokens, lengths),
                     warmup=1, reps=5, batch=1)
    caches = dec.init_cache(8)
    pre_ms = time_ms(lambda: dec.prefill(caches, tokens, lengths),
                     warmup=1, reps=5, batch=1)
    log(f"recompute_logits: 8 x 512, B1 launches {launched} (12 layers), "
        f"logits rel-L2 vs the cached prefill {rel:.3e} (tol "
        f"{LOGIT_REL_TOL}); {rec_ms:.2f} ms against the prefill's "
        f"{pre_ms:.2f} ms")
    if launched != 12:
        raise AssertionError(f"recompute_logits launched B1 {launched} "
                             "times, expected 12")
    if not (np.isfinite(rel) and rel <= LOGIT_REL_TOL):
        raise AssertionError("recompute logits disagree with the prefill's")


def _burst(card, net, dec, rng):
    """32 requests with mixed deadlines, EDF, headroom shedding, 4
    cancelled mid-decode, on a paged engine."""
    engine = _tier_engine(net, dec, paged=True, page_size=PAGE_SIZE,
                          shed_headroom=True)
    engine.submit(rng.integers(0, 32000, 64), 16)
    engine.submit(rng.integers(0, 32000, 128), 16)
    engine.run_until_drained()              # warm: the latency averages
    ks, lat = [], []
    choose, retire = engine._choose_block_size, engine._retire_block

    def recording_choose():
        ks.append(choose())
        return ks[-1]

    def timed_retire(block):
        retire(block)
        lat.append((time.perf_counter() - block[3]) * 1e3)
    engine._choose_block_size = recording_choose
    engine._retire_block = timed_retire
    deadlines = [None, 60.0, 3.0, 0.05] * 8
    reqs = [engine.submit(rng.integers(0, 32000, int(rng.integers(32, 257))),
                          int(rng.integers(32, 97)), deadline=d)
            for d in deadlines]
    targets = [r for r, d in zip(reqs, deadlines) if d is None][:4]

    def cancel_mid_decode():
        for r in targets:
            if len(r.generated) >= 2 and not r.done() and \
                    not r._cancel_requested:
                r.cancel()
    t0 = time.perf_counter()
    _serve(engine, cancel_mid_decode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats()
    states = {}
    for r in reqs:
        states[r.state] = states.get(r.state, 0) + 1
    k_hist = {k: ks.count(k) for k in sorted(set(ks))}
    log(f"deadlines [{card}]: 32 requests (deadlines none / 60 s / 3 s / "
        f"0.05 s, 4 cancelled mid-decode), EDF, headroom shedding: "
        f"{states}; headroom_shed {st['headroom_shed']}, "
        f"deadline_exceeded {st['deadline_exceeded']}, cancelled "
        f"{st['cancelled']}, completed {st['completed'] - 2}; {wall:.2f}s")
    log(f"adaptive K [{card}]: blocks by K {k_hist}; block latency "
        f"(dispatch to retire) median {np.median(lat):.2f} ms, max "
        f"{max(lat):.2f} ms against block_latency_target "
        f"{engine.block_latency_target * 1e3:.0f} ms")
    if not all(r.done() for r in reqs):
        raise AssertionError("a request of the burst never ended")
    if st["cancelled"] != 4 or any(r.state != r.CANCELLED for r in targets):
        raise AssertionError(f"cancelled {st['cancelled']}, expected the 4 "
                             "targets")
    if st["headroom_shed"] < 1:
        raise AssertionError("no infeasible request was shed by headroom")
    if engine._any_active() or engine.stats()["queue_depth"]:
        raise AssertionError("a slot or a queued request is left over")
    _audit(engine, "deadline burst")


def _sentinel_checks(card, net, dec_s, rng):
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(64, 257, 8)]
    plain = TransformerDecoder(net, t_max=PAGED_T_MAX)
    rates, outs = {}, {}
    for what in ("off", "on", "on", "off"):
        engine = _tier_engine(net, plain if what == "off" else dec_s,
                              integrity=None if what == "off" else SENTINEL)
        engine.submit(prompts[0][:64], 4)
        engine.run_until_drained()
        reqs, wall, st, fetched, _, _ = _drive(engine, prompts, 64)
        rates.setdefault(what, []).append(8 * 64 / wall)
        outs[what] = [r.result(0) for r in reqs]
        if what == "on" and st["numerical_faults"]:
            raise AssertionError("the sentinel tripped on a clean run")
    same = sum((a == b).all() for a, b in zip(outs["on"], outs["off"]))
    log(f"sentinel [{card}]: generated tok/s off "
        f"{', '.join(f'{x:.1f}' for x in rates['off'])}, on "
        f"{', '.join(f'{x:.1f}' for x in rates['on'])} (runs off, on, on, "
        f"off; 8 requests of 64-256 tokens, 64 new, 8 slots); {same}/8 "
        f"outputs identical on and off")
    if same != 8:
        raise AssertionError("the sentinel changed tokens")
    # NaN logits on the first block's first lane, paged
    inj = FaultInjector()
    inj.corrupt("device.corrupt_logits", mode="nan", at=1)
    engine = _tier_engine(net, dec_s, paged=True, page_size=PAGE_SIZE,
                          fault_injector=inj)
    reqs = [engine.submit(p, 64) for p in prompts]
    engine.run_until_drained()
    faulted = [r for r in reqs if isinstance(r._error, NumericalFault)]
    done = [r for r in reqs if r.state == r.DONE and
            len(r.result(0)) == len(r.prompt) + 64]
    log(f"sentinel [{card}]: NaN injected at the first block: "
        f"{len(faulted)} NumericalFault (tokens kept "
        f"{[len(r.generated) for r in faulted]}), {len(done)} completed, "
        f"numerical_faults {engine.stats()['numerical_faults']}")
    if len(faulted) != 1 or len(faulted[0].generated) != 1 or \
            len(done) != 7:
        raise AssertionError("the NaN injection did not fail exactly its "
                             "request before any of its block's tokens")
    _audit(engine, "NaN injection")
    # a flipped page of a registered prefix, caught on the next hit
    inj = FaultInjector()
    engine = _tier_engine(net, dec_s, paged=True, page_size=PAGE_SIZE,
                          fault_injector=inj,
                          integrity=IntegrityConfig(kv_verify_rate=1.0))
    prefix = rng.integers(0, 32000, 256)
    tail = lambda: rng.integers(0, 32000, 32)          # noqa: E731
    engine.submit(np.concatenate([prefix, tail()]), 8)
    engine.run_until_drained()
    inj.corrupt("device.corrupt_page", mode="flip", at=1,
                where="registered")
    engine.submit(np.concatenate([prefix, tail()]), 8)
    engine.run_until_drained()
    last = engine.submit(np.concatenate([prefix, tail()]), 8)
    engine.run_until_drained()
    st = engine.stats()
    log(f"page verifier [{card}]: flipped shared-prefix page: "
        f"kv_page_corruptions {st['kv_page_corruptions']}, prefix hits "
        f"{st['prefix_cache_hits']}, the next request "
        f"{len(last.result(0)) - len(last.prompt)} tokens")
    if st["kv_page_corruptions"] != 1 or \
            len(last.result(0)) != len(last.prompt) + 8:
        raise AssertionError("the verifier missed the flipped page")
    _audit(engine, "page verifier")


def _supervised_restart(card, net, dec_s, rng):
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(64, 257, 8)]
    inj = FaultInjector()
    inj.raise_once("engine.step", RuntimeError("injected crash"), at=12)
    engine = _tier_engine(net, dec_s, fault_injector=inj)
    sup = EngineSupervisor(engine, timeout=60.0, interval=0.1,
                           max_restarts=2)
    took = []
    restart = sup._restart

    def timed_restart(cause):
        t0 = time.perf_counter()
        restart(cause)
        took.append(time.perf_counter() - t0)
    sup._restart = timed_restart
    casts, builds = dec_s.param_casts, cuda_lib.nvcc_runs()
    ends = []
    sup.start()
    try:
        t0 = time.perf_counter()
        reqs = [sup.submit(p, 64) for p in prompts]
        for r in reqs:
            r.add_done_callback(ends.append)
        outs = [r.result(timeout=300) for r in reqs]
        wall = time.perf_counter() - t0
        st = sup.stats()
    finally:
        sup.stop()
    log(f"supervisor [{card}]: crash at engine.step hit 12: restarts "
        f"{sup.restarts}, recovered {sup.recovered_requests}, requeued "
        f"{st['requeued']}, completed {st['completed']}, failed "
        f"{st['failed']}; restart "
        f"{took[0] * 1e3 if took else float('nan'):.2f} ms (quarantine, "
        f"rebuild, requeue); 8 requests in {wall:.2f}s; nvcc runs after "
        f"{cuda_lib.nvcc_runs() - builds}, weight casts after "
        f"{dec_s.param_casts - casts}")
    if sup.restarts != 1 or st["completed"] != 8 or st["failed"] or \
            len(ends) != 8 or \
            any(len(o) != len(p) + 64 for o, p in zip(outs, prompts)):
        raise AssertionError("supervised recovery lost, duplicated or cut "
                             "a request")
    if cuda_lib.nvcc_runs() != builds or dec_s.param_casts != casts:
        raise AssertionError("the restart built a kernel or cast weights")


def phase_tier(card, net):
    """Phase 4c: chunked prefill, recompute, deadlines / cancel /
    shedding / adaptive K, the sentinel and page verifier, and supervised
    restart, on the flagship net."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    dec_s = TransformerDecoder(net, t_max=PAGED_T_MAX, sentinel=True)
    reset_launches()
    shorts = [rng.integers(0, 32000, int(n)) for n in rng.integers(32, 65, 8)]
    longs = [rng.integers(0, 32000, int(n))
             for n in rng.integers(448, 513, 4)]
    warm = [rng.integers(0, 32000, 480), rng.integers(0, 32000, 48)]
    for paged in (False, True):
        rows = {}
        for chunk in (None, TIER_CHUNK):
            rows[chunk] = _stall_run(net, dec_s, paged, chunk, shorts,
                                     longs, warm)
        for chunk, (gmax, gmed, ttft, fetched, blocks, windows) in \
                rows.items():
            log(f"chunked prefill [{card}]: "
                f"{'paged' if paged else 'slab'}, "
                f"{'windows of ' + str(chunk) if chunk else 'whole'}: "
                f"short lanes' longest retire gap {gmax:.2f} ms (median "
                f"{gmed:.2f}) while 4 long prompts prefill; long TTFT ms "
                f"{[round(t, 2) for t in ttft]}; {windows} windows; "
                f"readbacks {fetched} for {blocks} decode blocks")
        log(f"chunked prefill [{card}]: {'paged' if paged else 'slab'} "
            f"chunked / whole: longest gap "
            f"{rows[TIER_CHUNK][0] / rows[None][0]:.3f}x, last long TTFT "
            f"{rows[TIER_CHUNK][2][-1] / rows[None][2][-1]:.3f}x")
    slab_b1 = read_launches()["shortseq_attention"]
    log(f"tier phase: B1 launches in the slab engines' admissions "
        f"{slab_b1}")
    # what a cycle's window costs against the whole admission it replaces
    caches = dec_s.init_cache(12)
    tokens, lengths = _padded(longs, 512)
    window = tokens[:1, 3 * TIER_CHUNK:4 * TIER_CHUNK]
    profile_step(lambda: dec_s.prefill_chunk(caches, window, 3 * TIER_CHUNK,
                                             TIER_CHUNK, 0),
                 "slab window (1 x 128 at 384)")
    profile_step(lambda: dec_s.prefill_slots(caches, tokens, lengths,
                                             np.arange(4)),
                 "slab admission of the 4 long prompts (bucket 512)")
    del caches
    if slab_b1 < 12:
        raise AssertionError("the slab engines' admissions did not launch "
                             "B1")
    check_chunk_logits(net, dec_s, rng.integers(0, 32000, 480))
    check_recompute(net, dec_s, rng)
    _burst(card, net, dec_s, rng)
    _sentinel_checks(card, net, dec_s, rng)
    _supervised_restart(card, net, dec_s, rng)
    log(f"tier phase: {time.perf_counter() - t_phase:.1f}s wall")


# ----------------------------------------------------------------- phase 5
# ---------------------------------------------------------------- phase 4d
def _route_round(card, net, broker, what):
    """Phase 4's prompts through a GenerationServingRoute on ``broker``
    with every sink on; checks the bars of phase 4d (a) and returns the
    route's generated tok/s."""
    prompts, outputs = SERVED["prompts"], SERVED["outputs"]
    new_tokens = SERVED["new_tokens"]
    reg, ring = MetricsRegistry(), TraceRing()
    slo = SLOTracker(registry=reg, name=f"route-{what}")
    eng = SlotGenerationEngine(net, num_slots=8, block_size=4, registry=reg,
                               trace_store=ring, slo=slo,
                               flight_recorder=FlightRecorder(registry=reg),
                               profiler=PhaseProfiler(reg))
    topic_in, topic_out = f"gen-in-{what}", f"gen-out-{what}"
    out_sub = NDArraySubscriber(broker, topic_out)
    route = GenerationServingRoute(net, broker, input_topic=topic_in,
                                   output_topic=topic_out,
                                   max_new_tokens=new_tokens, engine=eng,
                                   max_inflight=len(prompts))
    route.start()
    time.sleep(0.2)               # the route's subscription is live
    torch.cuda.synchronize()
    reset_launches()
    fetched0 = fetch_counts("engine.decode")["engine.decode"]
    t0 = time.perf_counter()
    pub = NDArrayPublisher(broker, topic_in)
    for p in prompts:
        pub.publish(np.asarray(p, np.int64))
    got = [out_sub.poll(timeout=120) for _ in prompts]
    wall = time.perf_counter() - t0
    extra = out_sub.poll(timeout=0.5)
    launches = read_launches()
    fetched = fetch_counts("engine.decode")["engine.decode"] - fetched0
    stats = eng.stats()
    route.stop()
    eng.shutdown()
    out_sub.close()
    if any(g is None for g in got) or extra is not None:
        raise AssertionError(f"route over {what}: {sum(g is None for g in got)}"
                             f" results missing, duplicate {extra is not None}")
    for g, want in zip(got, outputs):
        if not np.array_equal(np.asarray(g), want):
            raise AssertionError(f"route over {what}: tokens differ from "
                                 "the direct engine's")
    traces = ring.recent()
    bad = [t.span_names() for t in traces
           if not t.finished or t.span_names().count("consume") != 1 or
           t.span_names()[-1] != "publish"]
    if len(traces) != len(prompts) or bad:
        raise AssertionError(f"route over {what}: {len(traces)} traces for "
                             f"{len(prompts)} requests, {len(bad)} without "
                             "consume .. publish")
    if slo.snapshot()["requests"] != len(prompts):
        raise AssertionError(f"route over {what}: SLO records "
                             f"{slo.snapshot()['requests']}")
    if fetched > stats["decode_blocks"]:
        raise AssertionError(f"route over {what}: {fetched} readbacks for "
                             f"{stats['decode_blocks']} decode blocks")
    if launches["shortseq_attention"] < 12 * stats["prefill_batches"]:
        raise AssertionError(f"route over {what}: B1 launched "
                             f"{launches['shortseq_attention']} times for "
                             f"{stats['prefill_batches']} admissions")
    tok_s = len(prompts) * new_tokens / wall
    log(f"serving host [{card}]: route over {what}: {len(got)} results, "
        f"token-identical, {len(traces)} traces consume..publish, SLO "
        f"records {slo.snapshot()['requests']}, readbacks {fetched} / "
        f"decode blocks {stats['decode_blocks']}, admissions "
        f"{stats['prefill_batches']}, B1 launches "
        f"{launches['shortseq_attention']}; {tok_s:.1f} generated tok/s "
        f"({wall:.2f}s)")
    return tok_s


def _hooks_ab(card, net):
    """Decode tok/s of the 16 requests with every hook on and every hook
    off (tracing, histograms, flight events, profiler), 3 alternating runs
    each on one decoder; medians logged, no gate."""
    prompts, new_tokens = SERVED["prompts"], SERVED["new_tokens"]
    dec = TransformerDecoder(net)

    def run(on):
        eng = SlotGenerationEngine(net, num_slots=8, block_size=4,
                                   decoder=dec, tracing=on,
                                   registry=MetricsRegistry())
        for p in prompts:
            eng.submit(p, new_tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        return eng.stats()["emitted_tokens"] / (time.perf_counter() - t0)

    run(True)
    on, off = [], []
    for r in range(3):
        for hooks in ((True, False) if r % 2 == 0 else (False, True)):
            (on if hooks else off).append(run(hooks))
    log(f"serving host [{card}]: hooks A/B decode tok/s (16 requests, 64 "
        f"new tokens, 8 slots, K 4): on {[round(x, 1) for x in on]} median "
        f"{statistics.median(on):.1f}, off {[round(x, 1) for x in off]} "
        f"median {statistics.median(off):.1f}")


def _f32_twin(net):
    """The net's f32 masters run in f32 on the card (TF32 off): the net of
    the token-exact recovery rounds. A recovered request re-prefills
    prompt + tokens so far, and in bf16 that prefill's cache cells differ
    in rounding from the ones decode wrote (other kernels, other summation
    orders): greedy continuations may then part from the uninterrupted
    run's after the crash, as the JAX engine's do in bf16
    (tests/test_torch_resilience.py). In f32 they agree."""
    twin = ComputationGraph(net.conf, compute_dtype=torch.float32,
                            device=net.device)
    twin.params, twin.state = net.params, net.state
    twin.updater_state = {}      # serving only: write_model skips adam's
    twin._initialized = True     # two copies of the weights
    return twin


def _crash_round(card, net, label, exact, prompts, new_tokens):
    """Two FaultInjector crashes at engine.step under an EngineSupervisor
    with a post-mortem directory (tools/chaos_soak.run_soak); ``exact``
    False holds recovered tokens to the clean run up to each request's
    first crash point only."""
    pm_dir = tempfile.mkdtemp(prefix="postmortems-")
    try:
        s = chaos_soak.run_soak(
            net=net, prompts=prompts[:8], gens=[new_tokens] * 8,
            num_slots=8, block_size=4, crashes=2, hangs=0,
            crash_hits=(4, 9),
            supervisor_timeout=10.0, overhead_ab=False,
            postmortem_dir=pm_dir, steady_wave=2, seed=3,
            exact_after_crash=exact)
        shown = _check_soak(s, f"supervised crashes ({label})", (
            "crash_hits", "stranded", "completed", "failed", "mismatches",
            "diverged_after_crash", "restarts", "recovered_requests",
            "takeover_spans", "trace_problems", "readbacks_per_block",
            "steady_new_builds", "steady_new_casts", "postmortem_ok"))
        if s["restarts"] != len(s["crash_hits"]) or \
                len(s["postmortems"]) != s["restarts"] or \
                s["completed"] != 8:
            raise AssertionError(f"supervised crashes ({label}): "
                                 f"{s['restarts']} restarts, "
                                 f"{len(s['postmortems'])} post-mortems, "
                                 f"{s['completed']} of 8 completed")
        log(f"serving host [{card}]: supervised crashes, {label}: "
            f"{json.dumps(shown)}")
    finally:
        shutil.rmtree(pm_dir, ignore_errors=True)


def _check_soak(summary, what, keys):
    shown = {k: summary.get(k) for k in keys}
    if not summary.get("ok"):
        raise AssertionError(f"{what} failed: {json.dumps(shown, default=str)}")
    return shown


def phase_serving_host(card, net):
    """Phase 4d: the serving host tier around one engine on the flagship
    (module docstring)."""
    t_phase = time.perf_counter()
    # (a) the routes over memory:// and over TCP
    _route_round(card, net, create_broker("memory://"), "memory")
    server = TcpBrokerServer(host="127.0.0.1", port=0).start()
    try:
        _route_round(card, net, create_broker(server.url), "tcp")
    finally:
        server.close()
    # (b) telemetry on / off
    _hooks_ab(card, net)
    prompts, outputs = SERVED["prompts"], SERVED["outputs"]
    new_tokens = SERVED["new_tokens"]
    twin = _f32_twin(net)
    # (c) two supervised crashes with post-mortems: on the bf16 flagship
    # every bar but token identity after a request's first crash point
    # (identity up to it, full length, exactly once, post-mortem ids);
    # on the f32 twin the tokens equal the clean run's throughout
    _crash_round(card, net, "bf16 flagship", False, prompts, new_tokens)
    _crash_round(card, twin, "f32 twin", True, prompts, new_tokens)
    # (d) the process kill and the preemption drain, on the card
    # 4 slots and budgets of 16-64 tokens, so results trickle out and
    # each kill lands with requests still decoding
    rng = np.random.default_rng(11)
    pk_prompts = [prompts[i] for i in rng.choice(len(prompts), 10,
                                                 replace=False)]
    pk_gens = [int(g) for g in rng.integers(16, new_tokens + 1, 10)]
    s = chaos_soak.run_process_kill_soak(
        net=twin, prompts=pk_prompts, gens=pk_gens, num_slots=4,
        block_size=4, drain_deadline=20.0, round_wait_s=240.0, slow=0.1)
    shown = _check_soak(s, "process kill", (
        "rounds", "lost", "duplicates", "mismatches", "failures",
        "clock_spanning_requests", "clock_breaks", "steady_new_builds",
        "recovery_s", "drain_ok", "child_logs"))
    drain = s["drain"] or {}
    log(f"serving host [{card}]: process kill {json.dumps(shown, default=str)}"
        f"; drain {drain.get('drain_s')} s (harvested "
        f"{drain.get('harvested')}, manifest "
        f"{bool(drain.get('manifest_path'))}); journal on tok/s "
        f"{[round(x, 1) for x in s['journal_on_tok_s']]} median "
        f"{s['journal_on_tok_s_median']:.1f}, off "
        f"{[round(x, 1) for x in s['journal_off_tok_s']]} median "
        f"{s['journal_off_tok_s_median']:.1f}")
    # (e) ParallelInference.generate from 4 threads
    pi = ParallelInference(net, generation_slots=8, generation_block_size=4,
                           generation_registry=MetricsRegistry())
    got = [None] * 4
    threads = [threading.Thread(
        target=lambda i=i: got.__setitem__(
            i, pi.generate(prompts[i], new_tokens, timeout=120)),
        daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = pi.generation_stats()
    engine_ids = {id(pi._gen_engine)}
    pi.shutdown()
    if any(g is None or not np.array_equal(g, outputs[i])
           for i, g in enumerate(got)) or len(engine_ids) != 1 or \
            st["completed"] != 4:
        raise AssertionError("ParallelInference.generate disagrees with the "
                             "direct engine")
    log(f"serving host [{card}]: ParallelInference.generate from 4 threads:"
        f" one engine, {st['prefill_batches']} admissions, token-identical")
    log(f"serving host phase: {time.perf_counter() - t_phase:.1f}s wall")


# ---------------------------------------------------------------- phase 4e
#: the fleet phase's shape: 3 replicas of 4 slots on one shared decoder,
#: 24 greedy requests (16-256 prompt tokens, 16-64 new), r0 crashed at
#: its 6th engine.step hit
FLEET_REPLICAS = 3
FLEET_SLOTS = 4
FLEET_CRASH_HIT = 6
#: the phase's wall-clock budget, s
FLEET_PHASE_LIMIT_S = 150
DISAGG_KW = dict(num_slots=FLEET_SLOTS, block_size=4, page_size=PAGE_SIZE,
                 heartbeat_interval=0.05, monitor_interval=0.05,
                 suspect_after=1.0, dead_after=5.0)
FLEET_KW = dict(DISAGG_KW, paged=True)


def _fleet_requests():
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(16, 257, 24)]
    gens = [int(g) for g in rng.integers(16, 65, 24)]
    return prompts, gens


def _direct_paged(net, dec, prompts, gens):
    """The direct paged engine's outputs: the fleet phase's reference."""
    eng = SlotGenerationEngine(net, decoder=dec, num_slots=FLEET_SLOTS,
                               block_size=4, paged=True,
                               page_size=PAGE_SIZE)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng.run_until_drained()
    _audit(eng, "direct paged engine")
    return [r.result(timeout=0) for r in reqs]


def _migration_point(fr):
    """Tokens a request held when it first migrated (its trace's first
    ``migrate`` event), or None."""
    if fr.trace is None:
        return None
    for span in fr.trace._spans:
        if span.name == "migrate":
            return int(span.attrs.get("generated", 0))
    return None


def _hold_fleet(frs, prompts, gens, ref, exact, what):
    """Every request once, DONE, at full length. ``exact``: tokens equal
    to ``ref``. Otherwise (bf16) they are compared and reported, not
    held: a bf16 prefill rounds by its admission wave's shape (its rows
    and padded length choose the products' tiling), and a fleet's waves
    are not the direct engine's. Returns {"identical", "migrated",
    "parted": [(request, first differing new token, tokens at its
    migration or None)]}."""
    out = {"identical": 0, "migrated": 0, "parted": []}
    for fr, p, g, want in zip(frs, prompts, gens, ref):
        got = fr.result(timeout=0)
        if len(got) != len(p) + g:
            raise AssertionError(f"{what}: {fr.request_id} returned "
                                 f"{len(got)} tokens, expected {len(p) + g}")
        n = _migration_point(fr)
        out["migrated"] += n is not None
        if np.array_equal(got, want):
            out["identical"] += 1
            continue
        first = int(np.flatnonzero(got != want)[0]) - len(p)
        out["parted"].append((fr.request_id, first, n))
        if exact:
            raise AssertionError(f"{what}: {fr.request_id} (migrated at "
                                 f"{n}) parts from the reference at new "
                                 f"token {first}")
    return out


def _fleet_audits(router, what):
    bad = chaos_soak._page_audit(router)
    if bad:
        raise AssertionError(f"{what}: page audit failed: {bad[:4]}")


def _crash_fleet(card, net, dec, prompts, gens, ref, exact, label, sinks):
    """The 24 requests on 3 replicas, r0 crashed mid-stream; the bars of
    phase 4e (a). Returns the B1 launches and the fleet's admissions."""
    injs = [FaultInjector() for _ in range(FLEET_REPLICAS)]
    injs[0].raise_once("engine.step", RuntimeError(
        f"fleet phase: r0 crash at step hit {FLEET_CRASH_HIT}"),
        at=FLEET_CRASH_HIT)
    router = EngineFleetRouter(net, num_replicas=FLEET_REPLICAS, decoder=dec,
                               replica_injectors=injs, **sinks, **FLEET_KW)
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    torch.cuda.synchronize()
    reset_launches()
    fetched0 = fetch_counts("engine.decode")["engine.decode"]
    t0 = time.perf_counter()
    router.start()
    try:
        for fr in frs:
            fr.result(timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()["shortseq_attention"]
        fetched = fetch_counts("engine.decode")["engine.decode"] - fetched0
        st = router.stats()
        states = {rid: router.replica_state(rid)
                  for rid in router.replica_ids()}
        _fleet_audits(router, f"fleet ({label})")
    finally:
        router.shutdown()
    ledger = router.ledger.to_dict()
    held = _hold_fleet(frs, prompts, gens, ref, exact, f"fleet ({label})")
    migrated = held["migrated"]
    log(f"fleet [{card}] ({label}): {len(frs)} requests on "
        f"{FLEET_REPLICAS} x {FLEET_SLOTS} slots, r0 crashed at step hit "
        f"{FLEET_CRASH_HIT}: states {states}; ledger {ledger}; migrated "
        f"{migrated}; identical to the direct paged engine "
        f"{held['identical']} of {len(frs)}, parted (request, first new "
        f"token, migration point) {held['parted']}; "
        f"admissions {st['prefill_batches']}, B1 launches {launches}; "
        f"decode readbacks {fetched} / blocks {st['decode_blocks']}; "
        f"{sum(gens) / wall:.1f} generated tok/s ({wall:.2f}s)")
    if ledger["duplicates"] or ledger["completed"] != len(frs) or \
            states["r0"] != "DEAD" or not migrated:
        raise AssertionError(f"fleet ({label}): ledger {ledger}, states "
                             f"{states}, migrated {migrated}")
    if fetched > st["decode_blocks"]:
        raise AssertionError(f"fleet ({label}): {fetched} readbacks for "
                             f"{st['decode_blocks']} decode blocks")
    if launches < len(dec.attn_names) * st["prefill_batches"]:
        raise AssertionError(f"fleet ({label}): B1 launched {launches} "
                             f"times for {st['prefill_batches']} admissions")
    return launches


def check_paged_fresh_prefill(net, dec, prompts):
    """A paged admission of fresh prompts through the attention helper (B1
    on the card) against the same admission on the plain window path:
    the last-position logits within the attention tolerance."""
    from deeplearning4j_tpu_torch.nn.conf.layers import attention as attn
    tokens, lengths = _padded(prompts[:4], 256)
    ptab = np.zeros((4, PAGED_T_MAX // PAGE_SIZE), np.int64)
    for i in range(4):
        ptab[i] = 1 + i * ptab.shape[1] + np.arange(ptab.shape[1])
    outs = []
    for plain in (False, True):
        pools = dec.init_paged_pool(1 + 4 * ptab.shape[1], PAGE_SIZE)
        saved = attn.get_helper
        if plain:
            attn.get_helper = lambda kind, device: None
        try:
            _, logits, _ = dec.paged_prefill(pools, tokens,
                                             np.zeros(4, np.int64), lengths,
                                             ptab)
        finally:
            attn.get_helper = saved
        outs.append(logits.float().cpu())
    err = _rel_l2_rows(outs[0], outs[1])
    log(f"fleet: fresh paged prefill through B1 vs the plain window path "
        f"(4 prompts, bucket 256): logits rel-L2 {err:.3e} (tol "
        f"{LOGIT_REL_TOL})")
    if not err <= LOGIT_REL_TOL:
        raise AssertionError("the fresh paged prefill's kernel route "
                             "disagrees with the plain window path")


def _disagg_round(card, net, dec, prompts, gens, ref, exact, transport,
                  sinks, label, server=None):
    """The 24 requests through a PhaseRouter (1 prefill, 2 decode
    workers), queued before it starts, so the prefill worker's admission
    waves are the same in every such run: tokens against ``ref`` (held
    with ``exact``), every export 2 x layers ``kv_handoff`` readbacks,
    the transfer bytes against the formula. Returns (B1 launches,
    outputs). With ``server``
    (a TelemetryServer over ``sinks``' registry), the router's fleet and
    disagg documents become its sources and every endpoint is scraped
    while the router is up."""
    router = PhaseRouter(net, prefill_replicas=1, decode_replicas=2,
                         decoder=dec, transport=transport, **sinks,
                         **DISAGG_KW)
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    torch.cuda.synchronize()
    reset_launches()
    kv0 = fetch_counts("kv_handoff")["kv_handoff"]
    t0 = time.perf_counter()
    router.start()
    try:
        for fr in frs:
            fr.result(timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()["shortseq_attention"]
        kv = fetch_counts("kv_handoff")["kv_handoff"] - kv0
        stats = router.disagg_stats()
        pre = router._replicas["p0"].engine.stats()
        _fleet_audits(router, f"disagg ({label})")
        if server is not None:
            server.add_source("fleet", router.fleet_stats)
            server.add_source("disagg", router.disagg_stats)
            _scrape_telemetry(card, server)
    finally:
        router.shutdown()
    ledger = router.ledger.to_dict()
    held = _hold_fleet(frs, prompts, gens, ref, exact, f"disagg ({label})")
    h = stats["handoffs"]
    # payload: pages x 2 (k, v) x layers x heads x page x Dh x itemsize
    # (one page of every layer's pool) plus the int32 context tokens
    layers = len(dec.attn_names)
    page_bytes = sum(t.numel() * t.element_size() for kv in
                     dec.init_paged_pool(1, PAGE_SIZE).values()
                     for t in kv.values())
    ctx_tokens = sum(len(p) for p in prompts)
    payload = h["pages"] * page_bytes + 4 * ctx_tokens
    secs = stats["transfer_seconds"]
    wire = transport.stats().get("wire_bytes")
    log(f"disagg [{card}] ({label}): {len(frs)} requests, 1 prefill + 2 "
        f"decode workers: identical to the reference {held['identical']} "
        f"of {len(frs)} (parted {held['parted']}); handoffs "
        f"{h['completed']} (fenced {h['fenced']}, failed "
        f"{h['failed']}), pages {h['pages']}, payload bytes {h['bytes']} "
        f"(formula: pages x {page_bytes} + 4 x {ctx_tokens} = {payload}), "
        f"wire bytes {wire}; kv_transfer_seconds "
        f"{secs['sum'] / max(1, secs['count']) * 1e3:.3f} ms a handoff "
        f"(p50 {secs.get('p50')}, p99 {secs.get('p99')}); kv_handoff "
        f"readbacks {kv} ({kv / max(1, pre['handoffs']):.1f} an export); "
        f"prefill admissions {pre['prefill_batches']}, B1 launches "
        f"{launches}; ledger {ledger}; {sum(gens) / wall:.1f} generated "
        f"tok/s ({wall:.2f}s)")
    if h["completed"] != len(frs) or h["bytes"] != payload or \
            kv != 2 * layers * pre["handoffs"] or ledger["duplicates"] or \
            ledger["completed"] != len(frs):
        raise AssertionError(f"disagg ({label}): handoffs {h}, "
                             f"readbacks {kv}, ledger {ledger}")
    if launches < len(dec.attn_names) * pre["prefill_batches"]:
        raise AssertionError(f"disagg ({label}): B1 launched "
                             f"{launches} times for "
                             f"{pre['prefill_batches']} admissions")
    return launches, [fr.result(timeout=0) for fr in frs]


def _disagg_kill(card, net, dec, prompts, gens, ref, sinks):
    """A decode worker killed mid-stream: its streams re-prefill on the
    prefill pool, nothing lost or duplicated."""
    router = PhaseRouter(net, prefill_replicas=1, decode_replicas=2,
                         decoder=dec, transport=InProcessKVTransport(),
                         **sinks, **DISAGG_KW)
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    router.start()
    try:
        deadline = time.monotonic() + 120
        while router.disagg_stats()["handoffs"]["completed"] < 6 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        router.kill_replica("d0")
        for fr in frs:
            fr.result(timeout=300)
        _fleet_audits(router, "disagg decode kill")
        handoffs = router.disagg_stats()["handoffs"]
    finally:
        router.shutdown()
    ledger = router.ledger.to_dict()
    held = _hold_fleet(frs, prompts, gens, ref, False, "disagg decode kill")
    migrated = held["migrated"]
    log(f"disagg [{card}]: decode worker d0 killed after "
        f"{handoffs['completed']} handoffs: {len(frs)} completed, lost 0, "
        f"duplicated {ledger['duplicates']}, re-prefilled {migrated}; "
        f"identical to the direct paged engine {held['identical']} "
        f"(parted {held['parted']}); ledger {ledger}")
    if ledger["duplicates"] or ledger["completed"] != len(frs) or \
            not migrated:
        raise AssertionError(f"disagg decode kill: ledger {ledger}, "
                             f"migrated {migrated}")


def _corruption_round(card, twin, prompts, gens):
    """On the f32 twin (TF32 off, where a re-prefill decodes as the first
    pass did): a silent sign flip at rest in r1's pool under the canary's
    cached prefix; the next canary round quarantines r1 CORRUPT, its
    streams migrate, and no result differs from the direct engine's."""
    cfg = IntegrityConfig(kv_verify=False, fault_threshold=1,
                          canary_tokens=8, canary_prompt=tuple(
                              int(t) for t in np.arange(20) * 37 + 11))
    dec = TransformerDecoder(twin, t_max=PAGED_T_MAX, sentinel=True,
                             logit_bound=cfg.logit_bound)
    ref_dec = TransformerDecoder(twin, t_max=PAGED_T_MAX, sentinel=True,
                                 logit_bound=cfg.logit_bound)
    eng = SlotGenerationEngine(twin, decoder=ref_dec, num_slots=FLEET_SLOTS,
                               block_size=4, paged=True,
                               page_size=PAGE_SIZE, integrity=cfg)
    reqs = [eng.submit(p, g) for p, g in zip(prompts[:8], gens[:8])]
    eng.run_until_drained()
    ref = [r.result(timeout=0) for r in reqs]
    injs = [FaultInjector() for _ in range(FLEET_REPLICAS)]
    router = EngineFleetRouter(twin, num_replicas=FLEET_REPLICAS,
                               decoder=dec, integrity=cfg,
                               replica_injectors=injs, **FLEET_KW).start()
    try:
        round1 = router.canary_round()
        injs[1].corrupt("device.corrupt_page", mode="flip", at=1,
                        where="registered")
        router.submit(list(cfg.canary_prompt) + [1, 1], 2,
                      replica_id="r1").result(timeout=120)
        frs = [router.submit(p, g, replica_id="r1")
               for p, g in zip(prompts[:8], gens[:8])]
        round2 = router.canary_round()
        for fr in frs:
            fr.result(timeout=300)
        states = {rid: router.replica_state(rid)
                  for rid in router.replica_ids()}
        _fleet_audits(router, "corruption")
    finally:
        router.shutdown()
    migrated = _hold_fleet(frs, prompts[:8], gens[:8], ref, True,
                           "corruption")["migrated"]
    ledger = router.ledger.to_dict()
    log(f"corruption [{card}] (f32 twin): canary round 1 {round1}, after "
        f"the flip in r1's pool {round2}; states {states}; corrupt "
        f"quarantines {int(router.corrupt_quarantines)}; r1's streams "
        f"migrated {migrated} of 8, corrupted results served 0; ledger "
        f"{ledger}")
    if round2.get("r1") != "mismatch" or states.get("r1") != "CORRUPT" or \
            int(router.corrupt_quarantines) != 1 or ledger["duplicates"] or \
            any(v != "ok" for r, v in round2.items() if r != "r1"):
        raise AssertionError(f"corruption: round 2 {round2}, states "
                             f"{states}")


def _autoscale_round(card, net, dec, prompts, gens, ref, sinks):
    """A burst grows a 1-replica fleet to at most 3; the quiet after it
    retires the grown replicas through the drain. Prints the decisions."""
    router = EngineFleetRouter(net, num_replicas=1, decoder=dec,
                               max_pending=64, **sinks,
                               **FLEET_KW).start()
    scaler = BurnRateAutoscaler(
        router, min_replicas=1, max_replicas=FLEET_REPLICAS,
        saturation_high=1.5, saturation_low=0.5, scale_up_burn=1e9,
        scale_down_burn=1e9, up_consecutive=1, down_consecutive=4,
        cooldown_s=0.3, interval=0.05, drain_budget=20.0).start()
    try:
        frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
        grown = 1
        deadline = time.monotonic() + 300
        while not all(fr.done() for fr in frs) and \
                time.monotonic() < deadline:
            grown = max(grown, len(router.replica_ids()))
            time.sleep(0.02)
        deadline = time.monotonic() + 60
        while len(router.replica_ids()) > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        scaler.stop()
        final = router.replica_ids()
        _fleet_audits(router, "autoscale")
    finally:
        scaler.stop()
        router.shutdown()
    for fr in frs:
        fr.result(timeout=0)
    held = _hold_fleet(frs, prompts, gens, ref, False, "autoscale")
    ledger = router.ledger.to_dict()
    decisions = [(e["action"], e.get("replica"),
                  round(e["signals"]["utilization"], 3))
                 for e in scaler.history]
    log(f"autoscale [{card}]: decisions (action, replica, utilization) "
        f"{decisions}; grown to {grown}, back to {final}; descale moved "
        f"{held['migrated']}; identical to the direct paged engine "
        f"{held['identical']} of {len(frs)}; ledger {ledger}")
    if grown < 2 or final != ["r0"] or ledger["duplicates"] or \
            ledger["completed"] != len(frs):
        raise AssertionError(f"autoscale: grown {grown}, final {final}, "
                             f"ledger {ledger}")


def _scrape_telemetry(card, server):
    import urllib.request
    bodies = {}
    for ep in ("/metrics", "/snapshot", "/slo", "/profile",
               "/traces/recent", "/healthz"):
        with urllib.request.urlopen(server.url + ep, timeout=30) as r:
            if r.status != 200:
                raise AssertionError(f"telemetry {ep}: HTTP {r.status}")
            bodies[ep] = r.read().decode()
    metrics = bodies["/metrics"]
    want = ("fleet_migrations_total", "fleet_replicas",
            "fleet_kv_handoffs_total", "kv_transfer_bytes_total",
            "kv_transfer_seconds", "generation_engine_role")
    missing = [m for m in want if m not in metrics]
    healthz = json.loads(bodies["/healthz"])
    snap = json.loads(bodies["/snapshot"])
    log(f"telemetry [{card}]: {server.url} every endpoint 200 "
        f"({', '.join(f'{k} {len(v)} B' for k, v in bodies.items())}); "
        f"/healthz {healthz}; /snapshot sources "
        f"{sorted(snap.get('sources', {}))}")
    if missing or not healthz.get("ok") or \
            not {"fleet", "disagg"} <= set(snap.get("sources", {})):
        raise AssertionError(f"telemetry: /metrics lacks {missing}, "
                             f"/healthz {healthz}")


def phase_fleet(card, net):
    """Phase 4e: the in-process fleet on the flagship (module docstring).
    Returns the B1 launches of the fleet's and the disaggregated tier's
    admissions."""
    t_phase = time.perf_counter()
    prompts, gens = _fleet_requests()
    dec = TransformerDecoder(net, t_max=PAGED_T_MAX)
    check_paged_fresh_prefill(net, dec, prompts)
    ref = _direct_paged(net, dec, prompts, gens)
    reg, ring = MetricsRegistry(), TraceRing()
    sinks = {"registry": reg, "trace_store": ring,
             "slo_tracker": SLOTracker(registry=reg),
             "flight_recorder": FlightRecorder(registry=reg)}
    server = TelemetryServer(registry=reg, trace_store=ring,
                             slo_tracker=sinks["slo_tracker"],
                             flight_recorder=sinks["flight_recorder"],
                             host="127.0.0.1", port=0).start()
    try:
        # (a) a crash mid-stream: bf16, then the f32 twin
        b1 = _crash_fleet(card, net, dec, prompts, gens, ref, False,
                          "bf16 flagship", sinks)
        twin = _f32_twin(net)
        dec32 = TransformerDecoder(twin, t_max=PAGED_T_MAX)
        ref32 = _direct_paged(twin, dec32, prompts, gens)
        _crash_fleet(card, twin, dec32, prompts, gens, ref32, True,
                     "f32 twin", sinks)
        # (b) 1 against 3 replicas, alternating pairs (reported)
        scale = chaos_soak._fleet_scale_ab(
            FLEET_REPLICAS, net=net, prompts=prompts, gens=gens, pairs=2,
            warm=False, num_slots=FLEET_SLOTS, block_size=4, paged=True,
            page_size=PAGE_SIZE, t_max=PAGED_T_MAX)
        log(f"fleet [{card}]: aggregate generated tok/s, 1 replica "
            f"{scale['tok_s_1']} against {FLEET_REPLICAS} "
            f"{scale['tok_s_n']} (alternating pairs, 24 requests, "
            f"{FLEET_SLOTS} slots a replica): {scale['speedup']}x")
        # (c) the disaggregated tier, both transports, then a decode kill
        # in bf16 against the direct engine (reported), the wire against
        # the in-process handoff (held: the pages move bit-exactly), and
        # on the f32 twin against its direct engine (held)
        n, inproc = _disagg_round(card, net, dec, prompts, gens, ref, False,
                                  InProcessKVTransport(), sinks,
                                  "bf16, in process", server)
        b1 += n
        n, _ = _disagg_round(card, net, dec, prompts, gens, inproc, True,
                             SerializedKVTransport(per_page=True), sinks,
                             "bf16, page frames vs in process")
        b1 += n
        _disagg_round(card, twin, dec32, prompts, gens, ref32, True,
                      InProcessKVTransport(), sinks, "f32 twin, in process")
        _disagg_kill(card, net, dec, prompts, gens, ref, sinks)
        # (d) silent corruption, (e) autoscale
        _corruption_round(card, twin, prompts, gens)
        _autoscale_round(card, net, dec, prompts, gens, ref, sinks)
    finally:
        server.stop()
    wall = time.perf_counter() - t_phase
    log(f"fleet phase: {wall:.1f}s wall (limit {FLEET_PHASE_LIMIT_S} s)")
    if wall > FLEET_PHASE_LIMIT_S:
        raise AssertionError(f"the fleet phase took {wall:.1f}s")
    return b1


# ---------------------------------------------------------------- phase 4f
#: the remote workers' model dict: the flagship at full width, f32 weights
#: from its seed in every process
REMOTE_MODEL = {"vocab": 32000, "d_model": 768, "num_heads": 12,
                "num_layers": 12, "max_length": 577, "seed": 5}
REMOTE_ENGINE = {"num_slots": FLEET_SLOTS, "block_size": 4,
                 "page_size": PAGE_SIZE, "t_max": PAGED_T_MAX}
#: the first requests of phase 4e's set that the rounds serve
REMOTE_REQUESTS = 12
REMOTE_PHASE_LIMIT_S = 180
#: the card's free memory after the phase, against its start
REMOTE_MEM_SLACK = 1 << 30


def phase_remote(card, model=None, device=None):
    """Phase 4f: the process-per-replica fleet (module docstring).
    ``model`` / ``device`` let the phase be rehearsed on the CPU at a
    small width. Returns the workers' and the parent's B1 launches."""
    t_phase = time.perf_counter()
    model = dict(model or REMOTE_MODEL)
    on_card = device is None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
        held0 = torch.cuda.memory_reserved()
    prompts, gens = _fleet_requests()
    reqs = [{"id": f"req-{i:03d}", "prompt": [int(t) for t in p],
             "gen": int(g)} for i, (p, g) in
            enumerate(zip(prompts, gens))][:REMOTE_REQUESTS]
    # the A/B's endpoints boot beside the rounds, once the rounds' own
    # endpoints have booted, and wait for them idle
    ab_eps = chaos_soak.remote_scale_endpoints(
        model, REMOTE_ENGINE, workers=FLEET_REPLICAS, slow=0.0,
        hello_deadline=90.0, device=device)
    ab_pool = ThreadPoolExecutor(len(ab_eps))
    ab_boot = []

    def boot_ab():
        ab_boot.extend(ab_pool.submit(ep.start) for ep in ab_eps.values())

    try:
        t_soak = time.perf_counter()
        worker_b1, parent_b1 = _remote_rounds(card, model, device, on_card,
                                              reqs, boot_ab)
        # (b) 1 against 3 worker processes against 3 in-process replicas
        t_ab = time.perf_counter()
        for fut in ab_boot:
            fut.result()
        t_booted = time.perf_counter()
        ab = chaos_soak.run_remote_scale_ab(
            requests=reqs, model=model, engine=REMOTE_ENGINE, slow=0.0,
            workers=FLEET_REPLICAS, pairs=2, inprocess=True,
            hello_deadline=90.0, device=device, endpoints=ab_eps)
        log(f"remote timeline [{card}]: rounds {t_ab - t_soak:.1f} s, then "
            f"{t_booted - t_ab:.1f} s waiting for the A/B's boot, the A/B "
            f"{time.perf_counter() - t_booted:.1f} s")
    finally:
        for ep in ab_eps.values():
            ep.shutdown()
            shutil.rmtree(ep.workdir, ignore_errors=True)
        ab_pool.shutdown(wait=True)
    n = FLEET_REPLICAS
    log(f"remote A/B [{card}]: aggregate generated tok/s, unpaced, "
        f"{len(reqs)} requests, {REMOTE_ENGINE['num_slots']} slots a "
        f"replica, f32: 1 process {ab['tok_s_1p']}, {n} processes "
        f"{ab[f'tok_s_{n}p']} ({ab['scaling_x']}x), {n} in-process "
        f"replicas {ab[f'tok_s_{n}_inprocess']} (processes / in-process "
        f"{ab['process_vs_inprocess_x']}x); spawn to hello s "
        f"{ab['hello_s']}")
    left = sorted(chaos_soak.child_pids())
    if left:
        raise AssertionError(f"child processes left alive: {left}")
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free1 = torch.cuda.mem_get_info()[0]
        held1 = torch.cuda.memory_reserved()
        log(f"remote memory [{card}]: free {free0 / 2**30:.2f} GiB at the "
            f"phase's start, {free1 / 2**30:.2f} GiB after it (this "
            f"process's allocator holds {held0 / 2**30:.2f} and "
            f"{held1 / 2**30:.2f} GiB)")
        if free1 < free0 - REMOTE_MEM_SLACK:
            raise AssertionError(f"the card's free memory fell by "
                                 f"{(free0 - free1) / 2**30:.2f} GiB")
    wall = time.perf_counter() - t_phase
    log(f"remote phase: {wall:.1f}s wall (limit {REMOTE_PHASE_LIMIT_S} s)")
    if wall > REMOTE_PHASE_LIMIT_S:
        raise AssertionError(f"the remote phase took {wall:.1f}s")
    return worker_b1 + parent_b1


def _remote_rounds(card, model, device, on_card, reqs, boot_ab):
    """Phase 4f's rounds A-D and their bars (``boot_ab`` is called once the
    rounds' endpoints have booted). Returns the workers' and the parent's
    B1 launches."""
    reset_launches()
    soak = chaos_soak.run_remote_soak(
        seed=0, requests=reqs, model=model, engine=REMOTE_ENGINE, slow=0.0,
        round_wait_s=120.0, hello_deadline=90.0, device=device,
        after_boot=boot_ab)
    parent_b1 = read_launches()["shortseq_attention"]
    rows = {k: soak.get(f"round_{k}", {}) for k in "abcd"}
    workers = {f"{k}:{pid}": w for k, row in rows.items()
               for pid, w in (row.get("workers") or {}).items()}
    worker_b1 = sum(int(row.get("b1_launches", 0)) for row in rows.values())
    for k, row in rows.items():
        brief = {key: row.get(key) for key in (
            "completed", "lost", "failures", "mismatches", "ledger",
            "respawn_epoch", "results_at_kill", "wire",
            "shipped_wire_bytes", "transfer_exact", "held_at_pause",
            "zombie_fenced", "migrations", "orphans_reaped",
            "final_exit_code", "steady", "b1_launches", "error")
            if key in row}
        log(f"remote round {k.upper()} [{card}]: ok {row.get('ok')} "
            f"{json.dumps(brief, default=str)}")
    hello = sorted(round(w["hello_s"], 2) for w in workers.values()
                   if w.get("hello_s") is not None)
    names = sorted({str(w.get("device_name")) for w in workers.values()})
    stages = {}
    for w in workers.values():
        for k, v in (w.get("boot") or {}).items():
            stages.setdefault(k, []).append(v)
    boot = {k: round(float(np.median(v)), 2) for k, v in stages.items()}
    log(f"remote workers [{card}]: {len(workers)} incarnations reported, "
        f"{soak['workers_spawned']} spawned, devices {names}, spawn to "
        f"hello s {hello} (median seconds a stage, from the worker "
        f"module's start, and CPU seconds to the hello: {boot}), nvcc "
        f"runs {sorted({w.get('nvcc_runs') for w in workers.values()})}, "
        f"B1 launches {worker_b1} (+ {parent_b1} in the parent's "
        f"references, {soak['reference_s']:.1f} s), round s "
        f"{soak['round_s']} (A-C in turn, D beside them; endpoints "
        f"booted at s {soak['boot_s']}), leftover "
        f"{soak['leftover_pids']}")
    if not soak["ok"]:
        for name, tail in (soak.get("worker_logs") or {}).items():
            log(f"--- {name}:\n{tail}")
        raise AssertionError(f"remote rounds failed: "
                             f"{ {k: r.get('ok') for k, r in rows.items()} }")
    want = torch.cuda.get_device_name(0) if on_card else "cpu"
    if names != [want]:
        raise AssertionError(f"a worker served on {names}, not {want}")
    if any(w.get("nvcc_runs") for w in workers.values()):
        raise AssertionError("a worker ran nvcc: the parent built every "
                             "kernel before the workers started")
    if on_card and worker_b1 <= 0:
        raise AssertionError("the workers reported no B1 launch")
    return worker_b1, parent_b1


# ---------------------------------------------------------------- phase 4g
#: phase 4g's meshes (data, tp), every coordinate on the one card
MESH_SHAPES = [(2, 1), (1, 2), (2, 2), (1, 4)]
MESH_PHASE_LIMIT_S = 120
#: the fixed-seed sampled round: requests, new tokens, temperature
MESH_SAMPLED = (8, 32, 0.8)
#: the paged, speculative and bf16 rounds: requests, new tokens
MESH_ROUND = (8, 32)


def _mesh_of(shape, device):
    data, tp = shape
    return generation_mesh(data, tp, devices=[device] * (data * tp))


def _mesh_run(net, prompts, new_tokens, mesh, temps=None, seed=0,
              layers=12, **kw):
    """Serve ``prompts`` to the end on a fresh 8-slot, K = 4 engine over
    ``mesh`` (None: unsharded) after one warm request. Returns (outputs,
    wall s, counted B1 launches, predicted B1 launches, decode
    readbacks, decode blocks, the readback's mesh shards). The
    prediction: every admission's rows split over the data groups in
    contiguous runs, so a group runs when the admission's row bucket
    reaches it, and each group's tp shards run B1 once a layer."""
    fr = FlightRecorder()
    engine = SlotGenerationEngine(net, num_slots=8, block_size=4, mesh=mesh,
                                  seed=seed, flight_recorder=fr,
                                  registry=MetricsRegistry(), **kw)
    # the warm prompt shares no page with the counted ones, so a paged
    # engine's admissions stay fresh (whole prompts, through B1)
    engine.submit(np.ascontiguousarray(prompts[0][:64][::-1]), 4)
    engine.run_until_drained()
    n_adm = len(fr.events(kind="admission"))
    _sync()
    reset_launches()
    stats0 = engine.stats()
    fetched0 = fetch_counts("engine.decode")["engine.decode"]
    t0 = time.perf_counter()
    temps = temps or [0.0] * len(prompts)
    reqs = [engine.submit(p, new_tokens, temperature=t)
            for p, t in zip(prompts, temps)]
    engine.run_until_drained()
    _sync()
    wall = time.perf_counter() - t0
    b1 = read_launches()["shortseq_attention"]
    stats = _stats_delta(engine, stats0)
    fetched = fetch_counts("engine.decode")["engine.decode"] - fetched0
    shards = fetch_shards("engine.decode")["engine.decode"]
    data, tp = (1, 1) if mesh is None else \
        (mesh.shape["data"], mesh.shape["tp"])
    buckets = [ev["bucket"] for ev in fr.events(kind="admission")[n_adm:]]
    predicted = sum(min(b, data) for b in buckets) * tp * layers
    outs = []
    for p, r in zip(prompts, reqs):
        out = r.result(timeout=0)
        if len(out) != len(p) + new_tokens or not (out[:len(p)] == p).all():
            raise AssertionError(f"request returned {len(out)} tokens, "
                                 f"expected {len(p) + new_tokens}")
        outs.append(out)
    if fetched > stats["decode_blocks"] + stats["spec_blocks"]:
        raise AssertionError(f"{fetched} decode readbacks for "
                             f"{stats['decode_blocks']} blocks")
    if engine._pager is not None:
        _audit(engine, f"mesh {mesh_tag(mesh) or '1x1'}")
    return (outs, wall, b1, predicted, fetched,
            stats["decode_blocks"] + stats["spec_blocks"], shards, engine)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _same_tokens(got, want):
    return sum(bool(np.array_equal(a, b)) for a, b in zip(got, want))


def _pool_copies_equal(engine):
    """Every data group's copy of a paged engine's pool equal to group
    0's, the null page aside (duplicate redirected writes race there)."""
    for kv in engine._caches.values():
        for leaf in kv.values():
            data, tp = leaf.mesh.shape["data"], leaf.mesh.shape["tp"]
            for t in range(tp):
                first = leaf.local((0, t))[1:]
                for d in range(1, data):
                    if not torch.equal(leaf.local((d, t))[1:], first):
                        return False
    return True


def phase_mesh(card, device=None, model=None, prompts=None):
    """Phase 4g: the flagship served over (data, tp) meshes with every
    coordinate on the card (module docstring). ``device`` / ``model`` /
    ``prompts`` let the phase be rehearsed on the CPU at a small width.
    Returns the phase's B1 launches (kernel checks excluded)."""
    t_phase = time.perf_counter()
    on_card = device is None
    dev = torch.device(device or "cuda:0")
    model = dict(model or {"vocab": 32000, "d_model": 768, "num_heads": 12,
                           "num_layers": 12, "max_length": 577})
    layers, heads = model["num_layers"], model["num_heads"]
    if on_card:
        # B1 where the meshes run it: 8 admission rows at bucket 512 over
        # H / tp local heads
        lens = np.random.default_rng(11).integers(200, 513, 8)
        for tp in sorted({tp for _, tp in MESH_SHAPES if tp > 1}):
            check_kernel("shortseq_attention", 8, heads // tp, 512, 64,
                         lens, 12 + tp)
    conf = transformer_lm_conf(vocab_size=model["vocab"],
                               d_model=model["d_model"],
                               num_heads=heads, num_layers=layers,
                               max_length=model["max_length"])
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16,
                           device=dev).init()
    twin = _f32_twin(net)
    if prompts is None:
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, model["vocab"], int(n))
                   for n in rng.integers(200, 513, 16)]
    b1_total = 0
    # (1) the f32 twin (TF32 off): phase 4's requests, every mesh's greedy
    # tokens against the unsharded engine's
    ref, wall, b1, _, _, _, _, _ = _mesh_run(twin, prompts, 64, None,
                                              layers=layers)
    b1_total += b1
    gen = len(prompts) * 64
    rates = {"1x1": gen / wall}
    for shape in MESH_SHAPES:
        mesh = _mesh_of(shape, dev)
        tag = mesh_tag(mesh)
        outs, wall, b1, pred, fetched, blocks, shards, _ = _mesh_run(
            twin, prompts, 64, mesh, layers=layers)
        b1_total += b1
        rates[tag] = gen / wall
        same = _same_tokens(outs, ref)
        log(f"mesh {tag} f32: {same}/{len(prompts)} requests token-identical "
            f"to the unsharded engine; B1 launches {b1} (predicted {pred}); "
            f"decode readbacks {fetched} for {blocks} blocks, each "
            f"gathering {shards} shards")
        if same != len(prompts):
            raise AssertionError(f"mesh {tag}: f32 tokens differ from the "
                                 "unsharded engine's")
        if on_card and b1 != pred:
            raise AssertionError(f"mesh {tag}: {b1} B1 launches, predicted "
                                 f"{pred}")
        if shards != shape[0] * shape[1]:
            raise AssertionError(f"mesh {tag}: the readback gathered "
                                 f"{shards} shards")
    log(f"mesh f32 [{card}]: generated tok/s, 16 requests x 64 tokens, 8 "
        f"slots, K 4: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                    rates.items()) +
        " (every shard on this one card: the meshes measure the host's "
        "dispatch of data x tp shards, not scaling)")
    # fixed-seed sampled tokens: identical across the meshes
    n, new, temp = MESH_SAMPLED
    sampled = {}
    for shape in [None] + MESH_SHAPES:
        mesh = None if shape is None else _mesh_of(shape, dev)
        outs, _, b1, *_ = _mesh_run(twin, prompts[:n], new, mesh,
                                    temps=[temp] * n, seed=5, layers=layers)
        b1_total += b1
        sampled[mesh_tag(mesh) or "1x1"] = outs
    first = sampled[mesh_tag(_mesh_of(MESH_SHAPES[0], dev))]
    agree = {k: _same_tokens(v, first) for k, v in sampled.items()}
    log(f"mesh f32 sampled (T {temp}, seed 5, {n} requests x {new}): "
        f"requests identical to {MESH_SHAPES[0][0]}x{MESH_SHAPES[0][1]}'s "
        f"{agree}")
    if any(agree[mesh_tag(_mesh_of(s, dev))] != n for s in MESH_SHAPES):
        raise AssertionError("fixed-seed sampled tokens differ across the "
                             "meshes")
    # (2) paged and speculative on (2, 2), each against its unsharded run
    n, new = MESH_ROUND
    m22 = _mesh_of((2, 2), dev)
    for what, kw in (("paged", dict(paged=True, page_size=PAGE_SIZE,
                                    t_max=PAGED_T_MAX)),
                     ("speculative", dict(speculative=True, spec_k=4,
                                          spec_threshold=0.0))):
        want, _, b1a, *_ = _mesh_run(twin, prompts[:n], new, None,
                                     layers=layers, **kw)
        outs, wall, b1, pred, fetched, blocks, shards, eng = _mesh_run(
            twin, prompts[:n], new, m22, layers=layers, **kw)
        b1_total += b1a + b1
        same = _same_tokens(outs, want)
        copies = _pool_copies_equal(eng) if what == "paged" else None
        log(f"mesh 2x2 {what} f32: {same}/{n} token-identical to the "
            f"unsharded {what} engine; readbacks {fetched} for {blocks} "
            f"blocks ({shards} shards); B1 {b1} (predicted {pred})"
            + ("" if copies is None else
               f"; the data groups' pool copies equal: {copies}"))
        if same != n or copies is False or shards != 4:
            raise AssertionError(f"mesh 2x2 {what}: differs from the "
                                 "unsharded run")
        if on_card and b1 != pred:
            raise AssertionError(f"mesh 2x2 {what}: {b1} B1 launches, "
                                 f"predicted {pred}")
        if what == "speculative" and eng.stats()["spec_blocks"] == 0:
            raise AssertionError("no speculative block ran on the mesh")
    # (3) bf16 on (1, 2): first-prefill logits gated, tokens reported
    m12 = _mesh_of((1, 2), dev)
    tokens, lengths = _padded(prompts[:2], 512)
    reset_launches()
    logits = []
    for mesh in (m12, None):
        dec = TransformerDecoder(net, mesh=mesh)
        logits.append(dec.prefill(dec.init_cache(2), tokens, lengths)[1])
    b1_total += read_launches()["shortseq_attention"]
    rel = _rel_l2_rows(*logits)
    want_out, _, b1a, *_ = _mesh_run(net, prompts[:n], new, None,
                                     layers=layers)
    outs, wall, b1, *_ = _mesh_run(net, prompts[:n], new, m12,
                                   layers=layers)
    b1_total += b1a + b1
    log(f"mesh 1x2 bf16: first-prefill logits rel-L2 against the unsharded "
        f"bf16 decoder {rel:.3e} (tol {LOGIT_REL_TOL}); "
        f"{_same_tokens(outs, want_out)}/{n} requests token-identical "
        "(reported: bf16 tokens follow the reduction order)")
    if not (np.isfinite(rel) and rel <= LOGIT_REL_TOL):
        raise AssertionError("mesh 1x2 bf16 logits disagree")
    # (4) the routes on (2, 1), 2 requests each, against (1)'s tokens
    m21 = _mesh_of((2, 1), dev)
    reset_launches()
    broker = create_broker("memory://")
    out_sub = NDArraySubscriber(broker, "dl4j-gen-output")
    route = GenerationServingRoute(twin, broker, max_new_tokens=16,
                                   num_slots=2, block_size=4, mesh=m21,
                                   registry=MetricsRegistry()).start()
    try:
        pub = NDArrayPublisher(broker, "dl4j-gen-input")
        for p in prompts[2:4]:
            pub.publish(np.asarray(p, np.int32))
        routed = [np.asarray(out_sub.poll(timeout=120), np.int64)
                  for _ in range(2)]
    finally:
        route.stop()
        out_sub.close()
    pi = ParallelInference(twin, generation_slots=2, generation_block_size=4,
                           generation_mesh=m21,
                           generation_registry=MetricsRegistry())
    try:
        facade = [pi.generate(p, 16, timeout=120) for p in prompts[4:6]]
        engine_mesh = pi._gen_engine.mesh
    finally:
        pi.shutdown()
    b1_total += read_launches()["shortseq_attention"]
    want = [r[:len(p) + 16] for p, r in zip(prompts[2:6], ref[2:6])]
    same = _same_tokens(routed + facade, want)
    log(f"mesh 2x1 routes: GenerationServingRoute and ParallelInference "
        f"answered {same}/4 requests token-identical to (1)'s")
    if same != 4 or engine_mesh is not m21:
        raise AssertionError("a route on the mesh disagrees")
    wall = time.perf_counter() - t_phase
    log(f"mesh phase: {wall:.1f}s wall (limit {MESH_PHASE_LIMIT_S} s), B1 "
        f"launches {b1_total}")
    if wall > MESH_PHASE_LIMIT_S:
        raise AssertionError(f"the mesh phase took {wall:.1f}s")
    return b1_total


def phase_long_prompt():
    conf = transformer_lm_conf(vocab_size=32000, d_model=768, num_heads=12,
                               num_layers=2, max_length=2048)
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 32000, 1536) for _ in range(4)]
    dec = TransformerDecoder(net)
    reset_launches()
    outs = dec.generate(prompts, 16, block_size=4)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"long prompt: 4 x 1536 tokens, 16 new, K=4; kernel launches "
        f"{launches}")
    if any(len(o) != 1536 + 16 for o in outs):
        raise AssertionError("long-prompt generate returned wrong lengths")
    if launches["flash_forward"] < 2:
        raise AssertionError("the flash kernel did not launch on the "
                             "long-prompt prefill")
    check_logits(net, prompts[:1], 2048, "long-prompt 2-layer")
    return launches["flash_forward"]


# ----------------------------------------------------------------- phase 6
def check_train_twin(net, ds):
    """First-step loss and gradients of the card's bf16 kernel path
    against the same weights in f32 on the CPU (plain path)."""
    got_g, got_l = net.compute_gradient_and_score(ds)
    want_g, want_l = _cpu_twin(net).compute_gradient_and_score(ds)
    rel_l = abs(got_l - want_l) / abs(want_l)
    errs = {f"{v}.{k}": _rel_l2(got_g[v][k].cpu(), want_g[v][k])
            for v, k in (("embed", "W"), ("attn0", "Wq"), ("ffn11", "W2"),
                         ("out", "W"))}
    log(f"flagship train: first-step loss card bf16 {got_l:.6f} vs CPU f32 "
        f"{want_l:.6f} (rel {rel_l:.3e}, tol {TRAIN_LOSS_TOL}); gradient "
        f"rel-L2 {', '.join(f'{k} {e:.3e}' for k, e in errs.items())} "
        f"(tol {TRAIN_GRAD_TOL})")
    if not (rel_l <= TRAIN_LOSS_TOL and
            all(e <= TRAIN_GRAD_TOL for e in errs.values())):
        raise AssertionError("card training disagrees with the CPU f32 "
                             "reference")


def train_steps(net, ds, steps, step=None):
    """``steps`` train steps (``fit_batch``, or ``step``) with the launch
    counts zeroed just before; returns (losses as floats, wall seconds,
    launches)."""
    step = step or net.fit_batch
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        step(ds)
        losses.append(net.score_value)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    return [float(x) for x in losses], wall, launches


def _step_floor_ms(conf, b, t):
    """Data-sheet floor of one bf16 train step: 6 FLOP per matmul weight
    per token, plus attention's 4 * D (forward) + 10 * D (backward) per
    causal pair, at 989 TF/s."""
    d_model = conf.vertices["embed"].layer.n_out
    vocab = conf.vertices["out"].layer.n_out
    layers = sum(1 for n in conf.vertices if n.startswith("attn"))
    heads = conf.vertices["attn0"].layer.num_heads
    ff = conf.vertices["ffn0"].layer.hidden_mult
    weights = layers * (4 + 2 * ff) * d_model ** 2 + d_model * vocab
    pairs = b * heads * t * (t + 1) // 2
    flops = 6 * weights * b * t + layers * 14 * (d_model // heads) * pairs
    return flops / BF16_FLOPS * 1e3, flops


def phase_train_flagship(card):
    conf = transformer_lm_conf(vocab_size=32000, d_model=768, num_heads=12,
                               num_layers=12, max_length=512,
                               learning_rate=3e-4)
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    b, t, n_layers = 32, 512, 12
    x, y = lm_batch_sparse(np.random.default_rng(13).integers(
        0, 32000, (b, t + 1)))
    ds = DataSet(x, y)
    check_train_twin(net, DataSet(x[:2], y[:2]))
    torch.cuda.reset_peak_memory_stats()
    warm, _, _ = train_steps(net, ds, 2)
    losses, wall, launches = train_steps(net, ds, 8)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = wall / 8 * 1e3
    floor_ms, flops = _step_floor_ms(conf, b, t)
    log(f"flagship train: losses {[round(x, 4) for x in warm + losses]}; "
        f"kernel launches in 8 steps {launches}")
    for name in ("shortseq_attention", "shortseq_attention_bwd"):
        if launches[name] != n_layers * 8:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in 8 steps, expected {n_layers * 8}")
    if not (np.isfinite(warm + losses).all() and losses[-1] < warm[0]):
        raise AssertionError("flagship training loss is not finite and "
                             "falling")
    log(f"flagship train [{card}]: {8 * b * t / wall:.1f} train tok/s, "
        f"{step_ms:.2f} ms per step (B {b}, T {t}), data-sheet floor "
        f"{floor_ms:.2f} ms ({flops:.3e} FLOP) = {floor_ms / step_ms:.3f} "
        f"of the step; peak memory {peak_gb:.2f} GB")
    profile_step(lambda: net.fit_batch(ds))
    return launches


def _kernel_us(event) -> float:
    """An averaged profiler event's device time if it is a kernel (CPU-side
    ops, whose device time repeats their kernels', give 0; the attribute's
    name differs across torch versions)."""
    if getattr(event, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_step(step, what="step"):
    """One more ``step()`` under torch.profiler: device time by kernel name
    and the device's busy share of the step's wall time. Returns (kernel
    rows (name, device us, launches), busy us, wall us, launches of every
    profiled event by name)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    counts = {e.key: e.count for e in events}
    rows = [(e.key, _kernel_us(e), e.count) for e in events]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    log(f"profiled {what}: wall {wall_us / 1e3:.2f} ms, kernels "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.3f} of wall: the device's "
        f"busy share, one stream), {sum(r[2] for r in rows)} launches")
    for key, us, count in rows[:15]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    return rows, busy, wall_us, counts


# ----------------------------------------------------------------- phase 7
def phase_train_long(card):
    conf = transformer_lm_conf(vocab_size=32000, d_model=768, num_heads=12,
                               num_layers=2, max_length=2048,
                               learning_rate=3e-4)
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    b, t, n_layers, steps = 4, 2048, 2, 3
    x, y = lm_batch_sparse(np.random.default_rng(17).integers(
        0, 32000, (b, t + 1)))
    losses, wall, launches = train_steps(net, DataSet(x, y), steps)
    log(f"long-context train: losses {[round(x, 4) for x in losses]}; "
        f"kernel launches in {steps} steps {launches}")
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        if launches[name] != n_layers * steps:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {steps} steps, expected "
                                 f"{n_layers * steps}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("long-context training loss is not finite "
                             "and falling")
    log(f"long-context train [{card}]: {steps * b * t / wall:.1f} train "
        f"tok/s, {wall / steps * 1e3:.2f} ms per step (B {b}, T {t}, 2 "
        f"layers; first step included)")
    return launches


# ----------------------------------------------------------- phases 8-10
def _motif_batch(b, t, vocab, seed):
    """One-hot (chars, next chars) [B, T, vocab] of seeded rows that each
    repeat a random motif of 5-16 characters: text a char-RNN can learn."""
    rng = np.random.default_rng(seed)
    toks = np.stack([np.resize(rng.integers(0, vocab, rng.integers(5, 17)),
                               t + 1) for _ in range(b)])
    eye = np.eye(vocab, dtype=np.float32)
    return eye[toks[:, :-1]], eye[toks[:, 1:]]


def _cpu_twin_mln(net):
    """The same configuration and weights on the CPU in f32 (plain path)."""
    return network_from_numpy(net.conf, [{k: a.cpu().numpy()
                                          for k, a in p.items()}
                                         for p in net.params], device="cpu")


def check_charrnn_twin(net, ds):
    """First-step loss and gradients of the card's bf16 kernel path against
    the same weights in f32 on the CPU (plain path)."""
    got_g, got_l = net.compute_gradient_and_score(ds)
    want_g, want_l = _cpu_twin_mln(net).compute_gradient_and_score(ds)
    rel_l = abs(got_l - want_l) / abs(want_l)
    errs = {f"{i}.{k}": _rel_l2(got_g[i][k].cpu(), want_g[i][k])
            for i, k in ((0, "W"), (0, "R"), (1, "R"), (2, "W"))}
    log(f"char-RNN train: first-step loss card bf16 {got_l:.6f} vs CPU f32 "
        f"{want_l:.6f} (rel {rel_l:.3e}, tol {TRAIN_LOSS_TOL}); gradient "
        f"rel-L2 {', '.join(f'{k} {e:.3e}' for k, e in errs.items())} "
        f"(tol {TRAIN_GRAD_TOL})")
    if not (rel_l <= TRAIN_LOSS_TOL and
            all(e <= TRAIN_GRAD_TOL for e in errs.values())):
        raise AssertionError("card char-RNN training disagrees with the CPU "
                             "f32 reference")


def _charrnn_conf(tbptt_length):
    return char_rnn_conf(vocab_size=80, hidden=512, layers=2,
                         learning_rate=CHARRNN_LR, tbptt_length=tbptt_length)


def phase_charrnn_train(card):
    """bench.py's char-RNN (2 x 512 GravesLSTM, vocab 80, B 64, T 128,
    bf16, rmsprop, l2 1e-3) through MultiLayerNetwork._fit_batch."""
    b, t, layers = 64, 128, 2
    net = MultiLayerNetwork(_charrnn_conf(0),
                            compute_dtype=torch.bfloat16).init()
    x, y = _motif_batch(b, t, 80, 19)
    check_charrnn_twin(net, DataSet(x[:2], y[:2]))
    ds = DataSet(torch.from_numpy(x).cuda().bfloat16(),
                 torch.from_numpy(y).cuda().bfloat16())
    torch.cuda.reset_peak_memory_stats()
    warm, _, _ = train_steps(net, ds, 2, net._fit_batch)
    losses, wall, launches = train_steps(net, ds, 8, net._fit_batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"char-RNN train: losses {[round(v, 4) for v in warm + losses]}; "
        f"kernel launches in 8 steps {launches}")
    routes = lstm_routes()
    log(f"char-RNN train: LSTM launches by route {routes}")
    if launches["lstm_recurrence"] != layers * 8 or \
            routes["cluster"] != layers * 8:
        raise AssertionError(f"lstm_recurrence launched {routes} times in 8 "
                             f"steps, expected {layers * 8} on the cluster "
                             "route")
    if not (np.isfinite(warm + losses).all() and losses[-1] < warm[0]):
        raise AssertionError("char-RNN training loss is not finite and "
                             "falling")
    step_ms = wall / 8 * 1e3
    log(f"char-RNN train [{card}]: {8 * b * t / wall:.1f} train chars/s, "
        f"{step_ms:.2f} ms per step (B {b}, T {t}, 2 x 512, bf16); peak "
        f"memory {peak_gb:.2f} GB")
    profile_step(lambda: net._fit_batch(ds))
    return net, ds, launches


def phase_charrnn_tbptt(card, ds):
    """fit() with the example's 50-step window over the T 128 batch: three
    windows, one update each, the (h, c) carry handed across."""
    layers, windows = 2, 3
    net = MultiLayerNetwork(_charrnn_conf(50),
                            compute_dtype=torch.bfloat16).init()
    carries = []
    step = net._train_step

    def recording_step(*args):
        carries.append(args[4])
        return step(*args)
    net._train_step = recording_step
    losses, wall, launches = train_steps(net, ds, 1, net.fit)
    del net._train_step
    log(f"char-RNN TBPTT: {net.iteration} updates from one batch (window "
        f"50 over T 128), score {losses[0]:.4f}; kernel launches "
        f"{launches}")
    routes = lstm_routes()
    log(f"char-RNN TBPTT: LSTM launches by route {routes}")
    if net.iteration != windows or \
            launches["lstm_recurrence"] != layers * windows or \
            routes["cluster"] != layers * windows:
        raise AssertionError("TBPTT did not run 3 windows of 2 launches on "
                             "the cluster route")
    handed = [sorted(k for c in carry for k in c) for carry in carries]
    if handed[0] or any(h != ["c", "c", "h", "h"] for h in handed[1:]) or \
            any(c[i]["h"].shape != (64, 512) for c in carries[1:]
                for i in range(layers)):
        raise AssertionError(f"the (h, c) carry did not cross windows: "
                             f"{handed}")
    log(f"char-RNN TBPTT [{card}]: {wall / windows * 1e3:.2f} ms per window "
        f"(B 64, T 50 / 50 / 28), carry handed to windows 2 and 3")
    return launches


def phase_charrnn_sample(card, net):
    """CharacterIterator.sample of 100 characters through rnn_time_step:
    2 launches and one readback per character, probabilities as on the
    CPU twin."""
    chars = "".join(chr(32 + i) for i in range(80))
    it = CharacterIterator(chars * 2, seq_length=16, batch_size=1)
    twin = _cpu_twin_mln(net)
    net.rnn_clear_previous_state()
    err = 0.0
    for c in chars[:10]:
        x = np.zeros((1, 80), np.float32)
        x[0, it.char_to_idx[c]] = 1.0
        err = max(err, float(np.abs(net.rnn_time_step(x) -
                                    twin.rnn_time_step(x)).max()))
    log(f"sampling: next-char probabilities card vs CPU f32 over 10 steps "
        f"max-abs {err:.3e} (tol {SAMPLE_PROB_TOL})")
    if not err <= SAMPLE_PROB_TOL:
        raise AssertionError("card sampling probabilities disagree with the "
                             "CPU reference")
    torch.cuda.synchronize()
    reset_launches()
    fetched0 = fetch_counts("rnn_time_step")["rnn_time_step"]
    t0 = time.perf_counter()
    text = it.sample(net, chars[33], 100, rng_seed=3)
    wall = time.perf_counter() - t0
    launches = read_launches()
    fetched = fetch_counts("rnn_time_step")["rnn_time_step"] - fetched0
    log(f"sampling: {text!r}; kernel launches {launches}, readbacks "
        f"{fetched}")
    if len(text) != 101 or set(text) - set(chars):
        raise AssertionError("sample returned a malformed string")
    routes = lstm_routes()
    if launches["lstm_recurrence"] != 2 * 100 or fetched != 100 or \
            routes["cooperative"] != 2 * 100:
        raise AssertionError(f"sampling did not launch the LSTM kernel "
                             f"twice (cooperative route, f32) and read back "
                             f"once per character: {routes}")
    log(f"sampling [{card}]: {wall / 100 * 1e3:.3f} ms per character "
        f"(rnn_time_step, N 1, f32 masters)")
    return launches


# ------------------------------------------------------------ phase 10b
#: the graph char-RNN's evaluation against its CPU f32 twin over the same
#: batches: the accuracy and the average AUC (absolute; bf16 rounding ties
#: and reorders near-equal probabilities, which moves the AUC, a rank
#: statistic, by a few 1e-4); the output probabilities the evaluation
#: reads back are held at LOGIT_REL_TOL (_output_err)
EVAL_ACC_TOL = 1e-3
EVAL_AUC_TOL = 2e-3
GRAPH_RNN_EVAL_BATCHES = 4
GRAPH_RNN_SAMPLE = 200


def _charrnn_graph_conf(tbptt_length=50, vocab=80, hidden=512, layers=2):
    """bench.py's char-RNN (char_rnn_conf's settings) as a
    ComputationGraph: GravesLSTM x 2 -> softmax RnnOutputLayer, rmsprop,
    l2 1e-3, truncated BPTT."""
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
    g = (NeuralNetConfiguration.Builder().seed(12345)
         .learning_rate(CHARRNN_LR).updater("rmsprop").rms_decay(0.95)
         .weight_init("xavier").regularization(True).l2(0.001)
         .graph_builder().add_inputs("in"))
    prev = "in"
    for i in range(layers):
        g.add_layer(f"lstm{i}", GravesLSTM(n_out=hidden, activation="tanh"),
                    prev)
        prev = f"lstm{i}"
    g.add_layer("out", RnnOutputLayer(n_out=vocab, loss="mcxent",
                                      activation="softmax"), prev)
    return (g.set_outputs("out").set_input_types(InputType.recurrent(vocab))
            .backprop_type("truncated_bptt").tbptt_fwd_length(tbptt_length)
            .tbptt_back_length(tbptt_length).build())


def check_graph_rnn_twin(net, ds):
    """The first TBPTT window's loss and gradients of the card's bf16
    graph against the same weights in f32 on the CPU."""
    got_g, got_l = net.compute_gradient_and_score(ds)
    want_g, want_l = _cpu_twin(net).compute_gradient_and_score(ds)
    rel_l = abs(got_l - want_l) / abs(want_l)
    errs = {f"{v}.{k}": _rel_l2(got_g[v][k].cpu(), want_g[v][k])
            for v, k in (("lstm0", "W"), ("lstm0", "R"), ("lstm1", "R"),
                         ("out", "W"))}
    log(f"graph char-RNN: first-window loss card bf16 {got_l:.6f} vs CPU "
        f"f32 {want_l:.6f} (rel {rel_l:.3e}, tol {TRAIN_LOSS_TOL}); "
        f"gradient rel-L2 "
        f"{', '.join(f'{k} {e:.3e}' for k, e in errs.items())} (tol "
        f"{TRAIN_GRAD_TOL})")
    if not (rel_l <= TRAIN_LOSS_TOL and
            all(e <= TRAIN_GRAD_TOL for e in errs.values())):
        raise AssertionError("card graph char-RNN disagrees with the CPU "
                             "f32 reference")


def _eval_readbacks(fn, tag):
    """(fn(), readbacks under ``tag`` during it)."""
    before = fetch_counts(tag)[tag]
    out = fn()
    return out, fetch_counts(tag)[tag] - before


class _Recorded:
    """An evaluation for ``do_evaluation`` that keeps the output it is
    handed (the host array read back, one a batch) and passes it on to
    ``inner``."""

    def __init__(self, inner):
        self.inner, self.outputs = inner, []

    def eval(self, labels, output, mask=None):
        self.outputs.append(np.asarray(output, np.float32))
        self.inner.eval(labels, output, mask=mask)


def _recorded_eval(net, data):
    """The classification evaluation of ``net``'s first output over
    ``data`` through do_evaluation, with the outputs it read back."""
    name = net.conf.network_outputs[0]
    return net.do_evaluation(data, {name: _Recorded(Evaluation())})[name]


def _output_err(got, want):
    """rel-L2 of two lists of output probabilities (classes last), taken
    on the log-probabilities less their mean over the classes: the logits
    up to a constant a row, so a near-uniform output still shows how it
    differs."""
    def centered(outs):
        lp = np.log(np.maximum(np.concatenate(
            [o.reshape(-1, o.shape[-1]) for o in outs]).astype(np.float64),
            1e-30))
        return torch.from_numpy(lp - lp.mean(-1, keepdims=True))
    return _rel_l2(centered(got), centered(want))


def phase_graph_rnn(card):
    """bench.py's char-RNN built as a ComputationGraph (2 x 512 GravesLSTM,
    vocab 80, B 64, T 128, bf16, rmsprop, l2 1e-3): fit_batch with
    truncated BPTT (window 50: 3 windows, 2 x 3 B6 launches a step),
    evaluate and evaluate_roc_multi_class (one readback a batch), and 200
    sampled characters through rnn_time_step (one B6 launch a layer a
    character), each held against the CPU f32 twin."""
    t0 = time.perf_counter()
    b, t, vocab, layers, windows = 64, 128, 80, 2, 3
    net = ComputationGraph(_charrnn_graph_conf(),
                           compute_dtype=torch.bfloat16).init()
    x, y = _motif_batch(b, t, vocab, 23)
    check_graph_rnn_twin(net, DataSet(x[:2, :50], y[:2, :50]))
    ds = DataSet(torch.from_numpy(x).cuda().bfloat16(),
                 torch.from_numpy(y).cuda().bfloat16())
    warm, _, _ = train_steps(net, ds, 1)
    losses, wall, launches = train_steps(net, ds, 4)
    routes = lstm_routes()
    log(f"graph char-RNN TBPTT: losses {[round(v, 4) for v in warm + losses]}"
        f" (the last window's of each step), {net.iteration} updates; "
        f"kernel launches in 4 steps {launches}, LSTM routes {routes}")
    if net.iteration != 5 * windows or \
            launches["lstm_recurrence"] != 4 * layers * windows:
        raise AssertionError(f"graph TBPTT ran {net.iteration} updates and "
                             f"{launches['lstm_recurrence']} B6 launches, "
                             f"expected {5 * windows} and "
                             f"{4 * layers * windows}")
    if not np.isfinite(warm + losses).all():
        raise AssertionError("graph char-RNN loss is not finite")
    log(f"graph char-RNN TBPTT [{card}]: {wall / 4 * 1e3:.2f} ms per step "
        f"(3 windows, B {b}, T {t})")
    # evaluation: bf16 on the card against the CPU f32 twin
    batches = [DataSet(*_motif_batch(b, t, vocab, 60 + i))
               for i in range(GRAPH_RNN_EVAL_BATCHES)]
    twin = _cpu_twin(net)
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    ev, reads = _eval_readbacks(lambda: net.evaluate(batches), "graph.eval")
    roc, roc_reads = _eval_readbacks(
        lambda: net.evaluate_roc_multi_class(batches), "graph.eval")
    eval_s = time.perf_counter() - t1
    eval_launches = read_launches()["lstm_recurrence"]
    # the probabilities the evaluation reads back, against the twin's
    rec, want = _recorded_eval(net, batches), _recorded_eval(twin, batches)
    want_roc = twin.evaluate_roc_multi_class(batches)
    prob_err = _output_err(rec.outputs, want.outputs)
    auc, want_auc = roc.calculate_average_auc(), \
        want_roc.calculate_average_auc()
    n = GRAPH_RNN_EVAL_BATCHES
    log(f"graph char-RNN evaluate: accuracy card {ev.accuracy():.6f} vs CPU "
        f"f32 {want.inner.accuracy():.6f} (tol {EVAL_ACC_TOL}), {ev.total} "
        f"predictions, readbacks {reads} + {roc_reads} for {n} + {n} "
        f"batches, B6 launches {eval_launches}; read-back probabilities "
        f"(centered log) rel-L2 {prob_err:.3e} (tol {LOGIT_REL_TOL}); "
        f"average AUC card {auc:.6f} vs CPU {want_auc:.6f} (tol "
        f"{EVAL_AUC_TOL}); {eval_s:.2f}s")
    if reads != n or roc_reads != n or ev.total != n * b * t or \
            eval_launches != 2 * layers * n:
        raise AssertionError("graph evaluation did not read back once a "
                             "batch or launch B6 once a layer a batch")
    if not (abs(ev.accuracy() - want.inner.accuracy()) <= EVAL_ACC_TOL and
            prob_err <= LOGIT_REL_TOL and
            abs(auc - want_auc) <= EVAL_AUC_TOL and
            np.array_equal(rec.inner.confusion, ev.confusion)):
        raise AssertionError("card graph evaluation disagrees with the CPU "
                             "f32 twin")
    # rnn_time_step: the card's steps against the twin's full sequence
    probe = x[:2, :16]
    net.rnn_clear_previous_state()
    steps = np.stack([net.rnn_time_step(probe[:, i])[0] for i in range(16)],
                     1)
    full = twin.output(probe)[0]
    err = float(np.abs(steps - full).max())
    log(f"graph rnn_time_step: 16 single steps on the card vs the CPU f32 "
        f"twin's full-sequence output max-abs {err:.3e} (tol "
        f"{SAMPLE_PROB_TOL})")
    if not err <= SAMPLE_PROB_TOL:
        raise AssertionError("card rnn_time_step disagrees with the full "
                             "forward")
    # sampling 200 characters: one B6 launch a layer a character
    rng = np.random.default_rng(5)
    net.rnn_clear_previous_state()
    xs = np.zeros((1, vocab), np.float32)
    xs[0, 0] = 1.0
    torch.cuda.synchronize()
    reset_launches()
    fetched0 = fetch_counts("graph.rnn_time_step")["graph.rnn_time_step"]
    t2 = time.perf_counter()
    text = [0]
    for _ in range(GRAPH_RNN_SAMPLE):
        probs = net.rnn_time_step(xs)[0][0].astype(np.float64)
        nxt = int(rng.choice(vocab, p=probs / probs.sum()))
        text.append(nxt)
        xs = np.zeros((1, vocab), np.float32)
        xs[0, nxt] = 1.0
    sample_s = time.perf_counter() - t2
    sl = read_launches()["lstm_recurrence"]
    fetched = fetch_counts("graph.rnn_time_step")["graph.rnn_time_step"] - \
        fetched0
    log(f"graph sampling: {GRAPH_RNN_SAMPLE} characters, B6 launches {sl}, "
        f"readbacks {fetched}, LSTM routes {lstm_routes()}; "
        f"{sample_s / GRAPH_RNN_SAMPLE * 1e3:.3f} ms per character [{card}]")
    if sl != layers * GRAPH_RNN_SAMPLE or fetched != GRAPH_RNN_SAMPLE:
        raise AssertionError("graph sampling did not launch B6 once a layer "
                             "a character with one readback")
    log(f"phase graph_rnn: {time.perf_counter() - t0:.1f}s wall")
    return launches


# ------------------------------------------------------------ phase 12b
def _lenet_bn_conf(learning_rate=0.02):
    """LeNet with a batch norm after each conv (C = 20 and 50, the
    general route's widths in bf16), from the existing builders."""
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer,
                                                         SubsamplingLayer)
    b = (NeuralNetConfiguration.Builder().seed(123)
         .learning_rate(learning_rate).updater("nesterovs").momentum(0.9)
         .weight_init("xavier").regularization(True).l2(5e-4).list())
    for c in (20, 50):
        b.layer(ConvolutionLayer(n_out=c, kernel_size=[5, 5], stride=[1, 1],
                                 activation="identity"))
        b.layer(BatchNormalization(activation="relu"))
        b.layer(SubsamplingLayer(kernel_size=[2, 2], stride=[2, 2],
                                 pooling_type="max"))
    b.layer(DenseLayer(n_out=500, activation="relu"))
    b.layer(OutputLayer(n_out=10, loss="mcxent", activation="softmax"))
    return b.set_input_type(InputType.convolutional(28, 28, 1)).build()


def _mnist_batches(n, seed, b=128):
    g = np.random.default_rng(seed)
    return [DataSet(g.random((b, 28, 28, 1), np.float32),
                    np.eye(10, dtype=np.float32)[g.integers(0, 10, b)])
            for _ in range(n)]


def _bn_routes():
    return {k: dict(f.routes) for k, f in (("fwd", bnk.bn_train_fwd),
                                            ("bwd", bnk.bn_train_bwd))}


def check_lenet_bn(card, dtype):
    """The BN LeNet in ``dtype``: 4 fit steps with every BN on its kernel
    (the general route at C 20 and 50 in bf16; C 20 is fused in f32), the
    first step's loss against the CPU f32 twin, and (f32) its gradients
    and the running statistics after the 4 steps."""
    net = MultiLayerNetwork(_lenet_bn_conf(), compute_dtype=dtype).init()
    batches = _mnist_batches(4, 43)
    twin = _cpu_twin_mln(net)
    got_g, got_l = net.compute_gradient_and_score(batches[0])
    want_g, want_l = twin.compute_gradient_and_score(batches[0])
    rel_l = abs(got_l - want_l) / abs(want_l)
    errs = {f"{i}.{k}": _rel_l2(got_g[i][k].cpu(), want_g[i][k])
            for i, k in ((0, "W"), (1, "gamma"), (3, "W"), (4, "gamma"),
                         (7, "W"))}
    for f in (bnk.bn_train_fwd, bnk.bn_train_bwd):
        f.routes = dict.fromkeys(bnk.ROUTES, 0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    net.fit(batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    twin.fit(batches)
    state_err = max(_rel_l2(net.state[i][k].cpu(), twin.state[i][k])
                    for i in (1, 4) for k in ("mean", "var"))
    what = str(dtype)[6:]
    log(f"lenet-bn {what}: first-step loss card {got_l:.6f} vs CPU f32 "
        f"{want_l:.6f} (rel {rel_l:.3e}); gradient rel-L2 "
        f"{', '.join(f'{k} {e:.3e}' for k, e in errs.items())}; running "
        f"statistics after 4 steps rel-L2 {state_err:.3e}; BN launches "
        f"{launches['batchnorm_train']} + {launches['batchnorm_train.bwd']} "
        f"by route {_bn_routes()}; {wall / 4 * 1e3:.2f} ms a step [{card}]")
    if launches["batchnorm_train"] != 8 or \
            launches["batchnorm_train.bwd"] != 8:
        raise AssertionError("the BN LeNet did not run each BN on its kernel "
                             "once a direction a step")
    if not rel_l <= TRAIN_LOSS_TOL or not np.isfinite(float(net.score_value)):
        raise AssertionError("the BN LeNet's loss disagrees with its CPU "
                             "twin")
    if dtype == torch.float32 and not (
            all(e <= TRAIN_GRAD_TOL for e in errs.values()) and
            state_err <= RESNET_STATE_TOL):
        raise AssertionError("the f32 BN LeNet's gradients or running "
                             "statistics disagree with its CPU twin")
    return launches


def phase_evaluate(card):
    """evaluate of ResNet-50 (B 128, bf16, 4 synthetic batches, inference
    BN), its read-back probabilities on 4 images held against its CPU f32
    twin; evaluate and score_examples of LeNet (f32, B 128) against its
    CPU f32 twin; the BN LeNet trained 4 steps in bf16 and f32. One
    readback a batch."""
    t0 = time.perf_counter()
    r50 = ComputationGraph(resnet50_conf(1000, 224, 224, 3),
                           compute_dtype=torch.bfloat16).init()
    batches = []
    for i in range(4):
        x, y = _images(128, 224, 3, 1000, 70 + i)
        batches.append(DataSet(x, y.cpu().numpy()))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev, reads = _eval_readbacks(lambda: r50.evaluate(batches), "graph.eval")
    r50_s = time.perf_counter() - t1
    # the first 4 images against the twin: the probabilities read back
    # (one-hot at initialization: inference BN on the initial running
    # statistics lets the activations grow through 50 layers) and the
    # logits of the same inference forward
    rec = _recorded_eval(r50, batches)
    x4, twin = batches[0].features[:4], _cpu_twin(r50)
    want = _recorded_eval(twin, DataSet(x4.cpu(), batches[0].labels[:4]))
    got4 = rec.outputs[0][:4]
    prob_err = _output_err([got4], want.outputs)
    logit_err = _rel_l2(_logits(r50, x4), _logits(twin, x4.cpu()))
    log(f"resnet50 evaluate (B 128 x 4, bf16, inference BN): accuracy "
        f"{ev.accuracy():.6f} over {ev.total} images, readbacks {reads}, "
        f"{r50_s:.2f}s ({4 * 128 / r50_s:.1f} images/s) [{card}]; 4 images "
        f"vs the CPU f32 twin: read-back probabilities (centered log, "
        f"largest {np.round(got4.max(-1), 6).tolist()}) rel-L2 "
        f"{prob_err:.3e}, logits rel-L2 {logit_err:.3e} (tol "
        f"{RESNET_LOGIT_TOL})")
    if reads != 4 or ev.total != sum(d.num_examples() for d in batches) \
            or not np.array_equal(rec.inner.confusion, ev.confusion) \
            or not max(prob_err, logit_err) <= RESNET_LOGIT_TOL:
        raise AssertionError("ResNet-50 evaluation did not read back once a "
                             "batch or disagrees with its CPU twin")
    del r50, batches
    lenet = MultiLayerNetwork(lenet_conf(learning_rate=0.02)).init()
    train = _mnist_batches(3, 44)
    lenet.fit(train)
    test = _mnist_batches(4, 45)
    twin = _cpu_twin_mln(lenet)
    ev, reads = _eval_readbacks(lambda: lenet.evaluate(test),
                                "multilayer.eval")
    want = twin.evaluate(test)
    per = lenet.score_examples(test[0], add_regularization=True)
    per_want = twin.score_examples(test[0], add_regularization=True)
    per_err = float(np.abs(per - per_want).max() / np.abs(per_want).max())
    log(f"lenet evaluate (f32, B 128 x 4): accuracy card {ev.accuracy():.6f}"
        f" vs CPU f32 {want.accuracy():.6f} (tol {EVAL_ACC_TOL}), readbacks "
        f"{reads}; score_examples [{per.shape[0]}] max relative difference "
        f"{per_err:.3e} (tol {TRAIN_LOSS_TOL})")
    if reads != 4 or not abs(ev.accuracy() - want.accuracy()) <= \
            EVAL_ACC_TOL or not per_err <= TRAIN_LOSS_TOL:
        raise AssertionError("LeNet evaluation disagrees with its CPU twin")
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        launches[dtype] = check_lenet_bn(card, dtype)
    log(f"phase evaluate: {time.perf_counter() - t0:.1f}s wall")
    return launches


# ------------------------------------------------------------ phase 11
#: (M, C) of ResNet-50's batch norms at B 128, 224 x 224 (M = N·H·W), and
#: how many BN layers of each variant sit at each in one step: "relu" the
#: 33 BNs whose own ReLU the kernel applies (the stem and every block's a
#: and b BNs), "identity" the 4 projection shortcuts' BNs (both
#: batchnorm_train), "tail" the 16 fused BN -> add -> ReLU tails
#: (batchnorm_add_act_train)
BN_SITES = {
    (1605632, 64): {"relu": 1},
    (401408, 64): {"relu": 6},
    (401408, 256): {"identity": 1, "tail": 3},
    (100352, 128): {"relu": 8},
    (100352, 512): {"identity": 1, "tail": 4},
    (25088, 256): {"relu": 12},
    (25088, 1024): {"identity": 1, "tail": 6},
    (6272, 512): {"relu": 6},
    (6272, 2048): {"identity": 1, "tail": 3},
}
#: the helper, and the kernels-line row, of each variant
BN_HELPER = {"relu": "batchnorm_train", "identity": "batchnorm_train",
             "tail": "batchnorm_add_act_train"}
#: the PyTorch calls each variant's yardstick composes: no single call
#: computes relu(bn(x)) or relu(bn(x) + res)
BN_LIBRARY = {"identity": "F.batch_norm",
              "relu": "composition F.batch_norm + relu",
              "tail": "composition F.batch_norm + add + relu"}
#: a batch-norm kernel against its plain version on the card: relative L2
#: of y and dx (bf16: both round every elementwise op to bf16, and the
#: per-channel scale / shift, rounded to bf16, can differ by one rounding
#: where the two sum the statistics in other orders; f32: summation order
#: only), and of mean / var / dgamma / dbeta (f32 sums of the same terms
#: in other orders, in both dtypes)
BN_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-5}
BN_STAT_TOL = 1e-5
#: the ResNet-50 phase against its CPU f32 twin: inference logits (B 4),
#: the running statistics after the first step (B 8); the first step's
#: loss and gradients use TRAIN_LOSS_TOL / TRAIN_GRAD_TOL
RESNET_LOGIT_TOL, RESNET_STATE_TOL = 5e-2, 2e-2
VGG_TOL = 5e-2
RESNET_FALL_STEPS = 6
LAYOUT_TRANSPOSES = re.compile(r"nchwToNhwc|nhwcToNchw|transpose",
                               re.IGNORECASE)
#: the profiled ResNet-50 step of the earlier three-kernel batch-norm
#: design (PERF.md): launches, device ms, and its 318 batch-norm kernels
#: (3 a call, 53 BNs, 2 ways)
THREE_KERNEL_STEP = {"launches": "3,504-3,509", "device_ms": "33.98-34.21",
                     "bn_kernels": 318}
#: CPU-side operators of a BN layer's ReLU run outside its kernel
RELU_OPS = ("aten::relu", "aten::relu_", "aten::threshold_backward")


def _bn_case(m, c, dtype, seed):
    """x [M, C] with per-channel means and scales, a residual, an incoming
    gradient, gamma, beta and a shift hint near each channel's mean (a
    warmed-up running mean), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    mu, sigma = randn(c), 0.5 + 1.5 * torch.rand(c, generator=g,
                                                 device="cuda")
    x = (randn(m, c) * sigma + mu).to(dtype)
    res, dy = randn(m, c).to(dtype), randn(m, c).to(dtype)
    gamma = 0.5 + torch.rand(c, generator=g, device="cuda")
    beta = 0.1 * randn(c)
    shift = mu + 0.1 * randn(c)
    return x, res, dy, gamma, beta, shift


def _bn_fwd(variant, impl, x, res, gamma, beta, shift):
    """(y, mean, var, rstd) of ``variant`` through ``impl`` ("kernel" or
    "plain")."""
    tail, relu = variant == "tail", variant != "identity"
    if impl == "plain":
        return bnk.bn_fwd_plain(x, gamma, beta, shift, 1e-5,
                                res if tail else None, relu)
    if tail:
        return bnk.bn_add_act_fwd(x, gamma, beta, shift, res, 1e-5, True)
    return bnk.bn_train_fwd(x, gamma, beta, shift, 1e-5, relu)


def _bn_bwd(variant, impl, dy, x, y, gamma, beta, mean, rstd):
    """The backward of ``variant`` on a forward's outputs: (dx, dgamma,
    dbeta) and, for the tail, dres."""
    tail, relu = variant == "tail", variant != "identity"
    if impl == "plain":
        grads = bnk.bn_bwd_plain(dy, x, gamma, mean, rstd,
                                 y if tail else None, relu, beta)
        return grads if tail else grads[:3]
    if tail:
        return bnk.bn_add_act_bwd(dy, x, y, gamma, mean, rstd, True)
    return bnk.bn_train_bwd(dy, x, gamma, mean, rstd, beta, relu)


def _bn_fwd_bwd(variant, impl, x, res, dy, gamma, beta, shift):
    """One forward and backward of ``variant`` through ``impl``; the
    backward reads the forward's outputs."""
    y, mean, var, rstd = _bn_fwd(variant, impl, x, res, gamma, beta, shift)
    return (y, mean, var, rstd), _bn_bwd(variant, impl, dy, x, y, gamma,
                                         beta, mean, rstd)


def _bn_library(variant, x, res, dy, gamma, beta):
    """F.batch_norm in training, forward and backward (x, gamma, beta, and
    res for the tail) on the same [M, C], composed with the variant's add
    and ReLU: the yardstick (BN_LIBRARY)."""
    xl, rl = (t.detach().requires_grad_(True) for t in (x, res))
    gl, bl = (t.detach().requires_grad_(True) for t in (gamma, beta))
    rm = torch.zeros_like(gamma)
    rv = torch.ones_like(gamma)
    inputs = (xl, gl, bl) + ((rl,) if variant == "tail" else ())

    def run():
        y = torch.nn.functional.batch_norm(xl, rm, rv, gl, bl, True, 0.1,
                                           1e-5)
        if variant == "tail":
            y = y + rl
        if variant != "identity":
            y = torch.relu(y)
        torch.autograd.grad(y, inputs, dy)
    return run


def check_bn_site(variant, m, c, dtype, seed, timed):
    """A batch-norm variant's forward and backward kernels against their
    plain versions on the card at one (M, C) site, and bitwise equal over
    two runs; for "relu" also the backward's recomputed mask against the
    forward's y > 0. With ``timed`` the times: the two kernels' device
    time (``ms``, each alone with the host's enqueue hidden), the wrapper
    calls' back to back (``wrapper_ms``, which the host bounds at small
    sites), the plain version's, the yardstick's, and the bytes bound
    (every activation read once and written once, both ways)."""
    case = _bn_case(m, c, dtype, seed)
    x, res, dy, gamma, beta, shift = case
    (y, mean, var, rstd), grads = _bn_fwd_bwd(variant, "kernel", *case)
    (y_p, mean_p, var_p, _), _ = _bn_fwd_bwd(variant, "plain", *case)
    # the plain backward on the kernel's forward outputs (the same mask)
    grads_p = _bn_bwd(variant, "plain", dy, x, y, gamma, beta, mean, rstd)
    again = _bn_fwd_bwd(variant, "kernel", *case)
    errs = {"y": _rel_l2(y, y_p), "dx": _rel_l2(grads[0], grads_p[0])}
    stats = {"mean": _rel_l2(mean, mean_p), "var": _rel_l2(var, var_p),
             "dgamma": _rel_l2(grads[1], grads_p[1]),
             "dbeta": _rel_l2(grads[2], grads_p[2])}
    same = all(torch.equal(a, b) for a, b in
               zip((y, mean, var, *grads), (*again[0][:3], *again[1])))
    checks = {"bitwise run to run": same}
    if variant == "tail":
        checks["dres exact"] = torch.equal(grads[3], grads_p[3])
    if variant == "relu":
        masked = torch.where(y > 0, dy, torch.zeros_like(dy))
        checks["mask = y > 0"] = torch.equal(
            grads[0], bnk.bn_train_bwd(masked, x, gamma, mean, rstd)[0])
    torch.cuda.synchronize()
    ok = all(e <= BN_TOL[dtype] for e in errs.values()) and \
        all(e <= BN_STAT_TOL for e in stats.values()) and \
        all(checks.values()) and \
        all(torch.isfinite(t).all() for t in (y, *grads[:3]))
    line = (f"{variant} M {m} C {c} {str(dtype)[6:]}: "
            + ", ".join(f"{k} {e:.2e}" for k, e in {**errs, **stats}.items())
            + "".join(f", {k} {v}" for k, v in checks.items()))
    if not ok:
        raise AssertionError(f"batch-norm kernel disagrees with its plain "
                             f"version: {line}")
    if not timed:
        return line, None
    size = x.element_size()
    bytes_ = m * c * size * (8 if variant == "tail" else 5) + 9 * c * 4
    fwd = lambda: _bn_fwd(variant, "kernel", x, res, gamma, beta, shift)
    bwd = lambda: _bn_bwd(variant, "kernel", dy, x, y, gamma, beta, mean,
                          rstd)
    dev = {"fwd": device_ms(fwd), "bwd": device_ms(bwd)}
    t = {"ms": dev["fwd"] + dev["bwd"],
         "wrapper_ms": time_ms(lambda: _bn_fwd_bwd(variant, "kernel",
                                                   *case)),
         "plain_ms": time_ms(lambda: _bn_fwd_bwd(variant, "plain", *case),
                             reps=10),
         "library_ms": time_ms(_bn_library(variant, x, res, dy, gamma,
                                           beta)),
         "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3}
    kind = BN_HELPER[variant]
    plans = [bnk.plan(m, c, dtype, v) for v in (
        (bnk.FWD_RES_RELU, bnk.BWD_RES_RELU) if variant == "tail" else
        (bnk.FWD_RELU, bnk.BWD_RELU) if variant == "relu" else
        (bnk.FWD, bnk.BWD))]
    resident = "/".join("resident" if p["resident"] else
                        f"{p['stages']} stages" for p in plans)
    return line + (
        f"; fwd+bwd kernels {t['ms']:.4f} ms on the device (fwd "
        f"{dev['fwd']:.4f}, bwd {dev['bwd']:.4f}; {resident}), wrapper "
        f"calls back to back {t['wrapper_ms']:.4f}, bound "
        f"{t['bound_ms']:.4f} (bytes; "
        f"kernel/bound {t['ms'] / t['bound_ms']:.2f}), plain "
        f"{t['plain_ms']:.4f}, {BN_LIBRARY[variant]} {t['library_ms']:.4f} "
        f"(kernel/library {t['ms'] / t['library_ms']:.2f}) [{kind}]"), t


def check_bn_kernels():
    """The three batch-norm variants at every ResNet-50 site, bf16 and
    f32, against their plain versions; the bf16 times where the step runs
    each variant, summed over one ResNet-50 step's sites (times the layers
    at each) into the helper's row of the kernels line; the refusal of a
    dtype the kernel does not take."""
    measured = {k: {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0,
                    "library_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
                    "max_abs_err": 0.0}
                for k in ("batchnorm_train", "batchnorm_add_act_train")}
    by_variant = {v: {"ms": 0.0, "wrapper_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0} for v in BN_HELPER}
    for i, ((m, c), counts) in enumerate(BN_SITES.items()):
        for variant in BN_HELPER:
            for dtype in (torch.bfloat16, torch.float32):
                timed = dtype == torch.bfloat16 and variant in counts
                line, t = check_bn_site(variant, m, c, dtype, 100 + i, timed)
                log(f"  {line}")
                if t is None:
                    continue
                row = measured[BN_HELPER[variant]]
                for key in ("ms", "wrapper_ms", "plain_ms", "library_ms",
                            "bound_ms"):
                    row[key] += counts[variant] * t[key]
                for key in by_variant[variant]:
                    by_variant[variant][key] += counts[variant] * t[key]
    # the largest forward difference at the stem's site, for the line
    for variant in ("relu", "tail"):
        case = _bn_case(1605632, 64, torch.bfloat16, 7)
        (y, *_), _ = _bn_fwd_bwd(variant, "kernel", *case)
        (y_p, *_), _ = _bn_fwd_bwd(variant, "plain", *case)
        measured[BN_HELPER[variant]]["max_abs_err"] = \
            (y.float() - y_p.float()).abs().max().item()
    for variant, r in by_variant.items():
        log(f"batch-norm {variant} over one ResNet-50 step's sites (bf16, "
            f"fwd + bwd): kernels {r['ms']:.4f} ms on the device (wrapper "
            f"calls {r['wrapper_ms']:.4f}), bound {r['bound_ms']:.4f} "
            f"({r['ms'] / r['bound_ms']:.2f}x), "
            f"{BN_LIBRARY[variant]} {r['library_ms']:.4f} "
            f"({r['ms'] / r['library_ms']:.2f}x)")
    for kind, r in measured.items():
        log(f"{kind} over one ResNet-50 step's sites (bf16, fwd + bwd): "
            f"kernels {r['ms']:.4f} ms on the device (wrapper calls "
            f"{r['wrapper_ms']:.4f}), plain {r['plain_ms']:.4f}, "
            f"yardstick {r['library_ms']:.4f}, bound {r['bound_ms']:.4f}")
    return measured


# -------------------------------------- phase 3: the ring and the BN shards
#: the ring's rows: (B, H, T, D, sp) of phase 15's steps; the first is
#: timed for the kernels line
RING_CASES = [(8, 12, 512, 64, 4), (8, 12, 512, 64, 2), (4, 12, 2048, 64, 4)]
#: cross-shard batch norm: data shards of one ResNet-50 step at data 2
BN_XS_SHARDS = 2


def _ring_run(chunks, impl, dtype=None):
    """Forward and backward of the ring over ``chunks`` ((qs, ks, vs, dos),
    lists of [B, T/sp, H, D]): (outputs, (dq, dk, dv) chunk lists)."""
    qs, ks, vs, dos = chunks
    cast = (lambda t: t.to(dtype)) if dtype else (lambda t: t)
    leaves = [cast(t).detach().requires_grad_(True) for t in qs + ks + vs]
    n = len(qs)
    outs = ring_attend(leaves[:n], leaves[n:2 * n], leaves[2 * n:], True,
                       impl)
    grads = torch.autograd.grad(outs, leaves, [cast(t) for t in dos])
    return outs, (grads[:n], grads[n:2 * n], grads[2 * n:])


def _sdpa_ring_yardstick(q, k, v, do):
    """scaled_dot_product_attention (is_causal) forward and backward on the
    unsharded q / k / v."""
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    dot = do.transpose(1, 2)

    def run():
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True)
        torch.autograd.grad(o, leaves, dot)
    return run


def check_ring(b, h, t, d, sp, seed, timed):
    """The flash-kernel ring (``parallel/sequence.py``'s ``_RingFlash``,
    each pair on B3 and B4 / B5) over ``sp`` chunks of causal bf16 q / k /
    v [B, T, H, D] against its plain version (the streaming ring, in f32
    on the same inputs): o max-abs, dq / dk / dv rel-L2, and B3, B4, B5
    each launched sp(sp+1)/2 times. With ``timed``: the ring's forward +
    backward, the plain ring's in bf16, SDPA's on the unsharded q / k / v
    and the bound."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = [torch.randn(b, t, h, d, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(4)]
    chunks = [[c.contiguous() for c in x.chunk(sp, dim=1)] for x in full]
    _sync()
    reset_launches()
    outs, grads = _ring_run(chunks, None)
    _sync()
    launches = {k: read_launches()[k] for k in RING_KERNELS}
    outs_p, grads_p = _ring_run(chunks, "jnp", torch.float32)
    err = max((o.float() - p).abs().max().item()
              for o, p in zip(outs, outs_p))
    rels = {n: _rel_l2(torch.cat(gk, 1).float(), torch.cat(gp, 1))
            for n, gk, gp in zip("qkv", grads, grads_p)}
    want = sp * (sp + 1) // 2
    line = (f"ring B {b} H {h} T {t} D {d} sp {sp} (causal, bf16): o "
            f"max-abs {err:.3e} (tol {O_TOL}); d"
            + ", d".join(f"{n} rel-L2 {e:.3e}" for n, e in rels.items())
            + f" (tol {GRAD_TOL}); launches {launches} (expected {want} "
            "each)")
    if err > O_TOL or any(e > GRAD_TOL for e in rels.values()) or \
            any(n != want for n in launches.values()) or \
            not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"the ring disagrees with its plain version: "
                             f"{line}")
    if not timed:
        log(f"  {line}")
        return None
    pairs = b * h * t * (t + 1) // 2
    bytes_ = 8 * b * t * h * d * 2
    flops = 14 * d * pairs
    bound = max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    r = {"max_abs_err": err,
         "ms": time_ms(lambda: _ring_run(chunks, None), reps=10, batch=3),
         "plain_ms": time_ms(lambda: _ring_run(chunks, "jnp"), warmup=1,
                             reps=5, batch=1),
         "library_ms": time_ms(_sdpa_ring_yardstick(*full), reps=10),
         "bound_ms": bound,
         "bound_by": "bytes" if bytes_ / HBM_BYTES_PER_S >=
         flops / BF16_FLOPS else "operations"}
    log(f"  {line}; forward + backward {r['ms']:.4f} ms (host dispatch "
        f"of the pairs and merges in it), plain ring {r['plain_ms']:.4f}, "
        f"SDPA unsharded {r['library_ms']:.4f}, bound {bound:.4f} "
        f"({r['bound_by']})")
    return r


def check_ring_kernels():
    """The ring at phase 15's shapes (RING_CASES); the first timed."""
    out = None
    for i, case in enumerate(RING_CASES):
        r = check_ring(*case, 400 + i, i == 0)
        out = out or r
    return out


def _bn_xs_run(variant, case, shards=BN_XS_SHARDS):
    """The cross-shard batch norm's forward and backward (its autograd
    Function) over ``shards`` row blocks of the case: (ys, mean, var,
    grads of the xs, gamma, beta and the residuals)."""
    x, res, dy, gamma, beta, shift = case
    tail = variant == "tail"
    xs = [c.detach().requires_grad_(True) for c in x.chunk(shards)]
    rs = [c.detach().requires_grad_(True) for c in res.chunk(shards)] \
        if tail else None
    gl, bl = (p.detach().requires_grad_(True) for p in (gamma, beta))
    ys, mean, var = bnk.bn_train_shards(
        xs, gl, bl, shift, 1e-5, "identity" if variant == "identity"
        else "relu", rs)
    grads = torch.autograd.grad(ys, xs + [gl, bl] + (rs or []),
                                list(dy.chunk(shards)))
    return ys, mean, var, grads


def _bn_xs_plain(variant, case):
    """The same function on the whole batch by the plain versions."""
    x, res, dy, gamma, beta, shift = case
    tail, relu = variant == "tail", variant != "identity"
    y, mean, var, rstd = bnk.bn_fwd_plain(x, gamma, beta, shift, 1e-5,
                                          res if tail else None, relu)
    return (y, mean, var), bnk.bn_bwd_plain(dy, x, gamma, mean, rstd,
                                            y if tail else None, relu, beta)


def check_bn_cross_site(variant, m, c, seed):
    """A batch norm over BN_XS_SHARDS row blocks of one ResNet-50 site
    (bf16) through the cross-shard kernels against the plain version on
    the whole batch, timed beside it, F.batch_norm on the whole batch and
    the bytes bound."""
    case = _bn_case(m, c, torch.bfloat16, seed)
    n = BN_XS_SHARDS
    _sync()
    reset_launches()
    ys, mean, var, grads = _bn_xs_run(variant, case)
    _sync()
    launches = _xs_launches(read_launches())
    (y_p, mean_p, var_p), grads_p = _bn_xs_plain(variant, case)
    y = torch.cat(ys)
    errs = {"y": _rel_l2(y, y_p), "dx": _rel_l2(torch.cat(grads[:n]),
                                                grads_p[0])}
    stats = {"mean": _rel_l2(mean, mean_p), "var": _rel_l2(var, var_p),
             "dgamma": _rel_l2(grads[n], grads_p[1]),
             "dbeta": _rel_l2(grads[n + 1], grads_p[2])}
    if variant == "tail":
        errs["dres"] = _rel_l2(torch.cat(grads[n + 2:]), grads_p[3])
    want = {f"{p}{s}": (1 if "finalize" in p else n)
            for p in XS_PHASES for s in ("", ".bwd")}
    line = (f"cross-shard {variant} M {m} C {c} bf16 over {n} shards: "
            + ", ".join(f"{k} {e:.2e}" for k, e in {**errs, **stats}.items())
            + f"; launches {launches}")
    if any(e > BN_TOL[torch.bfloat16] for e in errs.values()) or \
            any(e > BN_STAT_TOL for e in stats.values()) or \
            launches != want or not torch.isfinite(y).all():
        raise AssertionError(f"the cross-shard batch norm disagrees with "
                             f"its plain version: {line} (expected "
                             f"launches {want})")
    x, res, dy, gamma, beta, _ = case
    size = x.element_size()
    t = {"max_abs_err": (y.float() - y_p.float()).abs().max().item(),
         "ms": time_ms(lambda: _bn_xs_run(variant, case), reps=10,
                       batch=3),
         "plain_ms": time_ms(lambda: _bn_xs_plain(variant, case), reps=5,
                             batch=2),
         "library_ms": time_ms(_bn_library(variant, x, res, dy, gamma,
                                           beta), reps=10, batch=3),
         "bound_ms": (m * c * size * (8 if variant == "tail" else 5) +
                      9 * c * 4) / HBM_BYTES_PER_S * 1e3}
    log(f"  {line}; fwd + bwd {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, "
        f"{BN_LIBRARY[variant]} {t['library_ms']:.4f}, bound "
        f"{t['bound_ms']:.4f} (bytes)")
    return t


def check_bn_cross_shard():
    """Every variant a ResNet-50 step runs at each site, over 2 shards,
    summed over the step's sites (times the layers at each) for the
    kernels line; max_abs_err the largest y difference of any site."""
    row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes", "max_abs_err": 0.0}
    for i, ((m, c), counts) in enumerate(BN_SITES.items()):
        for variant, k in counts.items():
            t = check_bn_cross_site(variant, m, c, 500 + i)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                row[key] += k * t[key]
            row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
    log(f"batchnorm_cross_shard over one ResNet-50 step's sites at data 2 "
        f"(bf16, fwd + bwd): {row['ms']:.4f} ms, plain {row['plain_ms']:.4f},"
        f" F.batch_norm (composed) {row['library_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f}")
    return row


# ------------------------------------------------- phase 3: C4 variants
#: batch norms the fused kernel does not take, on the general route:
#: (M, C, dtype); the first three are an RGB input's and LeNet's BN sites
C4_BN = [(m, c, dt) for m, c in ((401408, 3), (100352, 20), (25088, 50))
         for dt in (torch.bfloat16, torch.float32, torch.float16)] + \
    [(6272, 8192, torch.bfloat16), (6272, 4096, torch.float32)]
#: LSTMs the cluster route does not take: (T, N, H, dtype, peepholes,
#: masked, route, (gate, cell), scale of xw and R). relu gates with an
#: identity cell are unbounded, and a logsoftmax cell feeds h ~ -6 o back
#: through R (at scale 1 the plain f32 loop ends 1e11 off f64 at T 32), so
#: their inputs are scaled down until the recurrence contracts
C4_LSTM = [
    (128, 64, 512, torch.bfloat16, True, True, "cooperative",
     ("hardsigmoid", "softsign"), 1.0),
    (128, 64, 512, torch.float32, True, False, "cooperative",
     ("hardsigmoid", "softsign"), 1.0),
    (32, 64, 512, torch.float32, False, False, "cooperative",
     ("relu", "identity"), 0.3),
    (128, 64, 512, torch.float16, True, True, "cooperative",
     lk.DEFAULT_ACTS, 1.0),
    (32, 64, 2048, torch.float32, False, False, "streamed",
     lk.DEFAULT_ACTS, 1.0),
    # the row-wise activations (two grid-wide row reductions a step)
    (32, 64, 512, torch.float32, True, True, "cooperative",
     ("softmax", "tanh"), 1.0),
    (32, 64, 512, torch.bfloat16, False, False, "cooperative",
     ("softmax", "tanh"), 1.0),
    (32, 64, 512, torch.float32, True, True, "cooperative",
     ("sigmoid", "logsoftmax"), 0.05),
    (32, 64, 512, torch.bfloat16, False, False, "cooperative",
     ("sigmoid", "logsoftmax"), 0.05),
    (32, 64, 2048, torch.float32, False, False, "streamed",
     ("softmax", "tanh"), 1.0),
]
#: attention head dims no kernel took before: (name, B, H, T, D)
C4_ATTN = [(name, b, h, t, d) for d in (36, 256) for name, b, h, t in (
    ("shortseq_attention", 4, 4, 512), ("flash_forward", 1, 4, 2048),
    ("shortseq_attention_bwd", 4, 4, 512), ("flash_backward_dq", 1, 4, 2048),
    ("flash_backward_dkv", 1, 4, 2048))] + \
    [(name, b, h, t, d) for d in (264, 320, 512) for name, b, h, t in (
        ("shortseq_attention", 2, 4, 512), ("flash_forward", 1, 2, 2048),
        ("shortseq_attention_bwd", 2, 4, 512),
        ("flash_backward_dq", 1, 2, 2048),
        ("flash_backward_dkv", 1, 2, 2048))]


def _c4_row(kernel, shape, dtype, route, r):
    return {"kernel": kernel, "shape": shape, "dtype": str(dtype)[6:],
            "route": route, **{k: r.get(k) for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}


def check_c4_bn(m, c, dtype, seed):
    """The three batch-norm variants at (M, C) in ``dtype`` (the general
    route, or the fused one where it takes the shape) against their plain
    versions (check_bn_site's gates); the
    identity BN's forward + backward timed beside its plain version,
    F.batch_norm and the bytes bound."""
    way = bnk.route(torch.empty(m, c, device="cuda", dtype=dtype),
                    torch.empty(c, device="cuda"))
    for variant in BN_HELPER:
        line, _ = check_bn_site(variant, m, c, dtype, seed, False)
        log(f"  C4 {line}")
    case = _bn_case(m, c, dtype, seed)
    xk, res, dy, gamma, beta, shift = case
    (y, *_), _ = _bn_fwd_bwd("identity", "kernel", *case)
    (y_p, *_), _ = _bn_fwd_bwd("identity", "plain", *case)
    err = (y.float() - y_p.float()).abs().max().item()
    lib = time_ms(_bn_library("identity", xk, res, dy, gamma, beta),
                  reps=10)
    r = {"max_abs_err": err,
         "ms": time_ms(lambda: _bn_fwd_bwd("identity", "kernel", *case),
                       reps=10),
         "plain_ms": time_ms(lambda: _bn_fwd_bwd("identity", "plain",
                                                 *case), reps=5),
         "library_ms": lib,
         "bound_ms": m * c * xk.element_size() * 5 / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes"}
    log(f"  C4 batch norm [{m}, {c}] {str(dtype)[6:]} {way} route, "
        f"identity fwd+bwd: kernel_ms {r['ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} library_ms {lib:.4f} (F.batch_norm) bound_ms "
        f"{r['bound_ms']:.4f} (bytes)")
    return _c4_row("batchnorm_train", [m, c], dtype, way, r)


def check_c4_lstm(t, n, h, dtype, peep, masked, route, acts, scale, seed):
    """B6 on a C4 case against its plain version, timed beside it, the
    bound and (sigmoid / tanh without peepholes) the cuDNN LSTM layer."""
    err = _lstm_check(t, n, h, dtype, peep, masked, seed, route, acts,
                      scale)
    args = _lstm_inputs(t, n, h, dtype, peep, masked, seed)
    args = (args[0] * scale, args[1] * scale) + args[2:]
    fns = tuple(get_activation(a) for a in acts)
    ms = time_ms(lambda: lk.lstm_recurrence_fwd(*args, *acts), reps=5,
                 batch=2)
    plain_ms = time_ms(lambda: lk.lstm_recurrence_plain(*args, *fns),
                       warmup=1, reps=3, batch=1)
    library_ms = None
    if tuple(acts) == lk.DEFAULT_ACTS and not peep:
        ref = torch.nn.LSTM(h, h, batch_first=True).cuda().to(dtype)
        ref.flatten_parameters()
        x = torch.randn(n, t, h, device="cuda", dtype=dtype)
        with torch.no_grad():
            library_ms = time_ms(lambda: ref(x), reps=5, batch=2)
    bound_ms, bound_by = _lstm_bound(t, n, h, dtype, peep, masked)
    plan = lk.lstm_plan(n, h, dtype, *acts)
    log(f"  C4 lstm T {t} N {n} H {h} {str(dtype)[6:]} {acts[0]}/{acts[1]} "
        f"route {plan['route']} (resident R rows {plan['resident_rows']}): "
        f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms} (cuDNN LSTM layer, projection included) bound_ms "
        f"{bound_ms:.4f} ({bound_by})")
    return _c4_row("lstm_recurrence", [t, n, h], dtype,
                   f"{route} {acts[0]}/{acts[1]}",
                   {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by})


def check_c4_attention(name, b, h, t, d, seed):
    """An attention kernel at a C4 head dim (zero-padded to a multiple of
    8, or the D 256 instance) against its plain version, causal bf16 with
    a prefix key mask, through check_kernel / check_bwd_kernel."""
    lengths = [t] + [t // 2 + 7] * (b - 1)
    if name in ("shortseq_attention", "flash_forward"):
        r = check_kernel(name, b, h, t, d, lengths, seed)
    else:
        r = check_bwd_kernel(name, b, h, t, d, lengths, seed, True)
    route = "columns split in 128-wide slices" if d > 256 else \
        "CUDA-core D 256 instance" if d > 128 else \
        f"padded to D {-(-d // 8) * 8}"
    return _c4_row(name, [b, h, t, d], torch.bfloat16, route, r)


def check_nothing_refused():
    """No head dim and no activation of ops/activations.py raises on the
    card: attention forward and backward at D 4-1000 (short and flash),
    and B6 with every activation as the gate (tanh cell) and as the cell
    (sigmoid gates), each against its plain version (the attention at
    the check's bf16 tolerances, B6 by _lstm_check's rule)."""
    from deeplearning4j_tpu_torch.ops.activations import activation_names
    for d in (4, 100, 264, 520, 1000):
        for name, t in (("shortseq_attention", 64),
                        ("flash_forward", 1024)):
            q3, k3, v3, km = _attention_case(1, 2, t, d, [t], 700 + d)
            o_k, lse_k = KERNELS[name]["wrapper"](q3, k3, v3, km, 2, True)
            o_p, _ = KERNELS[name]["plain"](q3, k3, v3, km, 2, True)
            err = (o_k.float() - o_p.float()).abs().max().item()
            if not err <= O_TOL:
                raise AssertionError(f"{name} at D {d} disagrees with its "
                                     f"plain version ({err:.3e})")
            do = torch.randn_like(q3)
            grads = (short_attention_bwd if t <= 512 else flash_backward)(
                q3, k3, v3, km, 2, True, o_k, lse_k, do)
            want = attention_bwd_plain(q3, k3, v3, km, 2, True, o_k, lse_k,
                                       do)
            gerr = max(_rel_l2(g, w) for g, w in zip(grads, want))
            if not gerr <= GRAD_TOL:
                raise AssertionError(f"attention backward at D {d}, T {t} "
                                     f"disagrees ({gerr:.3e})")
    names = [a for a in activation_names() if a != "linear"]
    for act in names:
        for acts in ((act, "tanh"), ("sigmoid", act)):
            _lstm_check(4, 5, 48, torch.float32, True, True, 800, None,
                        acts, 0.3)
    log(f"nothing refused: attention at D 4, 100, 264, 520, 1000 (short "
        f"and flash, forward and backward) and B6 with each of "
        f"{len(names)} activations as gate and as cell agree with their "
        "plain versions")


def check_c4_variants():
    """Every C4 variant (shapes the card refused before) against its plain
    version, with its times: the rows of PERF.md's C4 table."""
    t0 = time.perf_counter()
    rows = [check_c4_bn(m, c, dt, 400 + i) for i, (m, c, dt) in
            enumerate(C4_BN)]
    rows += [check_c4_lstm(*case, 500 + i) for i, case in
             enumerate(C4_LSTM)]
    rows += [check_c4_attention(*case, 600 + i) for i, case in
             enumerate(C4_ATTN)]
    check_nothing_refused()
    log(f"C4 variants: {len(rows)} checked in "
        f"{time.perf_counter() - t0:.1f}s")
    return rows


def _conv_flops(conf, b, fused):
    """(training FLOPs of one step's convolutions and head, batch-norm
    bytes): 2 FLOP a multiply-add, the forward and the two backward
    products (no input gradient for the stem); each BN's least forward +
    backward bytes in bf16: 5 passes of its [M, C] (its own ReLU, when it
    has one, adds none: the kernel applies it and recomputes its mask), 8
    for a fused tail (in ``fused``)."""
    vertices = copy.deepcopy(conf.vertices)
    types = infer_graph_shapes(vertices, conf.vertex_inputs,
                               conf.network_inputs, conf.input_types,
                               conf.topological_order)
    flops, bytes_ = 0, 0
    for name in conf.topological_order:
        v = conf.vertices[name]
        if not isinstance(v, LayerVertex):
            continue
        out = types[name]
        layer = v.layer
        if isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernel_size
            macs = b * out.height * out.width * out.channels * kh * kw * \
                layer.n_in
            grads = 1 if conf.vertex_inputs[name] == ["input"] else 2
            flops += 2 * macs * (1 + grads)
        elif isinstance(layer, BatchNormalization):
            mc = b * out.height * out.width * out.channels
            bytes_ += 2 * mc * (8 if name in fused else 5)
        elif hasattr(layer, "n_out") and hasattr(layer, "n_in"):
            flops += 2 * b * layer.n_in * layer.n_out * 3
    return flops, bytes_


def _logits(net, x):
    """The head's pre-softmax output of an inference forward."""
    with torch.no_grad():
        _, _, _, _, _, pre = net._forward(
            net._cast_params(net.params), net._inference_state(),
            net._inputs_dict(x), output_preout=True)
    return pre[net.conf.network_outputs[0]].float().cpu()


def _images(b, hw, c, classes, seed):
    """Seeded synthetic images [B, H, W, C] and one-hot labels on the
    card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, hw, hw, c, generator=g, device="cuda")
    labels = torch.randint(0, classes, (b,), generator=g, device="cuda")
    return x, torch.nn.functional.one_hot(labels, classes).float()


def _grad_errs(got_g, want_g):
    return {f"{v}.{k}": _rel_l2(got_g[v][k].cpu(), want_g[v][k])
            for v, k in (("stem_conv", "W"), ("s1b0_b_conv", "W"),
                         ("s3b2_c_bn", "gamma"), ("fc", "W"))}


def _state_err(net, twin):
    """The worst rel-L2 over every running mean and variance."""
    return max(_rel_l2(net.state[v][k].cpu(), twin.state[v][k])
               for v in net.state for k in net.state[v])


def check_resnet_twin(net):
    """ResNet-50 on the card against its CPU f32 twin (same weights and
    state): the bf16 net's inference logits at B 4 and first-step loss at
    B 8; the same weights in f32 on the card (the f32 batch-norm kernels,
    cuDNN without TF32) for the first step's loss and gradients and the
    running statistics after it. The bf16 net's first-step gradients and
    running statistics against the twin are printed too: at random
    initialization a 53-BN-deep net's backward amplifies bf16 rounding,
    so they measure bf16, not the kernels (which phase 3 holds against
    their plain versions in bf16 at every site)."""
    twin = _cpu_twin(net)
    x4, _ = _images(4, 224, 3, 1000, 31)
    logit_err = _rel_l2(_logits(net, x4), _logits(twin, x4.cpu()))
    x8, y8 = _images(8, 224, 3, 1000, 32)
    ds, ds_cpu = DataSet(x8, y8), DataSet(x8.cpu(), y8.cpu())
    want_g, want_l = twin.compute_gradient_and_score(ds_cpu)
    bf_g, bf_l = net.compute_gradient_and_score(ds)
    # copies on the card, so the timed steps start from the initial net
    copies = {dt: graph_from_numpy(
        net.conf, {v: {k: a.cpu().numpy() for k, a in p.items()}
                   for v, p in net.params.items()},
        state={v: {k: a.cpu().numpy() for k, a in p.items()}
               for v, p in net.state.items()}, compute_dtype=dt)
        for dt in (torch.float32, torch.bfloat16)}
    f32 = copies[torch.float32]
    got_g, got_l = f32.compute_gradient_and_score(ds)
    rel = lambda a: abs(a - want_l) / abs(want_l)
    errs, bf_errs = _grad_errs(got_g, want_g), _grad_errs(bf_g, want_g)
    for copy_net in copies.values():
        copy_net.fit_batch(ds)
    twin.fit_batch(ds_cpu)
    state_err = _state_err(f32, twin)
    bf_state_err = _state_err(copies[torch.bfloat16], twin)
    log(f"resnet50 vs CPU f32 twin: bf16 logits (B 4) rel-L2 "
        f"{logit_err:.3e} (tol {RESNET_LOGIT_TOL}); first-step loss (B 8) "
        f"bf16 {bf_l:.6f}, f32 {got_l:.6f}, twin {want_l:.6f} (rel "
        f"{rel(bf_l):.3e}, {rel(got_l):.3e}; tol {TRAIN_LOSS_TOL}); f32 "
        f"gradient rel-L2 "
        f"{', '.join(f'{k} {e:.3e}' for k, e in errs.items())} (tol "
        f"{TRAIN_GRAD_TOL}); f32 running statistics after the step, worst "
        f"rel-L2 {state_err:.3e} (tol {RESNET_STATE_TOL}); bf16 (not held): "
        f"gradients {', '.join(f'{k} {e:.3e}' for k, e in bf_errs.items())}"
        f", running statistics {bf_state_err:.3e}")
    if not (logit_err <= RESNET_LOGIT_TOL and
            max(rel(bf_l), rel(got_l)) <= TRAIN_LOSS_TOL and
            all(e <= TRAIN_GRAD_TOL for e in errs.values()) and
            state_err <= RESNET_STATE_TOL):
        raise AssertionError("card ResNet-50 disagrees with the CPU f32 "
                             "reference")


def phase_resnet(card):
    """bench.py's ResNet-50 (resnet50_conf(1000, 224, 224, 3), nesterovs
    lr 0.1, l2 1e-4, bf16 compute on f32 masters, B 128) through
    ComputationGraph.fit_batch on seeded synthetic images: the CPU f32
    twin's checks, 2 warm and 8 timed steps with every BN on its kernel
    (37 batchnorm_train and 16 fused tails a step, each with its
    backward), the step floor, peak memory and a profiled step with no
    layout transposes."""
    t_phase = time.perf_counter()
    conf = resnet50_conf(1000, 224, 224, 3, updater="nesterovs",
                         learning_rate=0.1)
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    plan, skip = net._get_fusion_plan()
    if len(plan) != 16 or len(skip) != 32:
        raise AssertionError(f"fusion plan has {len(plan)} tails, expected "
                             "16")
    check_resnet_twin(net)
    b, steps = 128, 8
    x, y = _images(b, 224, 3, 1000, 33)
    ds = DataSet(x, y)
    torch.cuda.reset_peak_memory_stats()
    warm, _, _ = train_steps(net, ds, 2)
    losses, wall, launches = train_steps(net, ds, steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"batchnorm_train": 37, "batchnorm_add_act_train": 16}
    log(f"resnet50 train: losses {[round(v, 4) for v in warm + losses]}; "
        f"batch-norm launches in {steps} steps "
        f"{ {k: v for k, v in launches.items() if 'batchnorm' in k} }")
    for kind, per_step in want.items():
        for key in (kind, f"{kind}.bwd"):
            if launches[key] != per_step * steps:
                raise AssertionError(f"{key} launched {launches[key]} times "
                                     f"in {steps} steps, expected "
                                     f"{per_step * steps}")
    if not np.isfinite(warm + losses).all():
        raise AssertionError("ResNet-50 training loss is not finite")
    step_ms = wall / steps * 1e3
    flops, bn_bytes = _conv_flops(conf, b, skip)
    floor_ms = (flops / BF16_FLOPS + bn_bytes / HBM_BYTES_PER_S) * 1e3
    log(f"resnet50 train [{card}]: {steps * b / wall:.1f} images/s, "
        f"{step_ms:.2f} ms per step (B {b}, 224 x 224, bf16); floor "
        f"{floor_ms:.2f} ms = conv/fc {flops:.4e} FLOP at 989 TF/s "
        f"({flops / BF16_FLOPS * 1e3:.2f} ms) + BN {bn_bytes:.4e} B at "
        f"3.35 TB/s ({bn_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms) = "
        f"{floor_ms / step_ms:.3f} of the step; peak memory {peak_gb:.2f} GB")
    rows, busy, _, counts = profile_step(lambda: net.fit_batch(ds),
                                         "resnet50 step")
    bn_us = sum(us for key, us, _ in rows if "dl4j_bn" in key)
    bn_kernels = sum(n for key, _, n in rows if "dl4j_bn" in key)
    transposes = [(key, count) for key, _, count in rows
                  if LAYOUT_TRANSPOSES.search(key)]
    relu_ops = {k: counts.get(k, 0) for k in RELU_OPS}
    was = THREE_KERNEL_STEP
    log(f"resnet50 profile: batch-norm kernels {bn_kernels} (three-kernel "
        f"design: {was['bn_kernels']}), {bn_us / 1e3:.2f} ms "
        f"({bn_us / busy:.3f} of device time); all kernels "
        f"{sum(n for _, _, n in rows)} launches, {busy / 1e3:.2f} ms "
        f"(three-kernel design: {was['launches']} launches, "
        f"{was['device_ms']} ms); ReLU operators outside the kernels "
        f"{relu_ops}; layout-transpose kernels "
        f"{sum(c for _, c in transposes)} {transposes[:4]}")
    if transposes:
        raise AssertionError(f"layout transposes in the ResNet-50 step: "
                             f"{transposes}")
    n_bn = sum(want.values())
    if bn_kernels != 2 * n_bn:
        raise AssertionError(f"{bn_kernels} batch-norm kernels in the "
                             f"profiled step, expected {2 * n_bn} (one a "
                             f"direction for each of {n_bn} BN layers)")
    if any(relu_ops.values()):
        raise AssertionError(f"a BN layer's ReLU ran outside its kernel: "
                             f"{relu_ops}")
    # at lr 0.1 from a fresh init the loss on one batch of noise images
    # rises in f32 as in bf16; at lr 0.01 it must fall
    del net
    slow = ComputationGraph(resnet50_conf(1000, 224, 224, 3,
                                          learning_rate=0.01),
                            compute_dtype=torch.bfloat16).init()
    for _ in range(RESNET_FALL_STEPS):
        slow.fit_batch(ds)
        losses.append(float(slow.score_value))
    falling = losses[-RESNET_FALL_STEPS:]
    log(f"resnet50 at lr 0.01: losses {[round(v, 4) for v in falling]}")
    if not falling[-1] < falling[0]:
        raise AssertionError("ResNet-50's loss does not fall at lr 0.01")
    log(f"resnet50 phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


#: SwinV2-B's images a step in phase 11c (the benchmark's cell trains 256)
SWIN_BATCH = 16


def phase_swin(card):
    """SwinV2-B (``swinv2_conf()``: 256², window 16, depths 2 / 2 / 18 / 2,
    Adam, bf16 on f32 masters) through ComputationGraph.fit_batch on B 16
    seeded noise images: 2 warm and 3 counted steps. Stages 1-2 shift
    every other block, stages 3-4 clip the window to the resolution; every
    block's attention is one launch of each biased kernel a step, and
    none of the unbiased B1 / B2. Returns the counted steps' launches."""
    t_phase = time.perf_counter()
    conf = swinv2_conf()
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    res = 256 // 4
    windows = []
    for v in conf.vertices.values():
        layer = getattr(v, "layer", None)
        if isinstance(layer, PatchMerging):
            res //= 2
        elif isinstance(layer, SwinV2Block):
            windows.append((res, *window_of(res, res, layer.window_size,
                                            layer.shift_size)))
    shifted = sum(1 for _, _, s in windows if s)
    clipped = sum(1 for r, m, _ in windows if m == r)
    if not (len(windows) == 24 and shifted and clipped):
        raise AssertionError(f"SwinV2-B's blocks (resolution, window, "
                             f"shift): {windows}")
    x, y = _images(SWIN_BATCH, 256, 3, 1000, 37)
    ds = DataSet(x, y)
    torch.cuda.reset_peak_memory_stats()
    warm, _, _ = train_steps(net, ds, 2)
    steps = 3
    losses, wall, launches = train_steps(net, ds, steps)
    want = {"shortseq_attention_bias": len(windows) * steps,
            "shortseq_attention_bias_bwd": len(windows) * steps,
            "shortseq_attention": 0, "shortseq_attention_bwd": 0}
    log(f"swinv2-b train [{card}]: losses "
        f"{[round(v, 4) for v in warm + losses]}; {len(windows)} blocks, "
        f"{shifted} shifted, {clipped} clipped; attention launches in "
        f"{steps} steps { {k: launches[k] for k in want} }; "
        f"{steps * SWIN_BATCH / wall:.1f} images/s at B {SWIN_BATCH}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    bad = {k: launches[k] for k, n in want.items() if launches[k] != n}
    if bad:
        raise AssertionError(f"SwinV2-B's attention launches {bad}, "
                             f"expected {want}")
    if not np.isfinite(warm + losses).all():
        raise AssertionError("SwinV2-B's training loss is not finite")
    del net
    torch.cuda.empty_cache()
    log(f"swinv2-b phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_lenet_vgg(card):
    """LeNet (lenet_conf, lr 0.02, f32, B 128) through
    MultiLayerNetwork.fit on seeded synthetic MNIST: ms a step; VGG16
    (vgg16_conf, 224 x 224) forward at B 4 against its CPU f32 twin."""
    net = MultiLayerNetwork(lenet_conf(learning_rate=0.02)).init()
    g = np.random.default_rng(41)
    batches = [DataSet(g.random((128, 28, 28, 1), np.float32),
                       np.eye(10, dtype=np.float32)[g.integers(0, 10, 128)])
               for _ in range(10)]
    net.fit(batches[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(batches)
    loss = float(net.score_value)
    wall = time.perf_counter() - t0
    log(f"lenet train [{card}]: {wall / 10 * 1e3:.3f} ms per step, "
        f"{10 * 128 / wall:.1f} images/s (B 128, f32, fit over 10 batches);"
        f" last loss {loss:.4f}")
    if not np.isfinite(loss):
        raise AssertionError("LeNet training loss is not finite")
    vgg = MultiLayerNetwork(vgg16_conf(1000),
                            compute_dtype=torch.bfloat16).init()
    x4, _ = _images(4, 224, 3, 1000, 42)
    got = torch.from_numpy(vgg.output(x4))
    twin = _cpu_twin_mln(vgg)
    want = torch.from_numpy(twin.output(x4.cpu()))
    err = _rel_l2(got, want)
    log(f"vgg16 forward (B 4, 224 x 224) vs CPU f32 twin: rel-L2 "
        f"{err:.3e} (tol {VGG_TOL})")
    if not err <= VGG_TOL:
        raise AssertionError("card VGG16 disagrees with the CPU f32 "
                             "reference")


# ---------------------------------------------------------------- phase 13
#: phase 13's wall-clock budget, s
TRAINING_API_LIMIT_S = 90
#: phase 13's shapes: the char-RNN (vocab, hidden, B, T, TBPTT window) of
#: (a) and (b), the pretrain stack's batch and batch count (c), ResNet-50's
#: batch and image side (d)
API_SHAPES = {"vocab": 80, "hidden": 512, "b": 64, "t": 128, "window": 50,
              "pre_b": 128, "pre_batches": 8, "resnet_b": 128,
              "resnet_hw": 224}
#: (c)'s first-batch pretrain losses and center-loss steps against the
#: CPU twin, relative: f32 on both (TF32 off), summation order only
API_TWIN_TOL = 1e-4
#: the four batch-norm wrapper counters (forward and backward of both
#: helpers): 53 BN layers a ResNet-50 step, one launch a direction each
BN_COUNTERS = ("batchnorm_train", "batchnorm_train.bwd",
               "batchnorm_add_act_train", "batchnorm_add_act_train.bwd")


def _bn_launches(launches):
    return sum(launches[k] for k in BN_COUNTERS)


def _clone_params(params, names):
    return {n: {k: a.clone() for k, a in params[n].items()} for n in names}


def _unchanged(params, snapshot):
    """The vertices / layers of ``snapshot`` whose parameters are not
    bit-identical to it now."""
    return [n for n, p in snapshot.items()
            if any(not torch.equal(params[n][k], a) for k, a in p.items())]


class _ScoreRecorder(DataSetIterator):
    """Yields ``batches`` and, after each, keeps the net's ``score_value``
    (a device tensor until the phase reads it)."""

    def __init__(self, net, batches):
        self.net, self.batches, self.scores = net, batches, []

    def __iter__(self):
        for ds in self.batches:
            yield ds
            self.scores.append(self.net.score_value)


def _api_fine_tune(card):
    """(a) the char-RNN fine-tuned under early stopping: layer 0 frozen, a
    new head, rmsprop, batches staged in bf16 on the card by
    AsyncDataSetIterator, LocalFileModelSaver in a temporary directory."""
    s = API_SHAPES
    v, b, t, w = s["vocab"], s["b"], s["t"], s["window"]
    base = MultiLayerNetwork(
        char_rnn_conf(v, hidden=s["hidden"], layers=2,
                      learning_rate=CHARRNN_LR, tbptt_length=w),
        compute_dtype=torch.bfloat16).init()
    host = [_motif_batch(b, t, v, 90 + i) for i in range(6)]
    card_ds = lambda x, y: DataSet(torch.from_numpy(x).cuda().bfloat16(),
                                   torch.from_numpy(y).cuda().bfloat16())
    base.fit([card_ds(*xy) for xy in host[:2]])
    net = (TransferLearning.Builder(base)
           .fine_tune_configuration(FineTuneConfiguration(
               learning_rate=CHARRNN_LR, updater="rmsprop", seed=7))
           .set_feature_extractor(0).remove_output_layer()
           .add_layer(RnnOutputLayer(n_out=v, loss="mcxent",
                                     activation="softmax")).build())
    frozen = _clone_params(net.params, [0])
    moving = _clone_params(net.params, [1])
    n_held = 2
    held = ListDataSetIterator([card_ds(*xy) for xy in host[4:4 + n_held]])
    train = AsyncDataSetIterator(
        ListDataSetIterator([DataSet(*xy) for xy in host[:4]]), prefetch=2,
        stage_dtype=torch.bfloat16)
    tmp = tempfile.mkdtemp(prefix="dl4j_es_")
    try:
        calc = DataSetLossCalculator(held)
        cfg = EarlyStoppingConfiguration(
            score_calculator=calc,
            model_saver=LocalFileModelSaver(tmp,
                                            compute_dtype=torch.bfloat16),
            epoch_terminations=[
                MaxEpochsTerminationCondition(3),
                ScoreImprovementEpochTerminationCondition(patience=1)])
        it0 = net.iteration
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        result = EarlyStoppingTrainer(cfg, net, train).fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        routes = lstm_routes()
        restored = calc.calculate_score(result.best_model)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    windows = net.iteration - it0
    evals = len(result.score_vs_epoch)
    want = 2 * windows + 2 * n_held * evals
    log(f"training API (a) char-RNN fine-tune: {result.termination_reason} "
        f"({result.termination_details}) after {result.total_epochs} "
        f"epochs, best epoch {result.best_model_epoch}, held-out scores "
        f"{ {e: round(x, 5) for e, x in result.score_vs_epoch.items()} }; "
        f"restored best {restored:.6f} vs recorded "
        f"{result.best_model_score:.6f}; {windows} TBPTT windows and "
        f"{evals} evaluations in {wall:.2f}s; B6 launches "
        f"{launches['lstm_recurrence']} (expected {want}), routes {routes}")
    if _unchanged(net.params, frozen):
        raise AssertionError("the frozen char-RNN layer 0 changed")
    if any(not torch.equal(net.params[0][k], base.params[0][k])
           for k in net.params[0]):
        raise AssertionError("layer 0 is not an exact copy of the source")
    if not _unchanged(net.params, moving):
        raise AssertionError("layer 1 did not move under fine-tuning")
    if not abs(restored - result.best_model_score) <= \
            TRAIN_LOSS_TOL * abs(result.best_model_score):
        raise AssertionError("the restored best model's held-out score "
                             "differs from the recorded best")
    if windows != -(-t // w) * 4 * result.total_epochs or \
            launches["lstm_recurrence"] != want or \
            routes["cluster"] != want:
        raise AssertionError(f"B6 launched {launches['lstm_recurrence']} "
                             f"times ({routes}) for {windows} windows and "
                             f"{evals} evaluations, expected {want} on the "
                             "cluster route")
    return launches["lstm_recurrence"], wall / windows * 1e3


def _seq_graph_conf():
    """DL4J's addition-RNN shape: a GravesLSTM encoder over a masked
    one-hot sequence, its last present step duplicated over the decoder
    input's time axis and merged with it, a GravesLSTM decoder and a
    softmax head."""
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    s = API_SHAPES
    v, h = s["vocab"], s["hidden"]
    return (NeuralNetConfiguration.Builder().seed(12345)
            .learning_rate(CHARRNN_LR).updater("rmsprop").rms_decay(0.95)
            .weight_init("xavier").graph_builder()
            .add_inputs("encoder_in", "decoder_in")
            .add_layer("encoder", GravesLSTM(n_out=h, activation="tanh"),
                       "encoder_in")
            .add_vertex("last", LastTimeStepVertex(mask_input="encoder_in"),
                        "encoder")
            .add_vertex("dup", DuplicateToTimeSeriesVertex(
                ts_input="decoder_in"), "last", "decoder_in")
            .add_vertex("merge", MergeVertex(), "decoder_in", "dup")
            .add_layer("decoder", GravesLSTM(n_out=h, activation="tanh"),
                       "merge")
            .add_layer("out", RnnOutputLayer(n_out=v, loss="mcxent",
                                             activation="softmax"),
                       "decoder")
            .set_outputs("out")
            .set_input_types(InputType.recurrent(v), InputType.recurrent(v))
            .build())


def _api_seq_graph(card):
    """(b) the encoder / decoder graph, bf16: logits and first-step loss
    against the CPU f32 twin on 2 rows, 1 warm and 4 timed steps."""
    s = API_SHAPES
    v, b, t = s["vocab"], s["b"], s["t"]
    net = ComputationGraph(_seq_graph_conf(),
                           compute_dtype=torch.bfloat16).init()
    enc, _ = _motif_batch(b, t, v, 101)
    dec, y = _motif_batch(b, t, v, 102)
    lengths = np.random.default_rng(103).integers(t // 2, t + 1, b)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    part = lambda a: a[:2]
    twin_ds = MultiDataSet([part(enc), part(dec)], [part(y)],
                           features_masks=[part(mask), None])
    got_l = net.compute_gradient_and_score(twin_ds)[1]
    twin = _cpu_twin(net)
    want_l = twin.compute_gradient_and_score(twin_ds)[1]
    logit_err = _rel_l2(torch.from_numpy(net.output(part(enc),
                                                    part(dec))[0]),
                        torch.from_numpy(twin.output(part(enc),
                                                     part(dec))[0]))
    rel_l = abs(got_l - want_l) / abs(want_l)
    gpu = lambda a: torch.from_numpy(a).cuda()
    ds = MultiDataSet([gpu(enc).bfloat16(), gpu(dec).bfloat16()],
                      [gpu(y).bfloat16()],
                      features_masks=[gpu(mask), None])
    warm, _, _ = train_steps(net, ds, 1)
    losses, wall, launches = train_steps(net, ds, 4)
    step_ms = wall / 4 * 1e3
    log(f"training API (b) sequence graph: first-step loss card bf16 "
        f"{got_l:.6f} vs CPU f32 {want_l:.6f} (rel {rel_l:.3e}, tol "
        f"{TRAIN_LOSS_TOL}); logits rel-L2 {logit_err:.3e} (tol "
        f"{LOGIT_REL_TOL}); losses {[round(x, 4) for x in warm + losses]}; "
        f"{step_ms:.2f} ms per step (B {b}, T {t}, 2 x {s['hidden']}, "
        f"encoder masked); B6 launches in 4 steps "
        f"{launches['lstm_recurrence']}, routes {lstm_routes()}")
    if not (rel_l <= TRAIN_LOSS_TOL and logit_err <= LOGIT_REL_TOL):
        raise AssertionError("the card's sequence graph disagrees with the "
                             "CPU f32 reference")
    if launches["lstm_recurrence"] != 2 * 4 or \
            not np.isfinite(warm + losses).all():
        raise AssertionError("the sequence graph did not run B6 twice a "
                             "step with finite losses")
    return launches["lstm_recurrence"], step_ms


def _digit_batches(n_batches, b, seed):
    """Binary 784-pixel "digits": each of 10 seeded prototypes (20% of
    pixels on) with 10% of its pixels flipped, and one-hot classes."""
    rng = np.random.default_rng(seed)
    protos = rng.random((10, 784)) < 0.2
    out = []
    for _ in range(n_batches):
        cls = rng.integers(0, 10, b)
        x = protos[cls] ^ (rng.random((b, 784)) < 0.1)
        out.append(DataSet(x.astype(np.float32),
                           np.eye(10, dtype=np.float32)[cls]))
    return out


def _api_pretrain(card):
    """(c) layerwise pretrain and the center-loss head, f32, plain torch
    (no kernel of the port runs here): 784 → AutoEncoder(500) → RBM(250)
    → VAE(32) → Output(10) pretrained one epoch over 8 batches of 128 and
    fitted one epoch; 784 → Dense(500) → CenterLossOutputLayer(10) three
    steps; both against the CPU twin."""
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    s = API_SHAPES
    conf = (NeuralNetConfiguration.Builder().seed(42).learning_rate(1e-3)
            .updater("adam").weight_init("xavier").activation("sigmoid")
            .list()
            .layer(AutoEncoder(n_out=500, corruption_level=0.0, loss="mse"))
            .layer(RBM(n_out=250))
            .layer(VariationalAutoencoder(n_out=32,
                                          encoder_layer_sizes=[256],
                                          decoder_layer_sizes=[256],
                                          activation="tanh"))
            .layer(OutputLayer(n_out=10, loss="mcxent",
                               activation="softmax"))
            .set_input_type(InputType.feed_forward(784)).build())
    net = MultiLayerNetwork(conf).init()
    twin = _cpu_twin_mln(net)
    batches = _digit_batches(s["pre_batches"], s["pre_b"], 104)
    rec = _ScoreRecorder(net, batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(rec)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) / len(rec.scores) * 1e3
    scores = np.array([float(x) for x in rec.scores]).reshape(3, -1)
    twin_rec = _ScoreRecorder(twin, batches)
    twin.pretrain(twin_rec)
    twin_scores = np.array([float(x) for x in twin_rec.scores]) \
        .reshape(3, -1)
    t0 = time.perf_counter()
    net.fit(batches)
    fit_loss = float(net.score_value)
    fit_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    first_err = [abs(scores[i, 0] - twin_scores[i, 0]) /
                 abs(twin_scores[i, 0]) for i in range(2)]
    log(f"training API (c) pretrain: losses first → last batch "
        f"{[(round(r[0], 5), round(r[-1], 5)) for r in scores.tolist()]} "
        f"(AutoEncoder, RBM, VAE); first-batch AutoEncoder / RBM vs CPU f32 "
        f"twin rel {first_err[0]:.3e} / {first_err[1]:.3e} (tol "
        f"{API_TWIN_TOL}; the VAE's ε comes from the card's generator); "
        f"{pre_ms:.2f} ms a pretrain step, fit {fit_ms:.2f} ms a step, "
        f"last loss {fit_loss:.4f}")
    if not np.isfinite(scores).all() or not np.isfinite(fit_loss):
        raise AssertionError("a pretrain or fit loss is not finite")
    if not (scores[:, -1] < scores[:, 0]).all():
        raise AssertionError("a pretrained layer's loss did not fall")
    if not max(first_err) <= API_TWIN_TOL:
        raise AssertionError("the first-batch pretrain losses disagree with "
                             "the CPU f32 twin")
    cconf = (NeuralNetConfiguration.Builder().seed(43).learning_rate(0.05)
             .updater("sgd").weight_init("xavier").activation("relu").list()
             .layer(DenseLayer(n_out=500))
             .layer(CenterLossOutputLayer(n_out=10, loss="mcxent",
                                          activation="softmax", alpha=0.1,
                                          lambda_=0.01))
             .set_input_type(InputType.feed_forward(784)).build())
    cnet = MultiLayerNetwork(cconf).init()
    ctwin = _cpu_twin_mln(cnet)
    got, want = [], []
    for ds in batches[:3]:
        cnet._fit_batch(ds)
        ctwin._fit_batch(ds)
        got.append(float(cnet.score_value))
        want.append(float(ctwin.score_value))
    err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    moved = float(cnet.state[1]["centers"].abs().sum())
    log(f"training API (c) center loss: losses {[round(g, 6) for g in got]} "
        f"vs CPU f32 twin {[round(w, 6) for w in want]} (rel {err:.3e}, tol "
        f"{API_TWIN_TOL}); |centers| {moved:.4f}")
    if not (err <= API_TWIN_TOL and moved > 0):
        raise AssertionError("the center-loss head disagrees with the CPU "
                             "twin or its centers did not move")
    return pre_ms


def _api_resnet_transfer(card):
    """(d) ResNet-50 (bf16, B 128) with its trunk frozen below avgpool and
    a new 10-class head: 1 warm and 3 timed steps with every BN on its
    kernels, then GraphTransferLearningHelper's featurize once and
    fit_featurized for 3 epochs."""
    s = API_SHAPES
    b, hw = s["resnet_b"], s["resnet_hw"]
    base = ComputationGraph(resnet50_conf(1000, hw, hw, 3,
                                          updater="nesterovs",
                                          learning_rate=0.1),
                            compute_dtype=torch.bfloat16).init()
    net = (TransferLearning.GraphBuilder(base)
           .fine_tune_configuration(FineTuneConfiguration(learning_rate=0.01))
           .set_feature_extractor("avgpool")
           .remove_vertex_and_connections("fc")
           .add_layer("new_fc", OutputLayer(n_out=10, loss="mcxent",
                                            activation="softmax"), "avgpool")
           .set_outputs("new_fc").build())
    del base
    frozen = _clone_params(net.params, sorted(net.frozen_vertices))
    x, y = _images(b, hw, 3, 10, 105)
    ds = DataSet(x, y)
    warm, _, _ = train_steps(net, ds, 1)
    losses, wall, launches = train_steps(net, ds, 3)
    step_ms = wall / 3 * 1e3
    changed = _unchanged(net.params, frozen)
    bn = _bn_launches(launches)
    helper = GraphTransferLearningHelper(net)
    before = _clone_params(net.params, list(net.params))
    t0 = time.perf_counter()
    feat = helper.featurize(ds)
    helper.fit_featurized(feat, num_epochs=3)
    torch.cuda.synchronize()
    helper_s = time.perf_counter() - t0
    moved = _unchanged(net.params, before)
    log(f"training API (d) ResNet-50 transfer [{card}]: {step_ms:.2f} ms "
        f"per step (B {b}, {hw} x {hw}, bf16, trunk frozen below avgpool, "
        f"{len(frozen)} frozen vertices); losses "
        f"{[round(v, 4) for v in warm + losses]}; batch-norm launches in 3 "
        f"steps {bn} ({ {k: launches[k] for k in BN_COUNTERS} }); frozen "
        f"vertices changed: {changed}; featurize + 3 fit_featurized epochs "
        f"{helper_s:.2f}s (features {feat.features[0].shape}), vertices "
        f"moved {moved}")
    if changed:
        raise AssertionError(f"frozen ResNet-50 vertices changed: {changed}")
    if bn != 106 * 3:
        raise AssertionError(f"{bn} batch-norm launches in 3 steps, "
                             f"expected {106 * 3}")
    if moved != ["new_fc"] or not np.isfinite(warm + losses).all():
        raise AssertionError(f"fit_featurized moved {moved}, expected only "
                             "new_fc")
    return launches, step_ms


def phase_training_api(card):
    """Phase 13: the training API of queue A1 and A11 at full width,
    (a)–(d) in turn within TRAINING_API_LIMIT_S. Returns the phase's
    launches of B6 and of the batch-norm counters."""
    t_phase = time.perf_counter()
    lstm_a, window_ms = _api_fine_tune(card)
    lstm_b, seq_ms = _api_seq_graph(card)
    pre_ms = _api_pretrain(card)
    resnet, resnet_ms = _api_resnet_transfer(card)
    wall = time.perf_counter() - t_phase
    log(f"training API [{card}]: char-RNN fine-tune {window_ms:.2f} ms a "
        f"TBPTT window (scoring included), B6 {lstm_a}; sequence graph "
        f"{seq_ms:.2f} ms a step, B6 {lstm_b}; pretrain {pre_ms:.2f} ms a "
        f"step (plain torch, no kernel); ResNet-50 transfer {resnet_ms:.2f} "
        f"ms a step, batch-norm launches {_bn_launches(resnet)}")
    log(f"training API phase: {wall:.1f}s wall (limit "
        f"{TRAINING_API_LIMIT_S} s)")
    if wall > TRAINING_API_LIMIT_S:
        raise AssertionError(f"the training API phase took {wall:.1f}s")
    out = {"lstm_recurrence": lstm_a + lstm_b}
    out.update({k: resnet[k] for k in BN_COUNTERS})
    return out


# ---------------------------------------------------------------- phase 14
#: the data-parallel phase's wall-clock budget, s
DP_PHASE_LIMIT_S = 120
#: the f32 twin's runs against solo steps: (trainer, data shards, rows)
DP_TWIN_RUNS = [("graph", 2, 8), ("graph", 4, 8), ("wrapper", 2, 8),
                ("wrapper", 4, 8), ("graph", 4, 6), ("wrapper", 4, 6)]
#: f32 sync DP against solo steps (TF32 off): each step's loss (relative)
#: and the parameters after 2 steps (relative L2); the shards' sums only
#: reorder the batch's
DP_LOSS_REL, DP_PARAM_REL = 1e-6, 1e-5
#: bf16 sync DP: data shards, global rows, warm and timed steps
DP_BF16_DATA, DP_BF16_B, DP_WARM, DP_TIMED = (2, 4), 32, 2, 4
#: the compressed local-steps round's threshold: above one adam step's
#: per-element move (lr 3e-4), below two in one direction
DP_THRESHOLD = 5e-4
DP_COUNTERS = ("shortseq_attention", "shortseq_attention_bwd",
               "lstm_recurrence")


def _dp_conf(model):
    return transformer_lm_conf(vocab_size=model["vocab"],
                               d_model=model["d_model"],
                               num_heads=model["num_heads"],
                               num_layers=model["num_layers"],
                               max_length=model["t"], learning_rate=3e-4)


def _lm_ds(model, b, seed):
    x, y = lm_batch_sparse(np.random.default_rng(seed).integers(
        0, model["vocab"], (b, model["t"] + 1)))
    return DataSet(x, y)


def _dp_step(kind, net, data, dev, **kw):
    """One step function of ``net`` over ``data`` shards on ``dev``:
    GraphDataParallelTrainer.fit_batch, or ParallelWrapper.fit."""
    mesh = make_mesh(devices=[dev] * data)
    if kind == "graph":
        return GraphDataParallelTrainer(net, mesh=mesh).fit_batch
    pw = ParallelWrapper(net, mesh=mesh, **kw)
    return lambda ds: pw.fit([ds])


def _tree_rel_l2(got, want):
    """Relative L2 of every tensor of ``got`` against ``want`` (f64, on
    their device)."""
    num = den = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        num += float(((g.double() - w.double()) ** 2).sum())
        den += float((w.double() ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def _count(total, launches):
    for name in DP_COUNTERS:
        total[name] += launches[name]


def _dp_f32_twin(dev, model, on_card, total):
    """(1) f32, TF32 off: every DP_TWIN_RUNS run's 2 steps against 2 solo
    fit_batch steps from the same weights."""
    base = ComputationGraph(_dp_conf(model), device=dev).init()
    batches = {b: [_lm_ds(model, b, 100 + b + s) for s in range(2)]
               for b in {b for _, _, b in DP_TWIN_RUNS}}
    refs = {}
    for b, dss in batches.items():
        solo = base.clone()
        losses = []
        for ds in dss:
            solo.fit_batch(ds)
            losses.append(float(solo.score_value))
        refs[b] = (solo.params, losses)
    layers = model["num_layers"]
    for kind, data, b in DP_TWIN_RUNS:
        net = base.clone()
        step = _dp_step(kind, net, data, dev)
        _sync()
        reset_launches()
        losses = []
        for ds in batches[b]:
            step(ds)
            losses.append(float(net.score_value))
        _sync()
        launches = read_launches()
        _count(total, launches)
        want_p, want_l = refs[b]
        rel_l = max(abs(g - w) / abs(w) for g, w in zip(losses, want_l))
        rel_p = _tree_rel_l2(net.params, want_p)
        b1, b2 = (launches[n] for n in DP_COUNTERS[:2])
        log(f"data-parallel f32 {kind} data {data} B {b}: losses "
            f"{losses} vs solo {want_l} (max rel {rel_l:.3e}, tol "
            f"{DP_LOSS_REL}); params rel-L2 {rel_p:.3e} (tol "
            f"{DP_PARAM_REL}); B1 {b1}, B2 {b2}")
        if rel_l > DP_LOSS_REL or rel_p > DP_PARAM_REL:
            raise AssertionError(f"f32 {kind} DP at data {data}, B {b} "
                                 "disagrees with the solo steps")
        want = layers * data * 2 if on_card else 0
        if (b1, b2) != (want, want):
            raise AssertionError(f"{kind} DP at data {data}: B1 {b1}, B2 "
                                 f"{b2} in 2 steps, expected {want} each")
        del net, step
    del base, refs


def _dp_bf16(card, dev, model, on_card, total):
    """(1) bf16, global B 32: solo, then each DP_BF16_DATA mesh, DP_WARM
    + DP_TIMED steps each."""
    base = ComputationGraph(_dp_conf(model), compute_dtype=torch.bfloat16,
                            device=dev).init()
    ds = _lm_ds(model, DP_BF16_B, 13)
    layers = model["num_layers"]
    runs = [("solo", 1)] + [("graph", d) for d in DP_BF16_DATA]
    first, ms = {}, {}
    for kind, data in runs:
        net = base.clone()
        step = net.fit_batch if kind == "solo" else \
            _dp_step(kind, net, data, dev)
        warm, _, w_launch = train_steps(net, ds, DP_WARM, step)
        losses, wall, t_launch = train_steps(net, ds, DP_TIMED, step)
        ms[data] = wall / DP_TIMED * 1e3
        first[data] = warm[0]
        losses = warm + losses
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"bf16 DP at data {data}: loss not "
                                 f"finite and falling: {losses}")
        if kind == "solo":
            continue
        _count(total, w_launch)
        _count(total, t_launch)
        b1 = w_launch["shortseq_attention"] + t_launch["shortseq_attention"]
        b2 = w_launch["shortseq_attention_bwd"] + \
            t_launch["shortseq_attention_bwd"]
        want = layers * data * (DP_WARM + DP_TIMED) if on_card else 0
        rel = abs(first[data] - first[1]) / abs(first[1])
        log(f"data-parallel bf16 data {data} [{card}]: losses "
            f"{[round(x, 4) for x in losses]}; first-step loss rel "
            f"{rel:.3e} to solo (tol {TRAIN_LOSS_TOL}); B1 {b1}, B2 {b2} "
            f"(expected {want} each); {ms[data]:.2f} ms per step against "
            f"solo {ms[1]:.2f} ms (B {DP_BF16_B}, T {model['t']}; one "
            f"card: host dispatch over the shards, not scaling)")
        if rel > TRAIN_LOSS_TOL or (b1, b2) != (want, want):
            raise AssertionError(f"bf16 DP at data {data} failed its "
                                 "checks")
        del net, step
    return base, ds


def _replicas_equal(pw):
    r0 = pw._replicas[0]
    return all(torch.equal(a, b) for r in pw._replicas[1:]
               for t0, t in ((r0.params, r.params),
                             (r0.updater_state, r.updater_state),
                             (r0.state, r.state))
               for a, b in zip(tree_leaves(t0), tree_leaves(t)))


def _dp_local_steps(base, dev, model, on_card, total):
    """(2) local steps on the bf16 net: data 2, k 2, 2 rounds; then one
    compressed round."""
    ds_b = _lm_ds(model, DP_BF16_B, 14)
    ds_a = _lm_ds(model, DP_BF16_B, 13)
    net = base.clone()
    pw = ParallelWrapper(net, mesh=make_mesh(devices=[dev] * 2),
                         averaging_frequency=2)
    _sync()
    reset_launches()
    scores = []
    for _ in range(2):
        pw.fit([ds_a, ds_b])
        scores.append(float(net.score_value))
        if not _replicas_equal(pw):
            raise AssertionError("local-steps replicas differ after a "
                                 "round")
    _sync()
    launches = read_launches()
    _count(total, launches)
    b1, b2 = launches["shortseq_attention"], \
        launches["shortseq_attention_bwd"]
    want = model["num_layers"] * 2 * 2 * 2 if on_card else 0
    comp = ParallelWrapper(base.clone(), mesh=make_mesh(devices=[dev] * 2),
                           averaging_frequency=2,
                           gradient_compression=DP_THRESHOLD)
    reset_launches()
    comp.fit([ds_a, ds_b])
    _sync()
    _count(total, read_launches())
    frac = float(comp.last_sent_fraction)
    log(f"data-parallel local steps (data 2, k 2, bf16): round scores "
        f"{scores}, replicas bitwise equal after each round; B1 {b1}, B2 "
        f"{b2} (expected {want} each); compressed round (threshold "
        f"{DP_THRESHOLD}) sent fraction {frac:.6f}")
    if not (np.isfinite(scores).all() and scores[1] < scores[0]):
        raise AssertionError(f"local-steps loss not falling: {scores}")
    if (b1, b2) != (want, want) or not 0.0 < frac <= 1.0:
        raise AssertionError("local-steps DP failed its checks")


def _small_mln(dev, lstm=False, bn=False, seed=5):
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    b = (NeuralNetConfiguration.Builder().seed(seed)
         .learning_rate(0.05 if lstm else 0.1).updater("sgd")
         .weight_init("xavier").activation("tanh").list())
    if lstm:
        b = b.layer(LSTM(n_out=32, activation="tanh")).layer(
            RnnOutputLayer(n_out=4, loss="mcxent", activation="softmax"))
        it = InputType.recurrent(8)
    else:
        b = b.layer(DenseLayer(n_out=64))
        if bn:
            b = b.layer(BatchNormalization())
        b = b.layer(OutputLayer(n_out=4, loss="mcxent",
                                activation="softmax"))
        it = InputType.feed_forward(16)
    return MultiLayerNetwork(b.set_input_type(it).build(),
                             device=dev).init()


def _small_batches(n, b=32, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(b, 16)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[(np.abs(x).sum(1) * 2).astype(int)
                                        % 4]
        out.append(DataSet(x, y))
    return out


def _dp_masked_lstm(dev, total, on_card):
    """(3) the masked LSTM, f32: sync DP at data 2 on a ragged batch
    against a solo step."""
    rng = np.random.default_rng(21)
    n, t = 7, 12
    x = rng.normal(size=(n, t, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (n, t))]
    mask = (np.arange(t)[None] < rng.integers(3, t + 1, n)[:, None]) \
        .astype(np.float32)
    ds = DataSet(x, y, features_mask=mask, labels_mask=mask.copy())
    solo = _small_mln(dev, lstm=True)
    dp = solo.clone()
    solo.fit([ds])
    _sync()
    reset_launches()
    ParallelWrapper(dp, mesh=make_mesh(devices=[dev] * 2)).fit([ds])
    _sync()
    launches = read_launches()
    _count(total, launches)
    rel = _tree_rel_l2(dp.params, solo.params)
    b6 = launches["lstm_recurrence"]
    want = 2 if on_card else 0
    log(f"data-parallel masked LSTM (f32, data 2, 7 rows): params rel-L2 "
        f"{rel:.3e} to solo (tol {DP_PARAM_REL}); B6 {b6} (expected "
        f"{want}: one a shard)")
    if rel > DP_PARAM_REL or b6 != want:
        raise AssertionError("masked LSTM DP failed its checks")


def _dp_batch_norm(dev, total):
    """(4) sync DP over 2 shards of a net with a batch norm (f32): the
    whole batch's statistics, against a solo step."""
    solo = _small_mln(dev, bn=True)
    dp = solo.clone()
    batches = _small_batches(1)
    solo.fit(batches)
    _sync()
    reset_launches()
    ParallelWrapper(dp, mesh=make_mesh(devices=[dev] * 2)).fit(batches)
    _sync()
    xs = {k: v for k, v in read_launches().items()
          if k.startswith("batchnorm_xs")}
    for k, v in xs.items():
        total[k] = total.get(k, 0) + v
    rel = _tree_rel_l2(dp.params, solo.params)
    rel_s = _tree_rel_l2(dp.state, solo.state)
    log(f"data-parallel batch norm (f32, data 2): params rel-L2 {rel:.3e}, "
        f"running statistics rel-L2 {rel_s:.3e} to solo (tol "
        f"{DP_PARAM_REL}); cross-shard BN launches {xs}")
    if rel > DP_PARAM_REL or rel_s > DP_PARAM_REL:
        raise AssertionError("batch-norm DP disagrees with the solo step")


def _falls(before, after, what):
    log(f"{what}: held-out loss {before:.4f} -> {after:.4f}")
    if not (np.isfinite(after) and after < before):
        raise AssertionError(f"{what}: loss did not fall")


def _dp_tools(dev):
    """(5) the parameter servers (native), early stopping, the CLI and the
    cluster master, each on a small net on ``dev``."""
    batches, held = _small_batches(16), _small_batches(4, seed=4)
    score = lambda net: float(np.mean([net.score(d) for d in held]))
    net = _small_mln(dev)
    s0 = score(net)
    ps = ParameterServerParallelWrapper(net, num_workers=2,
                                        backend="native")
    ps.fit(batches, num_epochs=2)
    if ps.backend != "native" or \
            not isinstance(ps.server, NativeParameterServer) or \
            ps.server.pushes < len(batches):
        raise AssertionError(f"parameter server: backend {ps.backend}, "
                             f"{ps.server.pushes} pushes")
    _falls(s0, score(net), f"native parameter server (2 workers, "
           f"{ps.server.pushes} pushes for {2 * len(batches)} batches)")
    ps.server.shutdown()

    net = _small_mln(dev)
    s0 = score(net)
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(held),
        epoch_terminations=[MaxEpochsTerminationCondition(3)])
    result = EarlyStoppingParallelTrainer(
        cfg, net, batches, mesh=make_mesh(devices=[dev] * 2)).fit()
    _falls(s0, result.best_model_score,
           f"EarlyStoppingParallelTrainer ({result.total_epochs} epochs, "
           f"{result.termination_reason})")

    net = _small_mln(dev)
    s0 = score(net)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model.zip"
        ModelSerializer.write_model(net, path)
        mod = type(sys)("_dp_cli_factory")
        mod.make_iterator = lambda: ListDataSetIterator(batches)
        sys.modules["_dp_cli_factory"] = mod
        rc = dp_main(["--model-path", path, "--iterator-factory",
                      "_dp_cli_factory:make_iterator", "--workers", "2",
                      "--epochs", "2", "--device", str(dev)])
        trained = ModelSerializer.restore_multi_layer_network(path,
                                                              device=dev)
    if rc != 0 or trained.iteration != 2 * len(batches):
        raise AssertionError(f"the CLI: rc {rc}, iteration "
                             f"{trained.iteration}")
    _falls(s0, score(trained), "the CLI (--workers 2, 2 epochs)")

    net = _small_mln(dev)
    s0 = score(net)
    rdd = DistributedDataSet.from_datasets(batches, num_partitions=2,
                                           num_executors=2)
    ClusterDl4jMultiLayer(net, ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=2)).fit(rdd, num_epochs=3)
    _falls(s0, score(net), "ClusterDl4jMultiLayer (2 executors, 3 "
           "epochs)")


def phase_data_parallel(card, device=None, model=None):
    """Phase 14: data-parallel training of the flagship LM and the scale-out
    tools (module docstring). ``device`` / ``model`` let the phase be
    rehearsed on the CPU at a small width. Returns the phase's B1, B2 and
    B6 launches and its cross-shard batch-norm launches by phase."""
    t_phase = time.perf_counter()
    on_card = device is None
    dev = torch.device(device or "cuda:0")
    model = dict(model or {"vocab": 32000, "d_model": 768, "num_heads": 12,
                           "num_layers": 12, "t": 512})
    total = dict.fromkeys(DP_COUNTERS, 0)
    _dp_f32_twin(dev, model, on_card, total)
    base, _ = _dp_bf16(card, dev, model, on_card, total)
    _dp_local_steps(base, dev, model, on_card, total)
    del base
    _dp_masked_lstm(dev, total, on_card)
    _dp_batch_norm(dev, total)
    _dp_tools(dev)
    wall = time.perf_counter() - t_phase
    log(f"data-parallel phase: launches {total}; {wall:.1f}s wall (limit "
        f"{DP_PHASE_LIMIT_S} s)")
    if wall > DP_PHASE_LIMIT_S:
        raise AssertionError(f"the data-parallel phase took {wall:.1f}s")
    return total


# ---------------------------------------------------------------- phase 15
MP_PHASE_LIMIT_S = 120
#: the flagship's sequence-parallel meshes: (data, sp)
SP_MESHES = [(1, 2), (1, 4), (2, 2)]
#: f32 twin rows, bf16 rows, warm and timed bf16 steps a mesh
SP_TWIN_B, SP_BF16_B, SP_WARM, SP_TIMED = 4, 8, 1, 3
#: the long-context run: the flagship's width at 2 layers, T 2048, sp 4
SP_LONG = {"num_layers": 2, "t": 2048, "b": 4, "sp": 4}
#: f32 sequence-parallel steps against solo steps (TF32 off): each step's
#: loss (relative) and the parameters after 2 adam steps (relative L2).
#: The ring merges each query chunk's pair partials, so attention sums
#: in another order than the solo kernels; adam then moves the elements
#: whose gradient is near zero by up to lr in a direction that order
#: decides
SP_LOSS_REL, SP_PARAM_REL = 1e-5, 1e-4
#: the kernels the phase counts, and the cross-shard batch norm's counters
MP_COUNTERS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv",
               "shortseq_attention", "shortseq_attention_bwd")
RING_KERNELS = MP_COUNTERS[:3]
XS_PHASES = ("batchnorm_xs_stats", "batchnorm_xs_finalize",
             "batchnorm_xs_apply")
#: ResNet-50 under sync DP at data 2: global rows, the f32 twin's rows
RESNET_DP_B, RESNET_DP_TWIN_B = 128, 8
#: the f32 twin's step against the solo step: the parameters' difference
#: relative to the solo step's update (|p_dp - p_solo| / |p_solo - p_0|),
#: at phase 11's gradient bar, and the running statistics (relative L2).
#: The batch statistics are one-pass sums about the running mean, 0 at the
#: first step: the variance keeps f32's rounding of Σx² times (mean /
#: std)², so another order of the sums (two shards' partials, or the
#: batch's rows reversed, the witness below) moves a few % of ResNet-50's
#: first update at lr 0.1; in f64 the two-shard step equals the solo step
#: to 1e-12 of it (``tests/test_torch_scaleout.py``)
RESNET_DP_UPDATE_REL, RESNET_DP_STATE_REL = TRAIN_GRAD_TOL, 1e-4
#: the dense parities of TP / EP / PP / the small nets on the card (f32,
#: TF32 off): relative L2 of the parameters after 2 steps against the
#: unsharded run; the shards sum their partial products in another order
MP_PARAM_REL = 1e-5


def _xs_launches(launches):
    return {k: launches[k] for k in launches if k.startswith(
        "batchnorm_xs")}


def _count_mp(total, launches):
    for name in MP_COUNTERS + tuple(
            f"{p}{s}" for p in XS_PHASES for s in ("", ".bwd")):
        total[name] = total.get(name, 0) + launches[name]


def _sp_trainer(net, data, sp, dev):
    mesh = make_mesh(axis_names=("data", "sp"), shape=(data, sp),
                     devices=[dev] * (data * sp))
    return GraphSequenceParallelTrainer(
        net, mesh=mesh, data_axis="data" if data > 1 else None)


def _ring_want(layers, data, sp, steps, on_card):
    """B3 / B4 / B5 launches of ``steps`` sequence-parallel steps: each
    layer's causal ring runs sp(sp+1)/2 pairs a data group."""
    return layers * data * sp * (sp + 1) // 2 * steps if on_card else 0


def _check_ring_launches(launches, want, what):
    got = {k: launches[k] for k in MP_COUNTERS}
    expect = {k: want if k in RING_KERNELS else 0 for k in MP_COUNTERS}
    if got != expect:
        raise AssertionError(f"{what}: launches {got}, expected {expect}")
    return got


def _mp_sp_f32(dev, model, on_card, total):
    """(1) the flagship's f32 twin (TF32 off): 2 steps on each SP_MESHES
    mesh against 2 solo fit_batch steps from the same weights."""
    base = ComputationGraph(_dp_conf(model), device=dev).init()
    dss = [_lm_ds(model, SP_TWIN_B, 300 + s) for s in range(2)]
    solo = base.clone()
    want_l = []
    for ds in dss:
        solo.fit_batch(ds)
        want_l.append(float(solo.score_value))
    for data, sp in SP_MESHES:
        net = base.clone()
        with _sp_trainer(net, data, sp, dev) as tr:
            _sync()
            reset_launches()
            losses = []
            for ds in dss:
                tr.fit_batch(ds)
                losses.append(float(net.score_value))
            _sync()
            launches = read_launches()
        _count_mp(total, launches)
        rel_l = max(abs(g - w) / abs(w) for g, w in zip(losses, want_l))
        rel_p = _tree_rel_l2(net.params, solo.params)
        got = _check_ring_launches(
            launches, _ring_want(model["num_layers"], data, sp, 2, on_card),
            f"f32 SP at data {data}, sp {sp}")
        log(f"sequence-parallel f32 (data {data}, sp {sp}, B {SP_TWIN_B}, "
            f"T {model['t']}): losses {losses} vs solo {want_l} (max rel "
            f"{rel_l:.3e}, tol {SP_LOSS_REL}); params rel-L2 {rel_p:.3e} "
            f"(tol {SP_PARAM_REL}); launches in 2 steps {got}")
        if rel_l > SP_LOSS_REL or rel_p > SP_PARAM_REL:
            raise AssertionError(f"f32 SP at data {data}, sp {sp} "
                                 "disagrees with the solo steps")
        del net
    del base, solo


def _mp_sp_bf16(card, dev, model, on_card, total, b=SP_BF16_B,
                meshes=SP_MESHES, what="flagship"):
    """bf16: the solo step, then each mesh, SP_WARM + SP_TIMED steps:
    the first-step loss against the solo step's, the ring's launches, ms
    a step beside the solo step's."""
    base = ComputationGraph(_dp_conf(model), compute_dtype=torch.bfloat16,
                            device=dev).init()
    ds = _lm_ds(model, b, 17)
    first, ms = {}, {}
    for data, sp in [(1, 1)] + list(meshes):
        net = base.clone()
        tr = None if sp == 1 else _sp_trainer(net, data, sp, dev)
        step = net.fit_batch if tr is None else tr.fit_batch
        warm, _, w_l = train_steps(net, ds, SP_WARM, step)
        losses, wall, t_l = train_steps(net, ds, SP_TIMED, step)
        if tr is not None:
            tr.close()
        ms[(data, sp)] = wall / SP_TIMED * 1e3
        first[(data, sp)] = warm[0]
        if not np.isfinite(warm + losses).all():
            raise AssertionError(f"bf16 SP {what} at {data}x{sp}: loss not "
                                 f"finite: {warm + losses}")
        if tr is None:
            continue
        launches = {k: w_l[k] + t_l[k] for k in w_l}
        _count_mp(total, launches)
        got = _check_ring_launches(
            launches, _ring_want(model["num_layers"], data, sp,
                                 SP_WARM + SP_TIMED, on_card),
            f"bf16 SP {what} at {data}x{sp}")
        rel = abs(first[(data, sp)] - first[(1, 1)]) / abs(first[(1, 1)])
        log(f"sequence-parallel bf16 {what} (data {data}, sp {sp}, B {b}, "
            f"T {model['t']}) [{card}]: losses "
            f"{[round(x, 4) for x in warm + losses]}; first-step loss rel "
            f"{rel:.3e} to solo (tol {TRAIN_LOSS_TOL}); launches {got}; "
            f"{ms[(data, sp)]:.2f} ms a step against solo "
            f"{ms[(1, 1)]:.2f} ms (one card: the shards' operators in "
            f"turn, not scaling)")
        if rel > TRAIN_LOSS_TOL:
            raise AssertionError(f"bf16 SP {what} at {data}x{sp}: first "
                                 "step disagrees with the solo step")
        del net
    del base
    return ms


def _mp_resnet(card, dev, on_card, total, conf_fn=None, b=RESNET_DP_B,
               twin_b=RESNET_DP_TWIN_B, hw=224):
    """(2) ResNet-50 under sync DP at data 2, every batch norm across the
    shards: the f32 twin (B twin_b) against a solo step's parameters and
    running statistics, then bf16 at global B b against the solo step's
    first loss and running statistics, the BN phases' launches counted,
    ms a step beside the solo step's."""
    conf_fn = conf_fn or (lambda: resnet50_conf(
        1000, hw, hw, 3, updater="nesterovs", learning_rate=0.1))
    mesh = make_mesh(devices=[dev] * 2)
    n_bn = sum(1 for v in conf_fn().vertices.values()
               if isinstance(getattr(v, "layer", None), BatchNormalization))
    # f32 twin, TF32 off
    base = ComputationGraph(conf_fn(), device=dev).init()
    x, y = _images_on(dev, twin_b, hw, 3, 1000, 41)
    solo, dp, unfused, rev = (base.clone() for _ in range(4))
    solo.fit_batch(DataSet(x, y))
    GraphDataParallelTrainer(dp, mesh=mesh).fit_batch(DataSet(x, y))
    # two witnesses, solo steps of the same arithmetic in another f32
    # order: an empty fusion plan (the BN -> add -> act tails vertex by
    # vertex; the statistics' sums unchanged), and the batch's rows
    # reversed (the statistics summed in another order)
    unfused._fusion = ({}, set())
    unfused.fit_batch(DataSet(x, y))
    rows = torch.arange(twin_b - 1, -1, -1, device=x.device)
    rev.fit_batch(DataSet(x[rows], y[rows]))
    step = _tree_norm(_tree_diff(solo.params, base.params))
    of_update = lambda net: _tree_rel_l2(net.params, solo.params) * \
        _tree_norm(solo.params) / step
    upd = of_update(dp)
    rel_s = _tree_rel_l2(dp.state, solo.state)
    log(f"ResNet-50 sync DP f32 (data 2, B {twin_b}): parameters' "
        f"difference {upd:.3e} of the solo step's update (tol "
        f"{RESNET_DP_UPDATE_REL}; solo steps against the solo step: "
        f"unfused {of_update(unfused):.3e}, rows reversed "
        f"{of_update(rev):.3e}), running statistics rel-L2 {rel_s:.3e} "
        f"(tol {RESNET_DP_STATE_REL}); losses "
        f"{float(dp.score_value):.6f} vs {float(solo.score_value):.6f}")
    if upd > RESNET_DP_UPDATE_REL or rel_s > RESNET_DP_STATE_REL:
        raise AssertionError("f32 ResNet-50 DP disagrees with the solo "
                             "step")
    del base, solo, dp, unfused, rev
    # bf16 at global B
    base = ComputationGraph(conf_fn(), compute_dtype=torch.bfloat16,
                            device=dev).init()
    x, y = _images_on(dev, b, hw, 3, 1000, 42)
    ds = DataSet(x, y)
    runs, first, ms, states = {}, {}, {}, {}
    for kind in ("solo", "dp"):
        net = base.clone()
        step = net.fit_batch if kind == "solo" else \
            GraphDataParallelTrainer(net, mesh=mesh).fit_batch
        warm, _, w_l = train_steps(net, ds, 1, step)
        states[kind] = copy.deepcopy(net.state)
        losses, wall, t_l = train_steps(net, ds, 2, step)
        first[kind], ms[kind] = warm[0], wall / 2 * 1e3
        runs[kind] = {k: w_l[k] + t_l[k] for k in w_l}
        if not np.isfinite(warm + losses).all():
            raise AssertionError(f"bf16 ResNet-50 {kind}: loss not finite")
        del net
    launches = runs["dp"]
    _count_mp(total, launches)
    xs = _xs_launches(launches)
    want = {f"{p}{s}": n_bn * 3 * (1 if "finalize" in p else 2)
            for p in XS_PHASES for s in ("", ".bwd")} if on_card else \
        dict.fromkeys(xs, 0)
    fused = {k: launches[k] for k in launches if k.startswith(
        "batchnorm_train") or k.startswith("batchnorm_add_act")}
    rel = abs(first["dp"] - first["solo"]) / abs(first["solo"])
    rel_s = _tree_rel_l2(states["dp"], states["solo"])
    log(f"ResNet-50 sync DP bf16 (data 2, global B {b}) [{card}]: "
        f"first-step loss {first['dp']:.5f} vs solo {first['solo']:.5f} "
        f"(rel {rel:.3e}, tol {TRAIN_LOSS_TOL}); running statistics after "
        f"it rel-L2 {rel_s:.3e} (tol {RESNET_STATE_TOL}); cross-shard BN "
        f"launches in 3 steps {xs} (expected {want}); single-shard BN "
        f"kernels {fused}; {ms['dp']:.2f} ms a step against solo "
        f"{ms['solo']:.2f} ms")
    if rel > TRAIN_LOSS_TOL or rel_s > RESNET_STATE_TOL or xs != want or \
            any(fused.values()):
        raise AssertionError("bf16 ResNet-50 DP failed its checks")
    del base
    return ms


def _tree_norm(tree):
    return sum(float((a.double() ** 2).sum())
               for a in tree_leaves(tree)) ** 0.5


def _tree_diff(a, b):
    return [x - y for x, y in zip(tree_leaves(a), tree_leaves(b))]


def _images_on(dev, b, hw, c, classes, seed):
    if dev.type == "cuda":
        return _images(b, hw, c, classes, seed)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, hw, hw, c, generator=g)
    lab = torch.randint(0, classes, (b,), generator=g)
    return x, torch.nn.functional.one_hot(lab, classes).float()


def _mp_center_loss(dev, total):
    """(2) a center-loss head (after a batch norm) under sync DP at data
    2 against a solo step: parameters, running statistics and centers."""
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    conf = (NeuralNetConfiguration.Builder().seed(8).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").activation("tanh").list()
            .layer(DenseLayer(n_out=64)).layer(BatchNormalization())
            .layer(CenterLossOutputLayer(n_out=4, loss="mcxent",
                                         activation="softmax", alpha=0.3,
                                         lambda_=0.5))
            .set_input_type(InputType.feed_forward(16)).build())
    solo = MultiLayerNetwork(conf, device=dev).init()
    dp = solo.clone()
    batches = _small_batches(2, b=64, seed=9)
    solo.fit(batches)
    _sync()
    reset_launches()
    ParallelWrapper(dp, mesh=make_mesh(devices=[dev] * 2)).fit(batches)
    _sync()
    launches = read_launches()
    _count_mp(total, launches)
    rel_p = _tree_rel_l2(dp.params, solo.params)
    rel_s = _tree_rel_l2(dp.state, solo.state)
    log(f"center-loss head + batch norm under sync DP (data 2, f32, 2 "
        f"steps of 64): params rel-L2 {rel_p:.3e}, state (running "
        f"statistics, centers) rel-L2 {rel_s:.3e} (tol {MP_PARAM_REL}); "
        f"cross-shard BN launches {_xs_launches(launches)}")
    if rel_p > MP_PARAM_REL or rel_s > MP_PARAM_REL:
        raise AssertionError("center-loss DP disagrees with the solo steps")


def _timed_steps(step, ds, steps=2):
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(ds)
    _sync()
    return (time.perf_counter() - t0) / steps * 1e3


def _mp_tp(card, dev):
    """(3) TensorParallelTrainer on LeNet (f32, B 128) at (1, 2) and (2,
    2), 2 steps, against 2 solo steps; then ms a step each."""
    base = MultiLayerNetwork(lenet_conf(), device=dev).init()
    x, y = _images_on(dev, 128, 28, 1, 10, 51)
    ds = DataSet(x, y)
    solo = base.clone()
    for _ in range(2):
        solo._fit_batch(ds)
    solo_ms = _timed_steps(base.clone()._fit_batch, ds)
    for shape in ((1, 2), (2, 2)):
        net = base.clone()
        mesh = make_mesh(axis_names=("data", "model"), shape=shape,
                         devices=[dev] * (shape[0] * shape[1]))
        tr = TensorParallelTrainer(net, mesh)
        for _ in range(2):
            tr.fit_batch(ds)
        rel = _tree_rel_l2(net.params, solo.params)
        local = tuple(tr.params[0]["W"].local((0, 1)).shape)
        ms = _timed_steps(tr.fit_batch, ds)
        log(f"tensor-parallel LeNet (data {shape[0]}, model {shape[1]}, "
            f"f32, B 128) [{card}]: params rel-L2 {rel:.3e} to the solo "
            f"steps (tol {MP_PARAM_REL}); conv0 W local {local}; "
            f"{ms:.2f} ms a step against solo {solo_ms:.2f} ms")
        if rel > MP_PARAM_REL or local != (5, 5, 1, 20 // shape[1]):
            raise AssertionError(f"TP LeNet at {shape} failed its checks")


def _moe_net(dev):
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    conf = (NeuralNetConfiguration.Builder().seed(12).learning_rate(0.05)
            .updater("sgd").weight_init("xavier").list()
            .layer(MixtureOfExpertsLayer(n_out=768, num_experts=8,
                                         expert_hidden=3072,
                                         activation="relu"))
            .layer(OutputLayer(n_out=16, loss="mcxent",
                               activation="softmax"))
            .set_input_type(InputType.feed_forward(768)).build())
    return MultiLayerNetwork(conf, device=dev).init()


def _mp_ep(card, dev):
    """(4) ExpertParallelTrainer on a Switch MoE (d 768, 8 experts,
    hidden 3072, 512 tokens, f32) at ep 2 and 4, 2 steps, against the
    unsharded net."""
    base = _moe_net(dev)
    g = torch.Generator(device=dev).manual_seed(61)
    x = torch.randn(512, 768, generator=g, device=dev)
    y = torch.nn.functional.one_hot(torch.randint(
        0, 16, (512,), generator=g, device=dev), 16).float()
    ds = DataSet(x, y)
    solo = base.clone()
    for _ in range(2):
        solo._fit_batch(ds)
    solo_ms = _timed_steps(base.clone()._fit_batch, ds)
    for ep in (2, 4):
        net = base.clone()
        tr = ExpertParallelTrainer(net, make_mesh(
            axis_names=("data", "ep"), shape=(1, ep), devices=[dev] * ep))
        for _ in range(2):
            tr.fit_batch(ds)
        rel = _tree_rel_l2(net.params, solo.params)
        local = tuple(tr.params[0]["We1"].local((0, ep - 1)).shape)
        ms = _timed_steps(tr.fit_batch, ds)
        log(f"expert-parallel MoE (ep {ep}, 8 experts, d 768, hidden 3072, "
            f"512 tokens, f32) [{card}]: params rel-L2 {rel:.3e} to the "
            f"unsharded steps (tol {MP_PARAM_REL}); We1 local {local}; "
            f"{ms:.2f} ms a step against unsharded {solo_ms:.2f} ms")
        if rel > MP_PARAM_REL or local != (8 // ep, 768, 3072):
            raise AssertionError(f"EP at {ep} failed its checks")


def _mp_pp(card, dev):
    """(5) PipelineParallelTrainer: 8 tanh Dense 768 -> 768 blocks and a
    16-class head, pipe 4, M 4, B 256, f32, 2 steps, against the same
    stack on one stage (the sequential stack)."""
    block = DenseLayer(n_in=768, n_out=768, activation="tanh",
                       weight_init="xavier")
    head = OutputLayer(n_in=768, n_out=16, loss="mcxent",
                       activation="softmax", weight_init="xavier")
    piped = PipelineParallelTrainer(
        block, 8, head, mesh=make_mesh(axis_names=("pipe",),
                                       devices=[dev] * 4),
        num_microbatches=4, learning_rate=0.1, seed=7)
    seq = PipelineParallelTrainer(
        block, 8, head, mesh=make_mesh(axis_names=("pipe",), devices=[dev]),
        num_microbatches=4, learning_rate=0.1,
        block_params={k: v.gather().cpu().numpy()
                      for k, v in piped.block_params.items()},
        head_params={k: v.cpu().numpy()
                     for k, v in piped.head_params.items()})
    rng = np.random.default_rng(71)
    x = rng.normal(size=(256, 768)).astype(np.float32)
    y = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 256)]
    ds = DataSet(x, y)
    scores = []
    for _ in range(2):
        piped.fit_batch(ds)
        seq.fit_batch(ds)
        scores.append((float(piped.score_value), float(seq.score_value)))
    rel = _tree_rel_l2({k: v.gather() for k, v in piped.block_params.items()},
                       {k: v.gather() for k, v in seq.block_params.items()})
    ms = _timed_steps(piped.fit_batch, ds)
    seq_ms = _timed_steps(seq.fit_batch, ds)
    local = tuple(piped.block_params["W"].local((3,)).shape)
    log(f"pipeline-parallel (pipe 4, M 4, 8 x Dense 768 tanh, B 256, f32) "
        f"[{card}]: scores {scores}; block params rel-L2 {rel:.3e} to the "
        f"sequential stack (tol {MP_PARAM_REL}); stage 3 W {local}; "
        f"{ms:.2f} ms a step against the sequential stack {seq_ms:.2f} ms")
    if rel > MP_PARAM_REL or local != (2, 768, 768) or any(
            abs(a - b) > 1e-6 * abs(b) for a, b in scores):
        raise AssertionError("PP disagrees with the sequential stack")


def phase_model_parallel(card, device=None, model=None, long=None,
                         resnet_hw=224, resnet_b=RESNET_DP_B):
    """Phase 15: sequence, data-with-batch-norm, tensor, expert and
    pipeline parallelism, every shard on the card (module docstring).
    ``device`` / ``model`` / ``long`` / ``resnet_hw`` / ``resnet_b`` let
    the phase be rehearsed on the CPU at a small size. Returns its
    launches by counter."""
    t_phase = time.perf_counter()
    on_card = device is None
    dev = torch.device(device or "cuda:0")
    model = dict(model or {"vocab": 32000, "d_model": 768, "num_heads": 12,
                           "num_layers": 12, "t": 512})
    long = dict(long or {**model, **{k: SP_LONG[k] for k in
                                     ("num_layers", "t")}})
    total = {}
    _mp_sp_f32(dev, model, on_card, total)
    _mp_sp_bf16(card, dev, model, on_card, total)
    _mp_sp_bf16(card, dev, long, on_card, total, b=SP_LONG["b"],
                meshes=[(1, SP_LONG["sp"])], what="long context")
    _mp_resnet(card, dev, on_card, total, hw=resnet_hw, b=resnet_b)
    _mp_center_loss(dev, total)
    _mp_tp(card, dev)
    _mp_ep(card, dev)
    _mp_pp(card, dev)
    wall = time.perf_counter() - t_phase
    log(f"model-parallel phase: launches {total}; {wall:.1f}s wall (limit "
        f"{MP_PHASE_LIMIT_S} s)")
    if wall > MP_PHASE_LIMIT_S:
        raise AssertionError(f"the model-parallel phase took {wall:.1f}s")
    return total


# ---------------------------------------------------------------- phase 16
#: phase 16's wall-clock budget, s
DATA_KERAS_LIMIT_S = 120
#: phase 16's sizes: MNIST's train / test rows, LeNet's batch, ResNet-50's
#: side and batches (the f32 check, the bf16 step, the fine-tune), VGG16's
#: side and batch, the Keras LSTM (width, vocab, B, T)
DK_SHAPES = {"mnist_train": 60000, "mnist_test": 10000, "lenet_b": 64,
             "resnet_hw": 224, "resnet_classes": 1000, "resnet_f32_b": 8,
             "resnet_b": 128, "transfer_b": 32, "vgg_hw": 224, "vgg_b": 4,
             "lstm_h": 512, "lstm_v": 80, "lstm_b": 64, "lstm_t": 128}
#: LeNet's test accuracy after one epoch on the synthetic glyphs (stated
#: in PERF.md before the phase first ran)
LENET_ACC_BAR = 0.95
#: f32 (TF32 off) logits of an imported net against the same weights in
#: the native configuration, and the Keras LSTM's against the plain path
KERAS_F32_TOL = 1e-5
#: the server's predictions against the direct net's, and the reloaded
#: net's against the saved one's (max-abs)
SERVER_TOL = 1e-6
DK_COUNTERS = ("batchnorm_train", "batchnorm_train.bwd",
               "batchnorm_add_act_train", "batchnorm_add_act_train.bwd",
               "lstm_recurrence")


def _delta(before, after):
    return {k: after[k] - before[k] for k in DK_COUNTERS}


def _dk_steps(net, ds, steps):
    """``steps`` train steps (a graph's fit_batch, a MultiLayerNetwork's
    fit on the one DataSet; no launch reset): (losses, wall s)."""
    step = net.fit_batch if isinstance(net, ComputationGraph) else net.fit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        step(ds)
        losses.append(net.score_value)
    torch.cuda.synchronize()
    return [float(v) for v in losses], time.perf_counter() - t0


def _mln_logits(net, x):
    """A MultiLayerNetwork's pre-softmax output of an inference forward."""
    with torch.no_grad():
        pre = net._forward(net._cast_params(net.params),
                           net._inference_state(), net._as_tensor(x),
                           train=False, rng=None, last_preoutput=True)[0]
    return pre.float().cpu()


class _AsImages(DataSetIterator):
    """Flat [N, H*W] batches of ``source`` as NHWC [N, H, W, 1] views."""
    async_supported = False

    def __init__(self, source, hw):
        self.source, self.hw = source, hw

    def __iter__(self):
        for ds in self.source:
            yield DataSet(ds.features.reshape(-1, self.hw, self.hw, 1),
                          ds.labels)


def _write_idx(path, arr):
    arr = np.ascontiguousarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim) +
                b"".join(struct.pack(">I", d) for d in arr.shape) +
                arr.tobytes())


def _same_batches(got, want, what):
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} batches against "
                             f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if not (np.array_equal(g.features, w.features) and
                np.array_equal(g.labels, w.labels)):
            raise AssertionError(f"{what}: batch {i} differs")


def _dk_mnist(card, tmp, dev, s):
    """(a) MNIST at its size through the native loader to LeNet; (b) the
    test rows as CSV through both CSV readers."""
    mdir = tmp / "mnist"
    mdir.mkdir()
    t0 = time.perf_counter()
    for prefix, n, train in (("train", s["mnist_train"], True),
                             ("t10k", s["mnist_test"], False)):
        imgs, labels = mnist_synthetic(n, train)
        _write_idx(mdir / f"{prefix}-images-idx3-ubyte",
                   np.round(imgs * 255))
        _write_idx(mdir / f"{prefix}-labels-idx1-ubyte", labels)
    write_s = time.perf_counter() - t0
    os.environ["MNIST_DIR"] = str(mdir)
    b = s["lenet_b"]
    images, labels = (mdir / "train-images-idx3-ubyte",
                      mdir / "train-labels-idx1-ubyte")
    t0 = time.perf_counter()
    py_it = MnistDataSetIterator(b, shuffle=False, flatten=True)
    py_load = time.perf_counter() - t0
    if py_it.is_synthetic:
        raise AssertionError("MnistDataSetIterator did not find the IDX "
                             "files")
    t0 = time.perf_counter()
    py_batches = list(py_it)
    py_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native_available():
        raise AssertionError("the native loader did not build")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat_it = NativeMnistDataSetIterator(images, labels, b, shuffle=False)
    nat_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat_batches = list(nat_it)
    nat_s = time.perf_counter() - t0
    n = s["mnist_train"]
    _same_batches(nat_batches[:n // b], py_batches, "native vs Python MNIST")
    if len(nat_batches) != -(-n // b):
        raise AssertionError(f"native MNIST gave {len(nat_batches)} batches")
    nat_rate = len(nat_batches) / nat_s
    log(f"data (a) MNIST [{card}]: IDX files of {n} + {s['mnist_test']} "
        f"glyphs written in {write_s:.2f}s; shuffle off, the native loader's"
        f" {len(nat_batches)} batches of {b} equal the Python iterator's "
        f"{len(py_batches)} bit for bit (it keeps the last {n % b} rows); "
        f"alone, after the g++ build ({build_s:.2f}s) and loading the files"
        f" (native {nat_load:.2f}s, Python {py_load:.2f}s): native "
        f"{nat_rate:.1f} batches/s, Python "
        f"{len(py_batches) / py_s:.1f} batches/s")
    del py_batches, nat_batches
    net = MultiLayerNetwork(lenet_conf(), device=dev).init()
    shuffled = NativeMnistDataSetIterator(images, labels, b, shuffle=True,
                                          seed=1)
    first = next(iter(shuffled))
    loss0 = net.score(DataSet(first.features.reshape(-1, 28, 28, 1),
                              first.labels))
    shuffled = NativeMnistDataSetIterator(images, labels, b, shuffle=True,
                                          seed=1)
    steps = -(-shuffled.total_examples() // b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(AsyncDataSetIterator(_AsImages(shuffled, 28), device=dev))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    loss1 = float(net.score_value)
    ev = net.evaluate(MnistDataSetIterator(1000, train=False,
                                           shuffle=False))
    acc = ev.accuracy()
    slice_it = NativeMnistDataSetIterator(images, labels, b, shuffle=True,
                                          seed=2)
    part = [ds for _, ds in zip(range(100), slice_it)]
    busy = None
    if dev.type == "cuda":
        _, busy_us, wall_us, _ = profile_step(
            lambda: net.fit(AsyncDataSetIterator(
                _AsImages(ListDataSetIterator(part), 28), device=dev)),
            "lenet, 100 steps from the native loader")
        busy = busy_us / wall_us
    log(f"data (a) LeNet [{card}]: one epoch of {steps} steps at B {b} "
        f"from the native loader through AsyncDataSetIterator: "
        f"{epoch_s / steps * 1e3:.3f} ms a step ({steps / epoch_s:.1f} "
        f"steps/s against the native loader's {nat_rate:.1f} batches/s "
        f"alone); busy share {busy if busy is None else round(busy, 3)} "
        f"(100 profiled steps); loss "
        f"{loss0:.4f} -> {loss1:.4f}; test accuracy {acc:.4f} (bar "
        f"{LENET_ACC_BAR})")
    if not loss1 < loss0:
        raise AssertionError("LeNet's loss did not fall over the epoch")
    if not acc >= LENET_ACC_BAR:
        raise AssertionError(f"LeNet's test accuracy {acc:.4f} is below "
                             f"{LENET_ACC_BAR}")
    # (b) the test rows as a 785-column CSV (label, 784 pixels)
    timgs = _read_idx(mdir / "t10k-images-idx3-ubyte")
    tlabels = _read_idx(mdir / "t10k-labels-idx1-ubyte")
    csv_path = tmp / "mnist_test.csv"
    rows = np.concatenate([tlabels[:, None].astype(np.int64),
                           timgs.reshape(len(timgs), -1)], axis=1)
    np.savetxt(csv_path, rows, fmt="%d", delimiter=",")
    t0 = time.perf_counter()
    nat = list(NativeCSVDataSetIterator(csv_path, b, label_index=0,
                                        num_classes=10, shuffle=False))
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = list(RecordReaderDataSetIterator(CSVRecordReader(csv_path), b,
                                          label_index=0, num_classes=10))
    py_s = time.perf_counter() - t0
    _same_batches(nat, py, "native vs Python CSV")
    n_rows = len(rows)
    log(f"data (b) CSV [{card}]: {n_rows} rows x 785 columns, shuffle off,"
        f" {len(nat)} equal batches; native {n_rows / nat_s:.0f} rows/s, "
        f"RecordReaderDataSetIterator(CSVRecordReader) "
        f"{n_rows / py_s:.0f} rows/s")
    os.environ.pop("MNIST_DIR", None)


def _native_resnet(weights, s, dev, dtype=None):
    """resnet50_conf (Keras's BN epsilon) carrying the exported arrays."""
    conf = resnet50_conf(s["resnet_classes"], s["resnet_hw"], s["resnet_hw"],
                         3)
    for v in conf.vertices.values():
        if isinstance(v, LayerVertex) and \
                isinstance(v.layer, BatchNormalization):
            v.layer.eps = 1e-3
    arrays, state = {}, {}
    for name, arrs in weights.items():
        if name.endswith("_conv"):
            arrays[name] = {"W": arrs[0]}
        elif name.endswith("_bn"):
            arrays[name] = {"gamma": arrs[0], "beta": arrs[1]}
            state[name] = {"mean": arrs[2], "var": arrs[3]}
        else:
            arrays[name] = {"W": arrs[0], "b": arrs[1]}
    return graph_from_numpy(conf, arrays, device=dev, compute_dtype=dtype,
                            state=state)


def _dk_resnet(card, tmp, dev, s, on_card):
    """(c) Keras ResNet-50 at full width: export, import, f32 against the
    native configuration, a bf16 step's BN launches, the imported and
    native step times, then the transfer-learning workflow. Returns the
    file, the f32 import's B-2 probabilities on ``x2`` and ``x2``."""
    hw, classes = s["resnet_hw"], s["resnet_classes"]
    path = tmp / "resnet50.h5"
    t0 = time.perf_counter()
    weights = export_resnet50_keras_h5(path, num_classes=classes,
                                       height=hw, width=hw, seed=7)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = KerasModelImport.import_keras_model_and_weights(path, device=dev)
    if on_card:
        torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    native = _native_resnet(weights, s, dev)
    g = np.random.default_rng(71)
    x8 = g.normal(size=(s["resnet_f32_b"], hw, hw, 3)).astype(np.float32)
    err = _rel_l2(_logits(net, x8), _logits(native, x8))
    x2 = x8[:2]
    probs2 = net.output(x2)[0]
    log(f"keras (c) ResNet-50 [{card}]: export {export_s:.2f}s "
        f"({path.stat().st_size / 1e6:.1f} MB), import "
        f"{import_s:.2f}s to {net.device}; f32 logits at B "
        f"{len(x8)} against native resnet50_conf on the same arrays: "
        f"rel-L2 {err:.3e} (tol {KERAS_F32_TOL})")
    if not err <= KERAS_F32_TOL:
        raise AssertionError("the imported ResNet-50 disagrees with the "
                             "native configuration")
    del net, native
    b = s["resnet_b"]
    imp = KerasModelImport.import_keras_model_and_weights(
        path, device=dev, compute_dtype=torch.bfloat16)
    nat = _native_resnet(weights, s, dev, torch.bfloat16)
    plan = imp._get_fusion_plan()[0]
    x, y = (_images(b, hw, 3, classes, 72) if on_card else
            (torch.randn(b, hw, hw, 3),
             torch.eye(classes)[torch.randint(0, classes, (b,))]))
    ds = DataSet(x, y)
    ms = {}
    for what, model in (("imported", imp), ("native", nat), ("imported", imp),
                        ("native", nat)):
        _dk_steps(model, ds, 1)
        before = read_launches()
        losses, wall = _dk_steps(model, ds, 2)
        bn = _delta(before, read_launches())
        ms.setdefault(what, []).append(wall / 2 * 1e3)
        if not np.isfinite(losses).all():
            raise AssertionError(f"the {what} ResNet-50's loss is not finite")
        if on_card and sum(bn[k] for k in DK_COUNTERS[:4]) != 106 * 2:
            raise AssertionError(f"the {what} ResNet-50 launched the BN "
                                 f"kernels {bn} in 2 steps, expected 106 a "
                                 "step (37 + 16 a direction)")
    log(f"keras (c) ResNet-50 bf16 B {b} [{card}]: fusion plan "
        f"{len(plan)} tails; BN launches a step {_bn_per_step(bn)}; ms a "
        f"step (2 steps, twice each, in turns) imported "
        f"{[round(v, 2) for v in ms['imported']]}, native "
        f"{[round(v, 2) for v in ms['native']]}")
    if on_card and len(plan) != 16:
        raise AssertionError(f"the imported graph's fusion plan has "
                             f"{len(plan)} tails, expected 16")
    del nat
    # examples/transfer_learning.py's workflow at full width
    tb = s["transfer_b"]
    # plain SGD on ~2048 unit-scale features moves a logit by about
    # lr x 2048 a step: 1e-4 keeps the head's steps below overshooting
    new = (TransferLearning.GraphBuilder(imp)
           .fine_tune_configuration(FineTuneConfiguration(
               learning_rate=1e-4, updater="sgd"))
           .set_feature_extractor("avgpool")
           .remove_vertex_and_connections("fc")
           .add_layer("new_fc", OutputLayer(n_out=4, loss="mcxent",
                                            activation="softmax"), "avgpool")
           .set_outputs("new_fc").build())
    del imp
    frozen = _clone_params(new.params, sorted(new.frozen_vertices))
    xt = x[:tb]
    yt = torch.nn.functional.one_hot(torch.arange(tb, device=xt.device) % 4,
                                     4).float()
    losses, wall = _dk_steps(new, DataSet(xt, yt), 6)
    changed = _unchanged(new.params, frozen)
    log(f"keras (c) transfer learning [{card}]: frozen below avgpool "
        f"({len(frozen)} vertices), a new 4-way head, 6 steps at B {tb}: "
        f"losses {[round(v, 4) for v in losses]}, {wall / 6 * 1e3:.2f} ms "
        f"a step; frozen vertices changed: {changed}")
    if changed:
        raise AssertionError(f"frozen vertices changed: {changed}")
    if not losses[-1] < losses[0]:
        raise AssertionError("the fine-tuned head's loss did not fall")
    return path, x2, probs2


def _bn_per_step(bn):
    return {k: v // 2 for k, v in bn.items() if "batchnorm" in k}


_VGG_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def _vgg_keras_config(hw, classes):
    """A Keras 2 Sequential VGG16 (Keras's layer names)."""
    layers = []
    for bi, (n, width) in enumerate(_VGG_BLOCKS, start=1):
        for ci in range(1, n + 1):
            conf = {"name": f"block{bi}_conv{ci}", "filters": width,
                    "kernel_size": [3, 3], "strides": [1, 1],
                    "padding": "same", "activation": "relu",
                    "use_bias": True}
            if not layers:
                conf["batch_input_shape"] = [None, hw, hw, 3]
            layers.append({"class_name": "Conv2D", "config": conf})
        layers.append({"class_name": "MaxPooling2D", "config": {
            "name": f"block{bi}_pool", "pool_size": [2, 2],
            "strides": [2, 2], "padding": "valid"}})
    layers.append({"class_name": "Flatten", "config": {"name": "flatten"}})
    for name, units, act in (("fc1", 4096, "relu"), ("fc2", 4096, "relu"),
                             ("predictions", classes, "softmax")):
        layers.append({"class_name": "Dense", "config": {
            "name": name, "units": units, "activation": act,
            "use_bias": True}})
    return {"class_name": "Sequential",
            "config": {"name": "vgg16", "layers": layers}}


def _dk_vgg(card, tmp, dev, s):
    """(d) VGG16: the native net's weights written as a Keras 2 file,
    loaded through TrainedModels.vgg16(weights_h5=), its f32 logits
    against the native net's; ImageNetLabels on a labels JSON."""
    hw = s["vgg_hw"]
    native = MultiLayerNetwork(vgg16_conf(1000, height=hw, width=hw),
                               device=dev).init()
    config = _vgg_keras_config(hw, 1000)
    names = [lc["config"]["name"] for lc in config["config"]["layers"]
             if lc["class_name"] in ("Conv2D", "Dense")]
    weighted = [p for p in native.params if p]
    weights = {name: [("kernel:0", p["W"].cpu().numpy()),
                      ("bias:0", p["b"].cpu().numpy())]
               for name, p in zip(names, weighted)}
    path = tmp / "vgg16.h5"
    t0 = time.perf_counter()
    write_keras_h5(path, config, weights, {
        "loss": "categorical_crossentropy",
        "optimizer_config": {"class_name": "SGD",
                             "config": {"lr": 0.01, "momentum": 0.9}}})
    write_s = time.perf_counter() - t0
    del weights
    t0 = time.perf_counter()
    net = TrainedModels.vgg16(weights_h5=str(path), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = np.random.default_rng(73).normal(
        size=(s["vgg_b"], hw, hw, 3)).astype(np.float32) * 50
    err = _rel_l2(_mln_logits(net, x), _mln_logits(native, x))
    labels_path = tmp / "imagenet_labels.json"
    labels_path.write_text(json.dumps(
        {str(i): [f"n{i:08d}", f"class_{i}"] for i in range(1000)}))
    probs = net.output(x)
    top = ImageNetLabels(path=str(labels_path)).decode_predictions(probs,
                                                                   top=3)
    want = [f"class_{i}" for i in np.argsort(probs[0])[::-1][:3]]
    log(f"keras (d) VGG16 [{card}]: {path.stat().st_size / 1e9:.3f} GB "
        f"written in {write_s:.2f}s, TrainedModels.vgg16(weights_h5=) "
        f"{load_s:.2f}s to {net.device}; f32 logits at B {len(x)} against "
        f"the native net: rel-L2 {err:.3e} (tol {KERAS_F32_TOL}); "
        f"decode_predictions row 0 {[t['label'] for t in top[0]]}")
    if not err <= KERAS_F32_TOL:
        raise AssertionError("the imported VGG16 disagrees with the native "
                             "net")
    if [t["label"] for t in top[0]] != want:
        raise AssertionError("decode_predictions disagrees with the argsort")


def _dk_lstm(card, tmp, dev, s, on_card):
    """(e) a Keras Sequential of 2 LSTMs (hard_sigmoid gates) and a
    TimeDistributed softmax Dense: f32 on B6 against the plain
    recurrence (the same file on the CPU), a warm and a counted bf16
    step."""
    h, v, b, t = s["lstm_h"], s["lstm_v"], s["lstm_b"], s["lstm_t"]
    g = np.random.default_rng(74)

    def lstm(name, n_in, first):
        conf = {"name": name, "units": h, "activation": "tanh",
                "recurrent_activation": "hard_sigmoid",
                "return_sequences": True}
        if first:
            conf["batch_input_shape"] = [None, t, n_in]
        return {"class_name": "LSTM", "config": conf}

    def lstm_w(n_in):
        return [("kernel:0", g.normal(0, n_in ** -0.5, (n_in, 4 * h))),
                ("recurrent_kernel:0", g.normal(0, h ** -0.5, (h, 4 * h))),
                ("bias:0", g.normal(0, 0.1, 4 * h))]

    config = {"class_name": "Sequential", "config": {"name": "char_lstm",
              "layers": [lstm("lstm_1", v, True), lstm("lstm_2", h, False),
                         {"class_name": "TimeDistributed", "config": {
                             "name": "td", "layer": {
                                 "class_name": "Dense", "config": {
                                     "name": "out", "units": v,
                                     "activation": "softmax"}}}}]}}
    path = tmp / "lstm.h5"
    write_keras_h5(path, config, {
        "lstm_1": lstm_w(v), "lstm_2": lstm_w(h),
        "td": [("kernel:0", g.normal(0, h ** -0.5, (h, v))),
               ("bias:0", np.zeros(v))]},
        {"loss": "categorical_crossentropy",
         "optimizer_config": {"class_name": "RMSprop",
                              "config": {"lr": 0.001}}})
    ids = g.integers(0, v, (b, t + 1))
    x = np.eye(v, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(v, dtype=np.float32)[ids[:, 1:]].reshape(b * t, v)
    net = KerasModelImport.import_keras_model_and_weights(path, device=dev)
    plain = KerasModelImport.import_keras_model_and_weights(path,
                                                            device="cpu")
    before = read_launches()
    got = _mln_logits(net, x)
    fwd = _delta(before, read_launches())["lstm_recurrence"]
    err = _rel_l2(got, _mln_logits(plain, x))
    del net, plain
    bnet = KerasModelImport.import_keras_model_and_weights(
        path, device=dev, compute_dtype=torch.bfloat16)
    _dk_steps(bnet, DataSet(x, y), 1)
    before = read_launches()
    losses, wall = _dk_steps(bnet, DataSet(x, y), 1)
    step = _delta(before, read_launches())["lstm_recurrence"]
    log(f"keras (e) LSTM 2 x {h}, hard_sigmoid gates, vocab {v}, B {b}, "
        f"T {t} [{card}]: gates "
        f"{[la.gate_activation for la in bnet.layers[:2]]}; f32 logits on B6 against the plain recurrence (CPU): rel-L2 "
        f"{err:.3e} (tol {KERAS_F32_TOL}), B6 launches {fwd}; a bf16 step "
        f"after a warm one {wall * 1e3:.2f} ms, loss {losses[0]:.4f}, B6 "
        f"launches {step}")
    if not err <= KERAS_F32_TOL:
        raise AssertionError("the Keras LSTM on B6 disagrees with the plain "
                             "recurrence")
    if not np.isfinite(losses).all():
        raise AssertionError("the Keras LSTM's loss is not finite")
    if on_card and (fwd, step) != (2, 2):
        raise AssertionError(f"B6 launched {fwd} / {step} times, expected 2")


def _post(base, path, payload):
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _dk_server(card, tmp, dev, path, x2, probs2):
    """(f) KerasBackendServer on the device over HTTP on (c)'s file."""
    srv = KerasBackendServer(device=dev).start()
    try:
        base = f"http://{srv.host}:{srv.port}"
        t0 = time.perf_counter()
        mid = _post(base, "/import", {"path": str(path)})["model_id"]
        import_s = time.perf_counter() - t0
        feats = x2.tolist()
        out = np.asarray(_post(base, "/predict", {
            "model_id": mid, "features": feats})["output"])[0]
        predict_err = float(np.abs(out - probs2).max())
        labels = np.eye(probs2.shape[1])[[3, 5]].tolist()
        score = _post(base, "/fit", {"model_id": mid, "features": feats,
                                     "labels": labels, "epochs": 1})["score"]
        ev = _post(base, "/evaluate", {"model_id": mid, "features": feats,
                                       "labels": labels})
        fitted = np.asarray(_post(base, "/predict", {
            "model_id": mid, "features": feats})["output"])[0]
        saved = tmp / "served.zip"
        _post(base, "/save", {"model_id": mid, "path": str(saved)})
        again = _post(base, "/load", {"path": str(saved)})["model_id"]
        reloaded = np.asarray(_post(base, "/predict", {
            "model_id": again, "features": feats})["output"])[0]
        reload_err = float(np.abs(reloaded - fitted).max())
        with urllib.request.urlopen(base + "/models") as r:
            models = json.loads(r.read())["models"]
    finally:
        srv.shutdown()
    log(f"keras (f) KerasBackendServer(device={dev}) [{card}]: /import "
        f"{import_s:.2f}s, /predict at B 2 against the direct net max-abs "
        f"{predict_err:.3e} (tol {SERVER_TOL}), /fit score {score:.4f}, "
        f"/evaluate accuracy {ev['accuracy']:.3f}, /save + /load: the "
        f"reloaded net's predictions max-abs {reload_err:.3e}; models "
        f"{models}")
    if not predict_err <= SERVER_TOL:
        raise AssertionError("/predict disagrees with the direct net")
    if not np.isfinite(score) or not 0.0 <= ev["accuracy"] <= 1.0:
        raise AssertionError("/fit or /evaluate gave no valid number")
    if not reload_err <= SERVER_TOL or sorted(models) != sorted([mid, again]):
        raise AssertionError("the reloaded net predicts differently")


def phase_data_and_keras(card, device=None, shapes=None):
    """Phase 16: data to the card (MNIST through the native loader to
    LeNet, CSV) and Keras models to the card (ResNet-50 and transfer
    learning, VGG16, an LSTM on B6, the backend server) (module
    docstring). ``device`` / ``shapes`` let the phase be rehearsed on the
    CPU at a small size. Returns its launches by counter."""
    t_phase = time.perf_counter()
    on_card = device is None
    dev = torch.device(device or "cuda:0")
    s = dict(DK_SHAPES, **(shapes or {}))
    tmp = Path(tempfile.mkdtemp(prefix="dl4j_phase16_"))
    reset_launches()
    try:
        _dk_mnist(card, tmp, dev, s)
        path, x2, probs2 = _dk_resnet(card, tmp, dev, s, on_card)
        _dk_vgg(card, tmp, dev, s)
        _dk_lstm(card, tmp, dev, s, on_card)
        _dk_server(card, tmp, dev, path, x2, probs2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = read_launches()
    wall = time.perf_counter() - t_phase
    log(f"data and keras phase: launches "
        f"{ {k: total[k] for k in DK_COUNTERS} }; {wall:.1f}s wall (limit "
        f"{DATA_KERAS_LIMIT_S} s)")
    if wall > DATA_KERAS_LIMIT_S:
        raise AssertionError(f"the data and Keras phase took {wall:.1f}s")
    return total


# ---------------------------------------------------------------- phase 17
NLP_LIMIT_S = 120
#: phase 17's shapes. The corpus: a Zipf(1.0) vocabulary of 50,000 types
#: in 20 topic blocks (the 100 most frequent types shared, every other
#: type one topic's), sentences of 8-24 tokens. (a) and (c) take DL4J's
#: Word2VecRawTextExample settings (layer 100, window 5, min count 5,
#: seed 42, HS, one epoch), (b) GoogleNews's width 300 with 5 negatives;
#: (d) dl4j-examples' Word2VecSentimentRNN shape (batch 64, sequences cut
#: at 256 steps, GravesLSTM 256, a 2-way mcxent head); (e) DeepWalk at
#: the paper's d 128, window 10, walk length 40 on a planted-community
#: graph of BlogCatalog's size (10,312 vertices, 333,983 edges, 39
#: groups), the walks per vertex cut from the paper's 80 to fit the limit
NLP_SHAPES = {"vocab": 50000, "common": 100, "topics": 20,
              "tokens": 2_000_000, "prefix": 200_000, "sent": (8, 24),
              "width": 100, "window": 5, "min_count": 5, "ns_width": 300,
              "negative": 5, "lstm_h": 256, "lstm_b": 64, "lstm_t": 256,
              "lstm_batches": 3, "lstm_epochs": 2, "pv_docs": 2000,
              "pv_len": 100, "pv_heldout": 100, "pv_epochs": 5,
              "glove_epochs": 5, "dw_vertices": 10312, "dw_edges": 333983,
              "dw_groups": 39, "dw_width": 128, "dw_window": 10,
              "dw_walk": 40, "dw_walks": 2, "profile_steps": 64}
#: relative L2 of the change the card's HS per-batch fit makes to syn0 /
#: syn1 against the change the same fit makes on the CPU's plain path,
#: with the segment update forced onto its f32 (scatter) route: both sum
#: the same f32 products in other orders, carried through hundreds of
#: dependent batches. scripts/torch_w2v_parity_faults.py reads the sound
#: card path at 1.357e-06 / 2.216e-07 and a card path that rounds the
#: values to bf16 on this route at 9.442e-04 / 1.573e-03
NLP_CPU_TOL = 3e-5
#: the same on the one-hot route the prefix's vocabulary takes: each
#: update is rounded to bf16 there, so an f32 difference between the two
#: devices can flip a rounding by one bf16 unit. The script reads the
#: sound card path at 2.665e-04 / 4.523e-04 and a card path that skips
#: the bf16 rounding at 8.550e-04 / 1.346e-03 (dividing by the weight
#: instead of its square root: 0.998 / 0.974)
NLP_CPU_BF16_TOL = 7.5e-4
#: tokens of the prefix the f32-route comparison fits (the CPU side of the
#: 200,000-token comparison takes ~12 s on the card's host)
NLP_F32_ROUTE_TOKENS = 50_000
#: max-abs of the text word-vector / graph-vector files against the
#: tables: six decimals (half a unit of the sixth, 5e-7), then the f32
#: rounding of the value read back
NLP_TXT_TOL = 1e-6


def _topic_tokens(rng, s, n_tokens, topics=None):
    """``n_tokens`` token ids in sentences of s["sent"] tokens: each
    sentence one topic (drawn from ``topics``, default all), its tokens
    Zipf(1.0) ranks over the vocabulary with every rank past the shared
    ones moved into that topic's block (so each type keeps its rank's
    frequency and belongs to one topic). Returns (sentences as id
    arrays, their topics)."""
    V, C, T = s["vocab"], s["common"], s["topics"]
    cdf = np.cumsum(1.0 / np.arange(1, V + 1))
    lo, hi = s["sent"]
    lens = rng.integers(lo, hi + 1, n_tokens // lo + 1)
    lens = lens[:np.searchsorted(np.cumsum(lens), n_tokens) + 1]
    pool = np.asarray(topics if topics is not None else np.arange(T))
    topic = pool[rng.integers(0, len(pool), len(lens))]
    ranks = np.minimum(np.searchsorted(cdf, rng.random(int(lens.sum())) *
                                       cdf[-1]), V - 1)
    tok_topic = np.repeat(topic, lens)
    ids = np.where(ranks < C, ranks,
                   C + T * ((ranks - C) // T) + tok_topic)
    return np.split(ids, np.cumsum(lens)[:-1]), topic


def nlp_corpus(s):
    """Phase 17's corpus from the seed: (the sentences as word lists, its
    first ``s["prefix"]`` tokens' sentences)."""
    sents, _ = _topic_tokens(np.random.default_rng(42), s, s["tokens"])
    seqs = _as_words(sents)
    n, prefix = 0, []
    for x in seqs:
        if n >= s["prefix"]:
            break
        prefix.append(x)
        n += len(x)
    return seqs, prefix


def _as_words(sentences):
    return [[f"w{i}" for i in sent.tolist()] for sent in sentences]


def _topic_words(s, topic, n):
    """The ``n`` most frequent content words of ``topic``."""
    return [f"w{s['common'] + s['topics'] * g + topic}" for g in range(n)]


def _topic_bar(sim, s, n_topics=5, n_words=10):
    """Mean cosine of word pairs within a topic and across topics, over
    the ``n_words`` most frequent content words of ``n_topics`` topics
    (tests/test_nlp_graph.py's in-topic over cross-topic bar)."""
    words = [_topic_words(s, k, n_words) for k in range(n_topics)]
    intra = [sim(a, b) for ws in words for i, a in enumerate(ws)
             for b in ws[i + 1:]]
    inter = [sim(a, b) for k, ws in enumerate(words)
             for other in words[k + 1:] for a in ws for b in other]
    intra, inter = np.nanmean(intra), np.nanmean(inter)
    return float(intra), float(inter)


def _nlp_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _nlp_profile(card, dev, fn, steps, what):
    """Busy share and launches a step of ``steps`` scan steps (``fn``) on
    the card ((None, None) on the CPU), and the segment-update launches
    the profiled run made (not the path's: they are not counted)."""
    before = sgk.segment_update.launches
    if dev.type != "cuda":
        fn()
        return None, None, sgk.segment_update.launches - before
    rows, busy, wall, _ = profile_step(fn, what)
    return (busy / wall, sum(n for _, _, n in rows) / steps,
            sgk.segment_update.launches - before)


def _w2v(dev, s, **kw):
    b = (Word2Vec.Builder().layer_size(kw.pop("width", s["width"]))
         .window_size(s["window"]).min_word_frequency(s["min_count"])
         .seed(42).epochs(1).device(dev))
    for k, v in kw.items():
        getattr(b, k)(v)
    return b.build()


def _timed_fit(model, seqs, dev):
    _nlp_sync(dev)
    t0 = time.perf_counter()
    model.fit(seqs)
    _nlp_sync(dev)
    return time.perf_counter() - t0


def _scan_segment(model, seqs, steps):
    """The first ``steps`` scan steps of ``model``'s fit over ``seqs`` —
    the same indexed corpus, its sentence breaks included, and the same
    step seeds — on copies of its tables (the profiled window; the model
    is untouched)."""
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import _stage_corpus
    lt, w = model.lookup, model.window
    p = max(32, model.batch_size // (2 * w))
    need, n, head = steps * p, 0, []
    for x in seqs:                      # enough sentences for the window
        if n >= 2 * need:
            break
        head.append(x)
        n += len(x) + 1
    corpus = next(model._index_chunks(head))[:need]
    padded = np.full((need + 2 * w,), -1, np.int32)
    padded[w:w + len(corpus)] = corpus
    corpus, sep = _stage_corpus(padded, model.device)
    key = fold_in(model.seed, 0)
    syn0 = lt.syn0.clone()
    if model.negative > 0:
        out = lt.syn1neg.clone()
        return lambda: skipgram_ns_corpus_scan(
            syn0, out, corpus, sep, model._neg_table_dev, key, 0, 0.025,
            1e-4, 0.0, 1e-6, k=model.negative, window=w, n_steps=steps,
            p=p, shared_negatives=model.shared_negatives)
    out = lt.syn1.clone()
    return lambda: skipgram_hs_corpus_scan(
        syn0, out, corpus, sep, model._codes, model._points,
        model._lengths, key, 0, 0.025, 1e-4, 0.0, 1e-6, window=w,
        n_steps=steps, p=p)


def _nlp_scans(card, dev, s, seqs, prefix):
    """(a) the HS corpus scan, (b) the NS scans. Returns (the 300-wide
    model of (b), the segment-update launches of the profiled runs)."""
    w = _w2v(dev, s)
    t0 = time.perf_counter()
    w.build_vocab(seqs)
    vocab_s = time.perf_counter() - t0
    V = len(w.vocab)
    p = max(32, w.batch_size // (2 * w.window))
    L = int(w._codes.shape[1])
    ntok = sum(len(x) for x in seqs)
    # the scan's steps: in-vocabulary tokens and a separator a sentence,
    # p centers a step; two segment updates a step
    n = sum(1 for x in seqs for t in x if t in w.vocab) + len(seqs)
    steps = -(-n // p)
    before = sgk.segment_update.launches
    wall = _timed_fit(w, seqs, dev)
    seg = sgk.segment_update.launches - before
    intra, inter = _topic_bar(w.similarity, s)
    busy, per_step, excluded = _nlp_profile(card, dev, _scan_segment(
        w, seqs, s["profile_steps"]), s["profile_steps"], "HS scan segment")
    routes = (segment_route(V, p * 2 * w.window),
              segment_route(V - 1, p * 2 * w.window * L))
    log(f"nlp (a) HS corpus scan, layer {s['width']}, window "
        f"{s['window']}, min count {s['min_count']} [{card}]: {ntok} tokens,"
        f" V {V} after min count (of {s['vocab']}), Huffman depth {L}, "
        f"wire {'int16' if V < 2 ** 15 else 'int32'}, {p} centers a step; "
        f"segment routes syn0 {routes[0]}, syn1 {routes[1]}; vocab "
        f"{vocab_s:.2f}s, fit {wall:.2f}s = {ntok / wall:.0f} tokens/s, "
        f"loss {w._last_loss:.4f}; busy share {busy} over "
        f"{s['profile_steps']} steps, {per_step} launches a step; "
        f"segment_update launches {seg} (predicted 2 x {steps} steps); "
        f"in-topic cosine {intra:.4f} vs cross-topic {inter:.4f}")
    if not (np.isfinite(w._last_loss) and intra > inter):
        raise AssertionError("the HS scan's vectors miss the topic bar")
    if dev.type == "cuda" and seg != 2 * steps:
        raise AssertionError(f"segment_update launched {seg} times in the HS "
                             f"scan, predicted {2 * steps}")
    ns = _w2v(dev, s, width=s["ns_width"], negative_sample=s["negative"])
    ns.build_vocab(seqs)
    wall = _timed_fit(ns, seqs, dev)
    intra, inter = _topic_bar(ns.similarity, s)
    busy, per_step, more = _nlp_profile(card, dev, _scan_segment(
        ns, seqs, s["profile_steps"]), s["profile_steps"], "NS scan segment")
    excluded += more
    pp = _w2v(dev, s, width=s["ns_width"], negative_sample=s["negative"],
              shared_negatives=False)
    npre = sum(len(x) for x in prefix)
    pwall = _timed_fit(pp, prefix, dev)
    pintra, pinter = _topic_bar(pp.similarity, s)
    B = p * 2 * ns.window
    log(f"nlp (b) NS corpus scan, layer {s['ns_width']}, {s['negative']} "
        f"negatives [{card}]: shared negatives over {ntok} tokens "
        f"{wall:.2f}s = {ntok / wall:.0f} tokens/s, loss "
        f"{ns._last_loss:.4f}, busy share {busy}, {per_step} launches a "
        f"step, routes syn0 {segment_route(V, B)} syn1neg "
        f"{segment_route(V, B)}; topic cosine {intra:.4f} vs {inter:.4f}; "
        f"per-pair negatives over the {npre}-token prefix {pwall:.2f}s = "
        f"{npre / pwall:.0f} tokens/s (syn1neg route "
        f"{segment_route(len(pp.vocab), B * (1 + s['negative']))}), topic "
        f"cosine {pintra:.4f} vs {pinter:.4f}")
    if not (np.isfinite(ns._last_loss) and np.isfinite(pp._last_loss)):
        raise AssertionError("an NS scan's loss is not finite")
    HS_VECTORS["model"] = w           # phase 18 embeds and clusters them
    return ns, excluded


def _hs_batch_fit(dev, s, seqs):
    """The HS per-batch fit of ``seqs`` on ``dev``: (model, wall s, its
    syn0 at init on the host)."""
    m = _w2v(dev, s, scan_min_tokens=10 ** 12)
    m.build_vocab(seqs)
    init = m.lookup.syn0.to("cpu", copy=True)
    return m, _timed_fit(m, seqs, dev), init


def _table_errs(got, want, init):
    """syn0 / syn1 rel-L2 of ``got``'s change to its tables against
    ``want``'s (both start from the same numpy draws, ``init``; syn1 from
    zeros)."""
    return [_rel_l2(getattr(got.lookup, k).cpu().double() - base,
                    getattr(want.lookup, k).double() - base)
            for k, base in (("syn0", init.double()), ("syn1", 0.0))]


def _nlp_card_runs(dev, s, prefix):
    """(c)'s runs on the card: the seeded NS scan twice over the prefix
    and the HS per-batch fit. Returns (whether the two scans' syn0 are
    bitwise equal, the per-batch model, its wall s)."""
    runs = []
    for _ in range(2):
        m = _w2v(dev, s, width=s["ns_width"], negative_sample=s["negative"])
        m.fit(prefix)
        runs.append(m.lookup.syn0)
    same = bool(torch.equal(runs[0], runs[1]))
    del runs
    return (same,) + _hs_batch_fit(dev, s, prefix)[:2]


def _nlp_parity(card, dev, s, prefix, cpu_fit, same, card_m, card_s):
    """(c) the seeded NS scan's reruns (``same``), the card's HS per-batch
    fit (``card_m``, ``card_s`` s) against the CPU's plain path
    (``cpu_fit``: a future of that fit, started when (c) began), on the
    segment update's route for the prefix's vocabulary, then both forced
    onto its f32 route over a shorter prefix."""
    t0 = time.perf_counter()
    cpu_m, cpu_s, init, cpu_end = cpu_fit.result()
    wait_s = time.perf_counter() - t0
    errs = _table_errs(card_m, cpu_m, init)
    V = len(card_m.vocab)
    route = (segment_route(V, card_m.batch_size),
             segment_route(V - 1, card_m.batch_size *
                           int(card_m._codes.shape[1])))
    n, short = 0, []
    for x in prefix:
        if n >= NLP_F32_ROUTE_TOKENS:
            break
        short.append(x)
        n += len(x)
    saved = psg.ONEHOT_SEGMENT_MAX_V
    psg.ONEHOT_SEGMENT_MAX_V = 0            # every table on the f32 route
    try:
        f32 = [_hs_batch_fit(d, s, short)
               for d in (dev, torch.device("cpu"))]
    finally:
        psg.ONEHOT_SEGMENT_MAX_V = saved
    f32_errs = _table_errs(f32[0][0], f32[1][0], f32[1][2])
    tol = NLP_CPU_BF16_TOL if "onehot" in route else NLP_CPU_TOL
    log(f"nlp (c) determinism and parity [{card}]: the seeded NS scan "
        f"(layer {s['ns_width']}) twice over the prefix: syn0 bitwise "
        f"equal {same}; the HS per-batch fit (layer {s['width']}, routes "
        f"syn0 {route[0]}, syn1 {route[1]}) on {dev} {card_s:.2f}s (beside "
        f"the CPU side's thread) vs the CPU's plain path {cpu_s:.2f}s (in a "
        f"thread beside (c)'s card runs and (d), done {cpu_end:.2f}s into "
        f"the phase; "
        f"waited {wait_s:.2f}s): rel-L2 of the change to syn0 / syn1 "
        f"{errs[0]:.3e} / {errs[1]:.3e} (tol {tol:.3e}); on the f32 route "
        f"over the first {n} tokens ({f32[0][1]:.2f}s / {f32[1][1]:.2f}s): "
        f"{f32_errs[0]:.3e} / {f32_errs[1]:.3e} (tol {NLP_CPU_TOL:.3e})")
    if not same:
        raise AssertionError("the seeded NS scan is not reproducible")
    if not (max(errs) <= tol and max(f32_errs) <= NLP_CPU_TOL):
        raise AssertionError("the HS per-batch fit disagrees with the CPU")


def _nlp_lstm(card, dev, s, vectors, on_card):
    """(d) word vectors into B6: masked sequences from
    Word2VecDataSetIterator through GravesLSTM → RnnOutputLayer, f32 and
    bf16. Returns B6's launches on the path."""
    rng = np.random.default_rng(17)
    n = s["lstm_b"] * s["lstm_batches"]
    docs, topic = [], rng.integers(0, 2, n)
    for k in topic:
        sents, _ = _topic_tokens(rng, s, int(rng.integers(
            s["lstm_t"] * 3 // 4, s["lstm_t"] * 3 // 2)), topics=[k])
        docs.append(" ".join(f"w{i}" for i in np.concatenate(sents)))
    labelled = [(d, ("positive", "negative")[k]) for d, k in zip(docs, topic)]
    # (b)'s vectors scaled to unit length (DL4J's normalized word-vector
    # matrix): the NS scan leaves them near their init scale, 1/300, where
    # the LSTM's input projection sees almost nothing
    syn0 = vectors.lookup.host_syn0()
    unit = StaticWord2Vec(vectors.vocab, syn0 / np.maximum(
        np.linalg.norm(syn0, axis=1, keepdims=True), 1e-12))
    unit.vector_length = syn0.shape[1]
    it = Word2VecDataSetIterator(unit, labelled, ["positive", "negative"],
                                 batch_size=s["lstm_b"],
                                 max_length=s["lstm_t"])
    t0 = time.perf_counter()
    batches = list(it)
    it_s = time.perf_counter() - t0
    ds0 = batches[0]
    conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(2e-3)
            .updater("adam").l2(1e-5).weight_init("xavier")
            .gradient_normalization("ClipElementWiseAbsoluteValue")
            .gradient_normalization_threshold(1.0).list()
            .layer(GravesLSTM(n_out=s["lstm_h"], activation="tanh"))
            .layer(RnnOutputLayer(n_out=2, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(InputType.recurrent(s["ns_width"])).build())
    launches, report = 0, []
    for dtype in (torch.float32, torch.bfloat16):
        net = MultiLayerNetwork(conf, compute_dtype=dtype,
                                device=dev).init()
        first = net.score(ds0)
        before = lk.lstm_recurrence_fwd.launches
        losses, wall = [], 0.0
        for _ in range(s["lstm_epochs"]):
            got, w_s = _nlp_steps(net, batches)
            losses += got
            wall += w_s
        launched = lk.lstm_recurrence_fwd.launches - before
        launches += launched
        last = net.score(ds0)
        steps = s["lstm_epochs"] * len(batches)
        err = _nlp_b6_check(net, ds0, dtype, dev)
        report.append(f"{str(dtype)[6:]}: the first batch's loss {first:.4f}"
                      f" -> {last:.4f} after {steps} steps (losses "
                      f"{[round(x, 4) for x in losses]}), "
                      f"{wall / steps * 1e3:.1f} ms a step (beside (c)'s "
                      f"CPU thread), B6 {launched} "
                      f"launches in {steps} steps, masked B6 against "
                      f"lstm_recurrence_plain max-abs {err:.3e} (tol "
                      f"{LSTM_TOL[dtype]})")
        if on_card and launched != steps:
            raise AssertionError(f"B6 launched {launched} times in {steps} "
                                 "steps, expected one a step")
        if not (np.isfinite(losses).all() and last < first):
            raise AssertionError(f"the LSTM's loss does not fall: "
                                 f"{report[-1]}")
        if not err <= LSTM_TOL[dtype]:
            raise AssertionError("B6 disagrees with the plain recurrence")
    T = ds0.features.shape[1]
    fill = float(np.mean([b.features_mask.mean() for b in batches]))
    log(f"nlp (d) Word2VecDataSetIterator -> GravesLSTM({s['lstm_h']}) -> "
        f"RnnOutputLayer(2, mcxent) [{card}]: {len(batches)} batches of "
        f"{s['lstm_b']} x T {T} x F {s['ns_width']} built in {it_s:.2f}s, "
        f"mask fill {fill:.3f}; " + "; ".join(report))
    return launches


def _nlp_steps(net, batches):
    """One epoch of fit steps over ``batches``: (losses, wall s)."""
    _nlp_sync(net.device)
    t0 = time.perf_counter()
    losses = []
    for ds in batches:
        net.fit(ds)
        losses.append(net.score_value)
    _nlp_sync(net.device)
    return [float(v) for v in losses], time.perf_counter() - t0


def _nlp_b6_check(net, ds, dtype, dev):
    """B6 on the first batch's masked sequences, with the trained layer's
    weights, against lstm_recurrence_plain on the same inputs: max-abs of
    y, hT and cT (on the CPU both are the plain version)."""
    layer, params = net.layers[0], net.params[0]
    x = torch.from_numpy(ds.features).to(dev, dtype)
    n, t, _ = x.shape
    h = layer.n_out
    W, R, b = (params[k].to(dtype) for k in ("W", "R", "b"))
    peep = tuple(params[k].to(dtype) for k in ("pi", "pf", "po"))
    xw_t = ((x.reshape(n * t, -1) @ W).reshape(n, t, 4 * h) +
            b).transpose(0, 1)
    mask_t = torch.from_numpy(ds.features_mask).to(dev, dtype).T
    zeros = torch.zeros((n, h), dtype=dtype, device=dev)
    args = (xw_t, R, zeros, zeros, peep, mask_t)
    got = lk.lstm_recurrence_fwd(*args)
    want = lk.lstm_recurrence_plain(*args, get_activation("sigmoid"),
                                    get_activation("tanh"))
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, want))


def _planted_graph(s, rng):
    """BlogCatalog's size as a planted partition: vertex v in group
    v mod groups, 80% of the edges inside a group."""
    nv, ne, k = s["dw_vertices"], s["dw_edges"], s["dw_groups"]
    g = Graph(nv)
    u = rng.integers(0, nv, ne)
    inside = rng.random(ne) < 0.8
    same = (u % k) + k * rng.integers(0, (nv - 1 - u % k) // k + 1, ne)
    v = np.where(inside, same, rng.integers(0, nv, ne))
    keep = u != v
    for a, b in zip(u[keep].tolist(), v[keep].tolist()):
        g.add_edge(a, b)
    return g, int(keep.sum())


def _nlp_embeddings(card, dev, s, prefix, tmp):
    """(e) ParagraphVectors DBOW with infer_vector, GloVe, DeepWalk.
    Returns the DeepWalk model."""
    rng = np.random.default_rng(23)
    T = s["topics"]
    docs, labels = [], []
    for i in range(s["pv_docs"] + s["pv_heldout"]):
        k = i % T
        sents, _ = _topic_tokens(rng, s, s["pv_len"], topics=[k])
        docs.append((f"doc{i}", _as_words([np.concatenate(sents)])[0]))
        labels.append(k)
    train, held = docs[:s["pv_docs"]], docs[s["pv_docs"]:]
    pv = ParagraphVectors(vector_length=s["width"], epochs=s["pv_epochs"],
                          min_word_frequency=s["min_count"], seed=42,
                          device=dev)
    _nlp_sync(dev)
    t0 = time.perf_counter()
    pv.fit_documents(train)
    _nlp_sync(dev)
    pv_s = time.perf_counter() - t0
    dv = pv.doc_vectors.float().cpu().numpy()
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    cents = np.stack([dv[np.array(labels[:len(train)]) == k].mean(0)
                      for k in range(T)])
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    t0 = time.perf_counter()
    inferred = np.stack([pv.infer_vector(toks) for _, toks in held])
    infer_s = time.perf_counter() - t0
    pred = np.argmax(inferred @ cents.T, axis=1)
    acc = float(np.mean(pred == np.array(labels[len(train):])))
    log(f"nlp (e) ParagraphVectors DBOW, layer {s['width']}, "
        f"{len(train)} documents of {s['pv_len']} tokens, {s['pv_epochs']} "
        f"epochs [{card}]: fit {pv_s:.2f}s; infer_vector on "
        f"{len(held)} held-out documents {infer_s:.2f}s; their topic by "
        f"the nearest training centroid: accuracy {acc:.3f} (chance "
        f"{1 / T:.3f}, bar {3 / T:.3f})")
    if not acc >= 3 / T:
        raise AssertionError("inferred vectors miss the topic bar")
    glove = Glove(vector_length=s["width"], window=s["window"],
                  min_word_frequency=s["min_count"],
                  epochs=s["glove_epochs"], seed=42, device=dev)
    _nlp_sync(dev)
    t0 = time.perf_counter()
    glove.fit(prefix)
    _nlp_sync(dev)
    glove_s = time.perf_counter() - t0
    intra, inter = _topic_bar(glove.similarity, s)
    log(f"nlp (e) GloVe, layer {s['width']}, window {s['window']}, "
        f"{s['glove_epochs']} epochs over the prefix [{card}]: "
        f"{glove_s:.2f}s (co-occurrence on the host included), loss "
        f"{glove._last_loss:.4f}, topic cosine {intra:.4f} vs "
        f"{inter:.4f}")
    if not (np.isfinite(glove._last_loss) and intra > inter):
        raise AssertionError("GloVe misses the topic bar")
    t0 = time.perf_counter()
    graph, edges = _planted_graph(s, rng)
    graph_s = time.perf_counter() - t0
    dw = DeepWalk(vector_size=s["dw_width"], window=s["dw_window"],
                  seed=42, device=dev)
    _nlp_sync(dev)
    t0 = time.perf_counter()
    dw.fit(graph, walk_length=s["dw_walk"], walks_per_vertex=s["dw_walks"])
    _nlp_sync(dev)
    dw_s = time.perf_counter() - t0
    vv = dw.vertex_vectors.cpu().numpy()
    vv = vv / np.linalg.norm(vv, axis=1, keepdims=True)
    a, b = rng.integers(0, s["dw_vertices"], (2, 4000))
    k = s["dw_groups"]
    cos = np.sum(vv[a] * vv[b], axis=1)
    intra = float(cos[(a % k == b % k) & (a != b)].mean())
    inter = float(cos[a % k != b % k].mean())
    log(f"nlp (e) DeepWalk d {s['dw_width']}, window {s['dw_window']}, walk "
        f"length {s['dw_walk']}, {s['dw_walks']} walks a vertex (the "
        f"paper's 80 cut to fit the phase's limit) on {s['dw_vertices']} "
        f"vertices, {edges} edges, {k} planted groups [{card}]: graph "
        f"{graph_s:.2f}s, fit {dw_s:.2f}s (walks on the host included); "
        f"in-group cosine {intra:.4f} vs across {inter:.4f}")
    if not intra > inter:
        raise AssertionError("DeepWalk misses the community bar")
    return dw


def _nlp_files(card, model, dw, tmp):
    """(f) the text and binary word-vector files and the graph-vector
    file, written from the card's tables and read back."""
    syn0 = model.lookup.syn0.cpu().numpy()
    t0 = time.perf_counter()
    WordVectorSerializer.write_word_vectors(model, tmp / "w2v.txt")
    WordVectorSerializer.write_word_vectors_binary(model, tmp / "w2v.npz")
    GraphVectorSerializer.write_graph_vectors(dw, tmp / "graph.txt")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vocab, txt = WordVectorSerializer.load_txt_vectors(tmp / "w2v.txt")
    static = StaticWord2Vec.load(tmp / "w2v.npz")
    graph = GraphVectorSerializer.load_graph_vectors(tmp / "graph.txt")
    read_s = time.perf_counter() - t0
    txt_err = float(np.abs(txt - syn0).max())
    same = vocab.index2word == model.vocab.index2word and \
        static.vocab.index2word == model.vocab.index2word and \
        np.array_equal(static.vectors, syn0)
    graph_err = float(np.abs(graph - dw.vertex_vectors.cpu().numpy()).max())
    log(f"nlp (f) serializers [{card}]: {syn0.shape[0]} x {syn0.shape[1]} "
        f"word vectors and {graph.shape[0]} x {graph.shape[1]} graph "
        f"vectors written {write_s:.2f}s, read {read_s:.2f}s; text max-abs "
        f"{txt_err:.3e}, binary bitwise {same}, graph max-abs "
        f"{graph_err:.3e} (tol {NLP_TXT_TOL})")
    if not (same and txt_err <= NLP_TXT_TOL and graph_err <= NLP_TXT_TOL):
        raise AssertionError("a vector file does not read back its table")


def phase_nlp_graph(card, device=None, shapes=None):
    """Phase 17: word embeddings and graph embeddings on the card (module
    docstring). ``device`` / ``shapes`` let the phase be rehearsed on the
    CPU at a small size. Returns its launches by counter (B6 only on the
    path: the kernel checks' launches are not counted)."""
    t_phase = time.perf_counter()
    on_card = device is None
    dev = torch.device(device or "cuda:0")
    s = dict(NLP_SHAPES, **(shapes or {}))
    t0 = time.perf_counter()
    seqs, prefix = nlp_corpus(s)
    n = sum(len(x) for x in prefix)
    log(f"nlp corpus: {sum(len(x) for x in seqs)} tokens in {len(seqs)} "
        f"sentences, {len(prefix)} in the {n}-token prefix, made in "
        f"{time.perf_counter() - t0:.2f}s")
    tmp = Path(tempfile.mkdtemp(prefix="dl4j_phase17_"))
    seg0 = sgk.segment_update.launches
    threads = torch.get_num_threads()
    pool = ThreadPoolExecutor(1)
    try:
        walls = [time.perf_counter()]
        ns, excluded = _nlp_scans(card, dev, s, seqs, prefix)
        walls.append(time.perf_counter())
        # (c)'s CPU side runs in a thread beside (c)'s card runs and (d),
        # on the host's other cores ((a) and (b) are timed with the host
        # to themselves); it changes no module state: (c) waits for it
        # before forcing the f32 route
        torch.set_num_threads(max(1, threads - 2))
        cpu_fit = pool.submit(
            lambda: _hs_batch_fit(torch.device("cpu"), s, prefix) +
            (time.perf_counter() - t_phase,))
        same, hs_batch, card_s = _nlp_card_runs(dev, s, prefix)
        walls.append(time.perf_counter())
        b6 = _nlp_lstm(card, dev, s, ns, on_card)
        del ns
        walls.append(time.perf_counter())
        _nlp_parity(card, dev, s, prefix, cpu_fit, same, hs_batch, card_s)
        torch.set_num_threads(threads)
        walls.append(time.perf_counter())
        dw = _nlp_embeddings(card, dev, s, prefix, tmp)
        walls.append(time.perf_counter())
        _nlp_files(card, hs_batch, dw, tmp)
        walls.append(time.perf_counter())
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        torch.set_num_threads(threads)
        shutil.rmtree(tmp, ignore_errors=True)
    seg = sgk.segment_update.launches - seg0 - excluded
    wall = time.perf_counter() - t_phase
    parts = dict(zip(("corpus", "a-b", "c on the card", "d",
                      "c's comparison", "e", "f"),
                     np.diff([t_phase] + walls).round(2).tolist()))
    log(f"nlp and graph phase: B6 launches {b6}, segment_update launches "
        f"{seg}; {wall:.1f}s wall (limit {NLP_LIMIT_S} s): seconds by part "
        f"{parts}")
    if wall > NLP_LIMIT_S:
        raise AssertionError(f"the NLP and graph phase took {wall:.1f}s")
    if on_card and not seg > 0:
        raise AssertionError("the embedding trainers launched no "
                             "segment_update")
    return {"lstm_recurrence": b6, "segment_update": seg}


# ---------------------------------------------------------------- phase 18
def word_topics(vocab, s=None):
    """Each vocabulary row's topic block in phase 17's corpus (word
    ``w<id>``: id < common is shared, -1; else (id - common) mod topics)."""
    s = s or NLP_SHAPES
    ids = np.array([int(vocab.word_for(i)[1:]) for i in range(len(vocab))])
    return np.where(ids < s["common"], -1,
                    (ids - s["common"]) % s["topics"])


def topic_agreement(Z, topics, device, k=10):
    """The share of each topic word's ``k`` nearest neighbours (squared
    distance over every row of ``Z``, exact, on ``device``) from its own
    topic block."""
    idx, _ = bh_knn(np.asarray(Z, np.float32), k, device=device)
    own = topics >= 0
    return float(np.mean(topics[idx[own]] == topics[own, None]))


def unit_rows(a):
    """Rows scaled to unit length (DL4J's normalized word-vector matrix)."""
    return (a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True),
                           1e-12)).astype(np.float32)


#: phase 18's wall-clock budget, s
CLUSTER_LIMIT_S = 60
#: phase 18's shapes: (a) runs BarnesHutTsne at its defaults (perplexity
#: 30, 1000 iterations, 64 negatives past 8192 points) over phase 17's HS
#: syn0 (V x 100); (b) its exact route on the 8192 most frequent words
#: (300 iterations of the schedule on the card, then 20 on both devices)
#: and the dense f64 Tsne on the 2000 most frequent for 50 iterations;
#: (c) k-means with phase 17's 20 topics; (d) phase 12's LeNet for 8
#: steps of B 64 under the UI's listeners; (e) a 4-8-3 net on the port's
#: Iris data
CLUSTER_SHAPES = {"tsne_iter": 1000, "exact_rows": 8192, "exact_warm": 300, "exact_iter": 20,
                  "dense_rows": 2000, "dense_iter": 50, "k": 20,
                  "kmeans_iter": 100, "ui_steps": 8, "ui_b": 64,
                  "iris_epochs": 30, "iris_b": 16, "profile_iter": 10}
#: relative L2 of the exact route's Y after 20 iterations on the card
#: against the CPU's (f32: the matmuls and the attractive sum add in
#: other orders). They start from a state 300 iterations into the
#: schedule: from the 1e-4-scale initial draw the f32 repulsion is
#: rounding noise in both packages (on the CPU, JAX's f32 and f64 runs
#: part ~2x an iteration, O(1) by iteration 20)
TSNE_EXACT_TOL = 1e-4
#: the same for the dense f64 Tsne over 50 iterations
TSNE_DENSE_TOL = 1e-8
#: k-means: the share of rows the card assigns as the CPU does
KMEANS_AGREE_BAR = 0.999
#: the share of each topic word's 10 nearest 2-D neighbours from its own
#: topic block (chance 0.05). scripts/torch_tsne_topic_bar.py rehearsed
#: (a) on the CPU at full size: 0.3261 in 2-D, 0.3874 in the 100-D
#: vectors; the card draws other negatives (its own generator) from a
#: syn0 trained on the card, so the bar leaves a quarter of the reading
TOPIC_2D_BAR = 0.25
#: the pipeline's accuracy on the Iris data it was fitted on
IRIS_ACC_BAR = 0.9


def _tsne_state(ts, n, steps, src, dst, w, dev):
    """``steps`` exact iterations of ``ts``'s schedule from its seeded
    initial draw on ``dev``: (Y, vel, gains)."""
    rng = np.random.default_rng(ts.seed)
    Y = torch.from_numpy(rng.normal(0, 1e-4, (n, 2)).astype(
        np.float32)).to(dev)
    state = (Y, torch.zeros_like(Y), torch.ones_like(Y))
    for it in range(steps):
        mom = ts.momentum if it < ts.switch_momentum_iteration \
            else ts.final_momentum
        ex = ts.exaggeration if it < ts.stop_lying_iteration else 1.0
        state = bh_iter_exact(*state, src, dst, w, mom, ts.learning_rate, ex)
    return state


def _exact_iterations(state, edges, steps, ts):
    """``steps`` late-schedule exact iterations (final momentum, no
    exaggeration) from ``state``; returns Y on the host."""
    for _ in range(steps):
        state = bh_iter_exact(*state, *edges, ts.final_momentum,
                              ts.learning_rate, 1.0)
    return state[0].cpu().numpy()


def _cpu_refs(X, syn0, s):
    """The CPU side of (b)'s dense Tsne and of (c): (Y, KL, the k-means
    assignments, its iterations, wall s)."""
    t0 = time.perf_counter()
    dense = Tsne(n_iter=s["dense_iter"], device="cpu")
    Y = dense.calculate(X[:s["dense_rows"]])
    km = KMeansClustering(s["k"], max_iterations=s["kmeans_iter"],
                          device="cpu")
    assign, _ = km.apply_to(syn0)
    return Y, dense.kl_divergence_, assign, km.iterations_, \
        time.perf_counter() - t0


def _cluster_bh(card, dev, X, topics, s, on_card):
    """(a) BarnesHutTsne twice over the whole vocabulary, then a profiled
    window of 10 iterations on the second run's edges; returns the
    segment-update launches the window made (not the path's)."""
    runs, seg, walls = [], [], []
    t0 = time.perf_counter()
    for _ in range(2):
        before = sgk.segment_update.launches
        ts = BarnesHutTsne(n_iter=s["tsne_iter"], device=dev)
        runs.append(ts.calculate(X))
        seg.append(sgk.segment_update.launches - before)
        walls.append(ts.timings_)
    t1 = time.perf_counter()
    same = bool(np.array_equal(runs[0], runs[1]))
    n, it, edges = X.shape[0], ts.n_iter, ts.edges_
    state = [torch.from_numpy(runs[0]).to(dev)]
    state += [torch.zeros_like(state[0]), torch.ones_like(state[0])]
    gens = [generator(fold_in(ts.seed, i), dev)
            for i in range(s["profile_iter"])]

    def window():
        st = state
        for g in gens:
            st = bh_iter_ns(*st, *edges, g, ts.negative_samples,
                            ts.final_momentum, ts.learning_rate, 1.0)
        return st

    before = sgk.segment_update.launches
    busy = per_it = None
    if on_card:
        rows, busy_us, wall_us, _ = profile_step(window, "BH t-SNE window")
        busy = busy_us / wall_us
        per_it = sum(r[2] for r in rows) / len(gens)
    else:
        window()
    excluded = sgk.segment_update.launches - before
    t2 = time.perf_counter()
    a2 = topic_agreement(runs[0], topics, dev)
    a100 = topic_agreement(X, topics, dev)
    t3 = time.perf_counter()
    rate = it / np.array([w["iterations_s"] for w in walls])
    log(f"cluster (a) BarnesHutTsne [{card}]: V {n} x {X.shape[1]} (unit "
        f"rows), perplexity {ts.perplexity}, k "
        f"{int(edges[0].shape[0]) // (2 * n)} neighbours, {it} iterations, "
        f"{ts.negative_samples} negatives (exact up to "
        f"{ts.exact_threshold}); two runs {t1 - t0:.2f}s: similarities "
        f"(kNN on the device, beta search on the host) "
        f"{[round(w['similarities_s'], 2) for w in walls]}s, iterations "
        f"{[round(w['iterations_s'], 2) for w in walls]}s = "
        f"{rate.round(1).tolist()} it/s; busy share {busy} over "
        f"{len(gens)} iterations, {per_it} launches an iteration (window "
        f"{t2 - t1:.2f}s); segment_update launches {seg} (predicted {it} a "
        f"run); two seeded runs bitwise equal {same}; topic agreement of "
        f"the 10 nearest ({t3 - t2:.2f}s): 2-D {a2:.4f} (bar "
        f"{TOPIC_2D_BAR}), 100-D {a100:.4f}, chance "
        f"{1 / NLP_SHAPES['topics']:.2f}")
    if not (same and np.isfinite(runs[0]).all()):
        raise AssertionError("seeded Barnes-Hut t-SNE is not reproducible")
    if on_card and seg != [it, it]:
        raise AssertionError(f"BH t-SNE launched segment_update {seg} "
                             f"times, predicted {it} a run")
    if not a2 >= TOPIC_2D_BAR:
        raise AssertionError("the 2-D embedding misses the topic bar")
    return excluded


def _cluster_exact(card, dev, X, s, pool):
    """(b)'s exact route: the 8192 rows' edges and 300 iterations on the
    card, then a future of the CPU's 20 iterations from that state.
    Returns (the card's Y, the future, its state's wall s)."""
    ts = BarnesHutTsne(device=dev)
    n = s["exact_rows"]
    edges = ts._edges(X[:n])
    state = _tsne_state(ts, n, s["exact_warm"], *edges, dev)
    cpu_state = [t.cpu() for t in state]
    cpu_edges = [t.cpu() for t in edges]
    fut = pool.submit(lambda: (_exact_iterations(
        cpu_state, cpu_edges, s["exact_iter"], ts),
        time.perf_counter()))
    t0 = time.perf_counter()
    Y = _exact_iterations(state, edges, s["exact_iter"], ts)
    return Y, fut, time.perf_counter() - t0


def _cluster_kmeans(card, dev, syn0, s):
    """(c) two seeded k-means fits on the card: (assignments, centres,
    iterations, readbacks of the cost, wall s of each)."""
    out = []
    for _ in range(2):
        c0 = fetch_counts().get("kmeans.cost", 0)
        t0 = time.perf_counter()
        km = KMeansClustering(s["k"], max_iterations=s["kmeans_iter"],
                              device=dev)
        assign, centers = km.apply_to(syn0)
        out.append((assign, centers, km.iterations_,
                    fetch_counts()["kmeans.cost"] - c0,
                    time.perf_counter() - t0))
    return out


def _cluster_ui(card, dev, s, tmp):
    """(d) LeNet under the UI's listeners, the server, the remote push,
    the activation PNG and a profiler trace."""
    net = MultiLayerNetwork(lenet_conf(learning_rate=0.02), device=dev).init()
    g = np.random.default_rng(43)
    b = s["ui_b"]
    batches = [DataSet(g.random((b, 28, 28, 1), np.float32),
                       np.eye(10, dtype=np.float32)[g.integers(0, 10, b)])
               for _ in range(s["ui_steps"])]
    storage = SqliteStatsStorage(tmp / "stats.db")
    flow = FlowIterationListener(storage, frequency=1, timing_frequency=4)
    net.set_listeners(
        StatsListener(storage, session_id="lenet", update_frequency=1,
                      histograms_frequency=4),
        flow, ConvolutionalIterationListener(storage, batches[0].features[:1],
                                             frequency=4))
    reads0 = fetch_counts().get("ui.stats", 0)
    t0 = time.perf_counter()
    net.fit(batches)
    fit_s = time.perf_counter() - t0
    reads = fetch_counts()["ui.stats"] - reads0
    want_reads = s["ui_steps"] + s["ui_steps"] // 4
    ui = UIServer.get_instance(port=0).attach(storage)
    try:
        base = f"http://127.0.0.1:{ui.port}"
        page = urllib.request.urlopen(base + "/train/overview",
                                      timeout=10).read()
        get = lambda path: json.loads(urllib.request.urlopen(
            base + path, timeout=10).read())
        ups = get("/train/updates?session=lenet")
        RemoteStatsRouter(base).put_update(
            {"session": "remote", "type": "update", "iteration": 1,
             "score": float(ups[-1]["score"])})
        remote = get("/train/updates?session=remote")
        flows = [u for u in get("/train/flow?session=flow")["layers"]]
        png = urllib.request.urlopen(base + "/train/activations.png",
                                     timeout=10).read()
    finally:
        ui.stop()
    (tmp / "activations.png").write_bytes(png)
    with profiler_trace(str(tmp / "trace")):
        net.fit(batches[:1])
        _nlp_sync(dev)
    trace = json.loads((tmp / "trace" / "trace.json").read_text())
    kernels = sum(1 for e in trace["traceEvents"]
                  if e.get("cat") == "kernel")
    times = [f["time_ms"] for f in flows]
    log(f"cluster (d) UI [{card}]: LeNet {s['ui_steps']} steps of B {b} "
        f"{fit_s:.2f}s under StatsListener (update 1, histograms every 4) "
        f"into sqlite, the flow and convolutional listeners; stats "
        f"readbacks {reads} (predicted {want_reads}: the score a step, the "
        f"parameter table in one copy every 4th); /train/overview "
        f"{len(page)} bytes, /train/updates {len(ups)} updates, remote push "
        f"{len(remote)} record; flow layer times (ms, on {dev}) {times}; "
        f"activation PNG {len(png)} bytes; profiler trace {kernels} CUDA "
        f"kernel events")
    if not (reads == want_reads and len(ups) == s["ui_steps"] and
            len(remote) == 1 and page.startswith(b"<!DOCTYPE html>") and
            png[:8] == b"\x89PNG\r\n\x1a\n" and
            len(times) == len(net.layers) and
            all(t is not None and t > 0 for t in times)):
        raise AssertionError("the UI's records, routes or readbacks are off")
    if dev.type == "cuda" and not kernels > 0:
        raise AssertionError("the profiler trace holds no CUDA kernel")


def _cluster_pipeline(card, dev, s):
    """(e) NormalizerStage + NetworkClassifier on the Iris data."""
    it = IrisDataSetIterator(150, 150, seed=7)
    conf = (NeuralNetConfiguration.Builder().seed(4).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").activation("tanh").list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device=dev).init()
    pipe = Pipeline([("norm", NormalizerStage(NormalizerStandardize())),
                     ("net", NetworkClassifier(net, batch_size=s["iris_b"],
                                               epochs=s["iris_epochs"],
                                               device=dev))])
    t0 = time.perf_counter()
    pipe.fit(it.features, it.labels)
    fit_s = time.perf_counter() - t0
    c0 = fetch_counts().get("pipeline.predict", 0)
    acc = pipe.score(it.features, it.labels)
    reads = fetch_counts()["pipeline.predict"] - c0
    log(f"cluster (e) pipeline [{card}]: NormalizerStage + NetworkClassifier "
        f"(4-8-3, sgd 0.1, {s['iris_epochs']} epochs of B {s['iris_b']}) "
        f"on the Iris data, fit {fit_s:.2f}s on {net.device}; accuracy "
        f"{acc:.4f} (bar {IRIS_ACC_BAR}), {reads} readback a score")
    if not (acc >= IRIS_ACC_BAR and reads == 1):
        raise AssertionError("the pipeline misses its accuracy bar")


def phase_clustering_ui(card, device=None, shapes=None, vectors=None):
    """Phase 18: phase 17's word vectors embedded and clustered, and the
    training UI, on the card (module docstring). ``vectors`` (syn0 on
    the host, each row's topic; default phase 17's HS model), ``device``
    and ``shapes`` let the phase be rehearsed on the CPU. Returns its
    segment-update launches (the profiled window's are not counted)."""
    t_phase = time.perf_counter()
    on_card = device is None
    dev = torch.device(device or "cuda:0")
    s = dict(CLUSTER_SHAPES, **(shapes or {}))
    if vectors is None:
        hs = HS_VECTORS["model"]
        vectors = (hs.lookup.host_syn0(), word_topics(hs.vocab))
    syn0, topics = vectors
    X = unit_rows(syn0)
    seg0 = sgk.segment_update.launches
    threads = torch.get_num_threads()
    pool = ThreadPoolExecutor(1)
    tmp = Path(tempfile.mkdtemp(prefix="dl4j_phase18_"))
    try:
        walls = [time.perf_counter()]
        # the CPU references run in a thread beside the card's work, on
        # the host's other cores; they share no state with it
        torch.set_num_threads(max(1, threads - 2))
        refs = pool.submit(_cpu_refs, X, syn0, s)
        Y8, exact_fut, exact_s = _cluster_exact(card, dev, X, s, pool)
        walls.append(time.perf_counter())
        excluded = _cluster_bh(card, dev, X, topics, s, on_card)
        walls.append(time.perf_counter())
        dense = Tsne(n_iter=s["dense_iter"], device=dev)
        t0 = time.perf_counter()
        Yd = dense.calculate(X[:s["dense_rows"]])
        dense_s = time.perf_counter() - t0
        kms = _cluster_kmeans(card, dev, syn0, s)
        walls.append(time.perf_counter())
        _cluster_ui(card, dev, s, tmp)
        walls.append(time.perf_counter())
        _cluster_pipeline(card, dev, s)
        walls.append(time.perf_counter())
        t0 = time.perf_counter()
        Yc, cpu_done = exact_fut.result()
        Yd_cpu, kl_cpu, km_cpu, km_it, cpu_s = refs.result()
        wait_s = time.perf_counter() - t0
        walls.append(time.perf_counter())
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        torch.set_num_threads(threads)
        shutil.rmtree(tmp, ignore_errors=True)
    exact_err = _rel_l2(torch.from_numpy(Y8), torch.from_numpy(Yc))
    dense_err = _rel_l2(torch.from_numpy(Yd), torch.from_numpy(Yd_cpu))
    (a0, c0, it0, r0, w0), (a1, c1, it1, r1, w1) = kms
    km_same = bool(np.array_equal(a0, a1) and np.array_equal(c0, c1))
    differ = int(np.sum(a0 != km_cpu))
    log(f"cluster (b) exact routes [{card}]: BH exact route on the "
        f"{s['exact_rows']} most frequent words, {s['exact_iter']} "
        f"iterations after {s['exact_warm']} on the card ({exact_s:.2f}s) "
        f"vs the CPU's plain segment sum (done "
        f"{cpu_done - t_phase:.2f}s into the phase): Y rel-L2 "
        f"{exact_err:.3e} (tol {TSNE_EXACT_TOL}); dense f64 Tsne on the "
        f"{s['dense_rows']} most frequent, {s['dense_iter']} iterations "
        f"{dense_s:.2f}s, KL {dense.kl_divergence_:.6f} vs the CPU's "
        f"{kl_cpu:.6f}: Y rel-L2 {dense_err:.3e} (tol {TSNE_DENSE_TOL})")
    log(f"cluster (c) KMeans [{card}]: k {s['k']} on syn0 "
        f"{syn0.shape[0]} x {syn0.shape[1]}, {it0} / {it1} iterations "
        f"(CPU {km_it}) in {w0:.2f}s / {w1:.2f}s, cost readbacks {r0} / "
        f"{r1} (predicted one an iteration); two seeded fits bitwise equal "
        f"{km_same}; rows assigned otherwise than the CPU's {differ} of "
        f"{len(a0)} (bar {KMEANS_AGREE_BAR}); CPU references {cpu_s:.2f}s "
        f"in their thread, waited {wait_s:.2f}s")
    if not (exact_err <= TSNE_EXACT_TOL and dense_err <= TSNE_DENSE_TOL):
        raise AssertionError("a t-SNE route disagrees with the CPU")
    if not (km_same and r0 == it0 and r1 == it1 and
            1 - differ / len(a0) >= KMEANS_AGREE_BAR):
        raise AssertionError("k-means is not reproducible or disagrees "
                             "with the CPU")
    seg = sgk.segment_update.launches - seg0 - excluded
    wall = time.perf_counter() - t_phase
    parts = dict(zip(("b exact on the card", "a", "b dense, c", "d", "e",
                      "waiting for the CPU"),
                     np.diff([t_phase] + walls[1:]).round(2).tolist()))
    want = 2 * s["tsne_iter"] + s["exact_warm"] + s["exact_iter"]
    log(f"clustering and UI phase: segment_update launches {seg} (predicted "
        f"{want}); {wall:.1f}s wall (limit {CLUSTER_LIMIT_S} s): seconds by "
        f"part {parts}")
    if on_card and seg != want:
        raise AssertionError("t-SNE launched segment_update otherwise than "
                             "predicted")
    if wall > CLUSTER_LIMIT_S:
        raise AssertionError(f"the clustering and UI phase took {wall:.1f}s")
    return {"segment_update": seg}


# ---------------------------------------------------------------- phase 19
#: the analysis phase's wall limit
ANALYSIS_LIMIT_S = 60.0
#: phase 4's flagship
ANALYSIS_MODEL = {"vocab": 32000, "d_model": 768, "num_heads": 12,
                  "num_layers": 12, "max_length": 577}
ANALYSIS_REQUESTS = 8
ANALYSIS_NEW_TOKENS = 32
#: the injected crash's ``engine.step`` hit, counted from warmup's end
ANALYSIS_CRASH_AFTER = 4
REPO_ROOT = Path(__file__).resolve().parent


def _lint_gate(card):
    """(a): the port's linter over its tree and this script, gated by the
    port's baseline. Returns the static lock-order edges."""
    t0 = time.perf_counter()
    runner = LintRunner(str(REPO_ROOT), force_facts=True)
    found = runner.lint([str(REPO_ROOT / "deeplearning4j_tpu_torch"),
                         str(REPO_ROOT / "chip_smoke.py")])
    lint_s = time.perf_counter() - t0
    baseline = load_baseline(str(REPO_ROOT / "deeplearning4j_tpu_torch" /
                                 "analysis" / "baseline.json"))
    fresh = new_findings(found, baseline)
    log(f"analysis (a) lint [{card}]: {len(runner.facts)} modules in "
        f"{lint_s:.2f}s: {len(found)} finding(s) "
        f"{sorted(f.key for f in found)}, {len(fresh)} beyond the "
        f"baseline ({sum(baseline.values())} baselined), "
        f"{len(runner.errors)} unreadable")
    for f in fresh:
        log(str(f))
    if fresh or runner.errors:
        raise AssertionError("the port's lint gate is not clean")
    return lock_order_edges(runner.facts)


def _lock_check(audit, static, what, explained=()):
    cycles = audit.cycles()
    cc = audit.cross_check(static.keys())
    log(f"analysis (b) {what}: observed edges {audit.edge_list()}, "
        f"cycles {cycles}, explained {cc['explained']}, novel "
        f"{cc['novel']}, inversions {cc['inversions']}")
    missing = [e for e in explained if e not in cc["explained"]]
    if cycles or cc["inversions"] or cc["novel"] or missing:
        raise AssertionError(f"{what}: observed lock order disagrees with "
                             f"the static graph (unexplained {missing})")


def _broker_locks(card, static):
    server = TcpBrokerServer().start()
    client = TcpMessageBroker(server.host, server.port)
    audit = LockAudit()
    audit.instrument(client, names={"_lock": "TcpMessageBroker._lock"})
    try:
        q = client.subscribe("analysis")
        client.publish("analysis", b"x")
        if q.get(timeout=5) != b"x":
            raise AssertionError("the broker lost a message")
        client.unsubscribe("analysis", q)
    finally:
        client.close()
        server.close()
    _lock_check(audit, static, f"TcpMessageBroker [{card}]",
                [("TcpMessageBroker._sub_lock",
                  "TcpMessageBroker._send_lock")])


def phase_analysis(card, device=None, model=None):
    """Phase 19 (module docstring). ``device`` / ``model`` let the phase
    be rehearsed on the CPU at a small width. Returns its B1 launches."""
    t_phase = time.perf_counter()
    on_card = device is None
    static = _lint_gate(card)
    m = dict(model or ANALYSIS_MODEL)
    conf = transformer_lm_conf(vocab_size=m["vocab"], d_model=m["d_model"],
                               num_heads=m["num_heads"],
                               num_layers=m["num_layers"],
                               max_length=m["max_length"])
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16 if on_card
                           else torch.float32, device=device).init()
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, m["vocab"], int(n))
               for n in rng.integers(64, 257, ANALYSIS_REQUESTS)]
    inj = FaultInjector()
    engine = SlotGenerationEngine(net, num_slots=8, block_size=4,
                                  fault_injector=inj)
    sup = EngineSupervisor(engine, timeout=60.0, interval=0.1,
                           max_restarts=2)
    locks = LockAudit()
    names = locks.instrument(sup, names={"_lock": "HeartbeatMonitor._lock"})
    names += locks.instrument(engine)
    reset_launches()
    sup.start()
    try:
        sup.submit(prompts[0][:64], 4).result(timeout=300)   # warm
        _sync()
        stats0 = sup.stats()
        inj.raise_once("engine.step", RuntimeError("injected crash"),
                       at=inj.hits("engine.step") + ANALYSIS_CRASH_AFTER)
        t0 = time.perf_counter()
        with CompileAudit() as compiles, TransferAudit() as transfers, \
                LockAudit(patch=True) as patched:
            reqs = [sup.submit(p, ANALYSIS_NEW_TOKENS) for p in prompts]
            outs = [r.result(timeout=300) for r in reqs]
            _sync()
        serve_s = time.perf_counter() - t0
        stats = sup.stats()
        restarts = sup.restarts
    finally:
        sup.stop()
    b1 = read_launches()["shortseq_attention"]
    served = {k: stats[k] - stats0.get(k, 0)
              for k in ("decode_blocks", "prefill_batches", "completed",
                        "failed", "host_readbacks")}
    log(f"analysis (b) served [{card}]: {len(reqs)} requests in "
        f"{serve_s:.2f}s across {restarts} restart(s): {served}; audited "
        f"locks {sorted(names)} and, made under patch by the takeover, "
        f"{sorted(patched.names)}")
    if "SlotGenerationEngine._lock" not in patched.names:
        raise AssertionError("the takeover's engine was not audited")
    if restarts != 1 or served["completed"] != len(reqs) or \
            served["failed"] or any(
                len(o) != len(p) + ANALYSIS_NEW_TOKENS
                for o, p in zip(outs, prompts)):
        raise AssertionError("the supervised restart lost, duplicated or "
                             "cut a request")
    _lock_check(locks, static, f"engine + supervisor [{card}]",
                [("EngineSupervisor._sup_lock",
                  "SlotGenerationEngine._lock")])
    _lock_check(patched, static, f"patch mode over the restart [{card}]")
    _broker_locks(card, static)
    # (c) readbacks, (d) builds and loads
    log(f"analysis (c) transfers [{card}]: {transfers.report()} over "
        f"{served['decode_blocks']} decode blocks and "
        f"{served['prefill_batches']} admissions")
    transfers.check_per_block("engine.decode", served["decode_blocks"])
    whole = CompileAudit.process()
    log(f"analysis (d) compiles [{card}]: after warmup "
        f"{compiles.report()}; the process so far: builds "
        f"{whole.builds()}, loads {whole.loads()}, duplicate signatures "
        f"{whole.duplicate_signature_compiles}")
    compiles.check(total=0)
    # every library is built and loaded under the one source hash of the
    # checkout, so a second build or load is a repeated signature
    whole.check(forbid_duplicate_signatures=True)
    # (e) B1 on the audited path
    admissions = stats["prefill_batches"]
    wall = time.perf_counter() - t_phase
    log(f"analysis (e) [{card}]: B1 launches {b1} over {admissions} "
        f"admissions (>= {m['num_layers']} each); phase "
        f"{wall:.1f}s wall (limit {ANALYSIS_LIMIT_S} s)")
    if on_card and b1 < m["num_layers"] * admissions:
        raise AssertionError("B1 did not launch on every admission")
    if wall > ANALYSIS_LIMIT_S:
        raise AssertionError(f"the analysis phase took {wall:.1f}s")
    return b1


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    card = phase_environment()
    phase_build()
    measured = phase_kernel_checks()
    serving_launches, flagship = phase_serving(card)
    phase_paged_serving(card, flagship)
    phase_tier(card, flagship)
    phase_serving_host(card, flagship)
    fleet_launches = phase_fleet(card, flagship)
    del flagship
    remote_launches = phase_remote(card)
    mesh_launches = phase_mesh(card)
    launches = {"shortseq_attention": serving_launches + fleet_launches +
                remote_launches + mesh_launches,
                "flash_forward": phase_long_prompt()}
    train = phase_train_flagship(card)
    long = phase_train_long(card)
    charrnn, charrnn_ds, lstm_train = phase_charrnn_train(card)
    phase_charrnn_tbptt(card, charrnn_ds)
    phase_charrnn_sample(card, charrnn)
    del charrnn, charrnn_ds
    phase_graph_rnn(card)
    resnet = phase_resnet(card)
    swin = phase_swin(card)
    phase_lenet_vgg(card)
    phase_evaluate(card)
    api = phase_training_api(card)
    dp = phase_data_parallel(card)
    mp = phase_model_parallel(card)
    dk = phase_data_and_keras(card)
    nlp = phase_nlp_graph(card)
    clu = phase_clustering_ui(card)
    analysis_launches = phase_analysis(card)
    launches["shortseq_attention"] += analysis_launches
    for name in ("batchnorm_train", "batchnorm_add_act_train"):
        launches[name] = sum(src[name] + src[f"{name}.bwd"]
                             for src in (resnet, api, dk))
    launches["lstm_recurrence"] = lstm_train["lstm_recurrence"] + \
        api["lstm_recurrence"] + dp["lstm_recurrence"] + \
        dk["lstm_recurrence"] + nlp["lstm_recurrence"]
    launches["segment_update"] = nlp["segment_update"] + \
        clu["segment_update"]
    for name in ("shortseq_attention_bias", "shortseq_attention_bias_bwd"):
        launches[name] = swin[name]
    launches["shortseq_attention"] += dp["shortseq_attention"]
    log(f"B1 launches by phase: serving (4) {serving_launches}, fleet "
        f"(4e) {fleet_launches}, remote (4f) {remote_launches}, mesh (4g) "
        f"{mesh_launches}, data parallel (14) {dp['shortseq_attention']}, "
        f"analysis (19) {analysis_launches}; total "
        f"{launches['shortseq_attention']}")
    launches["shortseq_attention_bwd"] = train["shortseq_attention_bwd"] + \
        dp["shortseq_attention_bwd"]
    for name in ("flash_backward_dq", "flash_backward_dkv"):
        launches[name] = long[name]
    # phase 15: the ring's pairs on B3 / B4 / B5, the cross-shard BN
    for name in RING_KERNELS:
        launches[name] += mp.get(name, 0)
    launches["ring_attention"] = sum(mp.get(n, 0) for n in RING_KERNELS)
    launches["batchnorm_cross_shard"] = sum(
        v for src in (dp, mp) for k, v in src.items()
        if k.startswith("batchnorm_xs"))
    for line in measured["shortseq_attention"].pop("main_shapes"):
        log(line)
    rows = []
    for name, spec in KERNELS.items():
        rows.append({"name": name, "route": "cuda",
                     "source": f"deeplearning4j_tpu_torch/csrc/"
                               f"{spec['lib']}.cu",
                     "replaces": spec["replaces"],
                     "launches": launches[name], **measured[name]})
    rows.append({"name": "ring_attention", "route": "cuda",
                 "source": "deeplearning4j_tpu_torch/parallel/sequence.py",
                 "replaces": "deeplearning4j_tpu/parallel/sequence.py:94",
                 "launches": launches["ring_attention"],
                 **measured["ring_attention"]})
    rows.append({"name": "batchnorm_cross_shard", "route": "cuda",
                 "source": "deeplearning4j_tpu_torch/csrc/batchnorm.cu",
                 "replaces": "deeplearning4j_tpu/kernels/batchnorm.py:44",
                 "launches": launches["batchnorm_cross_shard"],
                 **measured["batchnorm_cross_shard"]})
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
