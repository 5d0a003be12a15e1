#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``incubator_mxnet_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` and no network, and imports nothing of JAX.  Phases
(nothing catches a failure; any mismatch raises and the exit code is not
0):

1. print the card's name and power limit; build the kernels from
   ``incubator_mxnet_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once) and print the build time and the compile cache's counters (the
   library is not damaged here: ``tools/compile_cache_torch.py`` does
   that);
2. hold each kernel against its plain PyTorch version on the card, in
   bf16 and f32: K1/K2 (ghost BN forward/backward) at the stem, a
   56x56x256 dual exit, a 28x28x512 donated downsample exit, a 28x28x512
   downsample BN and the 7x7x2048 final exit at batch ``BATCH``, and the
   stem, the dual exit and the final exit at phase 3g-ii's batch
   (``GLUON_FUSED_BATCH``); K3 (max pool with index)
   at the stem on tie-heavy input, 2x2/2, 3x3/1 pad 1, 3x3/2 pad (1, 2),
   W 113, a (2, 3, 300, 300) plane cut into bands, NaN inputs, an input
   3 elements off the 16-byte grid and a permuted one (copied once), and
   LeNet's two pools (2x2/2 at (64, 20, 24, 24) and (64, 50, 8, 8)),
   every distinct max pool of the vision zoo at batch 32 (``ZOO_POOLS``:
   the stems 3x3/2 pad 1, VGG's 2x2/2 at 224-14, AlexNet's 3x3/2 at 55,
   27, 13, SqueezeNet's ceil-mode 3x3/2, Inception's 3x3/2 at 147, 71,
   35, 17 px), each one launch; K4/K5/K6 (flash attention forward,
   dQ, dK/dV) at the LM's (4, 8, 2048, 128) causal and not, a ragged
   length (Sq = Sk = 1000, D 64), a cross length with empty rows (Sq 256,
   Sk 128, causal, D 16), head dims 20 and 4 (zero-padded to 24 and 8),
   b*h = 70000 at S 16, the D <= 256 form: D 136 (Sq 300, Sk 200,
   causal), D 200 (Sq 200, Sk 300, dense) and D 256 at (4, 4, 2048)
   causal, and the D-streamed form: D 264 (Sq 300, Sk 200, causal), D 512
   (Sq 200, Sk 300, dense) and D 512 at (4, 2, 2048) causal; each case's
   launches of K4-K6 counted (one each);
2c. K7 (``bn_copy``, the copy over ghost-BN blocks that K1 and K2 are
   read against) bit-exact against ``clone()`` at the 9 ResNet-50 BN
   shapes (batch 256, bf16) and, in bf16 and f32, at C 3 / HW 5 and C 64
   / HW 49, with x on and off y's 16-byte grid; the rtc kernels
   compiled by NVRTC from ``incubator_mxnet_tpu_torch/csrc/rtc`` (their
   compile ms printed): R1 ``scale_kernel`` exact against ``2x + 1`` at
   (4, 8, 2048, 128) f32, at n 1, 3, 5 and 1000003, and on views 1-3
   floats off the 16-byte grid, R2 ``mm_kernel`` within 1e-4 of max |a @ b| at
   (8192, 1024) @ (1024, 1024) and a ragged (1000, 300) @ (300, 129);
   a missing export or kernel raises ValueError and a float64 launch
   TypeError;
3. the ResNet path: ``resnet50_v1(ghost_bn=16)`` at batch 256, 224 px,
   bf16 compute, f32 master weights, sgd momentum 0.9 / lr 0.1 / wd
   1e-4, a dynamic loss scale, synthetic data from a seed; ``STEPS``
   steps with the launch counters set to 0 just before; every loss
   finite and exactly 53/53/1 launches per step, none of K4-K6;
3b. the LM path: ``example/long_context/train_lm_torch.py``'s
   ``LongContextLM`` at dim 1024, 8 heads, seq 2048, batch 4, 2 layers,
   vocab 256, f32 (TF32 off), ``STEPS`` steps of its update (momentum
   0.9, lr ``LM_LR``) on its synthetic tokens, with the counters set to
   0 just before; every loss finite, the last below the first, exactly 2
   launches per step of each of K4/K5/K6 and none of K1-K3; then the same
   LM at 4 heads (head dim 256, the D <= 256 form of K4-K6) and at 2
   heads (head dim 512, the D-streamed form), each with finite, falling
   losses and 2/2/2 launches a step: ``lm_step_ms_d256`` and
   ``lm_step_ms_d512``;
3c. the imperative path: one causal attention layer of the LM at its
   width written with ``nd`` and ``autograd`` alone (x (4, 2048, 1024)
   from numpy seed 1; Wq, Wk, Wv, Wo (1024, 1024) from
   ``nd.random.uniform`` after ``nd.random.seed(0)`` on ``mx.gpu(0)``,
   with ``attach_grad``): ``nd.dot``, reshape/transpose to heads,
   ``nd.contrib.flash_attention(causal=True)``, back, ``nd.dot`` with Wo,
   ``(y * y).mean()``, ``backward``; ``STEPS`` steps with the counters at
   0 just before, then R1 on y and R2 on the output projection through
   rtc; exactly 1/1/1 launches of K4/K5/K6 a step, R1 and R2 once, none
   of K1-K3 or K7; loss and the four weight gradients within 1e-4
   (relative) of the same layer in plain torch autograd (dense
   ``attention_reference``); ``nd_step_ms`` the median of steps 2-6;
3d. the ResNet path fed from RecordIO, as ``bench.py --data recordio``
   composes it: a 512-record shard of 224x224x3 uint8 ``.npy`` payloads
   (``bench.py``'s ``_synth_recordio``, numpy seed 0, label ``i % 1000``)
   written by the port's ``recordio`` into a temporary directory, read by
   ``io.ImageRecordUInt8Iter`` (shuffle, rand_mirror, 8 threads, prefetch
   8) on the card, feeding phase 3's step with cuDNN held to deterministic
   algorithms: run A takes ``STEPS`` steps (two batches an epoch, so two
   epoch boundaries) and saves a checkpoint with the iterator's position
   after step 3; run B, a net from another seed with a new step and
   iterator, restores it (step 3) and takes steps 4-6.  Every loss finite,
   exactly 53/53/1 launches of K1-K3 every step and nothing else, and run
   B's losses and final state (params, running stats, optimizer state,
   PRNG key, step counter, loss scale) equal run A's bit for bit;
   ``recordio_step_ms`` (median of steps 2-6, ``next()`` included),
   ``iter_ms`` (in ``next()``), ``h2d_ms`` (the batch's copies to the
   card, device time), the save's ms and bytes and the restore's ms;
3e. the ImageNet trainer's path: ``example/image_classification/
   train_imagenet_torch.py`` at its defaults, built through its own
   functions: stock-BN ``resnet50_v1``, batch 128, 224 px, bf16 compute,
   f32 parameters, sgd momentum 0.9 / lr 0.1 / wd 1e-4; ``IMAGENET_STEPS``
   steps from its synthetic resident batch (finite losses, a later one
   below the first), then ``IMAGENET_RIO_STEPS`` fed from phase 3d's shard by
   its ``ImageRecordIter``; with the counters set to 0 just before, every
   step launches K3 once and nothing else (no K1/K2: stock BN is
   PyTorch's ``native_batch_norm``); ``imagenet_step_ms`` (median of steps 3-8) and img/s;
3f. one net of each other family of the zoo at full width, 1000
   classes, batch ``ZOO_BATCH``, bf16, lr ``ZOO_LR``, ``ZOO_STEPS`` steps
   (``ZOO_NETS``: resnet50_v2, resnet18_v1, resnet50_v1(s2d_stem=True),
   vgg16_bn, alexnet, squeezenet1_1, densenet121, mobilenet1_0,
   mobilenet_v2_1_0 at 224 px, inception_v3 at 299): each step launches
   K3 once for each of the net's max pools and nothing else, losses
   finite; each net's ``step_ms`` (cuDNN's own choice of algorithms, no
   autotuning at so few steps);
3g. the Gluon training surface: ``example/gluon/image_classification_
   torch.py``'s loop built through its own functions (``GLUON``:
   ``resnet50_v1``, 224 px, 1000 classes, batch 64, ``hybridize()``,
   ``Trainer("sgd", lr 0.05, momentum 0.9)`` over ``kv.create("device")``,
   ``metric.Accuracy``) for 8 steps of its synthetic data, the counters
   set to 0 just before: every loss finite, each step launches K3 once
   and nothing else; ``gluon_step_ms`` (median of steps 3-8,
   ``trainer.step`` included), img/s and ``trainer_step_ms`` (host time
   in ``trainer.step`` alone: one update per parameter); then 3g-ii,
   ``Trainer.make_fused_step`` on ``resnet50_v1(ghost_bn=16)`` (batch 64,
   bf16, ``multi_precision``, dynamic loss scale) beside
   ``make_train_step`` from the same weights and batches with cuDNN
   deterministic, 3 steps: losses equal bit for bit, 53/53/1 launches of
   K1-K3 a step on each side;
3h. the Module path: ``example/image_classification/
   train_mnist_torch.py`` through its own functions (``get_iters``,
   ``build_module``, ``fit``), LeNet and then the MLP, each one epoch of
   the synthetic 2048-image set (1536 to train, 512 to validate) at
   batch 64 through ``Module.fit`` with validation, ``Speedometer``,
   ``kv.create("local")`` and sgd lr 0.1 / momentum 0.9, the counters
   set to 0 just before ``fit``: every loss finite, K3 launched twice a
   forward for LeNet (24 training and 8 validation batches: 64) and
   never for the MLP, nothing else; ``module_step_ms`` (median of steps
   3-24 of ``forward_backward`` + ``update`` + ``update_metric``,
   synchronized on the host clock) and img/s of each net, and the
   phase's wall time;
3i. the word LM: ``example/rnn/word_lm/train_torch.py`` through its own
   functions at the upstream medium model's widths (``WORDLM``: vocab
   10000, embedding and hidden 650, 2 LSTM layers, batch 32, bptt 35),
   f32 with TF32 off, sgd lr 1.0, 10 steps of its synthetic corpus, the
   counters set to 0 just before: every loss finite, the first window's
   loss computed again after the steps below step 1's, no launch of
   K1-K7, R1 or R2 (the path is cuDNN's RNN and cuBLAS);
   ``wordlm_step_ms`` (median of steps 3-10) and tokens/s; 3i-ii,
   ``BucketingModule`` over ``BucketSentenceIter`` at
   ``lstm_bucketing.py``'s widths (``BUCKETING``: 2 layers, 200 hidden
   and embedding, vocab 10000, batch 32, buckets 10-60, two batches a
   bucket of synthetic sentences), ``Module.fit`` two epochs, with the
   unrolled ``mx.rnn.LSTMCell`` stack and with ``FusedRNNCell``: losses
   finite, all 6 buckets bound, no kernel launches; ``bucket_step_ms``
   of each (median of the second epoch);
3j. SSD detection (graded config 5): ``example/ssd/train_torch.py``
   through its own functions at the JAX example's defaults (``SSD``:
   TinySSD, batch 16, 32 px, 192 anchors, 60 batches of its synthetic
   data, sgd lr 0.05), f32 with TF32 off, the counters set to 0 just
   before: every loss finite, the mean loss of the last 20 batches below
   the first 20's, the decode (16, 192, 6) with rows kept, no launch of
   K1-K7, R1 or R2 (the path is cuDNN and torch ops); ``ssd_step_ms``
   (median of steps 3-60) and img/s; 3j-ii, the multibox head at the
   graded config's scale (``SSD300``: SSD300 over vgg16_reduced, 8732
   anchors from six ``MultiBoxPrior`` maps, batch 32, 21 classes, 1-40
   synthetic boxes an image, ``MultiBoxTarget`` with 3:1 hard negatives,
   softmax, ``MultiBoxDetection`` with NMS 0.45 over the top 400):
   ``multibox_target_ms`` and ``multibox_detection_ms`` (CUDA events,
   median of 5; detection also without NMS), the launches a call, the
   counts of positives, mined negatives, ignored anchors and kept
   detections; the card held to the CPU (positive masks and class
   targets equal, loc targets within 1e-5, kept detections equal but
   rows within 1e-6 of a threshold, counted);
3k. the symbolic deploy path (``SYMBOLIC``): ``resnet50_v1(ghost_bn=16)``
   (batch 64, 224 px, f32, Xavier from the seeded generator, cuDNN
   deterministic) exported into a temporary directory (ms, bytes of both
   files); ``SymbolBlock.imports`` of the files in inference equal to
   the Gluon net's eval output; ``model.load_checkpoint`` onto the card
   and ``simple_bind``, whose shape inference runs K1/K2/K3's wrappers
   on ``meta`` tensors and launches nothing; one Executor
   ``forward(is_train=True)`` + ``backward(head)`` bit-equal to the Gluon
   step on the same batch, weights and head gradient (output, 161
   argument gradients, 106 running stats), each 53/53/1 launches;
   ``symbol_step_ms`` and ``gluon_step_ms`` (medians of steps 2-5, host
   clock between synchronizations, every step 53/53/1) and one more step
   of each under the profiler (CUDA activities, busy ms); the exported
   symbol under ``SoftmaxOutput`` fine-tuned by ``mx.mod.Module`` for 8
   steps on one batch (sgd lr 0.01, momentum 0.9; 53/53/1 a step, the
   last loss below the first); then an LSTM-like ``foreach``, a
   ``while_loop`` and a ``cond`` (forward and backward) and
   ``potrf``/``trsm``/``syevd``/``gelqf``/``slogdet`` card against CPU
   (f32, TF32 off; the limits by ``CF_OUT_TOL``), launching nothing;
3l. data parallelism (ROADMAP A8), ``DP_RANKS`` ranks started by
   ``tools/launch_torch.py`` sharing the card over gloo (NCCL refuses two ranks
   on one device; gloo stages CUDA tensors through the host, so these
   step times are correctness figures, not NCCL's), each rank this
   script with ``--dp-rank`` running (i)-(iii) in turn: (i)
   ``cifar10_dist_torch.py`` at its defaults (kv ``dist_sync_device``)
   through its ``main``: each rank's epoch losses finite and falling, the
   trained parameters bit-equal across the ranks; (ii) the main path at
   batch ``BATCH`` over dp=2 with ``zero=1`` (``DP``): 53/53/1 launches
   a rank a step, the ranks' losses and state bit-equal, each step's loss
   within 4x the noise floor of one process stepping the whole batch
   (plain, halves swapped, weights nudged 1e-6) plus ``DP_FLOOR_ADD``,
   the running stats within 4x that floor's plus 1e-3; then the same
   steps in f32 (TF32 off, ``DP_F32_STEPS``), where the update's relative
   L2 difference from one process's is held within 4x the floor's, a
   limit that the faults a dp step can make (no update, gradients summed
   and not averaged, a step on rank 0's half alone; each stood in for by
   one process) must exceed; (iii) ``train_imagenet_torch.py --kv-store
   dist_sync_device`` at its defaults through its ``main``: the ranks'
   losses, last loss and state equal, the first ``DP_IMAGENET_STEPS``
   losses within 4x the noise floor of the trainer's step in one process
   (halves swapped, weights nudged) plus ``DP_FLOOR_ADD``, a limit that
   the step on rank 0's half alone must miss; (iv) NCCL at world size 1,
   in a process of its own (``--dp-nccl``): a ``dist_sync``
   push/pull, a ``Trainer.step`` over that store and the dp step equal
   bit for bit to the plain one.  ``dp_step_ms``
   of each route, with the backend;
3m. multi-process checkpoints and the elastic restore on the main path
   (``ELASTIC``): ``resnet50_v1(ghost_bn=16)`` at batch 256 as dp=2 x
   128 with ``zero=1`` (phase 3l (ii)'s step at lr 0.1), fed a resident
   synthetic set of 1024 images by ``ResilientIter(NDArrayIter(...,
   shuffle=True))`` (every rank holds the set and steps on its rows of
   each global batch), cuDNN deterministic in every process.  (1) Two
   ranks (this script with ``--elastic-rank DIR train``) take 4 steps at
   53/53/1 launches a rank a step and commit a checkpoint of step 2; in
   the step-4 save rank 1 dies mid-stage
   (``fault_injection.host_loss_during_save``) and rank 0 must raise
   ``CheckpointError`` naming the done-marker, with only step 2
   committed and the torn stage on disk; the step-2 manifest holds two
   shard files of each ZeRO leaf, one from each rank, and both ranks'
   iterator states.  (2) This process resumes at dp=1 from another
   seed: the restored step is 2, the logical state (parameters, running
   stats, the optimizer state without its padding, step, loss scale) has
   the ranks' SHA-1 digests, it re-saves at dp=1, and its next two
   batches are the ranks' steps 3 and 4, its step-3 loss within phase 3l
   (ii)'s first-step loss limit of theirs.  (3) Two ranks (``--elastic-
   rank DIR restore``) restore that dp=1 checkpoint: the digests again,
   and steps 3 and 4 with the first job's losses bit for bit.  Printed:
   the step-2 save ms and bytes of each rank, rank 0's commit wait, the
   seconds from the kill to rank 0's refusal, both restores' ms;
3n. model parallelism (ROADMAP A8 items c and d), ``DP_RANKS`` ranks
   started by ``tools/launch_torch.py`` sharing the card over gloo (as 3l: a
   real job has a card a rank, so the step times are correctness
   figures), each rank this script with ``--mp-rank``, f32 with TF32
   off, the sizes in ``MP``: (i) ``train_lm_torch.py --devices 2`` built
   through its own functions at phase 3b's width (dim 1024, 8 heads, seq
   2048, batch 4, 2 layers, vocab 256), ``--impl ring`` then ``--impl
   ulysses``, 3 steps each with the counters set to 0 just before: every
   loss finite, the replicas bit-equal, K4/K5/K6 launched exactly 2/2/2
   a rank a step under Ulysses and never under ring, and step 1's loss
   and the gradients of the 14 weight matrices within 4x the floor of
   the one-process LM on the card plus ``MP_LM_ADD``: for Ulysses (the
   same flash kernels) its weights nudged 1e-6, for ring (blockwise f32
   attention) also the flash kernels against the plain dense attention
   in one process; ``sp_step_ms_ring``, ``sp_step_ms_ulysses`` and the
   collectives a step; (ii) ``make_train_step(pipeline_stages=2,
   num_micro=4)`` over ``{"pp": 2}`` on 8 ``Dense(1024, tanh)`` (labels
   of 256 classes on their output: a ``Dense(256)`` head would break
   the stages' congruence), batch 256, one sgd step at unit lr: the
   gradients within ``MP_PP_TOL`` of max |g| of the one-process step,
   remat within 1e-6 of no remat, no kernel launched, ``pp_step_ms``;
   (iii) ``Dense(1024,
   relu)`` -> ``MoEFFN(4096, 8 experts, top_k=2, capacity_factor=2.0)``
   -> ``Dense(256)`` on 4096 tokens over ``{"dp": 1, "ep": 2}`` with the
   experts sharded (4 a rank), 3 steps at lr 0.1 against ep=1 on the
   card: losses within ``MP_MOE_LOSS_TOL``, parameters within
   ``MP_MOE_PARAM_TOL`` of each tensor's largest update, the replicated
   parameters bit-equal, no kernel launched, ``moe_step_ms``;
3o. the supervised main path: phase 3m's step and data under
   ``parallel.supervisor.run_supervised`` to step 8 with a checkpoint
   every 2 steps (``SUPERVISED``), cuDNN deterministic.  (0) The
   unfaulted run at dp=1 in this process (``supervised_step_ms``, the
   heartbeat's ms, each save's ms) and bare steps of the same step
   (``step_ms``: the batch, the step, the loss read back).  Then jobs of
   ranks (this script with ``--supervised-rank DIR``) that a
   ``Supervisor`` here starts through ``tools/launch_torch.py``, each
   rank in a session of its own, the card's free memory checked before
   every relaunch, every call's K1-K3 launches 53/53/1: (i)
   ``kill_process`` at call 3, dp=1: respawned, restored from step 2,
   its losses and final state's digest the unfaulted run's; (ii)
   ``loss_bomb`` at call 4: a divergence verdict (printed) rolls back
   in-process to step 4, final digest the unfaulted run's; (iii)
   ``hang_step`` at call 3: the heartbeat gap (the calibrated stall
   timeout printed), a respawn, as (i); (iv) dp=2 with no restart
   budget, rank 1 killed in its second save: shrunk to dp=1, which
   restores the dp=2 checkpoint and finishes; every ledger's events and
   no torn checkpoint checked, MTTR printed.  (v) ``sync="async"`` at
   batch 256 with ``staleness_bound=0`` and no loss scale against
   ``sync="allreduce"``: 2 steps bit-equal (the service runs the same
   update), then ``async_step_ms``, then 2 steps with
   ``compression="2bit"`` (finite losses).  (vi) ``tools/
   supervise_torch.py --chaos all --format json`` with its ranks on the
   card, beside (i)-(v): all five scenarios green, exit 0;
3p. serving (``serve/``), f32 with TF32 off, cuDNN deterministic: (i)
   ``bench.py``'s serve leg in the port: ``resnet50_v1(classes=1000)``,
   Xavier from seed 0, 224 px, ``ServeEngine`` at buckets (16, 64) (one
   CUDA graph a bucket and parameter slot), ``ContinuousBatcher`` with
   ``max_delay`` 10 ms, ``poisson_loadtest`` at 400 req/s, 200 requests
   from a pool of 8 images (``RandomState(0)``): ``serve_qps``, p50/p95/
   p99, errors, shed, occupancy, the captures after warmup (must be 0),
   warmup's eager and capture seconds; (ii) each bucket's replay
   bit-equal to the eager forward of the same padded batch, a row
   bit-equal whatever its batch-mates, the unpadded forward at batch 5
   within ``SERVE["unpadded_tol"]``, the served logits against the CPU
   forward (K3's plain version) within 4x the CPU's own noise floor
   (every weight nudged by 1e-6) plus ``SERVE["cpu_add"]`` of the
   largest logit, one K3 launch a captured bucket program and none
   during traffic; ``infer`` of a full bucket (host clock) and its parts
   alone (rows wrapped, the pageable H2D copy beside a pinned one, the
   replay, the rows cloned; host clock and CUDA events); (iii) a
   perturbed candidate committed under traffic, a ``nan_params``
   candidate rolled back with the live slot bit-equal, ``swap_storm``
   (one poisoned candidate) under a ``poisson_loadtest``: no capture, no
   hung future, every row attributed; (iv) ``tools/serve_bench_torch.py
   --model resnet50 --chaos`` at the same settings, its fallback the
   int8 tier, then its swap storm against a storm-free baseline (exit 0:
   no hung future, no capture after warmup, the poison rolled back,
   every row one version, the storm's p99 within the baseline's x 10 +
   250 ms); (v)
   ``CachedDecoder`` against full recompute over the sliding window
   (``SERVE["decode_tol"]``), step for step through a ring wraparound:
   at ``TinyDecoderLM``'s defaults (batch 4, seq bucket 32, 40 steps past
   an 8-token prompt), then at 3b's LM widths with a 32000-token
   vocabulary (batch 8, seq bucket 2048, 2000 steps past a 128-token
   prompt), where ``decode_step_ms`` (one step: token copy, graph replay,
   logits clone; host clock), the replay's device ms and the step's byte
   bound are read;
3q. the int8 serve leg: 3p's settings (``resnet50_v1``, Xavier from seed
   0, 224 px, buckets (16, 64), Poisson 400 req/s, 200 requests, 10 ms
   flush, TF32 off, cuDNN deterministic) at ``dtype="int8"``: (i) one K3
   launch a captured int8 program, one slot's resident bytes int8
   against f32; (ii) ``serve_bench_torch.py``'s ``run_leg`` for the f32
   engine and the int8 one on the same traffic (``gc.collect()`` before
   each), ``serve_qps``, p50, p99
   and ``serve_int8_p99_delta_ms``, no capture after warmup, no hung
   future, no launch through a wrapper during traffic; (iii) the codes
   made on the card equal to the CPU's ``quantize_tensor`` bit for bit,
   the int8 logits within ``INT8_SERVE_TOL`` of the largest logit of the
   f32 engine serving ``dequantize_tensor`` of the same codes, and their
   error against the f32 weights for information; (iv) a candidate with
   a NaN in a float parameter rolled back, the codes and amax bit-equal;
3r. ``bench.py --mode infer-int8`` in the port (``INT8_INFER``):
   ``resnet50_v1`` exported, ``fold_batch_norm``,
   ``quantize_model(calib_mode="none")``, batch 128, 224 px,
   ``RandomState(0)`` uniform input, through the ``Executor``: the bf16
   leg on the folded graph and the int8 leg, each the best of 3 chunks
   of 20 forwards after a first forward (``resnet50_int8_infer_img_per_
   sec``, the bf16 img/s, ``int8_over_bf16``); K3 once a bf16 forward and
   never an int8 one (the int8 pool is the plain path, as the
   reference's ``reduce_window``); at batch 8 (``quantize_v2``'s range
   is the batch's) the stem's int32 accumulator card against CPU bit for
   bit and the logits card against CPU within the CPU's own floor (the
   input nudged by 1e-6);
3s. the flywheel: ``tools/flywheel_torch.py`` at its defaults on the card,
   then ``--chaos loss_bomb`` (the bombed checkpoint quarantined at the
   metric stage, no promotion from it, the engine's rollbacks 0) and
   ``--chaos swap_storm`` (every row one version), each exit 0;
3t. ``gluon.data`` and the Estimator (``ESTIMATOR``): (i) ``Estimator.fit``
   on phase 3g's net and trainer (stock-BN ``resnet50_v1``, 1000
   classes, 224 px, f32, sgd lr 0.05 momentum 0.9), with
   ``SoftmaxCrossEntropyLoss``, ``metric.Accuracy`` and a
   ``CheckpointHandler``, one epoch over ``ImageRecordDataset`` of phase
   3d's shard through ``RandomResizedCrop``, ``RandomFlipLeftRight``,
   ``ToTensor`` and ``Normalize`` in a ``DataLoader`` (batch 64,
   shuffled, the last short batch dropped, 4 thread workers: 8 batches)
   and validation on 64 images: every loss finite, every batch a (64, 3,
   224, 224) f32 array on the card, K3 once a train forward and once a
   validation forward and nothing else launched, the checkpoint's
   ``.params`` loaded into a fresh CPU net bit for bit; the first batch
   of a 0-worker loader on the card equal to its rebuild on the CPU under
   the same seeds (the transforms run on the host: bound 0);
   ``estimator_step_ms`` (batch end to batch end, the card synchronized,
   median of the steady batches) with its compute and input-wait parts,
   ``loader_batch_ms`` at 0 and 4 workers; (ii) the fixed-transform
   loader with ``thread_pool=False`` and 2 spawned workers: the thread
   loader's batches bit for bit, ``torch.cuda.is_initialized()`` false in
   every worker that reported, none left running; (iii) with TF32 off,
   ``_contrib_DeformableConvolution`` at batch 8, 64 channels, 56x56,
   3x3, 2 deformable groups, random offsets in [-2, 2], and
   ``PixelShuffle2D``, ``HybridConcurrent``, a ``Conv2DLSTMCell`` and an
   ``LSTMPCell`` unrolled 4 steps: outputs and input gradients card
   against CPU within 4x the CPU's own difference under a 1e-6 nudge of
   the inputs; the op's forward and forward + backward ms beside
   ``F.conv2d``'s (``deform_conv_ms``, CUDA events); (iv) a
   ``SoftmaxCrossEntropyLoss`` composed on ``sym.var``s and bound by the
   ``Executor`` on the card, and a ``SequentialRNNCell`` of two
   ``LSTMCell``s likewise, equal to the Gluon calls within 1e-6;
3u. ``contrib.amp`` (``AMP``): (i) phase 3g's loop (stock-BN
   ``resnet50_v1``, 224 px, 1000 classes, batch 64, sgd lr 0.05 momentum
   0.9) built through ``image_classification_torch.py``'s functions
   with ``--amp bfloat16``: ``amp.init``, ``amp.init_trainer``,
   ``amp.scale_loss``, 8 steps: every loss finite and float32, every
   Conv2D and Dense output bfloat16 and every BatchNorm output float32
   (forward hooks, first step), K3 once a step and nothing else,
   ``amp_step_ms`` beside 3g's ``gluon_step_ms``; its first step at batch
   8 on the card and on the CPU from the same weights, and on the CPU
   in three runs with every weight nudged by 1e-6 (relative, as phase
   5; ``_amp_step_diffs``): the loss, the logits, the running stats and
   the update's norm ratio (the whole model's and the median tensor's)
   card-vs-CPU at most 4x the largest nudged run's (``AMP_HELD_FULL``:
   the update's direction is printed, not held, its floor saturates at
   this size), and the card's update made zero or doubled must miss
   that gate; the same at ``AMP_SMALL`` (``resnet18_v1``, 64 px) with
   the update's cosine held too and a negated update missing the gate;
   float16 (``amp_overflow_on_card``, batch 8): a planted inf gradient
   at the 2^16 scale skips the step with every parameter bit-equal and
   halves the scale, each later step is applied at its scale when its
   gradients are finite and skipped with the scale halved when not,
   until one is applied; (ii) phase 3k's
   ``resnet50_v1(ghost_bn=16)`` (Xavier weights, running stats drawn in
   numpy) exported, read back by ``model.load_checkpoint`` and rewritten
   by ``amp.convert_model``: 109 ``amp_cast`` nodes, the reference's
   count on the same graph (``tests/test_torch_amp.py``); both graphs
   bound in the ``Executor`` at batch 64, 224 px, inference: the
   converted graph's logits bf16, finite and within 5 % of the f32
   graph's largest logit, top-1 agreement printed, K3 once a forward,
   ``amp_convert_img_per_sec`` beside the f32 graph's; (iii) with TF32
   off, every op of the tail (``_tail_op_cases``: the 47 ops less the
   zero-input two, some in two modes, and 1-D and 3-D ``Pooling``) and
   the 23 new layers (``_tail_layer_cases``) at moderate shapes: each
   floating output and input gradient card against CPU within 4x the
   CPU's own difference under a 1e-6 nudge of the inputs and
   cotangents (not of index inputs, ``_TAIL_INDEX_INPUTS``, whose
   readings are printed), integer outputs equal; ``_linspace`` within
   one f32 step and ``_eye`` exact; no kernel launched;
3v. the NumPy frontend (``NP_PATH``): the zoo's stock-BN ``resnet50_v1``
   (1000 classes, Xavier weights from ``SEED``) written in ``mx.np``/
   ``mx.npx`` calls over the zoo net's parameters
   (``example/numpy/resnet_np.py``), 224 px, batch 64, f32 with TF32 off
   and cuDNN deterministic: uint8 NHWC images (288 x 320, from ``SEED``)
   through ``_image_resize`` to 256, ``_image_crop`` to 224,
   ``to_tensor`` and ``_image_normalize`` on the card, then 3 steps under
   ``autograd.record()``, each updating every trained parameter by one
   ``nd._multi_adamw_update`` call: (i) K3 once a step and nothing else;
   (ii) the first step's logits, loss, gradients and running stats bit
   for bit those of the Gluon net's ``net(x)`` and ``backward`` from the
   same weights and batch (the same registered ops run in both), a
   zeroed and a doubled gradient missing; (iii) that update against a
   per-tensor plain AdamW on the card within 1e-6 of each tensor's
   magnitude (a doubled step misses), and ``_multi_mp_adamw_update``
   over the same parameters in bf16 with f32 masters likewise;
   ``np_step_ms`` (the mean of steps 2-3) beside phase 3g's
   ``gluon_step_ms``, its forward + backward beside the Gluon net's on
   the phase's settings;
   (iv) the first step at ``NP_SMALL`` (``resnet18_v1``, 64 px, batch
   8) card against CPU and three CPU runs nudged by 1e-6, AMP's
   readings (phase 3u) within 4x the largest nudged run's, the card's
   update made zero, doubled or negated missing; (v) with TF32 off,
   every case of ``tools/np_surface_cases.py``: each name of ``mx.np``'s
   two sets at small shapes and the shape-agnostic ones again at
   moderate shapes (192 x 256, products of 8 x 64 x 48), ``mx.np.linalg``
   and ``mx.npx`` (forward, and backward for
   the differentiable set and npx) card against CPU within 4x the CPU's
   1e-6-nudged floor, integer, index and host outputs equal (index
   inputs not nudged), ``svd``/``qr``/``eigh`` rebuilt within 1e-5, and
   the samplers of ``mx.np.random`` and of the registry drawn on the
   card within 6 standard errors of their mean and variance;
3w. the op registry's tail (``LARS``, ``BERT``, ``RPN``), TF32 off and
   cuDNN deterministic: (i) upstream MXNet 1.6's large-batch ResNet-50
   recipe: the zoo's stock-BN ``resnet50_v1`` (1000 classes, Xavier
   weights from ``SEED``), 224 px, batch 64, f32, a registered
   ``CustomOp`` softmax head (forward ``softmax`` in nd ops, backward
   ``(p - onehot(label)) / batch``), 3 steps each updating every trained
   tensor by one call each of ``multi_sum_sq`` (weights, then
   gradients), ``multi_lars`` and ``preloaded_multi_sgd_mom_update``
   (momentum 0.9, lr 0.1, wd 1e-4, eta 0.001): K3 once a step and
   nothing else; the first step's logits bit for bit those of the same
   net under ``SoftmaxCrossEntropyLoss``, its gradients within
   ``LARS_GRAD_TOL`` (1e-4) of each tensor's largest magnitude, the
   worst three printed by name (a doubled head gradient misses); the
   update 0 from its per-tensor plain version,
   and ``preloaded_multi_mp_sgd_mom_update`` on bf16 copies with f32
   masters likewise (a doubled step misses each); ``lars_step_ms`` (the
   mean of steps 2-3) beside 3g's ``gluon_step_ms``; (ii) BERT-base
   self-attention (GluonNLP ``BERTEncoder`` widths: 768 units, 12 heads,
   seq 512, batch 8, f32): ``_contrib_interleaved_matmul_selfatt_qk`` ->
   ``softmax`` -> ``_contrib_interleaved_matmul_selfatt_valatt``,
   forward and backward, against ``_contrib_flash_attention`` (K4, K5/K6)
   on the same q, k, v: the output and dq, dk, dv against f64 within 4x
   the kernels' floor, measured in the run as the same attention in
   plain torch with every product in the kernels' 3xTF32 split
   (``_mm_3xtf32``) against f64 on the card; each reading is printed
   against the interleaved f32 path's own f64 floor too (K4-K6's
   products are good to ~2^-21, f32 ones to 2^-24); a doubled output
   missing; K4-K6 once each; ``interleaved_attn_ms`` beside K4-K6's;
   (iii) the Faster R-CNN RPN's ``Proposal`` at
   ``example/rcnn``'s VGG-16 test setting (a 600x1000 image, its 38x63
   map, 9 anchors, pre-NMS 6000, post-NMS 300, IoU 0.7, min size 16)
   from seeded numpy inputs, and ``MultiProposal`` at batch 2: rois and
   scores on the card equal to the CPU's; ``proposal_ms``; (iv) every
   other new name (``_w_cases``) at moderate shapes card against CPU
   within 4x the CPU's 1e-6-nudged floor, integer outputs equal, each
   nonzero floating tensor made zero, doubled and negated missing;
   ``Custom`` with two outputs eager (equal to its nd expression),
   recorded and through ``mx.sym`` into an ``Executor`` (equal to the
   recorded call); the ``*_like`` samplers' moments on the card and
   ``_sample_unique_zipfian``'s candidates distinct; no kernel launched
   in (iii) and (iv);
4. time each kernel at the shapes the paths gave it (K1 and K2 summed
   over one step's 53 layers, and K3 at the stem, each launch and its
   plain version by the profiler's device time with the L2 flushed, as
   phase 4c; the others by CUDA events; K4-K6 at one layer's attention),
   beside its plain version, its bound and, where one PyTorch call
   computes the same function, that call (``F.max_pool2d`` for K3, on
   the flushed clock, ``F.scaled_dot_product_attention`` for K4, its
   backward for K5 and K6 together); plus K4 and SDPA at (1, 8, 8192,
   128), and K4-K6 and SDPA at (4, 4, 2048, 256) causal f32 (the D <= 256
   form) and at (4, 2, 2048, 512) (the D-streamed form; the kernels SDPA
   ran are named).  With ``--before DIR`` (a tree unpacked there, as
   ``tools/bn_kernel_bench_torch.py --before`` takes it) the K1, K2 and
   K3 of that tree are built; K3 is also timed at four zoo shapes
   (``ZOO_TIMED``: VGG 2x2/2 at 224, AlexNet 3x3/2 at 55, SqueezeNet's
   ceil mode at 111, Inception at 147; batch 32, bf16) and at LeNet's
   two pools (f32, batch 64) beside its plain
   version, ``F.max_pool2d(return_indices=True)`` and its byte bound, on
   the flushed clock; K1 and K2 are summed over the same 53
   layers and K3 timed at the stem on the same clock, in the order
   before, now, now, before.  Bounds are the larger
   of bytes over 3.35 TB/s and operations over the f32 CUDA cores' 67
   TFLOP/s; K4-K6 also carry
   ``tc_bound_ms``, their 3xTF32 bound on the tensor cores (three TF32
   passes of every product at 495 TFLOP/s), and ``ms_over_library``
   (K5 and K6 each over SDPA's whole backward; a line gives K5 + K6 over
   it);
4c. K7 at the 9 BN shapes (with its channels a block, ``kc``) beside
   ``Tensor.copy_``, K1 and K2 (through ``tools/bn_kernel_bench_torch.py``),
   with K1 and K2 as a share of K7's time (what they cost beyond the
   walk over contiguous runs that K7 copies with), and R1 beside
   ``torch.add(1, x, alpha=2)``: all on one clock, the profiler's device
   time a launch with the L2 flushed (256 MB written) before every
   launch; the K7 and R1 rows carry ``ms_over_library``.  R2 beside its
   bound and ``torch.matmul`` (TF32 off), both by the profiler's device
   time (unflushed), with ``tc_bound_ms`` and ``ms_over_library`` as K4;
   K7's launches are those of this sweep; beside the kernel rows, the
   fused ``RNN`` op at phase 3i's LSTM (forward plus backward through
   cuDNN, held to its plain step loop at 1e-4 first) beside that loop,
   ``torch.nn.LSTM`` on its own packed weights and the GEMM FLOP bound;
5. one f32 step (TF32 off) of ``resnet50_v1(ghost_bn=16)`` at batch 16,
   64 px on the card and on the CPU from the same weights and batch;
5b. one f32 step of a small LM (dim 128, 8 heads, seq 256, batch 2, 2
   layers) on the card and on the CPU from the same weights;
5c. one f32 step of the Gluon example's loop at ``resnet18_v1``, 32 px,
   batch 16 on the card and on the CPU from the same weights (copied by
   name), held to phase 5's noise floor;
5d. one f32 step of ``train_mnist_torch.py``'s LeNet Module at batch 16
   (sgd lr 0.1, momentum 0.9) on the card and on the CPU from the same
   weights: the outputs (as phase 5's running stats), their
   cross-entropy (as its loss), the parameter updates and the momentum
   held to phase 5's noise floor;
5e. one f32 step (TF32 off) of ``train_torch.py``'s WordLM at vocab 256,
   embedding 64, hidden 128, batch 8, bptt 16 on the card and on the CPU
   from the same weights: the logits (within 1e-5), the loss and the
   updates held to the noise floor (4x plus 1e-4); the same step with
   TF32 on is printed beside it;
5f. one f32 step (TF32 off) of ``example/ssd/train_torch.py``'s TinySSD
   at batch 16, 32 px on the card and on the CPU from the same weights:
   the heads' outputs (within 1e-5), the loss and the gradients held to
   the noise floor (4x plus 1e-4);
6. print the kernels' JSON line, the card line, and the result line.

Tolerances of phase 2 (kernel against plain version on the same inputs):
f32 outputs within 1e-4 of the reference's largest magnitude (sums in
another order), bf16 outputs within 2^-7 of it (a value computed in f32
on both sides may round one bf16 step apart), the f32 statistics and
dgamma/dbeta sums within 1e-3 of it; max pooling exact (NaN where the
plain version has NaN).  Flash
attention: O and the LSE of rows that see a key as above; dQ, dK and dV
within 1e-3 (f32: each sums up to 2048 products, in another order) or
2^-6 (bf16: the gradient is rounded once, from a larger f32 sum);
rows that see no key exactly 0 in O and dQ, and their LSE below -5e29
on both sides.

Phase 5b: the LM has no ReLU or max-pool ties, so its step is not
chaotic like the ResNet's; it is held to the loss within 1e-5
(relative) and every parameter after the step within 1e-4 of its
largest magnitude.

Phase 5 compares against a noise floor measured in the same run.  This
step is chaotic at random init: nudging every CPU weight by 1e-6
(relative) moves the updates of some tensors by tens of percent (the
forward amplifies the nudge block by block, and the BN backward turns
that into update noise; phase 5 prints the floor).  So the CPU step is run
twice, plain and nudged, and the card must stay within the CPU's own
noise: loss within 1e-4 of the CPU's (relative), running stats within
1e-3 of each tensor's largest magnitude (forward quantities, well
conditioned), and the per-tensor relative update differences card-vs-CPU
at most 4x the nudged-vs-CPU ones plus 1e-3, both in their median over
the 161 parameters and in their maximum (a kernel fault moves most
tensors by O(1), which the median catches).
"""
import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

STEPS = 6          # main-path steps; the first is warm-up for the timing
BATCH = 256
IMAGE = 224
SEED = 0
# the long-context LM at bench.py --mode attention's shapes
LM = dict(vocab=256, dim=1024, heads=8, n_layers=2)
# the same LM at head dim 256 (train_lm_torch.py --dim 1024 --heads 4) and
# 512 (--heads 2)
LM_HEADS_D256 = 4
LM_HEADS_D512 = 2
LM_SEQ, LM_BATCH = 2048, 4
# the example's lr 0.05 suits its dim-128 default; at dim 1024 its update
# (momentum 0.9) diverges by the third step, in the JAX example as in the
# port, so the full-width run takes 0.01
LM_LR = 0.01
LM_SMALL = dict(vocab=256, dim=128, heads=8, n_layers=2)
FLASH = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
# the nd path: one attention layer of the LM at its width (phase 3c)
ND_TOL = 1e-4
RTC = ("scale_kernel", "mm_kernel")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores, dense TF32 FLOP/s on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
#: f32 operations per element: K1 (sum, square-sum, scale, shift,
#: residual add, ReLU), K2 (xhat, mask, two reductions, dX), K3 (compares)
OPS_FWD, OPS_BWD = 7, 12


def _card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _check(name, got, want, frac):
    """Raise unless ``got`` is within ``frac`` of ``want``'s largest
    magnitude (at least 1); returns the max abs error."""
    err = _max_err(got, want)
    limit = frac * max(1.0, want.float().abs().max().item())
    print("  %-44s max_abs_err %.3e  limit %.3e" % (name, err, limit),
          flush=True)
    if not err <= limit:
        raise AssertionError("%s: max abs error %g over %g" % (name, err,
                                                              limit))
    return err


def _time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_kernels(dev, errs):
    """Phase 2."""
    import torch

    from incubator_mxnet_tpu_torch.parallel import fused_bn

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev)

    n = BATCH
    # (label, shape, act, residual, donate, dual)
    cases = [("stem", (n, 64, 112, 112), "relu", False, False, False),
             ("56x56x256 dual exit", (n, 256, 56, 56), "relu", True, False,
              True),
             ("28x28x512 donated exit", (n, 512, 28, 28), "relu", True, True,
              True),
             ("28x28x512 downsample BN", (n, 512, 28, 28), "none", False,
              False, False),
             ("7x7x2048 final exit", (n, 2048, 7, 7), "relu", True, False,
              False)]
    # phase 3g-ii's batch: a quarter of the ghost groups per channel
    m = GLUON_FUSED_BATCH
    cases += [("stem N=%d" % m, (m, 64, 112, 112), "relu", False, False,
               False),
              ("56x56x256 dual exit N=%d" % m, (m, 256, 56, 56), "relu",
               True, False, True),
              ("7x7x2048 final exit N=%d" % m, (m, 2048, 7, 7), "relu",
               True, False, False)]
    for dtype in (torch.bfloat16, torch.float32):
        out_frac = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
        for label, shape, act, res, donate, dual in cases:
            tag = "%s %s" % (label, str(dtype).split(".")[1])
            ng = fused_bn.ghost_group(*shape, torch.finfo(dtype).bits // 8,
                                      16, res, donate, dual)
            x = (rnd(*shape) * 2 + 0.5).to(dtype)
            r = rnd(*shape).to(dtype) if res else None
            gamma = rnd(shape[1]) * 0.2 + 1
            beta = rnd(shape[1]) * 0.2
            y, m, v = fused_bn.ghost_bn_fwd(x, gamma, beta, r, 1e-5, act, ng)
            yp, mp, vp = fused_bn._gbn_fwd_plain(x, gamma, beta, r, 1e-5, act,
                                                 ng)
            errs["ghost_bn_fwd"].append(
                _check("K1 y    " + tag, y, yp, out_frac))
            _check("K1 mean " + tag, m, mp, 1e-3)
            _check("K1 var  " + tag, v, vp, 1e-3)
            del yp, mp, vp
            gy = rnd(*shape).to(dtype)
            gy2 = rnd(*shape).to(dtype) if dual else None
            ys = y if res else None
            dx, dg, db, dr = fused_bn.ghost_bn_bwd(gy, gy2, x, ys, gamma,
                                                   beta, m, v, 1e-5, act, ng)
            dxp, dgp, dbp, drp = fused_bn._gbn_bwd_plain(
                gy, gy2, x, ys, gamma, beta, m, v, 1e-5, act, ng)
            dx_tag = tag
            if act == "relu" and not res:
                # K2 recomputes its ReLU mask from x; leave out the
                # elements whose mask f32 rounding cannot decide
                edge = _relu_edge(x, gamma, beta, m, v, 1e-5, ng)
                zero = torch.zeros((), dtype=dtype, device=dev)
                dx = torch.where(edge, zero, dx)
                dxp = torch.where(edge, zero, dxp)
                dx_tag += " (%d at the ReLU edge left out)" % int(edge.sum())
                del edge
            errs["ghost_bn_bwd"].append(
                _check("K2 dx   " + dx_tag, dx, dxp, 2 * out_frac))
            _check("K2 dgam " + tag, dg, dgp, 1e-3)
            _check("K2 dbet " + tag, db, dbp, 1e-3)
            if res:
                _check("K2 dR   " + tag, dr, drp, out_frac)
            del x, r, y, gy, gy2, dx, dxp, dr, drp
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32, torch.float16,
                  torch.float64):
        _check_pools(dtype, rnd, errs)


def _relu_edge(x, gamma, beta, mean, var, eps, ng):
    """The elements of a ghost-BN ReLU whose mask f32 rounding cannot
    decide: the pre-activation (x - mean) rstd gamma + beta, in f64 from
    the kernel's statistics, within 2^-20 of the magnitude of its terms
    from 0 (K1's x a + b and K2's xhat gamma + beta each round a few
    times at 2^-24)."""
    import torch

    n, c, h, w = x.shape
    g = n // ng
    x5 = x.double().reshape(g, ng, c, h, w)
    a = gamma.double().reshape(1, 1, c, 1, 1) \
        * torch.rsqrt(var.double() + eps).reshape(g, 1, c, 1, 1)
    ma = mean.double().reshape(g, 1, c, 1, 1) * a
    bt = beta.double().reshape(1, 1, c, 1, 1)
    xa = x5 * a
    edge = (xa - ma + bt).abs() <= 2.0 ** -20 * (xa.abs() + ma.abs()
                                                 + bt.abs())
    return edge.reshape(n, c, h, w)


def _check_pools(dtype, rnd, errs):
    """Phase 2's K3 rows in one dtype: the stem at BATCH, POOL_CASES,
    LeNet's pools and every pool of the zoo, each bit for bit against
    the plain version."""
    import torch

    x = torch.clamp_min(torch.round(rnd(BATCH, 64, 112, 112) * 2) / 2,
                        0).to(dtype)
    errs["maxpool_idx_fwd"].append(_check_pool("stem", x, POOL_STEM))
    del x
    torch.cuda.empty_cache()
    for label, shape, cfg, layout in POOL_CASES:
        x = torch.clamp_min(torch.round(rnd(
            shape[0] * shape[1] * shape[2] * shape[3] + 3) * 2) / 2, 0)
        x = x.to(dtype)
        if layout == "offset":
            x = x[3:].view(shape)
        elif layout == "permuted":
            x = x[3:].view(shape[0], shape[2], shape[3], shape[1]) \
                .permute(0, 3, 1, 2)
        else:
            x = x[:-3].view(shape).clone()
            if layout == "nan":
                x.view(-1)[::97] = float("nan")
        errs["maxpool_idx_fwd"].append(_check_pool(label, x, cfg))
        del x
    for label, shape in LENET_POOLS:
        x = torch.clamp_min(torch.round(rnd(*shape) * 2) / 2, 0).to(dtype)
        errs["maxpool_idx_fwd"].append(
            _check_pool("LeNet " + label, x, LENET_POOL))
        del x
    torch.cuda.empty_cache()
    for models, (c, h, w), k, s, p, ceil in ZOO_POOLS:
        x = torch.clamp_min(torch.round(
            rnd(ZOO_POOL_BATCH, c, h, w) * 2) / 2, 0).to(dtype)
        label = "%s %dx%d/%d%s%s" % (models.split(",")[0], k, k, s,
                                     " pad %d" % p if p else "",
                                     " ceil" if ceil else "")
        errs["maxpool_idx_fwd"].append(
            _check_pool(label, x, zoo_pool_cfg(k, s, p, ceil)))
        del x
    torch.cuda.empty_cache()


#: 3x3/2 pad 1, the stem's max pool
POOL_STEM = ((1, 1, 3, 3), (1, 1, 2, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))
#: LeNet's two max pools, 2x2/2, at train_mnist_torch.py's batch 64
LENET_POOL = ((1, 1, 2, 2), (1, 1, 2, 2), ((0, 0), (0, 0), (0, 0), (0, 0)))
#: K3 beyond the stem: (label, shape, (window, strides, padding), layout)
POOL_CASES = [
    ("2x2/2", (32, 64, 56, 56), ((1, 1, 2, 2), (1, 1, 2, 2),
                                 ((0, 0), (0, 0), (0, 0), (0, 0))), None),
    ("3x3/1 pad 1", (32, 64, 28, 28), ((1, 1, 3, 3), (1, 1, 1, 1),
                                       ((0, 0), (0, 0), (1, 1), (1, 1))),
     None),
    ("3x3/2 pad (1, 2)", (32, 64, 30, 30), ((1, 1, 3, 3), (1, 1, 2, 2),
                                            ((0, 0), (0, 0), (1, 2), (1, 2))),
     None),
    ("W 113", (8, 16, 113, 113), POOL_STEM, None),
    ("300x300 (bands)", (2, 3, 300, 300), POOL_STEM, None),
    ("NaN inputs", (8, 16, 56, 56), POOL_STEM, "nan"),
    ("offset 3 elements", (8, 16, 57, 57), POOL_STEM, "offset"),
    ("permuted (copied)", (8, 16, 56, 56), POOL_STEM, "permuted"),
]
#: LeNet's pools at train_mnist_torch.py's batch 64, checked in phase 2
LENET_POOLS = [("pool1", (64, 20, 24, 24)), ("pool2", (64, 50, 8, 8))]


#: every distinct max pool of the vision zoo's 34 models (224 px, Inception
#: 299): (models, (C, H, W), kernel, stride, pad, ceil mode); phase 2
#: checks K3 at each at batch ZOO_POOL_BATCH in both dtypes, and
#: tests/test_torch_pooling.py holds the table to the models
ZOO_POOL_BATCH = 32
ZOO_POOLS = [
    ("resnet, densenet stem", (64, 112, 112), 3, 2, 1, False),
    ("densenet161 stem", (96, 112, 112), 3, 2, 1, False),
    ("vgg", (64, 224, 224), 2, 2, 0, False),
    ("vgg", (128, 112, 112), 2, 2, 0, False),
    ("vgg", (256, 56, 56), 2, 2, 0, False),
    ("vgg", (512, 28, 28), 2, 2, 0, False),
    ("vgg", (512, 14, 14), 2, 2, 0, False),
    ("alexnet", (64, 55, 55), 3, 2, 0, False),
    ("alexnet", (192, 27, 27), 3, 2, 0, False),
    ("alexnet", (256, 13, 13), 3, 2, 0, False),
    ("squeezenet1_0", (96, 109, 109), 3, 2, 0, True),
    ("squeezenet1_0", (256, 54, 54), 3, 2, 0, True),
    ("squeezenet1_0", (512, 27, 27), 3, 2, 0, True),
    ("squeezenet1_1", (64, 111, 111), 3, 2, 0, True),
    ("squeezenet1_1", (128, 55, 55), 3, 2, 0, True),
    ("squeezenet1_1", (256, 27, 27), 3, 2, 0, True),
    ("inception_v3", (64, 147, 147), 3, 2, 0, False),
    ("inception_v3", (192, 71, 71), 3, 2, 0, False),
    ("inception_v3", (288, 35, 35), 3, 2, 0, False),
    ("inception_v3", (768, 17, 17), 3, 2, 0, False),
]


def zoo_pool_cfg(kernel, stride, pad, ceil):
    """(window, strides, padding) of ``MaxPool2D(kernel, stride, pad,
    ceil_mode=ceil)``: ceil mode pads the high edge by ``pad + stride -
    1`` (``ops.nn.pooling``'s ``pooling_convention="full"``)."""
    hi = pad + stride - 1 if ceil else pad
    return ((1, 1, kernel, kernel), (1, 1, stride, stride),
            ((0, 0), (0, 0), (pad, hi), (pad, hi)))


def _check_pool(label, x, cfg):
    """K3 against its plain version on ``x``: out (NaN where the plain
    version has NaN) and idx exactly equal, one launch; returns 0.0."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.parallel import maxpool_idx

    before = _kernels.launch_counts()["maxpool_idx_fwd"]
    out, idx = maxpool_idx.maxpool_with_index(x, *cfg)
    launched = _kernels.launch_counts()["maxpool_idx_fwd"] - before
    outp, idxp = maxpool_idx._maxpool_plain(x, *cfg)
    torch.cuda.synchronize()
    nan = torch.isnan(outp)
    same_out = torch.equal(torch.isnan(out), nan) and \
        torch.equal(out[~nan], outp[~nan])
    same_idx = torch.equal(idx, idxp)
    ties = (idxp != 0).float().mean().item()
    print("  K3 %-20s %-22s %-8s out equal %s  index equal %s  (non-first "
          "winners %.3f%s)" % (label, tuple(x.shape),
                               str(x.dtype).split(".")[1], same_out,
                               same_idx, ties,
                               ", %d NaN" % int(nan.sum()) if nan.any()
                               else ""), flush=True)
    if not (same_out and same_idx and launched == 1):
        raise AssertionError("K3 disagrees with its plain version at %s "
                             "(%d launches)" % (label, launched))
    return 0.0


def _flash_module():
    import importlib

    return importlib.import_module(
        "incubator_mxnet_tpu_torch.parallel.flash_attention")


def _lm_module():
    """``example/long_context/train_lm_torch.py``, loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "long_context", "train_lm_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_flash(dev, errs):
    """Phase 2, K4-K6."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels

    fa = _flash_module()
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    bh = LM_BATCH * LM["heads"]
    d = LM["dim"] // LM["heads"]
    # (label, BH, Sq, Sk, D, causal)
    cases = [("LM causal", bh, LM_SEQ, LM_SEQ, d, True),
             ("LM dense", bh, LM_SEQ, LM_SEQ, d, False),
             ("ragged 1000 D64", 8, 1000, 1000, 64, True),
             ("cross 256/128 D16", 8, 256, 128, 16, True),
             # head dims the kernels take zero-padded to a multiple of 8,
             # b*h over 65535
             ("D20 padded", 8, 300, 300, 20, True),
             ("D4 padded 200/136", 8, 200, 136, 4, True),
             ("b*h 70000 S16 D32", 70000, 16, 16, 32, True),
             # the D <= 256 form: 64-row blocks, two warps per 16 rows
             ("D136 300/200", 8, 300, 200, 136, True),
             ("D200 dense 200/300", 8, 200, 300, 200, False),
             ("D256 (4, 4, 2048)", LM_BATCH * LM_HEADS_D256, LM_SEQ, LM_SEQ,
              LM["dim"] // LM_HEADS_D256, True),
             # the D-streamed form: 128 output columns a block, the scores
             # over 32-column chunks of D; a ragged chunk at 264
             ("D264 300/200", 8, 300, 200, 264, True),
             ("D512 dense 200/300", 8, 200, 300, 512, False),
             ("D512 (4, 2, 2048)", LM_BATCH * LM_HEADS_D512, LM_SEQ, LM_SEQ,
              LM["dim"] // LM_HEADS_D512, True)]
    for dtype in (torch.bfloat16, torch.float32):
        out_frac = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
        grad_frac = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-3
        for label, n, sq, sk, dd, causal in cases:
            tag = "%s %s" % (label, str(dtype).split(".")[1])
            before = _kernels.launch_counts()
            q = torch.randn(n, sq, dd, generator=g, device=dev).to(dtype)
            k = torch.randn(n, sk, dd, generator=g, device=dev).to(dtype)
            v = torch.randn(n, sk, dd, generator=g, device=dev).to(dtype)
            do = torch.randn(n, sq, dd, generator=g, device=dev).to(dtype)
            scale = dd ** -0.5
            out, lse = fa.flash_fwd(q, k, v, scale, causal)
            outp, lsep = fa._flash_fwd_plain(q, k, v, scale, causal)
            seen = lsep > -5e29
            errs["flash_attn_fwd"].append(_check("K4 O    " + tag, out, outp,
                                                 out_frac))
            _check("K4 LSE  " + tag, lse[seen], lsep[seen], 1e-4)
            delta = (do.float() * outp.float()).sum(-1)
            dq = fa.flash_bwd_dq(q, k, v, do, lsep, delta, scale, causal)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lsep, delta, scale, causal)
            dqp, dkp, dvp = fa._flash_bwd_plain(q, k, v, do, lsep, delta,
                                                scale, causal)
            errs["flash_attn_bwd_dq"].append(_check("K5 dQ   " + tag, dq, dqp,
                                                    grad_frac))
            errs["flash_attn_bwd_dkv"].append(max(
                _check("K6 dK   " + tag, dk, dkp, grad_frac),
                _check("K6 dV   " + tag, dv, dvp, grad_frac)))
            empty = ~seen
            if not (torch.equal(seen, lse > -5e29)
                    and torch.count_nonzero(out[empty]).item() == 0
                    and torch.count_nonzero(dq[empty]).item() == 0):
                raise AssertionError("%s: rows that see no key are not 0"
                                     % tag)
            if empty.any():
                print("  %-44s %d rows see no key: O, dQ exactly 0"
                      % ("K4/K5 " + tag, int(empty.sum())), flush=True)
            got = {name: _kernels.launch_counts()[name] - before[name]
                   for name in FLASH}
            want = {name: 1 for name in FLASH}
            if got != want:
                raise AssertionError("%s: launches %s, want %s"
                                     % (tag, got, want))
            del q, k, v, do, out, lse, outp, lsep, dq, dk, dv, dqp, dkp, dvp
        torch.cuda.empty_cache()


def _losses_ok(losses):
    return all(v == v and abs(v) != float("inf") for v in losses)


def run_lm_path(dev, heads=LM["heads"]):
    """Phase 3b at ``heads`` heads: returns (losses, step_ms list,
    counts).  Every loss must be finite and the last below the first."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import _kernels, convert

    lmm = _lm_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    lm = lmm.LongContextLM(LM["vocab"], LM["dim"], heads, LM["n_layers"],
                           device=dev)
    convert.lm_params_from_jax(lm, lmm.build_params(
        rng, LM["vocab"], LM["dim"], LM["n_layers"]))
    tokens = torch.from_numpy(lmm.synthetic_tokens(
        rng, LM["vocab"], LM_BATCH, LM_SEQ)).to(dev)
    step = lmm.make_step(lm, LM_LR)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = _kernels.launch_counts()
    losses = [float(v) for v in losses]
    print("  losses %s  step_ms %s" % (["%.5f" % v for v in losses],
                                       ["%.1f" % t for t in step_ms]),
          flush=True)
    if not _losses_ok(losses):
        raise AssertionError("non-finite loss on the LM path: %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("the LM's loss did not fall: %s" % losses)
    want = {name: 0 for name in _kernels.launch_counts()}
    want.update({name: LM["n_layers"] * STEPS for name in FLASH})
    print("  launches %s (want %s)" % (counts, want), flush=True)
    if counts != want:
        raise AssertionError("launch counts %s, want %s" % (counts, want))
    return losses, step_ms, counts


def run_main_path(dev):
    """Phase 3: returns (losses, step_ms list, BN layer configs, counts)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels, initializer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    torch.backends.cudnn.benchmark = True
    net = resnet.resnet50_v1(classes=1000, ghost_bn=16, device=dev)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(SEED))
    step = make_train_step(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                           learning_rate=0.1, momentum=0.9, wd=1e-4,
                           multi_precision=True, loss_scale="dynamic",
                           compute_dtype="bfloat16", device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=g, device=dev)
    y = torch.randint(0, 1000, (BATCH,), generator=g, device=dev).float()

    layers = []

    def record(mod, args):
        xin = args[0]
        if isinstance(mod, resnet.GhostBNReLU) and len(layers) < 53:
            layers.append((tuple(xin.shape), xin.dtype, mod._act,
                           len(args) > 1 and args[1] is not None,
                           mod._donate_residual, mod._dual_out, mod._group,
                           mod._epsilon))

    hooks = [m.register_forward_pre_hook(record) for m in net.modules()
             if isinstance(m, resnet.GhostBNReLU)]
    losses, step_ms = [], []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for i in range(STEPS):
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if i == 0:
            for h in hooks:
                h.remove()
    counts = _kernels.launch_counts()
    losses = [float(v) for v in losses]
    print("  losses %s  skipped %d  loss scale %g  step_ms %s"
          % (["%.5f" % v for v in losses], step.skipped_steps,
             step.loss_scale, ["%.1f" % t for t in step_ms]), flush=True)
    if not _losses_ok(losses):
        raise AssertionError("non-finite loss on the main path: %s" % losses)
    want = {name: 0 for name in _kernels.launch_counts()}
    want.update({"ghost_bn_fwd": 53 * STEPS, "ghost_bn_bwd": 53 * STEPS,
                 "maxpool_idx_fwd": STEPS})
    print("  launches %s (want %s)" % (counts, want), flush=True)
    if counts != want:
        raise AssertionError("launch counts %s, want %s" % (counts, want))
    if len(layers) != 53:
        raise AssertionError("recorded %d ghost-BN layers" % len(layers))
    return losses, step_ms, layers, counts
    # the net, the step and their buffers go out of scope here


# phase 3d: the main path fed from a RecordIO shard, checkpointed and resumed
RECORDS = 512      # bench.py --data recordio's shard (_synth_recordio)
SAVE_AFTER = 3     # run A saves after this step; run B resumes from it
MAIN_PATH = {"ghost_bn_fwd": 53, "ghost_bn_bwd": 53, "maxpool_idx_fwd": 1}


def write_shard(directory):
    """Phase 3d's shard, as ``bench.py``'s ``_synth_recordio`` writes it
    with ``--record-format .npy``, through the port's ``recordio``:
    returns (prefix, seconds, bytes written)."""
    import numpy as np

    from incubator_mxnet_tpu_torch import recordio

    prefix = os.path.join(directory, "synth%d" % IMAGE)
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(RECORDS):
        img = rng.randint(0, 255, (IMAGE, IMAGE, 3), dtype=np.uint8)
        rec.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 1000), i, 0), img, quality=90,
            img_fmt=".npy"))
    rec.close()
    seconds = time.perf_counter() - t0
    return prefix, seconds, sum(os.path.getsize(prefix + ext)
                                for ext in (".rec", ".idx"))


def _recordio_run(dev, prefix, seed):
    """Phase 3's net and step (Xavier from ``seed``) and the bench's
    ``ImageRecordUInt8Iter`` over the shard, on the card."""
    import torch

    from incubator_mxnet_tpu_torch import initializer, io
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    net = resnet.resnet50_v1(classes=1000, ghost_bn=16, device=dev)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(seed))
    step = make_train_step(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                           learning_rate=0.1, momentum=0.9, wd=1e-4,
                           multi_precision=True, loss_scale="dynamic",
                           compute_dtype="bfloat16", device=dev)
    it = io.ImageRecordUInt8Iter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        data_shape=(3, IMAGE, IMAGE), batch_size=BATCH, shuffle=True,
        rand_mirror=True, preprocess_threads=8, prefetch_buffer=8, seed=0,
        ctx=dev)
    return step, it


def _drive(step, it, steps, after=None):
    """``steps`` steps of ``b = next(it)`` (reset on ``StopIteration``, as
    ``bench.py`` does) and ``step(b.data[0], b.label[0])``, the launch
    counters set to 0 just before; every step must launch K1, K2 and K3
    53, 53 and 1 times and nothing else.  ``after(i)`` runs after step
    ``i`` (1-based), outside the timing.  Returns (losses, step_ms,
    iter_ms, h2d_ms, counts)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels

    losses, step_ms, iter_ms, h2d_ms = [], [], [], []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    prev = _kernels.launch_counts()
    for i in range(1, steps + 1):
        t0 = time.perf_counter()
        try:
            b = next(it)
        except StopIteration:
            it.reset()
            b = next(it)
        t1 = time.perf_counter()
        loss = step(b.data[0], b.label[0])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        iter_ms.append((t1 - t0) * 1e3)
        h2d_ms.append(it.h2d_ms())
        losses.append(loss)
        counts = _kernels.launch_counts()
        got = {k: counts[k] - prev[k] for k in counts}
        want = {k: MAIN_PATH.get(k, 0) for k in counts}
        if got != want:
            raise AssertionError("step %d launched %s, want %s"
                                 % (i, got, want))
        prev = counts
        if after is not None:
            after(i)
    return losses, step_ms, iter_ms, h2d_ms, prev


def _host_state(step):
    """The step's whole checkpointed state, copied to the host."""
    from incubator_mxnet_tpu_torch.parallel import checkpoint

    return [(k, v.detach().cpu().clone() if hasattr(v, "detach")
             else v.copy())
            for k, v in checkpoint._flatten(step._checkpoint_state())]


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def run_recordio_path(dev, directory):
    """Phase 3d: run A feeds the main path's step from the shard through
    ``ImageRecordUInt8Iter`` for ``STEPS`` steps and checkpoints after
    step ``SAVE_AFTER`` (the iterator's position included); run B, a new
    net from another seed, a new step and a new iterator, restores it and
    takes the remaining steps, which must equal run A's bit for bit in
    losses and in the whole state.  cuDNN is held to deterministic
    algorithms in this phase.  Returns (metrics, run A's counts)."""
    import numpy as np
    import torch

    prefix, write_s, shard_bytes = write_shard(directory)
    print("  shard: %d records, %d bytes written in %.2f s"
          % (RECORDS, shard_bytes, write_s), flush=True)
    ckpt = os.path.join(directory, "ckpt")
    cudnn = torch.backends.cudnn
    modes = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    saved = {}

    step, it = _recordio_run(dev, prefix, SEED)

    def save(i):
        if i == SAVE_AFTER:
            t0 = time.perf_counter()
            path = step.save_checkpoint(ckpt, data_iter=it)
            saved["ms"] = (time.perf_counter() - t0) * 1e3
            saved["bytes"] = sum(os.path.getsize(os.path.join(path, f))
                                 for f in os.listdir(path))

    losses_a, step_ms, iter_ms, h2d_ms, counts = _drive(step, it, STEPS, save)
    losses_a = [float(v) for v in losses_a]
    final_a = _host_state(step)
    it.close()
    del step, it
    torch.cuda.empty_cache()
    print("  run A: losses %s  step_ms %s"
          % (["%.5f" % v for v in losses_a], ["%.1f" % t for t in step_ms]),
          flush=True)
    if not _losses_ok(losses_a):
        raise AssertionError("non-finite loss on the recordio path: %s"
                             % losses_a)

    step, it = _recordio_run(dev, prefix, SEED + 7)
    t0 = time.perf_counter()
    resumed = step.restore_checkpoint(ckpt, data_iter=it)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if resumed != SAVE_AFTER:
        raise AssertionError("restored step %s, want %d"
                             % (resumed, SAVE_AFTER))
    losses_b = [float(v) for v in
                _drive(step, it, STEPS - SAVE_AFTER)[0]]
    final_b = _host_state(step)
    it.close()
    del step, it
    torch.cuda.empty_cache()
    cudnn.deterministic, cudnn.benchmark = modes
    print("  run B (resumed at step %d): losses %s"
          % (resumed, ["%.5f" % v for v in losses_b]), flush=True)
    if losses_b != losses_a[SAVE_AFTER:]:
        raise AssertionError("resumed losses %s, uninterrupted %s"
                             % (losses_b, losses_a[SAVE_AFTER:]))
    if [k for k, _ in final_a] != [k for k, _ in final_b]:
        raise AssertionError("the resumed state has other leaves")
    for (k, a), (_, b) in zip(final_a, final_b):
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) \
            else np.array_equal(a, b)
        if not same:
            raise AssertionError("leaf %s differs after the resume" % k)
    print("  resumed run equals the uninterrupted run bit for bit: losses "
          "of steps %d-%d and all %d state leaves (step %s, loss scale "
          "%s)" % (SAVE_AFTER + 1, STEPS, len(final_a),
                   int(dict(final_b)["['step']"]),
                   float(dict(final_b)["['loss_scale'][0]"])), flush=True)
    metrics = {"recordio_step_ms": _median(step_ms[1:]),
               "iter_ms": _median(iter_ms[1:]),
               "h2d_ms": _median(h2d_ms[1:]),
               "save_ms": saved["ms"], "save_bytes": saved["bytes"],
               "restore_ms": restore_ms}
    return metrics, counts


# phase 3e: train_imagenet_torch.py's path at its defaults
IMAGENET_STEPS = 8      # from the synthetic resident batch
IMAGENET_RIO_STEPS = 4  # then fed from phase 3d's shard by ImageRecordIter
IMAGENET_PATH = {"maxpool_idx_fwd": 1}


def _imagenet_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "image_classification",
                        "train_imagenet_torch.py")
    spec = importlib.util.spec_from_file_location("train_imagenet_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive_steps(step, src, steps, per_step):
    """``steps`` steps of ``step(*next(src))``, each timed on the host
    clock around a synchronize, each launching exactly ``per_step`` of the
    port's kernels and nothing else.  Returns (losses, step_ms)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels

    losses, step_ms = [], []
    prev = _kernels.launch_counts()
    for i in range(1, steps + 1):
        t0 = time.perf_counter()
        x, y = next(src)
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        counts = _kernels.launch_counts()
        got = {k: counts[k] - prev[k] for k in counts}
        want = {k: per_step.get(k, 0) for k in counts}
        if got != want:
            raise AssertionError("step %d launched %s, want %s"
                                 % (i, got, want))
        prev = counts
    return losses, step_ms


def run_imagenet_path(dev, prefix):
    """Phase 3e: ``train_imagenet_torch.py`` at its defaults, built
    through its own functions (``parse_args``, ``build_net``,
    ``build_step``, ``batches``): stock ``resnet50_v1``, batch 128, 224
    px, bf16 compute, sgd lr 0.1.  ``IMAGENET_STEPS`` steps from the
    synthetic resident batch, then ``IMAGENET_RIO_STEPS`` from the shard
    ``prefix`` by ``ImageRecordIter``, the counters set to 0 just before;
    every step launches K3 once and nothing else.  Returns (metrics,
    counts)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels

    trainer = _imagenet_module()
    torch.backends.cudnn.benchmark = True
    args = trainer.parse_args([])
    t0 = time.perf_counter()
    net = trainer.build_net(args, dev)
    step = trainer.build_step(net, args, dev)
    build_s = time.perf_counter() - t0
    pools = sum(type(m).__name__ == "MaxPool2D" for m in net.modules())
    src = trainer.batches(args, dev)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    losses, step_ms = _drive_steps(step, src, IMAGENET_STEPS, IMAGENET_PATH)
    src.close()
    print("  %s, batch %d, %s px, %s, lr %g: %d max pool(s); built and "
          "shapes resolved in %.1f s" % (args.network, args.batch_size,
                                         args.image_shape, args.dtype,
                                         args.lr, pools, build_s),
          flush=True)
    print("  resident batch: losses %s  step_ms %s"
          % (["%.4f" % v for v in losses], ["%.1f" % t for t in step_ms]),
          flush=True)
    # lr 0.1 with momentum 0.9 from random init overshoots on a fixed
    # batch: the loss falls at once, then swings above the first by steps
    # 4-8 (7.50 -> 6.12 ... 8.44 at step 8 with cuDNN deterministic;
    # phase 3's ghost-BN step 7.66 -> 6.00 -> 6.69), so the check is that
    # it fell below the first, not that step 8 is below it
    if not _losses_ok(losses) or not min(losses[1:]) < losses[0]:
        raise AssertionError("imagenet path losses %s: not finite or "
                             "never below the first" % losses)
    rio_args = trainer.parse_args(["--data-train", prefix + ".rec",
                                   "--data-train-idx", prefix + ".idx"])
    src = trainer.batches(rio_args, dev)
    rio_losses, rio_ms = _drive_steps(step, src, IMAGENET_RIO_STEPS,
                                      IMAGENET_PATH)
    src.close()
    counts = _kernels.launch_counts()
    print("  RecordIO (ImageRecordIter, phase 3d's shard): losses %s  "
          "step_ms %s" % (["%.4f" % v for v in rio_losses],
                          ["%.1f" % t for t in rio_ms]), flush=True)
    if not _losses_ok(rio_losses):
        raise AssertionError("imagenet path losses from RecordIO %s"
                             % rio_losses)
    print("  launches a step: K3 %d, K1 %d, K2 %d (%d steps: %s)"
          % (IMAGENET_PATH["maxpool_idx_fwd"], 0, 0,
             IMAGENET_STEPS + IMAGENET_RIO_STEPS, counts), flush=True)
    steady = _median(step_ms[2:])
    metrics = {"imagenet_step_ms": steady,
               "img_s": args.batch_size / steady * 1e3,
               "imagenet_rio_step_ms": _median(rio_ms[1:])}
    del net, step
    torch.cuda.empty_cache()
    return metrics, counts


# phase 3f: one network of each other family, full width, small batch
ZOO_BATCH = 16
ZOO_STEPS = 3
ZOO_LR = 0.01
#: (label, constructor name, constructor kwargs, image px)
ZOO_NETS = [
    ("resnet50_v2", "resnet50_v2", {}, 224),
    ("resnet18_v1", "resnet18_v1", {}, 224),
    ("resnet50_v1(s2d_stem=True)", "resnet50_v1", {"s2d_stem": True}, 224),
    ("vgg16_bn", "vgg16_bn", {}, 224),
    ("alexnet", "alexnet", {}, 224),
    ("squeezenet1_1", "squeezenet1_1", {}, 224),
    ("densenet121", "densenet121", {}, 224),
    ("mobilenet1_0", "mobilenet1_0", {}, 224),
    ("mobilenet_v2_1_0", "mobilenet_v2_1_0", {}, 224),
    ("inception_v3", "inception_v3", {}, 299),
]


def run_zoo_nets(dev):
    """Phase 3f: each of ``ZOO_NETS`` at full width (1000 classes),
    batch ``ZOO_BATCH``, bf16 compute, sgd momentum 0.9 / lr ``ZOO_LR`` /
    wd 1e-4, ``ZOO_STEPS`` steps on a synthetic batch, the counters set
    to 0 just before: every step launches K3 once for each of the net's
    max pools and nothing else; losses finite.  Returns (rows,
    counts)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels, gluon, initializer
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    # a few steps of each net at its own shapes: autotuning every
    # convolution (densenet121 alone has ~100 shapes) costs more than it
    # saves
    torch.backends.cudnn.benchmark = False
    total = {name: 0 for name in _kernels.launch_counts()}
    rows = []
    for label, name, kwargs, px in ZOO_NETS:
        net = vision.get_model(name, classes=1000, device=dev, **kwargs)
        initializer.initialize(net, initializer.Xavier(),
                               torch.Generator(device=dev).manual_seed(SEED))
        gluon.shape_init(net, (1, 3, px, px))
        pools = sum(isinstance(m, gluon.nn.MaxPool2D) for m in net.modules())
        step = make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                               optimizer="sgd", learning_rate=ZOO_LR,
                               momentum=0.9, wd=1e-4,
                               compute_dtype="bfloat16", device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        x = torch.rand(ZOO_BATCH, 3, px, px, generator=g, device=dev)
        y = torch.randint(0, 1000, (ZOO_BATCH,), generator=g,
                          device=dev).float()

        def batches():
            while True:
                yield x, y

        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        losses, step_ms = _drive_steps(step, batches(), ZOO_STEPS,
                                       {"maxpool_idx_fwd": pools})
        counts = _kernels.launch_counts()
        for k in total:
            total[k] += counts[k]
        ms = _median(step_ms[1:])
        print("  %-28s %3d px  step_ms %8.2f  K3 launches %d (%d max "
              "pools x %d steps)  losses %s" % (
                  label, px, ms, counts["maxpool_idx_fwd"], pools,
                  ZOO_STEPS, ["%.4f" % v for v in losses]), flush=True)
        if not _losses_ok(losses):
            raise AssertionError("%s: non-finite loss %s" % (label, losses))
        rows.append({"net": label, "px": px, "step_ms": ms,
                     "max_pools": pools,
                     "k3_launches": counts["maxpool_idx_fwd"]})
        del net, step, x, y
        torch.cuda.empty_cache()
    return rows, total


# phase 3g: the Gluon example's loop and the fused step through Gluon
GLUON = dict(model="resnet50_v1", batch=64, image=224, classes=1000,
             steps=8, lr=0.05)
GLUON_FUSED_BATCH = 64
GLUON_FUSED_STEPS = 3


def _gluon_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "gluon", "image_classification_torch.py")
    spec = importlib.util.spec_from_file_location(
        "image_classification_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gluon_args(ex, model, batch, image, classes, lr, samples):
    return ex.parse_args(["--model", model, "--batch-size", str(batch),
                          "--image-size", str(image), "--num-classes",
                          str(classes), "--lr", str(lr), "--samples",
                          str(samples)])


def run_gluon_path(dev):
    """Phase 3g-i: ``example/gluon/image_classification_torch.py``'s loop
    built through its own functions (``build_net``, ``build_data``,
    ``build_trainer``, ``train_batch``): stock-BN ``resnet50_v1``, 224
    px, 1000 classes, batch 64, ``hybridize()``, ``Trainer("sgd", lr
    0.05, momentum 0.9, kvstore=kv.create("device"))`` and
    ``metric.Accuracy``, ``GLUON["steps"]`` steps of its synthetic data
    (numpy seed 0), the counters set to 0 just before: every loss finite
    and every step launches K3 once and nothing else.  Returns (metrics,
    counts)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels, gluon, metric

    ex = _gluon_module()
    torch.backends.cudnn.benchmark = True
    g = GLUON
    args = _gluon_args(ex, g["model"], g["batch"], g["image"], g["classes"],
                       g["lr"], g["batch"] * g["steps"])
    t0 = time.perf_counter()
    net = ex.build_net(args, dev)
    it = ex.build_data(args, dev)
    trainer = ex.build_trainer(net, args)
    build_s = time.perf_counter() - t0
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    host_ms = []
    step_once = trainer.step

    def timed_step(*a, **kw):
        t = time.perf_counter()
        step_once(*a, **kw)
        host_ms.append((time.perf_counter() - t) * 1e3)

    trainer.step = timed_step
    losses, step_ms = [], []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    prev = _kernels.launch_counts()
    for i, batch in enumerate(it, 1):
        t = time.perf_counter()
        loss = ex.train_batch(net, trainer, loss_fn, acc, batch.data[0],
                              batch.label[0], args.batch_size)
        losses.append(float(loss.asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts = _kernels.launch_counts()
        got = {k: counts[k] - prev[k] for k in counts}
        want = {k: int(k == "maxpool_idx_fwd") for k in counts}
        if got != want:
            raise AssertionError("gluon step %d launched %s, want %s"
                                 % (i, got, want))
        prev = counts
    if len(losses) != g["steps"] or not _losses_ok(losses):
        raise AssertionError("gluon path losses %s" % losses)
    trained = sum(p.grad_req != "null"
                  for p in net.collect_params().values())
    print("  %s, batch %d, %d px, %d classes, lr %g, hybridized: %d "
          "parameters (%d trained); built in %.1f s" % (
              args.model, args.batch_size, args.image_size,
              args.num_classes, args.lr, len(net.collect_params()), trained,
              build_s), flush=True)
    print("  losses %s  %s  step_ms %s  trainer.step host ms %s"
          % (["%.4f" % v for v in losses], acc.get(),
             ["%.1f" % v for v in step_ms], ["%.1f" % v for v in host_ms]),
          flush=True)
    steady = _median(step_ms[2:])
    metrics = {"gluon_step_ms": steady,
               "img_s": args.batch_size / steady * 1e3,
               "trainer_step_ms": _median(host_ms[2:]),
               "trained": trained}
    del net, it, trainer
    torch.cuda.empty_cache()
    return metrics, prev


def run_gluon_fused(dev):
    """Phase 3g-ii: ``Trainer.make_fused_step`` on ``resnet50_v1(ghost_bn=
    16)`` (sgd momentum 0.9 / lr 0.1 / wd 1e-4, ``multi_precision``, bf16,
    a dynamic loss scale) beside ``make_train_step``'s step from the same
    weights and batches (batch ``GLUON_FUSED_BATCH``), cuDNN deterministic
    as in phase 3d: ``GLUON_FUSED_STEPS`` steps each, losses equal bit for
    bit, each step of each launching K1/K2/K3 53/53/1 times and nothing
    else.  Returns (losses, counts of the fused step's launches)."""
    import copy

    import torch

    from incubator_mxnet_tpu_torch import _kernels, gluon, initializer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        net = resnet.resnet50_v1(classes=1000, ghost_bn=16, device=dev)
        initializer.initialize(net, initializer.Xavier(),
                               torch.Generator(device=dev).manual_seed(SEED))
        twin = copy.deepcopy(net)
        opt = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                   multi_precision=True)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = gluon.Trainer(net.collect_params(), "sgd", dict(opt))
        fused = trainer.make_fused_step(net, loss_fn,
                                        compute_dtype="bfloat16",
                                        loss_scale="dynamic", device=dev)
        plain = make_train_step(twin, loss_fn, optimizer="sgd",
                                compute_dtype="bfloat16",
                                loss_scale="dynamic", device=dev, **opt)
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        batches = [(torch.randn(GLUON_FUSED_BATCH, 3, IMAGE, IMAGE,
                                generator=g, device=dev),
                    torch.randint(0, 1000, (GLUON_FUSED_BATCH,), generator=g,
                                  device=dev).float())
                   for _ in range(GLUON_FUSED_STEPS)]
        losses = {"fused": [], "plain": []}
        fused_counts = {name: 0 for name in _kernels.launch_counts()}
        for x, y in batches:
            for label, step in (("fused", fused), ("plain", plain)):
                torch.cuda.synchronize()
                _kernels.reset_launch_counts()
                losses[label].append(step(x, y))
                torch.cuda.synchronize()
                counts = _kernels.launch_counts()
                want = {k: MAIN_PATH.get(k, 0) for k in counts}
                if counts != want:
                    raise AssertionError("%s step launched %s, want %s"
                                         % (label, counts, want))
                if label == "fused":
                    for k in fused_counts:
                        fused_counts[k] += counts[k]
        same = all(torch.equal(a, b) for a, b in zip(losses["fused"],
                                                      losses["plain"]))
        print("  fused through Gluon %s  make_train_step %s  bit-equal %s  "
              "launches a step 53/53/1" % (
                  ["%.6f" % float(v) for v in losses["fused"]],
                  ["%.6f" % float(v) for v in losses["plain"]], same),
              flush=True)
        if not same or not _losses_ok([float(v) for v in losses["fused"]]):
            raise AssertionError("the fused step through Gluon and "
                                 "make_train_step disagree")
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
    del net, twin, fused, plain
    torch.cuda.empty_cache()
    return [float(v) for v in losses["fused"]], fused_counts


# phase 3h: train_mnist_torch.py's Module.fit, LeNet then the MLP
MNIST = dict(batch=64, epochs=1, lr=0.1)


def _mnist_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "image_classification",
                        "train_mnist_torch.py")
    spec = importlib.util.spec_from_file_location("train_mnist_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mnist_args(ex, network, batch):
    return ex.parse_args(["--network", network, "--batch-size", str(batch),
                          "--num-epochs", str(MNIST["epochs"]), "--lr",
                          str(MNIST["lr"])])


def run_mnist_path(dev, network):
    """Phase 3h: ``example/image_classification/train_mnist_torch.py``
    through its own functions (``get_iters``, ``build_module``, ``fit``:
    ``Module.fit`` with validation, ``Speedometer``, ``kv.create("local")``,
    sgd lr 0.1 / momentum 0.9) for one epoch of its synthetic set at batch
    64, the counters set to 0 just before ``fit``: every loss finite, and
    K3 launched twice a forward for LeNet (training and validation
    batches alike), never for the MLP, and nothing else.  The step time
    is ``forward_backward`` + ``update`` + ``update_metric`` on the host
    clock, synchronized on both ends.  Returns (metrics, counts)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels

    ex = _mnist_module()
    args = _mnist_args(ex, network, MNIST["batch"])
    t0 = time.perf_counter()
    train, val = ex.get_iters(args, dev)
    mod = ex.build_module(args, dev)
    step_ms, forwards, start = [], [0], [0.0]
    fwd, fwd_bwd = mod.forward, mod.forward_backward

    def counted_forward(*a, **kw):
        forwards[0] += 1
        return fwd(*a, **kw)

    def timed_forward_backward(batch):
        torch.cuda.synchronize()
        start[0] = time.perf_counter()
        fwd_bwd(batch)

    def step_end(param):
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start[0]) * 1e3)

    mod.forward = counted_forward
    mod.forward_backward = timed_forward_backward
    losses = ex.BatchLoss()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    ex.fit(mod, train, val, args, [step_end, losses])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    want = {k: 2 * forwards[0] if k == "maxpool_idx_fwd" and
            network == "lenet" else 0 for k in counts}
    if counts != want or not losses.losses or \
            not _losses_ok(losses.losses):
        raise AssertionError("%s: launches %s (want %s), losses %s"
                             % (network, counts, want, losses.losses))
    steady = _median(step_ms[2:])
    print("  %s: %d training steps, %d forwards, K3 launches %d; losses "
          "first %.4f last %.4f; step_ms %s"
          % (network, len(step_ms), forwards[0],
             counts["maxpool_idx_fwd"], losses.losses[0], losses.losses[-1],
             ["%.2f" % v for v in step_ms]), flush=True)
    metrics = {"module_step_ms": steady,
               "img_s": MNIST["batch"] / steady * 1e3, "wall_s": wall_s,
               "steps": len(step_ms), "forwards": forwards[0]}
    return metrics, counts


# phase 3i: example/rnn/word_lm/train_torch.py at the upstream medium
# model's widths (Apache MXNet example/rnn/word_lm: embedding and hidden
# 650, 2 LSTM layers, bptt 35, batch 32, PTB's 10000 words), f32 with TF32
# off, on the example's synthetic corpus
WORDLM = dict(vocab=10000, emsize=650, nhid=650, nlayers=2, batch=32,
              bptt=35, lr=1.0, steps=10)
# phase 3i-ii: BucketingModule at example/rnn/bucketing/lstm_bucketing.py's
# widths and defaults (its cudnn_lstm_bucketing.py for the fused cell)
BUCKETING = dict(vocab=10000, num_hidden=200, num_embed=200, num_layers=2,
                 batch=32, buckets=(10, 20, 30, 40, 50, 60), per_bucket=2,
                 lr=0.01, wd=1e-5)


def _word_lm_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "rnn", "word_lm", "train_torch.py")
    spec = importlib.util.spec_from_file_location("word_lm_train_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _word_lm_args(ex, cfg):
    return ex.parse_args([
        "--vocab", str(cfg["vocab"]), "--emsize", str(cfg["emsize"]),
        "--nhid", str(cfg["nhid"]), "--nlayers", str(cfg["nlayers"]),
        "--batch-size", str(cfg["batch"]), "--bptt", str(cfg["bptt"]),
        "--lr", str(cfg.get("lr", 1.0))])


def run_word_lm_path(dev):
    """Phase 3i: ``example/rnn/word_lm/train_torch.py``'s loop through its
    own functions (``build``: Xavier after ``random.seed(0)``,
    ``shape_init``, ``Trainer("sgd", lr 1.0)``; ``batch``, ``train_step``:
    ``autograd.record()``, ``SoftmaxCrossEntropyLoss``, ``backward``,
    ``trainer.step(batch)``, the loss read back each step as the script
    does) at ``WORDLM``, f32 (TF32 off), ``WORDLM["steps"]`` steps over
    its synthetic corpus with the counters set to 0 just before: every
    loss finite, no kernel of the port launched (the path is cuDNN's RNN
    and cuBLAS), and the first window's loss, computed again after the
    steps, below the first step's.  That window and not the last step's
    loss: at the script's lr 1.0 over a mean loss and ``step(batch)``'s
    1/32 the loss moves ~3e-6 a step, under the spread between windows.
    Returns (metrics, counts)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels

    ex = _word_lm_module()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _word_lm_args(ex, WORDLM)
    data = ex.corpus_rows(args)
    net, trainer, loss_fn = ex.build(args, dev)
    x0, y0 = ex.batch(data, 0, args.bptt, dev)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for lo in ex.windows(data, args.bptt)[:WORDLM["steps"]]:
        t0 = time.perf_counter()
        x, y = ex.batch(data, lo, args.bptt, dev)
        losses.append(float(ex.train_step(net, trainer, loss_fn, x, y,
                                          args).asscalar()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = _kernels.launch_counts()
    again = float(loss_fn(net(x0).reshape((-1, args.vocab)),
                          y0.reshape((-1,))).mean().asscalar())
    torch.backends.cudnn.allow_tf32 = True
    print("  losses %s; first window again %.7f (step 1 %.7f)"
          % (["%.7f" % v for v in losses], again, losses[0]), flush=True)
    print("  step_ms %s" % ["%.2f" % v for v in step_ms], flush=True)
    if not _losses_ok(losses + [again]) or not again < losses[0] or \
            any(counts.values()):
        raise AssertionError("word LM: losses %s, first window again %r, "
                             "launches %s" % (losses, again, counts))
    steady = _median(step_ms[2:])
    tokens = args.batch_size * args.bptt
    return {"wordlm_step_ms": steady, "tokens_s": tokens / steady * 1e3,
            "first": losses[0], "again": again}, counts


def _bucket_sym_gen(mx, fused):
    """``lstm_bucketing.py``'s ``sym_gen`` (``cudnn_lstm_bucketing.py``'s
    with ``fused``): embedding, the LSTM stack unrolled to the bucket's
    length, a softmax over the vocabulary at every step."""
    cfg = BUCKETING
    if fused:
        stack = mx.rnn.FusedRNNCell(cfg["num_hidden"], cfg["num_layers"],
                                    mode="lstm", prefix="lstm_")
    else:
        stack = mx.rnn.SequentialRNNCell()
        for i in range(cfg["num_layers"]):
            stack.add(mx.rnn.LSTMCell(num_hidden=cfg["num_hidden"],
                                      prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=cfg["vocab"],
                                 output_dim=cfg["num_embed"], name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, cfg["num_hidden"]))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=cfg["vocab"],
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def bucket_sentences():
    """``per_bucket`` batches of sentences for each bucket, lengths
    uniform in (previous bucket, bucket], words uniform in [1, vocab)
    (0 is the invalid label), from numpy seed ``SEED``."""
    import numpy as np

    cfg = BUCKETING
    rng = np.random.RandomState(SEED)
    sentences, low = [], 1
    for b in cfg["buckets"]:
        for _ in range(cfg["per_bucket"] * cfg["batch"]):
            n = rng.randint(low + 1, b + 1)
            sentences.append(rng.randint(1, cfg["vocab"], n).tolist())
        low = b
    return sentences


def run_bucketing_path(dev, fused):
    """Phase 3i-ii: ``BucketingModule`` over ``BucketSentenceIter``
    (``bucket_sentences``, invalid label 0, on the card) at
    ``BUCKETING``'s widths, ``Module.fit`` as ``lstm_bucketing.py`` calls
    it (sgd lr 0.01, wd 1e-5, Xavier(in, 2.34), ``Perplexity(0)``) for two
    epochs, the unrolled ``mx.rnn.LSTMCell`` stack or the
    ``FusedRNNCell``, the counters set to 0 just before ``fit``: every
    batch's loss (cross-entropy of the softmax outputs at the valid
    labels, on the card) finite, every bucket bound, no kernel of the
    port launched.  The step time is ``forward_backward`` + ``update`` +
    ``update_metric`` on the host clock, synchronized on both ends;
    ``bucket_step_ms`` is the median of the second epoch's steps (every
    bucket bound), ``first_epoch_ms`` that of the first (a bucket's
    first batch binds its ``Module``).  Returns (metrics, counts)."""
    import random

    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels

    cfg = BUCKETING
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    random.seed(SEED)
    np.random.seed(SEED)
    t0 = time.perf_counter()
    it = mx.rnn.BucketSentenceIter(bucket_sentences(), cfg["batch"],
                                   buckets=list(cfg["buckets"]),
                                   invalid_label=0, ctx=dev)
    mx.random.seed(SEED)
    mod = mx.mod.BucketingModule(_bucket_sym_gen(mx, fused),
                                 default_bucket_key=it.default_bucket_key,
                                 context=dev)
    step_ms, losses, start = [], [], [0.0]
    fwd_bwd = mod.forward_backward

    def timed_forward_backward(batch):
        torch.cuda.synchronize()
        start[0] = time.perf_counter()
        fwd_bwd(batch)

    def step_end(param):
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start[0]) * 1e3)
        prob = mod.get_outputs()[0].astorch()
        label = param.locals["data_batch"].label[0].astorch().reshape(-1)
        valid = label != 0
        picked = prob.gather(1, label.long()[:, None])[:, 0][valid]
        losses.append(float(-torch.log(picked.clamp_min(1e-30)).mean()))

    mod.forward_backward = timed_forward_backward
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    mod.fit(it, eval_metric=mx.metric.Perplexity(0), optimizer="sgd",
            optimizer_params={"learning_rate": cfg["lr"], "momentum": 0.0,
                              "wd": cfg["wd"]},
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=2, batch_end_callback=[step_end])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    torch.backends.cudnn.allow_tf32 = True
    per_epoch = cfg["per_bucket"] * len(cfg["buckets"])
    print("  %s: %d steps, %d buckets bound; losses first %.4f last %.4f; "
          "step_ms %s" % ("FusedRNNCell" if fused else "LSTMCell stack",
                          len(step_ms), len(mod._buckets), losses[0],
                          losses[-1], ["%.2f" % v for v in step_ms]),
          flush=True)
    if len(step_ms) != 2 * per_epoch or not _losses_ok(losses) or \
            len(mod._buckets) != len(cfg["buckets"]) or any(counts.values()):
        raise AssertionError("bucketing (fused=%s): %d steps, losses %s, "
                             "buckets %s, launches %s"
                             % (fused, len(step_ms), losses,
                                sorted(mod._buckets), counts))
    return {"bucket_step_ms": _median(step_ms[per_epoch:]),
            "first_epoch_ms": _median(step_ms[:per_epoch]),
            "steps": per_epoch, "buckets": len(mod._buckets),
            "wall_s": wall_s}, counts


# phase 3j: example/ssd/train_torch.py at the JAX example's defaults
SSD = dict(batch=16, batches=60, lr=0.05, anchors=192)
# phase 3j-ii: the multibox head at the graded config's scale: Apache
# MXNet example/ssd, SSD300 over vgg16_reduced (symbol/symbol_factory.py:
# six feature maps, their sizes, ratios and steps; train.py's --nms 0.45
# and --nms_topk 400; MultiBoxTarget's settings of symbol_builder.py),
# batch 32, 20 classes plus background, synthetic boxes
_R3, _R5 = (1.0, 2.0, 0.5), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)
SSD300 = dict(maps=(38, 19, 10, 5, 3, 1),
              sizes=((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                     (.71, .79), (.88, .961)),
              ratios=(_R3, _R5, _R5, _R5, _R3, _R3),
              steps=(8, 16, 32, 64, 100, 300), image=300, anchors=8732,
              batch=32, classes=20, max_boxes=40,
              target=dict(overlap_threshold=0.5, negative_mining_ratio=3,
                          negative_mining_thresh=0.5,
                          minimum_negative_samples=0),
              detection=dict(nms_threshold=0.45, nms_topk=400,
                             threshold=0.01),
              reps=5)
#: phase 3j-ii's limits: loc targets within 1e-5 of their largest
#: magnitude (at least 1); a kept row matches within 1e-5; a row differs
#: between card and CPU only if its score or an IoU lies within 1e-6 of a
#: threshold
SSD300_LOC_LIMIT, SSD300_ROW_TOL, SSD300_NEAR = 1e-5, 1e-5, 1e-6


def _ssd_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "ssd", "train_torch.py")
    spec = importlib.util.spec_from_file_location("ssd_train_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ssd_args(ex, batch, batches):
    return ex.parse_args(["--batch-size", str(batch), "--batches",
                          str(batches), "--lr", str(SSD["lr"])])


def run_ssd_path(dev, rtc_kernels):
    """Phase 3j: ``example/ssd/train_torch.py``'s loop through its own
    functions (``build_net``: Xavier after ``random.seed(0)``,
    ``shape_init``, ``Trainer("sgd", lr 0.05)``; ``train_step``:
    ``MultiBoxPrior``, ``MultiBoxTarget`` under ``autograd.pause()``, the
    softmax cross-entropy plus the masked L1 location loss, ``backward``,
    ``trainer.step``) at the JAX example's defaults (``SSD``: batch 16,
    60 batches of its synthetic data from numpy seed 0, 32 px), f32 with
    TF32 off, each step synchronized; then ``decode`` of one more batch.
    The counters of K1-K7, R1 and R2 are set to 0 just before and must
    stay 0; every loss finite, the mean of the last 20 below the first
    20's; the decode (16, 192, 6), finite, some rows kept.  Returns
    metrics."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import _kernels, nd

    ex = _ssd_module()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _ssd_args(ex, SSD["batch"], SSD["batches"])
    net, trainer, cls_loss = ex.build_net(args, dev)
    rng = np.random.RandomState(0)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for k in rtc_kernels.values():
        k.launches = 0
    for _ in range(args.batches):
        t0 = time.perf_counter()
        imgs, labels = ex.synthetic_batch(rng, args.batch_size)
        losses.append(ex.train_step(net, trainer, cls_loss,
                                    nd.array(imgs, ctx=dev),
                                    nd.array(labels, ctx=dev)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    imgs, _ = ex.synthetic_batch(rng, args.batch_size)
    t0 = time.perf_counter()
    dets = ex.decode(net, imgs, dev)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    counts = _kernels.launch_counts()
    counts.update({n: k.launches for n, k in rtc_kernels.items()})
    torch.backends.cudnn.allow_tf32 = True
    losses = [float(v.asscalar()) for v in losses]
    dets = dets.asnumpy()
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    kept = int((dets[..., 0] >= 0).sum())
    print("  losses every 10th %s; mean of the first 20 %.6f, of the last "
          "20 %.6f" % (["%.6f" % v for v in losses[::10]], first, last),
          flush=True)
    print("  step_ms %s" % ["%.2f" % v for v in step_ms[:8]], flush=True)
    print("  decode %s in %.2f ms (the first call of MultiBoxDetection "
          "here): %d rows kept of %d; launches %s" % (
              dets.shape, decode_ms, kept, dets.shape[0] * dets.shape[1],
              counts), flush=True)
    if not (_losses_ok(losses) and last < first
            and dets.shape == (args.batch_size, SSD["anchors"], 6)
            and np.isfinite(dets).all() and kept > 0
            and not any(counts.values())):
        raise AssertionError("SSD path: losses %s, decode %s kept %d, "
                             "launches %s" % (losses, dets.shape, kept,
                                              counts))
    steady = _median(step_ms[2:])
    return {"ssd_step_ms": steady, "img_s": args.batch_size / steady * 1e3,
            "first": first, "last": last, "decode_ms": decode_ms}


def ssd300_anchors(mx, ctx):
    """The anchors of SSD300's six feature maps: one ``MultiBoxPrior`` a
    map on zeros of its size, concatenated: (1, 8732, 4)."""
    parts = []
    for s, sizes, ratios, step in zip(SSD300["maps"], SSD300["sizes"],
                                      SSD300["ratios"], SSD300["steps"]):
        st = step / SSD300["image"]
        parts.append(mx.nd.contrib.MultiBoxPrior(
            mx.nd.zeros((1, 1, s, s), ctx=ctx), sizes=sizes, ratios=ratios,
            steps=(st, st)))
    return mx.nd.concat(*parts, dim=1)


def ssd300_inputs():
    """32 images' labels (1-40 synthetic boxes each of 20 classes, padded
    with -1), class logits (32, 21, 8732) and location predictions (32,
    8732 * 4), from numpy seed ``SEED + 5``."""
    import numpy as np

    rng = np.random.RandomState(SEED + 5)
    n, m, a = SSD300["batch"], SSD300["max_boxes"], SSD300["anchors"]
    labels = np.full((n, m, 5), -1.0, np.float32)
    for i in range(n):
        k = rng.randint(1, m + 1)
        xy = rng.rand(k, 2) * 0.8
        wh = rng.rand(k, 2) * 0.35 + 0.03
        labels[i, :k, 0] = rng.randint(0, SSD300["classes"], k)
        labels[i, :k, 1:3] = xy
        labels[i, :k, 3:5] = np.minimum(xy + wh, 1.0)
    cls_pred = rng.standard_normal(
        (n, SSD300["classes"] + 1, a)).astype(np.float32)
    loc_pred = (rng.standard_normal((n, a * 4)) * 0.5).astype(np.float32)
    return labels, cls_pred, loc_pred


def _multibox_head(mx, ctx, labels, cls_pred, loc_pred, nms=True):
    """Phase 3j-ii's pipeline on ``ctx``: anchors, ``MultiBoxTarget``,
    softmax, ``MultiBoxDetection`` (NMS off when ``nms`` is false)."""
    anchors = ssd300_anchors(mx, ctx)
    lab = mx.nd.array(labels, ctx=ctx)
    cp = mx.nd.array(cls_pred, ctx=ctx)
    lp = mx.nd.array(loc_pred, ctx=ctx)
    target = mx.nd.contrib.MultiBoxTarget(anchors, lab, cp,
                                          **SSD300["target"])
    prob = mx.nd.softmax(cp, axis=1)
    det = dict(SSD300["detection"])
    if not nms:
        det["nms_threshold"] = 0.0
    dets = mx.nd.contrib.MultiBoxDetection(prob, lp, anchors, **det)
    return anchors, target, dets


def _np_iou(box, boxes):
    import numpy as np

    il = np.maximum(box[0], boxes[:, 0])
    it = np.maximum(box[1], boxes[:, 1])
    ir = np.minimum(box[2], boxes[:, 2])
    ib = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(ir - il, 0) * np.maximum(ib - it, 0)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = (box[2] - box[0]) * (box[3] - box[1]) + area - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0)


def detections_agree(card, cpu, cand):
    """Hold the card's detections (N, A, 6) to the CPU's: each image's
    kept rows must match one for one (the same class id, score and box
    within ``SSD300_ROW_TOL``), except rows whose score lies within
    ``SSD300_NEAR`` of the score threshold or of the top-k boundary (the
    last candidate's score in ``cand``, the CPU's rows with NMS off), or
    whose IoU with a candidate box of its class lies within
    ``SSD300_NEAR`` of the NMS threshold.  Returns the count of those
    rows; raises on any other difference."""
    import numpy as np

    thr = SSD300["detection"]["threshold"]
    nms = SSD300["detection"]["nms_threshold"]
    excused = 0
    for i in range(card.shape[0]):
        a = card[i][card[i, :, 0] >= 0]
        b = list(cpu[i][cpu[i, :, 0] >= 0])
        left = []
        for row in a:
            hit = next((j for j, r in enumerate(b) if r[0] == row[0] and
                        np.abs(r - row).max() <= SSD300_ROW_TOL), None)
            if hit is None:
                left.append(row)
            else:
                b.pop(hit)
        c = cand[i][cand[i, :, 0] >= 0]
        for row in left + b:
            same = c[c[:, 0] == row[0]]
            near_iou = np.abs(_np_iou(row[2:], same[:, 2:]) - nms) \
                <= SSD300_NEAR
            if not (abs(row[1] - thr) <= SSD300_NEAR
                    or abs(row[1] - c[-1, 1]) <= SSD300_NEAR
                    or near_iou.any()):
                raise AssertionError(
                    "image %d: detection row %s differs between card and "
                    "CPU away from every threshold" % (i, row.tolist()))
            excused += 1
    return excused


def _launches(fn):
    """CUDA activities (kernels, copies, fills) of one call of ``fn`` and
    their summed device time in ms, from torch.profiler's CUDA trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    return len(evs), sum(ev.time_range.elapsed_us() for ev in evs) / 1e3


def _event_ms(fn, reps):
    """The median over ``reps`` calls of ``fn`` (after one more) of CUDA
    event time: one call's time, host syncs inside it included."""
    import torch

    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return _median(out)


def run_multibox_ssd300(dev):
    """Phase 3j-ii: the multibox head at SSD300's scale (``SSD300``),
    forward only, through ``mx.nd.contrib``: 8732 anchors from six
    ``MultiBoxPrior`` calls; ``MultiBoxTarget`` (overlap 0.5, hard
    negatives 3:1 below 0.5) of 32 images' synthetic boxes against
    seeded logits; softmax; ``MultiBoxDetection`` (NMS 0.45, top 400).
    Times each op by CUDA events (median of ``reps``) and counts its
    launches in one call (the profiler's CUDA activities), then holds the
    card to the port's CPU run of the same inputs: positive masks and
    class targets equal, loc targets within ``SSD300_LOC_LIMIT``, kept
    detections as :func:`detections_agree` says.  Returns metrics."""
    import math

    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx

    labels, cls_pred, loc_pred = ssd300_inputs()
    anchors = ssd300_anchors(mx, dev)
    if anchors.shape != (1, SSD300["anchors"], 4):
        raise AssertionError("SSD300 anchors %s" % (anchors.shape,))
    lab = mx.nd.array(labels, ctx=dev)
    cp = mx.nd.array(cls_pred, ctx=dev)
    lp = mx.nd.array(loc_pred, ctx=dev)
    prob = mx.nd.softmax(cp, axis=1)
    det_kw = dict(SSD300["detection"])
    off_kw = dict(det_kw, nms_threshold=0.0)

    def target():
        return mx.nd.contrib.MultiBoxTarget(anchors, lab, cp,
                                            **SSD300["target"])

    def detection():
        return mx.nd.contrib.MultiBoxDetection(prob, lp, anchors, **det_kw)

    def detection_no_nms():
        return mx.nd.contrib.MultiBoxDetection(prob, lp, anchors, **off_kw)

    reps = SSD300["reps"]
    m = {"multibox_target_ms": _event_ms(target, reps),
         "multibox_detection_ms": _event_ms(detection, reps),
         "multibox_detection_no_nms_ms": _event_ms(detection_no_nms, reps)}
    for name, fn in (("target", target), ("detection", detection),
                     ("detection_no_nms", detection_no_nms)):
        m[name + "_launches"], m[name + "_busy_ms"] = _launches(fn)
    scores = prob.asnumpy()[:, 1:].max(1)
    valid = (scores >= det_kw["threshold"]).sum(1)
    m["nms_rows"] = int(min(det_kw["nms_topk"], valid.max()))

    _, (loc_t, loc_mask, cls_t), dets = _multibox_head(
        mx, dev, labels, cls_pred, loc_pred)
    _, (cloc_t, cloc_mask, ccls_t), cdets = _multibox_head(
        mx, mx.cpu(), labels, cls_pred, loc_pred)
    _, _, cand = _multibox_head(mx, mx.cpu(), labels, cls_pred, loc_pred,
                                nms=False)
    cls_t, ccls_t = cls_t.asnumpy(), ccls_t.asnumpy()
    m.update(positives=int(loc_mask.asnumpy().sum()) // 4,
             negatives=int((cls_t == 0).sum()),
             ignored=int((cls_t == -1).sum()),
             kept=int((dets.asnumpy()[..., 0] >= 0).sum()))
    print("  anchors %d; per image: positives %.1f, mined negatives %.1f, "
          "ignored %.1f; kept detections %d of %d rows "
          "(NMS over the top %d rows)" % (
              anchors.shape[1], m["positives"] / SSD300["batch"],
              m["negatives"] / SSD300["batch"],
              m["ignored"] / SSD300["batch"], m["kept"], dets.size // 6,
              m["nms_rows"]), flush=True)
    if not (np.array_equal(loc_mask.asnumpy(), cloc_mask.asnumpy())
            and np.array_equal(cls_t, ccls_t)):
        raise AssertionError("MultiBoxTarget: positive masks or class "
                             "targets differ between card and CPU")
    _check("MultiBoxTarget loc_target card vs CPU", loc_t._data.cpu(),
           cloc_t._data, SSD300_LOC_LIMIT)
    m["excused"] = detections_agree(dets.asnumpy(), cdets.asnumpy(),
                                    cand.asnumpy())
    # the hard negatives are ranked in f64: how far an f32 ranking (the
    # reference's) would have agreed between card and CPU here
    positive = torch.from_numpy(cloc_mask.asnumpy()[:, ::4] > 0)
    num_neg = torch.from_numpy((ccls_t == 0).sum(1))
    mined, bits = {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        for dt in (torch.float32, torch.float64):
            p = torch.softmax(cp._data.to(d, dt), dim=1)[:, 0].cpu()
            bits[name, dt] = p
            order = torch.sort(torch.where(positive, math.inf, p), dim=1,
                               stable=True).indices
            mined[name, dt] = [set(order[i, :int(num_neg[i])].tolist())
                                 for i in range(order.shape[0])]
    for dt in (torch.float32, torch.float64):
        print("  background probabilities in %s: %d of %d differ card vs "
              "CPU; ranked in %s, the mined sets of %d of %d images differ"
              % (str(dt)[6:], int((bits["card", dt] != bits["cpu", dt])
                                  .sum()), bits["cpu", dt].numel(),
                 str(dt)[6:], sum(a != b for a, b in zip(
                     mined["card", dt], mined["cpu", dt])),
                 SSD300["batch"]), flush=True)
    print("  positive masks and class targets equal; detections equal "
          "but %d rows within %.0e of a threshold" % (m["excused"],
                                                       SSD300_NEAR),
          flush=True)
    del anchors, lab, cp, lp, prob, loc_t, loc_mask, dets
    torch.cuda.empty_cache()
    return m


# phase 3k: the exported ghost-BN ResNet-50 through the symbolic path
SYMBOLIC = dict(batch=64, image=224, classes=1000, steps=5, finetune_steps=8,
                finetune_lr=0.01)
#: phase 3k's control flow on the card: an LSTM-like foreach
SYMBOLIC_LSTM = dict(seq=8, batch=32, input=64, hidden=128)
#: phase 3k's limits, card against CPU in f32 with TF32 off: the foreach
#: outputs within 1e-5 of their largest magnitude (at least 1; sums of 192
#: products a gate), its gradients within 1e-4 (eight steps back), the
#: while loop and cond within 1e-6 (a few adds and multiplies); the la_op
#: results within 1e-4 (cuSOLVER against LAPACK, other orders of the same
#: sums; eigenvectors compared as ``U^T diag(lam) U``)
CF_OUT_TOL, CF_GRAD_TOL, CF_EXACT_TOL, LINALG_TOL = 1e-5, 1e-4, 1e-6, 1e-4


def _counted(fn):
    """``fn()`` with the launch counters set to 0 just before; returns
    (its result, the counts just after)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _kernels.launch_counts()


def _gate_step(label, counts, want):
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError("%s launched %s, want %s" % (label, counts,
                                                          full))


def _timed_steps(label, fn, steps, want):
    """``steps`` calls of ``fn``, each counted and gated against ``want``
    and timed on the host clock between synchronizations; returns (ms of
    each, summed counts)."""
    import time as _time

    import torch

    ms, total = [], {}
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        _, counts = _counted(fn)
        ms.append((_time.perf_counter() - t0) * 1e3)
        _gate_step(label, counts, want)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return ms, total


def run_symbolic_path(dev, directory):
    """Phase 3k: ``resnet50_v1(ghost_bn=16)`` built on the card (Xavier
    from the seeded generator), ``export``ed into ``directory`` (ms and
    bytes of both files); ``SymbolBlock.imports`` of the files on the
    card in inference equal to the Gluon net's eval output; the files
    through ``model.load_checkpoint`` (onto the card) and
    ``simple_bind(data=(B, 3, 224, 224))``, whose shape inference runs the
    ghost-BN ops and the stem pool on ``meta`` tensors (K1/K2/K3's
    wrappers answer them; no launch); one ``forward(is_train=True)`` +
    ``backward(head)`` of the Executor held bit for bit to the Gluon
    net's step under ``record()`` on the same batch, weights and head
    gradient (the output, every argument gradient, the running stats
    after the step), each launching K1/K2/K3 53/53/1 times; ``steps``
    more of each timed (``symbol_step_ms``, ``gluon_step_ms``: medians,
    host clock between synchronizations); then the exported symbol under
    a ``SoftmaxOutput`` head fine-tuned by ``mx.mod.Module``
    (``forward_backward`` + ``update``, sgd momentum 0.9, on one fixed
    batch): every step 53/53/1, the last loss below the first.  cuDNN
    deterministic in this phase.  Returns (metrics, the counts of every
    counted step)."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import initializer, nd
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    cfg = SYMBOLIC
    b, side, classes = cfg["batch"], cfg["image"], cfg["classes"]
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        net = resnet.resnet50_v1(classes=classes, ghost_bn=16, device=dev)
        initializer.initialize(net, initializer.Xavier(),
                               torch.Generator(device=dev).manual_seed(SEED))
        prefix = os.path.join(directory, "resnet50_v1_ghost16")
        t0 = time.perf_counter()
        sym_file, params_file = net.export(prefix)
        export_ms = (time.perf_counter() - t0) * 1e3
        nbytes = (os.path.getsize(sym_file), os.path.getsize(params_file))
        g = torch.Generator(device=dev).manual_seed(SEED + 5)
        x = nd.NDArray(torch.randn(b, 3, side, side, generator=g,
                                   device=dev))
        head = nd.NDArray(torch.randn(b, classes, generator=g, device=dev))
        labels = torch.randint(0, classes, (b,), generator=g,
                               device=dev).float()

        block = mx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                             ctx=dev)
        block_eval = block(x)._data
        gluon_eval = net(x)._data
        eval_same = torch.equal(block_eval, gluon_eval)
        print("  SymbolBlock.imports on the card, inference: equal to the "
              "Gluon net's eval output %s (max abs diff %.3e)"
              % (eval_same, _max_err(block_eval, gluon_eval)), flush=True)
        if not eval_same:
            raise AssertionError("SymbolBlock's inference differs from the "
                                 "Gluon net's")
        del block, block_eval, gluon_eval

        t0 = time.perf_counter()
        sym, args, aux = mx.model.load_checkpoint(prefix, 0, ctx=dev)
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        exe, bind_counts = _counted(
            lambda: sym.simple_bind(dev, data=(b, 3, side, side)))
        bind_ms = (time.perf_counter() - t0) * 1e3
        if any(bind_counts.values()):
            raise AssertionError("simple_bind launched %s" % bind_counts)
        exe.copy_params_from(args, aux)

        def exe_step():
            exe.forward(is_train=True, data=x)
            exe.backward(head)

        def gluon_step():
            with mx.autograd.record():
                y = net(x)
            y.backward(head)
            return y

        _, c = _counted(exe_step)
        _gate_step("the Executor's step", c, MAIN_PATH)
        add(c)
        y, c = _counted(gluon_step)
        _gate_step("the Gluon step", c, MAIN_PATH)
        add(c)
        params = net.collect_params()
        pairs = [("output", exe.outputs[0]._data, y._data)]
        pairs += [(n, exe.grad_dict[n]._data, params[n].grad()._data)
                  for n in exe.grad_dict if n != "data"]
        pairs += [(n, exe.aux_dict[n]._data, params[n].data()._data)
                  for n in exe.aux_dict]
        worst = max(pairs, key=lambda p: _max_err(p[1], p[2]))
        same = all(torch.equal(a, w) for _, a, w in pairs)
        print("  Executor step against the Gluon step: output, %d argument "
              "gradients, %d running stats bit-equal %s (largest "
              "difference %.3e at %s); 53/53/1 launches each"
              % (len(exe.grad_dict) - 1, len(exe.aux_dict), same,
                 _max_err(worst[1], worst[2]), worst[0]), flush=True)
        if not same:
            raise AssertionError("the Executor's step differs from the "
                                 "Gluon step")
        del y, pairs, worst

        exe_ms, c = _timed_steps("the Executor's step", exe_step,
                                 cfg["steps"], MAIN_PATH)
        add(c)
        gl_ms, c = _timed_steps("the Gluon step", gluon_step, cfg["steps"],
                                MAIN_PATH)
        add(c)
        # where the two steps differ: device activities and busy time
        exe_acts, exe_busy = _launches(exe_step)
        gl_acts, gl_busy = _launches(gluon_step)
        print("  under the profiler: the Executor's step %d CUDA activities, "
              "%.2f ms busy; the Gluon step %d, %.2f ms busy"
              % (exe_acts, exe_busy, gl_acts, gl_busy), flush=True)
        del exe
        torch.cuda.empty_cache()

        mod = mx.mod.Module(mx.sym.SoftmaxOutput(sym, name="softmax"),
                            context=dev)
        mod.bind(data_shapes=[("data", (b, 3, side, side))],
                 label_shapes=[("softmax_label", (b,))])
        mod.init_params(arg_params=args, aux_params=aux)
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
            learning_rate=cfg["finetune_lr"], momentum=0.9))
        batch = mx.io.DataBatch([x], [nd.NDArray(labels)])
        rows = torch.arange(b, device=dev)
        losses = []

        def finetune_step():
            mod.forward_backward(batch)
            mod.update()
            p = mod.get_outputs()[0]._data
            losses.append(float(-p[rows, labels.long()].clamp_min(1e-30)
                                .log().mean()))

        ft_ms, c = _timed_steps("a Module step", finetune_step,
                                cfg["finetune_steps"], MAIN_PATH)
        add(c)
        print("  Module fine-tune under SoftmaxOutput: losses %s  "
              "(forward_backward + update, median %.2f ms)"
              % (["%.6f" % v for v in losses], _median(ft_ms)), flush=True)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError("the fine-tune's loss did not fall: %s"
                                 % losses)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
    del net, mod
    torch.cuda.empty_cache()
    return dict(export_ms=export_ms, symbol_bytes=nbytes[0],
                params_bytes=nbytes[1], load_ms=load_ms, bind_ms=bind_ms,
                symbol_step_ms=_median(exe_ms[1:]),
                gluon_step_ms=_median(gl_ms[1:]), symbol_busy_ms=exe_busy,
                gluon_busy_ms=gl_busy, symbol_activities=exe_acts,
                gluon_activities=gl_acts,
                finetune_step_ms=_median(ft_ms[1:]),
                losses=losses), counts


def _lstm_like(S, hidden):
    """A ``foreach`` over an LSTM-like cell (states h and c; input and
    recurrent products, four gates), the reference's
    ``test_control_flow.py`` scan at an LSTM's shape."""
    data, h0, c0 = S.var("data"), S.var("h0"), S.var("c0")
    wx, bx = S.var("i2h_weight"), S.var("i2h_bias")
    wh, bh = S.var("h2h_weight"), S.var("h2h_bias")

    def body(x, states):
        h, c = states
        gates = S.FullyConnected(x, wx, bx, num_hidden=4 * hidden) \
            + S.FullyConnected(h, wh, bh, num_hidden=4 * hidden)
        i, f, g, o = list(S.SliceChannel(gates, num_outputs=4, axis=1))
        c2 = S.Activation(f, act_type="sigmoid") * c \
            + S.Activation(i, act_type="sigmoid") \
            * S.Activation(g, act_type="tanh")
        h2 = S.Activation(o, act_type="sigmoid") \
            * S.Activation(c2, act_type="tanh")
        return h2, [h2, c2]

    outs, (h, c) = S.contrib.foreach(body, data, [h0, c0])
    return S.Group([outs, h, c])


def _doubling_loop(S):
    x = S.var("x")
    _, final = S.contrib.while_loop(lambda v: S.sum(v) < 100,
                                    lambda v: (v * 2, [v * 2]), [x],
                                    max_iterations=3)
    return S.Group([final[0], S.contrib.cond(
        lambda: S.sum(x) > 1, lambda: x * 10, lambda: x - 1)])


def control_flow_linalg_card_vs_cpu(dev):
    """Phase 3k, last: the LSTM-like ``foreach`` (``SYMBOLIC_LSTM``,
    forward and backward), a ``while_loop`` and a ``cond`` (forward and
    backward) through the Executor, and ``potrf``, ``trsm``, ``syevd``,
    ``gelqf`` and ``slogdet`` (f32, batch 4 of 64 x 64) through
    ``mx.nd.linalg``, on the card against the CPU within the limits above,
    TF32 off; none launches a kernel of the port."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = torch.device("cpu")
    rng = np.random.RandomState(SEED + 7)

    def run(sym, inputs, head_grads):
        out = {}
        for key, d in (("card", dev), ("cpu", cpu)):
            exe = sym.bind(d, {k: nd.array(v, ctx=d)
                               for k, v in inputs.items()},
                           args_grad={k: nd.zeros(v.shape, ctx=d)
                                      for k, v in inputs.items()})
            outs = exe.forward(is_train=True)
            exe.backward([nd.array(h, ctx=d) for h in head_grads])
            out[key] = ([o._data.cpu() for o in outs],
                           {k: g._data.cpu() for k, g in
                            exe.grad_dict.items()})
        return out

    def compare(label, out, out_tol, grad_tol):
        for i, (a, w) in enumerate(zip(out["card"][0], out["cpu"][0])):
            _check("%s output %d" % (label, i), a, w, out_tol)
        for k, a in out["card"][1].items():
            _check("%s d%s" % (label, k), a, out["cpu"][1][k], grad_tol)

    def cf():
        cfg = SYMBOLIC_LSTM
        t, n, m, hid = cfg["seq"], cfg["batch"], cfg["input"], cfg["hidden"]
        inputs = {"data": rng.normal(size=(t, n, m)),
                  "h0": rng.normal(0, 0.5, (n, hid)),
                  "c0": rng.normal(0, 0.5, (n, hid)),
                  "i2h_weight": rng.normal(0, 0.1, (4 * hid, m)),
                  "i2h_bias": rng.normal(0, 0.1, 4 * hid),
                  "h2h_weight": rng.normal(0, 0.1, (4 * hid, hid)),
                  "h2h_bias": rng.normal(0, 0.1, 4 * hid)}
        inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
        heads = [rng.normal(size=s).astype(np.float32)
                 for s in ((t, n, hid), (n, hid), (n, hid))]
        compare("foreach LSTM-like", run(_lstm_like(mx.sym, hid), inputs,
                                         heads), CF_OUT_TOL, CF_GRAD_TOL)
        for x0 in (1.0, 30.0, 0.5):
            compare("while_loop + cond at x=%g" % x0,
                    run(_doubling_loop(mx.sym),
                        {"x": np.array([x0], np.float32)},
                        [np.ones(1, np.float32)] * 2),
                    CF_EXACT_TOL, CF_EXACT_TOL)
        a = rng.normal(size=(4, 64, 64))
        spd = (a @ a.transpose(0, 2, 1) + 64 * np.eye(64)).astype(np.float32)
        bmat = rng.normal(size=(4, 64, 16)).astype(np.float32)
        wide = rng.normal(size=(4, 32, 64)).astype(np.float32)
        res = {}
        for key, d in (("card", dev), ("cpu", cpu)):
            L = nd.linalg.potrf(nd.array(spd, ctx=d))
            u, lam = nd.linalg.syevd(nd.array(spd, ctx=d))
            recon = torch.matmul(u._data.transpose(-1, -2) * lam._data[
                ..., None, :], u._data)
            lq = nd.linalg.gelqf(nd.array(wide, ctx=d))
            sign, logabs = nd.linalg.slogdet(nd.array(spd, ctx=d))
            res[key] = [t.cpu() for t in (
                L._data, nd.linalg.trsm(L, nd.array(bmat, ctx=d))._data,
                lam._data, recon, lq[0]._data, lq[1]._data, sign._data,
                logabs._data)]
        for name, a_, w in zip(("potrf", "trsm", "syevd lam",
                                "syevd U^T diag(lam) U", "gelqf L",
                                "gelqf Q", "slogdet sign",
                                "slogdet logabs"),
                               res["card"], res["cpu"]):
            _check("linalg %s" % name, a_, w, LINALG_TOL)

    _, counts = _counted(cf)
    torch.backends.cudnn.allow_tf32 = True  # the defaults again
    if any(counts.values()):
        raise AssertionError("control flow or linalg launched %s" % counts)


# phase 3l: data parallelism, two ranks sharing the card over gloo
DP_RANKS = 2
#: route (ii): the main path at the global batch, dp=2, zero=1, at the
#: small lr that keeps two steps comparable (ROADMAP "Comparing steps")
DP = dict(batch=BATCH, steps=4, lr=1e-3)
#: seconds the launched two-rank job may take
DP_TIMEOUT = 400
#: route (ii)'s loss gate: each step's loss within 4x the one-process
#: noise floor plus this, relative.  The loss is a bf16 mean: each rank's
#: half rounds within 2^-8 of its f32 value and so does the whole batch's,
#: so two agreeing steps may report losses 2^-7 apart
DP_FLOOR_ADD = 2.0 ** -7
#: route (ii) again in f32 (TF32 off), the steps whose updates are held
#: against one process.  This net at random init amplifies a relative
#: perturbation of its weights ~4e4-fold into its first update, and more
#: with each step: in bf16 two orders of one batch move 4 steps' updates
#: by as much as the updates themselves; in f32 the floor after one step
#: is ~4e-2 and after two ~0.5, against ~1 for the faults (PERF.md)
DP_F32_STEPS = 1
#: route (ii) in f32: the loss and running-stat gates' additive term
DP_F32_ADD = 1e-6
#: route (iii): its first steps held against one process on the global
#: batch (at the trainer's lr 0.1 two orders of the batch drift apart by
#: a few bf16 ulps of the loss a step)
DP_IMAGENET_STEPS = 3

def _cifar_dist_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "distributed_training",
                        "cifar10_dist_torch.py")
    spec = importlib.util.spec_from_file_location("cifar10_dist_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launch_ranks(args, timeout=DP_TIMEOUT):
    """``tools/launch_torch.py -n DP_RANKS`` over ``args`` from the repository
    root, in a session of its own that is killed past ``timeout``;
    returns the job's output (raises where a rank failed)."""
    rc, out = _run_ranks(args, timeout)
    if rc != 0:
        raise AssertionError("%s failed (rc %d):\n%s"
                             % (" ".join(args), rc, out[-4000:]))
    return out


def _run_ranks(args, timeout):
    """:func:`_launch_ranks` that returns ``(exit code, output)`` whatever
    the code (a job that must fail)."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.join(here, "tools", "launch_torch.py"),
           "-n", str(DP_RANKS)] + list(args)
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError("%s passed its %d s limit:\n%s"
                             % (" ".join(args), timeout, out[-4000:]))
    try:  # a rank the launcher left behind must not hold the card
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    return proc.returncode, out


def _dp_main_net(dev):
    import torch

    from incubator_mxnet_tpu_torch import initializer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    net = resnet.resnet50_v1(classes=1000, ghost_bn=16, device=dev)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(SEED))
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(DP["batch"], 3, IMAGE, IMAGE, generator=g, device=dev)
    y = torch.randint(0, 1000, (DP["batch"],), generator=g,
                      device=dev).float()
    return net, x, y


def _dp_main_step(net, dev, mesh=None, rescale_grad=1.0,
                  dtype="bfloat16"):
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    return make_train_step(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                           learning_rate=DP["lr"], momentum=0.9, wd=1e-4,
                           multi_precision=True, loss_scale="dynamic",
                           compute_dtype=dtype, device=dev, mesh=mesh,
                           zero=1 if mesh is not None else 0,
                           rescale_grad=rescale_grad)


@contextlib.contextmanager
def _tf32_off():
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _dp_rank_cifar(logs):
    """Route (i) in this rank: ``cifar10_dist_torch.py`` at its defaults
    through its ``main``."""
    import re

    ex = _cifar_dist_module()
    t0 = time.perf_counter()
    losses, net = ex.main([])
    wall = time.perf_counter() - t0
    epochs = [re.search(r"mean loss (\S+)  (\S+) ms a step", m).groups()
              for m in logs if "ms a step" in m]
    return {"losses": losses, "sha1": ex.params_sha1(net), "wall_s": wall,
            "epoch_means": [float(a) for a, _ in epochs],
            "epoch_ms": [float(b) for _, b in epochs]}


def _dp_rank_main_path(dev, outdir):
    """Route (ii) in this rank: the main path's step over a dp mesh of
    the launched processes with ``zero=1``, on this rank's slice of the
    global batch; the launch and collective counters set to 0 just
    before the steps and read just after; rank 0 writes its state."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import _kernels, convert
    from incubator_mxnet_tpu_torch.parallel import collectives, make_mesh

    mesh = make_mesh({"dp": -1})
    net, x, y = _dp_main_net(dev)
    step = _dp_main_step(net, dev, mesh)
    x, y = mesh.local_slice(x), mesh.local_slice(y)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    collectives.reset_call_counts()
    for _ in range(DP["steps"]):
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = _kernels.launch_counts()
    calls = collectives.call_counts()
    if mesh.axis_index("dp") == 0:
        np.savez(os.path.join(outdir, "state.npz"),
                 *convert.params_to_numpy(net))
    grads = sum(p.numel() for p in net.parameters() if p.requires_grad)
    return {"losses": losses, "step_ms": step_ms,
            "skipped": step.skipped_steps, "loss_scale": step.loss_scale,
            "launches": launches, "collectives": calls,
            "local_batch": int(x.shape[0]),
            "sha1": _imagenet_module().state_sha1(net),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "grad_floats": grads,
            "allreduce_ms": [_allreduce_ms(n, dev, mesh) for n in (grads, 4)]}


def _dp_rank_main_f32(dev, outdir):
    """Route (ii)'s step in f32 with TF32 off, ``DP_F32_STEPS`` steps
    over the same mesh, weights and slices; rank 0 writes its state."""
    import numpy as np

    from incubator_mxnet_tpu_torch import convert
    from incubator_mxnet_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"dp": -1})
    net, x, y = _dp_main_net(dev)
    step = _dp_main_step(net, dev, mesh, dtype=None)
    x, y = mesh.local_slice(x), mesh.local_slice(y)
    with _tf32_off():
        losses = [float(step(x, y)) for _ in range(DP_F32_STEPS)]
    if mesh.axis_index("dp") == 0:
        np.savez(os.path.join(outdir, "state_f32.npz"),
                 *convert.params_to_numpy(net))
    return {"losses": losses, "sha1": _imagenet_module().state_sha1(net)}


def _allreduce_ms(numel, dev, mesh, reps=3):
    """Median ms of an ``all_reduce`` of ``numel`` f32 over the dp axis
    (host clock around ``torch.cuda.synchronize()``), after one
    untimed."""
    import torch

    from incubator_mxnet_tpu_torch.parallel import collectives

    x = torch.ones(numel, device=dev)
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collectives.allreduce(x, mesh=mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times[1:])


def _dp_rank_imagenet(logs):
    """Route (iii) in this rank: ``train_imagenet_torch.py --kv-store
    dist_sync_device`` at its defaults through its ``main``."""
    import re

    ex = _imagenet_module()
    t0 = time.perf_counter()
    losses = ex.main(["--kv-store", "dist_sync_device"])
    wall = time.perf_counter() - t0
    last = [re.search(r"last loss (\S+)  state sha1 (\w+)", m).groups()
            for m in logs if "state sha1" in m]
    rate = [float(re.search(r"(\S+) img/s", m).group(1))
            for m in logs if m.startswith("batch 50 ")]
    return {"losses": losses, "last": list(last[-1]), "img_s": rate[-1],
            "wall_s": wall}


def dp_rank_main(outdir):
    """One rank of phase 3l, started by ``tools/launch_torch.py`` (this script
    with ``--dp-rank``): routes (i), (ii) and (iii) in turn in the same
    process; what each example logs is kept, and the rank's results go
    to ``rank<r>.json``.  cuDNN's autotuning stays off: two processes
    autotuning the main path's convolutions at once took 25 s."""
    import logging

    import torch

    from incubator_mxnet_tpu_torch.parallel import distributed

    logs = []

    class Keep(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    logging.getLogger().addHandler(Keep())
    logging.getLogger().setLevel(logging.INFO)
    distributed.initialize()
    dev = distributed.local_device()
    torch.cuda.set_device(dev)
    torch.backends.cudnn.benchmark = False
    result = {"rank": distributed.process_index(),
              "backend": distributed.backend()}
    result["cifar"] = _dp_rank_cifar(logs)
    torch.cuda.empty_cache()
    result["main"] = _dp_rank_main_path(dev, outdir)
    torch.cuda.empty_cache()
    result["main_f32"] = _dp_rank_main_f32(dev, outdir)
    torch.cuda.empty_cache()
    logs.clear()
    result["imagenet"] = _dp_rank_imagenet(logs)
    with open(os.path.join(outdir, "rank%d.json" % result["rank"]), "w") as f:
        json.dump(result, f)
    distributed.barrier("phase 3l")


def _one_process_run(dev, order=None, nudge=False, rows=None,
                     rescale_grad=1.0, dtype="bfloat16"):
    """The route (ii) steps in one process on the global batch: the same
    weights and batch (in ``order``, or its first ``rows`` images alone),
    with every weight nudged by 1e-6 relative, or with the gradients
    multiplied by ``rescale_grad``; in ``dtype`` (None: f32 with TF32
    off, ``DP_F32_STEPS`` steps).  Returns (losses, the state after, as
    numpy)."""
    import torch

    from incubator_mxnet_tpu_torch import convert

    net, x, y = _dp_main_net(dev)
    if order is not None:
        x, y = x[order], y[order]
    if rows is not None:
        x, y = x[:rows], y[:rows]
    if nudge:
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=g,
                                              device=dev))
    step = _dp_main_step(net, dev, rescale_grad=rescale_grad, dtype=dtype)
    with _tf32_off() if dtype is None else contextlib.nullcontext():
        losses = [float(step(x, y)) for _ in
                  range(DP["steps"] if dtype else DP_F32_STEPS)]
    return losses, convert.params_to_numpy(net)


def _dp_readings(run, one, start, trained):
    """A route (ii) run, ``(losses or None, state)``, against the one
    process's: each step's loss relative difference (None without
    losses), the running stats' largest difference relative to each
    tensor's largest magnitude (at least 1), and the update's relative L2
    difference ``||d - d_one|| / ||d_one||`` over every trained tensor
    together (``d`` the state after less the state before)."""
    import numpy as np

    loss = None
    if run[0] is not None:
        ref = np.array(one[0])
        loss = np.abs(np.array(run[0]) - ref) / np.abs(ref)
    num = den = stats = 0.0
    for t, a, b, s0 in zip(trained, run[1], one[1], start):
        a, b = a.astype(np.float64), b.astype(np.float64)
        if t:
            num += float(np.square(a - b).sum())
            den += float(np.square(b - s0).sum())
        else:
            stats = max(stats, float(np.abs(a - b).max())
                        / max(1.0, float(np.abs(b).max())))
    return loss, stats, (num / den) ** 0.5


def check_dp_cifar(ranks, card):
    """Route (i): ``cifar10_dist_torch.py`` at its defaults (kv
    ``dist_sync_device``, ``Trainer`` pushpull per parameter): each
    rank's epoch losses finite and falling, the trained parameters
    bit-equal across the ranks.  Returns dp_step_ms."""
    for rk in ranks:
        c = rk["cifar"]
        print("  rank %d: epoch mean losses %s, ms a step %s, main() %.1f s"
              % (rk["rank"], c["epoch_means"], c["epoch_ms"], c["wall_s"]),
              flush=True)
        if not _losses_ok(c["losses"]) or \
                not c["epoch_means"][-1] < c["epoch_means"][0]:
            raise AssertionError("rank %d's losses %s are not finite and "
                                 "falling" % (rk["rank"], c["epoch_means"]))
    shas = {rk["cifar"]["sha1"] for rk in ranks}
    print("  trained parameters sha1 %s" % sorted(shas), flush=True)
    if len(shas) != 1:
        raise AssertionError("the ranks' trained parameters differ")
    ms = _median([rk["cifar"]["epoch_ms"][-1] for rk in ranks])
    print("[3l] (i) cifar10_dist_torch.py dp_step_ms %.2f (second epoch, "
          "median over the ranks; the loss read back each step)  %s  on %s"
          % (ms, ranks[0]["backend"], card), flush=True)
    return ms


def check_dp_main(dev, ranks, dp_state, f32_state, card):
    """Route (ii): the main path (``resnet50_v1(ghost_bn=16)``, 224 px,
    bf16, ``multi_precision``, a dynamic loss scale, sgd 0.9 / 1e-4) at
    the global batch over dp=2 with ``zero=1``, ``DP["batch"] / 2``
    images a rank: 53/53/1 launches a rank a step, the ranks' losses and
    parameters and running stats bit-equal, and the steps within the
    noise floor of one process stepping the whole batch (the floor: that
    batch in another order, its halves swapped, and the weights nudged by
    1e-6; :func:`_dp_readings`): each step's loss within 4x the floor
    (the largest so far) plus ``DP_FLOOR_ADD`` (relative) and the running
    stats within 4x the floor's plus 1e-3.  The bf16 update is printed, not held: rounding
    amplified over the steps moves it by as much as the update itself,
    so the updates are held in f32 (:func:`check_dp_main_f32`).  Returns
    (rank 0's launches, dp_step_ms, the relative loss limit of each
    step)."""
    import numpy as np
    import torch

    want = {name: 0 for name in ranks[0]["main"]["launches"]}
    want.update({k: v * DP["steps"] for k, v in MAIN_PATH.items()})
    for rk in ranks:
        m = rk["main"]
        print("  rank %d (%s, %d images): losses %s  skipped %d  loss scale "
              "%g  step_ms %s  peak %.1f GiB  collectives %s" % (
                  rk["rank"], rk["backend"], m["local_batch"],
                  ["%.6f" % v for v in m["losses"]], m["skipped"],
                  m["loss_scale"], ["%.1f" % t for t in m["step_ms"]],
                  m["peak_gib"], m["collectives"]), flush=True)
        print("  rank %d launches %s (want %s)" % (rk["rank"], m["launches"],
                                                  want), flush=True)
        if m["launches"] != want:
            raise AssertionError("rank %d launched %s, want %s"
                                 % (rk["rank"], m["launches"], want))
        if not _losses_ok(m["losses"]):
            raise AssertionError("non-finite dp loss: %s" % m["losses"])
    first = ranks[0]["main"]
    if any(rk["main"]["losses"] != first["losses"]
           or rk["main"]["sha1"] != first["sha1"] for rk in ranks):
        raise AssertionError("the ranks' losses or state differ")
    print("  the ranks' losses and state (parameters, running stats) "
          "bit-equal: sha1 %s" % first["sha1"], flush=True)
    torch.cuda.empty_cache()
    start, trained = _dp_start(dev)
    half = DP["batch"] // 2
    swap = torch.cat([torch.arange(half, DP["batch"]),
                      torch.arange(half)]).to(dev)
    one = _one_process_run(dev)
    floors = {"halves swapped": _one_process_run(dev, order=swap),
              "weights nudged 1e-6": _one_process_run(dev, nudge=True)}
    torch.cuda.empty_cache()
    print("  one process, the whole batch: losses %s;  %s" % (
        ["%.6f" % v for v in one[0]],
        ";  ".join("%s %s" % (k, ["%.6f" % v for v in r[0]])
                   for k, r in floors.items())), flush=True)
    floor = [_dp_readings(r, one, start, trained) for r in floors.values()]
    loss_lim = 4 * np.maximum.accumulate(
        np.max([f[0] for f in floor], axis=0)) + DP_FLOOR_ADD
    stats_lim = 4 * max(f[1] for f in floor) + 1e-3
    loss, stats, upd = _dp_readings((first["losses"], dp_state), one, start,
                                    trained)
    print("  loss rel diff dp vs one process per step %s;  limit (4x floor "
          "+ 2^-7) %s" % (["%.2e" % v for v in loss],
                          ["%.2e" % v for v in loss_lim]), flush=True)
    print("  running stats max rel diff %.3e, noise floor %s (limit 4x "
          "floor + 1e-3);  update rel L2 diff %.4e, noise floor %s (not "
          "held in bf16)" % (stats, ["%.3e" % f[1] for f in floor], upd,
                             ["%.4e" % f[2] for f in floor]), flush=True)
    if np.any(loss > loss_lim) or stats > stats_lim:
        raise AssertionError("the dp step left the one-process noise floor")
    print("  gloo all_reduce over the ranks: the %d gradient floats (%.1f MB) "
          "%.3f ms, 4 floats %.3f ms (rank 0, median of 3)" % (
              first["grad_floats"], first["grad_floats"] * 4 / 1e6,
              *first["allreduce_ms"]), flush=True)
    check_dp_main_f32(dev, ranks, f32_state, start, trained)
    ms = _median([_median(rk["main"]["step_ms"][1:]) for rk in ranks])
    print("[3l] (ii) main path over dp=2, zero=1: dp_step_ms %.2f (median of "
          "steps 2-%d, %d images a rank, %d a step)  %.1f img/s  %s (CUDA "
          "tensors staged through the host)  on %s"
          % (ms, DP["steps"], half, DP["batch"], DP["batch"] / ms * 1e3,
             ranks[0]["backend"], card), flush=True)
    return first["launches"], ms, [float(v) for v in loss_lim]


def _dp_start(dev):
    """Route (ii)'s initial state (numpy) and which of its tensors
    train."""
    from incubator_mxnet_tpu_torch import convert

    net, _, _ = _dp_main_net(dev)
    grads = {n for n, p in net.named_parameters() if p.requires_grad}
    return (convert.params_to_numpy(net),
            [n in grads for n, _ in convert.ordered_tensors(net)])


def check_dp_main_f32(dev, ranks, f32_state, start, trained):
    """Route (ii) in f32 with TF32 off (``DP_F32_STEPS`` steps): the
    ranks' losses and state bit-equal, and the steps within the noise
    floor of one process (halves swapped, weights nudged 1e-6): each
    step's loss within 4x the floor plus ``DP_F32_ADD`` (relative), the
    running stats within 4x the floor's plus ``DP_F32_ADD``, the update's
    relative L2 difference within 4x the floor's.  The update limit must
    see the faults a dp step can make, each stood in for by one process:
    no update at all, the gradients summed and not averaged
    (``rescale_grad=2``), a step on rank 0's half alone."""
    import numpy as np
    import torch

    first = ranks[0]["main_f32"]
    if any(rk["main_f32"] != first for rk in ranks):
        raise AssertionError("the ranks' f32 losses or state differ")
    half = DP["batch"] // 2
    swap = torch.cat([torch.arange(half, DP["batch"]),
                      torch.arange(half)]).to(dev)
    one = _one_process_run(dev, dtype=None)
    floors = [_one_process_run(dev, order=swap, dtype=None),
              _one_process_run(dev, nudge=True, dtype=None)]
    faults = {
        "no update": (None, [s0 if t else a for t, s0, a in
                             zip(trained, start, f32_state)]),
        "gradients summed, not averaged": _one_process_run(
            dev, rescale_grad=float(DP_RANKS), dtype=None),
        "rank 0's half alone": _one_process_run(dev, rows=half, dtype=None)}
    torch.cuda.empty_cache()
    floor = [_dp_readings(r, one, start, trained) for r in floors]
    loss_lim = 4 * np.max([f[0] for f in floor], axis=0) + DP_F32_ADD
    stats_lim = 4 * max(f[1] for f in floor) + DP_F32_ADD
    upd_lim = 4 * max(f[2] for f in floor)
    loss, stats, upd = _dp_readings((first["losses"], f32_state), one,
                                    start, trained)
    print("  f32, TF32 off, %d step(s): the ranks' losses and state "
          "bit-equal (sha1 %s); loss rel diff dp vs one process %s, limit "
          "%s;  running stats %.3e, limit %.3e;  update rel L2 diff %.4e, "
          "noise floor %s (limit 4x floor: %.4e)" % (
              DP_F32_STEPS, first["sha1"], ["%.2e" % v for v in loss],
              ["%.2e" % v for v in loss_lim], stats, stats_lim, upd,
              ["%.4e" % f[2] for f in floor], upd_lim), flush=True)
    if np.any(loss > loss_lim) or stats > stats_lim or upd > upd_lim:
        raise AssertionError("the f32 dp step left the one-process noise "
                             "floor")
    for name, run in faults.items():
        f_upd = _dp_readings(run, one, start, trained)[2]
        print("  f32 fault stood in by one process, %s: update rel L2 diff "
              "%.4e (%.1fx the limit)" % (name, f_upd, f_upd / upd_lim),
              flush=True)
        if not f_upd > upd_lim:
            raise AssertionError("the update limit %.4e cannot see a dp step "
                                 "with %s (%.4e)" % (upd_lim, name, f_upd))


def _imagenet_one_process(dev, order=None, rows=None, nudge=False):
    """Route (iii)'s first ``DP_IMAGENET_STEPS`` steps in one process:
    the trainer's net, step and synthetic global batch at its defaults
    (the batch in ``order``, or its first ``rows`` images alone, or the
    weights nudged by 1e-6 relative).  Returns the losses."""
    import torch

    ex = _imagenet_module()
    args = ex.parse_args([])
    net = ex.build_net(args, dev)
    if nudge:
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=g,
                                              device=dev))
    step = ex.build_step(net, args, dev)
    src = ex.batches(args, dev)
    x, y = next(src)
    src.close()
    if order is not None:
        x, y = x[order], y[order]
    if rows is not None:
        x, y = x[:rows], y[:rows]
    return [float(step(x, y)) for _ in range(DP_IMAGENET_STEPS)]


def check_dp_imagenet(dev, ranks, card):
    """Route (iii): ``train_imagenet_torch.py --kv-store dist_sync_device``
    at its defaults (stock-BN ``resnet50_v1``, global batch 128, 50
    batches, bf16, lr 0.1): the ranks' losses and state (parameters,
    running stats) equal, the losses finite, and the first
    ``DP_IMAGENET_STEPS`` losses within 4x the noise floor plus
    ``DP_FLOOR_ADD`` (relative) of the trainer's step in one process on
    the same global batch (the floor: that batch with its halves
    swapped, and the weights nudged by 1e-6; at each step the largest
    difference so far, as the bf16 losses of two runs can meet again
    by chance), a limit that the same step on rank 0's half alone must
    miss.  Returns dp_step_ms."""
    import numpy as np
    import torch

    for rk in ranks:
        im = rk["imagenet"]
        print("  rank %d: losses %s ... %s  last loss and state sha1 %s  "
              "main() %.1f s" % (rk["rank"],
                                 ["%.4f" % v for v in im["losses"][:3]],
                                 ["%.4f" % v for v in im["losses"][-3:]],
                                 im["last"], im["wall_s"]), flush=True)
        if not _losses_ok(im["losses"]):
            raise AssertionError("non-finite loss: %s" % im["losses"])
    if any(rk["imagenet"]["losses"] != ranks[0]["imagenet"]["losses"]
           or rk["imagenet"]["last"] != ranks[0]["imagenet"]["last"]
           for rk in ranks):
        raise AssertionError("the ranks' losses or state differ")
    batch = _imagenet_module().parse_args([]).batch_size
    swap = torch.cat([torch.arange(batch // 2, batch),
                      torch.arange(batch // 2)]).to(dev)
    one = np.array(_imagenet_one_process(dev))
    floors = [_imagenet_one_process(dev, order=swap),
              _imagenet_one_process(dev, nudge=True)]
    alone = _imagenet_one_process(dev, rows=batch // 2)
    torch.cuda.empty_cache()

    def rel(losses):
        return np.abs(np.array(losses) - one) / np.abs(one)

    dp = ranks[0]["imagenet"]["losses"][:DP_IMAGENET_STEPS]
    floor = np.maximum.accumulate(np.max([rel(f) for f in floors], axis=0))
    limit = 4 * floor + DP_FLOOR_ADD
    print("  first %d losses: dp %s, one process %s, halves swapped %s, "
          "weights nudged 1e-6 %s, rank 0's half alone %s" % (
              DP_IMAGENET_STEPS, ["%.4f" % v for v in dp],
              ["%.4f" % v for v in one], ["%.4f" % v for v in floors[0]],
              ["%.4f" % v for v in floors[1]], ["%.4f" % v for v in alone]),
          flush=True)
    print("  loss rel diff dp vs one process %s, rank 0's half alone %s;  "
          "limit (4x floor + 2^-7) %s" % (
              ["%.2e" % v for v in rel(dp)], ["%.2e" % v for v in rel(alone)],
              ["%.2e" % v for v in limit]), flush=True)
    if np.any(rel(dp) > limit):
        raise AssertionError("the dp trainer left the one-process noise "
                             "floor")
    if not np.any(rel(alone) > limit):
        raise AssertionError("the loss limit cannot see a step on rank 0's "
                             "half alone")
    rate = _median([rk["imagenet"]["img_s"] for rk in ranks])
    ms = batch / rate * 1e3
    print("[3l] (iii) train_imagenet_torch.py --kv-store dist_sync_device: "
          "dp_step_ms %.2f (batches 41-50, global batch %d, %d a rank)  "
          "%.1f img/s  %s  on %s" % (ms, batch, batch // 2, rate,
                                     ranks[0]["backend"], card), flush=True)
    return ms


def run_dp_job(dev, card):
    """Phase 3l (i)-(iii): one job of ``DP_RANKS`` ranks of this script
    (``--dp-rank``) through ``tools/launch_torch.py``, then the checks.
    Returns route (ii)'s rank-0 launches and its relative loss limit of
    each step."""
    import numpy as np

    outdir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        t0 = time.perf_counter()
        _launch_ranks([sys.executable, os.path.abspath(__file__),
                       "--dp-rank", outdir])
        print("  the two-rank job took %.1f s" % (time.perf_counter() - t0),
              flush=True)
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(outdir, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        states = []
        for name in ("state.npz", "state_f32.npz"):
            with np.load(os.path.join(outdir, name)) as z:
                states.append([z["arr_%d" % i] for i in range(len(z.files))])
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    print("[3l] (i) example/distributed_training/cifar10_dist_torch.py at "
          "its defaults", flush=True)
    check_dp_cifar(ranks, card)
    print("[3l] (ii) the main path: resnet50_v1(ghost_bn=16), batch %d over "
          "dp=%d with zero=1, %d px, bf16, multi_precision, dynamic loss "
          "scale, sgd lr %g, %d steps, against one process"
          % (DP["batch"], DP_RANKS, IMAGE, DP["lr"], DP["steps"]), flush=True)
    launches, _, loss_limits = check_dp_main(dev, ranks, *states, card)
    print("[3l] (iii) example/image_classification/train_imagenet_torch.py "
          "--kv-store dist_sync_device at its defaults", flush=True)
    check_dp_imagenet(dev, ranks, card)
    return launches, loss_limits


def run_dp_nccl(dev, card):
    """Phase 3l (iv), in a process of its own (``--dp-nccl``): NCCL at
    world size 1 (the group created here): a
    ``dist_sync`` push and pull (one broadcast, one all_reduce), one
    ``Trainer.step`` over that store, and the dp step over the group's
    mesh with ``zero=1`` equal bit for bit to the step without a mesh."""
    import socket

    import torch
    import torch.distributed as dist

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import context, gluon
    from incubator_mxnet_tpu_torch.parallel import (collectives, distributed,
                                                    make_mesh,
                                                    make_train_step)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=1, rank=0, device_id=dev)
    try:
        if distributed.backend() != "nccl":
            raise AssertionError("backend %s" % distributed.backend())
        collectives.reset_call_counts()
        store = mx.kv.create("dist_sync")
        store.init("w", mx.nd.full((1000,), 2.0, ctx=dev))
        store.push("w", [mx.nd.ones((1000,), ctx=dev)] * 3)
        out = mx.nd.zeros((1000,), ctx=dev)
        store.pull("w", out=out)
        if not torch.equal(out._data, torch.full((1000,), 3.0, device=dev)):
            raise AssertionError("NCCL push/pull gave %s" % out._data[:4])
        kv_counts = collectives.call_counts()
        if kv_counts != {"broadcast": 1, "all_reduce": 1}:
            raise AssertionError("kvstore collectives %s" % kv_counts)

        def mlp():
            mx.random.seed(SEED)
            with context.device_scope(dev):
                net = gluon.nn.HybridSequential()
                net.add(gluon.nn.Dense(64, in_units=32, activation="relu"),
                        gluon.nn.Dense(13, in_units=64))
            net.initialize(init=mx.init.Xavier())
            return net

        net = mlp()
        before = net[0].weight.detach().clone()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}, kvstore=store)
        x = mx.nd.random.uniform(shape=(8, 32), ctx=dev)
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        trainer.step(8)
        if torch.equal(before, net[0].weight):
            raise AssertionError("Trainer.step over the NCCL store moved "
                                 "nothing")
        g = torch.Generator(device=dev).manual_seed(SEED)
        xb = torch.randn(8, 32, generator=g, device=dev)
        yb = torch.randint(0, 13, (8,), generator=g, device=dev).float()
        runs = []
        for mesh in (None, make_mesh({"dp": 1})):
            net = mlp()
            collectives.reset_call_counts()
            step = make_train_step(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                   device=dev, learning_rate=0.1,
                                   multi_precision=True, mesh=mesh,
                                   zero=1 if mesh is not None else 0)
            losses = [float(step(xb, yb)) for _ in range(3)]
            runs.append((losses, [p.detach().clone()
                                  for p in net.parameters()],
                         collectives.call_counts()))
        if runs[0][0] != runs[1][0] or not all(
                torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])):
            raise AssertionError("the NCCL dp step differs from the plain "
                                 "step")
        print("[3l] (iv) NCCL at world size 1: push/pull %s, Trainer.step, "
              "dp step (zero=1) %s bit-equal to the plain step  on %s"
              % (kv_counts, runs[1][2], card), flush=True)
    finally:
        dist.destroy_process_group()


# phase 3m: multi-process checkpoints, a rank lost mid-save, the elastic
# restore; phase 3l (ii)'s step at the trainer's lr
ELASTIC = dict(images=1024, batch=BATCH, steps=4, save_step=2, lr=0.1,
               commit_timeout=10.0)
#: the nets' seeds: the two-rank job, the dp=1 resume, the dp=2 restore
ELASTIC_SEEDS = (SEED, SEED + 7, SEED + 11)
#: seconds each two-rank job may take
ELASTIC_TIMEOUT = 300


def _elastic_data():
    """The resident set: ``ELASTIC["images"]`` normal f32 images of 224
    px and their labels, from a seed (every process makes the same)."""
    import torch

    g = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn(ELASTIC["images"], 3, IMAGE, IMAGE, generator=g)
    y = torch.randint(0, 1000, (ELASTIC["images"],), generator=g).float()
    return x.numpy(), y.numpy()


def _elastic_iter(data, shuffle_seed):
    """``ResilientIter(NDArrayIter(...))`` over the global batches, the
    shuffle drawn from ``shuffle_seed`` (a restore replaces it)."""
    import numpy as np

    from incubator_mxnet_tpu_torch import cpu
    from incubator_mxnet_tpu_torch.io import NDArrayIter, ResilientIter

    np.random.seed(shuffle_seed)
    return ResilientIter(NDArrayIter(data[0], data[1],
                                     batch_size=ELASTIC["batch"],
                                     shuffle=True, ctx=cpu()))


def _main_net(dev, seed):
    """``resnet50_v1(ghost_bn=16)``, the main path's net, drawn from
    ``seed``."""
    import torch

    from incubator_mxnet_tpu_torch import initializer
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    net = resnet.resnet50_v1(classes=1000, ghost_bn=16, device=dev)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(seed))
    return net


def _elastic_step(dev, mesh, seed):
    """The main path's step over ``mesh`` with ``zero=1``, on a net drawn
    from ``seed``."""
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    return make_train_step(_main_net(dev, seed), SoftmaxCrossEntropyLoss(),
                           optimizer="sgd", learning_rate=ELASTIC["lr"],
                           momentum=0.9, wd=1e-4, multi_precision=True,
                           loss_scale="dynamic", compute_dtype="bfloat16",
                           device=dev, mesh=mesh, zero=1)


def _elastic_feed(step, mesh, batch, dev):
    """One step on this process's rows of the global batch; its loss."""
    x, y = (mesh.local_slice(v._data).to(dev)
            for v in (batch.data[0], batch.label[0]))
    return float(step(x, y))


def _elastic_digest(step, part, count):
    """SHA-1 of the logical state as rank ``part`` of ``count`` holds it:
    the parameters, running stats, step counter and loss-scale state, and
    that rank's rows of each optimizer-state leaf without the ZeRO
    padding.  A rank of a dp=``count`` step and one process (which holds
    every row) give equal digests for equal states."""
    h = hashlib.sha1()
    for t in list(step._gp) + list(step._aux):
        h.update(t.detach().cpu().numpy().tobytes())
    h.update(str(step.step_count).encode())
    for t in (step._scale, step._unskipped, step._skipped):
        h.update(t.cpu().numpy().tobytes())
    for s, p in zip(step._opt_state, step._gp):
        rows = -(-p.shape[0] // count)
        lo, hi = part * rows, min((part + 1) * rows, p.shape[0])
        for leaf in (s if isinstance(s, tuple) else (s,)):
            blk = leaf[:max(0, hi - lo)] if step._n > 1 else leaf[lo:hi]
            h.update(blk.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def elastic_rank_main(outdir, stage):
    """One rank of phase 3m (this script with ``--elastic-rank DIR
    STAGE``).  ``train``: 4 steps from ``ELASTIC_SEEDS[0]`` with a
    checkpoint of step 2; in the step-4 save rank 1 dies and rank 0 must
    refuse the commit (the exit codes are 3 for that refusal, else 4 or
    5).  ``restore``: the dp=1 re-save of this process's parent restored,
    then steps 3 and 4.  Each rank writes ``<stage>_rank<r>.json``."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.parallel import (CheckpointError,
                                                    CheckpointManager,
                                                    distributed, make_mesh)
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi

    distributed.initialize()
    dev = distributed.local_device()
    torch.cuda.set_device(dev)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rank = distributed.process_index()
    mesh = make_mesh({"dp": -1})
    data = _elastic_data()
    result = {"rank": rank, "idx": [], "losses": [], "launches": []}
    path = os.path.join(outdir, "%s_rank%d.json" % (stage, rank))

    def dump(**kw):
        result.update(kw)
        with open(path, "w") as f:
            json.dump(result, f)
            f.flush()
            os.fsync(f.fileno())

    if stage == "train":
        step = _elastic_step(dev, mesh, ELASTIC_SEEDS[0])
        it = _elastic_iter(data, SEED)
        mgr = CheckpointManager(os.path.join(outdir, "ckpt"),
                                commit_timeout=ELASTIC["commit_timeout"])
        waits = []
        wait_markers = mgr._wait_markers

        def timed_wait(*args):  # rank 0's wait for the peers' markers
            t0 = time.perf_counter()
            try:
                return wait_markers(*args)
            finally:
                waits.append((time.perf_counter() - t0) * 1e3)

        mgr._wait_markers = timed_wait
        first = 0
    else:
        step = _elastic_step(dev, mesh, ELASTIC_SEEDS[2])
        it = _elastic_iter(data, SEED + 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = step.restore_checkpoint(os.path.join(outdir, "ckpt1"),
                                        data_iter=it)
        torch.cuda.synchronize()
        dump(restored=first, restore_ms=(time.perf_counter() - t0) * 1e3,
             digest=_elastic_digest(step, rank, mesh.size))
    for k in range(first, ELASTIC["steps"]):
        b = it.next()
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        loss = _elastic_feed(step, mesh, b, dev)
        result["launches"].append(_kernels.launch_counts())
        result["idx"].append(np.asarray(b.index).tolist())
        result["losses"].append(loss)
        if stage == "train" and k + 1 == ELASTIC["save_step"]:
            t0 = time.perf_counter()
            d = step.save_checkpoint(mgr, data_iter=it)
            save_ms = (time.perf_counter() - t0) * 1e3
            with open(os.path.join(d, "done-p%05d.json" % rank)) as f:
                mine = json.load(f)["files"]
            dump(save_ms=save_ms, commit_wait_ms=waits[-1] if waits else None,
                 save_bytes=sum(f["nbytes"] for files in mine.values()
                                for _, f in files),
                 digest=_elastic_digest(step, rank, mesh.size))
        dump()
    it.close()
    if stage == "restore":
        distributed.barrier("phase 3m")
        return 0
    if rank == 1:
        dump(kill_t=time.time())
        with fi.host_loss_during_save(at=0):
            step.save_checkpoint(mgr, data_iter=it)
        dump(error="the host loss did not fire")
        return 4
    try:
        step.save_checkpoint(mgr, data_iter=it)
    except CheckpointError as e:
        dump(error=type(e).__name__, message=str(e), error_t=time.time(),
             steps=mgr.steps(), listing=sorted(os.listdir(mgr.directory)))
        return 3
    dump(error="the commit went through without rank 1")
    return 5


def _elastic_ranks(outdir, stage):
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(outdir, "%s_rank%d.json" % (stage, r))) as f:
            ranks.append(json.load(f))
    return ranks


def _elastic_gate_launches(ranks, label):
    """53/53/1 launches of K1-K3 a rank a step, and no other kernel."""
    for rk in ranks:
        for k, got in enumerate(rk["launches"]):
            want = {name: 0 for name in got}
            want.update(MAIN_PATH)
            if got != want:
                raise AssertionError("%s rank %d step %d launched %s, want "
                                     "%s" % (label, rk["rank"], k, got, want))


def _elastic_manifest_checks(d):
    """The step-2 manifest: two shard files of each ZeRO leaf, one from
    each rank (its marker lists it), and both ranks' iterator states."""
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    markers = []
    for r in range(DP_RANKS):
        with open(os.path.join(d, "done-p%05d.json" % r)) as f:
            markers.append({fe["file"] for files in json.load(f)[
                "files"].values() for _, fe in files})
    sharded = [e for e in manifest["arrays"]
               if e["key"].startswith("['opt_state']")]
    for e in sharded:
        files = [f["file"] for f in e["files"]]
        if len(files) != DP_RANKS or any(
                f not in markers[r] for r, f in enumerate(files)):
            raise AssertionError("ZeRO leaf %s: files %s, not one a rank"
                                 % (e["key"], files))
    parts = set(manifest["meta"].get("data_iter_parts", {}))
    if parts != {"0", "1"}:
        raise AssertionError("data_iter_parts %s" % sorted(parts))
    return len(sharded), len(manifest["arrays"])


def run_elastic_path(dev, card, loss_limit):
    """Phase 3m (see the module docstring).  ``loss_limit``: phase 3l
    (ii)'s relative loss limit of its first step, which the first step
    after the 2 -> 1 restore is held to.  Returns the launches of the
    main path's steps here and in each job's rank 0."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    counts = {name: 0 for name in MAIN_PATH}
    outdir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    here = os.path.abspath(__file__)
    try:
        # (1) two ranks; rank 1 lost in the step-4 save
        rc, out = _run_ranks([sys.executable, here, "--elastic-rank", outdir,
                              "train"], ELASTIC_TIMEOUT)
        train = _elastic_ranks(outdir, "train")
        r0, r1 = train
        if rc == 0 or r0.get("error") != "CheckpointError" \
                or "done-marker" not in r0.get("message", "") \
                or "error" in r1:
            raise AssertionError("the lost rank was not refused (rc %d): %s"
                                 "\n%s" % (rc, [r0.get("error"),
                                                r1.get("error")],
                                           out[-3000:]))
        if r0["steps"] != [ELASTIC["save_step"]] or \
                ".tmp-step-%08d" % ELASTIC["steps"] not in r0["listing"]:
            raise AssertionError("committed %s, on disk %s"
                                 % (r0["steps"], r0["listing"]))
        _elastic_gate_launches(train, "(1)")
        if r0["losses"] != r1["losses"] or r0["idx"] != r1["idx"]:
            raise AssertionError("the ranks' losses differ")
        if not _losses_ok(r0["losses"]):
            raise AssertionError("non-finite losses %s" % r0["losses"])
        n_zero, n_leaves = _elastic_manifest_checks(os.path.join(
            outdir, "ckpt", "step-%08d" % ELASTIC["save_step"]))
        for name in MAIN_PATH:
            counts[name] += sum(c[name] for c in r0["launches"])
        print("[3m] (1) two ranks, dp=2 x %d, zero=1: losses %s, 53/53/1 "
              "launches a rank a step; step-%d checkpoint: %d leaves, %d "
              "ZeRO leaves in two shard files each, iterator parts of both "
              "ranks; rank 1 killed in the step-%d save, rank 0 refused: %s"
              % (ELASTIC["batch"] // DP_RANKS,
                 ["%.6f" % v for v in r0["losses"]], ELASTIC["save_step"],
                 n_leaves, n_zero, ELASTIC["steps"],
                 r0["message"][:120]), flush=True)
        for rk in train:
            print("[3m] rank %d step-%d save %.1f ms, %d bytes written%s  on "
                  "%s" % (rk["rank"], ELASTIC["save_step"], rk["save_ms"],
                          rk["save_bytes"],
                          "; commit wait %.1f ms" % rk["commit_wait_ms"]
                          if rk["commit_wait_ms"] is not None else "", card),
                  flush=True)
        print("[3m] kill to rank 0's CheckpointError %.2f s (commit_timeout "
              "%g s)  on %s" % (r0["error_t"] - r1["kill_t"],
                                ELASTIC["commit_timeout"], card), flush=True)

        # (2) one process resumes at dp=1 and re-saves
        torch.cuda.empty_cache()
        old = (torch.backends.cudnn.deterministic,
               torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            mesh = make_mesh({"dp": 1})
            step = _elastic_step(dev, mesh, ELASTIC_SEEDS[1])
            it = _elastic_iter(_elastic_data(), SEED + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored = step.restore_checkpoint(os.path.join(outdir, "ckpt"),
                                               data_iter=it)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            digests = [_elastic_digest(step, r, DP_RANKS)
                       for r in range(DP_RANKS)]
            if restored != ELASTIC["save_step"] or \
                    digests != [rk["digest"] for rk in train]:
                raise AssertionError("dp=1 restored step %d, digests %s, "
                                     "the ranks' %s" % (
                                         restored, digests,
                                         [rk["digest"] for rk in train]))
            step.save_checkpoint(os.path.join(outdir, "ckpt1"), data_iter=it)
            one = {"idx": [], "losses": []}
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            for _ in range(ELASTIC["steps"] - restored):
                b = it.next()
                one["idx"].append(b.index.tolist())
                one["losses"].append(_elastic_feed(step, mesh, b, dev))
            launched = _kernels.launch_counts()
            it.close()
        finally:
            torch.backends.cudnn.deterministic, \
                torch.backends.cudnn.benchmark = old
        del step
        torch.cuda.empty_cache()
        want = {name: 0 for name in launched}
        want.update({name: n * len(one["losses"])
                     for name, n in MAIN_PATH.items()})
        if launched != want:
            raise AssertionError("dp=1 launched %s, want %s"
                                 % (launched, want))
        for name in MAIN_PATH:
            counts[name] += launched[name]
        if one["idx"] != r0["idx"][restored:]:
            raise AssertionError("the resumed batches are not the lost ones")
        rel = abs(one["losses"][0] - r0["losses"][restored]) / \
            abs(r0["losses"][restored])
        if rel > loss_limit:
            raise AssertionError("dp=1 step-3 loss %.6f vs the ranks' %.6f: "
                                 "%.3e over the limit %.3e" % (
                                     one["losses"][0], r0["losses"][restored],
                                     rel, loss_limit))
        print("[3m] (2) one process at dp=1 (2 -> 1): restored step %d, the "
              "ranks' digests, re-saved at dp=1; its batches 3-4 are the "
              "ranks'; losses %s vs %s, step 3 rel diff %.3e (limit %.3e, "
              "phase 3l (ii)'s first step)  elastic restore %.1f ms  on %s"
              % (restored, ["%.6f" % v for v in one["losses"]],
                 ["%.6f" % v for v in r0["losses"][restored:]], rel,
                 loss_limit, restore_ms, card), flush=True)

        # (3) two ranks restore the dp=1 checkpoint
        _launch_ranks([sys.executable, here, "--elastic-rank", outdir,
                       "restore"], ELASTIC_TIMEOUT)
        back = _elastic_ranks(outdir, "restore")
        _elastic_gate_launches(back, "(3)")
        for rk, was in zip(back, train):
            if rk["restored"] != restored or rk["digest"] != was["digest"] \
                    or rk["losses"] != was["losses"][restored:] \
                    or rk["idx"] != was["idx"][restored:]:
                raise AssertionError(
                    "rank %d after 1 -> 2: step %d, losses %s, want %s"
                    % (rk["rank"], rk["restored"], rk["losses"],
                       was["losses"][restored:]))
        for name in MAIN_PATH:
            counts[name] += sum(c[name] for c in back[0]["launches"])
        print("[3m] (3) two ranks (1 -> 2): restored step %d, the step-2 "
              "digests, steps 3-4 bit-equal to (1): %s  restore %s ms  on %s"
              % (back[0]["restored"],
                 ["%.6f" % v for v in back[0]["losses"]],
                 ["%.1f" % rk["restore_ms"] for rk in back], card),
              flush=True)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("[3m] phase wall time %.2f s  on %s"
          % (time.perf_counter() - t_phase, card), flush=True)
    return counts


# phase 3n: model parallelism, two ranks sharing the card over gloo
#: (i) the LM at phase 3b's width through train_lm_torch.py --devices 2;
#: (ii) pp=2 over 8 Dense(1024, tanh); (iii) ep=2 over an MoEFFN of 8
#: experts.  The ranks read this from the job's config.json, so a test can
#: run the phase small.
MP = {"lm": dict(vocab=LM["vocab"], dim=LM["dim"], heads=LM["heads"],
                 layers=LM["n_layers"], seq=2048, batch=4, lr=LM_LR,
                 steps=3),
      "pp": dict(width=1024, layers=8, classes=256, batch=256, num_micro=4,
                 steps=4),
      "moe": dict(width=1024, hidden=4096, experts=8, top_k=2,
                  capacity=2.0, classes=256, tokens=4096, lr=0.1, steps=3)}
#: seconds the launched two-rank job may take
MP_TIMEOUT = 300
#: (i): step 1's loss and weight gradients within 4x the one-process
#: floor (check_mp_lm) plus this, relative to each tensor's largest
#: magnitude
MP_LM_ADD = 1e-5
#: (ii): the unit-lr gradients within this of max |g| of one process
MP_PP_TOL = 1e-5
#: (iii): the losses within this (relative) of the ep=1 step's, the
#: parameters within this of each tensor's largest update
MP_MOE_LOSS_TOL = 1e-4
MP_MOE_PARAM_TOL = 1e-2


def _mp_lm_argv(cfg, impl, devices):
    return ["--devices", str(devices), "--impl", impl,
            "--seq", str(cfg["seq"]), "--dim", str(cfg["dim"]),
            "--heads", str(cfg["heads"]), "--layers", str(cfg["layers"]),
            "--vocab", str(cfg["vocab"]), "--batch", str(cfg["batch"]),
            "--lr", str(cfg["lr"]), "--steps", str(cfg["steps"])]


def _mp_lm_weights(layers):
    """The LM's 14 weight matrices at 2 layers: ``embed``, ``out`` and
    each layer's ``wq``, ``wk``, ``wv``, ``wo``, ``w1``, ``w2``."""
    return ["embed", "out"] + ["l%d.%s" % (i, k) for i in range(layers)
                               for k in ("wq", "wk", "wv", "wo", "w1", "w2")]


def _mp_lm_grads(lmm, lm, tokens, layers):
    """The example's loss at ``lm``'s weights and the gradients of its
    weight matrices, as numpy."""
    import torch

    params = dict(lm.named_parameters())
    names = _mp_lm_weights(layers)
    loss = lmm.loss_fn(lm, tokens)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.item(), {n: g.cpu().numpy() for n, g in zip(names, grads)}


def _mp_pp_net(dev, cfg):
    from incubator_mxnet_tpu_torch import initializer, random
    from incubator_mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    for _ in range(cfg["layers"]):
        net.add(nn.Dense(cfg["width"], in_units=cfg["width"],
                         activation="tanh", device=dev))
    random.seed(SEED + 20)
    net.initialize(init=initializer.Xavier())
    return net


def _mp_moe_net(dev, cfg):
    from incubator_mxnet_tpu_torch import initializer, random
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.gluon.contrib.nn import MoEFFN

    w = cfg["width"]
    net = nn.HybridSequential()
    net.add(nn.Dense(w, in_units=w, activation="relu", device=dev),
            MoEFFN(cfg["hidden"], cfg["experts"], top_k=cfg["top_k"],
                   capacity_factor=cfg["capacity"], aux_loss_weight=1e-2,
                   in_units=w, device=dev),
            nn.Dense(cfg["classes"], in_units=w, device=dev))
    random.seed(SEED + 30)
    net.initialize(init=initializer.Xavier())
    return net


def _mp_batch(dev, rows, width, classes, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, width, generator=g, device=dev)
    y = torch.randint(0, classes, (rows,), generator=g, device=dev).float()
    return x, y


def _mp_step(net, dev, lr, mesh=None, **kw):
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    return make_train_step(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                           learning_rate=lr, device=dev, mesh=mesh, **kw)


def _timed_calls(fn, steps):
    """``steps`` calls of ``fn`` (each returning a loss tensor), the
    launch and collective counters set to 0 just before and read just
    after: (losses, ms a call, launches, collectives)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    collectives.reset_call_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(fn()))   # float() waits for the card
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, _kernels.launch_counts(), collectives.call_counts()


def _mp_rank_lm(dev, cfg, impl, outdir, rank):
    """(i) in this rank: ``train_lm_torch.py --devices 2 --impl impl``
    built through its own functions; step 1's weight gradients (rank 0
    writes them), then its steps with the counters set to 0 just
    before."""
    lmm = _lm_module()
    args = lmm.parse_args(_mp_lm_argv(cfg, impl, 2))
    mesh = lmm.build_mesh(args)
    lm, tokens = lmm.build(args, mesh)
    loss1, grads = _mp_lm_grads(lmm, lm, tokens, cfg["layers"])
    if rank == 0:
        import numpy as np

        np.savez(os.path.join(outdir, "lm_%s.npz" % impl), **grads)
    step = lmm.make_step(lm, args.lr)
    losses, ms, launches, calls = _timed_calls(lambda: step(tokens),
                                               cfg["steps"])
    return {"loss1": loss1, "losses": losses, "step_ms": ms,
            "launches": launches, "collectives": calls,
            "sha1": _imagenet_module().state_sha1(lm)}


def _mp_rank_pp(dev, cfg, outdir, rank):
    """(ii) in this rank: one unit-lr step (sgd, no momentum) over
    ``{"pp": 2}`` with remat off and on, each rank's gradients (rank 0
    writes them), then more steps of the first, timed."""
    import numpy as np

    from incubator_mxnet_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"pp": 2})
    x, y = _mp_batch(dev, cfg["batch"], cfg["width"], cfg["classes"],
                     SEED + 21)
    out = {}
    for remat in (False, True):
        net = _mp_pp_net(dev, cfg)
        step = _mp_step(net, dev, 1.0, mesh, momentum=0.0,
                        pipeline_stages=2, num_micro=cfg["num_micro"],
                        pipeline_remat=remat)
        before = [p.detach().clone() for p in step._gp]
        losses, ms, launches, calls = _timed_calls(lambda: step(x, y), 1)
        if rank == 0:
            np.savez(os.path.join(outdir, "pp_remat%d.npz" % remat),
                     *[(b - p.detach()).cpu().numpy()
                       for b, p in zip(before, step._gp)])
        key = "remat" if remat else "plain"
        out[key] = {"loss": losses[0], "collectives": calls,
                    "sha1": _imagenet_module().state_sha1(net)}
        if not remat:
            more = _timed_calls(lambda: step(x, y), cfg["steps"] - 1)
            out["losses"], out["step_ms"] = more[0], more[1]
            out["launches"] = more[2]
    return out


def _mp_rank_moe(dev, cfg, outdir, rank):
    """(iii) in this rank: the MoE net's step over ``{"dp": 1, "ep": 2}``
    with the experts sharded (this rank holds half), its steps with the
    counters set to 0 just before; rank 0 writes the parameters after,
    gathered."""
    import numpy as np

    from incubator_mxnet_tpu_torch.parallel import collectives, make_mesh

    mesh = make_mesh({"dp": 1, "ep": 2})
    net = _mp_moe_net(dev, cfg)
    moe = net[1]
    step = _mp_step(net, dev, cfg["lr"], mesh,
                    param_shardings=moe.expert_shardings("ep"))
    x, y = _mp_batch(dev, cfg["tokens"], cfg["width"], cfg["classes"],
                     SEED + 31)
    losses, ms, launches, calls = _timed_calls(lambda: step(x, y),
                                               cfg["steps"])
    whole = []
    for i, p in enumerate(step._gp):
        if i in step._shards:
            axis, d = step._shards[i]
            p = collectives.allgather(p.detach(), axis, mesh, axis=d)
        whole.append(p.detach().cpu().numpy())
    if rank == 0:
        np.savez(os.path.join(outdir, "moe.npz"), *whole)
    h = hashlib.sha1()
    for i, p in enumerate(step._gp):
        if i not in step._shards:
            h.update(p.detach().cpu().numpy().tobytes())
    return {"losses": losses, "step_ms": ms, "launches": launches,
            "collectives": calls, "experts_held": int(moe.expert_w1.shape[0]),
            "replicated_sha1": h.hexdigest()}


def mp_rank_main(outdir):
    """One rank of phase 3n, started by ``tools/launch_torch.py`` (this script
    with ``--mp-rank``): (i) ring then Ulysses, (ii), (iii) in turn in
    f32 with TF32 off; the rank's results go to ``rank<r>.json``."""
    import torch

    from incubator_mxnet_tpu_torch.parallel import distributed

    with open(os.path.join(outdir, "config.json")) as f:
        cfg = json.load(f)
    distributed.initialize()
    dev = distributed.local_device()
    torch.cuda.set_device(dev)
    rank = distributed.process_index()
    result = {"rank": rank, "backend": distributed.backend()}
    with _tf32_off():
        for impl in ("ring", "ulysses"):
            result["lm_" + impl] = _mp_rank_lm(dev, cfg["lm"], impl, outdir,
                                               rank)
            torch.cuda.empty_cache()
        result["pp"] = _mp_rank_pp(dev, cfg["pp"], outdir, rank)
        torch.cuda.empty_cache()
        result["moe"] = _mp_rank_moe(dev, cfg["moe"], outdir, rank)
    with open(os.path.join(outdir, "rank%d.json" % rank), "w") as f:
        json.dump(result, f)
    distributed.barrier("phase 3n")


def _per_step(calls, steps):
    return {k: v / steps for k, v in sorted(calls.items())}


def check_mp_lm(dev, ranks, grads, cfg, card):
    """(i): every loss finite, the replicas bit-equal, K4/K5/K6 launched
    ``layers`` times a rank a step under Ulysses and never under ring,
    and step 1's loss and weight gradients within 4x the one-process
    floor plus ``MP_LM_ADD`` of the one-process LM on the card.  Ulysses
    runs the flash kernels as one process does, so its floor is that
    LM's at weights nudged 1e-6.  Ring attention is another
    implementation (blockwise f32 softmax), so its floor is also the
    spread between two implementations of the same attention in one
    process: the flash kernels against the plain dense attention
    (``attention_reference``), which the gradients of wq and wk
    amplify most (dS = P (dP - delta) cancels).  Returns rank 0's
    Ulysses launches."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch.parallel.ring_attention import \
        attention_reference

    lmm = _lm_module()
    with _tf32_off():
        args = lmm.parse_args(_mp_lm_argv(cfg, "ring", 0))
        lm, tokens = lmm.build(args)
        one_loss, one = _mp_lm_grads(lmm, lm, tokens, cfg["layers"])
        # the same LM with the plain dense attention in the flash
        # kernels' place (the name its forward calls)
        flash = lmm.flash_attention
        lmm.flash_attention = \
            lambda q, k, v, causal: attention_reference(q, k, v, causal)
        try:
            dense_loss, plain = _mp_lm_grads(lmm, lm, tokens, cfg["layers"])
        finally:
            lmm.flash_attention = flash
        nudge = torch.Generator(device=dev).manual_seed(SEED + 3)
        with torch.no_grad():
            for p in lm.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=nudge,
                                              device=dev))
        nudged_loss, nudged = _mp_lm_grads(lmm, lm, tokens, cfg["layers"])
    del lm, tokens
    torch.cuda.empty_cache()

    def rel(a, b):
        return float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                1e-30)

    floors = {"ulysses": ({n: rel(nudged[n], one[n]) for n in one},
                          abs(nudged_loss - one_loss) / abs(one_loss))}
    floors["ring"] = ({n: max(floors["ulysses"][0][n], rel(plain[n], one[n]))
                       for n in one},
                      max(floors["ulysses"][1],
                          abs(dense_loss - one_loss) / abs(one_loss)))
    launches = None
    for impl in ("ring", "ulysses"):
        floor, loss_floor = floors[impl]
        rk = [r["lm_" + impl] for r in ranks]
        losses = rk[0]["losses"]
        if not all(_losses_ok(r["losses"]) for r in rk):
            raise AssertionError("%s: a non-finite loss: %s"
                                 % (impl, [r["losses"] for r in rk]))
        if len({r["sha1"] for r in rk}) != 1 or \
                len({json.dumps(r["losses"]) for r in rk}) != 1:
            raise AssertionError("%s: the replicas differ: %s"
                                 % (impl, [r["sha1"] for r in rk]))
        per = cfg["layers"] * cfg["steps"] if impl == "ulysses" else 0
        for r in rk:
            want = {name: 0 for name in r["launches"]}
            want.update({name: per for name in FLASH})
            if r["launches"] != want:
                raise AssertionError("%s: launches %s, want %s"
                                     % (impl, r["launches"], want))
        err = {n: rel(grads[impl][n], one[n]) for n in one}
        bad = [n for n in one if err[n] > 4 * floor[n] + MP_LM_ADD]
        worst = max(err, key=lambda n: err[n] / (4 * floor[n] + MP_LM_ADD))
        lrel = abs(rk[0]["loss1"] - one_loss) / abs(one_loss)
        print("[3n] (i) --impl %s: losses %s  replicas bit-equal (sha1 %s)  "
              "K4/K5/K6 %d/%d/%d a rank a step  collectives a step %s"
              % (impl, ["%.6f" % v for v in losses], rk[0]["sha1"][:12],
                 *(rk[0]["launches"][n] // cfg["steps"] for n in FLASH),
                 _per_step(rk[0]["collectives"], cfg["steps"])), flush=True)
        print("  step 1 against one process (%s): loss rel diff %.3e (floor "
              "%.3e); weight gradients rel diff max %.3e, nearest its limit "
              "%s %.3e against floor %.3e (limit 4x floor + %.0e)"
              % ("flash; floor: weights nudged 1e-6" if impl == "ulysses"
                 else "flash; floor: also flash against dense attention",
                 lrel, loss_floor, max(err.values()), worst, err[worst],
                 floor[worst], MP_LM_ADD), flush=True)
        if bad or lrel > 4 * loss_floor + MP_LM_ADD:
            raise AssertionError(
                "%s: step 1 off the one-process LM: loss %.3e, tensors %s"
                % (impl, lrel, {n: (err[n], floor[n]) for n in bad}))
        print("[3n] sp_step_ms_%s %.1f (median of steps 2-%d, %d ranks on "
              "one card over gloo: a correctness figure)  on %s"
              % (impl, _median(rk[0]["step_ms"][1:]), cfg["steps"],
                 len(ranks), card), flush=True)
        if impl == "ulysses":
            launches = rk[0]["launches"]
    return launches


def check_mp_pp(dev, ranks, grads, cfg, card):
    """(ii): the unit-lr gradients of the pp=2 step within ``MP_PP_TOL``
    of max |g| of one process's step, remat within 1e-6 of no remat, the
    replicas bit-equal, no kernel launched."""
    import numpy as np

    with _tf32_off():
        net = _mp_pp_net(dev, cfg)
        step = _mp_step(net, dev, 1.0, momentum=0.0)
        x, y = _mp_batch(dev, cfg["batch"], cfg["width"], cfg["classes"],
                         SEED + 21)
        before = [p.detach().clone() for p in step._gp]
        loss = float(step(x, y))
        one = [(b - p.detach()).cpu().numpy()
               for b, p in zip(before, step._gp)]
    rk = [r["pp"] for r in ranks]
    for key in ("plain", "remat"):
        if len({r[key]["sha1"] for r in rk}) != 1:
            raise AssertionError("pp %s: the replicas differ" % key)
    err = max(float(np.abs(a - b).max()) / float(np.abs(b).max())
              for a, b in zip(grads[0], one))
    remat = max(float(np.abs(a - b).max()) / float(np.abs(b).max())
                for a, b in zip(grads[1], grads[0]))
    exact = all(a.tobytes() == b.tobytes() for a, b in zip(grads[1],
                                                           grads[0]))
    lrel = abs(rk[0]["plain"]["loss"] - loss) / abs(loss)
    print("[3n] (ii) pp=2: loss %.6f (one process %.6f, rel diff %.3e); "
          "unit-lr gradients max diff %.3e of max |g| (limit %.0e); remat "
          "against no remat %.3e (%s; limit 1e-6); replicas bit-equal; "
          "collectives a step %s" % (
              rk[0]["plain"]["loss"], loss, lrel, err, MP_PP_TOL, remat,
              "bit-equal" if exact else "not bit-equal",
              rk[0]["plain"]["collectives"]), flush=True)
    if err > MP_PP_TOL or remat > 1e-6 or lrel > MP_PP_TOL:
        raise AssertionError("the pp=2 step is off the one-process step")
    if any(rk[0]["launches"].values()):
        raise AssertionError("pp=2 launched %s; its path has no kernel"
                             % rk[0]["launches"])
    if not _losses_ok(rk[0]["losses"]):
        raise AssertionError("pp=2: a non-finite loss %s" % rk[0]["losses"])
    print("[3n] pp_step_ms %.1f (median of %d steps: batch %d, %d "
          "microbatches, 2 stages of %d Dense(%d, tanh))  on %s"
          % (_median(rk[0]["step_ms"]), len(rk[0]["step_ms"]),
             cfg["batch"], cfg["num_micro"], cfg["layers"] // 2,
             cfg["width"], card), flush=True)


def check_mp_moe(dev, ranks, params, cfg, card):
    """(iii): each rank holds half the experts; the ep=2 losses within
    ``MP_MOE_LOSS_TOL`` of the ep=1 step's, the parameters after within
    ``MP_MOE_PARAM_TOL`` of each tensor's largest update; the replicated
    parameters bit-equal across the ranks; no kernel launched."""
    import numpy as np

    with _tf32_off():
        net = _mp_moe_net(dev, cfg)
        step = _mp_step(net, dev, cfg["lr"])
        start = [p.detach().cpu().numpy() for p in step._gp]
        x, y = _mp_batch(dev, cfg["tokens"], cfg["width"], cfg["classes"],
                         SEED + 31)
        losses = [float(step(x, y)) for _ in range(cfg["steps"])]
        after = [p.detach().cpu().numpy() for p in step._gp]
    rk = [r["moe"] for r in ranks]
    if any(r["experts_held"] * len(ranks) != cfg["experts"] for r in rk):
        raise AssertionError("the ranks hold %s experts"
                             % [r["experts_held"] for r in rk])
    if len({r["replicated_sha1"] for r in rk}) != 1 or \
            len({json.dumps(r["losses"]) for r in rk}) != 1:
        raise AssertionError("ep=2: the replicas differ")
    lrel = max(abs(a - b) / abs(b) for a, b in zip(rk[0]["losses"], losses))
    perr = max(float(np.abs(p - a).max())
               / max(float(np.abs(a - s).max()), 1e-12)
               for p, a, s in zip(params, after, start))
    print("[3n] (iii) ep=2: losses %s (ep=1 %s, max rel diff %.3e, limit "
          "%.0e); parameters after %d steps max diff %.3e of each tensor's "
          "largest update (limit %.0e); %d of %d experts a rank; replicas "
          "bit-equal; collectives a step %s"
          % (["%.6f" % v for v in rk[0]["losses"]],
             ["%.6f" % v for v in losses], lrel, MP_MOE_LOSS_TOL,
             cfg["steps"], perr, MP_MOE_PARAM_TOL, rk[0]["experts_held"],
             cfg["experts"], _per_step(rk[0]["collectives"], cfg["steps"])),
          flush=True)
    if not _losses_ok(rk[0]["losses"]) or lrel > MP_MOE_LOSS_TOL or \
            perr > MP_MOE_PARAM_TOL:
        raise AssertionError("the ep=2 step is off the ep=1 step")
    if any(rk[0]["launches"].values()):
        raise AssertionError("ep=2 launched %s; its path has no kernel"
                             % rk[0]["launches"])
    print("[3n] moe_step_ms %.1f (median of steps 2-%d: %d tokens, width %d, "
          "%d experts of hidden %d, top-%d)  on %s"
          % (_median(rk[0]["step_ms"][1:]), cfg["steps"], cfg["tokens"],
             cfg["width"], cfg["experts"], cfg["hidden"], cfg["top_k"],
             card), flush=True)


def run_mp_job(dev, card, cfg=None):
    """Phase 3n: one job of ``DP_RANKS`` ranks of this script
    (``--mp-rank``) through ``tools/launch_torch.py``, then the checks against
    one process on the card.  Returns rank 0's launches under Ulysses."""
    import numpy as np
    import torch

    cfg = MP if cfg is None else cfg
    outdir = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        with open(os.path.join(outdir, "config.json"), "w") as f:
            json.dump(cfg, f)
        t0 = time.perf_counter()
        _launch_ranks([sys.executable, os.path.abspath(__file__),
                       "--mp-rank", outdir], timeout=MP_TIMEOUT)
        print("  the two-rank job took %.1f s" % (time.perf_counter() - t0),
              flush=True)
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(outdir, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        grads = {}
        for impl in ("ring", "ulysses"):
            with np.load(os.path.join(outdir, "lm_%s.npz" % impl)) as z:
                grads[impl] = {k: z[k] for k in z.files}

        def arrays(name):
            with np.load(os.path.join(outdir, name)) as z:
                return [z["arr_%d" % i] for i in range(len(z.files))]

        pp = [arrays("pp_remat%d.npz" % r) for r in (0, 1)]
        moe = arrays("moe.npz")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError("backends %s" % [r["backend"] for r in ranks])
    launches = check_mp_lm(dev, ranks, grads, cfg["lm"], card)
    check_mp_pp(dev, ranks, pp, cfg["pp"], card)
    check_mp_moe(dev, ranks, moe, cfg["moe"], card)
    torch.cuda.empty_cache()
    return launches


def time_rnn_op(dev):
    """Phase 4, beside the kernel rows: the fused ``RNN`` op at phase 3i's
    LSTM (T 35, batch 32, 650 in, 650 hidden, 2 layers, f32, TF32 off),
    forward plus backward (the gradients of input and flat parameters),
    through cuDNN (``torch._VF.lstm`` on views of the flat vector, which
    cuDNN copies into its own layout each call) beside the plain step
    loop, ``torch.nn.LSTM`` (cuDNN over its own packed weights, the same
    values) and the bound: the GEMM FLOPs (forward, and twice that
    backward) over the f32 CUDA cores' 67 TFLOP/s; CUDA events.  The
    cuDNN route is first held to the plain loop (1e-4 of each tensor's
    largest magnitude)."""
    import torch

    from incubator_mxnet_tpu_torch.ops import rnn as rnn_ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t, n, c, h, layers = (WORDLM["bptt"], WORDLM["batch"], WORDLM["emsize"],
                          WORDLM["nhid"], WORDLM["nlayers"])
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    size = rnn_ops.rnn_param_size(layers, c, h, "lstm")
    x = torch.randn(t, n, c, generator=g, device=dev).requires_grad_()
    w = ((torch.rand(size, generator=g, device=dev) - 0.5) * 0.1) \
        .requires_grad_()
    h0 = torch.zeros(layers, n, h, device=dev)
    gout = torch.randn(t, n, h, generator=g, device=dev)

    def fwd_bwd(fn):
        out = fn(x, w, h0, h0, h, layers, "lstm")
        return (out,) + torch.autograd.grad(out, (x, w), gout)

    for name, got, want in zip(("out", "dx", "dparams"),
                               fwd_bwd(rnn_ops.rnn),
                               fwd_bwd(rnn_ops.rnn_plain)):
        _check("RNN op %s (cuDNN vs plain loop)" % name, got, want, 1e-4)
    lib = torch.nn.LSTM(c, h, layers).to(dev)
    with torch.no_grad():
        flat = [p for layer in rnn_ops.unpack_params(w, layers, c, h, "lstm",
                                                     1) for p in layer]
        for p, v in zip(lib._flat_weights, flat):
            p.copy_(v)

    def library():
        out = lib(x, (h0, h0))[0]
        torch.autograd.grad(out, [x] + list(lib.parameters()), gout)

    ms = _time_ms(lambda: fwd_bwd(rnn_ops.rnn), 20)
    plain_ms = _time_ms(lambda: fwd_bwd(rnn_ops.rnn_plain), 3)
    library_ms = _time_ms(library, 20)
    flops = sum(2 * t * n * 4 * h * ((c if i == 0 else h) + h)
                for i in range(layers)) * 3
    row = dict(shape="LSTM T %d N %d C %d H %d x%d f32" % (t, n, c, h, layers),
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=flops / PEAK_F32 * 1e3, bound_by="operations",
               gflop=flops / 1e9)
    print("  RNN op %-30s ms %.4f  plain %.4f  nn.LSTM %.4f (op/library "
          "%.3f)  bound %.4f (%.2f GFLOP, %.2fx)" % (
              row["shape"], ms, plain_ms, library_ms, ms / library_ms,
              row["bound_ms"], row["gflop"], ms / row["bound_ms"]),
          flush=True)
    torch.backends.cudnn.allow_tf32 = True
    return row


def time_lenet_pools(dev):
    """Phase 4: K3 at LeNet's two pool shapes (f32, batch 64) beside its
    plain version, ``F.max_pool2d(return_indices=True)`` and its byte
    bound, by the profiler's device time with the L2 flushed."""
    import torch
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.parallel import maxpool_idx

    tool = _bench_tool()
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows = []
    for label, shape in LENET_POOLS:
        x = torch.tanh(torch.randn(shape, generator=g, device=dev))
        out_numel = x.numel() // 4
        row = dict(
            shape="LeNet %s %s 2x2/2 f32" % (label, shape),
            ms=tool.flushed_device_ms(
                lambda: maxpool_idx.maxpool_with_index(x, *LENET_POOL), 20,
                dev, "maxpool_idx_kernel"),
            plain_ms=tool.flushed_device_ms(
                lambda: maxpool_idx._maxpool_plain(x, *LENET_POOL), 3, dev,
                None),
            library_ms=tool.flushed_device_ms(
                lambda: F.max_pool2d(x, 2, 2, return_indices=True), 20, dev,
                None),
            **_bound(x.numel() * 4 + out_numel * (4 + 1), out_numel * 4))
        print("  K3 %-38s ms %.4f  bound %.4f (%s, %.2fx)  plain %.4f  "
              "F.max_pool2d %.4f (K3/library %.3f)" % (
                  row["shape"], row["ms"], row["bound_ms"], row["bound_by"],
                  row["ms"] / row["bound_ms"], row["plain_ms"],
                  row["library_ms"], row["ms"] / row["library_ms"]),
              flush=True)
        rows.append(row)
        del x
    return rows


def time_kernels(dev, layers, before=None, before_pool=None):
    """Phase 4: per-kernel times summed over one step's launches; K1, K2
    and K3 (and their plain versions and ``F.max_pool2d``) by the
    profiler's device time with the L2 flushed.  ``before``: the (fwd,
    bwd) of an earlier tree's K1 and K2
    (``tools/bn_kernel_bench_torch.py::before_ghost_bn``), summed on the
    same clock into ``before_ms`` (both of its passes); ``before_pool``:
    that tree's K3 (``before_maxpool``), timed at the stem beside this
    tree's in the order before, now, now, before."""
    import torch
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.parallel import fused_bn, maxpool_idx

    tool = _bench_tool()

    def flushed(fn, name=None, reps=10):
        return tool.flushed_device_ms(fn, reps, dev, name)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    distinct = {}
    for cfg in layers:
        distinct[cfg] = distinct.get(cfg, 0) + 1
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0,
               "before": [0.0, 0.0]}
           for k in ("ghost_bn_fwd", "ghost_bn_bwd")}
    for (shape, dtype, act, res, donate, dual, group, eps), k in \
            distinct.items():
        n, c, h, w = shape
        isz = torch.finfo(dtype).bits // 8
        ng = fused_bn.ghost_group(n, c, h, w, isz, group, res, donate and res,
                                  dual)
        x = torch.randn(*shape, generator=g, device=dev).to(dtype)
        r = torch.randn(*shape, generator=g, device=dev).to(dtype) \
            if res else None
        gamma = torch.ones(c, device=dev)
        beta = torch.zeros(c, device=dev)
        y, m, v = fused_bn.ghost_bn_fwd(x, gamma, beta, r, eps, act, ng)
        gy = torch.randn(*shape, generator=g, device=dev).to(dtype)
        gy2 = torch.randn(*shape, generator=g, device=dev).to(dtype) \
            if dual else None
        ys = y if res else None
        numel = x.numel()
        small = (2 * c + 2 * (n // ng) * c) * 4

        def new_fwd():
            return fused_bn.ghost_bn_fwd(x, gamma, beta, r, eps, act, ng)

        def new_bwd():
            return fused_bn.ghost_bn_bwd(gy, gy2, x, ys, gamma, beta, m, v,
                                         eps, act, ng)

        f = tot["ghost_bn_fwd"]
        fwd_ms = flushed(new_fwd, "ghost_bn_fwd")
        f["ms"] += k * fwd_ms
        f["plain_ms"] += k * flushed(lambda: fused_bn._gbn_fwd_plain(
            x, gamma, beta, r, eps, act, ng), None, 3)
        f["bytes"] += k * (numel * isz * (2 + res) + small)
        f["ops"] += k * numel * OPS_FWD
        b = tot["ghost_bn_bwd"]
        bwd_ms = flushed(new_bwd, "ghost_bn_bwd")
        b["ms"] += k * bwd_ms
        b["plain_ms"] += k * flushed(lambda: fused_bn._gbn_bwd_plain(
            gy, gy2, x, ys, gamma, beta, m, v, eps, act, ng), None, 3)
        b["bytes"] += k * (numel * isz * (3 + dual + 2 * res) + small)
        b["ops"] += k * numel * OPS_BWD
        old = ""
        if before is not None:
            old_fwd, old_bwd = before
            t = [flushed(lambda: old_fwd(x, gamma, beta, r, eps, act, ng),
                         "ghost_bn_fwd"), fwd_ms,
                 flushed(new_fwd, "ghost_bn_fwd"),
                 flushed(lambda: old_fwd(x, gamma, beta, r, eps, act, ng),
                         "ghost_bn_fwd")]
            u = [flushed(lambda: old_bwd(gy, gy2, x, ys, gamma, beta, m, v,
                                         eps, act, ng), "ghost_bn_bwd"),
                 bwd_ms, flushed(new_bwd, "ghost_bn_bwd"),
                 flushed(lambda: old_bwd(gy, gy2, x, ys, gamma, beta, m, v,
                                         eps, act, ng), "ghost_bn_bwd")]
            f["before"] = [a + k * bb for a, bb in zip(f["before"],
                                                       (t[0], t[3]))]
            b["before"] = [a + k * bb for a, bb in zip(b["before"],
                                                       (u[0], u[3]))]
            old = "  before K1 %.4f/%.4f K2 %.4f/%.4f" % (t[0], t[3], u[0],
                                                          u[3])
        print("  %-22s %-8s act=%-4s res=%d donate=%d dual=%d group=%d x%d  "
              "K1 %.4f K2 %.4f%s" % (shape, str(dtype).split(".")[1], act,
                                     res, donate, dual, ng, k, fwd_ms,
                                     bwd_ms, old), flush=True)
        del x, r, y, gy, gy2, ys, m, v
    torch.cuda.empty_cache()
    rows = {}
    for name, t in tot.items():
        byte_ms = t["bytes"] / PEAK_BYTES * 1e3
        op_ms = t["ops"] / PEAK_F32 * 1e3
        rows[name] = {"ms": t["ms"], "plain_ms": t["plain_ms"],
                      "bound_ms": max(byte_ms, op_ms),
                      "bound_by": "bytes" if byte_ms >= op_ms
                      else "operations", "library_ms": None}
        if before is not None:
            rows[name]["before_ms"] = t["before"]
        print("  %s over one step (flushed): %.4f ms, %.2fx its %.4f ms "
              "bound%s" % (name, t["ms"], t["ms"] / rows[name]["bound_ms"],
                           rows[name]["bound_ms"],
                           "" if before is None else
                           "; the earlier tree's %.4f/%.4f ms"
                           % tuple(t["before"])), flush=True)
    # K3 at the stem: (256, 64, 112, 112) bf16 -> (256, 64, 56, 56), on
    # the same flushed clock, beside the earlier tree's K3 (before_pool)
    x = torch.clamp_min(torch.randn(BATCH, 64, IMAGE // 2, IMAGE // 2,
                                    generator=g, device=dev), 0)
    x = x.to(torch.bfloat16)
    out_numel = BATCH * 64 * (IMAGE // 4) ** 2

    def new_pool():
        return maxpool_idx.maxpool_with_index(x, *POOL_STEM)

    k3 = "maxpool_idx_kernel"
    rows["maxpool_idx_fwd"] = dict(
        ms=flushed(new_pool, k3, 20),
        plain_ms=flushed(lambda: maxpool_idx._maxpool_plain(x, *POOL_STEM),
                         None, 3),
        library_ms=flushed(lambda: F.max_pool2d(x, 3, 2, 1,
                                                return_indices=True), None,
                           20),
        **_bound(x.numel() * 2 + out_numel * (2 + 1), out_numel * 9))
    r = rows["maxpool_idx_fwd"]
    r["ms_over_library"] = r["ms"] / r["library_ms"]
    old = ""
    if before_pool is not None:
        t = [flushed(lambda: before_pool(x, *POOL_STEM), k3, 20), r["ms"],
             flushed(new_pool, k3, 20),
             flushed(lambda: before_pool(x, *POOL_STEM), k3, 20)]
        r["before_ms"] = [t[0], t[3]]
        old = "; the earlier tree's K3 %.4f/%.4f ms (before, now, now, " \
              "before: %s)" % (t[0], t[3], ["%.4f" % v for v in t])
    print("  K3 at the stem (flushed): %.4f ms, %.2fx its %.4f ms bound, "
          "F.max_pool2d(return_indices=True) %.4f (K3/library %.3f)%s"
          % (r["ms"], r["ms"] / r["bound_ms"], r["bound_ms"], r["library_ms"],
             r["ms_over_library"], old), flush=True)
    del x
    torch.cuda.empty_cache()
    return rows


#: K3's zoo shapes timed in phase 4: (models of ZOO_POOLS, (C, H, W))
ZOO_TIMED = [("vgg", (64, 224, 224)), ("alexnet", (64, 55, 55)),
             ("squeezenet1_1", (64, 111, 111)),
             ("inception_v3", (64, 147, 147))]


def time_zoo_pools(dev):
    """Phase 4: K3 at the zoo shapes of ``ZOO_TIMED`` (batch
    ``ZOO_POOL_BATCH``, bf16, the trainer's dtype) beside its plain
    version, ``F.max_pool2d(return_indices=True)`` and its byte bound,
    all by the profiler's device time with the L2 flushed."""
    import torch
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.parallel import maxpool_idx

    tool = _bench_tool()
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = []
    for models, chw in ZOO_TIMED:
        (_, _, k, st, p, ceil), = [e for e in ZOO_POOLS
                                   if e[0] == models and e[1] == chw]
        cfg = zoo_pool_cfg(k, st, p, ceil)
        x = torch.clamp_min(torch.randn((ZOO_POOL_BATCH,) + chw, generator=g,
                                        device=dev), 0).to(torch.bfloat16)
        oh, ow = maxpool_idx.check_shape(x.shape, *cfg)
        out_numel = ZOO_POOL_BATCH * chw[0] * oh * ow
        row = dict(
            shape="%s %s %dx%d/%d%s" % (models, (ZOO_POOL_BATCH,) + chw, k,
                                        k, st, " ceil" if ceil else ""),
            ms=tool.flushed_device_ms(
                lambda: maxpool_idx.maxpool_with_index(x, *cfg), 20, dev,
                "maxpool_idx_kernel"),
            plain_ms=tool.flushed_device_ms(
                lambda: maxpool_idx._maxpool_plain(x, *cfg), 3, dev, None),
            library_ms=tool.flushed_device_ms(
                lambda: F.max_pool2d(x, k, st, p, ceil_mode=ceil,
                                     return_indices=True), 20, dev, None),
            **_bound(x.numel() * 2 + out_numel * (2 + 1), out_numel * k * k))
        print("  K3 %-44s ms %.4f  bound %.4f (%s, %.2fx)  plain %.4f  "
              "F.max_pool2d %.4f (K3/library %.3f)" % (
                  row["shape"], row["ms"], row["bound_ms"], row["bound_by"],
                  row["ms"] / row["bound_ms"], row["plain_ms"],
                  row["library_ms"], row["ms"] / row["library_ms"]),
              flush=True)
        out.append(row)
        del x
    torch.cuda.empty_cache()
    return out


def _causal_pairs(sq, sk):
    """Visible (i, j) pairs of one head under the right-aligned mask."""
    return sum(min(max(i + sk - sq + 1, 0), sk) for i in range(sq))


def _bound(nbytes, ops, peak=PEAK_F32):
    """The least time for ``nbytes`` of traffic and ``ops`` operations at
    ``peak`` operations a second."""
    byte_ms = nbytes / PEAK_BYTES * 1e3
    op_ms = ops / peak * 1e3
    return {"bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def _tensor_core_row(row, nbytes, ops):
    """Add to a 3xTF32 kernel's row its bound on the tensor cores (three
    TF32 passes of every product) and its time over the library call's."""
    row["tc_bound_ms"] = _bound(nbytes, 3 * ops, PEAK_TF32)["bound_ms"]
    row["ms_over_library"] = row["ms"] / row["library_ms"]


def time_flash(dev):
    """Phase 4, K4-K6 at one LM layer's attention: (4, 8, 2048, 128),
    causal, f32.  Bounds count the products only (2 FLOP per multiply-add
    over the visible pairs: S and PV for K4; S, dP, dQ for K5; S, dP, dV,
    dK for K6) and each input read, each output written once."""
    import torch
    import torch.nn.functional as F

    fa = _flash_module()
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, h, s = LM_BATCH, LM["heads"], LM_SEQ
    d = LM["dim"] // h
    q, k, v, do = (torch.randn(b * h, s, d, generator=g, device=dev)
                   for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = (do * out).sum(-1)
    pairs = b * h * _causal_pairs(s, s)
    mat = b * h * s * d * 4                    # one (BH, S, D) f32 tensor
    row = b * h * s * 4                        # one (BH, S) f32 vector
    rows = {
        "flash_attn_fwd": dict(
            ms=_time_ms(lambda: fa.flash_fwd(q, k, v, scale, True), 10),
            plain_ms=_time_ms(lambda: fa._flash_fwd_plain(q, k, v, scale,
                                                          True), 3),
            **_bound(4 * mat + row, 4 * d * pairs)),
        "flash_attn_bwd_dq": dict(
            ms=_time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                scale, True), 10),
            plain_ms=_time_ms(lambda: fa._flash_bwd_dq_plain(
                q, k, v, do, lse, delta, scale, True), 3),
            **_bound(5 * mat + 2 * row, 6 * d * pairs)),
        "flash_attn_bwd_dkv": dict(
            ms=_time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                 scale, True), 10),
            plain_ms=_time_ms(lambda: fa._flash_bwd_dkv_plain(
                q, k, v, do, lse, delta, scale, True), 3),
            **_bound(6 * mat + 2 * row, 8 * d * pairs)),
    }
    q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
    rows["flash_attn_fwd"]["library_ms"] = _time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        10)
    _tensor_core_row(rows["flash_attn_fwd"], 4 * mat + row, 4 * d * pairs)
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, do4, retain_graph=True), 10)
    # one call computes dQ, dK and dV: the same time stands in both rows,
    # and beside K5 + K6 together
    rows["flash_attn_bwd_dq"]["library_ms"] = lib_bwd
    rows["flash_attn_bwd_dkv"]["library_ms"] = lib_bwd
    _tensor_core_row(rows["flash_attn_bwd_dq"], 5 * mat + 2 * row,
                     6 * d * pairs)
    _tensor_core_row(rows["flash_attn_bwd_dkv"], 6 * mat + 2 * row,
                     8 * d * pairs)
    pair_ms = (rows["flash_attn_bwd_dq"]["ms"]
               + rows["flash_attn_bwd_dkv"]["ms"])
    print("  K5 + K6 at (4, 8, 2048, 128) causal f32: ms %.4f  SDPA backward "
          "%.4f  (K5 + K6)/SDPA backward %.3f  tc_bound_ms %.4f" % (
              pair_ms, lib_bwd, pair_ms / lib_bwd,
              rows["flash_attn_bwd_dq"]["tc_bound_ms"]
              + rows["flash_attn_bwd_dkv"]["tc_bound_ms"]), flush=True)
    err = _max_err(out.view(b, h, s, d), lib_out.detach())
    print("  SDPA forward against K4: max abs diff %.3e" % err, flush=True)
    del q, k, v, do, out, lse, delta, q4, k4, v4, do4, leaves, lib_out
    torch.cuda.empty_cache()

    # the long row: one sequence of 8192, forward only
    sl = 8192
    ql, kl, vl = (torch.randn(h, sl, d, generator=g, device=dev)
                  for _ in range(3))
    long_ms = _time_ms(lambda: fa.flash_fwd(ql, kl, vl, scale, True), 5)
    q4, k4, v4 = (t.view(1, h, sl, d) for t in (ql, kl, vl))
    long_lib = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 5)
    long_row = dict(ms=long_ms, library_ms=long_lib,
                    **_bound(4 * h * sl * d * 4 + h * sl * 4,
                             4 * d * h * _causal_pairs(sl, sl)))
    _tensor_core_row(long_row, 4 * h * sl * d * 4 + h * sl * 4,
                     4 * d * h * _causal_pairs(sl, sl))
    print("  K4 at (1, 8, 8192, 128) causal f32: ms %.4f  library_ms %.4f  "
          "ms/library %.3f  bound_ms %.4f (%s)  tc_bound_ms %.4f"
          % (long_ms, long_lib, long_row["ms_over_library"],
             long_row["bound_ms"], long_row["bound_by"],
             long_row["tc_bound_ms"]), flush=True)
    del ql, kl, vl, q4, k4, v4
    torch.cuda.empty_cache()
    time_flash_wide(dev, g, LM_HEADS_D256, "the D <= 256 form")
    time_flash_wide(dev, g, LM_HEADS_D512, "the D-streamed form")
    return rows


def _kernel_names(fn):
    """The names of the kernels one call of ``fn`` runs on the card, from
    torch.profiler's CUDA trace (which backend a library call chose)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({ev.name for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA})


def time_flash_wide(dev, g, heads, form):
    """Phase 4, a wider form of K4-K6 at the LM's (4, ``heads``, 2048,
    1024 / heads) causal f32: each kernel beside its 3xTF32 bound, and
    SDPA's forward and backward (the kernels SDPA ran named).  Returns
    the three rows (ms, bound_ms, tc_bound_ms, library_ms,
    ms_over_library)."""
    import torch
    import torch.nn.functional as F

    fa = _flash_module()
    b, h, s = LM_BATCH, heads, LM_SEQ
    d = LM["dim"] // h
    q, k, v, do = (torch.randn(b * h, s, d, generator=g, device=dev)
                   for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = (do * out).sum(-1)
    pairs = b * h * _causal_pairs(s, s)
    mat, row = b * h * s * d * 4, b * h * s * 4
    ms = {"K4": _time_ms(lambda: fa.flash_fwd(q, k, v, scale, True), 10),
          "K5": _time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                 scale, True), 10),
          "K6": _time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  scale, True), 10)}
    work = {"K4": (4 * mat + row, 4 * d * pairs),
            "K5": (5 * mat + 2 * row, 6 * d * pairs),
            "K6": (6 * mat + 2 * row, 8 * d * pairs)}
    q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
    lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 10)
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, do4, retain_graph=True), 10)
    rows = {}
    for name in ("K4", "K5", "K6"):
        lib = lib_fwd if name == "K4" else lib_bwd
        rows[name] = dict(ms=ms[name], library_ms=lib, **_bound(*work[name]))
        _tensor_core_row(rows[name], *work[name])
        print("  %s at (%d, %d, %d, %d) causal f32 (%s): ms %.4f  bound_ms "
              "%.4f (%s)  tc_bound_ms %.4f (%.2fx)  ms_over_library %.3f" % (
                  name, b, h, s, d, form, ms[name], rows[name]["bound_ms"],
                  rows[name]["bound_by"], rows[name]["tc_bound_ms"],
                  ms[name] / rows[name]["tc_bound_ms"],
                  rows[name]["ms_over_library"]), flush=True)
    names = _kernel_names(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    print("  SDPA at (%d, %d, %d, %d) causal f32: forward %.4f ms (K4/SDPA "
          "%.3f), backward %.4f ms ((K5 + K6)/SDPA backward %.3f); its "
          "forward ran %s" % (
              b, h, s, d, lib_fwd, ms["K4"] / lib_fwd, lib_bwd,
              (ms["K5"] + ms["K6"]) / lib_bwd, names), flush=True)
    del q, k, v, do, out, lse, delta, q4, k4, v4, do4, leaves, lib_out
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 2c, 3c, 4c: K7, the rtc kernels R1/R2 and the imperative nd path
# ---------------------------------------------------------------------------


#: traces :func:`_device_ms` took again, by what it timed; printed
#: before the kernels line, so a machine that keeps losing them shows
PROFILER_RETAKES = {}


def _device_ms(fn, reps, name=None, tries=3):
    """Mean device time in ms a call of ``fn`` (over ``reps`` calls) of the
    kernel ``name``, or of every kernel it launches, from torch.profiler's
    CUDA trace (as ``tools/torch_profile_step.py`` reads it): the kernels'
    own time, also where the host launches them more slowly than the card
    runs them.  A trace that lost launches is taken again, up to ``tries``
    traces in all, each retake printed and counted in
    ``PROFILER_RETAKES``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        if attempt:
            label = name or "kernels"
            PROFILER_RETAKES[label] = PROFILER_RETAKES.get(label, 0) + 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and name in (None, ev.name)]
        if len(times) == reps or (name is None and len(times) > reps):
            return sum(times) / reps
        print("  the profiler saw %d launches of %s, want %d: traced again"
              % (len(times), name or "kernels", reps), flush=True)
    raise AssertionError("the profiler saw %d launches of %s, want %d"
                         % (len(times), name or "kernels", reps))


def _bench_tool():
    """``tools/bn_kernel_bench_torch.py``, loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "bn_kernel_bench_torch.py")
    spec = importlib.util.spec_from_file_location("bn_kernel_bench_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel_err(got, want):
    """Max abs error over the reference's largest magnitude."""
    return _max_err(got, want) / max(want.float().abs().max().item(), 1e-30)


def check_copy_and_rtc(dev, errs):
    """Phase 2c: K7 bit-exact against ``clone()`` at the 9 BN shapes; R1
    exact and R2 within ND_TOL (relative) of their plain versions; the
    rtc refusals.  Returns ``{name: CudaKernel}`` of R1 and R2."""
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch.parallel import fused_bn

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    errs["bn_copy"] = []
    for shape in _bench_tool().SHAPES:
        ng = fused_bn.ghost_group(*shape, 2, 16)
        x = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
        y = fused_bn.bn_copy(x, ng)
        same = torch.equal(y.view(torch.int16), x.clone().view(torch.int16))
        print("  K7 %-22s group %-2d bit-exact against clone(): %s"
              % (shape, ng, same), flush=True)
        if not same:
            raise AssertionError("K7 differs from clone() at %s" % (shape,))
        errs["bn_copy"].append(_max_err(y, x))
        del x, y
    # runs that are not whole 16-byte vectors (scalar head and tail), and
    # an x off the 16-byte grid of y (every element scalar)
    for shape, ng, offset in (((48, 3, 1, 5), 16, 0), ((256, 64, 7, 7), 16, 0),
                              ((48, 3, 1, 5), 16, 1), ((64, 64, 7, 7), 16, 3)):
        for dtype in (torch.bfloat16, torch.float32):
            numel = shape[0] * shape[1] * shape[2] * shape[3]
            x = torch.randn(numel + offset, generator=g, device=dev) \
                .to(dtype)[offset:].view(shape)
            y = fused_bn.bn_copy(x, ng)
            same = torch.equal(y.view(-1), x.clone().view(-1))
            print("  K7 %-22s %-8s x offset %d: bit-exact: %s"
                  % (shape, str(dtype).split(".")[1], offset, same),
                  flush=True)
            if not same:
                raise AssertionError("K7 differs from clone() at %s %s"
                                     % (shape, dtype))
    torch.cuda.empty_cache()

    kernels = {}
    for name in RTC:
        mod = rtc.CudaModule(rtc.user_source(name), exports=[name])
        kernels[name] = mod.get_kernel(name, rtc.USER_KERNELS[name])
        print("  %-12s NVRTC compile %.1f ms (%s)" % (name, mod.compile_ms,
                                                      rtc.USER_KERNELS[name]),
              flush=True)
    ctx = mx.gpu(dev.index or 0)
    d = LM["dim"] // LM["heads"]
    x = mx.nd.NDArray(torch.randn(LM_BATCH, LM["heads"], LM_SEQ, d,
                                  generator=g, device=dev))
    y = rtc.launch_scale(kernels["scale_kernel"], x, ctx)
    want = rtc.scale_plain(x._data)
    err = _max_err(y._data, want)
    print("  R1 scale_kernel (%d, %d, %d, %d) f32: max_abs_err %.3e (exact "
          "required)" % (LM_BATCH, LM["heads"], LM_SEQ, d, err), flush=True)
    if not torch.equal(y._data, want):
        raise AssertionError("R1 is not exact")
    errs["scale_kernel"] = [err]
    # ragged n; x and y views 1-3 floats off the 16-byte grid, together
    # (a scalar head, then float4) and x alone (every element scalar)
    r1 = kernels["scale_kernel"]
    for n in (1, 3, 5, 1000003):
        xs = mx.nd.NDArray(torch.randn(n, generator=g, device=dev))
        ok = torch.equal(rtc.launch_scale(r1, xs, ctx)._data,
                         rtc.scale_plain(xs._data))
        for off in (1, 2, 3):
            xb = torch.randn(n + 4, generator=g, device=dev)
            yb = torch.empty(n + 4, device=dev)
            xv = mx.nd.NDArray(xb[off:off + n])
            r1.launch([xv, mx.nd.NDArray(yb[off:off + n]), n], ctx,
                      rtc.scale_grid(n, ctx), (rtc.SCALE_THREADS, 1, 1))
            ok = ok and torch.equal(yb[off:off + n], rtc.scale_plain(xv._data))
            ok = ok and torch.equal(rtc.launch_scale(r1, xv, ctx)._data,
                                    rtc.scale_plain(xv._data))
        print("  R1 n %-8d offsets 0-3 (x and y, x alone) exact: %s"
              % (n, ok), flush=True)
        if not ok:
            raise AssertionError("R1 is not exact at n %d" % n)
    errs["mm_kernel"] = []
    for m, k, n in ((LM_BATCH * LM_SEQ, LM["dim"], LM["dim"]),
                    (1000, 300, 129)):
        a = mx.nd.NDArray(torch.randn(m, k, generator=g, device=dev))
        b = mx.nd.NDArray(torch.randn(k, n, generator=g, device=dev))
        c = rtc.launch_mm(kernels["mm_kernel"], a, b, ctx)
        want = rtc.mm_plain(a._data, b._data)
        rel = _rel_err(c._data, want)
        print("  R2 mm_kernel (%d, %d) @ (%d, %d) f32: max_abs_err %.3e, "
              "%.3e of max |a @ b| (limit %.0e)"
              % (m, k, k, n, _max_err(c._data, want), rel, ND_TOL),
              flush=True)
        if not rel <= ND_TOL:
            raise AssertionError("R2 disagrees with a @ b")
        errs["mm_kernel"].append(_max_err(c._data, want))
    # the refusals: a missing export or kernel, a wrong dtype
    for build in (lambda: rtc.CudaModule(rtc.user_source("scale_kernel"),
                                         exports=["nope"]),
                  lambda: rtc.CudaModule(
                      rtc.user_source("scale_kernel")).get_kernel(
                          "missing", "const float *x")):
        try:
            build()
        except ValueError as e:
            print("  refused as it should: ValueError(%s)" % e, flush=True)
        else:
            raise AssertionError("a missing export or kernel did not raise")
    try:
        kernels["scale_kernel"].launch([x.astype("float64"), y, x.size], ctx,
                                       (1, 1, 1), (256, 1, 1))
    except TypeError as e:
        print("  refused as it should: TypeError(%s)" % e, flush=True)
    else:
        raise AssertionError("a float64 launch of scale_kernel did not raise")
    del x, y, a, b, c, want
    torch.cuda.empty_cache()
    return kernels


def nd_attention_layer(mx, x, w, heads):
    """One causal attention layer of the LM, with ``nd`` and ``autograd``
    alone: ``(loss, y, a)`` after ``loss.backward()``, where ``a`` is the
    attention output before the output projection ``y = a @ wo``."""
    nd = mx.nd
    b, s, dim = x.shape
    dh = dim // heads

    def heads_first(t):
        return t.reshape((b, s, heads, dh)).transpose((0, 2, 1, 3))

    with mx.autograd.record():
        q, k, v = (heads_first(nd.dot(x, w[n])) for n in ("wq", "wk", "wv"))
        o = nd.contrib.flash_attention(q, k, v, causal=True)
        a = o.transpose((0, 2, 1, 3)).reshape((b, s, dim))
        y = nd.dot(a, w["wo"])
        loss = (y * y).mean()
    loss.backward()
    return loss, y, a


def run_nd_path(dev, kernels):
    """Phase 3c: the nd layer at the LM's width, STEPS times, then R1 on y
    and R2 on the output projection; returns (step_ms list, counts)."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels, rtc
    from incubator_mxnet_tpu_torch.parallel.ring_attention import \
        attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    nd = mx.nd
    ctx = mx.gpu(dev.index or 0)
    dim, heads = LM["dim"], LM["heads"]
    nd.random.seed(0)
    bound = dim ** -0.5
    w = {n: nd.random.uniform(-bound, bound, shape=(dim, dim), ctx=ctx)
         for n in ("wq", "wk", "wv", "wo")}
    for p in w.values():
        p.attach_grad()
    x = nd.array(np.random.RandomState(1).standard_normal(
        (LM_BATCH, LM_SEQ, dim)).astype(np.float32), ctx=ctx)
    step_ms = []
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    for k in kernels.values():
        k.launches = 0
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss, y, a = nd_attention_layer(mx, x, w, heads)
        nd.waitall()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    r1 = rtc.launch_scale(kernels["scale_kernel"], y, ctx)
    a2 = a.reshape((LM_BATCH * LM_SEQ, dim))
    r2 = rtc.launch_mm(kernels["mm_kernel"], a2, w["wo"], ctx)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    counts.update({n: k.launches for n, k in kernels.items()})
    want = {n: 0 for n in _kernels.launch_counts()}
    want.update({n: STEPS for n in FLASH})
    want.update({n: 1 for n in RTC})
    print("  launches %s (want %s)" % (counts, want), flush=True)
    if counts != want:
        raise AssertionError("launch counts %s, want %s" % (counts, want))

    # the same layer in plain torch autograd, dense attention
    wt = {n: p._data.detach().clone().requires_grad_() for n, p in w.items()}
    xt = x._data
    b, s = LM_BATCH, LM_SEQ

    def heads_first(t):
        return t.view(b, s, heads, dim // heads).transpose(1, 2)

    q, k_, v = (heads_first(xt @ wt[n]) for n in ("wq", "wk", "wv"))
    ref_a = attention_reference(q, k_, v, causal=True).transpose(1, 2) \
        .reshape(b, s, dim)
    ref_y = ref_a @ wt["wo"]
    ref_loss = (ref_y * ref_y).mean()
    ref_grads = torch.autograd.grad(ref_loss, list(wt.values()))
    lrel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    grel = {n: _rel_err(w[n].grad._data, gr)
            for n, gr in zip(wt, ref_grads)}
    print("  loss nd %.7f torch %.7f rel diff %.3e; gradients %s of each "
          "reference's largest magnitude (tolerance %.0e)"
          % (loss.item(), ref_loss.item(), lrel,
             {n: "%.3e" % e for n, e in grel.items()}, ND_TOL), flush=True)
    if not (lrel <= ND_TOL and max(grel.values()) <= ND_TOL):
        raise AssertionError("the nd layer disagrees with plain torch")
    with torch.no_grad():
        r1_ok = torch.equal(r1._data, rtc.scale_plain(y._data))
        r2_rel = _rel_err(r2._data, y._data.reshape(b * s, dim))
    print("  R1 on y exact: %s; R2 projection against y: %.3e (tolerance "
          "%.0e)" % (r1_ok, r2_rel, ND_TOL), flush=True)
    if not (r1_ok and r2_rel <= ND_TOL):
        raise AssertionError("R1 or R2 disagrees on the nd path")
    del w, x, loss, y, a, a2, r1, r2, wt, ref_a, ref_y, ref_loss, ref_grads
    torch.cuda.empty_cache()
    return step_ms, counts


def time_nd_kernels(dev, kernels):
    """Phase 4c: K7 at the 9 BN shapes beside ``copy_``, K1 and K2, and R1
    beside ``torch.add``, each by the profiler's device time with the L2
    flushed before every launch (``tools/bn_kernel_bench_torch.py``'s
    ``flushed_device_ms``); R2 beside its bound and ``torch.matmul``.
    Returns (rows, K7's launches)."""
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels, rtc
    from incubator_mxnet_tpu_torch.parallel import fused_bn

    torch.backends.cuda.matmul.allow_tf32 = False
    tool = _bench_tool()

    def flushed(fn, name=None, reps=10):
        return tool.flushed_device_ms(fn, reps, dev, name)

    rows = {}
    _kernels.reset_launch_counts()
    print("  L2 flushed (%d MB written) before every timed launch; device "
          "ms a launch" % (tool.FLUSH_BYTES >> 20), flush=True)
    print("  %-20s %3s %9s %9s %8s %9s %9s %9s %7s %7s" % (
        "shape (bf16)", "kc", "K7 ms", "copy_ ms", "K7/copy_", "bound ms",
        "K1 ms", "K2 ms", "K1/K7", "K2/K7"), flush=True)
    worst = 0.0
    for n, c, h, w_ in tool.SHAPES:
        leg = tool.Leg(n, c, h, w_, torch.bfloat16, False, False, dev)
        tool.bench_kernels(leg, dev, iters=10)
        row = leg.row
        nbytes = 2 * n * c * h * w_ * 2
        x = leg.x
        dst = torch.empty_like(x)
        copy_ms = flushed(lambda: dst.copy_(x))
        k7 = row["copy_ms"]
        worst = max(worst, k7 / copy_ms)
        print("  %-20s %3d %9.4f %9.4f %8.3f %9.4f %9.4f %9.4f %7.2f %7.2f"
              % (row["shape"], fused_bn.bn_copy_channels(x, leg.ng),
                 k7, copy_ms, k7 / copy_ms, nbytes / PEAK_BYTES * 1e3,
                 row["fwd_ms"], row["bwd_ms"], row["fwd_ms"] / k7,
                 row["bwd_ms"] / k7), flush=True)
        if "bn_copy" not in rows:        # the stem: K7's row in the table
            rows["bn_copy"] = dict(ms=k7, plain_ms=flushed(lambda: x.clone()),
                                   library_ms=copy_ms, **_bound(nbytes, 0))
            rows["bn_copy"]["ms_over_library"] = k7 / copy_ms
        del leg, x, dst
    print("  K7/copy_ at most %.3f over the 9 shapes" % worst, flush=True)
    k7_launches = _kernels.launch_counts()["bn_copy"]
    torch.cuda.empty_cache()

    ctx = mx.gpu(dev.index or 0)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    d = LM["dim"] // LM["heads"]
    x = mx.nd.NDArray(torch.randn(LM_BATCH, LM["heads"], LM_SEQ, d,
                                  generator=g, device=dev))
    r1 = kernels["scale_kernel"]
    # one PyTorch call computes 2x + 1: 1 + 2 * x, exact as R1 is
    one = torch.ones((), device=dev)
    if not torch.equal(torch.add(one, x._data, alpha=2),
                       rtc.scale_plain(x._data)):
        raise AssertionError("torch.add(1, x, alpha=2) is not 2x + 1")
    rows["scale_kernel"] = dict(
        ms=flushed(lambda: rtc.launch_scale(r1, x, ctx), "scale_kernel", 20),
        plain_ms=flushed(lambda: rtc.scale_plain(x._data), None, 20),
        library_ms=flushed(lambda: torch.add(one, x._data, alpha=2), None,
                           20),
        **_bound(2 * x.size * 4, 0))
    rows["scale_kernel"]["ms_over_library"] = (
        rows["scale_kernel"]["ms"] / rows["scale_kernel"]["library_ms"])
    print("  R1 at (%d, %d, %d, %d) f32, %d blocks: device %.4f ms a launch, "
          "torch.add(1, x, alpha=2) %.4f, R1/add %.3f (both L2 flushed); "
          "%.4f ms between R1 launches (CUDA events, unflushed: the host's "
          "launch path)" % (
              LM_BATCH, LM["heads"], LM_SEQ, d,
              rtc.scale_grid(x.size, ctx)[0], rows["scale_kernel"]["ms"],
              rows["scale_kernel"]["library_ms"],
              rows["scale_kernel"]["ms_over_library"],
              _time_ms(lambda: rtc.launch_scale(r1, x, ctx), 20)),
          flush=True)
    print("  profiler sessions taken again (trace lost or cut short): %d"
          % tool.retried, flush=True)
    m, k, n = LM_BATCH * LM_SEQ, LM["dim"], LM["dim"]
    a = mx.nd.NDArray(torch.randn(m, k, generator=g, device=dev))
    b = mx.nd.NDArray(torch.randn(k, n, generator=g, device=dev))
    r2 = kernels["mm_kernel"]
    # R2 and torch.matmul on one clock: the profiler's device time
    nbytes, ops = (m * k + k * n + m * n) * 4, 2 * m * n * k
    rows["mm_kernel"] = dict(
        ms=_device_ms(lambda: rtc.launch_mm(r2, a, b, ctx), 10, "mm_kernel"),
        plain_ms=_time_ms(lambda: rtc.mm_plain(a._data, b._data), 10),
        library_ms=_device_ms(lambda: torch.matmul(a._data, b._data), 10),
        **_bound(nbytes, ops))
    _tensor_core_row(rows["mm_kernel"], nbytes, ops)
    print("  R2 at (%d, %d) @ (%d, %d) f32: device %.4f ms a launch, "
          "torch.matmul (TF32 off) device %.4f ms, ms/library %.3f; "
          "tc_bound_ms %.4f; %.4f ms between R2 launches (CUDA events)" % (
              m, k, k, n, rows["mm_kernel"]["ms"],
              rows["mm_kernel"]["library_ms"],
              rows["mm_kernel"]["ms_over_library"],
              rows["mm_kernel"]["tc_bound_ms"],
              _time_ms(lambda: rtc.launch_mm(r2, a, b, ctx), 10)),
          flush=True)
    del x, one, a, b
    torch.cuda.empty_cache()
    return rows, k7_launches


def lm_card_vs_cpu(dev):
    """Phase 5b: one f32 step of a small LM on the card and on the CPU from
    the same numpy weights and tokens."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import convert

    lmm = _lm_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    start = lmm.build_params(rng, LM_SMALL["vocab"], LM_SMALL["dim"],
                             LM_SMALL["n_layers"])
    tokens = lmm.synthetic_tokens(rng, LM_SMALL["vocab"], 2, 256)
    losses, after = {}, {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        lm = lmm.LongContextLM(device=d, **LM_SMALL)
        convert.lm_params_from_jax(lm, start)
        losses[where] = lmm.make_step(lm, 0.05)(
            torch.from_numpy(tokens).to(d)).item()
        after[where] = dict(lm.named_parameters())
    worst = 0.0
    for name, p in after["cpu"].items():
        ref = p.detach()
        err = (after["cuda"][name].detach().cpu() - ref).abs().max().item()
        worst = max(worst, err / max(ref.abs().max().item(), 1e-30))
    lrel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print("  loss card %.7f cpu %.7f  rel diff %.3e (limit 1e-5); params "
          "after the step: max diff %.3e of each tensor's largest magnitude "
          "(limit 1e-4)" % (losses["cuda"], losses["cpu"], lrel, worst),
          flush=True)
    if not (lrel <= 1e-5 and worst <= 1e-4):
        raise AssertionError("card and CPU LM steps disagree")


def card_vs_cpu(dev):
    """Phase 5: one small f32 step on the card and on the CPU (plain and
    with every weight nudged by 1e-6, the CPU's own noise floor)."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import convert, initializer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    where = {"cuda": "cuda", "cpu": "cpu", "cpu_nudged": "cpu"}
    runs = {d: resnet.resnet50_v1(classes=1000, ghost_bn=16, device=w)
            for d, w in where.items()}
    initializer.initialize(runs["cuda"], initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(SEED))
    start = convert.params_to_numpy(runs["cuda"])
    for d in ("cpu", "cpu_nudged"):
        convert.params_from_jax(runs[d], start)
    nudge = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        for p in runs["cpu_nudged"].parameters():
            p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=nudge))
    names = [n for n, _ in convert.ordered_tensors(runs["cpu"])]
    is_param = {n for n, _ in runs["cpu"].named_parameters()}
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.normal(size=(16, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, 16).astype(np.float32))
    losses, after = {}, {}
    for d, net in runs.items():
        before = convert.params_to_numpy(net)
        step = make_train_step(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                               learning_rate=0.1, momentum=0.9, wd=1e-4,
                               multi_precision=True, loss_scale="dynamic",
                               device=where[d])
        losses[d] = step(x, y).item()
        if step.skipped_steps:
            raise AssertionError("the %s step was skipped" % d)
        after[d] = [(a, a - b) for a, b in
                    zip(convert.params_to_numpy(net), before)]

    def rel_update(d):
        out = []
        for n, (_, upd), (_, ref) in zip(names, after[d], after["cpu"]):
            if n in is_param:
                out.append(float(np.abs(upd - ref).max())
                           / max(float(np.abs(ref).max()), 1e-30))
        return np.array(out)

    _hold_to_noise_floor(losses, rel_update("cuda"),
                         rel_update("cpu_nudged"),
                         [(a, b) for n, (a, _), (b, _) in
                          zip(names, after["cuda"], after["cpu"])
                          if n not in is_param])
    torch.backends.cudnn.allow_tf32 = True


def _noise_floor_gate(losses, card, noise, stats_pairs,
                      stats_name="running stats", stats_limit=1e-3,
                      floor_add=1e-3):
    """Phase 5's gate, printed: the card's loss within 1e-4 of the
    CPU's (relative), its running stats (or the forward quantities
    ``stats_name`` names) within ``stats_limit`` of each tensor's
    largest magnitude (at least 1), and its per-tensor relative update
    differences from the CPU's at most 4x the nudged CPU run's plus
    ``floor_add``, in median and in maximum.  Returns True where all
    hold."""
    import numpy as np

    stats = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
                for a, b in stats_pairs)
    lrel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print("  loss card %.6f cpu %.6f  rel diff %.3e (limit 1e-4)"
          % (losses["cuda"], losses["cpu"], lrel), flush=True)
    print("  %s max rel diff %.3e (limit %.0e)" % (stats_name, stats,
                                                   stats_limit), flush=True)
    print("  update rel diff card-vs-cpu median %.3e max %.3e;  noise floor "
          "(cpu nudged 1e-6) median %.3e max %.3e  (limit 4x floor%s)"
          % (np.median(card), card.max(), np.median(noise), noise.max(),
             " + %.0e" % floor_add if floor_add else ""), flush=True)
    return bool(lrel <= 1e-4 and stats <= stats_limit
                and np.median(card) <= 4 * np.median(noise) + floor_add
                and card.max() <= 4 * noise.max() + floor_add)


def _hold_to_noise_floor(*args, **kwargs):
    """:func:`_noise_floor_gate`, raising where it fails."""
    if not _noise_floor_gate(*args, **kwargs):
        raise AssertionError("card and CPU steps disagree")


def gluon_card_vs_cpu(dev):
    """Phase 5c: one f32 step (TF32 off) of the Gluon example's loop at
    ``resnet18_v1``, 32 px, batch 16, built through its functions, on the
    card and on the CPU from the card's weights (copied by name), and on
    the CPU with every weight nudged by 1e-6: held to phase 5's noise
    floor."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import convert, gluon, metric, nd

    ex = _gluon_module()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    args = _gluon_args(ex, "resnet18_v1", 16, 32, 10, 0.05, 16)
    where = {"cuda": dev, "cpu": "cpu", "cpu_nudged": "cpu"}
    nets = {d: ex.build_net(args, w) for d, w in where.items()}
    start = {k: p.data().asnumpy()
             for k, p in nets["cuda"].collect_params().items()}
    nudge = np.random.RandomState(SEED + 3)
    for d in ("cpu", "cpu_nudged"):
        arrays = start
        if d == "cpu_nudged":
            arrays = {k: (v * (1 + 1e-6 * nudge.normal(size=v.shape)))
                      .astype(np.float32) if v.dtype == np.float32 else v
                      for k, v in start.items()}
        convert.params_from_gluon(nets[d], arrays)
    rng = np.random.RandomState(SEED)
    xb = rng.rand(16, 3, 32, 32).astype(np.float32)
    yb = rng.randint(0, 10, 16).astype(np.float32)
    losses, after, trained = {}, {}, []
    for d, net in nets.items():
        params = list(net.collect_params().values())
        before = [p.data().asnumpy() for p in params]
        trained = [p.grad_req != "null" for p in params]
        loss = ex.train_batch(net, ex.build_trainer(net, args),
                              gluon.loss.SoftmaxCrossEntropyLoss(),
                              metric.Accuracy(),
                              nd.array(xb, ctx=where[d]),
                              nd.array(yb, ctx=where[d]), args.batch_size)
        losses[d] = float(loss.asscalar())
        after[d] = [(p.data().asnumpy(), p.data().asnumpy() - b)
                    for p, b in zip(params, before)]

    def rel_update(d):
        return np.array([
            float(np.abs(upd - ref).max()) / max(float(np.abs(ref).max()),
                                                 1e-30)
            for t, (_, upd), (_, ref) in zip(trained, after[d], after["cpu"])
            if t])

    _hold_to_noise_floor(losses, rel_update("cuda"),
                         rel_update("cpu_nudged"),
                         [(a, b) for t, (a, _), (b, _) in
                          zip(trained, after["cuda"], after["cpu"])
                          if not t])
    torch.backends.cudnn.allow_tf32 = True


#: phase 5d's limits, from its own readings: the outputs within 1e-6 of
#: their largest magnitude (at least 1), the updates within 4x the nudged
#: CPU run's differences with no additive term
MNIST_STATS_LIMIT = 1e-6


def mnist_card_vs_cpu(dev):
    """Phase 5d: one f32 step (TF32 off) of ``train_mnist_torch.py``'s
    LeNet Module at batch 16 (sgd lr 0.1, momentum 0.9) on the card and on
    the CPU from the card's ``Uniform(0.01)`` weights, and on the CPU from
    weights nudged by 1e-6: the outputs, the loss (their cross-entropy),
    the updated parameters and the momentum held to the noise floor with
    phase 5d's own limits (``MNIST_STATS_LIMIT``, no additive term).  The
    same step on the card with TF32 on must fail those limits, or they
    could not tell a TF32 convolution from an f32 one."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx

    ex = _mnist_module()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _mnist_args(ex, "lenet", 16)
    where = {"cuda": dev, "cuda_tf32": dev, "cpu": mx.cpu(),
             "cpu_nudged": mx.cpu()}
    mods = {d: ex.build_module(args, w) for d, w in where.items()}
    for m in mods.values():
        m.bind(data_shapes=[("data", (16, 1, 28, 28))],
               label_shapes=[("softmax_label", (16,))])
    mods["cuda"].init_params()
    start = {k: v.asnumpy() for k, v in mods["cuda"].get_params()[0].items()}
    nudge = np.random.RandomState(SEED + 3)
    for d in ("cuda_tf32", "cpu", "cpu_nudged"):
        arrays = start if d != "cpu_nudged" else {
            k: (v * (1 + 1e-6 * nudge.normal(size=v.shape))).astype(v.dtype)
            for k, v in start.items()}
        mods[d].init_params(arg_params={k: mx.nd.array(v, ctx=where[d])
                                        for k, v in arrays.items()})
    rng = np.random.RandomState(SEED)
    x = rng.rand(16, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    losses, outs, after = {}, {}, {}
    for d, m in mods.items():
        m.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": args.lr, "momentum": 0.9})
        before = {k: v.asnumpy() for k, v in m.get_params()[0].items()}
        torch.backends.cudnn.allow_tf32 = d == "cuda_tf32"
        torch.backends.cuda.matmul.allow_tf32 = d == "cuda_tf32"
        m.forward_backward(mx.io.DataBatch([mx.nd.array(x, ctx=where[d])],
                                           [mx.nd.array(y, ctx=where[d])]))
        m.update()
        torch.cuda.synchronize()
        outs[d] = m.get_outputs()[0].asnumpy()
        losses[d] = float(-np.log(outs[d][np.arange(16), y.astype(int)])
                          .mean())
        names = m._param_names
        params = m.get_params()[0]
        after[d] = [params[k].asnumpy() - before[k] for k in names] + \
            [m._updater.states[i].asnumpy() for i in range(len(names))]

    def rel(d):
        return np.array([float(np.abs(a - b).max())
                         / max(float(np.abs(b).max()), 1e-30)
                         for a, b in zip(after[d], after["cpu"])])

    limits = dict(stats_name="outputs", stats_limit=MNIST_STATS_LIMIT,
                  floor_add=0.0)
    _hold_to_noise_floor(losses, rel("cuda"), rel("cpu_nudged"),
                         [(outs["cuda"], outs["cpu"])], **limits)
    print("  the same step with TF32 on:", flush=True)
    tf32 = dict(losses, cuda=losses["cuda_tf32"])
    if _noise_floor_gate(tf32, rel("cuda_tf32"), rel("cpu_nudged"),
                         [(outs["cuda_tf32"], outs["cpu"])], **limits):
        raise AssertionError("phase 5d's limits pass a TF32 step")
    print("  TF32 on fails the limits, as it must", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


#: phase 5e's shapes: a small WordLM (the CPU runs it too)
WORDLM_SMALL = dict(vocab=256, emsize=64, nhid=128, nlayers=2, batch=8,
                    bptt=16)
#: phase 5e's limits: logits within 1e-5 of their largest magnitude (at
#: least 1), updates within 4x the nudged CPU run's plus 1e-4
WORDLM_STATS_LIMIT, WORDLM_FLOOR_ADD = 1e-5, 1e-4


def word_lm_card_vs_cpu(dev):
    """Phase 5e: one f32 step (TF32 off) of ``train_torch.py``'s WordLM at
    ``WORDLM_SMALL`` through its ``build`` and ``train_step`` on the card
    and on the CPU from the card's weights (copied by name), and on the
    CPU from weights nudged by 1e-6: the logits before the step, the loss
    and the updates (sgd's: the gradients times -lr / batch, compared as
    the gradients) held to the noise floor (``WORDLM_STATS_LIMIT``,
    ``WORDLM_FLOOR_ADD``).  The same step with TF32 on is printed beside
    it."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import convert

    ex = _word_lm_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _word_lm_args(ex, WORDLM_SMALL)
    data = ex.corpus_rows(args)
    where = {"cuda": dev, "cuda_tf32": dev, "cpu": mx.cpu(),
             "cpu_nudged": mx.cpu()}
    built = {d: ex.build(args, w) for d, w in where.items()}
    start = {k: p.data().asnumpy()
             for k, p in built["cuda"][0].collect_params().items()}
    nudge = np.random.RandomState(SEED + 3)
    for d in ("cuda_tf32", "cpu", "cpu_nudged"):
        arrays = start if d != "cpu_nudged" else {
            k: (v * (1 + 1e-6 * nudge.normal(size=v.shape))).astype(v.dtype)
            for k, v in start.items()}
        convert.params_from_gluon(built[d][0], arrays)
    losses, logits, after = {}, {}, {}
    for d, (net, trainer, loss_fn) in built.items():
        tf32 = d == "cuda_tf32"
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        x, y = ex.batch(data, 0, args.bptt, where[d])
        logits[d] = net(x).asnumpy()
        losses[d] = float(ex.train_step(net, trainer, loss_fn, x, y,
                                        args).asscalar())
        # sgd's update is -lr / batch times the gradient: compared as the
        # gradient, free of the cancellation in after - before
        after[d] = [p.grad().asnumpy()
                    for p in net.collect_params().values()]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    def rel(d):
        return np.array([float(np.abs(a - b).max())
                         / max(float(np.abs(b).max()), 1e-30)
                         for a, b in zip(after[d], after["cpu"])])

    limits = dict(stats_name="logits", stats_limit=WORDLM_STATS_LIMIT,
                  floor_add=WORDLM_FLOOR_ADD)
    _hold_to_noise_floor(losses, rel("cuda"), rel("cpu_nudged"),
                         [(logits["cuda"], logits["cpu"])], **limits)
    print("  the same step with TF32 on (printed, not gated):", flush=True)
    passed = _noise_floor_gate(dict(losses, cuda=losses["cuda_tf32"]),
                               rel("cuda_tf32"), rel("cpu_nudged"),
                               [(logits["cuda_tf32"], logits["cpu"])],
                               **limits)
    print("  TF32 on %s phase 5e's limits" % ("passes" if passed else
                                              "fails"), flush=True)


#: phase 5f's limits: the heads' outputs within 1e-5 of their largest
#: magnitude (at least 1), the gradients within 4x the nudged CPU run's
#: differences plus 1e-4
SSD_STATS_LIMIT, SSD_FLOOR_ADD = 1e-5, 1e-4


def ssd_card_vs_cpu(dev):
    """Phase 5f: one f32 step (TF32 off) of ``train_torch.py``'s TinySSD
    at batch 16 through its ``build_net`` and ``train_step`` on the card
    and on the CPU from the card's weights (copied by name), and on the
    CPU from weights nudged by 1e-6: the class and location heads before
    the step, the loss and the gradients (sgd's update is -lr / batch
    times the gradient) held to the noise floor (``SSD_STATS_LIMIT``,
    ``SSD_FLOOR_ADD``)."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import convert, nd

    ex = _ssd_module()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _ssd_args(ex, SSD["batch"], 1)
    where = {"cuda": dev, "cpu": mx.cpu(), "cpu_nudged": mx.cpu()}
    built = {d: ex.build_net(args, w) for d, w in where.items()}
    start = {k: p.data().asnumpy()
             for k, p in built["cuda"][0].collect_params().items()}
    nudge = np.random.RandomState(SEED + 3)
    for d in ("cpu", "cpu_nudged"):
        arrays = start if d == "cpu" else {
            k: (v * (1 + 1e-6 * nudge.normal(size=v.shape))).astype(v.dtype)
            for k, v in start.items()}
        convert.params_from_gluon(built[d][0], arrays)
    imgs, labels = ex.synthetic_batch(np.random.RandomState(SEED),
                                      args.batch_size)
    losses, heads, grads = {}, {}, {}
    for d, (net, trainer, cls_loss) in built.items():
        x = nd.array(imgs, ctx=where[d])
        y = nd.array(labels, ctx=where[d])
        _, cp, lp = ex.heads(net, x)
        heads[d] = np.concatenate([cp.asnumpy().ravel(),
                                   lp.asnumpy().ravel()])
        losses[d] = float(ex.train_step(net, trainer, cls_loss, x,
                                        y).asscalar())
        grads[d] = [p.grad().asnumpy()
                    for p in net.collect_params().values()]
    torch.backends.cudnn.allow_tf32 = True

    def rel(d):
        return np.array([float(np.abs(a - b).max())
                         / max(float(np.abs(b).max()), 1e-30)
                         for a, b in zip(grads[d], grads["cpu"])])

    _hold_to_noise_floor(losses, rel("cuda"), rel("cpu_nudged"),
                         [(heads["cuda"], heads["cpu"])],
                         stats_name="head outputs",
                         stats_limit=SSD_STATS_LIMIT,
                         floor_add=SSD_FLOOR_ADD)


# phase 3o: the supervised main path (run_supervised under the Supervisor's
# ladder), the async rung at full width, the chaos matrix on the card
#: the ranks' job: phase 3m's step and data at dp = the job's width, 8
#: applied steps, a checkpoint every 2 (with the iterator's position)
SUPERVISED = dict(steps=8, every=2, commit_timeout=30.0)
#: the watchdog: stall floor and startup grace (seconds) of every job of
#: the phase; the floor is above a two-rank save of the step's state
#: (1.5-3.8 s in phase 3m) plus a step, the grace above a rank's start
SUP_WATCH = dict(min_stall=12.0, startup=180.0, backoff=0.25,
                 timeout=300.0)
#: (i)-(iv): scenario, chaos spec, width, restart budget
SUP_CASES = (("kill", "kill_process:at=3", 1, 2),
             ("bomb", "loss_bomb:at=4,factor=1e4", 1, 2),
             ("hang", "hang_step:at=3,duration=600.0", 1, 2),
             ("shrink", "host_loss_during_save:save=1", 2, 0))
#: (v): the steps compared between the rungs, then timed on the async one
ASYNC_STEPS = dict(compare=2, timed=3, compressed=2)
#: (vi): seconds the chaos matrix may take
CHAOS_TIMEOUT = 420


def _supervise_tool():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "supervise_torch.py")
    spec = importlib.util.spec_from_file_location("supervise_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _supervised_job(tool, dev, outdir):
    """The ranks' job (``tools/supervise_torch.py``'s ``run_worker`` takes
    it): phase 3m's step over ``make_mesh({"dp": -1})`` with ``zero=1``,
    fed this rank's rows of each global batch of the resident set."""
    from incubator_mxnet_tpu_torch.parallel import (CheckpointManager,
                                                    SupervisorConfig,
                                                    make_mesh)

    mesh = make_mesh({"dp": -1})
    n, r = mesh.size, mesh.axis_index("dp")
    step = _elastic_step(dev, mesh, SEED)
    it = _elastic_iter(_elastic_data(), SEED)
    if n > 1:
        rows = ELASTIC["batch"] // n
        it = tool.RowSlice(it, r * rows, (r + 1) * rows)
    mgr = CheckpointManager(os.path.join(outdir, "ckpt"),
                            commit_timeout=SUPERVISED["commit_timeout"])
    return (step, it, mgr, SupervisorConfig(
        checkpoint_every=SUPERVISED["every"]), r, n)


@contextlib.contextmanager
def _counted_steps(record):
    """Each supervised step call's K1-K3 launches into ``record``: the
    counts set to 0 just before the call (``supervisor._run_step``, the
    choke point the chaos injectors wrap too) and read just after."""
    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.parallel import supervisor as sup

    real = sup._run_step

    def counted(step, x, y):
        _kernels.reset_launch_counts()
        out = real(step, x, y)
        record.append(_kernels.launch_counts())
        return out

    sup._run_step = counted
    try:
        yield
    finally:
        sup._run_step = real


def supervised_rank_main(outdir):
    """One rank of phase 3o (this script with ``--supervised-rank DIR``,
    started by the Supervisor through ``tools/launch_torch.py``): the job
    under ``run_supervised`` to ``SUPERVISED["steps"]``, the chaos of
    ``MXTPU_CHAOS`` armed on attempt 0; ``<DIR>/result_rank<r>.json``
    gets the losses, the state's digest and each call's launches."""
    import torch

    from incubator_mxnet_tpu_torch.parallel import distributed

    distributed.initialize()
    dev = distributed.local_device()
    torch.cuda.set_device(dev)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    tool = _supervise_tool()
    launches = []
    with _counted_steps(launches):
        job = _supervised_job(tool, dev, outdir)
        rank, n = job[4], job[5]

        def extra(step):
            return {"digest": _elastic_digest(step, rank, n),
                    "launches": launches,
                    "skipped": step.skipped_steps}

        return tool.run_worker(outdir, job, SUPERVISED["steps"],
                               extra=extra)


def _supervised_reference(tool, dev, outdir, card):
    """The unfaulted run in this process (dp=1), each step's host time
    under ``run_supervised`` (heartbeat, detectors, one read of the
    device's scalars) and each save's; then bare steps of the same step
    object on the next batches."""
    import torch

    from incubator_mxnet_tpu_torch.parallel import supervisor as sup

    launches, ticks, saves, beats = [], [], [], []
    real_save, real_emit = sup._save_checkpoint, sup.HeartbeatEmitter.emit

    def timed_save(step, mgr, it):
        t0 = time.perf_counter()
        try:
            return real_save(step, mgr, it)
        finally:
            saves.append((time.perf_counter() - t0) * 1e3)
            ticks.append(None)  # the next interval holds this save

    def timed_emit(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real_emit(self, *args, **kwargs)
        finally:
            beats.append((time.perf_counter() - t0) * 1e3)

    sup._save_checkpoint = timed_save
    sup.HeartbeatEmitter.emit = timed_emit
    try:
        with _counted_steps(launches):
            step, it, mgr, cfg, rank, n = _supervised_job(tool, dev, outdir)
            torch.cuda.synchronize()
            ticks.append(time.perf_counter())
            res = sup.run_supervised(
                step, it, mgr, until_step=SUPERVISED["steps"], config=cfg,
                on_step=lambda hb: ticks.append(time.perf_counter()))
    finally:
        sup._save_checkpoint = real_save
        sup.HeartbeatEmitter.emit = real_emit
    digest = _elastic_digest(step, rank, n)
    per, last, after_save = [], None, False
    for t in ticks:
        if t is None:
            after_save = True
            continue
        if last is not None and not after_save:
            per.append((t - last) * 1e3)
        last, after_save = t, False
    bare = []
    for _ in range(4):
        t0 = time.perf_counter()
        x, y = sup._next_batch(it)
        float(step(x, y))
        bare.append((time.perf_counter() - t0) * 1e3)
    it.close()
    del step
    torch.cuda.empty_cache()
    _elastic_gate_launches([{"rank": 0, "launches": launches}],
                           "(0) unfaulted")
    print("[3o] (0) unfaulted in this process, dp=1: losses %s  skipped %d"
          % (["%.5f" % v for v in res["losses"]],
             len(launches) - res["final_step"]), flush=True)
    print("[3o] supervised_step_ms %.2f (median of %d steps without a save "
          "before them: run_supervised's loop, the boundary read, the "
          "heartbeat)  bare step_ms %.2f (median of 3: the batch, the step, "
          "the loss read back)"
          "  heartbeat_ms %.2f (median of %d: JSON, write, fsync, rename)  "
          "save_ms %s  on %s" % (
              _median(per[1:]), len(per[1:]), _median(bare[1:]),
              _median(beats), len(beats), ["%.0f" % v for v in saves],
              card), flush=True)
    return {"digest": digest, "losses": res["losses"], "launches": launches,
            "supervised_step_ms": _median(per[1:]),
            "bare_step_ms": _median(bare[1:])}


def _gpu_memory_back(base_free, card, timeout=60.0):
    """Before a relaunch: wait until the card's free memory is back within
    2 GiB of what it was before the phase's first job (a killed rank
    must not hold it), and print it."""
    import torch

    t0 = time.perf_counter()
    while True:
        free, total = torch.cuda.mem_get_info()
        if free >= base_free - (2 << 30) or \
                time.perf_counter() - t0 > timeout:
            break
        time.sleep(0.2)
    print("[3o]   card memory before the relaunch: %.2f GiB free of %.2f "
          "(%.2f before the first job; waited %.2f s)  on %s"
          % (free / 2 ** 30, total / 2 ** 30, base_free / 2 ** 30,
             time.perf_counter() - t0, card), flush=True)
    if free < base_free - (2 << 30):
        raise AssertionError("the card's memory did not come back")


def _supervised_case(tool, root, name, chaos, width, max_restarts,
                     base_free, card):
    """One Supervisor run of the ranks' job: (outcome, rank 0's result,
    the merged ledger)."""
    from incubator_mxnet_tpu_torch.parallel.supervisor import read_ledger

    outdir = os.path.join(root, name)
    os.makedirs(outdir)
    args = tool.parser().parse_args([
        "--dir", outdir, "-n", str(width), "--steps",
        str(SUPERVISED["steps"]), "--checkpoint-every",
        str(SUPERVISED["every"]), "--max-restarts", str(max_restarts),
        "--min-stall", str(SUP_WATCH["min_stall"]), "--startup-timeout",
        str(SUP_WATCH["startup"]), "--backoff", str(SUP_WATCH["backoff"]),
        "--timeout", str(SUP_WATCH["timeout"])])

    here = os.path.abspath(__file__)
    spawn = tool.make_launcher(
        args, chaos, command=[sys.executable, here, "--supervised-rank",
                              outdir])

    def launch(w, attempt):
        if attempt > 0:  # the killed job must have let go of the card
            _gpu_memory_back(base_free, card)
        return spawn(w, attempt)

    t0 = time.perf_counter()
    out = tool.supervise_once(args, chaos_spec=chaos, launch=launch)
    out["wall_s"] = time.perf_counter() - t0
    try:
        with open(os.path.join(outdir, "result_rank0.json")) as f:
            res = json.load(f)
    except OSError:
        res = {}
    return out, res, read_ledger(os.path.join(outdir, "ckpt"))


def _require(cond, what, out):
    if not cond:
        raise AssertionError("phase 3o: %s; outcome %s" % (
            what, {k: out.get(k) for k in ("outcome", "reason", "width",
                                            "restarts", "shrinks", "events",
                                            "torn_visible")}))


def run_async_rung(dev, card):
    """Phase 3o (v): the main path's net at batch 256 with
    ``sync="async"``, ``staleness_bound=0``, no loss scale, one rank,
    against ``sync="allreduce"`` on the same batches; then timed; then
    ``compression="2bit"``.  Returns the launches."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.parallel import make_train_step

    from incubator_mxnet_tpu_torch.parallel.supervisor import _next_batch

    it = _elastic_iter(_elastic_data(), SEED)
    batches = [_next_batch(it) for _ in range(ASYNC_STEPS["compare"]
                                              + ASYNC_STEPS["timed"])]
    it.close()
    batches = [(x._data.to(dev), y._data.to(dev)) for x, y in batches]

    def build(sync, compression=None):
        return make_train_step(
            _main_net(dev, SEED), SoftmaxCrossEntropyLoss(), optimizer="sgd",
            learning_rate=ELASTIC["lr"], momentum=0.9, wd=1e-4,
            multi_precision=True, compute_dtype="bfloat16", device=dev,
            sync=sync, compression=compression,
            staleness_bound=None if sync == "allreduce" else 0)

    counts = {name: 0 for name in MAIN_PATH}

    def run(step, pairs, timed=False):
        losses, ms = [], []
        for x, y in pairs:
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            losses.append(float(step(x, y)))
            ms.append((time.perf_counter() - t0) * 1e3)
            got = _kernels.launch_counts()
            want = {name: 0 for name in got}
            want.update(MAIN_PATH)
            if got != want:
                raise AssertionError("(v) a step launched %s, want %s"
                                     % (got, want))
            for name in MAIN_PATH:
                counts[name] += got[name]
        return losses, ms

    k = ASYNC_STEPS["compare"]
    ref = build("allreduce")
    ref_losses, _ = run(ref, batches[:k])
    ref_params = [p.detach().cpu() for p in ref._gp]
    del ref
    torch.cuda.empty_cache()
    step = build("async")
    losses, _ = run(step, batches[:k])
    diff = max(float((p.detach().cpu() - q).abs().max())
               for p, q in zip(step._gp, ref_params))
    equal = all(torch.equal(p.detach().cpu(), q)
                for p, q in zip(step._gp, ref_params))
    if not equal or losses != ref_losses:
        raise AssertionError("(v) the async rung after %d steps: losses %s "
                             "vs %s, largest parameter difference %g (want "
                             "bit-equal: the service runs the same update)"
                             % (k, losses, ref_losses, diff))
    _, ms = run(step, batches[k:])
    svc = step._svc_client.service
    print("[3o] (v) sync='async' at batch %d, staleness_bound 0, no loss "
          "scale: after %d steps the parameters equal sync='allreduce''s "
          "bit for bit (losses %s); async_step_ms %.2f (median of %d: "
          "push %d MB, pull, install)  on %s"
          % (ELASTIC["batch"], k, ["%.5f" % v for v in losses],
             _median(ms), len(ms), svc.push_nbytes // svc.clock.step(0)
             // 2 ** 20, card), flush=True)
    del step, svc
    torch.cuda.empty_cache()
    step = build("async", "2bit")
    losses, ms = run(step, batches[:ASYNC_STEPS["compressed"]])
    if not _losses_ok(losses):
        raise AssertionError("(v) 2-bit compressed losses %s" % losses)
    print("[3o] (v) compression='2bit': losses %s finite  step_ms %s  on %s"
          % (["%.5f" % v for v in losses], ["%.1f" % v for v in ms], card),
          flush=True)
    del step
    torch.cuda.empty_cache()
    return counts


def start_chaos_matrix():
    """Phase 3o (vi): start ``tools/supervise_torch.py --chaos all --format
    json`` with its ranks on the card, in a session of its own (it runs
    beside (i)-(v)); returns ``(process, its directory, start time)``."""
    here = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "tools", "supervise_torch.py"),
         "--chaos", "all", "--format", "json", "--dir", d],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return proc, d, time.perf_counter()


def stop_chaos_matrix(job):
    """Kill the chaos matrix's process group (and every rank it started,
    each in a session of its own: they are killed by their supervisor's
    ``_kill_job`` when it is stopped, and else end at their job's
    timeout) and remove its directory."""
    import signal

    proc, d, _ = job
    try:
        os.killpg(proc.pid, signal.SIGTERM)
        proc.wait(timeout=30)
    except (ProcessLookupError, subprocess.TimeoutExpired):
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    shutil.rmtree(d, ignore_errors=True)


def finish_chaos_matrix(job, card):
    """Phase 3o (vi): wait for the chaos matrix; every scenario green,
    exit code 0."""
    proc, d, t0 = job
    try:
        out, err = proc.communicate(timeout=max(
            1.0, CHAOS_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_chaos_matrix(job)
        raise AssertionError("(vi) the chaos matrix passed its %d s limit"
                             % CHAOS_TIMEOUT)
    shutil.rmtree(d, ignore_errors=True)
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    if proc.returncode != 0 or len(recs) != 5 or \
            not all(r["ok"] for r in recs):
        raise AssertionError("(vi) the chaos matrix (rc %d): %s\n%s"
                             % (proc.returncode, recs, err[-3000:]))
    for r in recs:
        print("[3o] (vi) %-22s %s  restarts %d  shrinks %d  mttr %.2f s  "
              "width %d  on %s" % (r["scenario"], r["outcome"], r["restarts"],
                                   r["shrinks"], r["mttr"], r["width"],
                                   card), flush=True)
    print("[3o] (vi) tools/supervise_torch.py --chaos all exit 0 in %.1f s "
          "(beside (i)-(v))  on %s" % (time.perf_counter() - t0, card),
          flush=True)


def run_supervised_path(dev, card):
    """Phase 3o (see the module docstring).  Returns the launches of the
    main path's steps here and in the ranks."""
    import torch

    t_phase = time.perf_counter()
    tool = _supervise_tool()
    counts = {name: 0 for name in MAIN_PATH}
    root = tempfile.mkdtemp(prefix="chip_smoke_supervised_")
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mttr = {}
    torch.cuda.empty_cache()
    ref = _supervised_reference(tool, dev, os.path.join(root, "ref"), card)
    matrix = start_chaos_matrix()
    try:
        for name in MAIN_PATH:
            counts[name] += sum(c[name] for c in ref["launches"])
        torch.cuda.synchronize()
        base_free = torch.cuda.mem_get_info()[0]
        print("[3o] watchdog: min_stall_timeout %g s, startup_timeout %g s, "
              "backoff %g s; ranks check every %d steps"
              % (SUP_WATCH["min_stall"], SUP_WATCH["startup"],
                 SUP_WATCH["backoff"], SUPERVISED["every"]), flush=True)
        for name, chaos, width, budget in SUP_CASES:
            out, res, ledger = _supervised_case(tool, root, name, chaos,
                                                width, budget, base_free,
                                                card)
            ev = out["events"]
            _require(out["outcome"] == "resolved" and res.get("status")
                     == "done" and res.get("final_step")
                     == SUPERVISED["steps"], "(%s) did not finish" % name,
                     out)
            _require(out["torn_visible"] == 0, "(%s) a torn checkpoint is "
                     "visible" % name, out)
            _elastic_gate_launches([res], "(%s)" % name)
            for c in res["launches"]:
                for k in MAIN_PATH:
                    counts[k] += c[k]
            faults = [e for e in ledger if e["event"] == "fault"]
            if name in ("kill", "hang"):
                want = ["launch", "fault", "restart", "recovered",
                        "resolved"] + (["heartbeat_gap"] if name == "hang"
                                       else [])
                _require(all(e in ev for e in want) and out["restarts"] == 1
                         and res["restored_from"] == 2
                         and res["digest"] == ref["digest"]
                         and res["losses"] == ref["losses"][2:],
                         "(%s) the respawned run is not the unfaulted one"
                         % name, out)
            if name == "bomb":
                div = [e for e in ledger if e["event"] == "divergence"]
                _require(all(e in ev for e in ("launch", "divergence",
                                               "rollback", "recovered",
                                               "done", "resolved"))
                         and out["restarts"] == 0
                         and res["digest"] == ref["digest"],
                         "(bomb) the rollback's replay is not the unfaulted "
                         "run", out)
                print("[3o] (ii) loss_bomb at call 4: verdict %s at step %d "
                      "(loss %.4g, skip streak %d), rolled back to step %d; "
                      "the final state's digest is the unfaulted run's"
                      % (div[0]["verdict"], div[0]["step"], div[0]["loss"],
                         div[0]["skip_streak"],
                         [e for e in ledger if e["event"]
                          == "rollback"][0]["to_step"]), flush=True)
            if name == "hang":
                print("[3o] (iii) hang_step at call 3: stall timeout %.2f s "
                      "(the clock's calibration; floor %g)"
                      % (faults[0]["stall_timeout"], SUP_WATCH["min_stall"]),
                      flush=True)
            if name == "shrink":
                _require(all(e in ev for e in ("launch", "fault", "shrink",
                                               "recovered", "done",
                                               "resolved"))
                         and out["shrinks"] == 1 and out["width"] == 1
                         and res["width"] == 1, "(shrink) the ladder did not "
                         "shrink to dp=1", out)
            mttr[name] = max(out["mttrs"]) if out["mttrs"] else None
            print("[3o] (%s) %s, width %d -> %d: %s; restarts %d, shrinks %d;"
                  " faults %s; MTTR %s s; job %.1f s  on %s"
                  % ({"kill": "i", "bomb": "ii", "hang": "iii",
                      "shrink": "iv"}[name], chaos, width, out["width"],
                     out["outcome"], out["restarts"], out["shrinks"],
                     [f["verdict"] for f in faults],
                     "%.2f" % mttr[name] if mttr[name] is not None else "-",
                     out["wall_s"], card), flush=True)
        async_counts = run_async_rung(dev, card)
        for name in MAIN_PATH:
            counts[name] += async_counts[name]
        finish_chaos_matrix(matrix, card)
    except BaseException:
        stop_chaos_matrix(matrix)
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = old
    torch.cuda.empty_cache()
    print("[3o] supervised_step_ms %.2f vs bare step_ms %.2f (the loop's "
          "overhead %.2f ms, %.1f %%)  MTTR (i) %s (ii) %s (iii) %s (iv) %s s"
          "  phase wall time %.2f s  on %s"
          % (ref["supervised_step_ms"], ref["bare_step_ms"],
             ref["supervised_step_ms"] - ref["bare_step_ms"],
             100.0 * (ref["supervised_step_ms"] - ref["bare_step_ms"])
             / ref["bare_step_ms"],
             *["%.2f" % mttr[n] if mttr.get(n) is not None else "-"
               for n in ("kill", "bomb", "hang", "shrink")],
             time.perf_counter() - t_phase, card), flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 3p: serving (serve/): bench.py's serve leg, swaps, chaos, decode
# ---------------------------------------------------------------------------

#: bench.py:378-423's serve leg (run_serve's defaults), and 3p's limits:
#: the unpadded forward at another batch size (cuDNN may choose another
#: algorithm there) within ``unpadded_tol`` of the largest logit; the card
#: against the CPU within 4x the nudged CPU's difference plus ``cpu_add``
#: of the largest logit; the decoder within ``decode_tol`` (f32 sums of
#: the ring in slot order, of the recompute in position order).  The
#: decoder runs twice: ``decode_small`` at ``TinyDecoderLM``'s defaults
#: (a correctness gate only: at that width a step is launch overhead),
#: and ``decode_wide`` at 3b's LM widths (dim 1024, 8 heads, 2 layers,
#: seq 2048) with a 32000-token vocabulary, the width ``decode_step_ms``
#: is read at; each steps past its seq bucket, so the ring wraps
SERVE = dict(image=224, buckets=(16, 64), qps=400.0, requests=200,
             max_delay_ms=10.0, pool=8, cpu_rows=8, unpadded_tol=1e-5,
             cpu_add=1e-6, decode_tol=1e-5, storm_swaps=4,
             decode_small=dict(lm={}, batch=4, seq=32, prompt=8, steps=40),
             decode_wide=dict(lm=dict(vocab=32000, d_model=1024, n_heads=8,
                                      n_layers=2, d_ff=4096, max_len=2048),
                              batch=8, seq=2048, prompt=128, steps=2000))


def _serve_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_serve_bench_torch", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tools",
            "serve_bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _served_gates(dev, eng, pool, card):
    """3p (ii): replay against eager, rows against batch-mates, the
    unpadded forward, the CPU within its noise floor."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import convert
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    slot = eng._slots[eng._state[1]]
    rng = np.random.RandomState(SEED + 1)
    for b in eng.buckets:
        n = b - 3
        x = rng.rand(n, 3, SERVE["image"], SERVE["image"]).astype(np.float32)
        out = eng.infer(x)
        xp = torch.zeros((b,) + x.shape[1:], device=dev)
        xp[:n] = torch.from_numpy(x)
        with torch.no_grad():
            ref = slot.net(xp)[:n]
        gap = (out - ref).abs().max().item()
        mates = eng.infer(np.concatenate([x[:1], rng.rand(
            n - 1, *x.shape[1:]).astype(np.float32)]))
        print("[3p] (ii) bucket %d, %d rows: replay vs eager forward of the "
              "padded batch max |diff| %.3e (largest logit %.4g); row 0 with "
              "other batch-mates bit-equal %s  on %s" % (
                  b, n, gap, ref.abs().max().item(),
                  torch.equal(mates[0], out[0]), card), flush=True)
        if gap != 0.0 or not torch.equal(mates[0], out[0]):
            raise AssertionError("bucket %d: the replay is not the eager "
                                 "forward, or a row moved with its "
                                 "batch-mates" % b)
    x = pool[:5]
    out = eng.infer(x)
    with torch.no_grad():
        exact = slot.net(torch.from_numpy(x).to(dev))
    gap = (out - exact).abs().max().item()
    scale = exact.abs().max().item()
    print("[3p] (ii) 5 rows padded into bucket %d vs the eager forward at "
          "batch 5: max |diff| %.3e = %.3e of the largest logit (limit %.0e)"
          "  on %s" % (eng.bucket_for(5), gap, gap / scale,
                       SERVE["unpadded_tol"], card), flush=True)
    if gap > SERVE["unpadded_tol"] * scale:
        raise AssertionError("padded and unpadded forwards disagree")
    x = pool[:SERVE["cpu_rows"]]
    card_out = eng.infer(x).cpu().double()
    start = convert.params_to_numpy(eng.net)
    nudge = np.random.RandomState(SEED + 3)
    cpu = {}
    for name in ("cpu", "cpu_nudged"):
        net = resnet.resnet50_v1(classes=1000, device="cpu")
        net.shape_init((1,) + x.shape[1:])
        arrays = start if name == "cpu" else [
            (a * (1 + 1e-6 * nudge.normal(size=a.shape))).astype(np.float32)
            for a in start]
        convert.params_from_jax(net, arrays)
        net.eval()
        with torch.no_grad():
            cpu[name] = net(torch.from_numpy(x)).double()
    err = (card_out - cpu["cpu"]).abs().max().item()
    floor = (cpu["cpu_nudged"] - cpu["cpu"]).abs().max().item()
    scale = cpu["cpu"].abs().max().item()
    limit = 4 * floor + SERVE["cpu_add"] * scale
    print("[3p] (ii) served logits (%d rows) vs the CPU forward (K3's plain "
          "version): max |diff| %.3e; noise floor (CPU, weights nudged by "
          "1e-6) %.3e; limit 4x floor + %.0e x %.4g = %.3e  on %s"
          % (len(x), err, floor, SERVE["cpu_add"], scale, limit, card),
          flush=True)
    if not err <= limit:
        raise AssertionError("the served logits disagree with the CPU")


def _split_infer(eng, full, card):
    """3p (i): ``infer`` of a full bucket on the host clock, then its
    parts one at a time, each between two synchronizations, on the host
    clock and by CUDA events: the rows wrapped as a tensor, the copy
    from pageable numpy memory into the bucket's input (beside the same
    copy from pinned memory), the replay, the rows cloned out."""
    import torch

    b = full.shape[0]
    prog = eng._programs[(eng._state[1], b)]
    reps = 10
    eng.infer(full)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.infer(full)
    torch.cuda.synchronize()
    infer_ms = (time.perf_counter() - t0) * 1e3 / reps
    xt = eng._rows(full)
    pinned = xt.pin_memory()
    parts = (("rows", lambda: eng._rows(full)),
             ("copy", lambda: prog.x.copy_(xt)),
             ("pinned copy", lambda: prog.x.copy_(pinned)),
             ("replay", prog.graph.replay),
             ("clone", lambda: prog.out[:b].clone()))
    host = {k: 0.0 for k, _ in parts}
    dev_ms = {k: 0.0 for k, _ in parts}
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    for rnd in range(reps + 1):
        for k, fn in parts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            fn()
            z.record()
            torch.cuda.synchronize()
            if rnd:   # the first round warms
                host[k] += (time.perf_counter() - t0) * 1e3 / reps
                dev_ms[k] += a.elapsed_time(z) / reps
    print("[3p] (i) bucket %d: infer of %d rows %.3f ms (host clock, mean "
          "of %d); alone, host / events ms: rows wrapped %.3f / %.3f, "
          "pageable H2D copy of %.2f MB %.3f / %.3f (%.2f GB/s), pinned copy "
          "%.3f / %.3f, graph replay %.3f / %.3f, rows cloned %.3f / %.3f; "
          "infer less the parts (pageable) %.3f  on %s"
          % (b, b, infer_ms, reps, host["rows"], dev_ms["rows"],
             full.nbytes / 1e6, host["copy"], dev_ms["copy"],
             full.nbytes / host["copy"] / 1e6, host["pinned copy"],
             dev_ms["pinned copy"], host["replay"], dev_ms["replay"],
             host["clone"], dev_ms["clone"],
             infer_ms - sum(host[k] for k in host if k != "pinned copy"),
             card), flush=True)


def _run_decoder(dev, card, name):
    """3p (v): ``CachedDecoder`` over ``SERVE[name]``'s decoder against
    full recompute, step for step through a ring wraparound; at
    ``decode_wide`` also ``decode_step_ms`` beside its byte bound."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch.serve import CachedDecoder, TinyDecoderLM

    cfg = SERVE[name]
    B, S, P = cfg["batch"], cfg["seq"], cfg["prompt"]
    lm = TinyDecoderLM(**cfg["lm"])
    params = lm.init(SEED, device=dev)
    dec = CachedDecoder(lm, params, seq_buckets=(S,), device=dev)
    rng = np.random.RandomState(SEED)
    prompt = rng.randint(0, lm.vocab, (B, P))
    logits0 = dec.start(prompt, max_new=S - P)
    tok = logits0[:, -1].argmax(-1)
    toks, steps = [], []
    for _ in range(cfg["steps"]):
        toks.append(tok)
        lg = dec.step(tok)
        steps.append(lg)
        tok = lg.argmax(-1)
    seq = torch.cat([torch.from_numpy(prompt).to(dev),
                     torch.stack(toks, 1)], 1)
    with torch.no_grad():
        full = lm.apply_tokens(params, seq, window=S)
    err = (torch.stack(steps, 1) - full[:, P:]).abs().max().item()
    scale = full.abs().max().item()
    pos = dec.pos
    del full, steps
    limit = SERVE["decode_tol"] * max(1.0, scale)
    print("[3p] (v) CachedDecoder (%s): TinyDecoderLM(vocab %d, d_model %d,"
          " %d heads, %d layers, d_ff %d), batch %d, seq bucket %d, %d steps"
          " past a %d-token prompt (pos %d: the ring wrapped): max |diff| vs"
          " full recompute over the sliding window %.3e (limit %.0e x %.4g);"
          " programs %d  on %s"
          % (name, lm.vocab, lm.d_model, lm.n_heads, lm.n_layers, lm.d_ff,
             B, S, cfg["steps"], P, pos, err, SERVE["decode_tol"],
             max(1.0, scale), dec.compiles, card), flush=True)
    if not err <= limit or dec.compiles != 2 or pos <= S:
        raise AssertionError("cached decode disagrees with recompute")
    if name != "decode_wide":
        return
    prog = dec._graphs[("step", B, S)]
    reps = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dec.step(tok)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / reps
    replay_ms = _time_ms(prog.graph.replay, reps)
    # the step's bytes: every weight but the two tables read once (B rows
    # of the embedding, one of the positions), the K/V rings read, one
    # row a ring written, the logits written
    blocks = sum(t.numel() for blk in params["blocks"] for t in blk.values())
    words = (blocks + params["ln_f"].numel() + params["head"].numel()
             + (B + 1) * lm.d_model
             + lm.n_layers * 2 * (B * S * lm.d_model + B * lm.d_model)
             + B * lm.vocab)
    bound_ms = words * 4 / 3.35e12 * 1e3
    print("[3p] (v) decode_step_ms %.4f (token copy, graph replay, logits "
          "clone; host clock, mean of %d), replay %.4f ms (CUDA events, "
          "mean of %d), byte bound %.4f ms (%.1f MB at 3.35 TB/s): %.0f "
          "tokens/s at batch %d  on %s"
          % (step_ms, reps, replay_ms, reps, bound_ms, words * 4 / 1e6,
             B * 1e3 / step_ms, B, card), flush=True)


def run_serving_path(dev, card):
    """Phase 3p (see the module docstring).  Returns the phase's K3
    launches (captures and eager warmup passes: replays launch through no
    wrapper)."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.parallel import aot
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.serve import (ContinuousBatcher,
                                                 ServeEngine, SwapRejected,
                                                 poisson_loadtest)

    t_phase = time.perf_counter()
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
           torch.backends.cudnn.deterministic,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    try:
        image = SERVE["image"]
        mx.random.seed(SEED)
        net = resnet.resnet50_v1(classes=1000, device=dev)
        net.initialize(init=mx.init.Xavier())
        net.shape_init((1, 3, image, image))
        eng = ServeEngine(net, buckets=SERVE["buckets"])
        t = eng.warmup(np.zeros((3, image, image), np.float32))
        caps = eng.capture_launches
        print("[3p] (i) warmup: eager passes %.3f s, captures %.3f s (%d "
              "bucket programs: buckets %s x 2 parameter slots); K3 "
              "launches a captured program %s  on %s" % (
                  t["eager"], t["capture"], len(caps), list(eng.buckets),
                  sorted(set(c.get("maxpool_idx_fwd", 0)
                             for c in caps.values())), card), flush=True)
        if any(c != {"maxpool_idx_fwd": 1} for c in caps.values()):
            raise AssertionError("a captured bucket program launched %s, "
                                 "want one K3" % caps)
        pool = np.random.RandomState(0).rand(
            SERVE["pool"], 3, image, image).astype(np.float32)
        batcher = ContinuousBatcher(eng, max_delay=SERVE["max_delay_ms"]
                                    / 1e3)
        try:
            torch.cuda.synchronize()
            captures = aot.CUDA_GRAPH_CAPTURES.count
            before = _kernels.launch_counts()
            rep = poisson_loadtest(batcher, lambda i, rng: pool[i % 8],
                                   qps=SERVE["qps"],
                                   n_requests=SERVE["requests"], seed=0)
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in
                     _kernels.launch_counts().items() if v != before[k]}
            captures = aot.CUDA_GRAPH_CAPTURES.count - captures
        finally:
            batcher.close()
        print("[3p] (i) %s  on %s" % (rep.format(), card), flush=True)
        print("[3p] (i) serve_qps %.2f  serve_p50_ms %.3f  serve_p95_ms %.3f"
              "  serve_p99_ms %.3f  errors %d  shed %d  hung %d  occupancy %s"
              "  captures after warmup %d (process-wide during traffic %d)  "
              "kernel launches through the wrappers during traffic %s  on %s"
              % (rep.qps_sustained, rep.p50_ms, rep.p95_ms, rep.p99_ms,
                 rep.errors, rep.shed, rep.hung,
                 dict(sorted(rep.occupancy.items())), rep.recompiles,
                 captures, moved or 0, card), flush=True)
        if rep.ok != SERVE["requests"] or rep.hung or rep.recompiles \
                or moved or captures:
            raise AssertionError("the serve leg failed: %s" % rep.format())

        _served_gates(dev, eng, pool, card)
        for b in eng.buckets:
            _split_infer(eng, np.resize(pool, (b,) + pool.shape[1:]), card)

        # (iii) swaps under traffic
        rs = np.random.RandomState(SEED + 5)
        cand = [(p._tensor.detach().cpu().numpy()
                 * (1 + 0.01 * rs.uniform(-1, 1))).astype(np.float32)
                for p in eng._params]
        batcher = ContinuousBatcher(eng, max_delay=SERVE["max_delay_ms"]
                                    / 1e3)
        try:
            futs = [batcher.submit(pool[i % 8]) for i in range(16)]
            futs[0].result(timeout=30)   # v1 has served, the rest queue
            v = eng.update_params(cand, canary=pool[:4], canary_tol=0.5)
            futs += [batcher.submit(pool[i % 8]) for i in range(16)]
            for f in futs:
                f.result(timeout=30)
            vers = sorted({f._mxtpu_version for f in futs})
            live0 = fi._live_param_snapshot(eng)
            out0 = eng.infer(pool)
            try:
                eng.update_params(fi.nan_params(eng))
                raise AssertionError("a NaN candidate was accepted")
            except SwapRejected as e:
                reason = e.reason
            live1 = fi._live_param_snapshot(eng)
            same = live0[0] == live1[0] and all(
                fi._leaves_equal(a, b) for a, b in zip(live0[1], live1[1]))
            same_out = torch.equal(eng.infer(pool), out0)
            with fi.swap_storm(eng, n_swaps=SERVE["storm_swaps"],
                               interval=0.02,
                               poison_at=SERVE["storm_swaps"] // 2,
                               seed=SEED) as st:
                storm = poisson_loadtest(
                    batcher, lambda i, rng: pool[i % 8], qps=SERVE["qps"],
                    n_requests=SERVE["requests"], seed=1)
        finally:
            batcher.close()
        print("[3p] (iii) perturbed candidate committed as v%d under "
              "traffic (versions served %s); nan_params rolled back (%s), "
              "live slot bit-equal %s, outputs bit-equal %s  on %s" % (
                  v, vers, reason, same, same_out, card), flush=True)
        print("[3p] (iii) swap_storm: %d swaps (%d committed, poisoned #%d "
              "rejected %s, incumbent bit-equal %s, error %s) under %s  on "
              "%s" % (st.attempted, st.committed, SERVE["storm_swaps"] // 2,
                      st.poison_rejected, st.incumbent_bitwise_ok, st.error,
                      storm.format(), card), flush=True)
        if not (v == 2 and vers == [1, 2] and same and same_out
                and st.poison_rejected and st.incumbent_bitwise_ok
                and st.error is None and st.committed >= 1
                and storm.hung == 0 and storm.recompiles == 0
                and storm.unattributed == 0
                and storm.ok == SERVE["requests"]
                and eng.recompile_count == 0):
            raise AssertionError("a swap under traffic failed its gate")
        del eng, batcher
        torch.cuda.empty_cache()

        # (iv) the tool's chaos leg at the same settings
        argv = ["--model", "resnet50", "--image-size", str(image),
                "--buckets", ",".join(str(b) for b in SERVE["buckets"]),
                "--qps", str(SERVE["qps"]), "--requests",
                str(SERVE["requests"]), "--max-delay",
                str(SERVE["max_delay_ms"]), "--chaos"]
        t0 = time.perf_counter()
        rc = _serve_tool().main(argv)
        print("[3p] (iv) tools/serve_bench_torch.py %s: exit %d in %.1f s  "
              "on %s" % (" ".join(argv), rc, time.perf_counter() - t0, card),
              flush=True)
        if rc != 0:
            raise AssertionError("serve_bench_torch.py --chaos failed")
        torch.cuda.empty_cache()

        _run_decoder(dev, card, "decode_small")
        _run_decoder(dev, card, "decode_wide")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark, \
            torch.backends.cudnn.deterministic, \
            torch.backends.cuda.matmul.allow_tf32 = old
    torch.cuda.synchronize()
    k3 = _kernels.launch_counts()["maxpool_idx_fwd"]
    print("[3p] K3 launches in the phase %d (eager warmup passes and "
          "captures; replays are not counted)  phase wall time %.2f s  on %s"
          % (k3, time.perf_counter() - t_phase, card), flush=True)
    return k3


# phase 3q: the int8 serve leg (bench.py's serve leg at dtype="int8")
#: the logits of the int8 engine against the f32 engine serving the
#: dequantized codes, of the largest logit (the same f32 weights run the
#: same kernels: the tier adds nothing but its prologue)
INT8_SERVE_TOL = 1e-5


def _leg_args():
    """The serve leg's settings as ``serve_bench_torch.py``'s
    ``run_leg`` reads them."""
    import argparse

    return argparse.Namespace(
        model="resnet50", buckets=",".join(str(b) for b in SERVE["buckets"]),
        qps=SERVE["qps"], requests=SERVE["requests"],
        max_delay=SERVE["max_delay_ms"], max_queue=1024, device=None, seed=0)


def run_int8_serving_path(dev, card):
    """Phase 3q (see the module docstring).  Returns the phase's K3
    launches (captures and eager warmup passes)."""
    import gc

    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.ops.quantization import (
        dequantize_tensor, quantize_tensor)
    from incubator_mxnet_tpu_torch.parallel import aot
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi
    from incubator_mxnet_tpu_torch.serve import ServeEngine, SwapRejected

    t_phase = time.perf_counter()
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
           torch.backends.cudnn.deterministic,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    tool = _serve_tool()
    args = _leg_args()
    try:
        image = SERVE["image"]
        mx.random.seed(SEED)
        net = resnet.resnet50_v1(classes=1000, device=dev)
        net.initialize(init=mx.init.Xavier())
        net.shape_init((1, 3, image, image))
        sample = np.zeros((3, image, image), np.float32)
        e32 = ServeEngine(net, buckets=SERVE["buckets"])
        e32.warmup(sample)
        e8 = ServeEngine(net, buckets=SERVE["buckets"], dtype="int8")
        t = e8.warmup(sample)
        caps = e8.capture_launches
        n_q = sum(int(np.prod(sh)) for (_n, sh, _d), q in
                  zip(e8.param_signature, e8._quantized) if q)
        print("[3q] (i) int8 warmup: eager passes %.3f s, captures %.3f s "
              "(%d bucket programs); K3 launches a captured program %s; "
              "%d of %d parameters quantized (%d weights); one slot's "
              "resident bytes int8 %d against f32 %d (the quantized weights "
              "%d bytes against %d)  on %s" % (
                  t["eager"], t["capture"], len(caps),
                  sorted(set(c.get("maxpool_idx_fwd", 0)
                             for c in caps.values())),
                  sum(e8._quantized), len(e8._quantized), n_q,
                  e8.resident_bytes, e32.resident_bytes, n_q + 4 *
                  sum(e8._quantized), 4 * n_q, card), flush=True)
        if any(c != {"maxpool_idx_fwd": 1} for c in caps.values()):
            raise AssertionError("an int8 bucket program launched %s, want "
                                 "one K3" % caps)
        # (ii) serve_bench_torch.py's --int8 leg beside its fp32 leg, the
        # same traffic; the garbage of the engines' builds collected
        # before each leg, so neither pays the other's
        torch.cuda.synchronize()
        captures = aot.CUDA_GRAPH_CAPTURES.count
        before = _kernels.launch_counts()
        gc.collect()
        rep = tool.run_leg("fp32", net, sample.shape, args, engine=e32)
        gc.collect()
        rep8 = tool.run_leg("int8", net, sample.shape, args, engine=e8)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in
                 _kernels.launch_counts().items() if v != before[k]}
        captures = aot.CUDA_GRAPH_CAPTURES.count - captures
        delta = tool.int8_delta(rep, rep8)
        print("[3q] (ii) int8 leg: serve_qps %.2f  p50 %.3f  p99 %.3f ms  "
              "(fp32 leg on the same traffic: serve_qps %.2f  p50 %.3f  p99 "
              "%.3f ms)  serve_int8_p99_delta_ms %.3f  hung %d  captures "
              "after warmup %d (process-wide during traffic %d)  launches "
              "through the wrappers during traffic %s  on %s" % (
                  rep8.qps_sustained, rep8.p50_ms, rep8.p99_ms,
                  rep.qps_sustained, rep.p50_ms, rep.p99_ms, delta,
                  rep8.hung + rep.hung, rep8.recompiles + rep.recompiles,
                  captures, moved or 0, card), flush=True)
        if rep8.ok != SERVE["requests"] or rep.ok != SERVE["requests"] \
                or rep8.hung or rep.hung or rep8.recompiles \
                or rep.recompiles or moved or captures:
            raise AssertionError("the int8 serve leg failed: %s / %s"
                                 % (rep8.format(), rep.format()))

        # (iii) codes card against CPU; logits against the f32 engine on
        # the dequantized codes
        raw = [p._tensor.detach() for p in e8._params]
        for v, q, a in zip(e8._p_vals, e8._quantized, raw):
            if q:
                codes, amax = quantize_tensor(a.cpu())
                if not (torch.equal(v[0].cpu(), codes)
                        and torch.equal(v[1].cpu(), amax)):
                    raise AssertionError("codes made on the card differ "
                                         "from the CPU's")
        x = np.random.RandomState(SEED + 7).rand(
            SERVE["buckets"][0], 3, image, image).astype(np.float32)
        out32 = e32.infer(x)
        out8 = e8.infer(x)
        info = ((out8 - out32).abs().max() / out32.abs().max()).item()
        deq = [dequantize_tensor(*v).cpu().numpy() if q
               else a.cpu().numpy()
               for v, q, a in zip(e8._p_vals, e8._quantized, raw)]
        e32.update_params(deq)
        outdq = e32.infer(x)
        err = ((out8 - outdq).abs().max() / outdq.abs().max()).item()
        print("[3q] (iii) %d quantized tensors' codes made on the card equal "
              "to the CPU's bit for bit; int8 logits against the f32 engine "
              "on the dequantized codes %.3g of the largest logit (limit "
              "%g); against the f32 weights %.4g (for information; the "
              "reference's tests hold 2-5 %%)  on %s"
              % (sum(e8._quantized), err, INT8_SERVE_TOL, info, card),
              flush=True)
        if not err <= INT8_SERVE_TOL:
            raise AssertionError("int8 logits off the dequantized f32 "
                                 "engine by %g" % err)

        # (iv) a poisoned swap on the int8 tier: NaN in a float parameter
        snap = fi._live_param_snapshot(e8)
        cand = [a.cpu().numpy().copy() for a in raw]
        k = max(i for i, q in enumerate(e8._quantized) if not q)
        cand[k].reshape(-1)[0] = np.nan
        try:
            e8.update_params(cand)
            raise AssertionError("a poisoned int8 candidate was accepted")
        except SwapRejected as e:
            reason = e.reason
        after = fi._live_param_snapshot(e8)
        same = snap[0] == after[0] and all(
            fi._leaves_equal(a, b) for a, b in zip(snap[1], after[1]))
        same_out = torch.equal(e8.infer(x), out8)
        print("[3q] (iv) NaN in %s: rolled back (%s); codes and amax "
              "bit-equal %s, outputs bit-equal %s, rollbacks %d, captures "
              "after warmup %d  on %s" % (
                  e8.param_signature[k][0], reason, same, same_out,
                  e8.rollback_count, e8.recompile_count, card), flush=True)
        if not (same and same_out and e8.recompile_count == 0):
            raise AssertionError("the poisoned int8 swap changed the "
                                 "incumbent")
        del e8, e32
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark, \
            torch.backends.cudnn.deterministic, \
            torch.backends.cuda.matmul.allow_tf32 = old
    torch.cuda.synchronize()
    k3 = _kernels.launch_counts()["maxpool_idx_fwd"]
    print("[3q] K3 launches in the phase %d  phase wall time %.2f s  on %s"
          % (k3, time.perf_counter() - t_phase, card), flush=True)
    return k3


# phase 3r: bench.py --mode infer-int8 in the port
INT8_INFER = dict(batch=128, image=224, iters=20, chunks=3, gate_batch=8,
                  nudge=1e-6)


def _first_qconv(sym):
    for node in sym._all_nodes():
        if node.op == "_contrib_quantized_conv":
            return node.name
    raise AssertionError("no quantized convolution in the graph")


def _int8_forward(mx, sym, args, aux, x, ctx, watch=None):
    """One forward of ``sym`` on ``ctx``; with ``watch``, also the output
    of that node (its int32 accumulator) through the monitor callback."""
    binds = {k: mx.nd.array(v, ctx=ctx) for k, v in args.items()}
    binds["data"] = mx.nd.array(x, ctx=ctx)
    exe = sym.bind(ctx, args=binds,
                   aux_states={k: mx.nd.array(v, ctx=ctx)
                               for k, v in aux.items()})
    seen = {}
    if watch is not None:
        def callback(name, arr):
            if name == watch + "_output":
                seen["acc"] = arr._data.detach().cpu().clone()
        exe.set_monitor_callback(callback)
    out = exe.forward(is_train=False)[0]._data.detach().float().cpu()
    return out, seen.get("acc")


def run_int8_infer_path(dev, card):
    """Phase 3r (see the module docstring).  Returns the phase's K3
    launches."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.contrib.quantization import (
        fold_batch_norm, quantize_model)
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    t_phase = time.perf_counter()
    cfg = INT8_INFER
    _kernels.reset_launch_counts()
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000, device=dev)
    net.initialize(init=mx.init.Xavier())
    net.shape_init((1, 3, cfg["image"], cfg["image"]))
    directory = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    try:
        prefix = os.path.join(directory, "r50")
        net.export(prefix)
        sym, args, aux = mx.model.load_checkpoint(prefix, 0, ctx=dev)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    del net
    t0 = time.perf_counter()
    fsym, fargs, faux = fold_batch_norm(sym, args, aux)
    qsym, qargs, qaux = quantize_model(fsym, fargs, faux, calib_mode="none")
    j = qsym.tojson()
    print("[3r] export, fold_batch_norm and quantize_model(calib_mode="
          "'none') %.2f s: %d quantized convolutions, %d quantized dense, "
          "%d requantize, %d quantized residual adds, %d dequantize  on %s"
          % (time.perf_counter() - t0, j.count('"_contrib_quantized_conv"'),
             j.count('"_contrib_quantized_fully_connected"'),
             j.count('"_contrib_requantize"'),
             j.count('"_contrib_quantized_elemwise_add"'),
             j.count('"_contrib_dequantize"'), card), flush=True)
    xnp = np.random.RandomState(0).uniform(
        size=(cfg["batch"], 3, cfg["image"], cfg["image"])).astype(np.float32)
    results, k3_per = {}, {}
    for tag, (s_, a_, au_) in (("bf16", (fsym, fargs, faux)),
                               ("int8", (qsym, qargs, qaux))):
        if tag == "bf16":
            a_ = {k: v.astype("bfloat16") if str(v.dtype).startswith("f")
                  else v for k, v in a_.items()}
        binds = dict(a_)
        binds["data"] = mx.nd.array(xnp, ctx=dev)
        if tag == "bf16":
            binds["data"] = binds["data"].astype("bfloat16")
        exe = s_.bind(dev, args=binds, aux_states=au_)
        t = time.perf_counter()
        before = _kernels.launch_counts()["maxpool_idx_fwd"]
        (out,) = exe.forward(is_train=False)
        torch.cuda.synchronize()
        k3_per[tag] = _kernels.launch_counts()["maxpool_idx_fwd"] - before
        first = time.perf_counter() - t
        if not torch.isfinite(out._data).all() or \
                tuple(out.shape) != (cfg["batch"], 1000):
            raise AssertionError("%s forward: %s, finite %s" % (
                tag, tuple(out.shape), bool(torch.isfinite(out._data).all())))
        best = 0.0
        for _ in range(cfg["chunks"]):
            t = time.perf_counter()
            for _ in range(cfg["iters"]):
                (out,) = exe.forward(is_train=False)
            torch.cuda.synchronize()
            best = max(best, cfg["iters"] * cfg["batch"]
                       / (time.perf_counter() - t))
        results[tag] = best
        print("[3r] %s: first forward %.2f s, best of %d chunks of %d "
              "forwards %.1f img/s (%.2f ms a forward), K3 launches a "
              "forward %d  on %s" % (tag, first, cfg["chunks"], cfg["iters"],
                                     best, cfg["batch"] / best * 1e3,
                                     k3_per[tag], card), flush=True)
        del exe, binds, out
        torch.cuda.empty_cache()
    print("[3r] resnet50_int8_infer_img_per_sec %.1f  bf16_img_per_sec %.1f"
          "  int8_over_bf16 %.3f  (batch %d, %d px)  on %s" % (
              results["int8"], results["bf16"],
              results["int8"] / results["bf16"], cfg["batch"], cfg["image"],
              card), flush=True)
    if k3_per != {"bf16": 1, "int8": 0}:
        raise AssertionError("K3 launches a forward %s, want bf16 1 (the "
                             "stem pool) and int8 0 (the reference pools "
                             "int8 codes outside its kernel)" % k3_per)

    # gates at batch 8: the card and the CPU see the same batch, since
    # quantize_v2's dynamic range is the whole batch's
    n = cfg["gate_batch"]
    x = xnp[:n]
    host = {k: v.asnumpy() for k, v in qargs.items()}
    host_aux = {k: v.asnumpy() for k, v in qaux.items()}
    watch = _first_qconv(qsym)
    cpu = mx.cpu()
    t0 = time.perf_counter()
    got, acc_card = _int8_forward(mx, qsym, host, host_aux, x, dev, watch)
    want, acc_cpu = _int8_forward(mx, qsym, host, host_aux, x, cpu, watch)
    nudged = (x * (1.0 + cfg["nudge"])).astype(np.float32)
    again, _ = _int8_forward(mx, qsym, host, host_aux, nudged, cpu)
    scale = want.abs().max().item()
    floor = (again - want).abs().max().item() / scale
    err = (got - want).abs().max().item() / scale
    print("[3r] batch %d: %s's int32 accumulator %s card against CPU bit "
          "for bit %s; logits card against CPU %.4g of the largest logit, "
          "the CPU's own floor (input nudged by %g) %.4g; %.1f s  on %s"
          % (n, watch, tuple(acc_cpu.shape), torch.equal(acc_card, acc_cpu),
             err, cfg["nudge"], floor, time.perf_counter() - t0, card),
          flush=True)
    if not torch.equal(acc_card, acc_cpu) or acc_card.dtype != torch.int32:
        raise AssertionError("the first quantized convolution's accumulator "
                             "differs between the card and the CPU")
    if not err <= max(floor, 1e-6):
        raise AssertionError("int8 logits card against CPU %g beyond the "
                             "floor %g" % (err, floor))
    torch.cuda.empty_cache()
    k3 = _kernels.launch_counts()["maxpool_idx_fwd"]
    print("[3r] K3 launches in the phase %d  phase wall time %.2f s  on %s"
          % (k3, time.perf_counter() - t_phase, card), flush=True)
    return k3


# phase 3s: tools/flywheel_torch.py on the card
def _flywheel_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_flywheel_torch", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tools",
            "flywheel_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_flywheel_path(card):
    """Phase 3s (see the module docstring)."""
    import contextlib
    import io

    t_phase = time.perf_counter()
    tool = _flywheel_tool()
    for chaos in (None, "loss_bomb", "swap_storm"):
        argv = [] if chaos is None else ["--chaos", chaos]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(argv)
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        storm = rec.get("swap_storm") or {}
        print("[3s] tools/flywheel_torch.py %s: exit %d in %.1f s; trained "
              "%s steps (rollbacks %s), promoted steps %s, quarantined %s, "
              "serving version %d, serving rollbacks %d, captures after "
              "warmup %d%s  on %s" % (
                  " ".join(argv) or "(defaults)", rc,
                  time.perf_counter() - t0, rec["trained_steps"],
                  rec["train_rollbacks"], rec["promoted"], rec["quarantined"],
                  rec["serving_version"], rec["serving_rollbacks"],
                  rec["recompiles"],
                  "; storm p99 %.3f ms (bound %.3f), %d committed, versions "
                  "%s, unattributed %d" % (
                      storm["p99_ms"], storm["bound_ms"], storm["committed"],
                      storm["versions"], storm["unattributed"])
                  if storm else "", card), flush=True)
        if rc != 0 or rec["failures"] or rec["device"] != "cuda:0":
            raise AssertionError("flywheel %s failed: %s"
                                 % (chaos, rec["failures"]))
        if chaos == "loss_bomb" and not (
                rec["quarantined"] and rec["quarantined"][-1][1] == "metric"
                and rec["serving_rollbacks"] == 0
                and rec["quarantined"][-1][0] not in rec["promoted"]):
            raise AssertionError("the bombed checkpoint was not quarantined "
                                 "at the metric stage")
        if chaos == "swap_storm" and not (
                storm["unattributed"] == 0 and storm["committed"] > 0):
            raise AssertionError("the storm left rows without one version")
    print("[3s] phase wall time %.2f s  on %s"
          % (time.perf_counter() - t_phase, card), flush=True)


# phase 3t: Estimator.fit over a RecordIO DataLoader at config 2's width;
# the spawned-worker loader; the contrib layers; the symbolic bodies
ESTIMATOR = dict(model="resnet50_v1", batch=64, classes=1000, lr=0.05,
                 workers=4, val_images=64, spawn_workers=2,
                 spawn_batches=4, loader_batches=3)
#: ImageNet's channel means and deviations (the Normalize of the loader)
MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
#: phase 3t (iii): the deformable convolution's shape and timing reps
DEFORM = dict(batch=8, channels=64, size=56, kernel=3, groups=2, reps=10)


def _estimator_loader(prefix, dev, train=True, workers=0,
                      thread_pool=True, images=None):
    """Phase 3t's loaders over phase 3d's shard: training (shuffled,
    ``RandomResizedCrop``, ``RandomFlipLeftRight``, ``ToTensor``,
    ``Normalize``, the last short batch dropped) or the fixed transforms
    (``ToTensor``, ``Normalize``) in the shard's order over its first
    ``images`` records."""
    from incubator_mxnet_tpu_torch.gluon.data import DataLoader
    from incubator_mxnet_tpu_torch.gluon.data.vision import (
        ImageRecordDataset, transforms as T)

    ds = ImageRecordDataset(prefix + ".rec")
    tail = [T.ToTensor(), T.Normalize(*MEAN_STD)]
    if train:
        return DataLoader(
            ds.transform_first(T.Compose(
                [T.RandomResizedCrop(IMAGE), T.RandomFlipLeftRight()]
                + tail)),
            batch_size=ESTIMATOR["batch"], shuffle=True,
            last_batch="discard", num_workers=workers,
            thread_pool=thread_pool, device=dev)
    return DataLoader(ds.take(images).transform_first(T.Compose(tail)),
                      batch_size=ESTIMATOR["batch"], num_workers=workers,
                      thread_pool=thread_pool, device=dev)


def _first_batches(loader, n):
    """The first ``n`` batches of a pass and the host ms of each
    ``next()`` (the card synchronized after it)."""
    import torch

    out, ms = [], []
    it = iter(loader)
    for _ in range(n):
        t0 = time.perf_counter()
        b = next(it)
        if b[0].context.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(b)
    return out, ms


def run_estimator_path(dev, directory):
    """Phase 3t (i)-(ii), see the module docstring.  Returns (metrics,
    the launch counts of the fit)."""
    import random

    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import _kernels, gluon, metric
    from incubator_mxnet_tpu_torch.gluon.contrib import estimator as est_mod

    e = ESTIMATOR
    prefix, _, _ = write_shard(directory)
    ex = _gluon_module()
    torch.backends.cudnn.benchmark = True
    args = _gluon_args(ex, e["model"], e["batch"], IMAGE, e["classes"],
                       e["lr"], e["batch"])
    net = ex.build_net(args, dev)
    est = est_mod.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                            metrics=metric.Accuracy(),
                            trainer=ex.build_trainer(net, args), context=dev)
    np.random.seed(SEED)
    random.seed(SEED)
    train = _estimator_loader(prefix, dev, workers=e["workers"])
    val = _estimator_loader(prefix, dev, train=False, workers=e["workers"],
                            images=e["val_images"])
    ckpt_dir = os.path.join(directory, "estimator_checkpoints")
    watch = {"losses": [], "begin": [], "end": [], "k3": [], "bad": []}

    class Watch(est_mod.BatchBegin, est_mod.BatchEnd):
        """Times each batch, checks it and its launches."""

        def batch_begin(self, estimator, *a, batch=None, **kw):
            torch.cuda.synchronize()
            watch["begin"].append(time.perf_counter())
            x = batch[0]
            if (x.shape != (e["batch"], 3, IMAGE, IMAGE)
                    or x.dtype != np.float32 or x.context != dev):
                watch["bad"].append((x.shape, x.dtype, x.context))
            watch["k3_before"] = _kernels.launch_counts()

        def batch_end(self, estimator, *a, loss=None, **kw):
            torch.cuda.synchronize()
            watch["end"].append(time.perf_counter())
            watch["losses"].append(float(loss[0].asnumpy().mean()))
            now = _kernels.launch_counts()
            watch["k3"].append({k: now[k] - watch["k3_before"][k]
                                for k in now})

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(train, val_data=val, epochs=1, event_handlers=[
        Watch(), est_mod.CheckpointHandler(ckpt_dir,
                                           model_prefix=e["model"])])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    n_train = len(watch["losses"])
    n_val = -(-e["val_images"] // e["batch"])
    if watch["bad"]:
        raise AssertionError("batches off shape, dtype or device: %s"
                             % watch["bad"][:3])
    if n_train != RECORDS // e["batch"] or not _losses_ok(watch["losses"]):
        raise AssertionError("estimator losses %s" % watch["losses"])
    per_batch = {k: 1 if k == "maxpool_idx_fwd" else 0 for k in counts}
    if any(got != per_batch for got in watch["k3"]):
        raise AssertionError("a train batch launched %s, want %s"
                             % (watch["k3"], per_batch))
    want = {k: (n_train + n_val) * v for k, v in per_batch.items()}
    if counts != want:
        raise AssertionError("the fit launched %s, want %s (%d train and "
                             "%d validation forwards)"
                             % (counts, want, n_train, n_val))
    print("  %s, batch %d, %d px, %d classes, Trainer sgd lr %g momentum "
          "0.9, Accuracy, CheckpointHandler; %d train batches (4 thread "
          "workers) and %d validation: losses %s  %s  validation %s  fit "
          "%.2f s  K3 launches %d" % (
              e["model"], e["batch"], IMAGE, e["classes"], e["lr"], n_train,
              n_val, ["%.4f" % v for v in watch["losses"]],
              est.train_metrics[0].get(), est.val_metrics[0].get(), fit_s,
              counts["maxpool_idx_fwd"]), flush=True)
    compute = [(b - a) * 1e3 for a, b in zip(watch["begin"], watch["end"])]
    steps = [(b - a) * 1e3 for a, b in zip(watch["end"], watch["end"][1:])]
    waits = [(b - a) * 1e3 for a, b in zip(watch["end"], watch["begin"][1:])]

    # the checkpoint into a fresh net on the CPU, bit for bit
    files = sorted(os.listdir(ckpt_dir))
    want_files = ["%s-epoch0.params" % e["model"],
                  "%s-epoch0.states" % e["model"]]
    if files != want_files:
        raise AssertionError("checkpoint files %s, want %s"
                             % (files, want_files))
    fresh = ex.build_net(args, "cpu")
    fresh.load_parameters(os.path.join(ckpt_dir, want_files[0]))
    mine = net._collect_params_with_prefix()
    theirs = fresh._collect_params_with_prefix()
    differ = [k for k in mine if not torch.equal(
        mine[k].data()._data.cpu(), theirs[k].data()._data)]
    if sorted(mine) != sorted(theirs) or differ:
        raise AssertionError("the checkpoint reloads with %d of %d tensors "
                             "differing: %s" % (len(differ), len(mine),
                                                differ[:4]))
    print("  checkpoint %s (%d bytes) reloads into a fresh CPU net: all %d "
          "tensors bit for bit" % (
              files, sum(os.path.getsize(os.path.join(ckpt_dir, f))
                         for f in files), len(mine)), flush=True)
    del net, est, fresh, train, val
    torch.cuda.empty_cache()

    # the loader alone: 0 workers on the card, its first batch rebuilt on
    # the CPU under the same seeds; then 4 thread workers
    loader_ms = {}
    firsts = {}
    for where in (dev, "cpu"):
        np.random.seed(SEED + 1)
        random.seed(SEED + 1)
        batches, ms = _first_batches(
            _estimator_loader(prefix, where), e["loader_batches"])
        firsts[str(where)] = [t.asnumpy() for t in batches[0]]
        if where == dev:
            loader_ms[0] = _median(ms)
    diff = max(float(np.abs(a - b).max()) for a, b in
               zip(firsts[str(dev)], firsts["cpu"]))
    if diff != 0:
        raise AssertionError("the first batch on the card differs from its "
                             "CPU rebuild by %g" % diff)
    # a whole pass over the worker threads a batch (they start 8 batches
    # ahead, so a single next() after the first does not wait)
    threads = _estimator_loader(prefix, dev, workers=e["workers"])
    _, ms = _first_batches(threads, len(threads))
    loader_ms[e["workers"]] = sum(ms) / len(ms)
    del threads
    print("  first batch of a 0-worker loader on the card equal to its CPU "
          "rebuild under the same seeds (max abs diff %g; the 4 thread "
          "workers draw from one Python random in no fixed order)" % diff,
          flush=True)

    # (ii) spawned workers: the thread loader's batches, no CUDA context
    images = e["spawn_batches"] * e["batch"]
    t0 = time.perf_counter()
    spawned = _estimator_loader(prefix, dev, train=False,
                                workers=e["spawn_workers"],
                                thread_pool=False, images=images)
    got, _ = _first_batches(spawned, len(spawned))
    spawn_s = time.perf_counter() - t0
    cuda = spawned.worker_cuda_initialized()
    del spawned
    import gc
    import multiprocessing

    gc.collect()
    want_b, _ = _first_batches(_estimator_loader(
        prefix, dev, train=False, workers=e["workers"], images=images),
        e["spawn_batches"])
    same = all(torch.equal(a._data, b._data) for ga, gb in zip(got, want_b)
               for a, b in zip(ga, gb))
    if len(got) != e["spawn_batches"] or not same:
        raise AssertionError("the spawned loader's batches differ from the "
                             "thread loader's")
    if not cuda or any(cuda.values()):
        raise AssertionError("spawned workers' torch.cuda.is_initialized(): "
                             "%s" % cuda)
    left = multiprocessing.active_children()
    for p in left:
        p.join(timeout=10)
    if any(p.is_alive() for p in left):
        raise AssertionError("spawned workers left running: %s" % left)
    print("  spawned loader (thread_pool=False, %d workers, %d batches of "
          "%d): the thread loader's batches bit for bit in %.2f s (start "
          "included); torch.cuda.is_initialized() in the %d workers that "
          "reported: %s; none left running" % (
              e["spawn_workers"], e["spawn_batches"], e["batch"], spawn_s,
              len(cuda), sorted(cuda.values())), flush=True)
    return {"estimator_step_ms": _median(steps[1:]),
            "estimator_compute_ms": _median(compute[2:]),
            "estimator_wait_ms": _median(waits[1:]),
            "loader_batch_ms_0": loader_ms[0],
            "loader_batch_ms_%d" % e["workers"]: loader_ms[e["workers"]],
            "fit_s": fit_s, "spawn_s": spawn_s}, counts


def _nudged(arrays, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [(a * (1 + 1e-6 * rng.normal(size=a.shape))).astype(a.dtype)
            for a in arrays]


def _fwd_bwd(fn, arrays, device, nudge=False):
    """``fn`` of the arrays as tensors on ``device`` (the floating ones
    leaf tensors with a gradient), the sum of its floating outputs
    weighted by fixed random cotangents differentiated: [outputs...,
    gradients of the floating inputs...] on the host (no gradients where
    no output has one).  ``nudge`` scales the floating arrays and the
    cotangents by 1 + 1e-6 * N(0, 1) elementwise."""
    import numpy as np
    import torch

    flt = [np.issubdtype(np.asarray(a).dtype, np.floating) for a in arrays]
    if nudge:
        arrays = [n if f else a for n, f, a in
                  zip(_nudged([np.asarray(a) if f else
                               np.zeros(1, np.float32)
                               for a, f in zip(arrays, flt)], 2),
                      flt, arrays)]
    ts = [torch.tensor(np.asarray(a), device=device, requires_grad=f)
          for a, f in zip(arrays, flt)]
    outs = fn(*ts)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    rng = np.random.RandomState(1)
    cots = [rng.uniform(-1, 1, tuple(o.shape)).astype(np.float32)
            for o in outs]
    if nudge:
        cots = _nudged(cots, 3)
    live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    grads = []
    if live:
        total = sum((o * torch.tensor(c, device=device).to(o.dtype)).sum()
                    for o, c in live)
        leaves = [t for t in ts if t.requires_grad]
        got = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, got)]
    return [o.detach().cpu() for o in outs] + \
        [g.detach().cpu() for g in grads]


def _card_vs_cpu(name, fn_of, arrays, dev, readings=None, controls=None):
    """``fn_of(device)`` on the card and on the CPU from the same arrays,
    and on the CPU from the arrays and the cotangent nudged by 1e-6: each
    floating output and input gradient card-vs-CPU within 4x the nudged
    run's difference, each integer output equal.  Returns (the number of
    tensors, the worst ratio); appends (card-vs-CPU, floor) of each
    floating tensor to ``readings`` where given.  Where ``controls`` is a
    list, each floating tensor with a nonzero value is also made zero,
    doubled and negated on the card, each of which must miss, and
    (tensor, factor) of each is appended to it."""
    import torch

    card = _fwd_bwd(fn_of(dev), arrays, dev)
    cpu = _fwd_bwd(fn_of("cpu"), arrays, "cpu")
    nudged = _fwd_bwd(fn_of("cpu"), arrays, "cpu", nudge=True)
    if len(card) != len(cpu):
        raise AssertionError("%s: %d tensors on the card, %d on the CPU"
                             % (name, len(card), len(cpu)))
    worst = 0.0
    for i, (a, b, c) in enumerate(zip(card, cpu, nudged)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError("%s tensor %d: %s %s on the card, %s %s on "
                                 "the CPU" % (name, i, a.dtype, tuple(
                                     a.shape), b.dtype, tuple(b.shape)))
        if not b.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError("%s tensor %d differs" % (name, i))
            continue
        err, floor = _max_err(a, b), _max_err(c, b)
        if readings is not None:
            readings.append((err, floor))
        if not err <= 4 * floor:
            raise AssertionError("%s tensor %d: card-vs-CPU %g over 4x the "
                                 "nudged floor %g" % (name, i, err, floor))
        worst = max(worst, err / floor if floor else 0.0)
        if controls is not None and bool((a != 0).any()):
            for f in (0.0, 2.0, -1.0):
                if not _max_err(a * f, b) > 4 * floor:
                    raise AssertionError("%s tensor %d: the gate passes the "
                                         "card's value times %g" % (name, i,
                                                                    f))
                controls.append((i, f))
    return len(card), worst


def _print_card_vs_cpu(name, n, worst):
    print("  %-40s %d tensors (outputs, input gradients): card-vs-CPU at "
          "most %.3fx the nudged CPU floor (limit 4x)" % (name, n, worst),
          flush=True)


def _block_on(make, call):
    """``device -> fn``: the block ``make()`` builds, on ``device``, with
    one set of Xavier weights (seed ``SEED``), called by ``call``."""
    import torch

    from incubator_mxnet_tpu_torch import context, convert, initializer

    with context.device_scope("cpu"):
        proto = make()
    initializer.initialize(proto, initializer.Xavier(),
                           torch.Generator().manual_seed(SEED))
    weights = convert.params_to_numpy(proto)

    def of(device):
        with context.device_scope(device):
            blk = make()
        convert.params_from_jax(blk, weights)
        return lambda *a: call(blk, *a)
    return of


def _hconcat(contrib, nn):
    net = contrib.nn.HybridConcurrent(axis=1)
    net.add(nn.Dense(24, in_units=32), contrib.nn.Identity(),
            nn.Dense(8, in_units=32, activation="tanh"))
    return net


def contrib_card_vs_cpu(dev):
    """Phase 3t (iii), see the module docstring.  Returns the timings."""
    import numpy as np
    import torch
    import torch.nn.functional as tF

    from incubator_mxnet_tpu_torch.gluon import contrib, nn
    from incubator_mxnet_tpu_torch.ops import registry

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    d = DEFORM
    n, c, s, k, g = (d["batch"], d["channels"], d["size"], d["kernel"],
                     d["groups"])
    rng = np.random.RandomState(SEED + 5)
    x = rng.uniform(-1, 1, (n, c, s, s)).astype(np.float32)
    off = rng.uniform(-2, 2, (n, 2 * g * k * k, s, s)).astype(np.float32)
    w = (rng.normal(0, 1, (c, c, k, k)) / (c * k * k) ** 0.5).astype(
        np.float32)
    b = rng.normal(0, 0.1, c).astype(np.float32)
    deform = registry.get_op("_contrib_DeformableConvolution").fn
    attrs = dict(kernel=(k, k), num_filter=c, pad=(1, 1),
                 num_deformable_group=g)
    _print_card_vs_cpu("DeformableConvolution op", *_card_vs_cpu(
        "DeformableConvolution op", lambda _: (
            lambda *a: deform(*a, **attrs)), [x, off, w, b], dev))

    def unrolled(blk, xx):
        return blk.unroll(4, xx, merge_outputs=True)[0]

    cases = [
        ("PixelShuffle2D(2)", lambda: contrib.nn.PixelShuffle2D(2),
         lambda blk, xx: blk(xx), (4, 16, 7, 9)),
        ("HybridConcurrent(Dense, Identity, Dense)",
         lambda: _hconcat(contrib, nn), lambda blk, xx: blk(xx), (16, 32)),
        ("Conv2DLSTMCell unrolled 4 steps",
         lambda: contrib.rnn.Conv2DLSTMCell((8, 12, 12), 16, 3, 3),
         unrolled, (4, 4, 8, 12, 12)),
        ("LSTMPCell unrolled 4 steps",
         lambda: contrib.rnn.LSTMPCell(64, 32, input_size=48), unrolled,
         (8, 4, 48)),
    ]
    for name, make, call, shape in cases:
        _print_card_vs_cpu(name, *_card_vs_cpu(
            name, _block_on(make, call),
            [rng.uniform(-1, 1, shape).astype(np.float32)], dev))

    # the deformable op beside F.conv2d of its shape, CUDA events
    args = [torch.tensor(a, device=dev) for a in (x, off, w, b)]
    grads = [a.clone().requires_grad_() for a in args]
    cot = torch.ones(n, c, s, s, device=dev)
    out = {
        "deform_conv_ms": _time_ms(lambda: deform(*args, **attrs),
                                   d["reps"]),
        "conv2d_ms": _time_ms(lambda: tF.conv2d(args[0], args[2], args[3],
                                                padding=1), d["reps"]),
        "deform_conv_fwd_bwd_ms": _time_ms(
            lambda: deform(*grads, **attrs).backward(cot), d["reps"]),
        "conv2d_fwd_bwd_ms": _time_ms(
            lambda: tF.conv2d(grads[0], grads[2], grads[3],
                              padding=1).backward(cot), d["reps"])}
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32
    return out


def symbolic_bodies_on_card(dev):
    """Phase 3t (iv), see the module docstring."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import context, initializer

    rng = np.random.RandomState(SEED + 6)
    pred = rng.normal(0, 2, (64, 1000)).astype(np.float32)
    label = rng.randint(0, 1000, 64).astype(np.float32)
    with context.device_scope(dev):
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.name.NameManager():
        graph = loss(mx.sym.var("pred"), mx.sym.var("label"))
    exe = graph.bind(dev, {"pred": mx.nd.array(pred, ctx=dev),
                           "label": mx.nd.array(label, ctx=dev)})
    got = exe.forward()[0]
    want = loss(mx.nd.array(pred, ctx=dev), mx.nd.array(label, ctx=dev))
    _check("SoftmaxCrossEntropyLoss: Executor vs Gluon", got._data,
           want._data, 1e-6)

    with context.device_scope(dev):
        cell = mx.gluon.rnn.SequentialRNNCell()
        cell.add(mx.gluon.rnn.LSTMCell(64, input_size=32))
        cell.add(mx.gluon.rnn.LSTMCell(48, input_size=64))
    initializer.initialize(cell, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(SEED))
    names = ["h0", "c0", "h1", "c1"]
    with mx.name.NameManager():
        out, new = cell(mx.sym.var("x"), [mx.sym.var(v) for v in names])
    graph = mx.sym.Group([out] + list(new))
    feeds = {"x": rng.uniform(-1, 1, (16, 32)).astype(np.float32)}
    for v, width in zip(names, (64, 64, 48, 48)):
        feeds[v] = rng.uniform(-1, 1, (16, width)).astype(np.float32)
    args = {k: mx.nd.array(v, ctx=dev) for k, v in feeds.items()}
    args.update({p.name: p.data() for p in cell.collect_params().values()})
    outs = graph.bind(dev, args).forward()
    eager_out, eager_states = cell(args["x"], [args[v] for v in names])
    for i, (a, b) in enumerate(zip(outs, [eager_out] + list(eager_states))):
        _check("SequentialRNNCell(2 LSTMCell) output %d: Executor vs eager"
               % i, a._data, b._data, 1e-6)


# phase 3u: contrib.amp on the Gluon loop and on the exported graph, and
# the op tail and the rest of gluon.nn card against CPU
AMP = dict(steps=8, cpu_batch=8, convert_batch=64, convert_reps=10,
           floors=3, fp16_steps=6)
#: the AMP step's card-vs-CPU readings (``_amp_step_diffs``)
AMP_READINGS = ("loss", "logits", "stats", "upd_cos", "upd_norm",
                "upd_cos_median", "upd_norm_median")
#: those held at phase 3g's full size: there a 1e-6 nudge turns a bf16
#: update's direction by 0.63-0.71 in 1 - cosine (run on an H100), so 4x
#: that floor passes any direction; its norm moves by 1-2 %
AMP_HELD_FULL = ("loss", "logits", "stats", "upd_norm", "upd_norm_median")
#: a size at which the direction is held too (a 1e-6 nudge turns the
#: update by 0.04-0.05 in 1 - cosine): a negated update misses the gate
AMP_SMALL = dict(model="resnet18_v1", batch=8, image=64, classes=10)
#: amp_cast nodes in the converted resnet50_v1(ghost_bn=16) graph: two on
#: each of its 53 convolutions and three on the dense head, the
#: reference's count (tests/test_torch_amp.py holds the graph to the
#: reference's node for node)
AMP_CASTS = 53 * 2 + 3
#: the converted graph's bf16 logits against the f32 graph's: within this
#: share of the f32 logits' largest magnitude (53 convolutions each
#: rounding its inputs to 8 significant bits)
AMP_LOGIT_TOL = 0.05
#: the nudge of the AMP step's CPU floors (relative, every weight), as
#: phase 5's: it moves a weight's bf16 cast in about 1 case in 4000
AMP_NUDGE = 1e-6


def _dtype_hooks(net):
    """Forward hooks recording each Conv2D, Dense and BatchNorm output's
    dtype by module name; returns (records, handles)."""
    from incubator_mxnet_tpu_torch.gluon import nn

    seen, handles = {}, []
    for name, m in net.named_modules():
        if isinstance(m, (nn.Conv2D, nn.Dense, nn.BatchNorm)):
            handles.append(m.register_forward_hook(
                lambda mod, inp, out, n=name: seen.__setitem__(
                    n, (type(mod).__name__, out.dtype))))
    return seen, handles


def _check_amp_dtypes(seen):
    """Every Conv2D and Dense output bf16, every BatchNorm output f32;
    returns the count of each."""
    import torch

    want = {"Conv2D": torch.bfloat16, "Dense": torch.bfloat16,
            "BatchNorm": torch.float32}
    bad = {n: (k, str(d)) for n, (k, d) in seen.items() if d != want[k]}
    if bad:
        raise AssertionError("AMP output dtypes %s" % bad)
    counts = {}
    for k, _ in seen.values():
        counts[k] = counts.get(k, 0) + 1
    return counts


def run_amp_path(dev):
    """Phase 3u (i), see the module docstring.  Returns (metrics,
    counts)."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels, gluon, metric
    from incubator_mxnet_tpu_torch.contrib import amp

    ex = _gluon_module()
    torch.backends.cudnn.benchmark = True
    g = GLUON
    args = _gluon_args(ex, g["model"], g["batch"], g["image"], g["classes"],
                       g["lr"], g["batch"] * AMP["steps"])
    args.amp = "bfloat16"
    amp.init(args.amp)
    try:
        net = ex.build_net(args, dev)
        it = ex.build_data(args, dev)
        trainer = ex.build_trainer(net, args)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        acc = metric.Accuracy()
        seen, handles = _dtype_hooks(net)
        losses, step_ms, loss_dtypes = [], [], set()
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        prev = _kernels.launch_counts()
        for i, batch in enumerate(it, 1):
            t = time.perf_counter()
            loss = ex.train_batch(net, trainer, loss_fn, acc, batch.data[0],
                                  batch.label[0], args.batch_size)
            losses.append(float(loss.asscalar()))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            loss_dtypes.add(str(loss.dtype))
            if i == 1:
                for h in handles:
                    h.remove()
            counts = _kernels.launch_counts()
            got = {k: counts[k] - prev[k] for k in counts}
            want = {k: int(k == "maxpool_idx_fwd") for k in counts}
            if got != want:
                raise AssertionError("AMP step %d launched %s, want %s"
                                     % (i, got, want))
            prev = counts
        layers = _check_amp_dtypes(seen)
        scale = trainer._amp_loss_scaler.loss_scale
    finally:
        amp.disable()
    if len(losses) != AMP["steps"] or not _losses_ok(losses) \
            or loss_dtypes != {"float32"}:
        raise AssertionError("AMP path losses %s (%s)" % (losses,
                                                         loss_dtypes))
    print("  %s under amp.init('bfloat16'), batch %d, %d px, %d classes, "
          "lr %g: outputs bf16 in %d Conv2D and %d Dense, f32 in %d "
          "BatchNorm, the loss f32; loss scale %g" % (
              args.model, args.batch_size, args.image_size,
              args.num_classes, args.lr, layers.get("Conv2D", 0),
              layers.get("Dense", 0), layers.get("BatchNorm", 0), scale),
          flush=True)
    print("  losses %s  %s  step_ms %s" % (
        ["%.4f" % v for v in losses], acc.get(),
        ["%.1f" % v for v in step_ms]), flush=True)
    steady = _median(step_ms[2:])
    del net, it, trainer
    torch.cuda.empty_cache()
    return {"amp_step_ms": steady,
            "amp_img_s": args.batch_size / steady * 1e3}, prev


def _amp_step_diffs(a, r):
    """Run ``a``'s first AMP step against the CPU's, ``r``: the loss's and
    the logits' largest difference, the running stats' (of each tensor's
    largest magnitude, at least 1), and of the updates one minus their
    cosine and |ln| of their norm ratio, over the whole model's update
    (``upd_cos``, ``upd_norm``) and the median over its tensors
    (``*_median``).  An update of norm 0 has cosine 0 and ratio 0."""
    import numpy as np

    def cos_norm(u, v):
        u, v = u.astype(np.float64).ravel(), v.astype(np.float64).ravel()
        nu, nv = float(np.linalg.norm(u)), float(np.linalg.norm(v))
        if not nu:
            return 1.0, float("inf")
        return 1.0 - float(u @ v) / (nu * nv), abs(float(np.log(nu / nv)))

    live = [i for i, t in enumerate(r["trained"])
            if t and np.any(r["update"][i])]
    per = [cos_norm(a["update"][i], r["update"][i]) for i in live]
    whole = cos_norm(*(np.concatenate([d["update"][i].ravel() for i in live])
                       for d in (a, r)))
    stats = max(float(np.abs(u - w).max()) / max(1.0, float(np.abs(w).max()))
                for t, u, w in zip(r["trained"], a["after"], r["after"])
                if not t)
    return dict(loss=abs(a["loss"] - r["loss"]),
                logits=float(np.abs(a["logits"] - r["logits"]).max()),
                stats=stats, upd_cos=whole[0], upd_norm=whole[1],
                upd_cos_median=float(np.median([c for c, _ in per])),
                upd_norm_median=float(np.median([n for _, n in per])))


def _amp_gate_misses(got, floors, held):
    """The readings of ``held`` over 4x the largest of the floors'."""
    return [k for k in held if not got[k] <= 4 * max(f[k] for f in floors)]


def amp_card_vs_cpu(dev, model=None, batch=None, image=None, classes=None,
                    held=AMP_READINGS):
    """Phase 3u (i), the first step card against CPU, see the module
    docstring: the readings of ``held`` within 4x the largest floor; the
    card's update made zero or doubled must miss that gate, and negated
    too where the update's cosine is held.  Returns (the card's
    readings, the floors')."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import convert, gluon, metric, nd
    from incubator_mxnet_tpu_torch.contrib import amp

    ex = _gluon_module()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = batch or AMP["cpu_batch"]
    image = image or GLUON["image"]
    classes = classes or GLUON["classes"]
    args = _gluon_args(ex, model or GLUON["model"], batch, image, classes,
                       GLUON["lr"], batch)
    args.amp = "bfloat16"
    amp.init(args.amp)
    nudged = ["cpu_nudged%d" % j for j in range(AMP["floors"])]
    try:
        where = dict({"cuda": dev, "cpu": "cpu"}, **dict.fromkeys(nudged,
                                                                "cpu"))
        nets = {d: ex.build_net(args, w) for d, w in where.items()}
        start = {k: p.data().asnumpy()
                 for k, p in nets["cuda"].collect_params().items()}
        for j, d in enumerate(["cpu"] + nudged):
            arrays = start
            if d != "cpu":
                rs = np.random.RandomState(SEED + 3 + j)
                arrays = {k: (v * (1 + AMP_NUDGE * rs.normal(
                    size=v.shape))).astype(np.float32)
                    for k, v in start.items()}
            convert.params_from_gluon(nets[d], arrays)
        rng = np.random.RandomState(SEED)
        xb = rng.rand(batch, 3, image, image).astype(np.float32)
        yb = rng.randint(0, classes, batch).astype(np.float32)
        read = {}
        for d, net in nets.items():
            params = list(net.collect_params().values())
            before = [p.data().asnumpy() for p in params]
            trainer = ex.build_trainer(net, args)
            outs = []
            hook = list(net._modules.values())[-1].register_forward_hook(
                lambda mod, inp, out: outs.append(out.detach().float()))
            t = time.perf_counter()
            loss = ex.train_batch(net, trainer,
                                  gluon.loss.SoftmaxCrossEntropyLoss(),
                                  metric.Accuracy(),
                                  nd.array(xb, ctx=where[d]),
                                  nd.array(yb, ctx=where[d]), batch)
            hook.remove()
            read[d] = dict(
                loss=float(loss.asscalar()), step_s=time.perf_counter() - t,
                logits=outs[-1].cpu().numpy(),
                trained=[p.grad_req != "null" for p in params],
                after=[p.data().asnumpy() for p in params],
                update=[p.data().asnumpy() - b
                        for p, b in zip(params, before)])
    finally:
        amp.disable()
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.benchmark = True

    card = _amp_step_diffs(read["cuda"], read["cpu"])
    floors = [_amp_step_diffs(read[d], read["cpu"]) for d in nudged]
    print("  %s, batch %d, %d px, %d classes:" % (args.model, batch, image,
                                                  classes), flush=True)
    for k in card:
        print("  %-16s card-vs-CPU %.3e   CPU nudged by 1e-6 %s   (%s)" % (
            k, card[k], " ".join("%.3e" % f[k] for f in floors),
            "limit 4x the largest" if k in held else "not held: its floor "
            "saturates at this size"), flush=True)
    print("  loss card %.6f, CPU %.6f; largest logit %.3f; the CPU step "
          "took %.1f s" % (read["cuda"]["loss"], read["cpu"]["loss"],
                           float(np.abs(read["cpu"]["logits"]).max()),
                           read["cpu"]["step_s"]), flush=True)
    # the gate's controls: the card's step with its update made zero,
    # doubled or (where the direction is held) negated must miss it
    for label, f in (("zero", 0.0), ("doubled", 2.0), ("negated", -1.0)):
        if f < 0 and "upd_cos" not in held:
            continue
        ctl = dict(read["cuda"], update=[u * f
                                         for u in read["cuda"]["update"]])
        misses = _amp_gate_misses(_amp_step_diffs(ctl, read["cpu"]), floors,
                                  held)
        print("  control: the card's update %s misses the gate on %s"
              % (label, misses), flush=True)
        if not misses:
            raise AssertionError("the AMP step's gate passes a %s update"
                                 % label)
    misses = _amp_gate_misses(card, floors, held)
    if misses:
        raise AssertionError("the AMP step card and CPU disagree beyond the "
                             "CPU's own floor on %s" % misses)
    return card, floors


def amp_overflow_on_card(dev, model=None, batch=None, image=None,
                         classes=None):
    """Phase 3u (i), the float16 loss scaler on the card, see the module
    docstring.  Returns [(scale, gradients finite, step applied), ...]."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    from incubator_mxnet_tpu_torch.contrib import amp

    ex = _gluon_module()
    batch = batch or AMP["cpu_batch"]
    image = image or GLUON["image"]
    classes = classes or GLUON["classes"]
    args = _gluon_args(ex, model or GLUON["model"], batch, image, classes,
                       GLUON["lr"], batch)
    args.amp = "float16"
    amp.init(args.amp)
    log = []
    try:
        net = ex.build_net(args, dev)
        trainer = ex.build_trainer(net, args)
        scaler = trainer._amp_loss_scaler
        trained = [p for p in net.collect_params().values()
                   if p.grad_req != "null"]
        rng = np.random.RandomState(SEED + 4)
        x = nd.array(rng.rand(batch, 3, image, image).astype(np.float32),
                     ctx=dev)
        y = nd.array(rng.randint(0, classes, batch).astype(np.float32),
                     ctx=dev)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        for i in range(AMP["fp16_steps"]):
            with autograd.record():
                loss = loss_fn(net(x), y).mean()
                with amp.scale_loss(loss, trainer) as scaled:
                    pass
            scaled.backward()
            if i == 0:
                g = trained[0].grad()
                g[(0,) * g.ndim] = float("inf")
            finite = all(bool(torch.isfinite(p.grad()._data).all())
                         for p in trained)
            before = [p.data()._data.clone() for p in trained]
            scale = scaler.loss_scale
            trainer.step(batch)
            kept = all(torch.equal(p.data()._data, b)
                       for p, b in zip(trained, before))
            log.append((scale, finite, not kept))
            # a step with a non-finite gradient leaves every parameter
            # bit-equal and halves the scale; a finite one is applied at
            # the same scale
            want = (scale, True) if finite else (scale / 2, False)
            if (scaler.loss_scale, not kept) != want or (
                    finite and not all(bool(torch.isfinite(
                        p.data()._data).all()) for p in trained)):
                raise AssertionError("float16 step %d at scale %g: gradients "
                                     "finite %s, applied %s, scale after "
                                     "%g" % (i, scale, finite, not kept,
                                             scaler.loss_scale))
            if finite:
                break
    finally:
        amp.disable()
    if log[0][:2] != (2.0 ** 16, False) or not log[-1][2]:
        raise AssertionError("float16 loss scaler: %s" % log)
    print("  float16, batch %d: the planted inf at scale 2^16 skipped the "
          "step (parameters bit-equal), the scale halved; steps (scale, "
          "gradients finite, applied) %s" % (batch, log), flush=True)
    return log


def run_amp_convert(dev, directory):
    """Phase 3u (ii), see the module docstring.  Returns (metrics,
    counts)."""
    import json as _json

    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels, initializer, nd
    from incubator_mxnet_tpu_torch.contrib import amp
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    torch.backends.cudnn.benchmark = True
    b = AMP["convert_batch"]
    net = resnet.resnet50_v1(classes=1000, ghost_bn=16, device=dev)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.RandomState(SEED + 7)
    with torch.no_grad():
        for name, t in net.named_buffers():
            if name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.normal(
                    0, 0.1, tuple(t.shape)).astype(np.float32)))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, tuple(t.shape)).astype(np.float32)))
    prefix = os.path.join(directory, "resnet50_v1_ghost16")
    net.export(prefix)
    del net
    sym, arg, aux = mx.model.load_checkpoint(prefix, 0, ctx=dev)
    t0 = time.perf_counter()
    amp_sym, amp_arg, amp_aux = amp.convert_model(sym, arg, aux)
    convert_ms = (time.perf_counter() - t0) * 1e3
    casts = sum(n["op"] == "amp_cast"
                for n in _json.loads(amp_sym.tojson())["nodes"])
    if casts != AMP_CASTS:
        raise AssertionError("convert_model inserted %d amp_cast nodes, the "
                             "reference %d" % (casts, AMP_CASTS))
    x = nd.NDArray(torch.rand(b, 3, IMAGE, IMAGE, device=dev,
                              generator=torch.Generator(device=dev)
                              .manual_seed(SEED + 8)))
    exes = {label: s.bind(dev, dict(a, data=x), grad_req="null",
                          aux_states=dict(aux_p))
            for label, s, a, aux_p in (("f32", sym, arg, aux),
                                       ("amp", amp_sym, amp_arg, amp_aux))}
    outs, ms, counts = {}, {}, {}
    for label, exe in exes.items():
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        out = exe.forward(is_train=False)[0]._data
        torch.cuda.synchronize()
        c = _kernels.launch_counts()
        if c != {k: int(k == "maxpool_idx_fwd") for k in c}:
            raise AssertionError("the %s graph's forward launched %s"
                                 % (label, c))
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        outs[label] = out
        ms[label] = _time_ms(lambda: exe.forward(is_train=False),
                             AMP["convert_reps"])
    ref = outs["f32"].float()
    got = outs["amp"]
    rel = float((got.float() - ref).abs().max() / ref.abs().max())
    top1 = float((got.float().argmax(1) == ref.argmax(1)).float().mean())
    print("  convert_model: %d amp_cast nodes (the reference's %d) in %.1f "
          "ms; bound at batch %d, %d px, inference: logits %s, within %.3e "
          "of the f32 graph's largest logit (limit %g), top-1 agreement "
          "%.4f; forward %.2f ms (f32 graph %.2f ms)" % (
              casts, AMP_CASTS, convert_ms, b, IMAGE, str(got.dtype)
              .replace("torch.", ""), rel, AMP_LOGIT_TOL, top1, ms["amp"],
              ms["f32"]), flush=True)
    if got.dtype != torch.bfloat16 or not bool(torch.isfinite(got).all()) \
            or rel > AMP_LOGIT_TOL:
        raise AssertionError("the converted graph's logits are off")
    del exes, outs, sym, arg, aux, amp_sym, amp_arg, amp_aux, x
    torch.cuda.empty_cache()
    return {"amp_convert_img_per_sec": b / ms["amp"] * 1e3,
            "f32_graph_img_per_sec": b / ms["f32"] * 1e3,
            "amp_convert_top1": top1, "amp_convert_rel": rel}, counts


#: inputs of phase 3u (iii)'s ops that the op takes as float32 but whose
#: values are indices (sequence lengths, CTC's labels and lengths): held
#: as int32, so that the floor's nudge leaves them whole, and cast to
#: float32 inside the case
_TAIL_INDEX_INPUTS = {"SequenceMask": (1,), "SequenceLast": (1,),
                      "SequenceReverse": (1,), "CTCLoss": (1, 2, 3)}


def _tail_op_cases(rng, s=1):
    """(name, op name, arrays, attrs) of phase 3u (iii)'s ops; ``s``
    scales the batch (8 at 1)."""
    import numpy as np

    def n(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    b = max(2, int(8 * s))
    lens = rng.randint(1, 34, b).astype(np.int32)
    return [
        ("depth_to_space", "depth_to_space", [n(b, 64, 28, 28)],
         dict(block_size=2)),
        ("space_to_depth", "space_to_depth", [n(b, 16, 56, 56)],
         dict(block_size=2)),
        ("slice_like", "slice_like", [n(b, 64, 30), n(b, 32, 20)], {}),
        ("broadcast_axis", "broadcast_axis", [n(b, 1, 256)],
         dict(axis=1, size=64)),
        ("split_v2", "split_v2", [n(b, 96, 64)], dict(indices=(16, 48),
                                                      axis=1)),
        ("batch_take", "batch_take", [n(b * 32, 100),
                                      rng.randint(0, 100, b * 32)], {}),
        ("gather_nd", "gather_nd", [n(64, 128, 16), np.stack([
            rng.randint(0, 64, 512), rng.randint(0, 128, 512)])], {}),
        ("scatter_nd", "scatter_nd", [n(512, 16), np.stack(
            np.unravel_index(rng.permutation(64 * 128)[:512], (64, 128)))],
         dict(shape=(64, 128, 16))),
        ("_scatter_set_nd", "_scatter_set_nd", [
            n(64, 128), n(256), np.stack(np.unravel_index(
                rng.permutation(64 * 128)[:256], (64, 128)))],
         dict(shape=(64, 128))),
        ("Cast", "Cast", [n(b, 4096) * 50], dict(dtype="int32")),
        ("amp_cast", "amp_cast", [n(b, 4096)], dict(dtype="bfloat16")),
        ("amp_multicast", "amp_multicast", [n(b, 4096),
                                            n(b, 4096).astype(np.float16)],
         dict(num_outputs=2)),
        ("shape_array", "shape_array", [n(b, 3, 5)], {}),
        ("size_array", "size_array", [n(b, 3, 5)], {}),
        ("SequenceMask", "SequenceMask", [n(32, b, 256), lens],
         dict(use_sequence_length=True)),
        ("SequenceLast", "SequenceLast", [n(32, b, 256), lens],
         dict(use_sequence_length=True)),
        ("SequenceReverse", "SequenceReverse", [n(32, b, 256), lens],
         dict(use_sequence_length=True)),
        ("_np_nonzero", "_np_nonzero", [(u(0, 1, b, 512) > 0.7)
                                        .astype(np.float32)], {}),
        ("_np_unique", "_np_unique", [rng.randint(0, 300, b * 512)],
         dict(return_index=True, return_inverse=True, return_counts=True)),
        ("tril", "tril", [n(b, 256, 256)], dict(k=-3)),
        ("LinearRegressionOutput", "LinearRegressionOutput",
         [n(b * 32, 64), n(b * 32, 64)], dict(grad_scale=0.5)),
        ("LogisticRegressionOutput", "LogisticRegressionOutput",
         [n(b * 32, 64), u(0, 1, b * 32, 64)], {}),
        ("MAERegressionOutput", "MAERegressionOutput",
         [n(b * 32, 64), n(b * 32, 64)], {}),
        ("Deconvolution", "Deconvolution", [
            n(b, 64, 28, 28), n(64, 32, 4, 4) * 0.05, n(32)],
         dict(kernel=(4, 4), num_filter=32, stride=(2, 2), pad=(1, 1),
              no_bias=False)),
        ("Deconvolution groups", "Deconvolution", [
            n(b, 64, 28, 28), n(64, 32, 3, 3) * 0.05],
         dict(kernel=(3, 3), num_filter=64, num_group=2, stride=(2, 2),
              pad=(1, 1), adj=(1, 1))),
        ("batch_norm_stats", "batch_norm_stats", [n(b, 64, 28, 28) + 3], {}),
        ("LayerNorm", "LayerNorm", [n(b, 128, 768), n(768), n(768)],
         dict(output_mean_var=True)),
        ("GroupNorm", "GroupNorm", [n(b, 64, 28, 28), n(64), n(64)],
         dict(num_groups=8, output_mean_var=True)),
        ("InstanceNorm", "InstanceNorm", [n(b, 64, 28, 28), n(64), n(64)],
         {}),
        ("L2Normalization", "L2Normalization", [n(b, 64, 28, 28)],
         dict(mode="channel")),
        ("LRN", "LRN", [n(b, 64, 28, 28)], dict(nsize=5)),
        ("LeakyReLU prelu", "LeakyReLU", [n(b, 64, 28, 28), u(0, 0.5, 64)],
         dict(act_type="prelu")),
        ("LeakyReLU elu", "LeakyReLU", [n(b, 64, 28, 28)],
         dict(act_type="elu")),
        ("LeakyReLU selu", "LeakyReLU", [n(b, 64, 28, 28)],
         dict(act_type="selu")),
        ("LeakyReLU gelu", "LeakyReLU", [n(b, 64, 28, 28)],
         dict(act_type="gelu")),
        ("LeakyReLU rrelu (eval)", "LeakyReLU", [n(b, 64, 28, 28)],
         dict(act_type="rrelu")),
        ("SoftmaxActivation", "SoftmaxActivation", [n(b, 64, 28, 28)],
         dict(mode="channel")),
        ("UpSampling nearest", "UpSampling", [n(b, 32, 28, 28)],
         dict(scale=2)),
        ("UpSampling bilinear", "UpSampling", [n(b, 32, 28, 28),
                                               n(32, 1, 4, 4)],
         dict(scale=2, sample_type="bilinear", num_filter=32)),
        ("BilinearResize2D down", "_contrib_BilinearResize2D",
         [n(b, 32, 56, 56)], dict(height=24, width=40)),
        ("AdaptiveAvgPooling2D", "_contrib_AdaptiveAvgPooling2D",
         [n(b, 64, 28, 28)], dict(output_size=(7, 4))),
        ("CTCLoss", "CTCLoss", [n(64, b, 32), rng.randint(
            1, 32, (b, 20)).astype(np.int32), np.full(b, 64, np.int32),
            rng.randint(5, 21, b).astype(np.int32)],
         dict(use_data_lengths=True, use_label_lengths=True)),
        ("_scatter_elemwise_div", "_scatter_elemwise_div",
         [n(b, 4096), u(0.5, 2, b, 4096)], {}),
        ("make_loss", "make_loss", [n(b, 4096)], {}),
        ("smooth_l1", "smooth_l1", [n(b, 4096)], dict(scalar=2.0)),
        ("gelu", "gelu", [n(b, 4096)], {}),
        ("add_n", "add_n", [n(b, 4096), n(b, 4096), n(b, 4096)], {}),
        ("khatri_rao", "khatri_rao", [n(32, 64), n(48, 64), n(16, 64)], {}),
        ("softmin", "softmin", [n(b, 4096)], {}),
        ("cumsum", "cumsum", [n(b, 4096)], dict(axis=1)),
        ("diag", "diag", [n(b, 256, 256)], dict(k=2, axis1=1, axis2=2)),
        ("Pooling 1-D max", "Pooling", [n(b, 64, 500)],
         dict(kernel=(3,), stride=(2,), pad=(1,), pool_type="max")),
        ("Pooling 3-D avg", "Pooling", [n(b, 16, 16, 28, 28)],
         dict(kernel=(2, 3, 3), stride=(2, 2, 2), pool_type="avg",
              pooling_convention="full", count_include_pad=False)),
    ]


def _tail_layer_cases(nn, s=1):
    """(name, layer factory, input shape) of phase 3u (iii)'s layers;
    ``s`` scales the batch (8 at 1)."""
    b = max(2, int(8 * s))
    return [
        ("InstanceNorm", lambda: nn.InstanceNorm(in_channels=64, scale=True),
         (b, 64, 28, 28)),
        ("LayerNorm", lambda: nn.LayerNorm(in_channels=768), (b, 128, 768)),
        ("GroupNorm", lambda: nn.GroupNorm(8, in_channels=64),
         (b, 64, 28, 28)),
        ("Conv1D", lambda: nn.Conv1D(64, 5, padding=2, in_channels=32),
         (b, 32, 512)),
        ("Conv3D", lambda: nn.Conv3D(32, 3, padding=1, in_channels=16),
         (b // 2, 16, 8, 28, 28)),
        ("Conv1DTranspose", lambda: nn.Conv1DTranspose(
            32, 4, strides=2, padding=1, in_channels=64), (b, 64, 256)),
        ("Conv2DTranspose", lambda: nn.Conv2DTranspose(
            32, 3, strides=2, padding=1, output_padding=1, in_channels=64),
         (b, 64, 28, 28)),
        ("Conv3DTranspose", lambda: nn.Conv3DTranspose(
            16, 2, strides=2, in_channels=32), (b // 2, 32, 4, 14, 14)),
        ("MaxPool1D", lambda: nn.MaxPool1D(3, 2, 1), (b, 64, 500)),
        ("MaxPool3D", lambda: nn.MaxPool3D(ceil_mode=True),
         (b // 2, 16, 9, 28, 28)),
        ("AvgPool1D", lambda: nn.AvgPool1D(3, 2, 1), (b, 64, 500)),
        ("AvgPool3D", lambda: nn.AvgPool3D(), (b // 2, 16, 8, 28, 28)),
        ("GlobalMaxPool1D", lambda: nn.GlobalMaxPool1D(), (b, 64, 500)),
        ("GlobalMaxPool3D", lambda: nn.GlobalMaxPool3D(),
         (b // 2, 16, 8, 28, 28)),
        ("GlobalAvgPool1D", lambda: nn.GlobalAvgPool1D(), (b, 64, 500)),
        ("GlobalAvgPool3D", lambda: nn.GlobalAvgPool3D(),
         (b // 2, 16, 8, 28, 28)),
        ("ReflectionPad2D", lambda: nn.ReflectionPad2D(3), (b, 32, 56, 56)),
        ("LeakyReLU", lambda: nn.LeakyReLU(0.1), (b, 64, 28, 28)),
        ("PReLU", lambda: nn.PReLU(), (b, 64, 28, 28)),
        ("ELU", lambda: nn.ELU(0.5), (b, 64, 28, 28)),
        ("SELU", lambda: nn.SELU(), (b, 64, 28, 28)),
        ("GELU", lambda: nn.GELU(), (b, 64, 28, 28)),
        ("Swish", lambda: nn.Swish(1.5), (b, 64, 28, 28)),
    ]


def tail_card_vs_cpu(dev, s=1):
    """Phase 3u (iii), see the module docstring.  Returns the number of
    cases."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.ops import registry

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED + 9)
    before = _kernels.launch_counts()
    rows = []
    try:
        for name, opname, arrays, attrs in _tail_op_cases(rng, s):
            fn = registry.get_op(opname).fn
            idx = _TAIL_INDEX_INPUTS.get(name, ())
            readings = []
            rows.append((name, _card_vs_cpu(
                name, lambda _, fn=fn, attrs=attrs, idx=idx: (
                    lambda *a: fn(*(t.float() if i in idx else t
                                    for i, t in enumerate(a)), **attrs)),
                arrays, dev, readings)[1]))
            if idx:
                print("  %-16s (index inputs int32, not nudged) card-vs-CPU "
                      "against floor, each floating tensor: %s" % (
                          name, ", ".join("%.3e/%.3e" % r
                                          for r in readings)), flush=True)
        for opname, attrs, exact in (
                ("_linspace", dict(start=-3.0, stop=7.0, num=100001), False),
                ("_eye", dict(N=300, M=500, k=-7), True)):
            fn = registry.get_op(opname).fn
            a, b = fn(ctx=dev, **attrs).cpu(), fn(ctx="cpu", **attrs)
            err = _max_err(a, b)
            limit = 0.0 if exact else float(b.abs().max()) * 2.0 ** -23
            if not err <= limit:
                raise AssertionError("%s card-vs-CPU %g (limit %g)"
                                     % (opname, err, limit))
            rows.append((opname, 0.0))
        for name, make, shape in _tail_layer_cases(nn, s):
            rows.append((name + " (layer)", _card_vs_cpu(
                name, _block_on(make, lambda blk, xx: blk(xx)),
                [rng.uniform(-1, 1, shape).astype(np.float32)], dev)[1]))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    if _kernels.launch_counts() != before:
        raise AssertionError("the op tail launched a kernel")
    worst = max(rows, key=lambda r: r[1])
    print("  %d ops and %d layers, forward and backward: card against CPU "
          "within 4x the CPU's 1e-6-nudged floor (worst %s at %.3fx); "
          "_linspace within one f32 step, _eye exact; no kernel launched"
          % (len(rows) - 23, 23, worst[0], worst[1]), flush=True)
    return len(rows)



# phase 3v: the NumPy frontend: the zoo's resnet50_v1 written in mx.np and
# mx.npx (example/numpy/resnet_np.py), trained with _multi_adamw_update
NP_PATH = dict(model="resnet50_v1", batch=64, image=224, classes=1000,
               steps=3, lr=1e-3, wd=1e-4, resize=256, raw=(288, 320))
#: phase 3v (iv): the first step card against CPU at a small size
NP_SMALL = dict(model="resnet18_v1", batch=8, image=64, classes=10)
#: (iii): the AdamW hyperparameters the update is held at
NP_ADAMW = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                clip_gradient=-1.0)


def _np_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "numpy", "resnet_np.py")
    spec = importlib.util.spec_from_file_location("resnet_np", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_cases():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "np_surface_cases.py")
    spec = importlib.util.spec_from_file_location("np_surface_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zoo_net(dev, model, classes, image):
    """A stock zoo net on ``dev`` with Xavier weights from ``SEED``."""
    import torch

    from incubator_mxnet_tpu_torch import gluon, initializer

    net = gluon.model_zoo.vision.get_model(model, classes=classes,
                                           device=dev)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=dev).manual_seed(SEED))
    gluon.shape_init(net, (1, 3, image, image))
    return net


@contextlib.contextmanager
def _f32_exact():
    """TF32 off and cuDNN deterministic without autotuning, put back
    after (the defaults: TF32 on, autotuning on)."""
    import torch

    b = torch.backends
    keep = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark,
            b.cudnn.deterministic)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.benchmark, b.cudnn.deterministic = False, True
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark,
         b.cudnn.deterministic) = keep


def _plain_adamw(w, g, m, v, lr, wd, eta=1.0, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0):
    """One tensor's AdamW step in torch ops (``_multi_adamw_update``'s
    plain version): (weight, mean, var)."""
    import torch

    g = g * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * torch.square(g)
    return w - eta * (lr * m / (torch.sqrt(v) + epsilon) + wd * w), m, v


def _rel_max(a, b):
    return _max_err(a, b) / max(1.0, float(b.float().abs().max()))


def _check_update(label, outs, plain, tol):
    """Each output of the multi-tensor update within ``tol`` of its
    plain version's largest magnitude; a doubled learning rate (the
    plain update's step doubled) must miss.  Returns the worst error."""
    worst = max(_rel_max(o, p) for o, p in zip(outs, plain))
    if not worst <= tol:
        raise AssertionError("%s: %g from the per-tensor update (limit %g)"
                             % (label, worst, tol))
    return worst


def np_update_on_card(mx, ex, state, lr, wd):
    """Phase 3v (iii): ``_multi_adamw_update`` over every trained
    parameter of ``state`` against a per-tensor plain update on the card,
    then ``_multi_mp_adamw_update`` over the same parameters in bf16 with
    float32 masters; a doubled step misses each gate.  Updates
    ``state``."""
    import torch

    nd = mx.nd
    before = [a._data.detach().clone() for a in ex.adamw_arrays(state)]
    outs = ex.adamw_update(mx, state, lr, wd, **NP_ADAMW)
    plain = []
    for k in range(len(state.trained)):
        plain.extend(_plain_adamw(*before[4 * k:4 * k + 4], lr, wd,
                                  **NP_ADAMW))
    got = [o._data for o in outs]
    f32 = _check_update("_multi_adamw_update", got, plain, 1e-6)
    # the control: each weight's step doubled
    miss = max(_rel_max(got[3 * k], 2 * plain[3 * k] - before[4 * k])
               for k in range(len(state.trained)))
    if not miss > 1e-6:
        raise AssertionError("the update gate passes a doubled step")
    # the mixed-precision form: bf16 weights and gradients, f32 masters
    arrays, mp_plain = [], []
    for k, i in enumerate(state.trained):
        w32 = before[4 * k].clone()
        g = before[4 * k + 1].to(torch.bfloat16)
        m, v = before[4 * k + 2], before[4 * k + 3]
        arrays += [nd.NDArray(t) for t in (w32.to(torch.bfloat16), g, m, v,
                                           w32)]
        nw32, nm, nv = _plain_adamw(w32, g.float(), m, v, lr, wd,
                                    **NP_ADAMW)
        mp_plain += [nw32.to(torch.bfloat16), nm, nv, nw32]
    n = len(state.trained)
    mp = nd._multi_mp_adamw_update(*arrays, num_weights=n, lrs=[lr] * n,
                                   wds=[wd] * n, etas=[1.0] * n, **NP_ADAMW)
    mp_got = [o._data for o in mp]
    for i, (o, p) in enumerate(zip(mp_got, mp_plain)):
        if o.dtype != p.dtype:
            raise AssertionError("mp update output %d is %s, want %s"
                                 % (i, o.dtype, p.dtype))
    mp_err = _check_update("_multi_mp_adamw_update", mp_got, mp_plain, 1e-6)
    print("  (iii) _multi_adamw_update over %d tensors against the "
          "per-tensor plain update: %.3e (limit 1e-6), a doubled step %.3e "
          "(misses); _multi_mp_adamw_update, bf16 weights with f32 "
          "masters: %.3e" % (n, f32, miss, mp_err), flush=True)
    return f32, mp_err


def _np_gluon_first_step(net, x, y):
    """The Gluon zoo net's first step on ``x``: (logits, loss, the
    trained parameters' gradients, the running stats after it)."""
    from incubator_mxnet_tpu_torch import autograd, gluon

    params = list(net.collect_params().values())
    with autograd.record():
        out = net(x)
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(out, y).mean()
    loss.backward()
    return dict(logits=out._data.detach().clone(),
                loss=loss._data.detach().clone(),
                grads=[p.grad()._data.clone() for p in params
                       if p.grad_req != "null"],
                stats=[p.data()._data.clone() for p in params
                       if p.grad_req == "null"])


def run_np_path(dev, gluon_step_ms):
    """Phase 3v (i)-(iii), see the module docstring.  Returns (metrics,
    the launch counts of the steps)."""
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels, autograd, nd

    ex = _np_module()
    g = NP_PATH
    spec = ex.SPECS[g["model"]]
    t0 = time.perf_counter()
    with _f32_exact():
        net = _zoo_net(dev, g["model"], g["classes"], g["image"])
        state = ex.NpState(mx, net, ctx=dev)
        images, labels = ex.synthetic_batch(g["batch"], *g["raw"],
                                            g["classes"], SEED)
        raw = nd.array(images, ctx=dev, dtype="uint8")
        torch.cuda.synchronize()
        t = time.perf_counter()
        x = ex.preprocess(mx, raw, g["resize"], g["image"])
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t) * 1e3
        y = mx.np.array(labels, ctx=dev)
        if tuple(x.shape) != (g["batch"], 3, g["image"], g["image"]) \
                or x.dtype != "float32" or not bool(torch.isfinite(
                    x._data).all()):
            raise AssertionError("preprocessed batch %s %s"
                                 % (x.shape, x.dtype))
        glu = _np_gluon_first_step(net, x, y)
        counts = {k: 0 for k in _kernels.launch_counts()}
        losses, step_ms, fwd_bwd_ms = [], [], []
        for step in range(1, g["steps"] + 1):
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            t = time.perf_counter()
            with autograd.record():
                logits, stats = ex.forward(mx, state.named, x, spec)
                loss = ex.cross_entropy(mx, logits, y)
            loss.backward()
            ex.update_running_stats(mx, stats)
            if step == 1:
                torch.cuda.synchronize()
                np_first = dict(
                    logits=logits._data.detach().clone(),
                    loss=loss._data.detach().clone(),
                    grads=[state.named[i][1].grad._data.clone()
                           for i in state.trained],
                    stats=[a._data.clone() for k, (_, a) in enumerate(
                        state.named) if k not in state.trained])
                step_counts = _kernels.launch_counts()
                np_update_on_card(mx, ex, state, g["lr"], g["wd"])
            else:
                torch.cuda.synchronize()
                fwd_bwd_ms.append((time.perf_counter() - t) * 1e3)
                ex.adamw_update(mx, state, g["lr"], g["wd"], **NP_ADAMW)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                step_counts = _kernels.launch_counts()
            losses.append(float(loss.asnumpy()))
            want = {k: int(k == "maxpool_idx_fwd") for k in step_counts}
            if step_counts != want:
                raise AssertionError("mx.np step %d launched %s, want %s"
                                     % (step, step_counts, want))
            for k in counts:
                counts[k] += step_counts[k]
        if not _losses_ok(losses):
            raise AssertionError("mx.np path losses %s" % losses)
        same = _np_against_gluon(np_first, glu)
        # the Gluon net's forward + backward again, on this phase's
        # settings (its first call above set cuDNN up)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _np_gluon_first_step(net, x, y)
        torch.cuda.synchronize()
        gluon_fwd_bwd = (time.perf_counter() - t) * 1e3
    print("  steps 2-%d: %s ms, of which forward + backward + running "
          "stats %s ms, the update the rest; the Gluon net's forward + "
          "backward on these settings %.2f ms" % (
              g["steps"], ["%.2f" % v for v in step_ms],
              ["%.2f" % v for v in fwd_bwd_ms], gluon_fwd_bwd), flush=True)
    metrics = dict(np_step_ms=sum(step_ms) / len(step_ms),
                   preprocess_ms=pre_ms,
                   np_fwd_bwd_ms=sum(fwd_bwd_ms) / len(fwd_bwd_ms),
                   gluon_fwd_bwd_ms=gluon_fwd_bwd,
                   losses=losses, bit_equal=same,
                   trained=len(state.trained), build_s=time.perf_counter()
                   - t0, gluon_step_ms=gluon_step_ms)
    del net, state, x, raw
    torch.cuda.empty_cache()
    return metrics, counts


def _np_against_gluon(np_first, glu):
    """Phase 3v (ii): the mx.np step's logits, loss, gradients and running
    stats against the Gluon net's from the same weights and batch: the
    same registered ops run in both, so bit for bit; a zeroed gradient
    and a doubled one must miss."""
    import torch

    pairs = [("logits", [np_first["logits"]], [glu["logits"]]),
             ("loss", [np_first["loss"]], [glu["loss"]]),
             ("gradients", np_first["grads"], glu["grads"]),
             ("running stats", np_first["stats"], glu["stats"])]
    for label, got, want in pairs:
        if len(got) != len(want):
            raise AssertionError("%s: %d tensors, Gluon %d"
                                 % (label, len(got), len(want)))
        diff = [t for t, (a, b) in enumerate(zip(got, want))
                if a.shape != b.shape or not torch.equal(a, b)]
        worst = max(_rel_max(a, b) for a, b in zip(got, want)
                    if a.shape == b.shape)
        print("  (ii) %-14s %3d tensors, %d not bit-equal to the Gluon "
              "net's (largest difference %.3e of the tensor's magnitude)"
              % (label, len(got), len(diff), worst), flush=True)
        if diff:
            raise AssertionError("the mx.np step's %s differ from the "
                                 "Gluon net's in %d tensors" % (label,
                                                                len(diff)))
    for label, f in (("zeroed", 0.0), ("doubled", 2.0)):
        ctl = [g * f for g in np_first["grads"]]
        if all(torch.equal(a, b) for a, b in zip(ctl, glu["grads"])):
            raise AssertionError("the gradient gate passes a %s gradient"
                                 % label)
    print("  (ii) controls: a zeroed and a doubled gradient are not "
          "bit-equal (miss)", flush=True)
    return True


def _np_step_read(ex, mx, net, x, y, spec, ctx, lr):
    """One mx.np step (``ex.train_step``) of ``net``'s weights on ``ctx``:
    the loss, the logits, which arrays are trained, each array after the
    step and its change (AMP's readings, ``_amp_step_diffs``)."""
    state = ex.NpState(mx, net, ctx=ctx)
    before = [a.asnumpy() for _, a in state.named]
    t = time.perf_counter()
    loss, logits = ex.train_step(mx, state, mx.np.array(x, ctx=ctx),
                                 mx.np.array(y, ctx=ctx), spec, lr)
    after = [a.asnumpy() for _, a in state.named]
    return dict(loss=float(loss.asnumpy()), step_s=time.perf_counter() - t,
                logits=logits.asnumpy(),
                trained=[k in state.trained for k in range(len(after))],
                after=after, update=[a - b for a, b in zip(after, before)])


def np_card_vs_cpu(dev, model, batch, image, classes):
    """Phase 3v (iv): the mx.np step at a small size on the card and on
    the CPU from the same weights and batch, and on the CPU in three runs
    with every weight nudged by 1e-6: AMP's readings (phase 3u,
    ``_amp_step_diffs``) card-vs-CPU within 4x the largest nudged run's;
    the card's update made zero, doubled or negated must miss."""
    import numpy as np

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import context, convert

    ex = _np_module()
    spec = ex.SPECS[model]
    with _f32_exact():
        card_net = _zoo_net(dev, model, classes, image)
        start = {k: p.data().asnumpy()
                 for k, p in card_net.collect_params().items()}
        images, labels = ex.synthetic_batch(batch, image + 16, image + 8,
                                            classes, SEED)
        with context.device_scope("cpu"):
            x = ex.preprocess(mx, mx.nd.array(images, dtype="uint8"),
                              image * 8 // 7, image).asnumpy()
        read = {"cuda": _np_step_read(ex, mx, card_net, x, labels, spec, dev,
                                      NP_PATH["lr"])}
        nudged = ["cpu_nudged%d" % j for j in range(AMP["floors"])]
        for j, d in enumerate(["cpu"] + nudged):
            with context.device_scope("cpu"):
                net = _zoo_net("cpu", model, classes, image)
            arrays = start
            if d != "cpu":
                rs = np.random.RandomState(SEED + 3 + j)
                arrays = {k: (v * (1 + AMP_NUDGE * rs.normal(
                    size=v.shape))).astype(v.dtype)
                    for k, v in start.items()}
            convert.params_from_gluon(net, arrays)
            with context.device_scope("cpu"):
                read[d] = _np_step_read(ex, mx, net, x, labels, spec, "cpu",
                                        NP_PATH["lr"])
    card = _amp_step_diffs(read["cuda"], read["cpu"])
    floors = [_amp_step_diffs(read[d], read["cpu"]) for d in nudged]
    print("  (iv) %s, batch %d, %d px, %d classes, f32, TF32 off:"
          % (model, batch, image, classes), flush=True)
    for k in card:
        print("  %-16s card-vs-CPU %.3e   CPU nudged by 1e-6 %s   (limit 4x "
              "the largest)" % (k, card[k], " ".join(
                  "%.3e" % f[k] for f in floors)), flush=True)
    for label, f in (("zero", 0.0), ("doubled", 2.0), ("negated", -1.0)):
        ctl = dict(read["cuda"], update=[u * f
                                         for u in read["cuda"]["update"]])
        misses = _amp_gate_misses(_amp_step_diffs(ctl, read["cpu"]), floors,
                                  AMP_READINGS)
        print("  control: the card's update %s misses the gate on %s"
              % (label, misses), flush=True)
        if not misses:
            raise AssertionError("the mx.np step's gate passes a %s update"
                                 % label)
    misses = _amp_gate_misses(card, floors, AMP_READINGS)
    if misses:
        raise AssertionError("the mx.np step card and CPU disagree beyond "
                             "the CPU's own floor on %s" % misses)
    return card, floors


class _Slot:
    """Where a case's array goes (``tools/np_surface_cases.py``)."""

    def __init__(self, i):
        self.i = i


def _fill(obj, arrays):
    if isinstance(obj, _Slot):
        return arrays[obj.i]
    if isinstance(obj, (tuple, list)):
        return type(obj)(_fill(v, arrays) for v in obj)
    if isinstance(obj, dict):
        return {k: _fill(v, arrays) for k, v in obj.items()}
    return obj


def _surface_case(cases, table, case, func_of):
    """(arrays, fn_of, host values of) a case: ``fn_of(device)`` is the
    function of its arrays as tensors that ``_card_vs_cpu`` takes (its
    tensor outputs, recorded under ``autograd.record()`` where
    ``func_of`` says it differentiates); ``host(device)`` its other
    outputs (shapes, dtypes, strings)."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import autograd, context
    from incubator_mxnet_tpu_torch.ndarray import NDArray

    arrays = []

    def slot(x):
        arrays.append(np.asarray(x))
        return _Slot(len(arrays) - 1)

    args, kwargs = cases.build(table, case, slot)
    fn, record = func_of(cases.case_name(case))

    def call(device, ts):
        nds = [NDArray(t) for t in ts]
        with context.device_scope(device):
            if record:
                with autograd.record():
                    out = fn(*_fill(args, nds), **_fill(kwargs, nds))
            else:
                out = fn(*_fill(args, nds), **_fill(kwargs, nds))
        leaves = []

        def walk(o):
            if isinstance(o, (tuple, list)):
                for v in o:
                    walk(v)
            else:
                leaves.append(o._data if isinstance(o, NDArray) else o)
        walk(out)
        return leaves

    def fn_of(device):
        return lambda *ts: [o for o in call(device, ts)
                            if isinstance(o, torch.Tensor) and o.numel()]

    def host(device):
        ts = [torch.tensor(a, device=device) for a in arrays]
        return [o if not isinstance(o, torch.Tensor) else
                (str(o.dtype), tuple(o.shape)) for o in call(device, ts)]

    return arrays, fn_of, host


def _card_vs_cpu_quiet(name, fn_of, arrays, dev):
    """``fn_of`` of ``arrays`` on the card and on the CPU: integer and
    boolean outputs equal, floating ones within 1e-6 of their largest
    magnitude.  Returns 0 (no floor to be a ratio of)."""
    import torch

    card = [t.cpu() for t in fn_of(dev)(*[torch.tensor(a, device=dev)
                                          for a in arrays])]
    cpu = fn_of("cpu")(*[torch.tensor(a) for a in arrays])
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError("%s output %d: %s %s on the card, %s %s on "
                                 "the CPU" % (name, i, a.dtype, tuple(
                                     a.shape), b.dtype, tuple(b.shape)))
        if b.is_floating_point():
            bad = not _rel_max(a, b) <= 1e-6
        else:
            bad = not torch.equal(a, b)
        if bad:
            raise AssertionError("%s output %d differs card against CPU"
                                 % (name, i))
    if len(card) != len(cpu):
        raise AssertionError("%s: %d outputs on the card, %d on the CPU"
                             % (name, len(card), len(cpu)))
    return 0.0


def np_surface_card_vs_cpu(dev):
    """Phase 3v (v), see the module docstring.  Returns the number of
    cases."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels

    cases = _np_cases()
    np_mod = mx.np
    tables = (
        ("mx.np", dict(cases.CASES, **cases.MODERATE), lambda name: (
            getattr(np_mod, name), name in np_mod._DIFFERENTIABLE)),
        ("mx.np.linalg", cases.LINALG, lambda name: (
            getattr(np_mod.linalg, name), False)),
        ("mx.npx", cases.NPX, lambda name: (getattr(mx.npx, name), True)))
    rows = []
    with _f32_exact():
        before = _kernels.launch_counts()
        for label, table, func_of in tables:
            for case in sorted(table):
                arrays, fn_of, host = _surface_case(cases, table, case,
                                                    func_of)
                if host(dev) != host("cpu"):
                    raise AssertionError("%s %s: %s on the card, %s on the "
                                         "CPU" % (label, case, host(dev),
                                                  host("cpu")))
                if label == "mx.np" and cases.case_name(case) \
                        not in np_mod._DIFFERENTIABLE:
                    # the quiet set: piecewise constant, and some outputs'
                    # shapes follow the values, so no nudged floor
                    rows.append(("%s.%s" % (label, case), _card_vs_cpu_quiet(
                        case, fn_of, arrays, dev)))
                    continue
                rows.append(("%s.%s" % (label, case), _card_vs_cpu(
                    case, fn_of, arrays, dev)[1]))
        # the factors with a sign freedom: their products
        a = np.random.RandomState(SEED).normal(size=(48, 32)).astype(
            np.float32)
        spd = a.T @ a + 32 * np.eye(32, dtype=np.float32)
        for name, arr, rebuild in (
                ("svd", a, lambda u, s, vt: (u[:, :32] * s) @ vt),
                ("qr", a, lambda q, r: q @ r),
                ("eigh", spd, lambda w, v: (v * w) @ v.T)):
            got = getattr(np_mod.linalg, name)(mx.np.array(arr, ctx=dev))
            err = float(np.abs(rebuild(*[o.asnumpy() for o in got])
                               - arr).max()) / float(np.abs(arr).max())
            if not err <= 1e-5:
                raise AssertionError("np.linalg.%s on the card rebuilds "
                                     "with %g" % (name, err))
            rows.append(("mx.np.linalg.%s (rebuilt)" % name, 0.0))
        launched = {k: v - before[k] for k, v in
                    _kernels.launch_counts().items() if v != before[k]}
    # the samplers on the card: shape, dtype, moments
    mx.random.seed(SEED)
    moments = []
    for name in sorted(cases.RANDOM):
        kwargs, mean, var = cases.RANDOM[name]
        out = getattr(np_mod.random, name)(**dict(kwargs, ctx=dev))
        if out.context != dev or out.shape != (cases.N,):
            raise AssertionError("np.random.%s on %s, shape %s"
                                 % (name, out.context, out.shape))
        moments.append(("np.random." + name, out._data.double(), mean, var))
    for name, arrays, attrs, mean, var in cases.SAMPLERS:
        op = mx.ops.registry.get_op(name)
        ts = [torch.tensor(a, device=dev) for a in arrays]
        out = op.fn(*ts, **(attrs if arrays else dict(attrs, ctx=dev)))
        out = out[0] if isinstance(out, tuple) else out
        if out.device != dev:
            raise AssertionError("%s drew on %s" % (name, out.device))
        moments.append((name, out.double(), mean, var))
    for name, x, mean, var in moments:
        n = x.shape[-1]
        m, v = x.mean(-1).cpu().numpy(), x.var(-1, unbiased=False).cpu(
        ).numpy()
        if not (np.all(np.abs(m - mean) <= 6 * np.sqrt(np.asarray(var) / n))
                and np.all(np.abs(v - var) <= 6 * np.sqrt(
                    8 * np.square(var) / n))):
            raise AssertionError("%s on the card: mean %s var %s, want %s %s"
                                 % (name, m, v, mean, var))
    worst = max(rows, key=lambda r: r[1])
    print("  (v) %d cases of mx.np (every name, and %d at moderate shapes), "
          "mx.np.linalg and mx.npx, forward and "
          "(differentiable set, npx) backward, card against CPU within 4x "
          "the CPU's 1e-6-nudged floor (index inputs not nudged; worst %s "
          "at %.3fx); kernels launched there: %s; %d samplers' draws on the "
          "card within 6 standard errors of their mean and variance"
          % (len(rows), len(cases.MODERATE), worst[0], worst[1],
             launched or "none", len(moments)), flush=True)
    return len(rows)


# phase 3w: the last of the op registry: LARS through the multi-tensor
# updates with a CustomOp head, BERT-base attention through the interleaved
# matmuls, the Faster R-CNN RPN's Proposal, every other new name card
# against CPU

#: (i): upstream MXNet 1.6's large-batch ResNet-50 recipe at one card
LARS = dict(model="resnet50_v1", batch=64, image=224, classes=1000, steps=3,
            lr=0.1, momentum=0.9, wd=1e-4, eta=0.001)
#: (i): the CustomOp head's gradients against the Gluon loss's, of each
#: tensor's largest magnitude (a tensor whose gradient is a sum with much
#: cancellation reads larger; the worst are printed by name)
LARS_GRAD_TOL = 1e-4
#: (ii): GluonNLP BERTEncoder's widths (bert_12_768_12) at seq 512
BERT = dict(units=768, heads=12, seq=512, batch=8, reps=5)
#: (iii): example/rcnn's VGG-16 test setting: a 600x1000 image, the
#: stride-16 map 38x63, 9 anchors
RPN = dict(image=(600, 1000), stride=16, scales=(8, 16, 32),
           ratios=(0.5, 1, 2), pre=6000, post=300, threshold=0.7,
           min_size=16, reps=5)
HEAD_OP = "chip_smoke_softmax_head"
def _softmax_head(mx):
    """Register the reference docs' custom softmax head (once): forward
    ``softmax`` in nd ops, backward ``(p - onehot(label)) / batch``; no
    cotangent reaches it (a loss head)."""
    if HEAD_OP in mx.operator.get_all_registered():
        return HEAD_OP

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        mx.nd.softmax(in_data[0], axis=-1))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p = out_data[0]
            onehot = mx.nd.one_hot(in_data[1], p.shape[1])
            self.assign(in_grad[0], req[0], (p - onehot) / p.shape[0])

    @mx.operator.register(HEAD_OP)
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    return HEAD_OP


def lars_update(nd, weights, grads, moms, lr, wd, eta, momentum):
    """One LARS step over every tensor by one call of each op:
    ``multi_sum_sq`` of the weights and of the gradients,
    ``multi_lars`` and ``preloaded_multi_sgd_mom_update``.  Returns the
    new (weight, mom) NDArrays of each tensor, in order, and the
    learning rates."""
    n = len(weights)
    ctx = weights[0].context
    wss = nd.multi_sum_sq(*weights, num_arrays=n)
    gss = nd.multi_sum_sq(*grads, num_arrays=n)
    lrs = nd.multi_lars(nd.full((n,), lr, ctx=ctx), nd.stack(*wss),
                        nd.stack(*gss), wds=(wd,) * n, eta=eta)
    flat = [a for w, g, m in zip(weights, grads, moms) for a in (w, g, m)]
    outs = nd.preloaded_multi_sgd_mom_update(
        *flat, lrs, nd.full((n,), wd, ctx=ctx), num_weights=n,
        momentum=momentum)
    return outs, lrs


def _plain_lars_lr(w, g, lr, wd, eta):
    """One tensor's LARS learning rate in torch ops (``multi_sum_sq`` and
    ``multi_lars``'s plain version, the same operations on 0-d
    tensors)."""
    import torch

    wn = torch.sqrt(torch.square(w.float()).sum())
    gn = torch.sqrt(torch.square(g.float()).sum()) * 1.0
    wd_t = torch.tensor(wd, dtype=torch.float32, device=w.device)
    trust = torch.where((wn > 0) & (gn > 0), eta * wn / (gn + wd_t * wn
                                                        + 1e-8),
                        torch.ones((), device=w.device))
    return torch.tensor(lr, dtype=torch.float32, device=w.device) * trust, \
        wd_t


def _plain_sgd_mom(w, g, m, lr, wd, momentum):
    """``preloaded_multi_sgd_mom_update``'s plain version for one tensor:
    (weight, mom)."""
    new_m = momentum * m - lr * (g * 1.0 + wd * w)
    return w + new_m, new_m


def lars_on_card(mx, params, moms, cfg):
    """Phase 3w (i): the LARS update over every trained parameter against
    its per-tensor plain version on the card, 0 apart, then
    ``preloaded_multi_mp_sgd_mom_update`` on bf16 copies with float32
    masters likewise; a doubled step misses each.  Commits the f32
    update."""
    import torch

    nd = mx.nd
    weights = [p.data() for p in params]
    grads = [p.grad() for p in params]
    before = [w._data.clone() for w in weights]
    outs, lrs = lars_update(nd, weights, grads, moms, cfg["lr"], cfg["wd"],
                            cfg["eta"], cfg["momentum"])
    got, plain, lr_plain = [], [], []
    for k, (w, g, m) in enumerate(zip(before, grads, moms)):
        lr_k, wd_t = _plain_lars_lr(w, g._data, cfg["lr"], cfg["wd"],
                                    cfg["eta"])
        lr_plain.append(lr_k)
        plain += _plain_sgd_mom(w, g._data, m._data, lr_k, wd_t,
                                cfg["momentum"])
        got += [outs[2 * k]._data, outs[2 * k + 1]._data]
    lr_err = _max_err(lrs._data, torch.stack(lr_plain))
    err = max(_max_err(a, b) for a, b in zip(got, plain))
    miss = max(_max_err(got[2 * k], 2 * plain[2 * k] - before[k])
               for k in range(len(before)))
    if lr_err != 0 or err != 0 or not miss > 0:
        raise AssertionError("LARS update: learning rates %g and tensors %g "
                             "from the plain version (want 0); a doubled "
                             "step %g (must miss)" % (lr_err, err, miss))
    # the mixed-precision form: bf16 weights and gradients, f32 masters
    flat, mp_plain = [], []
    for k, (w32, g, m) in enumerate(zip(before, grads, moms)):
        gb = g._data.to(torch.bfloat16)
        flat += [nd.NDArray(t) for t in (w32.to(torch.bfloat16), gb,
                                         m._data, w32)]
        nw32, nm = _plain_sgd_mom(w32, gb.float(), m._data, lr_plain[k],
                                  torch.tensor(cfg["wd"], device=w32.device),
                                  cfg["momentum"])
        mp_plain += [nw32.to(torch.bfloat16), nm, nw32]
    n = len(before)
    mp = nd.preloaded_multi_mp_sgd_mom_update(
        *flat, lrs, nd.full((n,), cfg["wd"], ctx=weights[0].context),
        num_weights=n, momentum=cfg["momentum"])
    mp_got = [o._data for o in mp]
    mp_err = max(_max_err(a, b) for a, b in zip(mp_got, mp_plain))
    mp_miss = max(_max_err(mp_got[3 * k + 2], 2 * mp_plain[3 * k + 2]
                           - before[k]) for k in range(n))
    if any(a.dtype != b.dtype for a, b in zip(mp_got, mp_plain)) \
            or mp_err != 0 or not mp_miss > 0:
        raise AssertionError("preloaded_multi_mp_sgd_mom_update %g from the "
                             "plain version (want 0); doubled %g"
                             % (mp_err, mp_miss))
    _commit(params, moms, outs)
    print("  (i) LARS over %d tensors (multi_sum_sq x2, multi_lars, "
          "preloaded_multi_sgd_mom_update): learning rates and tensors 0 "
          "from the per-tensor plain version, a doubled step %.3e (misses); "
          "trust-scaled lr %.3e..%.3e; preloaded_multi_mp_sgd_mom_update, "
          "bf16 weights with f32 masters: 0 from its plain version, doubled "
          "%.3e (misses)" % (n, miss, float(lrs._data.min()),
                            float(lrs._data.max()), mp_miss), flush=True)


def _commit(params, moms, outs):
    """Write the update's (weight, mom) pairs into the parameters."""
    for k, p in enumerate(params):
        p.set_data(outs[2 * k])
        moms[k]._set_data(outs[2 * k + 1]._data)


def _lars_commit(mx, params, moms, cfg):
    """A LARS step without its checks (steps 2 on)."""
    outs, _ = lars_update(mx.nd, [p.data() for p in params],
                          [p.grad() for p in params], moms, cfg["lr"],
                          cfg["wd"], cfg["eta"], cfg["momentum"])
    _commit(params, moms, outs)


def run_lars_path(dev, gluon_step_ms):
    """Phase 3w (i), see the module docstring.  Returns (metrics, the
    launch counts of the steps)."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels, autograd, nd

    g = LARS
    head = _softmax_head(mx)
    with _f32_exact():
        net = _zoo_net(dev, g["model"], g["classes"], g["image"])
        params = [p for p in net.collect_params().values()
                  if p.grad_req != "null"]
        rng = np.random.RandomState(SEED)
        x = nd.array(rng.rand(g["batch"], 3, g["image"], g["image"]).astype(
            np.float32), ctx=dev)
        y = nd.array(rng.randint(0, g["classes"], g["batch"]).astype(
            np.float32), ctx=dev)
        glu = _np_gluon_first_step(net, x, y)
        moms = [nd.zeros(p.shape, ctx=dev) for p in params]
        counts = {k: 0 for k in _kernels.launch_counts()}
        losses, step_ms, upd_ms = [], [], []
        for step in range(1, g["steps"] + 1):
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            t = time.perf_counter()
            with autograd.record():
                logits = net(x)
                prob = nd.Custom(logits, y, op_type=head)
            prob.backward()
            step_counts = _kernels.launch_counts()
            if step == 1:
                first = dict(logits=logits._data.detach().clone(),
                             grads=[p.grad()._data.clone() for p in params],
                             names=[p.name for p in params])
            if step == 1:
                lars_on_card(mx, params, moms, g)
            else:
                torch.cuda.synchronize()
                t_upd = time.perf_counter()
                _lars_commit(mx, params, moms, g)
                torch.cuda.synchronize()
                done = time.perf_counter()
                upd_ms.append((done - t_upd) * 1e3)
                step_ms.append((done - t) * 1e3)
            want = {k: int(k == "maxpool_idx_fwd") for k in step_counts}
            if step_counts != want:
                raise AssertionError("LARS step %d launched %s, want %s"
                                     % (step, step_counts, want))
            for k in counts:
                counts[k] += step_counts[k]
            p_np = prob.asnumpy()
            losses.append(float(-np.log(p_np[np.arange(g["batch"]),
                                             y.asnumpy().astype(int)]
                                        + 1e-30).mean()))
        if not _losses_ok(losses):
            raise AssertionError("LARS path losses %s" % losses)
        worst = _lars_against_gluon(first, glu)
    metrics = dict(lars_step_ms=sum(step_ms) / len(step_ms),
                   lars_update_ms=sum(upd_ms) / len(upd_ms),
                   losses=losses, trained=len(params), grad_worst=worst,
                   gluon_step_ms=gluon_step_ms)
    print("  steps 2-%d: %s ms, of which the update %s ms; losses %s"
          % (g["steps"], ["%.2f" % v for v in step_ms],
             ["%.2f" % v for v in upd_ms], ["%.4f" % v for v in losses]),
          flush=True)
    del net, params, moms, x, glu, first
    torch.cuda.empty_cache()
    return metrics, counts


def _lars_against_gluon(first, glu):
    """Phase 3w (i): the CustomOp head's first step against the Gluon net's
    ``SoftmaxCrossEntropyLoss`` step from the same weights and batch:
    logits bit for bit, each gradient within ``LARS_GRAD_TOL`` of the
    tensor's largest magnitude, the worst three printed by name; a doubled
    head gradient misses.  Returns the worst gradient reading."""
    import torch

    if not torch.equal(first["logits"], glu["logits"]):
        raise AssertionError("the CustomOp head's logits differ from the "
                             "Gluon net's")
    if len(first["grads"]) != len(glu["grads"]):
        raise AssertionError("%d gradients, Gluon %d"
                             % (len(first["grads"]), len(glu["grads"])))
    reads = [_rel_max(a, b) for a, b in zip(first["grads"], glu["grads"])]
    worst = max(reads)
    top = sorted(range(len(reads)), key=lambda i: -reads[i])[:3]
    doubled = max(_rel_max(2 * a, b)
                  for a, b in zip(first["grads"], glu["grads"]))
    print("  (i) logits bit for bit the Gluon net's (SoftmaxCrossEntropyLoss); "
          "%d gradients against its, of each tensor's largest magnitude: "
          "median %.3e, worst %s (limit %g); a doubled head gradient %.3e "
          "(misses)" % (
              len(reads), sorted(reads)[len(reads) // 2],
              ", ".join("%s %.3e" % (first["names"][i], reads[i])
                        for i in top), LARS_GRAD_TOL, doubled), flush=True)
    if worst > LARS_GRAD_TOL:
        raise AssertionError("CustomOp head gradients over %g: %s"
                             % (LARS_GRAD_TOL, [(first["names"][i], reads[i])
                                                for i in top]))
    if not doubled > LARS_GRAD_TOL:
        raise AssertionError("the gradient gate passes a doubled head")
    return worst


def _bert_heads(qkv, heads):
    """(S, B, 3 * H * D) interleaved per head -> q, k, v (B, H, S, D)."""
    s, b, proj = qkv.shape
    d = proj // (3 * heads)
    t = qkv.reshape(s, b, heads, 3, d).permute(1, 2, 3, 0, 4)
    return t[:, :, 0], t[:, :, 1], t[:, :, 2]


def _bert_paths():
    """(interleaved, flash): self-attention of an interleaved (S, B, 3U)
    tensor through ``_contrib_interleaved_matmul_selfatt_qk`` ->
    ``softmax`` -> ``..._valatt``, and through ``_contrib_flash_attention``
    (K4, K5/K6 backward) on q, k, v taken from it; (S, B, U) out."""
    from incubator_mxnet_tpu_torch.ops import registry

    ops = registry.OPS
    h = BERT["heads"]

    def interleaved(qkv):
        scores = ops["_contrib_interleaved_matmul_selfatt_qk"].fn(qkv,
                                                                   heads=h)
        att = ops["softmax"].fn(scores, axis=-1)
        return ops["_contrib_interleaved_matmul_selfatt_valatt"].fn(
            qkv, att, heads=h)

    def flash(qkv):
        q, k, v = _bert_heads(qkv, h)
        o = ops["_contrib_flash_attention"].fn(q, k, v, causal=False)
        b, _, s, d = o.shape
        return o.permute(2, 0, 1, 3).reshape(s, b, h * d)

    return interleaved, flash


def _tf32(x):
    """x (float32) rounded to TF32 as the kernels' ``tf32_bits`` rounds it:
    to nearest, ties away from zero, onto 10 mantissa bits."""
    import torch

    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _mm_3xtf32_plain(a, b):
    """a @ b in csrc/flash_attention.cu's 3xTF32 split: each float32
    operand as hi = tf32(x) and lo = tf32(x - hi), the product as three
    TF32 products with float32 sums, lo*hi + hi*lo + hi*hi."""
    import torch

    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    mm = torch.backends.cuda.matmul
    keep, mm.allow_tf32 = mm.allow_tf32, True
    try:
        return torch.matmul(al, bh) + torch.matmul(ah, bl) + \
            torch.matmul(ah, bh)
    finally:
        mm.allow_tf32 = keep


def _mm_3xtf32():
    """``_mm_3xtf32_plain`` as an autograd function whose two gradient
    products are in the same split."""
    import torch

    class Mm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return _mm_3xtf32_plain(a, b)

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            return (_mm_3xtf32_plain(g, b.transpose(-1, -2)),
                    _mm_3xtf32_plain(a.transpose(-1, -2), g))

    return Mm.apply


def _attn_3xtf32(qkv):
    """The self-attention of ``_bert_paths`` in plain torch with every
    product, forward and backward, in K4-K6's 3xTF32 split: the kernels'
    floor."""
    import torch

    mm = _mm_3xtf32()
    q, k, v = _bert_heads(qkv, BERT["heads"])
    b, h, s, d = q.shape
    att = torch.softmax(mm(q / d ** 0.5, k.transpose(-1, -2)), dim=-1)
    return mm(att, v).permute(2, 0, 1, 3).reshape(s, b, h * d)


def _err64(a, b):
    return (a.double() - b.double()).abs().max().item()


def _attn_read(fn, qkv, cot):
    """(out, dq, dk, dv) of ``fn`` at ``qkv`` with cotangent ``cot``."""
    import torch

    x = qkv.detach().clone().requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad((out * cot).sum(), [x])
    return [out.detach()] + [t.contiguous() for t in _bert_heads(
        g, BERT["heads"])]


def run_bert_attention(dev):
    """Phase 3w (ii), see the module docstring.  Returns (metrics, launch
    counts)."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import _kernels

    b = BERT
    rng = np.random.RandomState(SEED + 25)
    qkv = torch.tensor(rng.normal(0, 1, (b["seq"], b["batch"],
                                         3 * b["units"])).astype(np.float32),
                       device=dev)
    cot = torch.tensor(rng.uniform(-1, 1, (b["seq"], b["batch"],
                                           b["units"])).astype(np.float32),
                       device=dev)
    interleaved, flash = _bert_paths()
    names = ("out", "dq", "dk", "dv")
    with _f32_exact():
        ref = _attn_read(interleaved, qkv, cot)
        f64 = _attn_read(interleaved, qkv.double(), cot.double())
        tc = _attn_read(_attn_3xtf32, qkv, cot)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        got = _attn_read(flash, qkv, cot)
        counts = _kernels.launch_counts()
        want = {k: int(k in FLASH) for k in counts}
        if counts != want:
            raise AssertionError("the flash comparison launched %s, want %s"
                                 % (counts, want))
        # (name, K4-K6 against f64, the kernels' floor, K4-K6 against the
        # interleaved f32 path, that path's f64 floor)
        rows = [(n, _err64(g, d), _err64(t, d), _err64(g, r), _err64(r, d))
                for n, r, g, t, d in zip(names, ref, got, tc, f64)]
        if not _err64(2 * got[0], f64[0]) > 4 * rows[0][2]:
            raise AssertionError("the attention gate passes a doubled output")

        def fwd_bwd(fn):
            x = qkv.detach().requires_grad_(True)
            torch.autograd.grad((fn(x) * cot).sum(), [x])

        inter_ms = _time_ms(lambda: fwd_bwd(interleaved), b["reps"])
        flash_ms = _time_ms(lambda: fwd_bwd(flash), b["reps"])
    for n, err, floor, err32, floor32 in rows:
        print("  (ii) %-3s K4-K6 against f64 %.3e, the plain path in 3xTF32 "
              "against f64 %.3e: %.2fx it (limit 4x); K4-K6 against the "
              "interleaved f32 path %.3e, %.2fx that path's f64 floor %.3e"
              % (n, err, floor, err / floor, err32, err32 / floor32, floor32),
              flush=True)
    print("  (ii) a doubled output misses; K4, K5, K6 once each", flush=True)
    for n, err, floor, _, _ in rows:
        if not err <= 4 * floor:
            raise AssertionError("BERT attention %s: K4-K6 %g from f64, over "
                                 "4x the 3xTF32 floor %g" % (n, err, floor))
    return dict(interleaved_attn_ms=inter_ms, flash_attn_ms=flash_ms), counts


def _rpn_inputs(batch, seed):
    """Seeded RPN head outputs at ``RPN``'s map: (cls_prob (N, 18, H, W)
    with each anchor's background and foreground summing to 1, bbox_pred
    (N, 36, H, W), im_info (N, 3))."""
    import math

    import numpy as np

    r = RPN
    fh = math.ceil(r["image"][0] / r["stride"])
    fw = math.ceil(r["image"][1] / r["stride"])
    a = len(r["scales"]) * len(r["ratios"])
    rng = np.random.RandomState(seed)
    fg = rng.rand(batch, a, fh, fw).astype(np.float32)
    cls = np.concatenate([1 - fg, fg], axis=1)
    bbox = rng.normal(0, 0.2, (batch, 4 * a, fh, fw)).astype(np.float32)
    info = np.tile(np.array([[r["image"][0], r["image"][1], 1.0]],
                            np.float32), (batch, 1))
    return cls, bbox, info


def run_proposal(dev):
    """Phase 3w (iii), see the module docstring.  Returns the metrics."""
    import torch

    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.ops import registry

    r = RPN
    fn = registry.OPS["_contrib_Proposal"].fn
    attrs = dict(rpn_pre_nms_top_n=r["pre"], rpn_post_nms_top_n=r["post"],
                 threshold=r["threshold"], rpn_min_size=r["min_size"],
                 scales=r["scales"], ratios=r["ratios"],
                 feature_stride=r["stride"], output_score=True)
    before = _kernels.launch_counts()
    out = {}
    for label, batch in (("Proposal", 1), ("MultiProposal", 2)):
        arrays = _rpn_inputs(batch, SEED + 26)
        card = [t.cpu() for t in fn(*[torch.tensor(a, device=dev)
                                      for a in arrays], **attrs)]
        cpu = fn(*[torch.tensor(a) for a in arrays], **attrs)
        moved = int((card[0] != cpu[0]).any(dim=1).sum())
        same_scores = torch.equal(card[1], cpu[1])
        print("  (iii) %s: map %s, %d anchors a position, batch %d: %d rois "
              "(%d distinct), %d rows differ card against CPU, scores %s"
              % (label, tuple(arrays[0].shape[2:]), arrays[0].shape[1] // 2,
                 batch, card[0].shape[0], len(torch.unique(card[0], dim=0)),
                 moved, "equal" if same_scores else "DIFFER"), flush=True)
        if moved or not same_scores:
            raise AssertionError("%s: rois or scores differ card against CPU"
                                 % label)
        ts = [torch.tensor(a, device=dev) for a in arrays]
        out[label.lower() + "_ms"] = _time_ms(lambda: fn(*ts, **attrs),
                                              r["reps"])
    if _kernels.launch_counts() != before:
        raise AssertionError("Proposal launched a kernel")
    return out


def _w_cases(rng):
    """(label, op name, arrays, attrs) of phase 3w (iv): every new name but
    the samplers and ``Custom`` (checked apart), at moderate shapes;
    index inputs are integers (not nudged)."""
    import numpy as np

    def n(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def i(hi, *shape):
        return rng.randint(0, hi, shape).astype(np.int64)

    w16 = u(0, 1, 64, 256).astype(np.float16)
    hawkes_k, hawkes_n, hawkes_t = 4, 64, 48
    lags = rng.exponential(0.5, (hawkes_n, hawkes_t)).astype(np.float32)
    anchors = np.sort(u(0, 1, 4, 256, 4).reshape(4, 256, 2, 2), axis=2
                      ).transpose(0, 1, 3, 2).reshape(4, 256, 4)
    rois = np.concatenate([np.zeros((32, 1), np.float32),
                           np.sort(u(0, 60, 32, 2, 2), axis=1).reshape(
                               32, 4)], axis=1)
    cases = [(nm, nm, [n(64, 256), n(64, 256)], {})
             for nm in ("equal", "not_equal", "greater", "greater_equal",
                        "less", "less_equal", "_grad_add", "_hypot")]
    cases += [(nm, nm, [n(64, 256)], dict(scalar=s)) for nm, s in (
        ("_scatter_plus_scalar", 1.5), ("_scatter_minus_scalar", 1.5),
        ("_logical_and_scalar", 2.0), ("_logical_or_scalar", 0.0),
        ("_logical_xor_scalar", 1.0), ("_hypot_scalar", 0.75))]
    cases += [
        ("BatchNorm_v1", "BatchNorm_v1", [n(8, 32, 16, 16), u(0.5, 1.5, 32),
                                          n(32), n(32), u(0.5, 1.5, 32)],
         dict(fix_gamma=False)),
        ("moments", "moments", [n(8, 64, 32) + 3], dict(axes=(0, 2))),
        ("reshape_like", "reshape_like", [n(64, 256), n(128, 128)], {}),
        ("softmax_cross_entropy", "softmax_cross_entropy",
         [n(256, 1000), i(1000, 256)], {}),
        ("_histogram", "_histogram", [n(64, 256)], dict(bin_cnt=50)),
        ("histogram", "histogram", [n(64, 256)],
         dict(bin_cnt=20, range=(-2.0, 2.0))),
        ("_ravel_multi_index", "_ravel_multi_index",
         [np.stack([i(64, 4096), i(32, 4096), i(16, 4096)])],
         dict(shape=(64, 32, 16))),
        ("_unravel_index", "_unravel_index", [i(64 * 32 * 16, 4096)],
         dict(shape=(64, 32, 16))),
        ("_slice_assign", "_slice_assign", [n(64, 256), n(16, 64)],
         dict(begin=(8, 0), end=(40, 256), step=(2, 4))),
        ("_slice_assign_scalar", "_slice_assign_scalar", [n(64, 256)],
         dict(scalar=3.0, begin=(60, 250), end=(2, 10), step=(-3, -4))),
        ("_split_v2", "_split_v2", [n(64, 256)], dict(indices=(50, 130),
                                                       axis=1)),
        ("_identity_with_attr_like_rhs", "_identity_with_attr_like_rhs",
         [n(64, 256), n(3)], {}),
        ("_np_all", "_np_all", [np.round(u(0, 1.2, 64, 256))],
         dict(axis=1)),
        ("all", "all", [u(0.1, 1, 64, 256)], {}),
        ("_np_any", "_np_any", [np.round(u(0, 0.51, 64, 256))],
         dict(axis=(0,), keepdims=True)),
        ("any", "any", [np.zeros((8, 8), np.float32)], {}),
        ("im2col", "im2col", [n(8, 16, 32, 32)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
        ("col2im", "col2im", [n(8, 16 * 9, 256)],
         dict(output_size=(32, 32), kernel=(3, 3), stride=(2, 2),
              pad=(1, 1))),
        ("_contrib_round_ste", "_contrib_round_ste", [n(64, 256) * 3], {}),
        ("_contrib_sign_ste", "_contrib_sign_ste", [n(64, 256)], {}),
        ("_contrib_gradientmultiplier", "_contrib_gradientmultiplier",
         [n(64, 256)], dict(scalar=-0.25)),
        ("_contrib_quadratic", "_contrib_quadratic", [n(64, 256)],
         dict(a=0.5, b=-1.0, c=2.0)),
        ("_npx_quadratic", "_npx_quadratic", [n(64, 256)], dict(a=1.5)),
        ("_contrib_allclose", "_contrib_allclose", [n(64, 256), n(64, 256)],
         {}),
        ("_contrib_arange_like", "_contrib_arange_like", [n(64, 256)],
         dict(start=-5.0, step=0.25, repeat=3)),
        ("_contrib_getnnz", "_contrib_getnnz",
         [np.round(u(0, 1, 64, 256))], dict(axis=1)),
        ("_contrib_box_encode", "_contrib_box_encode",
         [np.round(u(0, 1, 4, 256)), i(256, 4, 256), anchors,
          anchors[:, ::-1].copy()], {}),
        ("_contrib_box_decode", "_contrib_box_decode",
         [n(4, 256, 4) * 0.3, anchors], dict(clip=0.9)),
        ("multi_sum_sq", "multi_sum_sq", [n(64, 256), n(1000),
                                          n(8, 3, 3, 3)],
         dict(num_arrays=3)),
        ("reset_arrays", "reset_arrays", [n(64, 256), n(1000)],
         dict(num_arrays=2)),
        ("multi_lars", "multi_lars", [u(0.05, 0.2, 161), u(0, 40, 161),
                                      u(0, 4, 161)],
         dict(wds=(1e-4,) * 161, eta=0.001)),
        ("mp_nag_mom_update", "mp_nag_mom_update",
         [w16, n(64, 256).astype(np.float16), n(64, 256),
          w16.astype(np.float32)], dict(lr=0.1, momentum=0.9, wd=1e-4)),
        ("mp_lamb_update_phase1", "mp_lamb_update_phase1",
         [w16, n(64, 256).astype(np.float16), n(64, 256) * 0.1,
          u(0, 1, 64, 256), w16.astype(np.float32)],
         dict(t=5, wd=0.01)),
        ("mp_lamb_update_phase2", "mp_lamb_update_phase2",
         [w16, n(64, 256), u(1, 2, 1), u(0.5, 1, 1),
          w16.astype(np.float32)], dict(lr=0.01)),
        ("_mp_adamw_update", "_mp_adamw_update",
         [w16, n(64, 256).astype(np.float16), n(64, 256) * 0.1,
          u(0, 1, 64, 256), w16.astype(np.float32)],
         dict(lr=0.01, wd=0.01)),
        ("preloaded_multi_sgd_update", "preloaded_multi_sgd_update",
         [n(64, 256), n(64, 256), n(1000), n(1000), u(0, 0.1, 2),
          u(0, 1e-3, 2)], dict(num_weights=2)),
        ("preloaded_multi_sgd_mom_update", "preloaded_multi_sgd_mom_update",
         [n(64, 256), n(64, 256), n(64, 256), n(1000), n(1000), n(1000),
          u(0, 0.1, 2), u(0, 1e-3, 2)], dict(num_weights=2, momentum=0.9)),
        ("preloaded_multi_mp_sgd_update", "preloaded_multi_mp_sgd_update",
         [w16, n(64, 256).astype(np.float16), w16.astype(np.float32),
          u(0, 0.1, 1), u(0, 1e-3, 1)], dict(num_weights=1)),
        ("preloaded_multi_mp_sgd_mom_update",
         "preloaded_multi_mp_sgd_mom_update",
         [w16, n(64, 256).astype(np.float16), n(64, 256),
          w16.astype(np.float32), u(0, 0.1, 1), u(0, 1e-3, 1)],
         dict(num_weights=1, momentum=0.9)),
        ("_contrib_group_adagrad_update", "_contrib_group_adagrad_update",
         [n(64, 256), n(64, 256), u(0, 1, 64)], dict(lr=0.05)),
        ("IdentityAttachKLSparseReg", "IdentityAttachKLSparseReg",
         [u(0.05, 0.95, 64, 256)], dict(sparseness_target=0.2,
                                         penalty=0.01)),
        ("_contrib_hawkesll", "_contrib_hawkesll",
         [u(0.1, 0.5, hawkes_k), u(0.1, 0.4, hawkes_k), u(0.5, 2, hawkes_k),
          lags, i(hawkes_k, hawkes_n, hawkes_t),
          rng.randint(1, hawkes_t + 1, hawkes_n).astype(np.int64),
          lags.sum(1) + 1.0], {}),
        ("GridGenerator-affine", "GridGenerator", [n(8, 6)],
         dict(transform_type="affine", target_shape=(32, 48))),
        ("GridGenerator-warp", "GridGenerator", [n(8, 2, 32, 48)],
         dict(transform_type="warp")),
        ("BilinearSampler", "BilinearSampler", [n(8, 16, 32, 32),
                                                u(-1.1, 1.1, 8, 2, 24, 24)],
         {}),
        ("SpatialTransformer", "SpatialTransformer",
         [n(8, 16, 32, 32), np.tile(np.array([[0.9, 0.1, 0.05, -0.1, 0.8,
                                               0.0]], np.float32), (8, 1))
          + n(8, 6) * 0.05], dict(target_shape=(24, 24))),
        ("Crop", "Crop", [n(8, 16, 32, 32), n(8, 1, 20, 24)],
         dict(num_args=2, center_crop=True)),
        ("Correlation", "Correlation", [n(4, 32, 24, 32), n(4, 32, 24, 32)],
         dict(kernel_size=3, max_displacement=4, stride2=2, pad_size=4)),
        ("Correlation-absdiff", "Correlation", [n(4, 16, 24, 32),
                                                n(4, 16, 24, 32)],
         dict(kernel_size=1, max_displacement=2, is_multiply=False)),
        ("DeformablePSROIPooling", "_contrib_DeformablePSROIPooling",
         [n(4, 2 * 9, 16, 16), rois, n(32, 2, 3, 3)],
         dict(spatial_scale=0.25, output_dim=2, group_size=3, pooled_size=3,
              part_size=3, sample_per_part=2, trans_std=0.1)),
        ("SyncBatchNorm", "_contrib_SyncBatchNorm",
         [n(8, 32, 16, 16), u(0.5, 1.5, 32), n(32), n(32), u(0.5, 1.5, 32)],
         dict(fix_gamma=False, ndev=2, key="bn")),
        ("div_sqrt_dim", "_contrib_div_sqrt_dim", [n(64, 8, 96)], {}),
        ("interleaved_matmul_encdec_qk",
         "_contrib_interleaved_matmul_encdec_qk",
         [n(40, 4, 4 * 32), n(56, 4, 4 * 32 * 2)], dict(heads=4)),
        ("interleaved_matmul_encdec_valatt",
         "_contrib_interleaved_matmul_encdec_valatt",
         [n(56, 4, 4 * 32 * 2), u(0, 0.05, 16, 40, 56)], dict(heads=4)),
        ("fft", "_contrib_fft", [n(64, 256)], {}),
        ("ifft", "_contrib_ifft", [n(64, 512)], {}),
        ("count_sketch", "_contrib_count_sketch",
         [n(64, 256), i(100, 1, 256), np.sign(n(1, 256))],
         dict(out_dim=100)),
        ("boolean_mask", "_contrib_boolean_mask",
         [n(256, 64), i(2, 256)], {}),
        ("index_copy", "_contrib_index_copy",
         [n(256, 64), rng.permutation(256)[:64].astype(np.int64),
          n(64, 64)], {}),
        ("index_array", "_contrib_index_array", [n(16, 32, 8)],
         dict(axes=(2, 0))),
        ("_zeros_without_dtype", "_zeros_without_dtype", [],
         dict(shape=(64, 256))),
    ]
    return cases


def tail_w_card_vs_cpu(dev):
    """Phase 3w (iv), see the module docstring.  Returns the number of
    cases."""
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.ops import registry

    rng = np.random.RandomState(SEED + 27)
    rows, controls, misses = [], 0, []
    before = _kernels.launch_counts()
    with _f32_exact():
        for label, opname, arrays, attrs in _w_cases(rng):
            op = registry.get_op(opname)
            if not arrays:
                a = op.fn(ctx=dev, **attrs).cpu()
                b = op.fn(ctx="cpu", **attrs)
                if a.dtype != b.dtype or not torch.equal(a, b):
                    misses.append("%s differs" % label)
                rows.append((label, 0.0))
                continue

            def fn_of(_, fn=op.fn, attrs=attrs):
                return lambda *ts: fn(*ts, **attrs)

            # every case is held; the misses are reported together
            held = []
            try:
                _, worst = _card_vs_cpu(label, fn_of, arrays, dev,
                                        controls=held)
            except AssertionError as exc:
                misses.append(str(exc))
                continue
            rows.append((label, worst))
            controls += len(held)
        # Custom: eager, recorded, and through mx.sym into an Executor
        rows += _custom_card_vs_cpu(mx, dev)
    if misses:
        raise AssertionError("phase 3w (iv): %d of %d cases miss: %s"
                             % (len(misses), len(rows) + len(misses),
                                "; ".join(misses)))
    launched = {k: v - before[k] for k, v in _kernels.launch_counts().items()
                if v != before[k]}
    if launched:
        raise AssertionError("phase 3w (iv) launched %s" % launched)
    moments = _w_samplers_on_card(mx, dev)
    worst = max(rows, key=lambda r: r[1])
    print("  (iv) %d cases (every new name but the samplers, Proposal and "
          "the self-attention matmuls), forward and backward, card against "
          "CPU within 4x the CPU's 1e-6-nudged floor (worst %s at %.3fx), "
          "%d controls (zeroed, doubled, negated) missing; no kernel "
          "launched; %d samplers' draws on the card within 6 standard "
          "errors of their mean and variance" % (
              len(rows), worst[0], worst[1], controls, moments), flush=True)
    return len(rows)


#: name -> (attrs, mean, variance) of the *_like samplers on the card
W_SAMPLERS = {
    "_random_uniform_like": (dict(low=2.0, high=3.0), 2.5, 1.0 / 12),
    "_random_normal_like": (dict(loc=5.0, scale=0.1), 5.0, 0.01),
    "_random_exponential_like": (dict(lam=4.0), 0.25, 1.0 / 16),
    "_random_gamma_like": (dict(alpha=3.0, beta=0.5), 1.5, 0.75),
    "_random_poisson_like": (dict(lam=3.5), 3.5, 3.5),
    "_random_negative_binomial_like": (dict(k=4, p=0.4), 6.0, 15.0),
    "_random_generalized_negative_binomial_like": (
        dict(mu=2.0, alpha=0.5), 2.0, 4.0),
}


def _w_samplers_on_card(mx, dev):
    """The ``*_like`` samplers drawn on the card (shape, dtype, device, and
    1M draws within 6 standard errors of their mean and variance), and
    ``_sample_unique_zipfian``'s candidates on the card, distinct."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch.ops import registry

    mx.random.seed(SEED)
    base = torch.zeros((1000, 1000), device=dev)
    for name, (attrs, mean, var) in W_SAMPLERS.items():
        x = registry.OPS[name].fn(base, **attrs)
        if x.device != dev or x.shape != base.shape or x.dtype != base.dtype:
            raise AssertionError("%s drew %s %s on %s" % (name, x.dtype,
                                                          tuple(x.shape),
                                                          x.device))
        x = x.double()
        m, v = float(x.mean()), float(x.var(unbiased=False))
        nn = x.numel()
        if not (abs(m - mean) <= 6 * np.sqrt(var / nn)
                and abs(v - var) <= 6 * np.sqrt(8 * var * var / nn)):
            raise AssertionError("%s on the card: mean %g var %g, want %g %g"
                                 % (name, m, v, mean, var))
    cand, trials = registry.OPS["_sample_unique_zipfian"].fn(
        range_max=50000, shape=(4096,), ctx=dev)
    if cand.device != dev or len(torch.unique(cand)) != 4096 \
            or int(cand.max()) >= 50000 or int(trials[0]) < 4096:
        raise AssertionError("_sample_unique_zipfian on the card")
    return len(W_SAMPLERS) + 1


CUSTOM_OP = "chip_smoke_twoout"


def _custom_ops(mx):
    """A CustomOp in nd ops (once): ``chip_smoke_twoout`` (x * sigmoid(x)
    and x^2 / 2, two outputs) for the eager, recorded and symbolic
    checks."""
    if CUSTOM_OP in mx.operator.get_all_registered():
        return CUSTOM_OP

    class TwoOut(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], x * mx.nd.sigmoid(x))
            self.assign(out_data[1], req[1], x * x * 0.5)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0]
            s = mx.nd.sigmoid(x)
            self.assign(in_grad[0], req[0], out_grad[0] * (s + x * s * (1 - s))
                        + out_grad[1] * x)

    @mx.operator.register(CUSTOM_OP)
    class TwoOutProp(mx.operator.CustomOpProp):
        def list_outputs(self):
            return ["swish", "half_square"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return TwoOut()

    return CUSTOM_OP


def _custom_card_vs_cpu(mx, dev):
    """``Custom`` with two outputs card against CPU: eager (outputs equal
    the nd expression's on the same device), recorded (outputs and the
    input gradient within 4x the nudged floor, with the controls) and
    through ``mx.sym`` into an ``Executor`` (forward and backward equal
    the recorded call's on the same device).  Returns the rows."""
    import numpy as np
    import torch

    from incubator_mxnet_tpu_torch import autograd, context
    from incubator_mxnet_tpu_torch.ndarray import NDArray

    op_type = _custom_ops(mx)
    x = np.random.RandomState(SEED + 28).normal(0, 1, (64, 256)).astype(
        np.float32)

    def fn_of(device):
        def run(t):
            a = NDArray(t)
            with context.device_scope(device):
                if t.requires_grad:
                    with autograd.record():
                        out = mx.nd.Custom(a, op_type=op_type)
                else:
                    out = mx.nd.Custom(a, op_type=op_type)
            return [o._data for o in out]
        return run

    rows = [("Custom (recorded)", _card_vs_cpu("Custom", fn_of, [x], dev,
                                                controls=[])[1])]
    xt = mx.nd.array(x, ctx=dev)
    eager = mx.nd.Custom(xt, op_type=op_type)
    want = [xt * mx.nd.sigmoid(xt), xt * xt * 0.5]
    for a, b in zip(eager, want):
        if a.context != dev or not torch.equal(a._data, b._data):
            raise AssertionError("Custom eager on the card differs from its "
                                 "nd expression")
    sym = mx.sym.Custom(mx.sym.Variable("data"), op_type=op_type, name="two")
    if sym.list_outputs() != ["two_output0", "two_output1"]:
        raise AssertionError("Custom composed %s" % sym.list_outputs())
    exe = sym.bind(dev, {"data": mx.nd.array(x, ctx=dev)},
                   args_grad={"data": mx.nd.zeros(x.shape, ctx=dev)})
    outs = exe.forward(is_train=True)
    heads = [mx.nd.ones(x.shape, ctx=dev), mx.nd.full(x.shape, 0.5, ctx=dev)]
    exe.backward(heads)
    v = mx.nd.array(x, ctx=dev)
    v.attach_grad()
    with autograd.record():
        rec = mx.nd.Custom(v, op_type=op_type)
        loss = (rec[0] * heads[0]).sum() + (rec[1] * heads[1]).sum()
    loss.backward()
    if not (all(torch.equal(a._data, b._data) for a, b in zip(outs, rec))
            and torch.equal(exe.grad_dict["data"]._data, v.grad._data)):
        raise AssertionError("Custom through the Executor differs from the "
                             "recorded call on the card")
    rows.append(("Custom (eager, Executor)", 0.0))
    return rows


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", default=None, metavar="DIR",
                    help="also time the K1 and K2 of the tree unpacked under "
                         "DIR in phase 4")
    # one rank of phase 3l (i)-(iii); phase 3l (iv) in a process of its own
    ap.add_argument("--dp-rank", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dp-nccl", action="store_true", help=argparse.SUPPRESS)
    # one rank of phase 3m: DIR and the stage (train or restore)
    ap.add_argument("--elastic-rank", nargs=2, default=None,
                    metavar=("DIR", "STAGE"), help=argparse.SUPPRESS)
    # one rank of phase 3n
    ap.add_argument("--mp-rank", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    # one rank of phase 3o, started by the Supervisor
    ap.add_argument("--supervised-rank", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.dp_rank:
        dp_rank_main(args.dp_rank)
        return 0
    if args.dp_nccl:
        run_dp_nccl(torch.device("cuda", 0), _card_line())
        return 0
    if args.elastic_rank:
        return elastic_rank_main(*args.elastic_rank)
    if args.mp_rank:
        mp_rank_main(args.mp_rank)
        return 0
    if args.supervised_rank:
        return supervised_rank_main(args.supervised_rank)
    from incubator_mxnet_tpu_torch import _kernels

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = _card_line()
    print("[1] card: %s" % card, flush=True)
    build_s = _kernels.build()
    print("[1] kernels built in %.1f s; compile cache %s (%s)"
          % (build_s, _kernels.compile_cache().counters(),
             _kernels.compile_cache().directory), flush=True)

    print("[2] kernels against their plain versions", flush=True)
    errs = {name: [] for name in _kernels.KERNELS}
    check_kernels(dev, errs)
    check_flash(dev, errs)
    print("[2c] K7 (bn_copy) and the rtc kernels R1/R2 against their plain "
          "versions", flush=True)
    rtc_kernels = check_copy_and_rtc(dev, errs)

    print("[3] ResNet path: resnet50_v1(ghost_bn=16) batch %d, %d px, bf16, "
          "%d steps" % (BATCH, IMAGE, STEPS), flush=True)
    losses, step_ms, layers, counts = run_main_path(dev)
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    print("[3] step_ms %.2f (median of steps 2-%d)  %.1f img/s  on %s"
          % (steady, STEPS, BATCH / steady * 1e3, card), flush=True)
    torch.cuda.empty_cache()

    print("[3b] LM path: LongContextLM dim %d, %d heads, seq %d, batch %d, "
          "%d layers, f32, %d steps" % (LM["dim"], LM["heads"], LM_SEQ,
                                        LM_BATCH, LM["n_layers"], STEPS),
          flush=True)
    _, lm_ms, lm_counts = run_lm_path(dev)
    counts.update({name: lm_counts[name] for name in FLASH})
    lm_steady = sorted(lm_ms[1:])[len(lm_ms[1:]) // 2]
    print("[3b] lm_step_ms %.2f (median of steps 2-%d)  %.1f tokens/s  on %s"
          % (lm_steady, STEPS, LM_BATCH * LM_SEQ / lm_steady * 1e3, card),
          flush=True)
    torch.cuda.empty_cache()
    print("[3b] LM path at %d heads (head dim %d): the D <= 256 form of "
          "K4-K6" % (LM_HEADS_D256, LM["dim"] // LM_HEADS_D256), flush=True)
    _, d256_ms, d256_counts = run_lm_path(dev, LM_HEADS_D256)
    counts.update({name: counts[name] + d256_counts[name] for name in FLASH})
    d256_steady = sorted(d256_ms[1:])[len(d256_ms[1:]) // 2]
    print("[3b] lm_step_ms_d256 %.2f (median of steps 2-%d)  %.1f tokens/s  "
          "on %s" % (d256_steady, STEPS, LM_BATCH * LM_SEQ / d256_steady * 1e3,
                     card), flush=True)
    torch.cuda.empty_cache()
    print("[3b] LM path at %d heads (head dim %d): the D-streamed form of "
          "K4-K6" % (LM_HEADS_D512, LM["dim"] // LM_HEADS_D512), flush=True)
    _, d512_ms, d512_counts = run_lm_path(dev, LM_HEADS_D512)
    counts.update({name: counts[name] + d512_counts[name] for name in FLASH})
    d512_steady = sorted(d512_ms[1:])[len(d512_ms[1:]) // 2]
    print("[3b] lm_step_ms_d512 %.2f (median of steps 2-%d)  %.1f tokens/s  "
          "on %s" % (d512_steady, STEPS, LM_BATCH * LM_SEQ / d512_steady * 1e3,
                     card), flush=True)
    torch.cuda.empty_cache()

    print("[3c] nd path: one causal attention layer of the LM (x (%d, %d, "
          "%d), 4 weights (%d, %d), %d heads) with nd + autograd, f32, %d "
          "steps, then R1 and R2 through rtc" % (
              LM_BATCH, LM_SEQ, LM["dim"], LM["dim"], LM["dim"], LM["heads"],
              STEPS), flush=True)
    nd_ms, nd_counts = run_nd_path(dev, rtc_kernels)
    counts.update({name: nd_counts[name] for name in RTC})
    nd_steady = sorted(nd_ms[1:])[len(nd_ms[1:]) // 2]
    print("[3c] nd_step_ms %.2f (median of steps 2-%d)  on %s"
          % (nd_steady, STEPS, card), flush=True)

    print("[3d] ResNet path fed from RecordIO: %d-record shard, "
          "ImageRecordUInt8Iter, %d steps with a checkpoint after step %d, "
          "resumed in a new net, step and iterator" % (RECORDS, STEPS,
                                                        SAVE_AFTER),
          flush=True)
    directory = tempfile.mkdtemp(prefix="chip_smoke_recordio_")
    try:
        rio, rio_counts = run_recordio_path(dev, directory)
        for name in MAIN_PATH:
            counts[name] += rio_counts[name]
        print("[3d] recordio_step_ms %.2f (median of steps 2-%d, next() "
              "included; phase 3's step_ms %.2f)  %.1f img/s  iter_ms %.2f  "
              "h2d_ms %.3f  save %.0f ms (%d bytes)  restore %.0f ms  on %s"
              % (rio["recordio_step_ms"], STEPS, steady,
                 BATCH / rio["recordio_step_ms"] * 1e3, rio["iter_ms"],
                 rio["h2d_ms"], rio["save_ms"], rio["save_bytes"],
                 rio["restore_ms"], card), flush=True)

        print("[3e] ImageNet trainer path: train_imagenet_torch.py at its "
              "defaults (stock-BN resnet50_v1), %d steps from the resident "
              "batch, then %d from phase 3d's shard by ImageRecordIter"
              % (IMAGENET_STEPS, IMAGENET_RIO_STEPS), flush=True)
        imagenet, in_counts = run_imagenet_path(
            dev, os.path.join(directory, "synth%d" % IMAGE))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    counts["maxpool_idx_fwd"] += in_counts["maxpool_idx_fwd"]
    print("[3e] imagenet_step_ms %.2f (median of steps 3-%d)  %.1f img/s  "
          "from RecordIO %.2f (median of its steps 2-%d)  on %s"
          % (imagenet["imagenet_step_ms"], IMAGENET_STEPS,
             imagenet["img_s"], imagenet["imagenet_rio_step_ms"],
             IMAGENET_RIO_STEPS, card), flush=True)

    print("[3f] the zoo: one net of each family, full width, batch %d, "
          "bf16, lr %g, %d steps" % (ZOO_BATCH, ZOO_LR, ZOO_STEPS),
          flush=True)
    _, zoo_counts = run_zoo_nets(dev)
    counts["maxpool_idx_fwd"] += zoo_counts["maxpool_idx_fwd"]

    print("[3g] Gluon example's loop: image_classification_torch.py "
          "through its functions, %s, batch %d, %d px, %d classes, "
          "hybridized, Trainer sgd lr %g over kv.create('device'), "
          "Accuracy, %d steps" % (GLUON["model"], GLUON["batch"],
                                  GLUON["image"], GLUON["classes"],
                                  GLUON["lr"], GLUON["steps"]), flush=True)
    gl, gl_counts = run_gluon_path(dev)
    counts["maxpool_idx_fwd"] += gl_counts["maxpool_idx_fwd"]
    print("[3g] gluon_step_ms %.2f (median of steps 3-%d, trainer.step "
          "included)  %.1f img/s  trainer_step_ms %.2f (host time in "
          "trainer.step, %d parameters a step)  K3 launches %d  on %s"
          % (gl["gluon_step_ms"], GLUON["steps"], gl["img_s"],
             gl["trainer_step_ms"], gl["trained"],
             gl_counts["maxpool_idx_fwd"], card), flush=True)
    print("[3g-ii] Trainer.make_fused_step on resnet50_v1(ghost_bn=16), "
          "batch %d, bf16, multi_precision, dynamic loss scale, beside "
          "make_train_step, %d steps, cuDNN deterministic"
          % (GLUON_FUSED_BATCH, GLUON_FUSED_STEPS), flush=True)
    _, fused_counts = run_gluon_fused(dev)
    for name in MAIN_PATH:
        counts[name] += fused_counts[name]

    print("[3h] the Module path: train_mnist_torch.py through its "
          "functions, Module.fit one epoch of its synthetic set at batch %d "
          "(sgd lr %g, momentum 0.9, kv.create('local'), Speedometer, "
          "validation), LeNet then the MLP" % (MNIST["batch"], MNIST["lr"]),
          flush=True)
    t_mnist = time.perf_counter()
    for network in ("lenet", "mlp"):
        mn, mn_counts = run_mnist_path(dev, network)
        counts["maxpool_idx_fwd"] += mn_counts["maxpool_idx_fwd"]
        print("[3h] %s module_step_ms %.3f (median of steps 3-%d, "
              "forward_backward + update + update_metric)  %.1f img/s  "
              "fit %.2f s  K3 launches %d (%d forwards)  on %s"
              % (network, mn["module_step_ms"], mn["steps"], mn["img_s"],
                 mn["wall_s"], mn_counts["maxpool_idx_fwd"], mn["forwards"],
                 card), flush=True)
    print("[3h] phase wall time %.2f s" % (time.perf_counter() - t_mnist),
          flush=True)

    print("[3i] the word LM: example/rnn/word_lm/train_torch.py through its "
          "functions, vocab %d, embedding %d, hidden %d, %d LSTM layers, "
          "batch %d, bptt %d, f32 (TF32 off), sgd lr %g, %d steps"
          % (WORDLM["vocab"], WORDLM["emsize"], WORDLM["nhid"],
             WORDLM["nlayers"], WORDLM["batch"], WORDLM["bptt"],
             WORDLM["lr"], WORDLM["steps"]), flush=True)
    t_rnn = time.perf_counter()
    wl, _ = run_word_lm_path(dev)
    print("[3i] wordlm_step_ms %.2f (median of steps 3-%d, the loss read "
          "back each step)  %.1f tokens/s  first window's loss %.7f -> %.7f "
          "after the steps; no kernel launches  on %s"
          % (wl["wordlm_step_ms"], WORDLM["steps"], wl["tokens_s"],
             wl["first"], wl["again"], card), flush=True)
    torch.cuda.empty_cache()
    print("[3i-ii] BucketingModule over BucketSentenceIter: vocab %d, "
          "embedding %d, hidden %d, %d LSTM layers, batch %d, buckets %s, "
          "%d batches a bucket, Module.fit two epochs (sgd lr %g, wd %g, "
          "Perplexity), the unrolled LSTMCell stack then FusedRNNCell"
          % (BUCKETING["vocab"], BUCKETING["num_embed"],
             BUCKETING["num_hidden"], BUCKETING["num_layers"],
             BUCKETING["batch"], list(BUCKETING["buckets"]),
             BUCKETING["per_bucket"], BUCKETING["lr"], BUCKETING["wd"]),
          flush=True)
    for fused in (False, True):
        bk, _ = run_bucketing_path(dev, fused)
        print("[3i-ii] %s bucket_step_ms %.2f (median of the second "
              "epoch's %d steps, forward_backward + update + "
              "update_metric; the first epoch's, binding included, %.2f)  "
              "buckets bound %d  fit %.2f s  no kernel launches  on %s"
              % ("FusedRNNCell" if fused else "LSTMCell stack",
                 bk["bucket_step_ms"], bk["steps"], bk["first_epoch_ms"],
                 bk["buckets"], bk["wall_s"], card), flush=True)
    torch.cuda.empty_cache()
    print("[3i] phases 3i and 3i-ii wall time %.2f s"
          % (time.perf_counter() - t_rnn), flush=True)

    print("[3j] SSD: example/ssd/train_torch.py through its functions at "
          "the JAX example's defaults: TinySSD, batch %d, 32 px, %d "
          "anchors, %d batches, sgd lr %g, f32 (TF32 off)"
          % (SSD["batch"], SSD["anchors"], SSD["batches"], SSD["lr"]),
          flush=True)
    t_ssd = time.perf_counter()
    ssd = run_ssd_path(dev, rtc_kernels)
    print("[3j] ssd_step_ms %.2f (median of steps 3-%d, each synchronized)"
          "  %.1f img/s  mean loss of the first 20 batches %.6f -> of the "
          "last 20 %.6f; decode %.2f ms; no launch of K1-K7, R1, R2  on %s"
          % (ssd["ssd_step_ms"], SSD["batches"], ssd["img_s"],
             ssd["first"], ssd["last"], ssd["decode_ms"], card), flush=True)
    print("[3j-ii] the multibox head at SSD300's scale, forward: %d "
          "anchors (maps %s), batch %d, %d classes + background, 1-%d "
          "boxes an image, MultiBoxTarget %s, softmax, MultiBoxDetection "
          "%s" % (SSD300["anchors"], list(SSD300["maps"]), SSD300["batch"],
                  SSD300["classes"], SSD300["max_boxes"], SSD300["target"],
                  SSD300["detection"]), flush=True)
    mb = run_multibox_ssd300(dev)
    nms_ms = mb["multibox_detection_ms"] - mb["multibox_detection_no_nms_ms"]
    print("[3j-ii] multibox_target_ms %.3f (%d launches a call, device "
          "busy %.3f ms)  multibox_detection_ms %.3f (%d launches, busy "
          "%.3f ms; without NMS %.3f ms, %d launches: the greedy pass over "
          "%d rows %.3f ms, %.1f %% of the op)  (CUDA events, median of "
          "%d)  on %s" % (
              mb["multibox_target_ms"], mb["target_launches"],
              mb["target_busy_ms"], mb["multibox_detection_ms"],
              mb["detection_launches"], mb["detection_busy_ms"],
              mb["multibox_detection_no_nms_ms"],
              mb["detection_no_nms_launches"], mb["nms_rows"], nms_ms,
              100.0 * nms_ms / mb["multibox_detection_ms"], SSD300["reps"],
              card), flush=True)
    print("[3j] phases 3j and 3j-ii wall time %.2f s"
          % (time.perf_counter() - t_ssd), flush=True)

    print("[3k] the symbolic deploy path: resnet50_v1(ghost_bn=16) "
          "exported, SymbolBlock.imports, load_checkpoint + simple_bind, "
          "Executor steps against Gluon steps, Module fine-tune; batch %d, "
          "%d px, f32, cuDNN deterministic" % (SYMBOLIC["batch"],
                                               SYMBOLIC["image"]),
          flush=True)
    t_sym = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        sm, sm_counts = run_symbolic_path(dev, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    for name in MAIN_PATH:
        counts[name] += sm_counts[name]
    print("[3k] export %.0f ms (symbol %d bytes, params %d bytes)  "
          "load_checkpoint %.0f ms  simple_bind %.0f ms  symbol_step_ms %.2f"
          "  gluon_step_ms %.2f (medians of steps 2-%d, forward + backward)"
          "  finetune_step_ms %.2f  busy %.2f and %.2f ms  on %s"
          % (sm["export_ms"], sm["symbol_bytes"], sm["params_bytes"],
             sm["load_ms"], sm["bind_ms"], sm["symbol_step_ms"],
             sm["gluon_step_ms"], SYMBOLIC["steps"], sm["finetune_step_ms"],
             sm["symbol_busy_ms"], sm["gluon_busy_ms"], card), flush=True)
    print("[3k] control flow and linalg: card against CPU", flush=True)
    control_flow_linalg_card_vs_cpu(dev)
    print("[3k] phase wall time %.2f s" % (time.perf_counter() - t_sym),
          flush=True)

    print("[3l] data parallelism: %d ranks sharing the card over gloo "
          "(tools/launch_torch.py), then NCCL at world size 1" % DP_RANKS,
          flush=True)
    t_dp = time.perf_counter()
    dp_counts, dp_loss_limits = run_dp_job(dev, card)
    for name in MAIN_PATH:
        counts[name] += dp_counts[name]
    # (iv) in a process of its own: this one keeps no process group
    nccl = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--dp-nccl"], capture_output=True, text=True,
                          timeout=300)
    print("".join(line + "\n" for line in nccl.stdout.splitlines()
                  if line.startswith("[3l]")), end="", flush=True)
    if nccl.returncode != 0:
        raise AssertionError("phase 3l (iv) failed (rc %d):\n%s"
                             % (nccl.returncode, nccl.stderr[-3000:]))
    print("[3l] phase wall time %.2f s" % (time.perf_counter() - t_dp),
          flush=True)

    print("[3m] multi-process checkpoints and the elastic restore: the main "
          "path at batch %d as dp=%d with zero=1, lr %g, over "
          "ResilientIter(NDArrayIter) of %d resident images; a rank killed "
          "mid-save, then 2 -> 1 -> 2 processes; cuDNN deterministic"
          % (ELASTIC["batch"], DP_RANKS, ELASTIC["lr"], ELASTIC["images"]),
          flush=True)
    el_counts = run_elastic_path(dev, card, dp_loss_limits[0])
    for name in MAIN_PATH:
        counts[name] += el_counts[name]

    print("[3n] model parallelism: %d ranks sharing the card over gloo "
          "(tools/launch_torch.py), f32 with TF32 off: (i) train_lm_torch.py "
          "--devices 2 at dim %d, %d heads, seq %d, batch %d, --impl ring "
          "then ulysses, %d steps each; (ii) pp=2, %d Dense(%d, tanh), "
          "batch %d, %d microbatches; (iii) dp=1 x ep=2, Dense -> "
          "MoEFFN(%d, %d experts, top-%d, capacity %g) -> Dense(%d) on %d "
          "tokens, %d steps" % (
              DP_RANKS, MP["lm"]["dim"], MP["lm"]["heads"], MP["lm"]["seq"],
              MP["lm"]["batch"], MP["lm"]["steps"], MP["pp"]["layers"],
              MP["pp"]["width"], MP["pp"]["batch"], MP["pp"]["num_micro"],
              MP["moe"]["hidden"], MP["moe"]["experts"], MP["moe"]["top_k"],
              MP["moe"]["capacity"], MP["moe"]["classes"],
              MP["moe"]["tokens"], MP["moe"]["steps"]), flush=True)
    t_mp = time.perf_counter()
    mp_counts = run_mp_job(dev, card)
    for name in FLASH:
        counts[name] += mp_counts[name]
    print("[3n] phase wall time %.2f s  on %s"
          % (time.perf_counter() - t_mp, card), flush=True)

    print("[3o] the supervised main path: the main path's step (batch %d, "
          "dp = the job's width, zero=1, lr %g) fed ResilientIter(NDArrayIter)"
          " under run_supervised to step %d, a checkpoint every %d steps, "
          "ranks started by the Supervisor through tools/launch_torch.py "
          "(each in a session of its own); cuDNN deterministic"
          % (ELASTIC["batch"], ELASTIC["lr"], SUPERVISED["steps"],
             SUPERVISED["every"]), flush=True)
    sv_counts = run_supervised_path(dev, card)
    for name in MAIN_PATH:
        counts[name] += sv_counts[name]

    print("[3p] serving: bench.py's serve leg in the port (resnet50_v1, %d px,"
          " f32, TF32 off, buckets %s, Poisson %g req/s, %d requests, "
          "max_delay %g ms), swaps under traffic, serve_bench_torch.py "
          "--chaos, CachedDecoder" % (
              SERVE["image"], list(SERVE["buckets"]), SERVE["qps"],
              SERVE["requests"], SERVE["max_delay_ms"]), flush=True)
    counts["maxpool_idx_fwd"] += run_serving_path(dev, card)

    print("[3q] the int8 serve leg: the serve leg's settings at "
          "dtype='int8' through serve_bench_torch.py's --int8 leg beside "
          "its fp32 leg on the same traffic; codes card against CPU, logits "
          "against the f32 engine on the dequantized codes, a poisoned "
          "int8 swap", flush=True)
    counts["maxpool_idx_fwd"] += run_int8_serving_path(dev, card)
    print("[3r] bench.py --mode infer-int8 in the port: resnet50_v1 "
          "exported, fold_batch_norm, quantize_model(calib_mode='none'), "
          "batch %d, %d px, through the Executor beside the folded graph in "
          "bf16" % (INT8_INFER["batch"], INT8_INFER["image"]), flush=True)
    counts["maxpool_idx_fwd"] += run_int8_infer_path(dev, card)
    torch.cuda.empty_cache()
    print("[3s] the flywheel: tools/flywheel_torch.py at its defaults on "
          "the card, then --chaos loss_bomb and --chaos swap_storm",
          flush=True)
    run_flywheel_path(card)

    print("[3t] gluon.data and the Estimator: Estimator.fit on %s (batch "
          "%d, %d px, %d classes, f32, Trainer sgd lr %g momentum 0.9) over "
          "a DataLoader of phase 3d's shard (RandomResizedCrop, flip, "
          "ToTensor, Normalize; %d thread workers), a CheckpointHandler; "
          "the spawned-worker loader; the contrib layers and the symbolic "
          "bodies card against CPU" % (
              ESTIMATOR["model"], ESTIMATOR["batch"], IMAGE,
              ESTIMATOR["classes"], ESTIMATOR["lr"], ESTIMATOR["workers"]),
          flush=True)
    t_est = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="chip_smoke_estimator_")
    try:
        est, est_counts = run_estimator_path(dev, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    counts["maxpool_idx_fwd"] += est_counts["maxpool_idx_fwd"]
    print("[3t] estimator_step_ms %.2f (median of batches 3-%d, batch end "
          "to batch end: compute %.2f + input wait %.2f)  phase 3g's "
          "gluon_step_ms %.2f  loader_batch_ms %.2f at 0 workers (median "
          "of 3), %.2f at %d (a pass of 8 over 8)  fit %.2f s  spawned loader %.2f s  on %s" % (
              est["estimator_step_ms"], RECORDS // ESTIMATOR["batch"],
              est["estimator_compute_ms"], est["estimator_wait_ms"],
              gl["gluon_step_ms"], est["loader_batch_ms_0"],
              est["loader_batch_ms_%d" % ESTIMATOR["workers"]],
              ESTIMATOR["workers"], est["fit_s"], est["spawn_s"], card),
          flush=True)
    dc = contrib_card_vs_cpu(dev)
    print("[3t] deform_conv_ms %.3f (F.conv2d %.3f: %.1fx)  forward + "
          "backward %.3f (F.conv2d %.3f: %.1fx)  at (%d, %d, %d, %d), 3x3, "
          "%d deformable groups, f32, TF32 off, CUDA events  on %s" % (
              dc["deform_conv_ms"], dc["conv2d_ms"],
              dc["deform_conv_ms"] / dc["conv2d_ms"],
              dc["deform_conv_fwd_bwd_ms"], dc["conv2d_fwd_bwd_ms"],
              dc["deform_conv_fwd_bwd_ms"] / dc["conv2d_fwd_bwd_ms"],
              DEFORM["batch"], DEFORM["channels"], DEFORM["size"],
              DEFORM["size"], DEFORM["groups"], card), flush=True)
    symbolic_bodies_on_card(dev)
    print("[3t] phase wall time %.2f s" % (time.perf_counter() - t_est),
          flush=True)

    print("[3u] contrib.amp: (i) phase 3g's loop (%s, batch %d, %d px, %d "
          "classes, sgd lr %g momentum 0.9) under amp.init('bfloat16') "
          "with amp.init_trainer and amp.scale_loss, %d steps, its first "
          "step at batch %d card against CPU, float16's loss scaler with "
          "a planted inf; (ii) amp.convert_model on "
          "phase 3k's exported resnet50_v1(ghost_bn=16) through the "
          "Executor at batch %d; (iii) the op tail and the rest of "
          "gluon.nn card against CPU" % (
              GLUON["model"], GLUON["batch"], IMAGE, GLUON["classes"],
              GLUON["lr"], AMP["steps"], AMP["cpu_batch"],
              AMP["convert_batch"]), flush=True)
    t_amp = time.perf_counter()
    am, am_counts = run_amp_path(dev)
    counts["maxpool_idx_fwd"] += am_counts["maxpool_idx_fwd"]
    print("[3u] amp_step_ms %.2f (median of steps 3-%d)  %.1f img/s  phase "
          "3g's gluon_step_ms %.2f (f32): %.2fx  on %s" % (
              am["amp_step_ms"], AMP["steps"], am["amp_img_s"],
              gl["gluon_step_ms"], gl["gluon_step_ms"] / am["amp_step_ms"],
              card), flush=True)
    amp_card_vs_cpu(dev, held=AMP_HELD_FULL)
    amp_card_vs_cpu(dev, **AMP_SMALL)
    amp_overflow_on_card(dev)
    directory = tempfile.mkdtemp(prefix="chip_smoke_amp_")
    try:
        cv, cv_counts = run_amp_convert(dev, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    counts["maxpool_idx_fwd"] += cv_counts["maxpool_idx_fwd"]
    print("[3u] amp_convert_img_per_sec %.1f (the f32 graph %.1f: %.2fx)  "
          "top-1 agreement %.4f  on %s" % (
              cv["amp_convert_img_per_sec"], cv["f32_graph_img_per_sec"],
              cv["amp_convert_img_per_sec"] / cv["f32_graph_img_per_sec"],
              cv["amp_convert_top1"], card), flush=True)
    tail_card_vs_cpu(dev)
    print("[3u] phase wall time %.2f s" % (time.perf_counter() - t_amp),
          flush=True)

    print("[3v] the NumPy frontend: %s (stock BN, %d classes) written in "
          "mx.np/mx.npx over the zoo net's parameters (example/numpy/"
          "resnet_np.py), batch %d, %d px, f32, TF32 off: uint8 NHWC images "
          "through _image_resize, _image_crop, to_tensor and "
          "_image_normalize on the card, %d steps under autograd.record(), "
          "each one nd._multi_adamw_update call; the first step against the "
          "Gluon net, the updates against their plain versions, %s card "
          "against CPU, the surface card against CPU" % (
              NP_PATH["model"], NP_PATH["classes"], NP_PATH["batch"],
              NP_PATH["image"], NP_PATH["steps"], NP_SMALL["model"]),
          flush=True)
    t_np = time.perf_counter()
    npm, np_counts = run_np_path(dev, gl["gluon_step_ms"])
    counts["maxpool_idx_fwd"] += np_counts["maxpool_idx_fwd"]
    print("[3v] np_step_ms %.2f (mean of steps 2-%d; TF32 off, cuDNN "
          "deterministic)  phase 3g's gluon_step_ms %.2f: %.2fx  forward + "
          "backward %.2f against the Gluon net's %.2f on these settings  "
          "preprocess_ms %.2f  losses %s  K3 launches %d in %d steps  on %s"
          % (npm["np_step_ms"], NP_PATH["steps"], gl["gluon_step_ms"],
             npm["np_step_ms"] / gl["gluon_step_ms"], npm["np_fwd_bwd_ms"],
             npm["gluon_fwd_bwd_ms"], npm["preprocess_ms"],
             ["%.4f" % v for v in npm["losses"]],
             np_counts["maxpool_idx_fwd"], NP_PATH["steps"], card),
          flush=True)
    np_card_vs_cpu(dev, **NP_SMALL)
    np_surface_card_vs_cpu(dev)
    print("[3v] phase wall time %.2f s" % (time.perf_counter() - t_np),
          flush=True)

    print("[3w] the op registry's tail: (i) LARS on %s (stock BN, %d "
          "classes), batch %d, %d px, f32, TF32 off, a CustomOp softmax "
          "head, %d steps of multi_sum_sq, multi_lars and "
          "preloaded_multi_sgd_mom_update; (ii) BERT-base self-attention "
          "(%d units, %d heads, seq %d, batch %d) through the interleaved "
          "matmuls against K4-K6; (iii) the RPN's Proposal on a %dx%d image "
          "(pre-NMS %d, post-NMS %d); (iv) every other new name card "
          "against CPU" % (
              LARS["model"], LARS["classes"], LARS["batch"], LARS["image"],
              LARS["steps"], BERT["units"], BERT["heads"], BERT["seq"],
              BERT["batch"], RPN["image"][0], RPN["image"][1], RPN["pre"],
              RPN["post"]), flush=True)
    t_w = time.perf_counter()
    lars, lars_counts = run_lars_path(dev, gl["gluon_step_ms"])
    counts["maxpool_idx_fwd"] += lars_counts["maxpool_idx_fwd"]
    print("[3w] lars_step_ms %.2f (mean of steps 2-%d; TF32 off, cuDNN "
          "deterministic)  the update %.2f ms of it (%.1f %%)  phase 3g's "
          "gluon_step_ms %.2f  K3 launches %d in %d steps  on %s"
          % (lars["lars_step_ms"], LARS["steps"], lars["lars_update_ms"],
             100.0 * lars["lars_update_ms"] / lars["lars_step_ms"],
             gl["gluon_step_ms"], lars_counts["maxpool_idx_fwd"],
             LARS["steps"], card), flush=True)
    bert, bert_counts = run_bert_attention(dev)
    counts.update({name: counts[name] + bert_counts[name] for name in FLASH})
    print("[3w] interleaved_attn_ms %.3f (forward + backward, TF32 off)  "
          "K4-K6 on the same q, k, v %.3f  on %s"
          % (bert["interleaved_attn_ms"], bert["flash_attn_ms"], card),
          flush=True)
    rpn = run_proposal(dev)
    print("[3w] proposal_ms %.3f  multiproposal_ms (batch 2) %.3f  on %s"
          % (rpn["proposal_ms"], rpn["multiproposal_ms"], card), flush=True)
    tail_w_card_vs_cpu(dev)
    print("[3w] phase wall time %.2f s" % (time.perf_counter() - t_w),
          flush=True)

    print("[4] kernel times (K1/K2 summed over one step's 53 layers and K3 "
          "at the stem, device time with the L2 flushed; K4-K6 one layer's "
          "attention by CUDA events)", flush=True)
    before = before_pool = None
    if args.before:
        before = _bench_tool().before_ghost_bn(args.before, dev)
        before_pool = _bench_tool().before_maxpool(args.before, dev)
    rows = time_kernels(dev, layers, before, before_pool)
    print("[4] K3 at the zoo's pool shapes (flushed)", flush=True)
    time_zoo_pools(dev)
    print("[4] K3 at LeNet's pool shapes (flushed)", flush=True)
    time_lenet_pools(dev)
    print("[4] the fused RNN op at phase 3i's LSTM, forward + backward "
          "(cuDNN through torch._VF: a library route, not a kernel row; "
          "CUDA events)", flush=True)
    time_rnn_op(dev)
    rows.update(time_flash(dev))
    print("[4c] K7 at the 9 ResNet-50 BN shapes (batch 256, bf16) beside "
          "copy_, K1 and K2; R1 beside torch.add; R2 at the nd path's "
          "shapes", flush=True)
    nd_rows, counts["bn_copy"] = time_nd_kernels(dev, rtc_kernels)
    rows.update(nd_rows)
    for name, row in rows.items():
        print("  %-18s ms %.4f  plain_ms %.4f  bound_ms %.4f (%s)  "
              "library_ms %s%s%s" % (
                  name, row["ms"], row["plain_ms"], row["bound_ms"],
                  row["bound_by"], row["library_ms"],
                  "  tc_bound_ms %.4f" % row["tc_bound_ms"]
                  if "tc_bound_ms" in row else "",
                  "  ms/library %.3f" % row["ms_over_library"]
                  if "ms_over_library" in row else ""), flush=True)

    print("[5] one f32 step at batch 16, 64 px: card against CPU", flush=True)
    card_vs_cpu(dev)
    print("[5b] one f32 step of the LM at dim 128, seq 256: card against CPU",
          flush=True)
    lm_card_vs_cpu(dev)
    print("[5c] one f32 step of the Gluon example's loop at resnet18_v1, "
          "32 px, batch 16: card against CPU", flush=True)
    gluon_card_vs_cpu(dev)
    print("[5d] one f32 step of train_mnist_torch.py's LeNet Module at "
          "batch 16: card against CPU", flush=True)
    mnist_card_vs_cpu(dev)
    print("[5e] one f32 step of train_torch.py's WordLM (vocab %d, "
          "embedding %d, hidden %d, batch %d, bptt %d): card against CPU"
          % (WORDLM_SMALL["vocab"], WORDLM_SMALL["emsize"],
             WORDLM_SMALL["nhid"], WORDLM_SMALL["batch"],
             WORDLM_SMALL["bptt"]), flush=True)
    word_lm_card_vs_cpu(dev)
    print("[5f] one f32 step of example/ssd/train_torch.py's TinySSD at "
          "batch %d, 32 px: card against CPU" % SSD["batch"], flush=True)
    ssd_card_vs_cpu(dev)

    here = os.path.dirname(os.path.abspath(__file__))
    meta = {
        "ghost_bn_fwd": ("incubator_mxnet_tpu_torch/csrc/ghost_bn.cu",
                         "incubator_mxnet_tpu/parallel/fused_bn.py:537"),
        "ghost_bn_bwd": ("incubator_mxnet_tpu_torch/csrc/ghost_bn.cu",
                         "incubator_mxnet_tpu/parallel/fused_bn.py:577"),
        "maxpool_idx_fwd": ("incubator_mxnet_tpu_torch/csrc/maxpool_idx.cu",
                            "incubator_mxnet_tpu/parallel/maxpool_idx.py:145"),
        "flash_attn_fwd": ("incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
                           "incubator_mxnet_tpu/parallel/flash_attention.py:139"),
        "flash_attn_bwd_dq": (
            "incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
            "incubator_mxnet_tpu/parallel/flash_attention.py:261"),
        "flash_attn_bwd_dkv": (
            "incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
            "incubator_mxnet_tpu/parallel/flash_attention.py:279"),
        "bn_copy": ("incubator_mxnet_tpu_torch/csrc/bn_copy.cu",
                    "tools/bn_kernel_bench.py:99"),
        "scale_kernel": ("incubator_mxnet_tpu_torch/csrc/rtc/scale_kernel.cu",
                         "incubator_mxnet_tpu/rtc.py:37"),
        "mm_kernel": ("incubator_mxnet_tpu_torch/csrc/rtc/mm_kernel.cu",
                      "incubator_mxnet_tpu/rtc.py:37"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        if not os.path.exists(os.path.join(here, source)):
            raise AssertionError("missing source %s" % source)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=max(errs[name]), **rows[name]))
    print("[6] profiler traces taken again (launches lost): %s"
          % (PROFILER_RETAKES or "none"), flush=True)
    print("[6] done in %.1f s  on %s" % (time.perf_counter() - t_start, card),
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
