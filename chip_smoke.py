#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``incubator_mxnet_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` and no network, and imports nothing of JAX.  Phases
(nothing catches a failure; any mismatch raises and the exit code is not
0):

1. print the card's name and power limit; build the kernels from
   ``incubator_mxnet_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once) and print the build time;
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
    print("[1] kernels built in %.1f s" % build_s, flush=True)

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
