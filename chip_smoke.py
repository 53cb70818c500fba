#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
started together), prints the compiler's report (registers, spills) of
every kernel, and runs thirty-nine phases:

1. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it and a few more, timed (CUDA events)
   beside its bound, its plain version and a PyTorch library call that
   computes the same function (with the names of the kernels that call
   runs, for the attention backward). A kernel whose work is f32 matrix
   products is bound at the 3xTF32 rate (three TF32 tensor-core products
   for each f32-accurate one), with the CUDA cores' f32 bound beside it;
2. serving: GPT-2-small (``TransformerLM`` at its published width, random
   seeded weights) answers 16 requests through ``ParallelInference``'s
   batched dispatcher; the answers are checked;
3. training: GPT-2-small takes 5 ``ComputationGraph.fit`` steps with Adam
   through the fused updater helper; the loss must fall, every kernel must
   launch its expected count per step, and one batch's loss and gradients
   must agree with the plain attention path's on a twin network. Two more
   steps run under ``torch.profiler``: their device time by kernel group
   and the device's busy share are printed;
4. LSTM kernel: the fused LSTM sequence kernel, each plan it takes
   (cluster and grid), against its plain version at the character model's
   shapes (a training chunk, ``output``'s whole example, the sampling
   prime and one sampled step) and two wider ones, timed beside its bound,
   its chain floor (the cluster plan's hand-over of h and barrier alone,
   no arithmetic), its plain version and cuDNN's LSTM (``torch.nn.LSTM``,
   a yardstick the port never calls), with the host time of one call at
   the sampling shape;
5. character LSTM: DL4J's ``LSTMCharModellingExample`` configuration (2 x
   LSTM(200), 77 characters, Adam(0.005), l2 1e-4, TBPTT 50) built with
   ``list()`` as a ``MultiLayerNetwork`` trains on 2 minibatches of 32 x
   1000 characters of this repository's own text (40 TBPTT chunks; the
   loss must fall; 2 LSTM-kernel and 8 fused-Adam launches a chunk, every
   LSTM-kernel launch of training, ``output`` and sampling on the cluster
   plan), one
   chunk's loss and gradients are checked against a twin on the plain
   recurrence, it answers ``output`` over a [32, 1000, 77] batch and
   samples 4 x 300 characters through ``rnn_time_step``;
6. LeNet (``__graft_entry__._lenet``) through ``MultiLayerNetwork``: 5
   epochs with the fused updater, ``evaluate``, a timed window, a twin on
   stock Adam and the model zip on the card and the CPU;
7. regularizers: every dropout and weight-noise variant draws on the card
   at [4096, 4096] (SpatialDropout at [64, 32, 32, 64]) from a CUDA
   generator, and its statistics, its scaling and its determinism under a
   seed are checked; then example 17's regularization family (AlphaDropout,
   MaxNorm, NonNegative, DropConnect) trains 15 epochs with the fused
   updater, its constraints must hold and its accuracy match the JAX
   package's; then LeNet again with dropout 0.5 on the dense layer and
   per-layer L2 gradient renormalization, fed through a fitted
   ``NormalizerStandardize`` and the default prefetch, beside a twin fed
   with ``prefetch_depth=0``: both must evaluate >= 0.95; the step times
   of both ways, and of both ways fed batches made before the window
   (which leaves the producer only the pin and the copy), are printed
   with the device's busy share, and the prefetched batches must come
   from pinned memory on a side stream;
8. GPT-2-small with attention dropout 0.1: 5 ``ComputationGraph.fit``
   steps through a prefetching iterator (150 fused-Adam launches a step,
   no flash launch: the seam declines a dropout-active request), one
   ``output`` (12 flash-forward launches), and a step repeated from the
   dropout generator's saved state must give the same loss;
9. decode: GPT-2-small prefills 8 x 240 seeded ids through
   ``rnn_time_step`` and takes 16 single-token steps through the KV
   caches (no flash launch), each step's probabilities within 1e-4 of
   ``output`` over the same 256 ids (12 flash-forward launches); then
   ``generate`` (the host loop) and ``generate_on_device`` (greedy: the
   same tokens; sampled at temperature 0.8, top_k 40, top_p 0.95: in the
   vocabulary, decided by the seed, and no synchronising call between
   the prefill and the read) from 8 prompts of 128 ids, and
   ``beam_search`` (2 prompts x beam 4, length penalty 1; beam 1 equals
   greedy); each is timed (ms a token from CUDA events at each step,
   tokens/s), profiled (device busy share, launches a step) and set
   beside the bytes bound of its step;
10. GPT-2-small trained by truncated BPTT (chunks of 256 through the
   carried KV caches) with the fused updater: 2 fit calls on one 8 x 1024
   batch (4 chunks and 4 iterations a fit, 150 fused-Adam launches and no
   flash launch a chunk, the mean loss falling), its model zip without
   the updater state restored on the card (the same output) and the CPU
   (within 1e-5), and example 11's TBPTT net's zip with its Adam state;
11. ResNet-50 (the zoo's ``ResNet50``, 1000 labels, seed 1) trained through
   ``ComputationGraph.fit`` at 224x224x3, batch 256 (halved until it
   fits, each batch tried printed with its peak), f32, with the zoo's
   Nesterovs updater: 3 warm-up and 10 timed steps on seeded images
   (images/s, median step, peak memory; finite losses; every running mean
   and variance moved; no launch of K1, K2, K3a or K3b: the reference's
   path has no kernel either), 2 steps under the profiler (busy share,
   kernel groups; the Nesterovs update profiled alone), the step's FLOP
   bound at the f32 CUDA-core peak, ``output`` images/s at batch 256;
   then one step at batch 2 on the card against the same step in the
   port on the CPU (in f64, where the step is well-conditioned: loss,
   parameters and states; in f32: the loss, the Nesterovs update of the
   same gradients, and the gradients no farther from the CPU's f64 ones
   than the CPU's f32 ones are, a few times at most: RESNET_F32_FACTOR,
   each tensor against the larger of two CPU f32 samples;
   the output after the step printed beside the CPU's) and the zip with its layer states restored on the card
   (``output`` equal bit for bit); the Nesterovs update timed alone last,
   so that its extra steps move no weight another check reads;
12. DL4J checkpoints: the four DL4J-format fixtures in ``tests/fixtures``
   restored with ``device="cuda"`` reproduce their recorded outputs, and
   the convnet one fits 3 more steps from its restored Adam state on the
   fused updater (8 K2 launches a step);
13. bf16 kernels (run second, after the f32 kernels): the bf16 flash
   forward and backward kernels against their plain versions (the TPU
   kernel's rounding points; the largest error, each entry's and the
   relative Frobenius error) at GPT-2-small's shape, causal and full, at
   the bf16 encoder's [32, 12, 128, 64] full, at T = 192 (a last block of 64 rows), at N*H = 97 and at Dh 128 and 256,
   each shape with the design that served it (Dh 64: the Hopper design of
   TMA, mbarriers and wgmma; Dh 128 and 256: mma.sync), timed (CUDA-event
   medians and the profiler's device time a launch) beside their bound at
   the tensor cores' bf16 rate, their plain versions and SDPA in bf16
   (its event median and device time too). Before the phases, a SASS check
   of the built libraries: the Hopper kernels hold HGMMA and UTMALDG, the
   mma.sync ones neither;
14. GPT-2-small in mixed precision (``compute_dtype = "bfloat16"``, f32
   masters): 5 fit steps on integer ids with the fused updater (12 / 12 /
   12 bf16 flash launches, no f32 flash launch and 150 fused-Adam
   launches a step), profiled, one bf16 ``output``, and one batch's loss
   and gradients against an f32 twin no farther than a bf16 twin on the
   plain attention is (BF16_WHOLE_RATIO);
15. ResNet-50 in mixed precision as ``bench.py`` runs its headline (batch
   256, 224x224x3): timed, profiled, the FLOP bound at the bf16 rate, the
   running statistics f32 and moved, no kernel launch, the zip restored
   bit for bit, and the card's bf16 gradients at batch 2 against the
   CPU's f64 ones no farther than the CPU's bf16 ones are;
16. LSTM kernel on bf16 (run after the f32 LSTM kernel): K1-bf16 against
   its plain version (``lstm_sequence_plain`` on the same bf16 tensors,
   the TPU kernel's rounding points) at the bf16 path's [128, 64, 512],
   the char model's [50, 32, 200] and [12, 4, 200], [35, 20, 1500] (grid
   plan) and [128, 64, 512] on the grid plan: the largest error, each
   entry's in units of 2^-8 x max(|plain|, 2^-6), the relative Frobenius
   error and the distance from an f64 recurrence against the plain
   version's, each beside its limit; timed beside its bound at the bf16
   tensor-core rate, its chain floor, its plain version and cuDNN's bf16
   LSTM;
17. the bf16 LSTM path at ``bench.py``'s recurrent configuration (2 x
   512, 77 characters, B 64, T 128, Adam(1e-3), ``compute_dtype =
   "bfloat16"``, ordinary fit): its GravesLSTM network as it is (the plain
   loop, 0 K1), the same network on DL4J's standard LSTM (2 K1-bf16 and 8
   K2 launches a step, 2 K1-bf16 in ``output``, no f32 K1; median step,
   characters/s, peak memory, busy share, device time by group; losses
   falling; masters and gradients f32; one batch against an f32 twin no
   farther than a bf16 twin on the plain recurrence is; the zip restored
   with ``output`` equal bit for bit), and a Bidirectional(LSTM(512)) +
   LastTimeStep(LSTM(512)) classifier (3 K1-bf16 launches a forward);
18. the recurrent stack (SimpleRnn, GRU both ways, Bidirectional,
   GravesBidirectionalLSTM, LastTimeStep, MaskZeroLayer, ConvLSTM2D) at
   small width on the card, f32 and bf16, with and without a mask, against
   the same layer on the CPU, with each forward's K1 launches (an unmasked
   Bidirectional or LastTimeStep over a standard LSTM launches K1 of its
   dtype, a masked one does not);
19. VGG16 in mixed precision as ``bench.py`` runs it (the zoo's VGG16,
   1000 labels, seed 1, batch 64 x 224x224x3, its Nesterovs updater,
   ``MultiLayerNetwork``): 3 warm-up and 6 timed steps (median step,
   images/s, peak memory), profiled (busy share, device time by group),
   the FLOP bound share at the bf16 rate, no kernel launch, masters f32,
   the zip restored bit for bit, and the card's bf16 gradients at batch 2
   against the CPU's f64 ones no farther than the CPU's bf16 ones are,
   with the CPU's f32 distance from f64 printed beside them;
20. the BERT-base-shape ``TransformerEncoder`` in mixed precision as
   ``bench.py``'s fallback runs it (2 labels, seed 1, B 32, T 128,
   integer ids, the fused updater), two ways in one process: with no
   attention helper (148 fused-Adam launches and no flash launch a step)
   and with ``FlashAttentionHelper(causal=False)`` registered (12 / 12 /
   12 bf16 flash launches a step, 12 in one ``output``), each timed and
   profiled; the second way's loss and gradients against an f32 twin no
   farther than a bf16 twin on the plain attention is; a padded batch
   with its mask takes the plain path (no flash launch) and, in f32,
   equals its unpadded prefix within 1e-5;
21. the zoo's other models at their published widths, f32, batch 8 (AlexNet,
   VGG19, GoogLeNet at 224x224x3, TextGenerationLSTM, ViT-B/16): one fit
   step and one ``output`` each, the loss finite, rows summing to 1, no
   kernel launch but ViT's fused Adam;
22. the networks' remaining API at full width, each path's launches
   counted: (a) GPT-2-small in bf16, ``fit_batches_on_device`` over a
   window of 4 batches (12 / 12 / 12 bf16 flash and 150 fused-Adam
   launches a step, no host synchronisation from the first step to the
   window's end) against 4 ``fit`` calls of a clone made before it
   (parameters and Adam state within 1e-6 x each tensor's largest entry,
   generator states equal), each way timed and profiled; (b) the bf16
   char-RNN on standard LSTMs (2 x 512, B 64, T 128) the same way (2
   K1-bf16 and 8 fused-Adam launches a step), then ``to_computation_graph``
   (its ``output`` within 1e-6 x max(1, largest entry) of the network's,
   2 K1-bf16; two more steps on both within 1e-5), ``evaluate`` and
   ``evaluate_roc_multi_class`` over [64, 128, 77] with a label mask equal
   to the eval classes on the same ``output`` on the host, their AUCs
   beside an f32 twin's on the CPU; (c) GPT-2-small f32 ``score_examples``
   at 8 x 1024 (12 flash-forward launches), each score within 1e-5
   relative of that example's ``score`` alone, with and without the l1/l2
   term; (d) the regularized LeNet's ``clone`` (the same dropout masks),
   ``set_learning_rate`` (8 fused-Adam launches, within 1e-5 of stock Adam
   at the new rate), ``params_flat`` / ``set_params_flat`` (bit for bit,
   the storage kept, 8 fused-Adam launches after it) and
   ``evaluate_roc_binary``, ``evaluate_regression`` and
   ``EvaluationCalibration`` over ``output``;
23. the small layers (the activations, the core, loss and convolution
   family layers, 1-D pooling), each path's launches counted: three
   networks of them with Adam on the fused updater (one launch per
   parameter tensor a step, no other kernel), f32 and bf16, from the same
   weights as a twin on the CPU: (a) ``EmbeddingLayer`` (10000 x 256, 256
   integer ids) -> ``ElementWiseMultiplicationLayer`` -> ``PReLULayer`` ->
   a dense layer of 256 for each of the 14 activations of the slice ->
   ``CenterLossOutputLayer`` (100); (b) 1-D over [32, 128, 64]:
   ``Convolution1DLayer``, ``ZeroPadding1DLayer``, ``Subsampling1DLayer``,
   ``Upsampling1DLayer``, ``MaskLayer`` (a step mask that ends a quarter
   of the rows early), ``RnnLossLayer``; (c) 2-D over [16, 64, 64, 3]:
   convolution (relu6), depthwise (swish), separable (mish),
   space-to-depth, transposed convolution, crop, zero padding, upsampling,
   a 1x1 convolution and ``CnnLossLayer``. In f32, 3 steps on both with
   each parameter and Adam slot within 1e-5 x its largest entry; in bf16,
   one batch's loss and gradients against the f32 twin no farther than a
   bf16 twin on the CPU is (the GPT-2 bf16 ratio form), then 3 steps.
   ``SpaceToBatchLayer``'s forward equals the CPU's. Then the zoo's
   ``Darknet19`` at its published width (1000 labels, 224x224x3, batch
   8, its Nesterovs updater) in f32 and bf16: a fit, 3 timed fits (median
   step, images/s), the busy share of 2 profiled fits, peak memory, one
   ``output`` (rows summing to 1); and ``SimpleCNN`` (48x48x3, AdaDelta,
   f32): a fit and an ``output``. Neither launches a kernel;
24. layerwise pretraining, each path's K2 launches counted: DL4J's
   VaeMNISTAnomaly at its published widths (784 -> [256, 256] -> 32 ->
   [256, 256] -> Bernoulli, Adam(1e-3), l2 1e-4) pretrains 20 batches of
   128 synthetic binarized rows (14 K2 launches a step; the losses finite
   and the last 5 below the first 5; median step, examples/s, busy share,
   peak memory); one step against CPU twins with the same ε (each
   parameter and Adam slot within 1e-5 x its largest entry, or no farther
   from an f64 twin than 4x the CPU f32 twin), 3 against a stock-Adam
   twin on the card (1e-5), ``reconstruction_log_probability`` with 16
   samples over 256 rows against the CPU's (1e-5 relative); a stacked
   denoising autoencoder (784 -> 256 -> 64 -> softmax 10, corruption 0.3)
   pretrained and fitted as a MultiLayerNetwork and as a ComputationGraph
   through ``pretrain_layer(name)`` from the same weights and draws
   (1e-6); FrozenLayer (its tensors bit for bit unchanged from a zero Adam
   state, moved as the CPU's from a carried one), TimeDistributedWrapper
   over image sequences and MixtureOfExpertsLayer networks, 3 steps each
   against CPU twins;
25. object detection: the zoo's TinyYOLO at its defaults (416x416, 20
   labels) on 16 synthetic scenes: one warm-up and 10 timed fits (median
   step, images/s, busy share, peak memory, FLOP bound share; the loss
   falling), ``output`` decoded into detections (conf 0.1, NMS 0.4) on the
   card and on the CPU from the same raw output (equal lists; the decode
   and NMS host ms), one batch-2 step's loss against the CPU's f64 step
   (1e-5 relative); then YOLO2 at its defaults (608x608, 80 labels, batch
   8): one fit and one ``output`` ([8, 19, 19, 425]). K2 takes one launch
   per parameter tensor a step;
26. SameDiff: the zoo LeNet's widths built in SameDiff ops from a zoo
   LeNet's weights (its output and one batch's gradients, card and CPU f32,
   first set beside the CPU's f64 ones), trained with Adam(1e-3)
   on the fused updater over 20 batches of 128 synthetic MNIST-shaped
   images (8 K2 launches a step; median step, images/s, busy share, peak
   memory; the mean of the last 5 losses below the first 5's); one more
   step against CPU twins from the same variables and Adam state in the
   small-layer form; ``save``/``load`` on the card (``output`` bit for
   bit) and ``evaluate`` equal to ``Evaluation`` on the same output.
   Then a bounded ``while_loop`` (at most 8 trips, stopping at 5) with an
   ``if_cond``, and the same loop unbounded, on the card against the CPU
   (outputs and gradients within 1e-6 x max(1, largest entry)); and the
   zoo LeNet with its dense 500 a ``SameDiffLayer`` against the zoo LeNet
   over 3 Adam steps from the same weights (1e-6, 8 K2 a step);
27. transfer learning: the zoo's LeNet zip registered with its Adler32
   and SHA-256 and restored through ``init_pretrained`` from a
   ``file://`` URL into a temporary cache (``output`` bit for bit); the
   zoo's VGG16 at its defaults fine-tuned as dl4j-examples'
   EditLastLayerOthersFrozen does (frozen through fc2, a new 5-class
   softmax head, Adam(1e-4)): 3 steps at batch 16 on synthetic images (32
   K2 launches a step; frozen tensors and the source network bit for bit
   unchanged, the head moved; median step, images/s, busy share, peak
   memory beside ``network_memory_report``'s forecast and
   ``compiled_memory_analysis``), ``TransferLearningHelper``'s featurized
   head 3 steps against CPU twins (2 K2 a step), and ImageNet labels
   decoding the source network's output as the CPU decodes it;
28. gradient checkpointing: GPT-2-small (8 x 1024, f32, Adam(3e-4))
   without and with it from the same weights, 3 timed fits each (12 / 12
   / 12 / 150 and 24 / 12 / 12 / 150 K3a / K3b-dq / K3b-dkv / K2 launches
   a step; the checkpointed peak memory below the plain one), one batch's
   loss and gradients within 1e-6 relative of each other; the same pair
   with attention dropout 0.1 from one dropout-generator state (the plain
   attention path: the recompute must replay the masks); the reference's
   remat case (12 x Dense(512), batch 256) through
   ``compiled_memory_analysis`` with and without checkpointing;
29. the zoo's face models at their published widths with Adam on the
   fused updater, synthetic images: InceptionResNetV1 (160x160x3, batch
   32) and FaceNetNN4Small2 (96x96x3, batch 64), a warm-up and 5 timed
   fits each (one K2 launch per parameter tensor a step; median step,
   images/s, busy share, peak memory), the first batch's loss and
   gradients in f32 against an f64 twin on the card;
30. Keras import from the committed configurations
   (``tests/fixtures/keras``; weights drawn from a seed at the shapes
   Keras stores, filled through ``copy_weights``): BERT-base (12 x 768,
   vocab 30522, T 128, two inputs) in bf16 with the full-attention helper
   at batch 32, int64 ids, 5 timed fits (12 / 12 / 12 K3-bf16 launches a
   step) beside the zoo TransformerEncoder's step, its f32 output at batch
   2 against an f64 twin; keras-io's IMDB Bidirectional LSTM (4 K1
   launches a forward) against the plain recurrence, 3 fits; keras-io's
   MNIST convnet against the same network on the CPU;
31. DL4J export: the LeNet phase's LeNet and a two-input dense graph trained on the
   card (K2), written as DL4J zips and read back onto the card by the
   port's reader (the graph's output equal, LeNet's within 1e-6, the Adam
   state equal), and ``load_model_guess`` on the DL4J and the port's own
   zips;
32. training utilities (``optimize/``, ``util/gradient_check.py``,
   ``ui/``, ``eval/tools.py``): (a) the zoo LeNet (Adam on the fused
   updater, batch 128 over 4096 images with the planted signal) under
   ``EarlyStoppingTrainer`` twice (held-out loss, then accuracy), the
   first with six listeners (score, throughput, collected scores,
   held-out evaluation, checkpoints every 8 steps keeping 2, stats into a
   ``FileStatsStorage``): the best zip's score within 1e-6 of the
   trainer's record, the last checkpoint equal to the live parameters it
   saved, 8 K2 a step, the median step with and without the listeners;
   (b) GPT-2-small bf16 (8 x 1024) 10 steps each with no listener and
   with ``StatsListener`` (histograms) at report frequency 1 and 10,
   ``ProfilerListener`` over steps 3-5 (its Chrome trace names K2 and the
   bf16 K3 kernels), 150 K2 and 12 of each bf16 K3 a step; (c) ``Solver``
   on the zoo LeNet at full batch 1024, each algorithm 10 iterations: f32
   scores non-increasing, the first score and gradient within 1e-5 of an
   f64 twin's (the output layer's; the tensors below a relu within
   1e-3, its near-tie flips counted); f64 histories within 1e-8 of the
   same runs on the CPU, made after everything timed; (d)
   ``check_model_gradients`` in f64 on a narrowed LeNet and an LSTM
   network at the reference's defaults; (e) random and
   grid search over LeNet's learning rate and dense width, one epoch a
   trial, scored by the held-out loss, the random draws equal to the
   CPU's; (f) ``UIServer`` on 127.0.0.1 serving (a)'s stats, and
   ``eval/tools.py``'s ROC page of (a)'s best model;
33. the serving registry (``serving/``, ``observe/``, the rest of
   ``ParallelInference``): GPT-2-small at its published width under one
   name in four versions (f32 seeds 123 and 124, the second's int8 and
   bf16 versions, calibrated on 2 x 256 ids), batches of at most 8 over
   buckets (1, 2, 4, 8), tracing, metrics and the cost ledger on. 8
   client threads send 48 one-row requests of 256 ids; v2 is activated
   after the 16th answer, a 0.25 canary split to the int8 version set
   after the 32nd: every answer within the served-answer limit of its
   version's own ``output``, the canary exactly every 4th pick, 12 K3a a
   forward; the bf16 version pinned (12 K3a-bf16 a forward); the int8
   version's growth of the card's allocation beside its ``param_nbytes``;
   a ``crash_forward`` fault served through the fallback chain, the
   dispatcher restarted after its backoff and the breaker closed by its
   probe; one ``queue_wait`` and one ``batch_execute`` a batch, linked,
   the ledger conserving, exemplars naming traces, no ``kernel_build``
   span; requests/s, p50 and p99 by version; the calibrations beside the
   port's own on the CPU; the phase within 60 s;
34. the HTTP front end (``serving/server.py``, ``client.py``,
   ``admission.py``, ``brownout.py``, ``streaming/codec.py``,
   ``observe/health.py``, ``alerts.py``, ``slo.py``, ``incident.py``):
   the same four versions behind a ``ModelServer`` on loopback, 8
   ``ModelServingClient`` threads sending 48 one-row binary requests of
   256 ids under a 0.25 canary split to the int8 version, 4 pinned to
   the bf16 version (``"bfloat16"`` frames, byte for byte the codec's
   frame of that version's own ``output``) and 4 JSON requests to a small
   MLP: every answer within the served-answer limit of its version's own
   ``output``, 12 K3a (K3a-bf16) a forward; ``/readyz``, ``/livez``,
   ``/v1/models`` and ``/metrics`` read during the load, the 200s counted
   in ``serving_requests_total``, ``/debug/capture``, each request's
   spans linked client → server → dispatcher, ``X-Device-Ms`` summed
   against the cost ledger; on a one-slot server a burst's 429s with
   ``Retry-After`` fire a burn-rate rule on a manual clock, which engages
   a brownout (priority 0 shed, un-pinned requests degraded to v2) until
   recovery resolves it; a ``drop_response`` retried with one reconnect;
   a ``crash_forward`` served through the fallback chain; a
   ``TrainingWatchdog`` and a ``TraceListener`` on 5 Adam steps of the
   zoo LeNet (8 K2 a step, no event, host reads a step counted) and
   example 26's diverging MLP ended as an "Error" termination by
   ``EarlyStoppingTrainer``; requests/s, p50 and p99 by version, the HTTP
   layer's ms a request (the client's span less the dispatcher's
   ``inference_request``); the phase within 60 s.
35. DL4J's text-classification path (``nlp/``, ``native/``): Word2Vec as
   DL4J's Word2VecRawTextExample trains it, at 300 wide, through
   ``fit_file`` and the native corpus scan over this repository's own .py
   and .md text (the scan equal to its numpy fallback; words/s, the host
   ms a step split between the pairs, the negative draws and the copy and
   launches, launches a step and the busy share of a profiled prefix, the
   nearest words of a few), a twin over a prefix on the card and the CPU
   in f32 and f64; ParagraphVectors (DBOW, DM) over the port's files as
   labelled documents, ``infer_vector`` against CPU copies (the card's
   tables bit for bit unchanged), GloVe (5 epochs at batch 8192) against
   the CPU, each in the ratio form; the word vectors written as text,
   binary and zip from the card and a CPU copy (the same bytes) and read
   back onto both (equal); then DL4J's CnnSentenceClassificationExample
   (three "same" convolutions over (3|4|5, 300), a merge, a global max
   pool, softmax over 2, Adam(0.01)) fed by ``CnnSentenceDataSetIterator``
   (32 x 256 x 300 x 1 batches of seeded two-class reviews): a warm-up
   and 20 timed fits (8 K2 a step, nothing else; median step, examples/s,
   busy share, device time by group, peak memory, the iterator's host ms
   a batch), the loss falling, held-out accuracy >= 0.9, one batch against
   an f64 twin, the zip restored bit for bit and one sentence classified
   on the card as on the CPU.
36. DL4J's graph-embedding path (``graph/``, ``clustering/``, ``plot/``),
   DeepWalk's own evaluation at BlogCatalog's size (a seeded block model of
   10,312 vertices, 333,983 edges and 39 groups, loaded by
   ``GraphLoader``): DeepWalk at the paper's settings (pairs/s, the
   median step, launches a step, the busy share, the host ms a step split
   between the walks, the pairs and the step, the score at each tenth of
   the fit; a 1,000-vertex twin on the card and the CPU in f32 and f64);
   a softmax classifier over the vectors (2 K2 a step, held-out accuracy
   >= 0.7); KMeans (purity; against a CPU run from the same centres);
   exact t-SNE (its loop free of host reads; a short twin against the CPU)
   and Barnes-Hut; brute-force k-NN against the host VPTree, LSH against
   the CPU port, the k-NN server under 8 client threads; Node2Vec; the
   vectors' text file from the card and a CPU copy (the same bytes).
37. DL4J's char LSTM retrained through the continuous-training pipeline
   (``cli.py``, ``pipeline/``, ``streaming/``, ``util/preemption.py``):
   ``python -m deeplearning4j_tpu_torch.cli pipeline`` twice on one state
   directory over 160 sequences of this repository's text, (a) true
   labels (TRAIN 80 TBPTT chunks: 2 K1 + 8 K2 a chunk; the gate; a canary
   at 0.25 then 0.5 with shadow diffs; PROMOTE), then labels through a
   seeded permutation of the characters (ROLLBACK at the gate, the
   promoted version still live), the journal's terminal commits, the
   served zip bit for bit the promoted candidate's and within 1e-5 on the
   CPU; (b) the streamed batches as codec frames through an
   ``EmbeddedBroker``, a ``SocketPublisher``/``SocketConsumer`` pair and
   two ``Route``s into a ``StreamBuffer``, a ``ContinuousTrainer``'s two
   mini-epochs against a twin fed the same batches from a list; (c) a
   SIGTERM inside a fit under a ``PreemptionHandler``, the resumed zip bit
   for bit the parameters at that step boundary; (d) ``evaluate`` over a
   CSV of LeNet rows against ``Evaluation``; (e) ``serve`` and one binary
   predict; (f) ``profile``'s buckets naming K1 and K2.
38. data- and tensor-parallel training (``parallel/mesh.py``,
   ``sharding.py``, ``trainer.py``) in a world of one NCCL rank: (a) the
   world and its mesh; (b) GPT-2-small (8 x 1024, f32, seed 123) takes 3
   ``ParallelWrapper(mode="shared_gradients")`` steps on DTensors beside a
   twin's plain ``fit`` steps from the same weights, each loss within
   1e-6 relative and each parameter within 1e-5 of its largest entry, 12
   K3a, 12 K3b dq, 12 K3b dk/dv and 150 K2 launches a step through the
   kernels' ``local_map`` seams; (c) ``mode="averaging"``,
   ``averaging_frequency=2`` over 4 batches against 4 plain steps, the
   same limits; (d) ``shard_model_with_rules`` with ``DEFAULT_2D_RULES`` on
   a ``data=1, model=1`` mesh (every parameter path matches a rule), 2
   steps, the same limits and counts; (e) ``EarlyStoppingParallelTrainer``
   on the LeNet phase's LeNet (Adam: 8 K2 a step; the zoo LeNet's
   AdaDelta takes no kernel), 2 epochs of seeded images, against
   ``EarlyStoppingTrainer`` on a twin. The wrapper's median step beside
   plain ``fit``'s (CUDA events), its busy share, the peak memory and the
   phase's seconds are printed.
39. sharded serving in lockstep and the training masters
   (``parallel/lockstep.py``, ``inference.py``'s mesh paths,
   ``serving/registry.py``'s ``mesh=``, ``cli.py serve --mesh``,
   ``parallel/master.py``, ``compression.py``, ``dcn.py``) in a world of
   one NCCL rank: (a) the registry's GPT-2-small (T 256) placed by
   ``DEFAULT_2D_RULES`` on a ``data=1, model=1`` mesh, 8 client threads
   sending 48 one-row requests through the lockstep stream, v2 registered
   (placed, warmed, activated) under load: every answer within the
   served-answer limit of its version's own unplaced ``output``, 12 K3a a
   forward, ``describe()``'s mesh, no client error, no ``kernel_build``
   span after the warm-up, requests/s and p50; (b) ``cli.py serve --mesh
   data=1,model=1`` on a saved GPT-2-small cut to one block (its zip is
   written and read deflated), one binary answer within the same limit,
   ``--mesh`` with ``--dtype-policy`` exiting 2; (c)
   ``SharedTrainingMaster`` on GPT-2-small (8 x 1024, threshold 1e-4
   against Adam's 3e-4 step) for 3 steps against a twin written out in
   the phase (its gradient, the fused Adam kernel on a copy, quantization
   with a residual): losses within 1e-6 relative, parameters and
   residuals within 1e-5 of their largest entry, the threshold as
   ``_adapt_threshold`` moves it, each step's sparsity, 12 / 12 / 12 /
   150 launches a step; (d) ``ParameterAveragingTrainingMaster``
   (``averaging_frequency=2``, 4 batches) through
   ``DistributedMultiLayerNetwork`` against 4 plain ``fit`` steps, phase
   38's limits and counts; (e) ``threshold_encode`` / ``threshold_decode``
   on (c)'s flattened Adam update (~124 M entries) equal to the same call
   on a CPU copy; (f) ``CrossSliceGradientBridge`` between two Adam LeNets
   on the card through an ``EmbeddedBroker``, each on its own half of the
   LeNet data, exchanging after every step (8 K2 a step): the replicas
   within 4 thresholds of each other and apart by exactly their residuals,
   the bytes of each frame, and the last frame applied on a CPU copy
   equal to the card's. The shared master's median step beside plain
   ``fit``'s, its busy share, the peak memory and the phase's seconds are
   printed.

Any failure raises (exit code != 0). The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launches on the main paths, its error against the plain version
and its times beside its bound.

float32 matrix products run in full float32: TF32 is switched off.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SERVED_SHAPE = (8, 12, 1024, 64)  # [N, H, T, Dh] of GPT-2-small, batch 8
# the serving registry's attention: GPT-2-small at T SR_T, buckets 1 to 8
SR_ATTENTION = ((8, 12, 256, 64), True), ((1, 12, 256, 64), True)
KERNEL_SHAPES = [(SERVED_SHAPE, True), ((1, 2, 2048, 64), True),
                 ((2, 4, 256, 128), False), ((2, 2, 128, 256), True), *SR_ATTENTION]
KERNEL_TOL = 1e-4  # f32 both ways; only the summation order differs
# backward: max |kernel - plain| over each gradient, relative to the
# gradient's largest entry (sums over up to T products of order 1)
BWD_TOL = 1e-4
BWD_SHAPES = [(SERVED_SHAPE, True), ((2, 4, 256, 128), False),
              ((2, 2, 128, 256), True)]
# the bf16 flash kernels against their plain versions (the TPU kernel's
# rounding points): o, dq, dk, dv within BF16_TOL x max(1, largest entry)
# (one bf16 ulp is 3.9e-3 relative: the kernel rounds P against its
# running row max, the plain version against the final one, and sums in
# another order), the f32 LSE and D within BF16_ROW_TOL absolute. That
# limit follows the largest entry, which under a causal mask is row 0
# (o[0] = v[0]), so it cannot see a fault in the small late rows. So each
# entry x = sum_j term_j is also held to BF16_ELEM_TOL x (|plain| + A),
# A = sum_j |term_j| (P·|V| for o, |dS|·|K| for dq, |dS|ᵀ·|Q| for dk, Pᵀ·|dO|
# for dv): each version rounds each bf16 term (P or dS) once and the
# result once, at unit roundoff 2^-8, so two right versions differ by at
# most 2^-7 of that, and rows whose terms cancel keep their slack (the
# kernel's exp differs from torch's in the last f32 bits, which flips a
# rare P across a bf16 rounding boundary). dS = P ∘ (dO·Vᵀ − D) is itself
# an f32 difference that cancels (to 0 in row 0 of a causal head), so its
# magnitude in A carries 2^-7 of its own terms, P ∘ (|dO|·|V|ᵀ + |D|), far
# above any f32 evaluation error of it. The whole tensor is held to
# BF16_FROB_TOL in relative Frobenius norm, ||kernel - plain|| / ||plain||
BF16_TOL, BF16_ROW_TOL = 1e-2, 1e-4
BF16_ELEM_TOL, BF16_FROB_TOL = 2 ** -7, 4e-3
# the bf16 wrappers' host time a call: back-to-back calls at a shape whose
# kernels take a few microseconds, on the host clock
FLASH_HOST_SHAPE = (1, 1, 64, 64)
# the bf16 encoder's attention (B 32, 12 heads, T 128, Dh 64, full), the
# shape FlashAttentionHelper(causal=False) serves on its path
ENCODER_ATTENTION = ((32, 12, 128, 64), False)
FLASH_BF16_SHAPES = [(SERVED_SHAPE, True), (SERVED_SHAPE, False), ENCODER_ATTENTION,
                     ((1, 12, 192, 64), True), ((1, 12, 192, 64), False),
                     ((1, 97, 1024, 64), True),
                     ((2, 4, 256, 128), True), ((2, 4, 256, 128), False),
                     ((2, 2, 256, 256), True), ((2, 2, 256, 256), False),
                     SR_ATTENTION[1]]
# the SASS of the bf16 kernels and of the cluster LSTM kernels: (library
# source, a pattern that matches the start of the kernel's label (name and
# template arguments, kernel_label), instructions it must hold ("A|B": A or
# B), instructions it must not)
HOPPER_SASS = (
    ("flash_attention_fwd.cu", r"flash_attention_fwd_bf16_wgmma_kernel<",
     ("HGMMA", "UTMALDG"), ()),
    ("flash_attention_bwd.cu", r"flash_attention_bwd_dkv_bf16_wgmma_kernel<",
     ("HGMMA", "UTMALDG"), ()),
    ("flash_attention_bwd.cu", r"flash_attention_bwd_dq_bf16_wgmma_kernel<",
     ("HGMMA", "UTMALDG"), ()),
    ("flash_attention_fwd.cu", r"flash_attention_fwd_bf16_kernel<",
     ("HMMA",), ("HGMMA", "UTMALDG")),
    ("flash_attention_bwd.cu", r"flash_attention_bwd_dkv_bf16_kernel<",
     ("HMMA",), ("HGMMA", "UTMALDG")),
    ("flash_attention_bwd.cu", r"flash_attention_bwd_dq_bf16_kernel<",
     ("HMMA",), ("HGMMA", "UTMALDG")),
    # K1-bf16's cluster plan multiplies on the tensor cores, K1's (f32) on
    # the CUDA cores
    ("lstm_sequence.cu", r"lstm_sequence_cluster_kernel<\d+,bf16>",
     ("HMMA|HGMMA",), ()),
    ("lstm_sequence.cu", r"lstm_sequence_cluster_kernel<\d+>",
     (), ("HMMA", "HGMMA")),
)
# fused updater: max |kernel - plain| over each of p, m, v (and v-hat),
# relative to that tensor's largest entry; the same float32 coefficients
# both ways, only the kernel's fused multiply-adds round differently
ADAM_TOL = 1e-5
# the served answer against the same row with the plain attention path:
# |a - b| <= ATOL + RTOL * |b| over softmax probabilities (f32 through 12
# blocks; attention sums in another order)
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-8
ROWSUM_TOL = 1e-4
N_CLIENTS, N_REQUESTS, T = 8, 16, 1024
TRAIN_N, TRAIN_STEPS, PROFILED_STEPS = 8, 5, 2
# profile groups: (group, substrings of a kernel's name), first match wins
KERNEL_GROUPS = (
    ("K3a flash_attention_fwd", ("flash_attention_fwd_kernel",)),
    ("convolutions and pooling", ("conv", "fprop", "dgrad", "wgrad", "pool")),
    ("K3b flash_attention_bwd_dq", ("flash_attention_bwd_dq_kernel",)),
    ("K3b flash_attention_bwd_dkv", ("flash_attention_bwd_dkv_kernel",)),
    ("K2 fused_adam", ("fused_adam_kernel",)),
    ("K1 lstm_sequence", ("lstm_sequence_kernel", "lstm_sequence_cluster_kernel")),
    ("random draws", ("distribution", "philox", "bernoulli")),
    ("matrix products", ("gemm", "cutlass", "xmma", "sm90_", "ampere_")),
    ("softmax", ("softmax",)),
    ("gathers and scatters", ("index", "scatter", "gather", "embedding")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# the kernel path against the plain attention path on one batch: the loss
# within 1e-6 relative, each parameter's gradient within 1e-5 x its
# largest entry (f32 through 12 blocks, attention summed in another order;
# the first run on an H100 measured 0.0 and 7.4e-7)
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
# K1 against its plain version: max |kernel - plain| over each of ys, hN,
# cN, relative to max(1, that output's largest entry): f32 both ways, the
# recurrent dot products summed in another order, each step's rounding
# carried into the next (the first H100 runs measured at most 7.1e-7, at
# H = 1500, and 1.8e-7 at the character model's shapes)
LSTM_TOL = 1e-5
# [T, N, H] of the character model's paths: a TBPTT chunk, output over a
# whole example, the sampling prime ("The network ", 12 characters) and one
# sampled character; then two wider shapes that take the grid plan
LSTM_PATHS = {"train": (50, 32, 200), "output": (1000, 32, 200),
              "sample_prime": (12, 4, 200), "sample": (1, 4, 200)}
LSTM_SHAPES = list(LSTM_PATHS.values()) + [(128, 64, 512), (35, 20, 1500)]
HOST_CALLS = 1000  # back-to-back calls timed on the host clock at the sampling shape
# K1-bf16 against its plain version (lstm_sequence_plain on the same bf16
# tensors: the TPU kernel's rounding points) at the bf16 path's shape
# (bench.py's recurrent configuration: 2 x 512, B 64, T 128), the char
# model's training chunk and sampling prime, and one more on the grid plan
# (H = 1500, whose bf16 rw fits no cluster); [128, 64, 512] once more on
# the grid plan. The two versions round at the same points and differ only
# in the order of the f32 sums of h@rw, so a sum near a bf16 rounding
# boundary rounds the other way and the step carries it on. Held: each
# entry within LSTM_BF16_ELEM_TOL units of 2^-8 x max(|plain|, 2^-6) (one
# bf16 ulp is 1 to 2 such units), the relative Frobenius error within
# LSTM_BF16_FROB_TOL, and the kernel's relative Frobenius distance from an
# f64 recurrence on the same bf16 inputs within LSTM_BF16_F64_RATIO x the
# plain version's
LSTM_BF16_PATH = (128, 64, 512)
LSTM_BF16_SHAPES = [(LSTM_BF16_PATH, "auto"), ((50, 32, 200), "auto"),
                    ((12, 4, 200), "auto"), ((35, 20, 1500), "auto"),
                    (LSTM_BF16_PATH, "grid")]
# The limits, from the first H100 run (2x its worst readings, over these
# five shapes): worst entry 64 units (an entry near 0, where a one-ulp flip
# of a term of magnitude 1/2 to 1 cancels: c = f c + i g), relative
# Frobenius 2.29e-3 (H = 1500), f64 ratio 0.998 to 1.0002
LSTM_BF16_ELEM_TOL, LSTM_BF16_FROB_TOL, LSTM_BF16_F64_RATIO = 128.0, 5e-3, 1.05
# the bf16 LSTM path at bench.py's recurrent configuration (_bench_graveslstm:
# 2 x 512, 77 characters, B 64, T 128, Adam(1e-3), bf16 compute): its
# GravesLSTM network as it is, the same network on DL4J's standard LSTM
# (K1-bf16), and a Bidirectional + LastTimeStep LSTM classifier (2 classes)
LB_BATCH, LB_T, LB_VOCAB, LB_WIDTH = 64, 128, 77, 512
LB_WARMUP, LB_TIMED, LB_GRAVES_TIMED, LB_CLASSIFIER_STEPS = 3, 10, 5, 3
LB_TENSORS = 8  # W, RW, b of each LSTM, W and b of the output layer
# the recurrent stack at small width on the card against the same port
# layer on the CPU (same weights and inputs): f32 within the CPU tests'
# 1e-5 x max(1, largest entry) (outputs) and 1e-5 x the largest entry
# (each gradient); bf16 in the ratio form against the CPU's f64 result
# (BF16_WHOLE_RATIO for the output and the whole gradient, each tensor
# BF16_TENSOR_RATIO or BF16_TENSOR_FLOOR of its norm)
RS_N, RS_T, RS_IN, RS_H, RS_TOL = 4, 10, 12, 16, 1e-5
# the character model (LSTMCharModellingExample): its 77-character set
# (CharacterIterator.getMinimalCharacterSet), widths, batch and TBPTT length
CHARS = ("abcdefghijklmnopqrstuvwxyz" "ABCDEFGHIJKLMNOPQRSTUVWXYZ" "0123456789"
         "!&()?-'\",.:; \n\t")
CHAR_WIDTH, CHAR_BATCH, CHAR_LEN, CHAR_TBPTT, CHAR_BATCHES = 200, 32, 1000, 50, 2
CORPUS = ("ARCHITECTURE.md", "SURVEY.md")  # the repository's own text
N_SAMPLES, SAMPLE_LEN, PRIME = 4, 300, "The network "
# LeNet (__graft_entry__._lenet through the port's DSL) on the verify
# skill's data: 1024 seeded 28x28x1 images with a planted row signal, 5
# epochs of batch 128, then a timed window of LENET_TIMED steps after
# LENET_WARMUP, and output at batch LENET_OUT_BATCH
LENET_N, LENET_BATCH, LENET_EPOCHS, LENET_TENSORS = 1024, 128, 5, 8
LENET_WARMUP, LENET_TIMED, LENET_OUT_BATCH, LENET_MIN_ACCURACY = 2, 64, 256, 0.95
# the fused updater against stock Adam on a twin over 3 steps (cuDNN
# deterministic on both): each parameter within 1e-5 x its largest entry,
# the loss within 1e-6 relative; the zip's reload (card and CPU) within
# 1e-5 of the saved net's output
LENET_TWIN_STEPS, LENET_PARAM_TOL, LENET_LOSS_RTOL, LENET_ZIP_ATOL = 3, 1e-5, 1e-6, 1e-5
# the kernel path against the plain recurrence on a twin: one chunk's loss
# relative, each gradient relative to its tensor's largest entry; output
# probabilities absolute (the first H100 runs measured 0.0, 3.8e-7 and
# 2.1e-7: the backward is the same plain recomputation on both sides)
CHAR_LOSS_RTOL, CHAR_GRAD_TOL, CHAR_OUT_ATOL = 1e-6, 1e-5, 1e-5
# regularizer draws: a keep fraction within 5 standard errors of p; the
# noise's mean and variance within 1e-2 (AlphaDropout on N(0,1)) and 1%
# (GaussianDropout, the noise of GaussianNoise and WeightNoise)
DRAW_SHAPE, SPATIAL_SHAPE, KEEP_SIGMAS = (4096, 4096), (64, 32, 32, 64), 5.0
ALPHA_TOL, NOISE_RTOL = 1e-2, 1e-2
# example 17's regularization family at its own settings; its accuracy on
# the JAX package on the CPU (``examples/17_...py``'s regularization_family
# run alone) is 1.0, and the port's must lie within 0.05 of it
EX17_N, EX17_BATCH, EX17_EPOCHS, EX17_TENSORS = 512, 128, 15, 4
EX17_JAX_ACCURACY, EX17_ACCURACY_TOL, EX17_MAX_NORM = 1.0, 0.05, 2.0
# the regularized LeNet: 5 epochs each way, then LENET_REG_WINDOW_EPOCHS // 2
# timed epochs of each of four ways in turns (after a warm-up round); a
# step is the interval between two step starts of one epoch (the wait for
# the batch included)
LENET_REG_WINDOW_EPOCHS = 8
# GPT-2-small with attention dropout: 5 fit steps, a repeat within 1e-6
GPT2_DROPOUT, GPT2_REPEAT_RTOL = 0.1, 1e-6
# decode at GPT-2-small width: 8 x 240 seeded ids prefilled through
# rnn_time_step, then 16 single-token steps, each step's probabilities
# within 1e-4 absolute of output over the same 256 ids (the served-answer
# limit: the flash kernel sums in another order); generate, greedy, and
# generate_on_device from 8 prompts of 128 ids; sampling at temperature
# 0.8, top_k 40, top_p 0.95; beam_search on 2 prompts x beam 4
DECODE_N, DECODE_PREFILL, DECODE_STEPS, DECODE_ATOL = 8, 240, 16, 1e-4
GEN_PROMPT, GEN_TOKENS, GEN_PROFILED = 128, 64, 32
SAMPLE_KW = dict(temperature=0.8, top_k=40, top_p=0.95)
BEAM_N, BEAM_SIZE, BEAM_TOKENS, BEAM_PENALTY = 2, 4, 32, 1.0
# GPT-2-small trained by truncated BPTT: chunks of 256 of one 8 x 1024
# batch (the last label column masked, as in example 11), two fit calls;
# the zip of the trained net without its updater state restored on the
# card (output on 2 x 128 ids exact) and the CPU (within 1e-5)
TBPTT_LEN, TBPTT_FITS, ZIP_CPU_ATOL, ZIP_IDS = 256, 2, 1e-5, (2, 128)
# ResNet-50 at ImageNet shape: the batch tried first (halved until a step
# fits), warm-up and timed fit steps, profiled steps; the card's step
# against the CPU's at batch 2: the loss within 1e-5 relative in f32 and
# f64, and in f64 each parameter within 1e-4 x its largest entry and each
# running statistic within 1e-5. A randomly initialized ResNet-50's f32
# step is ill-conditioned (a few ReLU inputs within f32 rounding of zero
# flip sign between two summation orders, and each flip moves whole
# gradient entries), so in f32 the card's parameters after a step are
# printed, not held; held are the Nesterovs update of the same gradients
# (each parameter and its momentum within 2e-5 x the largest entry) and
# the card's f32 gradients against the CPU's f64 ones: the L2 norm of the
# error within RESNET_F32_FACTOR x the CPU's own f32 error, for the whole
# gradient and for each tensor (or within 1% of the tensor's gradient,
# where the CPU's f32 error happens to be smaller than that). A tensor's
# error comes from a few such flips, so one CPU sample of it scatters:
# against the CPU's f32 gradient of the same images, the worst of the 161
# tensors read 1.17 to 5.5 over five runs (within the 1% in all but one,
# bn5c_branch2b/beta at 4.5). Each tensor's yardstick is therefore the
# larger error of two CPU f32 gradients: of the images as given and of the
# images with each pixel moved by one f32 ulp (up or down, seeded), an
# input as far from the f64 one as f32's own rounding. The whole
# gradient's ratio keeps the first sample alone. The largest
# error of the output after the step is printed beside the CPU's, not
# held: their ratio ranged from 0.20 to 5.6 over three runs
RESNET_BATCH, RESNET_WARMUP, RESNET_TIMED, RESNET_PROFILED = 256, 3, 10, 2
RESNET_SIDE, RESNET_LABELS, RESNET_TWIN_BATCH = 224, 1000, 2
RESNET_LOSS_RTOL, RESNET_PARAM_TOL, RESNET_STATE_TOL = 1e-5, 1e-4, 1e-5
RESNET_UPDATE_TOL, RESNET_F32_FACTOR = 2e-5, 4.0
RESNET_GROUPS = (
    ("pooling", ("pool",)),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                      "xmma", "cudnn", "gemm", "sm90_", "sm80_", "cutlass")),
    ("BN reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# the bf16 paths (mixed precision, compute_dtype "bfloat16", f32 masters):
# GPT-2-small trained as the training phase trains it, on integer ids; its
# one-batch parity in the ratio form: the distance of the kernel path's
# loss and gradients from an f32 twin's (f32 kernels, the same weights)
# over the distance of a bf16 twin on the plain attention (auto-flash
# off) from it: the whole gradient within 2x, each tensor within 3x or
# within 2% of its f32 gradient's norm, the loss within 3x or 1e-3
# relative (bf16 rounds in other places on the two paths, so neither is
# the other's oracle; tests/test_torch_mixed_precision.py holds the same
# form against the JAX package on the CPU)
BF16_WHOLE_RATIO, BF16_TENSOR_RATIO, BF16_TENSOR_FLOOR = 2.0, 3.0, 2e-2
BF16_LOSS_RATIO, BF16_LOSS_FLOOR = 3.0, 1e-3
GPT2_BF16_GROUPS = (
    ("K3a-bf16", ("flash_attention_fwd_bf16_",)),  # either design
    ("K3b-dq-bf16", ("flash_attention_bwd_dq_bf16_",)),
    ("K3b-dkv-bf16", ("flash_attention_bwd_dkv_bf16_",)),
    ("K3 f32", ("flash_attention_fwd_kernel", "flash_attention_bwd_dq_kernel",
                "flash_attention_bwd_dkv_kernel")),
    ("K2 fused_adam", ("fused_adam_kernel",)),
    ("softmax", ("softmax",)),
    ("gathers and scatters", ("index", "scatter", "gather", "embedding")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# GEMM kernels by their names; f32 ones among them by these markers (on
# the bf16 path the f32 products are the loss head's)
GEMM_MARKS = ("gemm", "cutlass", "xmma", "sm90_", "ampere_", "nvjet")
F32_GEMM_MARKS = ("sgemm", "f32f32_f32", "tf32", "nvjet_sss", "_s1688", "simt")
# ResNet-50 in bf16 as bench.py runs it (its headline): the same batch,
# steps and twin batch as the f32 phase; the card's bf16 gradients at
# batch 2 against the CPU's f64 ones, over the CPU's own bf16 distance
# from them, in the same ratio form (per tensor within 3x or 5% of its
# f64 gradient's norm: a random ResNet-50's step is ill-conditioned, and
# bf16 flips more ReLU inputs than f32 does)
RESNET_BF16_TENSOR_FLOOR = 5e-2
# VGG16 in bf16 as bench.py runs it (_bench_vgg16): the zoo's VGG16 (1000
# labels, seed 1, its Nesterovs: no port kernel) at batch 64 x 224x224x3,
# 3 warm-up and 6 timed steps, 2 profiled; at batch 2 the card's bf16
# gradients (no dropout) against the CPU's f64 ones in the ResNet-50 bf16
# ratio form, the CPU's own f32 distance from f64 printed beside it (a
# random VGG16's f32 step is ill-conditioned on the CPU: its max pools
# hold near-ties, tests/test_torch_zoo_models.py)
VGG_BATCH, VGG_WARMUP, VGG_TIMED, VGG_PROFILED, VGG_TWIN_BATCH = 64, 3, 6, 2, 2
VGG_GROUPS = (
    ("pooling", ("pool",)),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                      "cudnn")),
    ("random draws", ("distribution", "philox", "bernoulli")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# the BERT-base-shape encoder in bf16 as bench.py runs its fallback
# (_bench_bert_import: the zoo's TransformerEncoder, 2 labels, seed 1,
# Adam(1e-4)) at B 32, T 128 on integer ids, ENC_WARMUP + ENC_TIMED steps
# each way: (a) as bench.py has it, no attention helper (full attention
# has no auto kernel): ENC_TENSORS K2 launches a step, no K3; (b) with
# FlashAttentionHelper(causal=False) registered, as the reference's opt-in
# path: 12 / 12 / 12 bf16 K3 a step and 12 K3a-bf16 in one output; (b)'s
# one-batch loss and gradients in the GPT-2 bf16 ratio form; a batch
# padded from ENC_MASK_VALID ids to T with its mask takes the plain path
# (no K3), and in f32 equals its unpadded prefix within ENC_MASK_TOL. Each
# way trains a fresh network from the same seed. Adam(1e-4) with no
# warm-up overshoots on the first steps of this post-LN encoder from random
# weights, in f32 as in bf16 (on an H100: 1.17, then 10.3 at step 2,
# then 0.7 to 3.8 for ten steps), so the loss is held to fall over the
# whole run: the mean of the last ENC_SETTLED steps below the first step's
ENC_BATCH, ENC_T, ENC_WARMUP, ENC_TIMED, ENC_TENSORS = 32, 128, 2, 18, 148
ENC_SETTLED = 5
# the networks' remaining API at full width: a window of NA_WINDOW batches
# through fit_batches_on_device against a clone's per-batch fit calls
# (parameters and updater state within NA_WINDOW_TOL x each tensor's
# largest entry, generator states equal); the char-RNN's
# to_computation_graph output within NA_GRAPH_OUT_TOL x max(1, largest
# entry) of the network's and NA_GRAPH_FITS more steps on both within
# NA_GRAPH_STEP_TOL x each tensor's largest entry; GPT-2 f32 score_examples
# within NA_SCORE_RTOL relative of each example's score alone
NA_WINDOW, NA_WINDOW_TOL, NA_GRAPH_FITS = 4, 1e-6, 2
NA_GRAPH_OUT_TOL, NA_GRAPH_STEP_TOL, NA_SCORE_RTOL = 1e-6, 1e-5, 1e-5
ENC_MASK_VALID, ENC_MASK_ROWS, ENC_MASK_TOL = 96, 8, 1e-5
# the zoo's other models at their published widths, f32, batch 8: one fit
# step and one output each, the fused updater registered (only ViT's Adam
# takes it); rows of output sum to 1 within ROWSUM_TOL
ZOO_BATCH = 8
VIT_B16 = dict(image_size=224, patch_size=16, n_layers=12, d_model=768,
               n_heads=12, d_ff=3072)
# the small-layer slice: three networks of the new layers (a feed-forward
# one on SL_VOCAB ids, a 1-D one over [N, T, C], a 2-D one over NHWC
# images) take SL_STEPS Adam steps on K2 from one set of weights, on the
# card and on the CPU: in f32 every parameter and Adam slot within SL_TOL
# x its largest entry of the CPU twin's (the CPU tests' limit), or, where
# the step is ill-conditioned, no farther from an f64 CPU twin's than
# SL_F32_FACTOR x the CPU f32 twin's distance from it. Adam scales each
# entry's step by its own gradient, so an entry whose gradient is a
# thousandth of the tensor's largest takes a full step from a gradient
# that f32 rounding (1e-6 of the largest entry, either way) moves by a
# thousandth: a bias that starts at 0 then lies 1e-5 to 1e-2 of its
# largest entry from the other f32 run after 3 steps, on the CPU as on the
# card. In bf16 one batch's loss and gradients in the GPT-2 bf16 ratio
# form (the f32 CPU twin the oracle, a bf16 CPU twin the yardstick), then
# the steps. Every parameter tensor must move on the card (each layer
# passes a gradient back). Darknet19 at its published
# width (1000 labels, 224x224x3) and SimpleCNN (10 labels, 48x48x3) at
# batch ZOO_BATCH: one fit, SL_ZOO_TIMED timed fits, one output; a bf16
# softmax row rounds each entry once, by at most bf16's unit roundoff
# (2^-8) of itself, so its sum lies within ROWSUM_TOL + 2^-8 of 1
SL_STEPS, SL_TOL, SL_F32_FACTOR, SL_ZOO_TIMED = 3, 1e-5, 4.0, 3
SL_VOCAB, SL_WIDTH, SL_FF_BATCH, SL_FF_LABELS = 10000, 256, 256, 100
SL_SEQ, SL_SEQ_LABELS = (32, 128, 64), 10
SL_IMAGES, SL_IMAGE_LABELS = (16, 64, 64, 3), 10
# in this order every layer passes a gradient back: thresholdedrelu (theta
# 1) follows logsoftmax, whose outputs near -log(256) give the next
# pre-activations a spread of ~5 (after an activation whose outputs lie in
# [0, 1) it would zero all of its inputs, and every gradient below it)
SL_ACTIVATIONS = ("relu6", "leakyrelu", "elu", "hardsigmoid", "hardtanh",
                  "rationaltanh", "rectifiedtanh", "logsoftmax", "thresholdedrelu",
                  "softplus", "softsign", "cube", "swish", "mish")
SIMPLE_CNN_SHAPE = (3, 48, 48)
ROWSUM_TOL_BF16 = ROWSUM_TOL + 2.0 ** -8
# layerwise pretraining: DL4J's VaeMNISTAnomaly (dl4j-examples,
# unsupervised/variational/VaeMNISTAnomaly.java) at its published widths,
# 784 -> encoder [256, 256] -> 32 -> decoder [256, 256] -> Bernoulli
# (sigmoid), leakyrelu, Adam(1e-3), xavier, l2 1e-4 (which the pretrain
# step does not add), batch 128; MNIST is not in the repository, so its
# rows are synthetic: PT_PROTOTYPES seeded binary patterns of density
# PT_DENSITY, each row one of them with PT_FLIP of its bits flipped (a
# structure the loss can learn). PT_BATCHES pretrain steps (14 K2 launches
# each), PT_PROFILED more under the profiler; one step against CPU twins
# and 3 against a stock-Adam twin on the card, each parameter and Adam
# slot within PT_TOL x its largest entry (else the small-layer f64 form,
# SL_F32_FACTOR); reconstruction_log_probability over PT_RECON_ROWS rows
# with PT_RECON_SAMPLES samples within PT_TOL relative of the CPU's, the
# same draws handed to both. A stacked denoising autoencoder (784 -> 256
# -> 64 -> softmax 10, corruption 0.3) pretrains PT_AE_BATCHES steps a
# layer and fits PT_FIT_STEPS, as a MultiLayerNetwork and as a
# ComputationGraph from the same weights and draws, within PT_GRAPH_TOL x
# each tensor's largest entry. FrozenLayer, TimeDistributedWrapper (over
# cnn_seq) and MixtureOfExpertsLayer networks take PT_FIT_STEPS Adam steps
# against CPU twins in the small-layer form
PT_BATCH, PT_BATCHES, PT_PROFILED, PT_TOL, PT_GRAPH_TOL = 128, 20, 5, 1e-5, 1e-6
PT_PROTOTYPES, PT_DENSITY, PT_FLIP = 10, 0.15, 0.05
PT_RECON_ROWS, PT_RECON_SAMPLES, PT_AE_BATCHES, PT_FIT_STEPS = 256, 16, 5, 3
VAE_MNIST = dict(n_in=784, n_out=32, encoder_layer_sizes=(256, 256),
                 decoder_layer_sizes=(256, 256))
PT_TD_SEQ = (16, 8, 28, 28, 1)  # [N, T, H, W, C] image sequences
# object detection: the zoo's TinyYOLO at its defaults ((3, 416, 416), 20
# VOC labels, seed 123, Adam(1e-3)) on YOLO_BATCH synthetic scenes of
# example 18's kind (bright squares whose side and channel encode the
# class; labels [13, 13, 25] in absolute grid units): one warm-up and
# YOLO_TIMED timed fits on one repeated batch (losses finite, the last
# below the first), 2 profiled; output at YOLO_BATCH decoded on the card
# and on the CPU from the same raw output (conf >= YOLO_CONF, NMS at
# YOLO_NMS): the same detections in the same order, boxes and
# confidences within YOLO_DET_TOL. At YOLO_TWIN_BATCH one f32 step on the
# card against the same step in f64 on the CPU: the loss within
# YOLO_LOSS_TOL relative (the step's max pools make the f32 gradients
# ill-conditioned, ROADMAP §C, so they are printed beside the CPU f32
# twin's distance, not held). YOLO2 at its defaults ((3, 608, 608), 80
# COCO labels) at YOLO2_BATCH: one fit and one output
YOLO_BATCH, YOLO_TIMED, YOLO_CONF, YOLO_NMS, YOLO_DET_TOL = 16, 10, 0.1, 0.4, 1e-5
YOLO_TWIN_BATCH, YOLO_LOSS_TOL, YOLO2_BATCH = 2, 1e-5, 8
# the DL4J-format fixtures (tests/fixtures): output within rtol 1e-5 / atol
# 1e-6 of the recorded one (the CPU tests' limit); the convnet's 3 more
# fit steps on the fused updater, 8 K2 launches a step
DL4J_FIXTURES = ("convnet", "lstm", "graph", "branchy_graph")
DL4J_RTOL, DL4J_ATOL, DL4J_FIT_STEPS, DL4J_CONVNET_TENSORS = 1e-5, 1e-6, 3, 8
# SameDiff: the zoo LeNet's widths in SameDiff ops (1,256,080 parameters in
# 8 variables, from a zoo LeNet's init), Adam(1e-3) on the fused updater,
# fit over SD_BATCHES batches of SD_BATCH synthetic MNIST-shaped images
# (8 K2 launches a step); one more step against CPU twins from the same
# variables and Adam state, each within SL_TOL x its largest
# entry or in the f64 form (SL_F32_FACTOR); save/load and evaluate over
# SD_EVAL images. Control flow over [SD_CF_ROWS, SD_CF_WIDTH] (a loop of
# at most SD_CF_BOUND trips stopping at 5, an if_cond; and unbounded):
# outputs and gradients within SD_CF_TOL x max(1, largest entry) of the
# CPU's. The zoo LeNet with its dense 500 a SameDiffLayer: SD_LAYER_STEPS
# Adam steps within SD_LAYER_TOL x each tensor's largest entry of the zoo
# LeNet's from the same weights
SD_BATCH, SD_BATCHES, SD_EVAL, SD_LENET_PARAMS = 128, 20, 256, 1256080
SD_CF_ROWS, SD_CF_WIDTH, SD_CF_BOUND, SD_CF_TOL = 64, 64, 8, 1e-6
SD_LAYER_STEPS, SD_LAYER_TOL = 3, 1e-6
# transfer learning: the zoo's VGG16 at its defaults fine-tuned as
# dl4j-examples' EditLastLayerOthersFrozen (frozen through fc2, layer
# TR_FROZEN_TILL; a new softmax head of TR_CLASSES) with Adam(1e-4):
# TR_STEPS steps at TR_BATCH on synthetic 224x224x3 images (one K2 launch
# per parameter tensor a step, frozen ones included); the featurized head
# TR_STEPS steps, each tensor within SL_TOL x its largest entry of a CPU
# twin's, else in the f64 form (SL_F32_FACTOR)
TR_FROZEN_TILL, TR_CLASSES, TR_BATCH, TR_STEPS = 19, 5, 16, 3
# gradient checkpointing: GPT-2-small (TRAIN_N x T, f32, Adam(3e-4)) with
# and without it, CK_STEPS timed fits each; one batch's loss and gradients
# within CK_TOL relative (each tensor's largest difference over its
# largest entry), with attention dropout GPT2_DROPOUT too
CK_STEPS, CK_TOL = 3, 1e-6
# the zoo's face models at their published widths, Adam on the fused
# updater (one K2 launch per parameter tensor a step), synthetic images
# (no face set is in the repository): InceptionResNetV1 (160x160x3) at
# batch FN_IRV1_BATCH, FaceNetNN4Small2 (96x96x3) at FN_NN4_BATCH, one
# warm-up and FN_STEPS timed fits, 2 profiled; the first batch's loss and
# gradients in f32 against an f64 twin on the card from the same weights:
# the loss within FN_LOSS_TOL relative, the whole gradient within
# FN_GRAD_TOL (relative L2; the zoo VGG16's f32 gradients lay 3.4e-3 from
# f64 on the card, its max pools' near-ties, so 3x that); each tensor's
# printed
FN_IRV1_BATCH, FN_NN4_BATCH, FN_STEPS, FN_LOSS_TOL, FN_GRAD_TOL = 32, 64, 5, 1e-5, 1e-2
# Keras import (tests/fixtures/keras, written by make_keras_fixtures.py),
# weights drawn from a seed at the shapes Keras stores: (a) BERT-base (12 x
# 768, 12 heads, vocab 30522, T 128, token and position ids) in bf16 with
# FlashAttentionHelper(causal=False), batch KI_BERT_BATCH, int64 ids, the
# imported network's default Sgd(0.1): KI_STEPS timed fits (12 / 12 / 12
# K3-bf16 launches a step, no K2) beside the zoo TransformerEncoder's at
# the same shape, 2 profiled; its f32 output at batch 2 (f32 K3a) within
# KI_BERT_TOL of an f64 twin's on the card; (b) keras-io's IMDB
# Bidirectional LSTM (maxlen 200) at batch KI_IMDB_BATCH, f32: output (4
# K1 launches) within LSTM_TOL x max(1, largest) of the plain recurrence's
# (the kernel off), KI_IMDB_STEPS fits; (c) keras-io's MNIST convnet:
# output at batch KI_CNN_BATCH within KI_CNN_TOL x max(1, largest) of the
# same network on the CPU
KI_BERT_BATCH, KI_STEPS, KI_BERT_TOL = 32, 5, 1e-4
KI_IMDB_BATCH, KI_IMDB_STEPS, KI_CNN_BATCH, KI_CNN_TOL = 32, 3, 64, 1e-5
# DL4J export of networks trained on the card: the LeNet of the lenet
# phase (lenet_conf: Adam on the fused updater, ME_STEPS steps at
# ME_BATCH) and a
# two-input dense graph (Merge, ElementWise); each zip read back onto the
# card by the port's DL4J reader: the graph's output equal (0.0), LeNet's
# within ME_LENET_TOL x max(1, largest) (its dense rows come back in
# DL4J's C, H, W order, so its product sums in another order); the Adam
# state read back equal; load_model_guess on the DL4J zips and the port's
# own zips gives each network's class
ME_STEPS, ME_BATCH, ME_LENET_TOL = 3, 64, 1e-6
# training utilities: (a) the zoo LeNet, Adam(1e-3) on the fused updater,
# TU_BATCH over TU_N seeded images with the planted signal, TU_HELD
# held-out; early stopping up to TU_EPOCHS epochs, patience TU_PATIENCE,
# checkpoints every TU_CKPT_EVERY steps keeping TU_CKPT_KEEP, the best
# zip's held-out score within TU_BEST_RTOL of the trainer's record; (b)
# GPT-2-small bf16, TU_GPT2_STEPS steps a run, ProfilerListener over steps
# TU_PROFILE (first, count); (c) Solver at full batch TU_SOLVER_N,
# TU_SOLVER_ITERS iterations an algorithm: the f32 first score and
# gradient (relative L2) within TU_SOLVER_F32_TOL of the f64 twin's, the
# f64 history within TU_SOLVER_F64_RTOL relative of the CPU's, entry by
# entry; (d) gradient checks at the reference's defaults on a narrowed
# LeNet (TU_GC_LENET: input side, conv widths, dense width, batch) and
# an LSTM network (TU_GC_LSTM: batch, steps, inputs, units, outputs); (e)
# TU_HPO_TRIALS random trials and a 2 x 2 grid, one epoch each
TU_N, TU_HELD, TU_BATCH, TU_EPOCHS, TU_PATIENCE = 4096, 1024, 128, 5, 2
TU_CKPT_EVERY, TU_CKPT_KEEP, TU_BEST_RTOL, TU_MAX_SECONDS = 8, 2, 1e-6, 600
TU_GPT2_STEPS, TU_PROFILE = 10, (3, 3)
# TU_SOLVER_N is 256 (1,024, then 512 earlier): (c)'s float64 CPU twin
# runs in process after the timed parts, and at 1,024 it took 96 s of the
# script; halved again to make room for the continuous-training phase
TU_SOLVER_N, TU_SOLVER_ITERS, TU_SOLVER_F32_TOL, TU_SOLVER_F64_RTOL = 256, 10, 1e-5, 1e-8
# the f32 first gradient below the output layer: a relu pre-activation
# within f32 rounding of 0 takes the other side of the kink than in f64
# (on an H100 80GB HBM3 at 700 W, one of the dense layer's 64000 at batch
# 128 moved its gradient by 0.6%), so those tensors are held at
# TU_SOLVER_F32_TIE_TOL (relative L2) and the flips are counted; the loss
# and the output layer's gradients at TU_SOLVER_F32_TOL
TU_SOLVER_F32_TIE_TOL = 1e-3
TU_ALGOS = ("stochastic_gradient_descent", "line_gradient_descent",
            "conjugate_gradient", "lbfgs")
TU_GC_LENET, TU_GC_LSTM = (12, (4, 6), 16, 4), (3, 6, 4, 8, 5)
TU_HPO_TRIALS, TU_HPO_SEED = 4, 0
# the serving registry: GPT-2-small at its published width under one
# name in four versions (v1 f32 seed SR_SEEDS[0]; v2 f32 seed SR_SEEDS[1];
# v3 int8 of v2, calibrated on SR_SAMPLE rows; v4 bf16 of v2), served at
# batch <= 8 over buckets (1, 2, 4, 8) with tracing, metrics and the cost
# ledger on. SR_CLIENTS threads send SR_REQUESTS one-row requests of SR_T
# ids; v2 is activated after the SR_ACTIVATE_AT-th answer, a SR_CANARY
# split to v3 set after the SR_SPLIT_AT-th. Each answer is held to its
# served version's own output on the same row within the served-answer
# limit (SERVE_RTOL / SERVE_ATOL; v4's SR_BF16_REQUESTS pinned requests
# too: the same kernel on the same row); the calibration on the card
# beside the port's on the CPU: int8's rel_err within SR_INT8_CAL_TOL
# relative (f32 both ways), bf16's within a factor SR_BF16_CAL_BAND either
# way (the bf16 roundings differ in order; PERF.md §2); v3's growth of
# torch.cuda.memory_allocated at its registration within SR_GROWTH_TOL of
# its param_nbytes; a crash_forward fault at the next dispatch is served
# through on the fallback chain (SR_CRASH_REQUESTS requests), the
# dispatcher restarted after its backoff and the breaker closed again by
# its probe; the phase within SR_MAX_SECONDS
SR_SEEDS, SR_T, SR_CLIENTS, SR_REQUESTS = (123, 124), 256, 8, 48
SR_ACTIVATE_AT, SR_SPLIT_AT, SR_CANARY, SR_SAMPLE = 16, 32, 0.25, 2
SR_BF16_REQUESTS, SR_CRASH_REQUESTS, SR_GROWTH_TOL, SR_MAX_SECONDS = 4, 3, 0.10, 60.0
SR_INT8_CAL_TOL, SR_BF16_CAL_BAND = 1e-3, 4.0
SR_BREAKER = dict(failure_threshold=1, window_s=60.0, cooldown_s=2.0, half_open_probes=1)
# the HTTP front end: the registry's four GPT-2-small versions (seeds and
# policies of SR_*) behind a ModelServer on loopback, called by a
# ModelServingClient from HS_CLIENTS threads with binary frames: HS_REQUESTS
# one-row requests of SR_T ids under a SR_CANARY split to v3, then
# HS_BF16_REQUESTS pinned to v4 (their frames "bfloat16", byte for byte the
# codec's frame of v4's own output), and HS_JSON_REQUESTS JSON requests of
# HS_JSON_ROWS rows to a small MLP served beside it. Every answer is held
# to its served version's own output within the served-answer limit;
# /readyz, /livez, /v1/models and /metrics are read during the load,
# /metrics and /debug/capture after it. Then resilience on a second server
# of max_inflight 1 over the same registry: a burst of HS_CLIENTS requests
# (429s with Retry-After) drives a burn-rate rule on a manual clock (HS_BURN),
# which engages a brownout that sheds priority 0 and degrades un-pinned
# requests to v2; HS_RECOVERY JSON requests resolve the rule; a
# drop_response fault is retried with one reconnect; a crash_forward is
# served through the fallback chain. Training side: a TrainingWatchdog and a
# TraceListener ride HS_LENET_STEPS Adam steps of the zoo LeNet (batch
# HS_LENET_BATCH), and example 26's diverging MLP ends as an "Error"
# termination under EarlyStoppingTrainer. The phase within HS_MAX_SECONDS.
HS_CLIENTS, HS_REQUESTS, HS_BF16_REQUESTS, HS_JSON_REQUESTS, HS_JSON_ROWS = 8, 48, 4, 4, 2
HS_RECOVERY, HS_LENET_STEPS, HS_LENET_BATCH, HS_MAX_SECONDS = 24, 5, 64, 60.0
HS_BURN = {"type": "burn_rate", "name": "serving_burn", "severity": "page",
           "slo": {"metric": "serving_requests_total", "error_labels": {"status": "429"},
                   "objective": 0.99},
           "windows": [{"long_s": 3600, "short_s": 300, "factor": 2.0}]}

# DL4J's text-classification path (phase 35, nlp_text_classification). (a)
# Word2Vec as DL4J's Word2VecRawTextExample trains it (window 5, 5
# negatives, min word frequency 5, 1 epoch, seed 42) at the width of the
# GoogleNews vectors CnnSentenceClassificationExample reads (300), by
# fit_file (the native corpus scan) over this repository's own .py and .md
# text: one line a source line, the files in sorted path order, hidden and
# build directories skipped (NLP_W2V_LINES cuts it; None: whole). A twin
# over the first NLP_TWIN_LINES lines on the card and in the port on the CPU
# in f32 and f64: syn0 and syn1neg on the card within NLP_TOL x their
# largest entry of the CPU f32 tables, or no farther from the f64 ones than
# NLP_F32_FACTOR x the CPU f32 tables are (index_add_ on the card adds in no
# fixed order); launches a step and the busy share from a profiled run over
# the first NLP_PROFILED_LINES lines. (b) ParagraphVectors, DBOW and DM,
# over the first NLP_PV_FILES files of NLP_PV_DIR as documents labelled by
# their paths, infer_vector of NLP_PV_INFER of them on the card against CPU
# copies of the same tables in f32 and f64, in that form, the card's tables
# bit for bit unchanged by it; GloVe (5 epochs at batch 8192) over the first
# NLP_GLOVE_LINES lines on the card, the CPU in f32 and in f64, in that
# form. (c) The word vectors written as text, binary and zip from the card
# and from a CPU copy (the same bytes; a zip's members), read back onto the
# card and the CPU (equal bit for bit; the text format within NLP_TEXT_TOL
# of the table: 6 decimals, then f32). (d)
# CnnSentenceClassificationExample's graph: three "same" convolutions of
# NLP_MAPS maps over (3|4|5, 300), stride (1, 300), leaky relu, relu init, a
# merge, a global max pool (dropout 0.5, which neither package applies:
# ROADMAP §C), softmax over 2, Adam(0.01), l2 1e-4;
# CnnSentenceDataSetIterator batches (NHWC, NLP_BATCH x NLP_LEN x 300 x 1,
# the vectors unnormalized as the example reads them) of seeded two-class
# reviews of NLP_LEN words, NLP_PLANTED of each from its class's
# NLP_PLANTED_SET planted words (taken among the frequent words
# NLP_PLANTED_FROM), the rest from the long tail (past NLP_FILLER_FROM).
# With 21 steps of Adam(0.01), planted words among the middle frequencies
# often left the classifier at chance: the long tail's patches won the max
# pool and took the first steps' gradient. One warm-up and NLP_TIMED timed
# fits (8 K2 a step, nothing else), the mean of the last 5 losses below the
# first 5's, held-out accuracy at least NLP_MIN_ACCURACY over NLP_HELD_OUT
# reviews, one batch's loss and gradients against an f64 twin in the ratio
# form, the zip restored on the card with output equal bit for bit,
# load_single_sentence classified on the card as on the CPU. The phase is
# meant to take at most NLP_MAX_SECONDS.
NLP_W2V = dict(layer_size=300, window_size=5, negative_sample=5,
               min_word_frequency=5, epochs=1, seed=42)
# NLP_W2V_LINES cuts the corpus to its first 50,000 lines: the repository's
# text grows with every module (175,044 lines took 84 s of host-bound steps;
# 100,000 until the continuous-training phase needed the room)
NLP_W2V_LINES, NLP_TWIN_LINES, NLP_TOL, NLP_F32_FACTOR = 50_000, 2000, 1e-5, 4.0
NLP_PROFILED_LINES = 300
NLP_NEAREST = ("def", "return", "tensor", "kernel")
NLP_SKIP_DIRS = ("build", "__pycache__")
NLP_PV = dict(layer_size=300, window_size=5, negative_sample=5, min_word_frequency=5,
              epochs=1, seed=42)
NLP_PV_DIR, NLP_PV_FILES, NLP_PV_INFER = "deeplearning4j_tpu_torch/", 48, 4
NLP_GLOVE = dict(layer_size=300, window=5, epochs=5, batch_size=8192, seed=42)
NLP_GLOVE_LINES = 1500
NLP_TEXT_TOL = 1e-6
NLP_FORMATS = {"text": ("write_word_vectors", "load_txt_vectors", "vectors.txt"),
               "binary": ("write_binary_model", "read_binary_model", "vectors.bin"),
               "zip": ("write_word2vec_model", "read_word2vec_model", "word2vec.zip")}
NLP_BATCH, NLP_LEN, NLP_MAPS, NLP_TIMED, NLP_HELD_OUT = 32, 256, 100, 20, 256
NLP_PLANTED, NLP_PLANTED_SET, NLP_MIN_ACCURACY, NLP_MAX_SECONDS = 16, 8, 0.9, 120.0
NLP_PLANTED_FROM, NLP_FILLER_FROM = (20, 220), 2000
NLP_GROUPS = (
    ("K2 fused_adam", ("fused_adam_kernel",)),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                      "xmma", "cudnn", "gemm", "sm90_", "sm80_", "cutlass", "nvjet")),
    ("reductions (the global max pool, the loss)", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)

# DL4J's graph-embedding path (phase 36, graph_clustering): DeepWalk's own
# evaluation (Perozzi et al. 2014, section 5) on DL4J's API. (a) A seeded
# degree-corrected stochastic block model of BlogCatalog's size (the
# DeepWalk paper's Table 1: GC_VERTICES vertices, GC_EDGES undirected edges,
# GC_GROUPS groups; the BlogCatalog file itself is not in the repository):
# the vertices dealt evenly into the blocks, power-law weights of exponent
# GC_EXPONENT scaled to BlogCatalog's mean degree, each edge drawn between
# an endpoint picked by weight and, with probability 1 - GC_OUT_DRAW, a
# partner picked by weight in its block, else one in another block, until
# GC_EDGES distinct edges (pairs inside a block repeat more often, so about
# a fifth of the edges leave their block); written as an edge list and read
# by GraphLoader. (b) DeepWalk at the paper's settings (GC_DEEPWALK,
# GC_FIT: gamma = 80 walks a vertex, t = 40, w = 10, d = 128, 8,192 pairs
# a step), the mean HS score of GC_SCORE_PAIRS fixed walk pairs at each
# tenth of the epochs (finite and falling), one epoch profiled on a second
# model, GC_PAD_STEPS steps of one batch timed with the padded path
# positions adding their zeros into inner node 0 (as the reference pads)
# and into each pair's own last inner node, in turns; a twin over a seeded GC_TWIN_VERTICES-vertex induced subgraph,
# GC_TWIN_EPOCHS epochs from the same carried tables on the card and on
# the CPU in f32 and f64 (sl_against_cpu's ratio form: index_add_ on the
# card adds in no fixed order), vertices_nearest and similarity on the card
# as on a CPU copy of its tables. (c) A softmax OutputLayer(128 -> 39),
# Adam(0.01) on the fused updater, GC_CLF_EPOCHS epochs of batch
# GC_CLF_BATCH over a seeded half of the vertices labelled by block (2 K2 a
# step, nothing else), the mean of the last 5 losses below the first 5's,
# held-out accuracy at least GC_MIN_ACCURACY. (d) KMeans (GC_KMEANS) over
# every vector: purity against the blocks; from the card's seeds a CPU run
# whose costs lie within GC_TOL relative of the card's, at least
# GC_MIN_SAME_ASSIGN of the assignments equal. (e) Exact t-SNE (GC_TSNE)
# over GC_TSNE_POINTS seeded vectors (None: all of them; the perplexity
# search is host f64 over N x N); its loop run short under the sync debug
# mode "error"; a GC_TSNE_TWIN_POINTS-point run of GC_TSNE_TWIN_ITERS
# iterations on the card against the CPU in f32 and f64 in the ratio form;
# Barnes-Hut over GC_BH_POINTS seeded vectors for GC_BH_ITERS iterations
# (its tree loop on the host by design). (f) Brute force on the card
# against the host VPTree for GC_VPTREE_QUERIES queries: the same index
# sets (where the k-th distance ties within GC_TIE_BAND relative, either
# member), equal distances lowest index first, distances in the ratio form
# against f64; search_excluding_self(GC_K) for every vertex; LSH (GC_LSH)
# recall@GC_K over GC_LSH_QUERIES queries beside the CPU port's on the
# same data, with the sign bits that differ; NearestNeighborsServer over
# the vectors with the blocks as labels, GC_CLIENTS client threads sending
# GC_REQUESTS /knn and /knnnew requests (every answer the local index's,
# the exposition counting them, the reference's 400s for bad bodies). (g)
# Node2Vec (GC_NODE2VEC, GC_N2V_FIT: its numpy walks scan a padded
# neighbour matrix as wide as the largest degree, so one walk a vertex of
# GC_N2V_FIT's length) on the same graph, its host walk time and a finite
# score; GraphVectorSerializer from the card and from a CPU copy of the
# table (the same bytes), read back onto both (bit for bit). The phase is
# meant to take at most GC_MAX_SECONDS.
GC_VERTICES, GC_EDGES, GC_GROUPS, GC_EXPONENT, GC_OUT_DRAW, GC_SEED = (
    10312, 333983, 39, 2.5, 0.125, 24)
GC_DEEPWALK = dict(vector_size=128, window_size=10, learning_rate=0.01, seed=12345)
GC_FIT = dict(walk_length=40, epochs=80)
GC_SCORE_PAIRS, GC_SCORE_POINTS, GC_TWIN_VERTICES, GC_TWIN_EPOCHS = 4096, 10, 1000, 2
GC_TOL, GC_F32_FACTOR, GC_SIM_TOL = 1e-5, 4.0, 1e-6
GC_CLF_BATCH, GC_CLF_EPOCHS, GC_MIN_ACCURACY = 256, 20, 0.7
GC_KMEANS, GC_KMEANS_PROFILED, GC_MIN_SAME_ASSIGN = (39, 100, "euclidean", 1), 5, 0.999
GC_TSNE, GC_TSNE_POINTS, GC_TSNE_PROFILED = dict(perplexity=30.0, n_iter=1000), 4096, 20
GC_TSNE_TWIN_POINTS, GC_TSNE_TWIN_ITERS, GC_BH_POINTS, GC_BH_ITERS = 512, 50, 500, 3
GC_K, GC_VPTREE_QUERIES, GC_TIE_BAND, GC_LSH_QUERIES = 10, 32, 1e-5, 256
GC_LSH = dict(hash_length=8, num_tables=8, seed=0)
GC_CLIENTS, GC_REQUESTS, GC_PAD_STEPS = 8, 400, 50
GC_NODE2VEC = dict(vector_size=128, window_size=1, learning_rate=0.01, p=0.25, q=4.0,
                   walks_per_vertex=1, seed=4)
GC_N2V_FIT = dict(walk_length=2, epochs=1)
GC_MAX_SECONDS = 100.0


def card_peaks(name: str):
    """The card's peaks from NVIDIA's data sheets (dense, at the full power
    limit): ``f32`` (non-tensor FLOP/s), ``tf32`` and ``bf16`` (tensor-core
    FLOP/s), ``mem`` (bytes/s) and a ``label``."""
    if "H100" in name and "PCIe" in name:
        f32, tf32, bf16, mem, label = 51e12, 378e12, 756e12, 2.0e12, "H100 PCIe"
    elif "H100" in name and "NVL" in name:
        f32, tf32, bf16, mem, label = 60e12, 417e12, 835e12, 3.9e12, "H100 NVL"
    elif "H200" in name:
        f32, tf32, bf16, mem, label = 67e12, 495e12, 989e12, 4.8e12, "H200 SXM"
    else:
        f32, tf32, bf16, mem, label = 67e12, 495e12, 989e12, 3.35e12, "H100 SXM"
    return {"f32": f32, "tf32": tf32, "bf16": bf16, "mem": mem,
            "label": f"{label}: {f32 / 1e12:g} TFLOP/s f32, {tf32 / 1e12:g} "
                     f"TFLOP/s TF32, {bf16 / 1e12:g} TFLOP/s bf16, "
                     f"{mem / 1e12:g} TB/s"}


def bound(flops, nbytes, peaks, rate="f32"):
    """(least time in ms, what bounds it): the larger of the operations
    over the compute rate and the bytes over the memory rate. ``rate``
    "f32" is the CUDA cores' f32 rate; "3xtf32" counts each f32-accurate
    product as three TF32 products on the tensor cores; "bf16" is the
    tensor cores' dense bf16 rate."""
    if rate == "f32":
        t_ops = flops / peaks["f32"] * 1e3
    elif rate == "bf16":
        t_ops = flops / peaks["bf16"] * 1e3
    else:
        t_ops = 3.0 * flops / peaks["tf32"] * 1e3
    t_bytes = nbytes / peaks["mem"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def product_bound(flops, nbytes, peaks):
    """The bound of a kernel whose work is f32 matrix products: ``bound_ms``
    at the 3xTF32 rate (the least time for the same f32-accurate work) and
    ``bound_simt_ms`` at the CUDA cores' f32 rate, as earlier rows had it."""
    ms, by = bound(flops, nbytes, peaks, "3xtf32")
    return {"bound_ms": ms, "bound_by": by,
            "bound_simt_ms": bound(flops, nbytes, peaks)[0]}


def flash_bound(shape, causal, peaks, products=2, heads_io=4, rows_io=0):
    """:func:`product_bound` of an attention kernel doing ``products`` [T x
    T x Dh] matrix products over the pairs this causality needs, reading
    and writing ``heads_io`` [N,H,T,Dh] and ``rows_io`` [N,H,T] f32 tensors
    once each. The forward: 2 products (q.kT, p.v), q, k, v in, o out."""
    n, h, t, dh = shape
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 2.0 * products * n * h * dh * pairs  # 2 flops per multiply-add
    nbytes = 4.0 * n * h * t * (heads_io * dh + rows_io)
    return product_bound(flops, nbytes, peaks)


def flash_bound_bf16(shape, causal, peaks, products=2, heads_io=4, rows_io=0):
    """The bound of a bf16 attention kernel: ``products`` [T x T x Dh] bf16
    matrix products over the pairs this causality needs at the tensor
    cores' bf16 rate, against ``heads_io`` bf16 [N,H,T,Dh] and ``rows_io``
    f32 [N,H,T] tensors read or written once each."""
    n, h, t, dh = shape
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 2.0 * products * n * h * dh * pairs
    nbytes = n * h * t * (2.0 * heads_io * dh + 4.0 * rows_io)
    ms, by = bound(flops, nbytes, peaks, "bf16")
    return {"bound_ms": ms, "bound_by": by}


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median per-launch time from CUDA events around each of ``runs``
    launches, enqueued back to back after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _randn(rng, shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            * np.float32(scale)).cuda()


def kernel_phase(ck, peaks):
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    rows = {}
    for shape, causal in KERNEL_SHAPES:
        q, k, v = (_randn(rng, shape) for _ in range(3))
        out, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        plain, plain_lse = ck.flash_attention_plain(q, k, v, causal,
                                                    return_lse=True)
        err = (out - plain).abs().max().item()
        lse_err = (lse - plain_lse).abs().max().item()
        if not (err <= KERNEL_TOL and lse_err <= KERNEL_TOL):
            raise RuntimeError(f"flash_attention_fwd {shape} causal={causal}: "
                               f"max abs err {err} (lse {lse_err}) > {KERNEL_TOL}")
        row = {
            "shape": list(shape), "causal": causal, "max_abs_err": err,
            "lse_max_abs_err": lse_err,
            "ms": median_ms(lambda: ck.flash_attention_fwd(q, k, v, causal)),
            "plain_ms": median_ms(lambda: ck.flash_attention_plain(q, k, v, causal)),
            "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
        }
        row.update(flash_bound(shape, causal, peaks))
        print("kernel flash_attention_fwd " + json.dumps(row), flush=True)
        rows[(shape, causal)] = row
        del q, k, v, out, lse, plain, plain_lse
    return rows[(SERVED_SHAPE, True)]


def backward_phase(ck, peaks):
    """K3b: the dq and dk/dv kernels against their plain versions on the
    forward kernel's own o and LSE; library: the backward of
    ``F.scaled_dot_product_attention`` (dq, dk and dv in one call)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(1)
    served = None
    for shape, causal in BWD_SHAPES:
        q, k, v, do = (_randn(rng, shape) for _ in range(4))
        o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
        dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        dk, dv = ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)
        torch.cuda.synchronize()
        p_dq, p_d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
        p_dk, p_dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, p_d, causal)
        errs = {}
        for name, got, ref in (("dq", dq, p_dq), ("d", d, p_d), ("dk", dk, p_dk),
                               ("dv", dv, p_dv)):
            err = (got - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            errs[name] = err
            if not err <= BWD_TOL * scale:
                raise RuntimeError(f"flash backward {shape} causal={causal}: "
                                   f"{name} max abs err {err} > {BWD_TOL} x {scale}")
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)

        lib_ms = median_ms(lib_bwd)
        if (shape, causal) == (SERVED_SHAPE, True):
            print("library kernels of SDPA's f32 backward "
                  + json.dumps(library_kernels(lib_bwd)), flush=True)
        rows = {
            "dq": {"max_abs_err": max(errs["dq"], errs["d"]),
                   "ms": median_ms(lambda: ck.flash_attention_bwd_dq(
                       q, k, v, o, lse, do, causal)),
                   "plain_ms": median_ms(lambda: ck.flash_attention_bwd_dq_plain(
                       q, k, v, o, lse, do, causal)),
                   "library_ms": lib_ms},
            "dkv": {"max_abs_err": max(errs["dk"], errs["dv"]),
                    "ms": median_ms(lambda: ck.flash_attention_bwd_dkv(
                        q, k, v, lse, do, d, causal)),
                    "plain_ms": median_ms(lambda: ck.flash_attention_bwd_dkv_plain(
                        q, k, v, lse, do, p_d, causal)),
                    "library_ms": lib_ms},
        }
        # dq: S, dP, dQ; reads q, k, v, o, dO and LSE, writes dQ and D.
        # dk/dv: S, dP, dV, dK; reads q, k, v, dO, LSE and D, writes dK, dV.
        rows["dq"].update(flash_bound(shape, causal, peaks, products=3,
                                      heads_io=6, rows_io=2))
        rows["dkv"].update(flash_bound(shape, causal, peaks, products=4,
                                       heads_io=6, rows_io=2))
        total = rows["dq"]["ms"] + rows["dkv"]["ms"]
        for name, row in rows.items():
            row.update(shape=list(shape), causal=causal, k3b_total_ms=total)
            print(f"kernel flash_attention_bwd_{name} " + json.dumps(row),
                  flush=True)
        if (shape, causal) == (SERVED_SHAPE, True):
            served = rows
        elif (shape, causal) == ENCODER_ATTENTION:
            encoder = rows
        del q, k, v, do, o, lse, dq, d, dk, dv, p_dq, p_d, p_dk, p_dv
        del ql, kl, vl, lib_out
    return served


def bf16_term_sums(ck, q, k, v, lse, do, d, causal):
    """Each bf16 output's sum of absolute terms A, from the plain version's
    f32 P and scaled dS: ``{"o": P·|V|, "dq": |dS|·|K|, "dk": |dS|ᵀ·|Q|,
    "dv": Pᵀ·|dO|}``, with |dS| = |bf16(dS)| + BF16_ELEM_TOL x P ∘ (|dO|·|V|ᵀ
    + |D|)·scale (dS's own terms)."""
    p, ds = ck._p_ds_bf16(q, k, v, lse, do, d, causal)
    own = torch.einsum("nhqd,nhkd->nhqk", do.float().abs(), v.float().abs())
    own = p * (own + d.abs()[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    ds = ds.to(torch.bfloat16).float().abs() + BF16_ELEM_TOL * own
    del own
    out = {"o": torch.einsum("nhqk,nhkd->nhqd", p, v.float().abs()),
           "dq": torch.einsum("nhqk,nhkd->nhqd", ds, k.float().abs()),
           "dk": torch.einsum("nhqk,nhqd->nhkd", ds, q.float().abs()),
           "dv": torch.einsum("nhqk,nhqd->nhkd", p, do.float().abs())}
    del p, ds
    return out


def bf16_readings(got, ref, terms):
    """A bf16 kernel output against its plain version: the max abs error,
    the largest |got - ref| / (BF16_ELEM_TOL (|ref| + terms)) (at most 1
    passes; ``terms`` is the entry's sum of absolute terms) and the
    relative Frobenius error."""
    g, r = got.double(), ref.double()
    diff = (g - r).abs()
    scale = BF16_ELEM_TOL * (r.abs() + terms.double())
    return {"max_abs_err": diff.max().item(),
            "elem_ratio": (diff / scale.clamp_min(1e-30)).max().item(),
            "frob_rel_err": (diff.norm() / r.norm().clamp_min(1e-30)).item()}


def flash_bf16_phase(ck, peaks):
    """The bf16 flash kernels (K3a-bf16, K3b-dq-bf16, K3b-dkv-bf16) against
    their plain versions (the TPU kernel's rounding points) on the card,
    causal and full, Dh 64/128/256: o, dq, dk, dv within BF16_TOL x max(1,
    largest entry), each entry within BF16_ELEM_TOL x (|plain| + its sum
    of absolute terms) and the whole within BF16_FROB_TOL relative
    Frobenius error, the f32 LSE and D within BF16_ROW_TOL; the backward
    kernels take the forward kernel's own o and LSE. Timed (CUDA-event
    medians of 25, and the profiler's device time a launch) beside their
    bf16 bound, their plain versions and SDPA in bf16 (forward; its
    backward for dq + dk/dv in one call; both timed the same two ways).
    Each shape prints the design that served the forward, the dq and the
    dk/dv kernel. Returns the rows at GPT-2-small's training shape, causal,
    and at the bf16 encoder's (ENCODER_ATTENTION)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    served = encoder = None
    for shape, causal in FLASH_BF16_SHAPES:
        q, k, v, do = (_randn(rng, shape).to(bf) for _ in range(4))
        o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
        dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        dk, dv = ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)
        torch.cuda.synchronize()
        p_o, p_lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
        p_dq, p_d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
        p_dk, p_dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
        if not all(t.dtype == bf for t in (o, dq, dk, dv)) or not all(
                t.dtype == torch.float32 for t in (lse, d)):
            raise RuntimeError("bf16 flash kernels: o, dq, dk, dv must be bf16 "
                               "and the LSE and D f32")
        terms = bf16_term_sums(ck, q, k, v, lse, do, d, causal)
        errs, readings = {}, {}
        for name, got, ref, row_stat in (
                ("o", o, p_o, False), ("lse", lse, p_lse, True),
                ("dq", dq, p_dq, False), ("d", d, p_d, True),
                ("dk", dk, p_dk, False), ("dv", dv, p_dv, False)):
            if row_stat:
                err = (got - ref).abs().max().item()
                ok = err <= BF16_ROW_TOL
                reading = {"max_abs_err": err, "limit": BF16_ROW_TOL}
            else:
                reading = bf16_readings(got, ref, terms[name])
                err = reading["max_abs_err"]
                reading.update(limit=BF16_TOL * max(1.0, ref.float().abs().max().item()),
                               elem_limit=1.0, frob_limit=BF16_FROB_TOL)
                ok = (err <= reading["limit"] and reading["elem_ratio"] <= 1.0
                      and reading["frob_rel_err"] <= BF16_FROB_TOL)
            errs[name], readings[name] = err, reading
            if not ok:
                raise RuntimeError(f"bf16 flash {shape} causal={causal}: {name} "
                                   f"outside its limits: {json.dumps(reading)}")
        del terms
        design = {kernel: ck.flash_bf16_tiles(kernel, shape[-1])[0]
                  for kernel in ("fwd", "dq", "dkv")}
        print(f"flash_bf16 agreement {list(shape)} causal={causal} design="
              f"{json.dumps(design)} " + json.dumps(readings), flush=True)
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)

        lib_bwd_ms = median_ms(lib_bwd)
        lib_bwd_device_ms = device_ms_per_call(lib_bwd)
        lib_fwd = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        fwd = lambda: ck.flash_attention_fwd(q, k, v, causal)  # noqa: E731
        dq_call = lambda: ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)  # noqa: E731
        dkv = lambda: ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)  # noqa: E731
        if (shape, causal) == (SERVED_SHAPE, True):
            print("library kernels of SDPA's bf16 forward and backward "
                  + json.dumps({"forward": library_kernels(lib_fwd),
                                "backward": library_kernels(lib_bwd)}), flush=True)
        rows = {
            "fwd": {"max_abs_err": errs["o"], "lse_max_abs_err": errs["lse"],
                    "design": design["fwd"], "ms": median_ms(fwd),
                    "device_ms": device_ms_per_launch(fwd, "flash_attention_fwd_bf16_"),
                    "plain_ms": median_ms(lambda: ck.flash_attention_plain(
                        q, k, v, causal)),
                    "library_ms": median_ms(lib_fwd),
                    "library_device_ms": device_ms_per_call(lib_fwd),
                    **flash_bound_bf16(shape, causal, peaks)},
            "dq": {"max_abs_err": errs["dq"], "d_max_abs_err": errs["d"],
                   "design": design["dq"], "ms": median_ms(dq_call),
                   "device_ms": device_ms_per_launch(dq_call, "flash_attention_bwd_dq_bf16_"),
                   "plain_ms": median_ms(lambda: ck.flash_attention_bwd_dq_plain(
                       q, k, v, o, lse, do, causal)),
                   "library_ms": lib_bwd_ms, "library_device_ms": lib_bwd_device_ms,
                   **flash_bound_bf16(shape, causal, peaks, products=3,
                                      heads_io=6, rows_io=2)},
            "dkv": {"max_abs_err": max(errs["dk"], errs["dv"]),
                    "design": design["dkv"], "ms": median_ms(dkv),
                    "device_ms": device_ms_per_launch(dkv, "flash_attention_bwd_dkv_bf16_"),
                    "plain_ms": median_ms(lambda: ck.flash_attention_bwd_dkv_plain(
                        q, k, v, lse, do, d, causal)),
                    "library_ms": lib_bwd_ms, "library_device_ms": lib_bwd_device_ms,
                    **flash_bound_bf16(shape, causal, peaks, products=4,
                                       heads_io=6, rows_io=2)},
        }
        total = rows["dq"]["ms"] + rows["dkv"]["ms"]
        for name, row in rows.items():
            row.update(shape=list(shape), causal=causal)
            if name != "fwd":
                row["k3b_total_ms"] = total
            print(f"kernel flash_bf16_{name} " + json.dumps(row), flush=True)
        if (shape, causal) == (SERVED_SHAPE, True):
            served = rows
        elif (shape, causal) == ENCODER_ATTENTION:
            encoder = rows
        del q, k, v, do, o, lse, dq, d, dk, dv, p_o, p_lse, p_dq, p_d, p_dk, p_dv
        del ql, kl, vl, lib_out, lib_fwd, fwd, dq_call, dkv
    # the wrappers' host time a call: at the served shape the kernels take
    # about as long, so back-to-back CUDA-event medians there can time the
    # host (compare "ms" with "device_ms")
    q, k, v, do = (_randn(rng, FLASH_HOST_SHAPE).to(bf) for _ in range(4))
    o, lse = ck.flash_attention_fwd(q, k, v, True, return_lse=True)
    _, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, True)
    for name, fn in (("fwd", lambda: ck.flash_attention_fwd(q, k, v, True)),
                     ("dq", lambda: ck.flash_attention_bwd_dq(q, k, v, o, lse, do, True)),
                     ("dkv", lambda: ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, True))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        served[name]["host_us_per_call"] = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
        served[name]["host_shape"] = list(FLASH_HOST_SHAPE)
    print("flash_bf16 host " + json.dumps({n: served[n]["host_us_per_call"]
                                           for n in ("fwd", "dq", "dkv")}), flush=True)
    return served, encoder


def adam_phase(ck, peaks):
    """K2 on GPT-2-small's own parameter shapes (the output matrix, its
    bias of odd length 50257, the first fused QKV matrix, and the bias as
    a view one float into its buffer, which takes the kernel's unaligned
    path) for Adam, AMSGrad and Nadam over steps t = 1..3; timed on the
    output matrix with Adam. Library: ``torch._fused_adam_`` on the same
    single tensor."""
    from deeplearning4j_tpu_torch.nn.updaters import AMSGrad, Adam, Nadam
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    conf = TransformerLM().conf()
    out_shapes = conf.vertices["out"].obj.param_shapes()
    tensors = {"out/W": out_shapes["W"], "out/b": out_shapes["b"],
               "block0-att/Wqkv": conf.vertices["block0-att"].obj.param_shapes()["Wqkv"],
               "out/b, unaligned": out_shapes["b"]}
    # and LeNet's eight tensors, the shapes its fit path gives the kernel
    for i, layer in enumerate(lenet_conf().layers):
        tensors.update({f"lenet {i}/{n}": shape
                        for n, shape in layer.param_shapes().items()})
    kinds = ((ck.ADAM, Adam(3e-4)), (ck.AMSGRAD, AMSGrad(3e-4)),
             (ck.NADAM, Nadam(3e-4)))
    rng = np.random.default_rng(2)
    worst, worst_rel = 0.0, 0.0
    for name, shape in tensors.items():
        for kind, upd in kinds:
            n = int(np.prod(shape))
            if name.endswith("unaligned"):
                p = _randn(rng, (n + 1,), 0.02)[1:]
            else:
                p = _randn(rng, shape, 0.02)
            m, v = torch.zeros_like(p), torch.zeros_like(p)
            vh = torch.zeros_like(p) if kind == ck.AMSGRAD else None
            ref = [t.clone() if t is not None else None for t in (p, m, v, vh)]
            for t in (1.0, 2.0, 3.0):
                g = _randn(rng, p.shape, 1e-2)
                coef = ck.adam_coefficients(upd, 3e-4, t)
                ck.fused_adam(kind, p, m, v, vh, g, coef)
                ck.fused_adam_plain(kind, *ref, g, coef)
                torch.cuda.synchronize()
                for label, got, want in zip(("p", "m", "v", "v_hat"),
                                            (p, m, v, vh), ref):
                    if want is None:
                        continue
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
                    if not err <= ADAM_TOL * scale:
                        raise RuntimeError(
                            f"fused_adam {name} {type(upd).__name__} t={t}: "
                            f"{label} max abs err {err} > {ADAM_TOL} x {scale}")
    p, g = _randn(rng, tensors["out/W"], 0.02), _randn(rng, tensors["out/W"], 1e-2)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    coef = ck.adam_coefficients(Adam(3e-4), 3e-4, 1.0)
    step = torch.ones((), device=p.device)
    row = {
        "shape": list(tensors["out/W"]), "updater": "Adam", "max_abs_err": worst,
        "max_err_rel_to_max": worst_rel,
        "ms": median_ms(lambda: ck.fused_adam(ck.ADAM, p, m, v, None, g, coef)),
        "plain_ms": median_ms(lambda: ck.fused_adam_plain(ck.ADAM, p, m, v, None,
                                                          g, coef)),
        "library_ms": median_ms(lambda: torch._fused_adam_(
            [p], [g], [m], [v], [], [step], lr=3e-4, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)),
    }
    # reads p, m, v, g and writes p, m, v: 28 bytes and ~12 flops an element
    row["bound_ms"], row["bound_by"] = bound(12.0 * p.numel(), 28.0 * p.numel(),
                                             peaks)  # bytes, at either rate
    print("kernel fused_adam " + json.dumps(row), flush=True)
    return row


def serving_phase(ck, card, served_ms):
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    t0 = time.perf_counter()
    net = TransformerLM().init()  # GPT-2-small defaults, f32, on cuda
    torch.cuda.synchronize()
    print(f"serve: TransformerLM init {time.perf_counter() - t0:.3f} s, "
          f"{net.conf.num_params()} params on {net.device}", flush=True)
    pi = ParallelInference(net, mode="batched", max_batch_size=8,
                           buckets=(1, 2, 4, 8))
    warm = pi.warmup((T,))
    print("serve: warmup s per bucket " + json.dumps(warm), flush=True)

    rng = np.random.default_rng(2026)
    reqs = rng.integers(0, net.conf.vertices["embed"].obj.n_in,
                        (N_REQUESTS, 1, T)).astype(np.float32)
    results, latency, errors = [None] * N_REQUESTS, [0.0] * N_REQUESTS, []

    def client(c):
        try:
            for j in range(c, N_REQUESTS, N_CLIENTS):
                t_req = time.perf_counter()
                results[j] = pi.output(reqs[j])
                latency[j] = time.perf_counter() - t_req
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    batches0 = pi.batches_dispatched
    ck.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = ck.flash_attention_fwd.launches
    batches = pi.batches_dispatched - batches0
    pi.shutdown()
    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"serving failed: {errors or 'client hung'}")

    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    if not (batches > 0 and launches == n_layers * batches):
        raise RuntimeError(f"flash kernel launches {launches} != {n_layers} x "
                           f"{batches} forwards")
    for j, r in enumerate(results):
        if r is None or r.shape != (1, T, 50257) or not np.isfinite(r).all():
            raise RuntimeError(f"request {j}: bad answer "
                               f"{None if r is None else r.shape}")
        dev = np.abs(r.sum(-1, dtype=np.float64) - 1.0).max()
        if not dev <= ROWSUM_TOL:
            raise RuntimeError(f"request {j}: softmax rows sum off by {dev}")

    # the same row through the plain attention path
    helpers.set_auto_flash_attention(False)
    ref = net.output(reqs[0])
    helpers.set_auto_flash_attention(True)
    got = torch.from_numpy(results[0]).cuda()
    diff = (got - ref).abs()
    worst = (diff - SERVE_RTOL * ref.abs()).max().item()
    if not worst <= SERVE_ATOL:
        raise RuntimeError(f"served answer disagrees with the plain path: "
                           f"max |a-b| - rtol|b| = {worst}")
    # where a batch-8 dispatch spends its time: the forward on the device
    # (CUDA events; its attention is 12 kernel launches) and the copy of
    # the [8, T, vocab] f32 answer to the host
    x8 = torch.from_numpy(reqs[:8].reshape(8, T)).cuda()
    fwd_ms = median_ms(lambda: net.output(x8), runs=5, warmup=1)
    out8 = net.output(x8)
    torch.cuda.synchronize()
    t_copy = time.perf_counter()
    host8 = out8.cpu()
    d2h_ms = (time.perf_counter() - t_copy) * 1e3
    del out8, host8
    lat = np.asarray(latency) * 1e3
    stats = {
        "card": card, "requests": N_REQUESTS, "clients": N_CLIENTS,
        "tokens_per_request": T, "wall_s": wall,
        "requests_per_s": N_REQUESTS / wall,
        "tokens_per_s": N_REQUESTS * T / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "batches_dispatched": batches, "flash_launches": launches,
        "max_abs_diff_vs_plain_attention": diff.max().item(),
        "batch8_forward_ms": fwd_ms,
        "batch8_attention_ms": n_layers * served_ms,
        "batch8_copy_to_host_ms": d2h_ms,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("serve " + json.dumps(stats), flush=True)
    return launches


def worst_gradient(got, ref):
    """``(name, ratio)`` of the gradient tensor whose largest difference
    from ``ref`` is the largest share of ``ref``'s largest entry."""
    worst_name, worst = None, 0.0
    for key, named in ref.items():
        for n, r in named.items():
            ratio = ((got[key][n] - r).abs().max()
                     / r.abs().max().clamp_min(1e-30)).item()
            if ratio > worst:
                worst_name, worst = f"{key}/{n}", ratio
    return worst_name, worst


def kernel_group(name: str, groups=KERNEL_GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def device_ms_by_kernel(prof):
    """Device time (ms) by kernel name in a finished ``torch.profiler``
    run; raises when it recorded none."""
    per_kernel = {}
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3
    if not per_kernel:
        raise RuntimeError("torch.profiler recorded no device time")
    return per_kernel


def profiled(fn, cpu=True, attempts=3):
    """``(profile, wall_ms, device ms by kernel)`` of one synchronised run
    of ``fn()`` under torch.profiler. The profiler on the card has been
    seen to hand back a profile with no device events now and then (the
    same command recorded them in another run); such a profile is run
    again, up to ``attempts`` times, and the last one's error raises.
    ``fn`` must be safe to repeat."""
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        try:
            return prof, wall, device_ms_by_kernel(prof)
        except RuntimeError:
            if attempt == attempts - 1:
                raise
            print(f"profiler: no device time recorded, attempt {attempt + 1} "
                  f"of {attempts}", flush=True)


def library_kernels(fn):
    """The device kernels one call of ``fn`` runs, with their ms, from
    one ``torch.profiler`` pass (names cut to 120 characters)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {k[:120]: ms for k, ms in sorted(device_ms_by_kernel(prof).items(),
                                              key=lambda kv: -kv[1])}


def kernel_label(mangled: str):
    """``name<template args>`` of a mangled kernel name: the length-prefixed
    identifier ending in ``_kernel`` and the integer and bool template
    arguments after it; None for anything else."""
    i = 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        ident, i = mangled[j:j + n], j + n
        if ident.endswith("_kernel"):
            tail = mangled[i:]
            tmpl = tail[:tail.find("EEv") + 1] if tail.startswith("I") else ""
            args = re.findall(r"L[ib](\d+)E", tmpl)
            if "__nv_bfloat16" in tmpl:  # a kernel instantiated on bf16 storage
                args.append("bf16")
            return f"{ident}<{','.join(args)}>"
    return None


def ptxas_report(ck, source):
    """The ``-Xptxas -v`` lines (registers, spills, stack) of every kernel
    in the build log of ``csrc/<source>``, by kernel and template
    arguments (e.g. Dh and causal, or rows and registers of rw)."""
    with open(ck.build(source) + ".log") as f:
        lines = f.read().splitlines()
    report, cur = {}, None
    for line in lines:
        text = line.split(":", 1)[-1].strip() if line.startswith("ptxas") else line.strip()
        if "Compiling entry function" in line:
            m = re.search(r"'(_Z\w+)'", line)
            cur = kernel_label(m.group(1)) if m else None
            if cur:
                report[cur] = []
        elif cur and ("spill" in text or text.startswith("Used")):
            report[cur].append(text)
    return report


def profile_steps(net, x, labels, fits=PROFILED_STEPS, steps_per_fit=1,
                  groups=KERNEL_GROUPS, classify=kernel_group):
    """Device time of ``fits`` more fit calls (``steps_per_fit`` steps
    each) under torch.profiler, per step: by kernel group (``classify(name,
    groups)``), in all, and as a share of the step's wall time (host clock
    around steps that end in a synchronize; kernels of one stream do not
    overlap), with the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    steps = fits * steps_per_fit
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(fits):
            net.fit(x, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_kernel = {k: ms / steps for k, ms in device_ms_by_kernel(prof).items()}
    by_group = {}
    for name, ms in per_kernel.items():
        g = classify(name, groups)
        by_group[g] = by_group.get(g, 0.0) + ms
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "steps": steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
        "device_ms_per_step_by_group": dict(sorted(by_group.items(),
                                                   key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [[k[:100], v] for k, v in top],
    }


def gemm_group(name: str, groups):
    """:func:`kernel_group`, with matrix products split into bf16 and f32
    ones by the kernel's name."""
    low = name.lower()
    group = kernel_group(name, groups)
    if group == "other" and any(k in low for k in GEMM_MARKS):
        return ("f32 matrix products (the loss head)"
                if any(k in low for k in F32_GEMM_MARKS) else "bf16 matrix products")
    return group


def ratio_form(port, yard, ref, loss_port, loss_yard, loss_ref, tensor_floor):
    """The distance of ``port``'s gradients (``{key: {name: tensor}}``) and
    loss from ``ref``'s over the distance of ``yard``'s from them: the
    whole gradient (L2), each tensor (with its distance over ``ref``'s
    norm) and the loss; ``ok`` when within BF16_WHOLE_RATIO, each tensor
    within BF16_TENSOR_RATIO or ``tensor_floor`` of its norm, the loss
    within BF16_LOSS_RATIO or BF16_LOSS_FLOOR relative."""
    rows, p_sq, y_sq = [], 0.0, 0.0
    for v, named in ref.items():
        for n, w in named.items():
            w = w.double()
            e_p = (port[v][n].double().to(w.device) - w).norm().item()
            e_y = (yard[v][n].double().to(w.device) - w).norm().item()
            rel = e_p / max(w.norm().item(), 1e-30)
            rows.append((e_p / max(e_y, 1e-30), f"{v}/{n}", rel,
                         e_p <= BF16_TENSOR_RATIO * e_y or rel <= tensor_floor))
            p_sq, y_sq = p_sq + e_p ** 2, y_sq + e_y ** 2
    whole = math.sqrt(p_sq / max(y_sq, 1e-60))
    lp, ly = abs(loss_port - loss_ref), abs(loss_yard - loss_ref)
    worst = max(rows)
    out = {"grad_l2_ratio_whole": whole,
           "grad_l2_ratio_worst": [worst[0], worst[1], worst[2]],
           "grad_tensors_within": sum(r[3] for r in rows),
           "grad_tensors": len(rows), "loss_err": lp, "yardstick_loss_err": ly}
    out["ok"] = (whole <= BF16_WHOLE_RATIO and out["grad_tensors_within"] == len(rows)
                 and lp <= max(BF16_LOSS_RATIO * ly, BF16_LOSS_FLOOR * abs(loss_ref)))
    return out


def zero_launches(ck):
    """Sets every kernel's launch counts to 0."""
    ck.reset_lstm_counts()
    for c in (ck.fused_adam, ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
              ck.flash_attention_bwd_dkv):
        c.launches = 0
    for c in (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
              ck.flash_attention_bwd_dkv):
        c.launches_bf16 = 0


def read_launches(ck):
    """Each kernel's launches since :func:`zero_launches`, the f32 and the
    bf16 ones apart (``<kernel>`` and ``<kernel>_bf16``)."""
    flash = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
             ck.flash_attention_bwd_dkv)
    got = {f"{c.__name__}_bf16": c.launches_bf16 for c in flash}
    got.update({c.__name__: c.launches - c.launches_bf16 for c in flash})
    got["fused_adam"] = ck.fused_adam.launches
    got["lstm_sequence"] = ck.lstm_sequence.launches_by_dtype["f32"]
    got["lstm_sequence_bf16"] = ck.lstm_sequence.launches_by_dtype["bf16"]
    return got


def unexpected_launches(got, want):
    """The kernels of ``got`` whose count is not ``want``'s (0 where
    ``want`` names none)."""
    return {k: n for k, n in got.items() if n != want.get(k, 0)}


def tensors_of(net):
    """The number of parameter tensors of a network (K2's launches a
    step when every one takes the fused updater)."""
    return sum(len(named) for named in net.params.values())


def training_phase(ck, card):
    """GPT-2-small takes TRAIN_STEPS fit steps on one seeded batch with the
    fused updater registered, then PROFILED_STEPS more under the profiler;
    then the parity check on a twin network."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = TransformerLM().init()  # GPT-2-small, f32, seed 123, on cuda
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    n_tensors = tensors_of(net)
    rng = np.random.default_rng(123)
    ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_N, T))).cuda()
    x = ids.float()  # token ids arrive as floats, as in serving
    # next-token one-hot labels, built on the device
    labels = F.one_hot(torch.cat([ids[:, 1:], ids[:, -1:]], 1), vocab).float()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())

    counters = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv, ck.fused_adam)
    for c in counters:
        c.launches = 0
    losses, events = [], []
    for _ in range(TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(x, labels)
        end.record()
        events.append((start, end))
        losses.append(net.score_)  # waits for the step
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    step_ms = [s.elapsed_time(e) for s, e in events]
    # the whole window, first start to last end (host gaps between steps
    # included), and the same without the first step's warm-up
    window_ms = events[0][0].elapsed_time(events[-1][1])
    warm_window_ms = events[1][0].elapsed_time(events[-1][1])

    want = {"flash_attention_fwd": n_layers, "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers, "fused_adam": n_tensors}
    for name, per_step in want.items():
        if launches[name] != per_step * TRAIN_STEPS:
            raise RuntimeError(f"{name}: {launches[name]} launches in "
                               f"{TRAIN_STEPS} steps, expected {per_step} a step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not progress: losses {losses}")
    profile = profile_steps(net, x, labels)  # after the counts were read

    # parity on the card: the kernel path against the plain attention path
    # (and stock autograd) on a twin with the same weights, one batch
    twin = load_reference_params(TransformerLM().init(), export_params(net))
    g_k, loss_k = net.compute_gradient_and_score(x, labels)
    helpers.set_auto_flash_attention(False)
    try:
        g_p, loss_p = twin.compute_gradient_and_score(x, labels)
    finally:
        helpers.set_auto_flash_attention(True)
    del twin
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst_name, worst = worst_gradient(g_k, g_p)
    if not (loss_rel <= LOSS_RTOL and worst <= GRAD_TOL):
        raise RuntimeError(f"kernel path disagrees with the plain path: loss "
                           f"{loss_k} vs {loss_p} (rel {loss_rel}), worst "
                           f"gradient {worst_name} at {worst} x its max")

    # one update of all the tensors: the fused kernel (one launch each)
    # against the stock updater math and one multi-tensor library call
    # (these launches come after the counts were read)
    flat = [(net.params[v][n], g_k[v][n], net.updater_states[v][n])
            for v in net.params for n in net.params[v]]
    update_ms = median_ms(lambda: net._apply_updates(g_k), runs=5, warmup=1)
    helpers.clear_helper("updater")
    stock_ms = median_ms(lambda: net._apply_updates(g_k), runs=5, warmup=1)
    step_t = [torch.ones((), device=x.device) for _ in flat]
    lib_ms = median_ms(lambda: torch._fused_adam_(
        [p for p, _, _ in flat], [g for _, g, _ in flat],
        [s["m"] for _, _, s in flat], [s["v"] for _, _, s in flat], [], step_t,
        lr=3e-4, beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
        amsgrad=False, maximize=False), runs=5, warmup=1)
    n_elems = sum(p.numel() for p, _, _ in flat)
    stats = {
        "card": card, "batch": [TRAIN_N, T], "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms,
        "median_step_ms": float(np.median(step_ms)),
        "window_ms": window_ms,
        "tokens_per_s": TRAIN_STEPS * TRAIN_N * T / (window_ms / 1e3),
        "tokens_per_s_after_first_step":
            (TRAIN_STEPS - 1) * TRAIN_N * T / (warm_window_ms / 1e3),
        "launches": launches, "launches_per_step": {
            k: v // TRAIN_STEPS for k, v in launches.items()},
        "parity_loss_kernel": loss_k, "parity_loss_plain": loss_p,
        "parity_loss_rel": loss_rel, "parity_worst_grad": worst_name,
        "parity_worst_grad_rel_to_max": worst,
        "update_all_tensors_ms": update_ms, "update_elements": n_elems,
        "update_stock_ms": stock_ms, "update_library_ms": lib_ms,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile,
    }
    print("train " + json.dumps(stats), flush=True)
    del net, g_k, g_p, flat, labels
    return launches


def gpt2_bf16_phase(ck, card):
    """GPT-2-small in bf16 (``compute_dtype``, f32 masters): TRAIN_STEPS fit
    steps at TRAIN_N x T on integer ids with the fused updater (each step
    12 K3a-bf16, 12 K3b-dq-bf16, 12 K3b-dkv-bf16 and 150 K2 launches, no
    f32 flash launch), PROFILED_STEPS more under the profiler (bf16 and f32
    matrix products apart, the f32 loss head's three products timed alone
    beside them), one ``output`` (12 K3a-bf16), then one batch's loss and
    gradients in the ratio form (BF16_WHOLE_RATIO). Returns the launch
    counts of the steps and of the ``output``."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    def bf16_net():
        conf = TransformerLM().conf()  # GPT-2-small, seed 123
        conf.global_conf.compute_dtype = "bfloat16"
        return ComputationGraph(conf).init()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = bf16_net()
    vocab = net.conf.vertices["embed"].obj.n_in
    d_model = net.conf.vertices["embed"].obj.n_out
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    n_tensors = tensors_of(net)
    rng = np.random.default_rng(123)
    ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_N, T))).cuda()  # integer ids
    labels = F.one_hot(torch.cat([ids[:, 1:], ids[:, -1:]], 1), vocab).float()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    zero_launches(ck)
    losses, events = [], []
    for _ in range(TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(ids, labels)
        end.record()
        events.append((start, end))
        losses.append(net.score_)
    torch.cuda.synchronize()
    launches = read_launches(ck)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    window_ms = events[0][0].elapsed_time(events[-1][1])
    warm_window_ms = events[1][0].elapsed_time(events[-1][1])
    want = {"flash_attention_fwd_bf16": n_layers, "flash_attention_bwd_dq_bf16": n_layers,
            "flash_attention_bwd_dkv_bf16": n_layers, "fused_adam": n_tensors}
    bad_counts = unexpected_launches(launches, {k: per * TRAIN_STEPS
                                                for k, per in want.items()})
    profile = profile_steps(net, ids, labels, groups=GPT2_BF16_GROUPS,
                            classify=gemm_group)
    # the three f32 products of the loss head alone: logits, their data and
    # weight gradients ([8192, 768] x [768, 50257] and its transposes)
    h32 = torch.randn((TRAIN_N * T, d_model), device="cuda")
    w32 = torch.randn((d_model, vocab), device="cuda") * 0.02
    g32 = torch.randn((TRAIN_N * T, vocab), device="cuda")
    head_ms = median_ms(lambda: (h32 @ w32, g32 @ w32.T, h32.T @ g32),
                        runs=5, warmup=1)
    del h32, w32, g32

    # one bf16 output: 12 K3a-bf16 launches
    zero_launches(ck)
    out = net.output(ids[:2])
    torch.cuda.synchronize()
    out_launches = read_launches(ck)
    out_ok = (out.dtype == torch.bfloat16 and tuple(out.shape) == (2, T, vocab)
              and bool(torch.isfinite(out.float()).all()))
    del out

    # parity: the kernel path, a bf16 twin on the plain attention and an
    # f32 twin (the f32 kernels), one batch, the same weights
    weights = export_params(net)
    g_k, loss_k = net.compute_gradient_and_score(ids, labels)
    plain = load_reference_params(bf16_net(), weights)
    helpers.set_auto_flash_attention(False)
    try:
        g_p, loss_p = plain.compute_gradient_and_score(ids, labels)
    finally:
        helpers.set_auto_flash_attention(True)
    del plain
    ref = load_reference_params(TransformerLM().init(), weights)
    g_r, loss_r = ref.compute_gradient_and_score(ids, labels)
    del ref
    parity = ratio_form(g_k, g_p, g_r, loss_k, loss_p, loss_r, BF16_TENSOR_FLOOR)
    grads_f32 = all(t.dtype == torch.float32 for named in g_k.values()
                    for t in named.values())
    masters_f32 = all(t.dtype == torch.float32 for named in net.params.values()
                      for t in named.values())
    helpers.clear_helper("updater")
    stats = {
        "card": card, "batch": [TRAIN_N, T], "steps": TRAIN_STEPS,
        "compute_dtype": "bfloat16", "ids": "int64",
        "losses": losses, "step_ms": step_ms,
        "median_step_ms": float(np.median(step_ms)), "window_ms": window_ms,
        "tokens_per_s_after_first_step":
            (TRAIN_STEPS - 1) * TRAIN_N * T / (warm_window_ms / 1e3),
        "launches": launches,
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
        "output_launches": out_launches,
        "peak_device_mem_gb": peak_gb,
        "loss_head_f32_products_ms": head_ms,
        "profile": profile,
        "parity": {"loss_kernel": loss_k, "loss_plain_bf16": loss_p,
                   "loss_f32": loss_r, **parity},
        "grads_f32": grads_f32, "masters_f32": masters_f32,
    }
    print("gpt2_bf16 " + json.dumps(stats), flush=True)
    if bad_counts:
        raise RuntimeError(f"gpt2_bf16: launches {bad_counts} in {TRAIN_STEPS} "
                           f"steps, expected {want} a step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"gpt2_bf16 training did not progress: {losses}")
    if not (out_ok and out_launches["flash_attention_fwd_bf16"] == n_layers
            and out_launches["flash_attention_fwd"] == 0):
        raise RuntimeError(f"gpt2_bf16 output: {out_launches}, ok {out_ok}")
    if not (parity["ok"] and grads_f32 and masters_f32):
        raise RuntimeError(f"gpt2_bf16 parity: {parity}, f32 gradients "
                           f"{grads_f32}, f32 masters {masters_f32}")
    del net, g_k, g_p, g_r, labels, weights
    torch.cuda.empty_cache()
    return {"train": launches, "output": out_launches}


def lstm_bound(shape, peaks):
    """:func:`product_bound` of the LSTM sequence at [T, N, H]: the
    recurrent products (2 T N H 4H flops) and the xw additions, or reading
    xw, rw, h0, c0 and writing ys, hN, cN once each."""
    t, n, h = shape
    flops = 2.0 * t * n * h * 4 * h + t * n * 4 * h
    nbytes = 4.0 * (t * n * 4 * h + h * 4 * h + 2 * n * h + t * n * h + 2 * n * h)
    return product_bound(flops, nbytes, peaks)


def ifgo(w, h):
    """IFOG column blocks of ``w`` (..., 4H) in torch.nn.LSTM's IFGO order."""
    return torch.cat([w[..., :2 * h], w[..., 3 * h:], w[..., 2 * h:3 * h]], -1)


def device_ms_per_launch(fn, key: str, launches: int = 20) -> float:
    """Device time (ms) of the kernel whose name contains ``key`` that one
    call of ``fn`` launches, averaged over ``launches`` calls under
    torch.profiler: at T = 1 a kernel is shorter than its host call, so
    CUDA events around back-to-back calls would time the host."""
    fn()

    def calls():
        for _ in range(launches):
            fn()

    _, _, per_kernel = profiled(calls, cpu=False)
    total = sum(ms for k, ms in per_kernel.items() if key in k)
    if total == 0:
        raise RuntimeError(f"torch.profiler recorded no {key} kernel")
    return total / launches  # one such kernel a call


def device_ms_per_call(fn, calls: int = 20) -> float:
    """Device time (ms) of every kernel that one call of ``fn`` launches,
    averaged over ``calls`` calls under torch.profiler (a library call
    may launch several kernels)."""
    fn()

    def run():
        for _ in range(calls):
            fn()

    _, _, per_kernel = profiled(run, cpu=False)
    return sum(per_kernel.values()) / calls


def sass_check(ck):
    """The instructions of the bf16 flash kernels and the cluster LSTM
    kernels in the built libraries (``cuobjdump -sass``): each HOPPER_SASS
    kernel must hold the instructions it lists (one of each "A|B") and none
    of those it must not. Returns, by kernel, the count of each of HGMMA,
    UTMALDG and HMMA; raises on a kernel that breaks its row or is
    missing."""
    tool = os.path.join(os.path.dirname(ck._nvcc()), "cuobjdump")
    found, bad = {}, []
    for source in sorted({row[0] for row in HOPPER_SASS}):
        sass = subprocess.run([tool, "-sass", ck.build(source)], capture_output=True,
                              text=True, check=True).stdout
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            label = kernel_label(body.split("\n", 1)[0].strip())
            if label is None:
                continue
            ops = re.findall(r"\b(HGMMA|UTMALDG|HMMA)\.", body)
            counts = {op: ops.count(op) for op in ("HGMMA", "UTMALDG", "HMMA")}
            for src, key, need, forbid in HOPPER_SASS:
                if src == source and re.match(key, label):
                    found[label] = counts
                    if (not all(any(counts[op] for op in alt.split("|")) for alt in need)
                            or any(counts[op] for op in forbid)):
                        bad.append(label)
    missing = [key for _, key, _, _ in HOPPER_SASS
               if not any(re.match(key, label) for label in found)]
    if bad or missing:
        raise RuntimeError(f"SASS check: {bad} break their rows, {missing} missing: "
                           f"{json.dumps(found)}")
    return found


def lstm_kernel_phase(ck, peaks):
    """K1 against its plain version at LSTM_SHAPES, on a layer's own
    inputs: x [T,N,H] and W, b give the hoisted xw = x W + b, with a
    Xavier-scale rw and non-zero h0, c0; each plan the shape can take (the
    cluster plan where rw fits one cluster, and the grid plan), its plan
    (S, R, C, shared memory), its time by CUDA events and its device time
    a launch by the profiler, per step, and for the cluster plan its chain
    floor. Timed for the plan "auto" takes: the kernel after the hoisted
    product (what FusedLSTMHelper launches), the plain recurrence, and the
    yardstick: a one-layer torch.nn.LSTM (cuDNN) with the same weights,
    which computes the product itself. At the sampling shape, the host
    time of one call, both plans. Returns the rows by shape."""
    rng = np.random.default_rng(3)
    rows = {}
    for shape in LSTM_SHAPES:
        t, n, h = shape
        x = _randn(rng, (t, n, h))
        w = _randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h)))
        rw = _randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h)))
        b = _randn(rng, (4 * h,), 0.1)
        h0, c0 = _randn(rng, (n, h), 0.5), _randn(rng, (n, h))
        xw = x @ w + b
        auto = ck.lstm_plan_for(xw)
        plain = ck.lstm_sequence_plain(xw, rw, h0, c0)
        runs = 5 if t >= 1000 else 25
        by_plan = {}
        for plan in ("cluster", "grid") if auto["plan"] == "cluster" else ("grid",):
            got = ck.lstm_sequence(xw, rw, h0, c0, plan=plan)
            torch.cuda.synchronize()
            errs = {}
            for name, g, ref in zip(("ys", "hN", "cN"), got, plain):
                errs[name] = (g - ref).abs().max().item()
                scale = max(1.0, ref.abs().max().item())
                if not errs[name] <= LSTM_TOL * scale:
                    raise RuntimeError(f"lstm_sequence {shape} {plan} plan: {name} max "
                                       f"abs err {errs[name]} > {LSTM_TOL} x {scale}")
            row = {"max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
                   "ms": median_ms(lambda: ck.lstm_sequence(xw, rw, h0, c0, plan=plan),
                                   runs=runs),
                   "device_ms": device_ms_per_launch(
                       lambda: ck.lstm_sequence(xw, rw, h0, c0, plan=plan),
                       "lstm_sequence", launches=5 if t >= 1000 else 20)}
            row["device_ms_per_step"] = row["device_ms"] / t
            if plan == "cluster":
                row.update({k: auto[k] for k in ("S", "U", "R", "C", "smem")})
                row["resident_clusters"] = ck.cluster_occupancy(auto, h)
                row["chain_floor_ms"] = device_ms_per_launch(
                    lambda: ck.lstm_chain_floor(t, auto, n, h), "lstm_chain_floor",
                    launches=5 if t >= 1000 else 20)
                row["chain_floor_ms_per_step"] = row["chain_floor_ms"] / t
            if shape == LSTM_PATHS["sample"]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    ck.lstm_sequence(xw, rw, h0, c0, plan=plan)
                row["host_us_per_call"] = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
                torch.cuda.synchronize()
            by_plan[plan] = row
            print(f"kernel lstm_sequence {plan} plan " + json.dumps(
                {"shape": list(shape), **row}), flush=True)
        mine = by_plan[auto["plan"]]
        lib = torch.nn.LSTM(h, h).cuda()
        with torch.no_grad():
            lib.weight_ih_l0.copy_(ifgo(w, h).t())
            lib.weight_hh_l0.copy_(ifgo(rw, h).t())
            lib.bias_ih_l0.copy_(ifgo(b, h))
            lib.bias_hh_l0.zero_()
        state = (h0[None].contiguous(), c0[None].contiguous())
        with torch.no_grad():
            lib_ys = lib(x, state)[0]
            row = {
                "shape": list(shape), "plan": auto["plan"],
                "max_abs_err": max(r["max_abs_err"] for r in by_plan.values()),
                "ms": mine["ms"], "device_ms": mine["device_ms"],
                "chain_floor_ms": mine.get("chain_floor_ms"),
                "library_max_abs_diff_vs_plain": (lib_ys - plain[0]).abs().max().item(),
                "ms_with_input_product": median_ms(lambda: ck.lstm_sequence(
                    (x @ w + b), rw, h0, c0), runs=runs),
                "plain_ms": median_ms(lambda: ck.lstm_sequence_plain(xw, rw, h0, c0),
                                      runs=5 if t >= 1000 else 25),
                "library_ms": median_ms(lambda: lib(x, state), runs=runs),
                "library": "torch.nn.LSTM on cuDNN, with its input product; "
                           "compare with ms_with_input_product",
            }
        row.update(lstm_bound(shape, peaks))
        print("kernel lstm_sequence " + json.dumps(row), flush=True)
        rows[shape] = row
        del x, w, rw, b, h0, c0, xw, plain, lib, lib_ys
    return rows


def lstm_bound_bf16(shape, peaks):
    """The bound of K1-bf16 at [T, N, H]: the recurrent products (2 T N H 4H
    flops) at the tensor cores' bf16 rate, or reading xw, rw, h0, c0 and
    writing ys, hN, cN once each in bf16."""
    t, n, h = shape
    flops = 2.0 * t * n * h * 4 * h
    nbytes = 2.0 * (t * n * 4 * h + h * 4 * h + 2 * n * h + t * n * h + 2 * n * h)
    ms, by = bound(flops, nbytes, peaks, "bf16")
    return {"bound_ms": ms, "bound_by": by}


def bf16_lstm_readings(got, plain, exact):
    """K1-bf16's outputs ``got`` against ``plain`` (both (ys, hN, cN)) and
    an f64 recurrence ``exact`` on the same inputs: the largest error, the
    worst entry in units of 2^-8 x max(|plain|, 2^-6), the relative
    Frobenius error, and each version's relative Frobenius distance from
    ``exact`` with their ratio; over the three outputs together."""
    g = torch.cat([t.double().reshape(-1) for t in got])
    p = torch.cat([t.double().reshape(-1) for t in plain])
    e = torch.cat([t.reshape(-1) for t in exact])
    err = (g - p).abs()
    units = err / (2.0 ** -8 * p.abs().clamp_min(2.0 ** -6))
    d_k = ((g - e).norm() / e.norm()).item()
    d_p = ((p - e).norm() / e.norm()).item()
    return {"max_abs_err": err.max().item(), "elem_units": units.max().item(),
            "rel_frob": ((g - p).norm() / p.norm()).item(),
            "f64_dist_kernel": d_k, "f64_dist_plain": d_p,
            "f64_ratio": d_k / max(d_p, 1e-30)}


def lstm_bf16_kernel_phase(ck, peaks):
    """K1-bf16 against its plain version on the card at LSTM_BF16_SHAPES,
    on a bf16 layer's own inputs (xw = x W + b in bf16, as FusedLSTMHelper
    computes it, a Xavier-scale rw, non-zero h0, c0): its plan, the
    readings of :func:`bf16_lstm_readings` against their limits, its time
    (CUDA events, median of 25) and device time a launch (profiler) beside
    its bound, the cluster plan's chain floor, the plain version's time and
    the yardstick: a bf16 ``torch.nn.LSTM`` (cuDNN) with the same weights
    and its input product. Raises when a limit fails; returns the rows by
    (shape, plan)."""
    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    rows = {}
    for shape, plan in LSTM_BF16_SHAPES:
        t, n, h = shape
        x = _randn(rng, (t, n, h)).to(bf)
        w = _randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h))).to(bf)
        rw = _randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h))).to(bf)
        b = _randn(rng, (4 * h,), 0.1).to(bf)
        h0, c0 = _randn(rng, (n, h), 0.5).to(bf), _randn(rng, (n, h)).to(bf)
        xw = x @ w + b
        chosen = ck.lstm_plan_for(xw) if plan == "auto" else {"plan": "grid"}
        before = dict(ck.lstm_sequence.launches_by_dtype)
        got = ck.lstm_sequence(xw, rw, h0, c0, plan=plan)
        torch.cuda.synchronize()
        if (ck.lstm_sequence.launches_by_dtype["bf16"] != before["bf16"] + 1
                or ck.lstm_sequence.launches_by_dtype["f32"] != before["f32"]
                or any(o.dtype != bf for o in got)):
            raise RuntimeError(f"lstm_sequence bf16 {shape}: not one bf16 launch "
                               f"with bf16 outputs")
        plain = ck.lstm_sequence_plain(xw, rw, h0, c0)
        exact = ck.lstm_sequence_plain(xw.double(), rw.double(), h0.double(), c0.double())
        row = {"shape": list(shape), "plan": chosen["plan"], "requested": plan,
               **{k: chosen[k] for k in ("S", "U", "R", "C", "smem") if k in chosen},
               **bf16_lstm_readings(got, plain, exact)}
        if chosen["plan"] == "cluster":  # the tensor cores' tiles (M, N, K padded)
            row["mma"] = ck._cluster_mma(h, chosen["S"], chosen["R"])
        row["limits"] = {"elem_units": LSTM_BF16_ELEM_TOL, "rel_frob": LSTM_BF16_FROB_TOL,
                         "f64_ratio": LSTM_BF16_F64_RATIO}
        row["ok"] = (math.isfinite(row["max_abs_err"])
                     and row["elem_units"] <= LSTM_BF16_ELEM_TOL
                     and row["rel_frob"] <= LSTM_BF16_FROB_TOL
                     and row["f64_ratio"] <= LSTM_BF16_F64_RATIO)
        print("lstm_bf16 agreement " + json.dumps(row), flush=True)
        if not row["ok"]:
            raise RuntimeError(f"lstm_sequence bf16 {shape} {plan}: {row}")
        row["ms"] = median_ms(lambda: ck.lstm_sequence(xw, rw, h0, c0, plan=plan))
        row["device_ms"] = device_ms_per_launch(
            lambda: ck.lstm_sequence(xw, rw, h0, c0, plan=plan), "lstm_sequence")
        row["device_ms_per_step"] = row["device_ms"] / t
        if chosen["plan"] == "cluster":
            row["resident_clusters"] = ck.cluster_occupancy(chosen, h)
            row["chain_floor_ms"] = device_ms_per_launch(
                lambda: ck.lstm_chain_floor(t, chosen, n, h), "lstm_chain_floor")
            row["chain_floor_ms_per_step"] = row["chain_floor_ms"] / t
        row["plain_ms"] = median_ms(lambda: ck.lstm_sequence_plain(xw, rw, h0, c0))
        lib = torch.nn.LSTM(h, h).cuda().to(bf)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(ifgo(w, h).t())
            lib.weight_hh_l0.copy_(ifgo(rw, h).t())
            lib.bias_ih_l0.copy_(ifgo(b, h))
            lib.bias_hh_l0.zero_()
            state = (h0[None].contiguous(), c0[None].contiguous())
            row["library_max_abs_diff_vs_plain"] = (
                lib(x, state)[0].float() - plain[0].float()).abs().max().item()
            row["library_ms"] = median_ms(lambda: lib(x, state))
            row["ms_with_input_product"] = median_ms(
                lambda: ck.lstm_sequence(x @ w + b, rw, h0, c0, plan=plan))
        row["library"] = ("torch.nn.LSTM in bf16 on cuDNN, with its input product; "
                          "compare with ms_with_input_product")
        row.update(lstm_bound_bf16(shape, peaks))
        print("kernel lstm_sequence_bf16 " + json.dumps(row), flush=True)
        rows[(shape, plan)] = row
        del x, w, rw, b, h0, c0, xw, got, plain, exact, lib
    return rows


def lstm_bf16_conf(layer_cls):
    """bench.py's recurrent configuration (_bench_graveslstm) through the
    port's DSL, on ``layer_cls`` (GravesLSTMLayer as bench.py has it, or
    LSTMLayer), compute dtype bf16."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    v, w = LB_VOCAB, LB_WIDTH
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-3)).list()
            .layer(layer_cls(n_in=v, n_out=w, activation="tanh"))
            .layer(layer_cls(n_in=w, n_out=w, activation="tanh"))
            .layer(RnnOutputLayer(n_in=w, n_out=v, activation="softmax",
                                  loss="negativeloglikelihood"))
            .set_input_type(InputType.recurrent(v, LB_T)).build())
    conf.global_conf.compute_dtype = "bfloat16"
    return conf


def lstm_classifier_conf():
    """A sequence classifier at the same width: Bidirectional(LSTM(512))
    (concat), LastTimeStep(LSTM(512)), a 2-class softmax; bf16."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (BidirectionalWrapper,
                                                    LastTimeStepWrapper, LSTMLayer,
                                                    OutputLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    w = LB_WIDTH
    conf = (NeuralNetConfiguration.builder().seed(2).updater(Adam(1e-3)).list()
            .layer(BidirectionalWrapper(layer=LSTMLayer(n_in=LB_VOCAB, n_out=w,
                                                        activation="tanh")))
            .layer(LastTimeStepWrapper(layer=LSTMLayer(n_in=2 * w, n_out=w,
                                                       activation="tanh")))
            .layer(OutputLayer(n_in=w, n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(LB_VOCAB, LB_T)).build())
    conf.global_conf.compute_dtype = "bfloat16"
    return conf


def k1_counts(ck):
    """K1's launches since the last reset, by dtype."""
    return dict(ck.lstm_sequence.launches_by_dtype)


def timed_fits(net, x, y, steps):
    """``steps`` fit steps, each between two CUDA events; returns (step
    ms, losses)."""
    events, losses = [], []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(x, y)
        end.record()
        events.append((start, end))
        losses.append(net.score_)
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events], [float(v) for v in losses]


def lstm_bf16_phase(ck, card):
    """The bf16 LSTM path at full width (see the module docstring). Returns
    K1's launches by path and dtype, and K2's."""
    import tempfile

    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTMLayer, LSTMLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)

    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, LB_VOCAB, (LB_BATCH, LB_T))).cuda()
    x = F.one_hot(ids, LB_VOCAB).float()
    y = F.one_hot(torch.roll(ids, -1, 1), LB_VOCAB).float()
    chars = LB_BATCH * LB_T
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    paths, out = {}, {}

    def counted(fn):
        ck.reset_lstm_counts()
        ck.fused_adam.launches = 0
        got = fn()
        torch.cuda.synchronize()
        return got, {**k1_counts(ck), "fused_adam": ck.fused_adam.launches}

    # 1. bench.py's GravesLSTM network, unchanged: the plain loop (peepholes)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graves = MultiLayerNetwork(lstm_bf16_conf(GravesLSTMLayer)).init()
    steps = LB_WARMUP + LB_GRAVES_TIMED
    (g_ms, g_losses), paths["graveslstm_bf16_train"] = counted(
        lambda: timed_fits(graves, x, y, steps))
    out["graveslstm"] = {
        "median_step_ms": float(np.median(g_ms[LB_WARMUP:])), "step_ms": g_ms,
        "chars_per_s": chars / (float(np.median(g_ms[LB_WARMUP:])) / 1e3),
        "losses": g_losses, "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": paths["graveslstm_bf16_train"]}
    del graves
    if (paths["graveslstm_bf16_train"]["f32"] or paths["graveslstm_bf16_train"]["bf16"]
            or paths["graveslstm_bf16_train"]["fused_adam"] != LB_TENSORS * steps
            or not np.isfinite(g_losses).all()):
        raise RuntimeError(f"lstm_bf16 GravesLSTM: {out['graveslstm']}")

    # 2. the standard-LSTM network: K1-bf16 in every forward
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = MultiLayerNetwork(lstm_bf16_conf(LSTMLayer)).init()
    steps = LB_WARMUP + LB_TIMED
    (s_ms, s_losses), paths["lstm_bf16_train"] = counted(
        lambda: timed_fits(net, x, y, steps))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_steps(net, x, y)
    profile_counts = k1_counts(ck)  # launched under the profiler (not a path)
    o, paths["lstm_bf16_output"] = counted(lambda: net.output(x))
    out_ok = (o.dtype == torch.bfloat16 and tuple(o.shape) == (LB_BATCH, LB_T, LB_VOCAB)
              and bool(torch.isfinite(o.float()).all()))
    med = float(np.median(s_ms[LB_WARMUP:]))
    out["lstm"] = {"median_step_ms": med, "step_ms": s_ms, "chars_per_s": chars / (med / 1e3),
                   "losses": s_losses, "peak_device_mem_gb": peak_gb, "profile": profile,
                   "launches": paths["lstm_bf16_train"],
                   "output_launches": paths["lstm_bf16_output"],
                   "profiled_launches": profile_counts}
    # one batch against twins: f32 (plain recurrence: no f32 K1 in this
    # phase) and bf16 on the plain recurrence, the same weights
    weights = export_params(net)
    g_k, loss_k = net.compute_gradient_and_score(x, y)
    helpers.set_auto_fused_lstm(False)
    try:
        plain = load_reference_params(MultiLayerNetwork(lstm_bf16_conf(LSTMLayer)).init(),
                                      weights)
        g_p, loss_p = plain.compute_gradient_and_score(x, y)
        del plain
        f32_conf = lstm_bf16_conf(LSTMLayer)
        f32_conf.global_conf.compute_dtype = None
        ref = load_reference_params(MultiLayerNetwork(f32_conf).init(), weights)
        g_r, loss_r = ref.compute_gradient_and_score(x, y)
        del ref
    finally:
        helpers.set_auto_fused_lstm(True)
    parity = ratio_form(g_k, g_p, g_r, loss_k, loss_p, loss_r, BF16_TENSOR_FLOOR)
    grads_f32 = all(t.dtype == torch.float32 for named in g_k.values() for t in named.values())
    masters_f32 = all(t.dtype == torch.float32 for named in net.params.values()
                      for t in named.values())
    out["lstm"]["parity"] = {"loss_kernel": loss_k, "loss_plain_bf16": loss_p,
                             "loss_f32": loss_r, **parity}
    # the zip restored on the card: output bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lstm_bf16.zip")
        net.save(path)
        back = MultiLayerNetwork.load(path)
        zip_equal = bool(torch.equal(back.output(x), o))
        del back
    out["lstm"]["zip_output_bit_for_bit"] = zip_equal
    del net, g_k, g_p, g_r, o

    # 3. the bidirectional classifier: 3 K1-bf16 launches a forward
    torch.cuda.empty_cache()
    cls = MultiLayerNetwork(lstm_classifier_conf()).init()
    labels = F.one_hot(torch.from_numpy(rng.integers(0, 2, LB_BATCH)).cuda(), 2).float()
    (c_ms, c_losses), paths["bidi_classifier_train"] = counted(
        lambda: timed_fits(cls, x, labels, LB_CLASSIFIER_STEPS))
    co, paths["bidi_classifier_output"] = counted(lambda: cls.output(x))
    out["classifier"] = {"step_ms": c_ms, "losses": c_losses,
                         "launches": paths["bidi_classifier_train"],
                         "output_launches": paths["bidi_classifier_output"],
                         "output_shape": list(co.shape)}
    cls_ok = (tuple(co.shape) == (LB_BATCH, 2) and bool(torch.isfinite(co.float()).all())
              and np.isfinite(c_losses).all())
    del cls, co
    helpers.clear_helper("updater")
    print("lstm_bf16 " + json.dumps({"card": card, "batch": [LB_BATCH, LB_T],
                                     "width": LB_WIDTH, "vocab": LB_VOCAB, **out}),
          flush=True)

    want = {"lstm_bf16_train": {"f32": 0, "bf16": 2 * steps, "fused_adam": LB_TENSORS * steps},
            "lstm_bf16_output": {"f32": 0, "bf16": 2, "fused_adam": 0},
            "bidi_classifier_train": {"f32": 0, "bf16": 3 * LB_CLASSIFIER_STEPS,
                                      "fused_adam": 11 * LB_CLASSIFIER_STEPS},
            "bidi_classifier_output": {"f32": 0, "bf16": 3, "fused_adam": 0}}
    bad = {p: paths[p] for p in want if paths[p] != want[p]}
    if bad:
        raise RuntimeError(f"lstm_bf16 launches {bad}, expected {want}")
    if not (np.isfinite(s_losses).all() and np.mean(s_losses[-3:]) < np.mean(s_losses[:3])):
        raise RuntimeError(f"lstm_bf16 training did not progress: {s_losses}")
    if not (out_ok and cls_ok and zip_equal and grads_f32 and masters_f32 and parity["ok"]):
        raise RuntimeError(f"lstm_bf16: output ok {out_ok}, classifier ok {cls_ok}, zip "
                           f"{zip_equal}, f32 gradients {grads_f32}, f32 masters "
                           f"{masters_f32}, parity {parity}")
    return paths


def recurrent_stack_layers():
    """(name, port layer, input kind, K1 launches of an unmasked forward)
    for each layer of the recurrent stack at small width."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import InputType

    n_in, h = RS_IN, RS_H
    conv = L.ConvLSTM2DLayer(n_in=2, n_out=4, convolution_mode="same")
    conv.output_type(InputType.recurrent_convolutional(8, 8, 2, RS_T))
    return [("simple_rnn", L.SimpleRnnLayer(n_in=n_in, n_out=h), "rnn", 0),
            ("gru_reset_after", L.GRULayer(n_in=n_in, n_out=h), "rnn", 0),
            ("gru_classic", L.GRULayer(n_in=n_in, n_out=h, reset_after=False), "rnn", 0),
            ("bidirectional_lstm",
             L.BidirectionalWrapper(layer=L.LSTMLayer(n_in=n_in, n_out=h)), "rnn", 2),
            ("graves_bidirectional_lstm",
             L.GravesBidirectionalLSTMLayer(n_in=n_in, n_out=h), "rnn", 0),
            ("last_time_step_lstm",
             L.LastTimeStepWrapper(layer=L.LSTMLayer(n_in=n_in, n_out=h)), "rnn", 1),
            ("mask_zero_lstm", L.MaskZeroLayer(layer=L.LSTMLayer(n_in=n_in, n_out=h)),
             "rnn", 0),
            ("conv_lstm2d", conv, "cnn_seq", 0)]


def _stack_run(layer, params, x, mask, w, dtype):
    """One layer's output and the gradients of sum(out * w) by parameter,
    with the parameters and x in ``dtype``."""
    live = {k: v.to(dtype).detach().requires_grad_(True) for k, v in params.items()}
    xd = x.to(dtype)
    if type(layer).__name__ == "LastTimeStepWrapper":
        y = layer.forward(live, xd, mask=mask)
    else:
        y = layer.forward_seq(live, xd, mask=mask)[0]
    grads = torch.autograd.grad((y.double() * w.to(y.device)).sum(), list(live.values()))
    return y.detach(), dict(zip(live, grads))


def recurrent_stack_phase(ck, card):
    """Each layer of the recurrent stack on the card against the same port
    layer on the CPU (same weights, inputs and mask), f32 and bf16, with
    and without a mask; the K1 launches of each card forward. Returns K1's
    launches on the card by dtype."""
    rng = np.random.default_rng(21)
    mask = np.ones((RS_N, RS_T), np.float32)
    mask[1, 6:] = 0.0
    mask[2, 3] = 0.0
    totals = {"f32": 0, "bf16": 0}
    rows, failures = [], []
    for name, layer, kind, unmasked_launches in recurrent_stack_layers():
        params = layer.init_params(torch.Generator().manual_seed(3))
        shape = ((RS_N, RS_T, RS_IN) if kind == "rnn" else (RS_N, RS_T, 8, 8, 2))
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        if name == "mask_zero_lstm":
            x[0, 7] = 0.0
        for with_mask in (False, True):
            m = torch.from_numpy(mask) if with_mask else None
            y_shape = _stack_run(layer, params, x, m, torch.zeros(()), torch.float64)[0].shape
            w = torch.from_numpy(rng.standard_normal(tuple(y_shape)))
            exact, g_exact = _stack_run(layer, params, x, m, w, torch.float64)
            for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                cpu, g_cpu = _stack_run(layer, params, x, m, w, dtype)
                ck.reset_lstm_counts()
                card_p = {k: v.cuda() for k, v in params.items()}
                got, g_got = _stack_run(layer, card_p, x.cuda(),
                                        None if m is None else m.cuda(), w, dtype)
                torch.cuda.synchronize()
                launched = k1_counts(ck)
                totals = {k: totals[k] + launched[k] for k in totals}
                want_launch = {"f32": 0, "bf16": 0}
                if not with_mask:
                    want_launch[tag] = unmasked_launches
                row = {"layer": name, "dtype": tag, "mask": with_mask,
                       "k1_launches": launched, "k1_expected": want_launch}
                got, cpu = got.double().cpu(), cpu.double()
                if tag == "f32":
                    row["out_err"] = (got - cpu).abs().max().item()
                    row["out_limit"] = RS_TOL * max(1.0, cpu.abs().max().item())
                    row["grad_err_rel_to_max"] = max(
                        (g_got[k].double().cpu() - g_cpu[k].double()).abs().max().item()
                        / max(g_cpu[k].abs().max().item(), 1e-30) for k in g_cpu)
                    ok = (row["out_err"] <= row["out_limit"]
                          and row["grad_err_rel_to_max"] <= RS_TOL)
                else:
                    d_card = (got - exact).norm().item()
                    d_cpu = (cpu - exact).norm().item()
                    row["out_ratio"] = d_card / max(d_cpu, 1e-30)
                    parity = ratio_form({0: {k: g.cpu() for k, g in g_got.items()}},
                                        {0: g_cpu}, {0: g_exact}, 0.0, 0.0, 0.0,
                                        BF16_TENSOR_FLOOR)
                    row["grad_ratio_whole"] = parity["grad_l2_ratio_whole"]
                    row["grad_ratio_worst"] = parity["grad_l2_ratio_worst"]
                    ok = (row["out_ratio"] <= BF16_WHOLE_RATIO
                          or d_card <= BF16_TENSOR_FLOOR * exact.norm().item()) and parity["ok"]
                ok = ok and launched == want_launch
                row["ok"] = ok
                rows.append(row)
                print("recurrent_stack " + json.dumps(row), flush=True)
                if not ok:
                    failures.append((name, tag, with_mask))
    print("recurrent_stack_summary " + json.dumps({"card": card, "layers": len(rows) // 4,
                                                  "runs": len(rows), "k1_launches": totals}),
          flush=True)
    if failures:
        raise RuntimeError(f"recurrent_stack: {failures}")
    return totals


def char_corpus(n_examples, files=CORPUS):
    """``n_examples`` non-overlapping character sequences of CHAR_LEN + 1
    from the repository's own text, with every character outside CHARS
    dropped (as the example's CharacterIterator drops them), as indices
    into CHARS (a [n_examples, CHAR_LEN + 1] int64 array). ``files``: the
    text, relative to the repository's root."""
    root = os.path.dirname(os.path.abspath(__file__))
    text = "".join(open(os.path.join(root, f), encoding="utf-8").read()
                   for f in files)
    index = {c: i for i, c in enumerate(CHARS)}
    ids = np.fromiter((index[c] for c in text if c in index), dtype=np.int64)
    need = n_examples * (CHAR_LEN + 1)
    if ids.size < need:
        raise RuntimeError(f"corpus has {ids.size} characters, {need} needed")
    return ids[:need].reshape(n_examples, CHAR_LEN + 1)


def char_lstm_conf():
    """LSTMCharModellingExample's configuration, through ``list()``."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    v = len(CHARS)
    return (NeuralNetConfiguration.builder().seed(12345).l2(1e-4)
            .weight_init("xavier").updater(Adam(0.005)).list()
            .layer(LSTMLayer(n_in=v, n_out=CHAR_WIDTH, activation="tanh"))
            .layer(LSTMLayer(n_in=CHAR_WIDTH, n_out=CHAR_WIDTH, activation="tanh"))
            .layer(RnnOutputLayer(n_in=CHAR_WIDTH, n_out=v, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(InputType.recurrent(v))
            .backprop_type("TruncatedBPTT").t_bptt_length(CHAR_TBPTT).build())


def sample_from(probs, rng):
    """The example's sampleFromDistribution: the first index whose
    cumulative probability reaches a uniform draw."""
    return int(min(np.searchsorted(np.cumsum(probs, dtype=np.float64), rng.random()),
                   len(probs) - 1))


def char_lstm_phase(ck, card):
    """Train, serve and sample DL4J's character model (see the module
    docstring). Returns K1's launches by path and K2's in training."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)

    v = len(CHARS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ids = torch.from_numpy(char_corpus((CHAR_BATCHES + 1) * CHAR_BATCH)).cuda()
    onehot = F.one_hot(ids, v).float()  # [examples, CHAR_LEN + 1, 77]
    batches = [(onehot[i * CHAR_BATCH:(i + 1) * CHAR_BATCH, :-1],
                onehot[i * CHAR_BATCH:(i + 1) * CHAR_BATCH, 1:])
               for i in range(CHAR_BATCHES + 1)]
    net = MultiLayerNetwork(char_lstm_conf()).init()  # on cuda
    n_tensors = tensors_of(net)
    n_lstm = sum(1 for l in net.layers if type(l).__name__ == "LSTMLayer")
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    chunk_losses = []
    apply = net._apply_updates

    def record_and_apply(grads):  # each chunk's loss, a device scalar
        chunk_losses.append(net._score)
        apply(grads)

    net._apply_updates = record_and_apply
    chunks = CHAR_BATCHES * CHAR_LEN // CHAR_TBPTT
    by_plan = {}  # the LSTM kernel's launches on each path, by plan

    reset_counts = ck.reset_lstm_counts
    reset_counts()
    ck.fused_adam.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for x, y in batches[:CHAR_BATCHES]:
        net.fit(x, y)
    end.record()
    torch.cuda.synchronize()
    del net._apply_updates
    window_ms = start.elapsed_time(end)
    train = {"lstm_sequence": ck.lstm_sequence.launches,
             "fused_adam": ck.fused_adam.launches}
    by_plan["train"] = dict(ck.lstm_sequence.launches_by_plan)
    losses = [float(l) for l in chunk_losses]
    print("char-lstm chunk losses " + json.dumps(losses), flush=True)
    if train != {"lstm_sequence": n_lstm * chunks, "fused_adam": n_tensors * chunks}:
        raise RuntimeError(f"launches {train} in {chunks} chunks, expected "
                           f"{n_lstm} and {n_tensors} a chunk")
    if not (len(losses) == chunks and np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise RuntimeError(f"training did not progress: {losses}")
    peak_train_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_steps(net, *batches[0], fits=1,
                            steps_per_fit=CHAR_LEN // CHAR_TBPTT)

    # one chunk on a twin that takes the plain recurrence
    twin = load_reference_params(MultiLayerNetwork(char_lstm_conf()).init(),
                                 export_params(net))
    xc, yc = batches[0][0][:, :CHAR_TBPTT], batches[0][1][:, :CHAR_TBPTT]
    g_k, loss_k = net.compute_gradient_and_score(xc, yc)
    helpers.set_auto_fused_lstm(False)
    try:
        g_p, loss_p = twin.compute_gradient_and_score(xc, yc)
        x_out = batches[CHAR_BATCHES][0]
        ref_out = twin.output(x_out)
    finally:
        helpers.set_auto_fused_lstm(True)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst_name, worst = worst_gradient(g_k, g_p)
    if not (loss_rel <= CHAR_LOSS_RTOL and worst <= CHAR_GRAD_TOL):
        raise RuntimeError(f"char LSTM kernel path disagrees with the plain "
                           f"recurrence: loss {loss_k} vs {loss_p} (rel "
                           f"{loss_rel}), worst gradient {worst_name} at {worst}")
    del twin, g_k, g_p

    # serving: output over one unseen [32, 1000, 77] batch
    reset_counts()
    start.record()
    out = net.output(x_out)
    end.record()
    torch.cuda.synchronize()
    output_launches = ck.lstm_sequence.launches
    by_plan["output"] = dict(ck.lstm_sequence.launches_by_plan)
    output_ms = start.elapsed_time(end)
    if output_launches != n_lstm or out.shape != (CHAR_BATCH, CHAR_LEN, v):
        raise RuntimeError(f"output: {output_launches} launches, shape "
                           f"{tuple(out.shape)}")
    rowsum_dev = (out.double().sum(-1) - 1.0).abs().max().item()
    out_diff = (out - ref_out).abs().max().item()
    if not (rowsum_dev <= ROWSUM_TOL and out_diff <= CHAR_OUT_ATOL):
        raise RuntimeError(f"output: rows sum off by {rowsum_dev}, "
                           f"{out_diff} from the plain recurrence")
    del out, ref_out

    # sampling: prime with PRIME, then N_SAMPLES x SAMPLE_LEN characters
    rng = np.random.default_rng(12345)
    index = {c: i for i, c in enumerate(CHARS)}
    prime = F.one_hot(torch.tensor([index[c] for c in PRIME]), v).float()
    net.rnn_clear_previous_state()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = net.rnn_time_step(prime[None].repeat(N_SAMPLES, 1, 1).cuda())[:, -1]
    samples = [[] for _ in range(N_SAMPLES)]
    for _ in range(SAMPLE_LEN):
        p = probs.cpu().numpy().astype(np.float64)
        nxt = [sample_from(p[k], rng) for k in range(N_SAMPLES)]
        for k, c in enumerate(nxt):
            samples[k].append(CHARS[c])
        probs = net.rnn_time_step(F.one_hot(torch.tensor(nxt), v).float().cuda())
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    sample_launches = ck.lstm_sequence.launches
    by_plan["sample"] = dict(ck.lstm_sequence.launches_by_plan)
    if sample_launches != n_lstm * (1 + SAMPLE_LEN) or probs.shape != (N_SAMPLES, v):
        raise RuntimeError(f"sampling: {sample_launches} launches for "
                           f"{1 + SAMPLE_LEN} steps")
    # every main-path launch of the LSTM kernel took the cluster plan
    launched = {"train": train["lstm_sequence"], "output": output_launches,
                "sample": sample_launches}
    for path, counts in by_plan.items():
        if counts != {"cluster": launched[path], "grid": 0}:
            raise RuntimeError(f"{path}: LSTM kernel launches by plan {counts}, "
                               f"expected all {launched[path]} on the cluster plan")
    texts = ["".join(t) for t in samples]
    print("char-lstm sample 0: " + json.dumps(PRIME + texts[0][:80]), flush=True)
    stats = {
        "card": card, "params": net.conf.num_params(), "chunks": chunks,
        "batch": [CHAR_BATCH, CHAR_LEN], "tbptt": CHAR_TBPTT,
        "first_5_mean_loss": float(np.mean(losses[:5])),
        "last_5_mean_loss": float(np.mean(losses[-5:])),
        "window_ms": window_ms,
        "trained_chars_per_s": CHAR_BATCHES * CHAR_BATCH * CHAR_LEN / (window_ms / 1e3),
        "ms_per_chunk": window_ms / chunks,
        "launches": train, "launches_per_chunk": {k: n // chunks for k, n in train.items()},
        "peak_device_mem_gb_train": peak_train_gb,
        "parity_loss_kernel": loss_k, "parity_loss_plain": loss_p,
        "parity_loss_rel": loss_rel, "parity_worst_grad": worst_name,
        "parity_worst_grad_rel_to_max": worst,
        "output_ms": output_ms, "output_chars_per_s": CHAR_BATCH * CHAR_LEN / (output_ms / 1e3),
        "output_launches": output_launches, "output_rowsum_dev": rowsum_dev,
        "output_max_abs_diff_vs_plain": out_diff,
        "sample_s": sample_s, "sampled_chars_per_s": N_SAMPLES * SAMPLE_LEN / sample_s,
        "sample_launches": sample_launches, "lstm_launches_by_plan": by_plan,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_per_chunk": profile,
    }
    print("char-lstm " + json.dumps(stats), flush=True)
    helpers.clear_helper("updater")
    del net, batches, onehot
    return launched, by_plan, train["fused_adam"]


def lenet_conf(regularized=False, flat_input=False):
    """``__graft_entry__._lenet``'s LeNet, through the port's DSL: conv 5x5
    20, max pool 2x2, conv 5x5 50, max pool 2x2, dense 500, output 10;
    Adam(1e-3), seed 42, f32, 28x28x1. ``regularized``: dropout 0.5 on the
    dense layer's input and per-layer L2 gradient renormalization.
    ``flat_input``: rows of 784 pixels (``InputType.convolutional_flat``)."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer,
                                                    OutputLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    b = NeuralNetConfiguration.builder().seed(42).updater(Adam(1e-3))
    if regularized:
        b = b.gradient_normalization("renormalize_l2_per_layer")
    lb = b.list()
    if flat_input:  # the list builder adds no ff_to_cnn for a flat input
        lb = lb.input_pre_processor(0, "ff_to_cnn:28,28,1")
    return (lb
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                    padding=(0, 0), activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                    pooling_type="max"))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                    padding=(0, 0), activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                    pooling_type="max"))
            .layer(DenseLayer(n_out=500, activation="relu",
                              dropout=0.5 if regularized else None))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1) if flat_input
                            else InputType.convolutional(28, 28, 1)).build())


def lenet_data():
    """The verify skill's data: seeded Gaussian images with row 2 + class
    raised by 2, and one-hot labels."""
    rng = np.random.default_rng(0)
    y_idx = rng.integers(0, 10, LENET_N)
    x = rng.normal(0, 0.3, size=(LENET_N, 28, 28, 1)).astype(np.float32)
    x[np.arange(LENET_N), 2 + y_idx, :, 0] += 2.0
    return x, np.eye(10, dtype=np.float32)[y_idx]


def lenet_phase(ck, card):
    """LeNet through ``MultiLayerNetwork`` on the card: 5 epochs of
    ``fit(ListDataSetIterator)`` with the fused updater, ``evaluate``, a
    timed window of fit steps, 2 profiled steps, ``output`` at batch 256,
    a twin on stock Adam, and the model zip reloaded on the card and on
    the CPU. Returns K2's launches on its fit path."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import (
        export_params, export_updater_state, load_reference_params,
        load_reference_updater_state)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, y = lenet_data()
    data = DataSet(x, y)
    steps_per_epoch = LENET_N // LENET_BATCH
    net = MultiLayerNetwork(lenet_conf()).init()  # on cuda
    n_tensors = tensors_of(net)
    if n_tensors != LENET_TENSORS:
        raise RuntimeError(f"LeNet has {n_tensors} parameter tensors")
    helpers.set_helper("updater", ck.FusedUpdaterHelper())

    # 5 epochs through the entry point, counted
    ck.fused_adam.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    net.fit(ListDataSetIterator(data, LENET_BATCH, shuffle=True), epochs=LENET_EPOCHS)
    end.record()
    torch.cuda.synchronize()
    fit_launches = ck.fused_adam.launches
    fit_steps = LENET_EPOCHS * steps_per_epoch
    if fit_launches != LENET_TENSORS * fit_steps or net.iteration != fit_steps:
        raise RuntimeError(f"LeNet fit: {fit_launches} fused_adam launches in "
                           f"{net.iteration} steps, expected {LENET_TENSORS} a step")
    epochs_ms = start.elapsed_time(end)
    ev = net.evaluate(ListDataSetIterator(data, LENET_OUT_BATCH))
    accuracy = ev.accuracy()
    if not accuracy >= LENET_MIN_ACCURACY:
        raise RuntimeError(f"LeNet evaluate: accuracy {accuracy} after "
                           f"{LENET_EPOCHS} epochs\n{ev.stats()}")

    # the timed window: fit steps of batch 128 from the iterator, each
    # between CUDA events, after the warm-up steps
    it = ListDataSetIterator(data, LENET_BATCH, shuffle=True, seed=1)
    batches = []
    while len(batches) < LENET_WARMUP + LENET_TIMED:
        it.reset()
        batches += list(it)
    ck.fused_adam.launches = 0
    events = []
    for i, ds in enumerate(batches[:LENET_WARMUP + LENET_TIMED]):
        if i == LENET_WARMUP:
            torch.cuda.synchronize()
        s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s_.record()
        net.fit(ds)
        e_.record()
        if i >= LENET_WARMUP:
            events.append((s_, e_))
    torch.cuda.synchronize()
    window_launches = ck.fused_adam.launches
    steps = LENET_WARMUP + LENET_TIMED
    if window_launches != LENET_TENSORS * steps:
        raise RuntimeError(f"LeNet window: {window_launches} fused_adam launches "
                           f"in {steps} steps")
    step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    window_ms = events[0][0].elapsed_time(events[-1][1])
    xb = torch.from_numpy(x[:LENET_BATCH]).cuda()
    yb = torch.from_numpy(y[:LENET_BATCH]).cuda()
    profile = profile_steps(net, xb, yb)

    # output at batch 256 from host images, as a caller hands them over
    x_out = x[:LENET_OUT_BATCH]
    out_ms = median_ms(lambda: net.output(x_out), runs=25, warmup=3)
    out = net.output(x_out)
    rowsum_dev = (out.double().sum(-1) - 1.0).abs().max().item()
    if not (out.shape == (LENET_OUT_BATCH, 10) and rowsum_dev <= ROWSUM_TOL):
        raise RuntimeError(f"LeNet output: shape {tuple(out.shape)}, rows sum "
                           f"off by {rowsum_dev}")

    # twin on stock Adam from the same weights and Adam state
    twin = load_reference_updater_state(
        load_reference_params(MultiLayerNetwork(lenet_conf()).init(),
                              export_params(net)), export_updater_state(net))
    twin.iteration, twin.epoch = net.iteration, net.epoch
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(LENET_TWIN_STEPS):
            net.fit(xb, yb)
        helpers.clear_helper("updater")
        for _ in range(LENET_TWIN_STEPS):
            twin.fit(xb, yb)
    finally:
        torch.backends.cudnn.deterministic = False
        helpers.clear_helper("updater")
    loss_rel = abs(net.score_ - twin.score_) / abs(twin.score_)
    worst_name, worst = "", 0.0
    for i, named in twin.params.items():
        for n, t in named.items():
            rel = ((net.params[i][n] - t).abs().max() / t.abs().max()).item()
            if rel >= worst:
                worst_name, worst = f"{i}/{n}", rel
    if not (loss_rel <= LENET_LOSS_RTOL and worst <= LENET_PARAM_TOL):
        raise RuntimeError(f"LeNet fused updater disagrees with stock Adam: loss "
                           f"rel {loss_rel}, worst parameter {worst_name} {worst}")
    del twin

    # the model zip: saved on the card, loaded on the card and on the CPU
    ref = net.output(x_out)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lenet.zip")
        net.save(path)
        zip_bytes = os.path.getsize(path)
        on_card = MultiLayerNetwork.load(path)
        on_cpu = MultiLayerNetwork.load(path, device="cpu")
    zip_err = {"card": (on_card.output(x_out) - ref).abs().max().item(),
               "cpu": (on_cpu.output(x_out) - ref.cpu()).abs().max().item()}
    if not (on_card.params[0]["W"].is_cuda and not on_cpu.params[0]["W"].is_cuda
            and on_card.iteration == net.iteration
            and max(zip_err.values()) <= LENET_ZIP_ATOL):
        raise RuntimeError(f"LeNet zip round trip: {zip_err}")

    stats = {
        "card": card, "params": net.conf.num_params(), "images": LENET_N,
        "batch": LENET_BATCH, "epochs": LENET_EPOCHS,
        "fit_5_epochs_ms": epochs_ms,
        "fit_5_epochs_images_per_s": LENET_EPOCHS * LENET_N / (epochs_ms / 1e3),
        "evaluate_accuracy": accuracy, "evaluate_f1": ev.f1(),
        "fused_adam_launches": {"fit": fit_launches, "window": window_launches},
        "fused_adam_launches_per_step": fit_launches // fit_steps,
        "window_steps": LENET_TIMED, "window_ms": window_ms,
        "train_images_per_s": LENET_TIMED * LENET_BATCH / (window_ms / 1e3),
        "median_step_ms": float(np.median(step_ms)),
        "train_images_per_s_at_median_step":
            LENET_BATCH / (float(np.median(step_ms)) / 1e3),
        "mean_step_ms": float(np.mean(step_ms)),
        "step_ms_p10_p90": [float(np.percentile(step_ms, 10)),
                            float(np.percentile(step_ms, 90))],
        # the slowest steps of the window, [index, ms]: where its mean
        # leaves its median
        "slowest_steps_ms": [[int(i), step_ms[i]]
                             for i in np.argsort(step_ms)[::-1][:5]],
        "device_busy_share_of_median_step":
            profile["device_ms_per_step"] / float(np.median(step_ms)),
        "output_batch": LENET_OUT_BATCH, "output_ms": out_ms,
        "output_images_per_s": LENET_OUT_BATCH / (out_ms / 1e3),
        "output_rowsum_dev": rowsum_dev,
        "twin_loss_rel": loss_rel, "twin_worst_param": worst_name,
        "twin_worst_param_rel_to_max": worst,
        "zip_bytes": zip_bytes, "zip_reload_max_abs_diff": zip_err,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_per_step": profile,
    }
    print("lenet " + json.dumps(stats), flush=True)
    del net, on_card, on_cpu
    return fit_launches + window_launches


def keep_stats(keep, p):
    """The keep fraction of a boolean mask and its distance from ``p`` in
    standard errors; raises beyond KEEP_SIGMAS."""
    n = keep.numel()
    frac = keep.float().mean().item()
    sigmas = (frac - p) / math.sqrt(p * (1.0 - p) / n)
    if not abs(sigmas) <= KEEP_SIGMAS:
        raise RuntimeError(f"keep fraction {frac} over {n} draws is "
                           f"{sigmas:.2f} standard errors from p = {p}")
    return {"p": p, "keep_fraction": frac, "sigmas": sigmas, "draws": n}


def moments(t):
    t = t.double()
    return t.mean().item(), t.var().item()


def draws_phase(card):
    """Every dropout and weight-noise variant draws on the card from a
    CUDA generator; keep fractions, scaling, moments and determinism."""
    from deeplearning4j_tpu_torch.nn.dropout import (AlphaDropout, Dropout,
                                                     GaussianDropout,
                                                     GaussianNoise,
                                                     SpatialDropout)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer
    from deeplearning4j_tpu_torch.nn.train_step import dropout_generator
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect, WeightNoise
    from deeplearning4j_tpu_torch.nn.weights import Distribution

    gen = dropout_generator(7, "cuda")
    src = torch.Generator(device="cuda").manual_seed(8)
    # positive inputs: an output of 0 means dropped
    pos = torch.rand(DRAW_SHAPE, device="cuda", generator=src) + 0.5
    out = {}

    y = Dropout(0.9).apply(pos, gen, True)
    keep = y != 0
    out["Dropout"] = keep_stats(keep, 0.9)
    out["Dropout"]["scaling_exact"] = torch.equal(y[keep], pos[keep] / 0.9)

    xs = torch.rand(SPATIAL_SHAPE, device="cuda", generator=src) + 0.5
    ys = SpatialDropout(0.8).apply(xs, gen, True)
    ks = ys != 0
    out["SpatialDropout"] = keep_stats(ks[:, 0, 0, :], 0.8)
    out["SpatialDropout"].update(
        constant_over_hw=torch.equal(ks.all(dim=2).all(dim=1), ks.any(dim=2).any(dim=1)),
        scaling_exact=torch.equal(ys[ks], xs[ks] / 0.8))

    z = torch.randn(DRAW_SHAPE, device="cuda", generator=src)
    ad = AlphaDropout(0.9)
    ya = ad.apply(z, gen, True)
    f32 = np.float32
    ap = ad.alpha_prime
    a = f32(1.0) / np.sqrt(f32(0.9 + ap * ap * 0.9 * 0.1))
    b = -a * f32(0.1) * f32(ap)
    out["AlphaDropout"] = keep_stats(ya == float(a) * z + float(b), 0.9)
    mean, var = moments(ya)
    out["AlphaDropout"].update(mean=mean, var=var)
    if not (abs(mean) <= ALPHA_TOL and abs(var - 1.0) <= ALPHA_TOL):
        raise RuntimeError(f"AlphaDropout on N(0,1): mean {mean}, var {var}")

    ones = torch.ones(DRAW_SHAPE, device="cuda")
    mean, var = moments(GaussianDropout(0.3).apply(ones, gen, True))
    want = 0.3 / 0.7
    out["GaussianDropout"] = {"mean": mean, "var": var, "var_expected": want}
    if not (abs(mean - 1.0) <= NOISE_RTOL and abs(var / want - 1.0) <= NOISE_RTOL):
        raise RuntimeError(f"GaussianDropout(0.3) noise: {out['GaussianDropout']}")

    zeros = torch.zeros(DRAW_SHAPE, device="cuda")
    mean, var = moments(GaussianNoise(0.1).apply(zeros, gen, True))
    out["GaussianNoise"] = {"mean": mean, "std": math.sqrt(var)}
    if not (abs(mean) <= NOISE_RTOL * 0.1 and abs(math.sqrt(var) / 0.1 - 1.0) <= NOISE_RTOL):
        raise RuntimeError(f"GaussianNoise(0.1) noise: {out['GaussianNoise']}")

    layer = DenseLayer(n_in=DRAW_SHAPE[0], n_out=DRAW_SHAPE[1])
    params = {"W": pos, "b": torch.zeros(DRAW_SHAPE[1], device="cuda")}
    dc = DropConnect(p=0.95).apply(layer, params, gen, True)
    kw = dc["W"] != 0
    out["DropConnect"] = keep_stats(kw, 0.95)
    out["DropConnect"].update(kept_unscaled=torch.equal(dc["W"][kw], pos[kw]),
                              bias_untouched=dc["b"] is params["b"])
    for name, wn, noise_of, want_mean, want_std in (
            ("WeightNoise additive", WeightNoise(),
             lambda w: w - pos, 0.0, 0.01),
            ("WeightNoise multiplicative",
             WeightNoise(distribution=Distribution(kind="normal", mean=1.0, std=0.1),
                         additive=False),
             lambda w: w / pos, 1.0, 0.1)):
        mean, var = moments(noise_of(wn.apply(layer, params, gen, True)["W"]))
        out[name] = {"mean": mean, "std": math.sqrt(var)}
        if not (abs(mean - want_mean) <= NOISE_RTOL * max(want_mean, want_std)
                and abs(math.sqrt(var) / want_std - 1.0) <= NOISE_RTOL):
            raise RuntimeError(f"{name}: {out[name]}")
    for name in ("Dropout", "SpatialDropout"):
        for k in ("scaling_exact", "constant_over_hw"):
            if out[name].get(k) is False:
                raise RuntimeError(f"{name}: {k} fails")
    if not (out["DropConnect"]["kept_unscaled"] and out["DropConnect"]["bias_untouched"]):
        raise RuntimeError(f"DropConnect: {out['DropConnect']}")

    # determinism: the same seed draws the same masks and noise, another
    # seed others
    def draw(seed):
        g = dropout_generator(seed, "cuda")
        return (Dropout(0.9).apply(pos, g, True) != 0,
                GaussianNoise(0.1).apply(zeros, g, True))
    (m1, n1), (m2, n2), (m3, n3) = draw(11), draw(11), draw(12)
    out["same_seed_identical"] = torch.equal(m1, m2) and torch.equal(n1, n2)
    out["other_seed_differs"] = not torch.equal(m1, m3) and not torch.equal(n1, n3)
    if not (out["same_seed_identical"] and out["other_seed_differs"]):
        raise RuntimeError(f"draws under a seed: {out}")
    # a CPU generator never draws for a CUDA tensor
    try:
        Dropout(0.9).apply(pos, torch.Generator(), True)
    except ValueError:
        out["cpu_generator_refused"] = True
    else:
        raise RuntimeError("a CPU generator drew for a CUDA tensor")
    out["dropout_ms"] = median_ms(lambda: Dropout(0.9).apply(pos, gen, True))
    out.update(card=card, shape=list(DRAW_SHAPE), spatial_shape=list(SPATIAL_SHAPE))
    print("regularizers " + json.dumps(out), flush=True)
    del pos, xs, z, ones, zeros, params


def ex17_conf():
    """Example 17's regularization family through the port's DSL: Dense 32
    selu with AlphaDropout(0.9), MaxNorm(2.0) on every layer's weights,
    NonNegative on the biases, DropConnect(0.95), Adam(5e-3), seed 1."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.constraints import (MaxNormConstraint,
                                                         NonNegativeConstraint)
    from deeplearning4j_tpu_torch.nn.dropout import AlphaDropout
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect

    return (NeuralNetConfiguration.builder().seed(1).updater(Adam(5e-3))
            .constrain_weights(MaxNormConstraint(max_norm=EX17_MAX_NORM))
            .constrain_bias(NonNegativeConstraint())
            .weight_noise(DropConnect(p=0.95))
            .list()
            .layer(DenseLayer(n_out=32, activation="selu",
                              dropout=AlphaDropout(p=0.9)))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(10)).build())


def ex17_phase(ck, card):
    """Example 17's regularization family on the card at its own settings
    (512 seeded examples, 15 epochs of batch 128) with the fused updater;
    the constraints must hold after the last step and the accuracy lie
    within EX17_ACCURACY_TOL of the JAX package's. Returns K2's launches."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.default_rng(0)
    cls = rng.integers(0, 3, EX17_N)
    x = rng.normal(0, 0.3, size=(EX17_N, 10)).astype(np.float32)
    x[np.arange(EX17_N), cls] += 2.0
    y = np.eye(3, dtype=np.float32)[cls]
    net = MultiLayerNetwork(ex17_conf()).init()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    ck.fused_adam.launches = 0
    try:
        net.fit(ListDataSetIterator(DataSet(x, y), EX17_BATCH, shuffle=True),
                epochs=EX17_EPOCHS)
        torch.cuda.synchronize()
    finally:
        helpers.clear_helper("updater")
    launches = ck.fused_adam.launches
    steps = EX17_EPOCHS * EX17_N // EX17_BATCH
    if launches != EX17_TENSORS * steps or net.iteration != steps:
        raise RuntimeError(f"example 17: {launches} fused_adam launches in "
                           f"{net.iteration} steps")
    col_norm = max(torch.sqrt((net.params[i]["W"] ** 2).sum(0)).max().item()
                   for i in net.params)
    min_bias = min(net.params[i]["b"].min().item() for i in net.params)
    accuracy = net.evaluate(ListDataSetIterator(DataSet(x, y), 256)).accuracy()
    stats = {"card": card, "steps": steps, "fused_adam_launches": launches,
             "max_column_norm": col_norm, "min_bias": min_bias,
             "accuracy": accuracy, "jax_cpu_accuracy": EX17_JAX_ACCURACY}
    print("ex17 " + json.dumps(stats), flush=True)
    if not (col_norm <= EX17_MAX_NORM + 1e-5 and min_bias >= 0.0
            and abs(accuracy - EX17_JAX_ACCURACY) <= EX17_ACCURACY_TOL):
        raise RuntimeError(f"example 17's family: {stats}")
    return launches


def profile_device_ms(run, steps):
    """Device ms a step of ``run()`` (``steps`` steps) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(device_ms_by_kernel(prof).values()) / steps


def lenet_regularized_phase(ck, card):
    """LeNet with dropout 0.5 on the dense input and per-layer L2 gradient
    renormalization, fed through ``NormalizerStandardize`` (fitted on the
    verify skill's data): one net with the default prefetch, a twin from
    the same seed with ``prefetch_depth=0``, 5 epochs each (8 K2 launches
    a step), ``evaluate`` >= 0.95 each; then the producer's host cost a
    batch, and timed epochs of four ways on the first net. Returns K2's
    launches on the two 5-epoch fits."""
    from deeplearning4j_tpu_torch.datasets import (DataSet, ListDataSetIterator,
                                                   NormalizerStandardize,
                                                   NormalizingIterator)
    from deeplearning4j_tpu_torch.datasets import iterators
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    torch.cuda.empty_cache()
    x, y = lenet_data()
    norm = NormalizerStandardize().fit(DataSet(x, y))
    steps_per_epoch = LENET_N // LENET_BATCH

    def batches(seed):
        return NormalizingIterator(
            ListDataSetIterator(DataSet(x, y), LENET_BATCH, shuffle=True, seed=seed), norm)

    ways = {"prefetch": None, "prefetch_depth_0": 0}
    nets, stats = {}, {"card": card, "normalizer": {"mean": norm.mean.tolist(),
                                                    "std": norm.std.tolist()}}
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    launches = 0
    try:
        for way, depth in ways.items():
            net = MultiLayerNetwork(lenet_conf(regularized=True)).init()
            ck.fused_adam.launches = 0
            iterators.COPY_STATS.update(batches=0, pinned=0, side_stream=0)
            net.fit(batches(0), epochs=LENET_EPOCHS, prefetch_depth=depth)
            torch.cuda.synchronize()
            fit_steps = LENET_EPOCHS * steps_per_epoch
            copies = dict(iterators.COPY_STATS)
            want_copies = fit_steps if depth is None else 0
            if (ck.fused_adam.launches != LENET_TENSORS * fit_steps
                    or net.iteration != fit_steps
                    or copies != {"batches": want_copies, "pinned": want_copies,
                                  "side_stream": want_copies}):
                raise RuntimeError(f"regularized LeNet ({way}): "
                                   f"{ck.fused_adam.launches} fused_adam launches "
                                   f"in {net.iteration} steps; copies {copies}")
            launches += ck.fused_adam.launches
            ev = net.evaluate(NormalizingIterator(
                ListDataSetIterator(DataSet(x, y), LENET_OUT_BATCH), norm))
            stats[way] = {"evaluate_accuracy": ev.accuracy(), "copies": copies,
                          "fused_adam_launches_per_step":
                              ck.fused_adam.launches // fit_steps}
            if not ev.accuracy() >= LENET_MIN_ACCURACY:
                raise RuntimeError(f"regularized LeNet ({way}): accuracy "
                                   f"{ev.accuracy()}\n{ev.stats()}")
            nets[way] = net
        # the same seeds, batches and draws both ways
        stats["params_max_abs_diff_between_ways"] = max(
            (nets["prefetch"].params[i][n] - t).abs().max().item()
            for i, named in nets["prefetch_depth_0"].params.items()
            for n, t in named.items())

        # the producer's host work a batch, alone on this thread: the
        # gather and the normalizer, then the pin and the copy's launch
        # (the second pass, on pinned blocks the allocator has cached)
        t0 = time.perf_counter()
        prepared = list(batches(7))
        t1 = time.perf_counter()
        for _ in range(2):
            t2 = time.perf_counter()
            moved = [iterators.device_put_batch(ds, "cuda") for ds in prepared]
            t3 = time.perf_counter()
            for ds in moved:
                iterators.finish_device_put(ds)
            torch.cuda.synchronize()
            del moved
        stats["producer_host_ms_per_batch"] = {
            "gather_and_normalize": (t1 - t0) * 1e3 / len(prepared),
            "pin_and_copy": (t3 - t2) * 1e3 / len(prepared)}

        # timed epochs on one net, the ways in turn, round after round:
        # both ways from the iterator, and both from batches made (gathered
        # and normalized) before the window, which leaves the producer
        # only the pin and the copy; each step start is an event, and each
        # epoch is bracketed by two
        net = nets["prefetch"]
        timed_ways = {
            "prefetch": (None, batches), "prefetch_depth_0": (0, batches),
            "made_before_prefetch": (
                None, lambda seed: iterators.ExistingDataSetIterator(prepared)),
            "made_before_prefetch_depth_0": (
                0, lambda seed: iterators.ExistingDataSetIterator(prepared))}
        starts = {w: [] for w in timed_ways}
        epochs_ms = {w: [] for w in timed_ways}
        fit_batch = net._fit_batch

        def timed_fit_batch(ds):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            current.append(e)
            fit_batch(ds)

        net._fit_batch = timed_fit_batch
        iterators.COPY_STATS.update(batches=0, pinned=0, side_stream=0)
        rounds = LENET_REG_WINDOW_EPOCHS // 2 + 1
        for rnd in range(rounds):
            for way, (depth, source) in timed_ways.items():
                current = []
                s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s_.record()
                net.fit(source(100 + rnd), epochs=1, prefetch_depth=depth)
                e_.record()
                if rnd > 0:  # the first round warms up
                    starts[way].append(current)
                    epochs_ms[way].append((s_, e_))
        torch.cuda.synchronize()
        del net._fit_batch
        copies = dict(iterators.COPY_STATS)
        want = 2 * rounds * steps_per_epoch  # the two prefetching ways
        if copies != {"batches": want, "pinned": want, "side_stream": want}:
            raise RuntimeError(f"prefetched batches of the timed epochs: {copies}")
        for way, (depth, source) in timed_ways.items():
            step_ms = [a.elapsed_time(b) for ep in starts[way]
                       for a, b in zip(ep[:-1], ep[1:])]
            ep_ms = [a.elapsed_time(b) for a, b in epochs_ms[way]]
            median = float(np.median(step_ms))
            busy_ms = profile_device_ms(
                lambda: net.fit(source(999), epochs=1, prefetch_depth=depth),
                steps_per_epoch)
            stats.setdefault(way, {}).update({
                "timed_epochs": len(ep_ms), "steps": len(step_ms),
                "median_step_ms": median,
                "step_ms_p10_p90": [float(np.percentile(step_ms, 10)),
                                    float(np.percentile(step_ms, 90))],
                "mean_step_ms": float(np.mean(step_ms)),
                "window_images_per_s": len(ep_ms) * LENET_N / (sum(ep_ms) / 1e3),
                "epoch_ms": ep_ms,
                "device_ms_per_step": busy_ms,
                "device_busy_share_of_median_step": busy_ms / median,
            })
        stats["timed_copies"] = copies
    finally:
        helpers.clear_helper("updater")
    print("lenet_regularized " + json.dumps(stats), flush=True)
    del nets
    return launches


def gpt2_attn_dropout_phase(ck, card):
    """GPT-2-small with attention dropout: TRAIN_STEPS fit steps through a
    prefetching iterator with the fused updater (150 K2, no flash launch a
    step), one ``output`` (12 K3a), a step repeated from the dropout
    generator's saved state, 2 profiled steps. Returns the launches."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets import iterators
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = TransformerLM(attn_dropout=GPT2_DROPOUT).init()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    n_tensors = tensors_of(net)
    rng = np.random.default_rng(123)
    ids = rng.integers(0, vocab, (TRAIN_N, T))
    x_host = ids.astype(np.float32)  # token ids from the host, as floats
    ids_dev = torch.from_numpy(ids).cuda()
    labels = F.one_hot(torch.cat([ids_dev[:, 1:], ids_dev[:, -1:]], 1), vocab).float()
    batches = iterators.ExistingDataSetIterator(
        [DataSet(x_host, labels) for _ in range(TRAIN_STEPS)])
    counters = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv, ck.fused_adam)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        events, losses = [], []
        fit_batch = net._fit_batch

        def timed_fit_batch(ds):
            s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s_.record()
            fit_batch(ds)
            e_.record()
            events.append((s_, e_))
            losses.append(net._score)

        net._fit_batch = timed_fit_batch
        for c in counters:
            c.launches = 0
        iterators.COPY_STATS.update(batches=0, pinned=0, side_stream=0)
        net.fit(batches)  # the default prefetch
        torch.cuda.synchronize()
        del net._fit_batch
        launches = {c.__name__: c.launches for c in counters}
        copies = dict(iterators.COPY_STATS)
        losses = [float(l) for l in losses]
        step_ms = [a.elapsed_time(b) for a, b in events]
        warm_window_ms = events[1][0].elapsed_time(events[-1][1])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0, "fused_adam": n_tensors * TRAIN_STEPS}
        if launches != want:
            raise RuntimeError(f"attention-dropout fit launches {launches}, "
                               f"expected {want}")
        if copies != {"batches": TRAIN_STEPS, "pinned": TRAIN_STEPS,
                      "side_stream": TRAIN_STEPS}:
            raise RuntimeError(f"prefetched batches: {copies}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"attention-dropout training did not progress: "
                               f"losses {losses}")

        # one output: the seam takes the flash forward again (no dropout)
        for c in counters:
            c.launches = 0
        out = net.output(x_host)
        torch.cuda.synchronize()
        output_launches = ck.flash_attention_fwd.launches
        rowsum_dev = (out[:, ::64].double().sum(-1) - 1.0).abs().max().item()
        if not (output_launches == n_layers and ck.flash_attention_bwd_dq.launches == 0
                and out.shape == (TRAIN_N, T, vocab) and rowsum_dev <= ROWSUM_TOL):
            raise RuntimeError(f"output: {output_launches} flash launches, shape "
                               f"{tuple(out.shape)}, rows off by {rowsum_dev}")
        del out

        # a step repeated from the saved generator state gives the same
        # loss; a step from the state after it draws other masks
        with torch.no_grad():
            saved_p = {k: {n: t.clone() for n, t in d.items()} for k, d in net.params.items()}
            saved_s = {k: {n: {s: t.clone() for s, t in st.items()} for n, st in d.items()}
                       for k, d in net.updater_states.items()}
        gen_state, it = net.dropout_generator.get_state(), net.iteration

        def restore():
            with torch.no_grad():
                for k, d in saved_p.items():
                    for n, t in d.items():
                        net.params[k][n].copy_(t)
                for k, d in saved_s.items():
                    for n, st in d.items():
                        for s_name, t in st.items():
                            net.updater_states[k][n][s_name].copy_(t)
            net.iteration = it

        xb = torch.from_numpy(x_host).cuda()
        net.fit(xb, labels)
        loss_a = net.score_
        restore()
        net.dropout_generator.set_state(gen_state)
        net.fit(xb, labels)
        loss_b = net.score_
        restore()
        net.fit(xb, labels)  # the generator has moved on
        loss_c = net.score_
        del saved_p, saved_s
        repeat_rel = abs(loss_a - loss_b) / abs(loss_a)
        if not (repeat_rel <= GPT2_REPEAT_RTOL and loss_c != loss_a):
            raise RuntimeError(f"repeated step: losses {loss_a}, {loss_b} (rel "
                               f"{repeat_rel}); from the next state {loss_c}")
        profile = profile_steps(net, xb, labels)
    finally:
        helpers.clear_helper("updater")
    stats = {
        "card": card, "batch": [TRAIN_N, T], "attn_dropout": GPT2_DROPOUT,
        "steps": TRAIN_STEPS, "losses": losses, "step_ms": step_ms,
        "median_step_ms": float(np.median(step_ms)),
        "tokens_per_s_after_first_step":
            (TRAIN_STEPS - 1) * TRAIN_N * T / (warm_window_ms / 1e3),
        "launches": launches, "launches_per_step": {
            k: v // TRAIN_STEPS for k, v in launches.items()},
        "prefetched_copies": copies,
        "output_flash_fwd_launches": output_launches,
        "repeat_losses": [loss_a, loss_b], "repeat_rel": repeat_rel,
        "next_state_loss": loss_c, "peak_device_mem_gb": peak_gb,
        "profile": profile,
    }
    print("gpt2_attn_dropout " + json.dumps(stats), flush=True)
    del net, labels, xb
    return {"train": launches, "fused_adam": launches["fused_adam"],
            "output_fwd": output_launches}


def gpt2_block_and_head_bytes(net):
    """The f32 bytes a decode step reads of the weights: every parameter
    but the embedding table and the positions (a step gathers one row of
    each)."""
    return 4.0 * sum(t.numel() for v, named in net.params.items()
                     if v not in ("embed", "pos") for t in named.values())


def kv_cache_bytes(net, batch):
    """The f32 bytes of every attention layer's full-capacity K and V
    caches at ``batch`` rows."""
    total = 0
    for vd in net.conf.layer_vertices():
        layer = vd.obj
        if hasattr(layer, "max_cache"):
            total += 2 * batch * layer.n_heads * layer.max_cache * layer._dh()
    return 4.0 * total


def profile_call(fn):
    """``(wall_ms, device ms by kernel group, kernel launches)`` of one
    call of ``fn`` under torch.profiler (the host clock around a
    synchronised call)."""
    prof, wall, per_kernel = profiled(fn)
    launches = sum(e.count for e in prof.key_averages()
                   if "cuda" in str(getattr(e, "device_type", "")).lower())
    groups = {}
    for name, ms in per_kernel.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    return wall, groups, launches


class StepEvents:
    """Records a CUDA event as each decode step of ``models._step`` (the
    on-device paths) or each ``rnn_time_step`` call of ``net`` (the host
    loop) starts; ``ms()`` is the median interval between consecutive
    starts, one token's period."""

    def __init__(self, models, net, host_loop):
        self.events, self.host_loop = [], host_loop
        self.target = (net, "rnn_time_step") if host_loop else (models, "_step")
        self.orig = getattr(*self.target)

    def __enter__(self):
        def recorded(*a, **kw):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)
            return self.orig(*a, **kw)
        setattr(*self.target, recorded)
        return self

    def __exit__(self, *exc):
        if self.host_loop:
            delattr(*self.target)  # the instance attribute hid the method
        else:
            setattr(*self.target, self.orig)

    def ms(self):
        torch.cuda.synchronize()
        gaps = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        return float(np.median(gaps))


def decode_phase(ck, card, peaks):
    """GPT-2-small decoding: the KV-cache steps against ``output``, then
    ``generate``, ``generate_on_device`` (greedy and sampled, the loop
    checked for synchronisation) and ``beam_search``, each timed and
    profiled beside the bytes bound of its step. Returns the launches."""
    from deeplearning4j_tpu_torch.zoo import models
    from deeplearning4j_tpu_torch.zoo.models import (TransformerLM, beam_search,
                                                     generate, generate_on_device)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = TransformerLM().init()  # GPT-2-small, f32, seed 123, on cuda
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    rng = np.random.default_rng(123)
    ids = rng.integers(0, vocab, (DECODE_N, DECODE_PREFILL + DECODE_STEPS))
    x = ids.astype(np.float32)
    counters = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv)

    # the KV-cache path against the whole sequence
    for c in counters:
        c.launches = 0
    net.rnn_clear_previous_state()
    probs = [net.rnn_time_step(x[:, :DECODE_PREFILL, None])]
    for j in range(DECODE_PREFILL, x.shape[1]):
        probs.append(net.rnn_time_step(x[:, j:j + 1]))
    torch.cuda.synchronize()
    decode_launches = {c.__name__: c.launches for c in counters}
    full = net.output(x)
    torch.cuda.synchronize()
    output_launches = ck.flash_attention_fwd.launches - decode_launches["flash_attention_fwd"]
    err = max((probs[0] - full[:, :DECODE_PREFILL]).abs().max().item(),
              max((p - full[:, DECODE_PREFILL + i]).abs().max().item()
                  for i, p in enumerate(probs[1:])))
    del probs, full
    if any(decode_launches.values()) or output_launches != n_layers:
        raise RuntimeError(f"decode launched {decode_launches} (expected none); "
                           f"output {output_launches} flash launches, expected "
                           f"{n_layers}")
    if not err <= DECODE_ATOL:
        raise RuntimeError(f"decode disagrees with output: max |a-b| {err}")

    prompts = x[:, :GEN_PROMPT]
    weights_b = gpt2_block_and_head_bytes(net)

    def run(fn, rows, new_tokens, host_loop=False, beams=1, cache_passes=1):
        """fn() once after a short warm-up call, timed (CUDA events at each
        step's start, host wall), then profiled at GEN_PROFILED tokens and
        at 1 (prefill only). ``rows`` sequences come back, each decoded as
        ``beams`` hypotheses (the step's batch is rows x beams)."""
        fn(2)
        torch.cuda.synchronize()
        with StepEvents(models, net, host_loop) as ev:
            t0 = time.perf_counter()
            out = fn(new_tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        wall_1, groups_1, k_1 = profile_call(lambda: fn(1))
        wall_p, groups_p, k_p = profile_call(lambda: fn(GEN_PROFILED + 1))
        dev_1, dev_p = sum(groups_1.values()), sum(groups_p.values())
        steps = GEN_PROFILED
        by_group = {g: (ms - groups_1.get(g, 0.0)) / steps
                    for g, ms in sorted(groups_p.items(), key=lambda kv: -kv[1])}
        nbytes = weights_b + cache_passes * kv_cache_bytes(net, rows * beams)
        bound_ms = nbytes / peaks["mem"] * 1e3
        ms_tok = ev.ms()
        return out, {
            "rows": rows, "beams": beams, "new_tokens": new_tokens,
            "ms_per_token": ms_tok, "tokens_per_s": rows * new_tokens / wall,
            "wall_s": wall,
            "profiled_tokens": steps, "busy_share": dev_p / wall_p,
            "busy_share_steps_only": (dev_p - dev_1) / (wall_p - wall_1),
            "launches_per_step": (k_p - k_1) / steps,
            "device_ms_per_step": (dev_p - dev_1) / steps,
            "device_ms_per_step_by_group": by_group,
            "step_bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / ms_tok}

    for c in counters:
        c.launches = 0
    host, host_stats = run(lambda n: generate(net, prompts, n), DECODE_N,
                           GEN_TOKENS, host_loop=True)
    dev, dev_stats = run(lambda n: generate_on_device(net, prompts, n),
                         DECODE_N, GEN_TOKENS)
    if not np.array_equal(host, dev):
        raise RuntimeError("generate_on_device (greedy) differs from generate: "
                           f"{(host != dev).sum()} of {host.size} tokens")
    sampled = generate_on_device(net, prompts, GEN_TOKENS, seed=1,
                                 check_no_sync=True, **SAMPLE_KW)
    again = generate_on_device(net, prompts, GEN_TOKENS, seed=1,
                               check_no_sync=True, **SAMPLE_KW)
    other = generate_on_device(net, prompts, GEN_TOKENS, seed=2,
                               check_no_sync=True, **SAMPLE_KW)
    if not (sampled.shape == (DECODE_N, GEN_TOKENS)
            and ((sampled >= 0) & (sampled < vocab)).all()
            and np.array_equal(sampled, again) and not np.array_equal(sampled, other)):
        raise RuntimeError("sampled decode: ids out of the vocabulary, or the "
                           "seed does not decide the draws")
    _, sample_stats = run(
        lambda n: generate_on_device(net, prompts, n, seed=1, **SAMPLE_KW),
        DECODE_N, GEN_TOKENS)
    beam_prompts = prompts[:BEAM_N]
    (beam_toks, beam_scores), beam_stats = run(
        lambda n: beam_search(net, beam_prompts, n, beam_size=BEAM_SIZE,
                              length_penalty=BEAM_PENALTY),
        BEAM_N, BEAM_TOKENS, beams=BEAM_SIZE, cache_passes=3)
    greedy_beam, _ = beam_search(net, beam_prompts, BEAM_TOKENS, beam_size=1)
    if not (np.array_equal(greedy_beam, dev[:BEAM_N, :BEAM_TOKENS])
            and beam_toks.shape == (BEAM_N, BEAM_TOKENS)
            and np.isfinite(beam_scores).all()):
        raise RuntimeError("beam_search: beam 1 differs from greedy, or bad beams")
    gen_launches = {c.__name__: c.launches for c in counters}
    if any(gen_launches.values()):
        raise RuntimeError(f"generation launched flash kernels: {gen_launches}")
    stats = {
        "card": card, "prefill": [DECODE_N, DECODE_PREFILL],
        "steps": DECODE_STEPS, "max_abs_err_vs_output": err,
        "decode_flash_launches": decode_launches,
        "output_flash_fwd_launches": output_launches,
        "generation_flash_launches": gen_launches,
        "generate": host_stats, "generate_on_device": dev_stats,
        "generate_on_device_sampled": dict(sample_stats, **SAMPLE_KW),
        "beam_search": dict(beam_stats, length_penalty=BEAM_PENALTY,
                            scores=beam_scores.tolist(),
                            note="step bytes count the cache gather's read and write"),
        "greedy_equal": True, "sampled_ids": sampled[0, :16].tolist(),
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("decode " + json.dumps(stats), flush=True)
    del net
    return {"decode": decode_launches, "output_fwd": output_launches}


def gpt2_tbptt_phase(ck, card):
    """GPT-2-small trained by truncated BPTT (chunks of TBPTT_LEN through
    the carried caches) with the fused updater: TBPTT_FITS fit calls on one
    batch (150 K2 and no flash launch a chunk; the mean loss falls); then
    the model zip without its updater state on the card and the CPU, and
    example 11's TBPTT net with its updater state. Returns the launches."""
    import tempfile

    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM, lm_labels

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = TransformerLM().conf()
    conf.backprop_type, conf.tbptt_fwd_length = "truncated_bptt", TBPTT_LEN
    net = ComputationGraph(conf).init()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_tensors = tensors_of(net)
    rng = np.random.default_rng(123)
    ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_N, T))).cuda()
    x = ids.float()
    labels = F.one_hot(torch.cat([ids[:, 1:], ids[:, -1:]], 1), vocab).float()
    lmask = torch.ones((TRAIN_N, T), device=x.device)
    lmask[:, -1] = 0.0  # the last step has no next token
    counters = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv, ck.fused_adam)
    chunks_per_fit = -(-T // TBPTT_LEN)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        events, losses = [], []
        apply = net._apply_updates

        def timed_apply(grads):
            apply(grads)
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)
            losses.append(net._score)

        net._apply_updates = timed_apply
        for c in counters:
            c.launches = 0
        iterations = [net.iteration]
        for _ in range(TBPTT_FITS):
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            events.append(e0)
            net.fit(DataSet(x, labels, labels_mask=lmask))
            iterations.append(net.iteration)
        torch.cuda.synchronize()
        del net._apply_updates
    finally:
        helpers.clear_helper("updater")
    launches = {c.__name__: c.launches for c in counters}
    per_fit = chunks_per_fit + 1
    chunk_ms = [events[f * per_fit + i].elapsed_time(events[f * per_fit + i + 1])
                for f in range(TBPTT_FITS) for i in range(chunks_per_fit)]
    losses = [float(l) for l in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chunks = TBPTT_FITS * chunks_per_fit
    want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "fused_adam": n_tensors * chunks}
    if launches != want:
        raise RuntimeError(f"TBPTT fit launches {launches}, expected {want}")
    if np.diff(iterations).tolist() != [chunks_per_fit] * TBPTT_FITS:
        raise RuntimeError(f"iterations {iterations}: expected "
                           f"{chunks_per_fit} a fit")
    fit_means = [float(np.mean(losses[f * chunks_per_fit:(f + 1) * chunks_per_fit]))
                 for f in range(TBPTT_FITS)]
    if not (np.isfinite(losses).all() and fit_means[-1] < fit_means[0]):
        raise RuntimeError(f"TBPTT did not progress: losses {losses}")
    del labels, lmask

    # the zip of the trained net without its updater state
    probe = np.random.default_rng(7).integers(0, vocab, ZIP_IDS).astype(np.float32)
    want_out = net.output(probe)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpt2.zip")
        t0 = time.perf_counter()
        net.save(path, save_updater=False)
        write_s = time.perf_counter() - t0
        zip_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = ComputationGraph.load(path)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        card_diff = (back.output(probe) - want_out).abs().max().item()
        del back
        t0 = time.perf_counter()
        cpu = ComputationGraph.load(path, device="cpu")
        read_cpu_s = time.perf_counter() - t0
        cpu_diff = (cpu.output(probe) - want_out.cpu()).abs().max().item()
        del cpu
    if not (card_diff == 0.0 and cpu_diff <= ZIP_CPU_ATOL):
        raise RuntimeError(f"GPT-2 zip: card output off by {card_diff}, CPU by "
                           f"{cpu_diff}")
    del net, want_out

    # example 11's TBPTT net, with its updater state, on the card
    ex = TransformerLM(vocab_size=11, max_length=32, n_layers=1, d_model=16,
                       n_heads=2, d_ff=32, seed=5).conf()
    ex.backprop_type, ex.tbptt_fwd_length = "truncated_bptt", 8
    small = ComputationGraph(ex).init()
    start = np.random.default_rng(0).integers(0, 11, (64, 1))
    xs = ((start + 3 * np.arange(32)[None, :]) % 11).astype(np.float32)
    small_mask = np.ones(xs.shape, np.float32)
    small_mask[:, -1] = 0.0
    for _ in range(3):
        small.fit(DataSet(xs, lm_labels(xs, 11), labels_mask=small_mask))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ex11.zip")
        small.save(path)
        again = ComputationGraph.load(path)
    same = all(torch.equal(again.params[v][n], t)
               for v, named in small.params.items() for n, t in named.items())
    same_state = all(torch.equal(again.updater_states[v][n][s], t)
                     for v, named in small.updater_states.items()
                     for n, slots in named.items() for s, t in slots.items())
    if not (same and same_state and again.iteration == small.iteration == 12):
        raise RuntimeError("example 11's zip: parameters or Adam state differ")
    stats = {
        "card": card, "batch": [TRAIN_N, T], "tbptt_length": TBPTT_LEN,
        "fits": TBPTT_FITS, "chunks_per_fit": chunks_per_fit,
        "iterations": iterations, "chunk_losses": losses,
        "fit_mean_losses": fit_means, "chunk_ms": chunk_ms,
        "median_chunk_ms": float(np.median(chunk_ms)),
        "tokens_per_s_median_chunk": TRAIN_N * TBPTT_LEN / (np.median(chunk_ms) / 1e3),
        "launches": launches, "launches_per_chunk": {
            k: v // chunks for k, v in launches.items()},
        "peak_device_mem_gb": peak_gb,
        "zip": {"bytes": zip_bytes, "write_s": write_s, "read_card_s": read_s,
                "read_cpu_s": read_cpu_s, "card_max_abs_diff": card_diff,
                "cpu_max_abs_diff": cpu_diff},
        "ex11_zip_with_updater": {"params_equal": same, "adam_state_equal": same_state,
                                  "iteration": again.iteration},
    }
    print("gpt2_tbptt " + json.dumps(stats), flush=True)
    return {"train": launches, "fused_adam": launches["fused_adam"]}


def cnn_train_flops(conf, batch):
    """The multiply-add FLOPs of one training step of a CNN, a graph or a
    sequential network, from its layer shapes: each convolution and dense
    product forward, its weight gradient, and its data gradient where
    autograd needs one (its input depends on a parameter: not the first
    layer, nor the stem behind the zero padding of a graph's input)."""
    from deeplearning4j_tpu_torch.nn.layers import ConvolutionLayer, DenseLayer

    if hasattr(conf, "vertices"):
        nodes = [(name, conf.vertices[name].obj if conf.vertices[name].is_layer
                  else None, conf.vertices[name].inputs,
                  conf.vertex_input_types[name][0]) for name in conf.topo_order]
    else:
        nodes = [(i, layer, [i - 1] if i else [], conf.layer_input_types[i])
                 for i, layer in enumerate(conf.layers)]
    total, has_grad = 0.0, set()
    for name, layer, inputs, it in nodes:
        needs_dgrad = any(s in has_grad for s in inputs)
        if needs_dgrad or (layer is not None and layer.param_shapes()):
            has_grad.add(name)
        if isinstance(layer, ConvolutionLayer):
            ot = layer.output_type(it)
            kh, kw = layer.kernel_size
            fwd = 2.0 * ot.height * ot.width * ot.channels * kh * kw * layer.n_in
        elif isinstance(layer, DenseLayer):  # the output layer too
            fwd = 2.0 * layer.n_in * layer.n_out
        else:
            continue
        total += fwd * (3 if needs_dgrad else 2)
    return total * batch


def resnet_images(batch, seed):
    """Seeded normal NHWC images and one-hot labels, made on the card."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((batch, RESNET_SIDE, RESNET_SIDE, 3), generator=gen,
                    device="cuda")
    idx = torch.randint(0, RESNET_LABELS, (batch,), generator=gen, device="cuda")
    return x, F.one_hot(idx, RESNET_LABELS).float()


def _worst_rel(got, want):
    """``(name, difference)`` of the tensor whose largest difference is the
    largest relative to its own largest entry, over two trees of tensors."""
    worst_name, worst = "", 0.0
    for v, named in want.items():
        for n, t in named.items():
            diff = (got[v][n].cpu().double() - t.cpu().double()).abs().max().item()
            rel = diff / max(t.abs().max().item(), 1e-30)
            if rel >= worst:
                worst_name, worst = f"{v}/{n}", rel
    return worst_name, worst


def resnet_twins(net_card):
    """One step at RESNET_TWIN_BATCH on the card and on the CPU from
    ``net_card``'s weights and states, in f64 and in f32 (see
    RESNET_F32_FACTOR). Returns the f64 and f32 comparisons; raises when
    one misses its limit."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import (
        export_params, export_states, load_reference_params,
        load_reference_states)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    params, states = export_params(net_card), export_states(net_card)
    x, y = resnet_images(RESNET_TWIN_BATCH, seed=5)
    probe, _ = resnet_images(RESNET_TWIN_BATCH, seed=6)
    x, y, probe = x.cpu().numpy(), y.cpu().numpy(), probe.cpu().numpy()

    def twin(device, dtype):
        conf = ResNet50(num_labels=RESNET_LABELS, seed=1).conf()
        conf.global_conf.dtype = dtype
        net = ComputationGraph(conf, device=device).init()
        return load_reference_states(load_reference_params(net, params), states)

    def grads(net, images=x):
        _, g, _ = net._gradients({"input": net._as_tensor(images)},
                                 [net._as_tensor(y)], train=True)
        return g

    def stepped(net):
        net.fit(x, y)
        return net, net.output(probe).cpu().double()

    out = {}
    cpu64, ref_out = stepped(twin("cpu", "float64"))
    card64, _ = stepped(twin("cuda", "float64"))
    ref_grads = grads(twin("cpu", "float64"))
    name, rel = _worst_rel(card64.params, cpu64.params)
    out["f64"] = {
        "loss_rel": abs(card64.score_ - cpu64.score_) / abs(cpu64.score_),
        "worst_param": name, "worst_param_rel_to_max": rel,
        "worst_state_abs": max(
            (card64.states[v][n].cpu() - t).abs().max().item()
            for v, named in cpu64.states.items() for n, t in named.items())}
    del card64, cpu64

    # f32: the gradients against the CPU's f64 ones, then the step. Each
    # tensor's yardstick is the larger error of two CPU f32 gradients: of
    # the images as given and of the images each moved by one f32 ulp
    # (see RESNET_F32_FACTOR)
    card32, cpu32 = twin("cuda", "float32"), twin("cpu", "float32")
    nudge = np.random.default_rng(8).random(x.shape) < 0.5
    x_ulp = np.where(nudge, np.nextafter(x, np.float32(np.inf)),
                     np.nextafter(x, np.float32(-np.inf)))
    g_card, g_cpu, g_cpu_ulp = grads(card32), grads(cpu32), grads(cpu32, x_ulp)
    ratios, card_sq, cpu_sq, one_sample = [], 0.0, 0.0, []
    for v, named in ref_grads.items():
        for n, w in named.items():
            e_card = (g_card[v][n].cpu().double() - w).norm().item()
            e_cpu = (g_cpu[v][n].double() - w).norm().item()
            e_yard = max(e_cpu, (g_cpu_ulp[v][n].double() - w).norm().item())
            ratios.append((e_card / max(e_yard, 1e-30), f"{v}/{n}",
                           e_card <= max(RESNET_F32_FACTOR * e_yard,
                                         1e-2 * w.norm().item())))
            one_sample.append((e_card / max(e_cpu, 1e-30), f"{v}/{n}"))
            card_sq, cpu_sq = card_sq + e_card ** 2, cpu_sq + e_cpu ** 2
    del g_card, g_cpu_ulp
    (card32, card_out), (cpu32, cpu_out) = stepped(card32), stepped(cpu32)
    name, rel = _worst_rel(card32.params, cpu32.params)
    out["f32"] = {
        "loss_rel": abs(card32.score_ - cpu32.score_) / abs(cpu32.score_),
        "worst_param": name, "worst_param_rel_to_max": rel,
        "grad_l2_ratio_worst": list(max(ratios)[:2]),
        "grad_l2_ratio_worst_first_sample": list(max(one_sample)),
        "grad_l2_ratio_whole": math.sqrt(card_sq / cpu_sq),
        "grad_tensors_within": sum(r[2] for r in ratios),
        "grad_tensors": len(ratios),
        "output_after_step_err": (card_out - ref_out).abs().max().item(),
        "cpu_output_after_step_err": (cpu_out - ref_out).abs().max().item()}
    del card32, cpu32

    # f32: the Nesterovs update of the CPU's gradients on both
    card32, cpu32 = twin("cuda", "float32"), twin("cpu", "float32")
    card32._apply_updates({v: {n: t.cuda() for n, t in named.items()}
                           for v, named in g_cpu.items()})
    cpu32._apply_updates(g_cpu)
    p_name, p_rel = _worst_rel(card32.params, cpu32.params)
    v_name, v_rel = _worst_rel(
        {k: {n: st["v"] for n, st in named.items()}
         for k, named in card32.updater_states.items()},
        {k: {n: st["v"] for n, st in named.items()}
         for k, named in cpu32.updater_states.items()})
    out["f32"].update(update_worst_param=p_name, update_param_rel_to_max=p_rel,
                      update_worst_momentum=v_name,
                      update_momentum_rel_to_max=v_rel)
    del card32, cpu32, g_cpu, ref_grads

    f32, f64 = out["f32"], out["f64"]
    if not (f64["loss_rel"] <= RESNET_LOSS_RTOL
            and f64["worst_param_rel_to_max"] <= RESNET_PARAM_TOL
            and f64["worst_state_abs"] <= RESNET_STATE_TOL
            and f32["loss_rel"] <= RESNET_LOSS_RTOL
            and f32["update_param_rel_to_max"] <= RESNET_UPDATE_TOL
            and f32["update_momentum_rel_to_max"] <= RESNET_UPDATE_TOL
            and f32["grad_tensors_within"] == f32["grad_tensors"]
            and f32["grad_l2_ratio_whole"] <= RESNET_F32_FACTOR):
        raise RuntimeError(f"ResNet-50 card step disagrees with the CPU's: {out}")
    return out


def resnet50_phase(ck, card, peaks):
    """The zoo's ResNet-50 trained at ImageNet shape on the card (see the
    module docstring, phase 11). Returns the launches of the four kernels
    in its timed fit steps (all 0)."""
    import tempfile

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    tried, batch, net = [], RESNET_BATCH, None
    while batch >= 1:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            net = ResNet50(num_labels=RESNET_LABELS, seed=1).init()
            x, labels = resnet_images(batch, seed=1)
            zero_launches(ck)
            net.fit(x, labels)  # the first warm-up step
            torch.cuda.synchronize()
            tried.append({"batch": batch, "fits": True,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            break
        except torch.OutOfMemoryError:
            tried.append({"batch": batch, "fits": False,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            net = x = labels = None
            batch //= 2
    print("resnet50_batches " + json.dumps(tried), flush=True)
    if net is None:
        raise RuntimeError("ResNet-50: no batch fits on the card")
    n_bn = sum(1 for st in net.states.values() if st)
    before = {v: {n: t.clone() for n, t in st.items()}
              for v, st in net.states.items() if st}
    for _ in range(RESNET_WARMUP - 1):
        net.fit(x, labels)
    events, losses = [], []
    for _ in range(RESNET_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(x, labels)
        end.record()
        events.append((start, end))
        losses.append(net._score)
    torch.cuda.synchronize()
    launches = read_launches(ck)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    window_ms = events[0][0].elapsed_time(events[-1][1])
    if any(launches.values()):
        raise RuntimeError(f"ResNet-50 fit launched a kernel: {launches}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"ResNet-50 losses not finite: {losses}")
    unmoved = [f"{v}/{n}" for v, st in before.items() for n, t in st.items()
               if torch.equal(net.states[v][n], t)]
    if n_bn != 53 or unmoved:
        raise RuntimeError(f"ResNet-50 running statistics: {n_bn} BatchNorm "
                           f"layers, unmoved {unmoved[:5]}")
    profile = profile_steps(net, x, labels, fits=RESNET_PROFILED,
                            groups=RESNET_GROUPS)
    flops = cnn_train_flops(net.conf, batch)
    bound_ms = flops / peaks["f32"] * 1e3
    median_step = float(np.median(step_ms))

    # inference: output at the same batch, under inference mode
    out_ms = median_ms(lambda: net.output(x), runs=5, warmup=1)
    out = net.output(x)
    rowsum_dev = (out.double().sum(-1) - 1.0).abs().max().item()
    if not (out.shape == (batch, RESNET_LABELS) and rowsum_dev <= ROWSUM_TOL):
        raise RuntimeError(f"ResNet-50 output: shape {tuple(out.shape)}, rows "
                           f"sum off by {rowsum_dev}")
    del out, x, labels
    torch.cuda.empty_cache()

    # the card's step against the CPU's at batch 2
    twins = resnet_twins(net)

    # the zip with its layer states, restored on the card
    probe, _ = resnet_images(4, seed=7)
    torch.backends.cudnn.deterministic = True
    try:
        want = net.output(probe)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "resnet50.zip")
            t0 = time.perf_counter()
            net.save(path, save_updater=False)
            write_s = time.perf_counter() - t0
            zip_bytes = os.path.getsize(path)
            back = ComputationGraph.load(path)
        got = back.output(probe)
    finally:
        torch.backends.cudnn.deterministic = False
    states_equal = all(torch.equal(back.states[v][n], t)
                       for v, st in net.states.items() for n, t in st.items())
    if not (torch.equal(got, want) and states_equal):
        raise RuntimeError(f"ResNet-50 zip: output off by "
                           f"{(got - want).abs().max().item()}, states equal "
                           f"{states_equal}")
    del back, got, want
    torch.cuda.empty_cache()

    # the Nesterovs update of every tensor, profiled alone on one batch's
    # gradients; last, as its extra steps move the weights
    x, labels = resnet_images(batch, seed=1)
    grads, _ = net.compute_gradient_and_score(x, labels)
    del x, labels
    _, update_wall_ms, update_kernels = profiled(lambda: net._apply_updates(grads))
    update_ms = median_ms(lambda: net._apply_updates(grads), runs=5, warmup=1)
    del grads
    stats = {
        "card": card, "params": net.conf.num_params(), "batch": batch,
        "image": [RESNET_SIDE, RESNET_SIDE, 3], "labels": RESNET_LABELS,
        "batches_tried": tried, "timed_steps": RESNET_TIMED,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_step,
        "window_ms": window_ms,
        "train_images_per_s": RESNET_TIMED * batch / (window_ms / 1e3),
        "train_images_per_s_at_median_step": batch / (median_step / 1e3),
        "peak_device_mem_gb": peak_gb,
        "launches": launches,
        "flops_per_step": flops, "flop_bound_ms_f32": bound_ms,
        "bound_share_of_median_step": bound_ms / median_step,
        "device_busy_share_of_median_step":
            profile["device_ms_per_step"] / median_step,
        "profile_per_step": profile,
        "nesterovs_update_ms": update_ms,
        "nesterovs_update_profiled_device_ms": sum(update_kernels.values()),
        "nesterovs_update_profiled_kernels": len(update_kernels),
        "nesterovs_update_profiled_wall_ms": update_wall_ms,
        "output_batch": batch, "output_ms": out_ms,
        "output_images_per_s": batch / (out_ms / 1e3),
        "twin_batch": RESNET_TWIN_BATCH,
        "twin_f32": twins["f32"], "twin_f64": twins["f64"],
        "zip": {"bytes": zip_bytes, "write_s": write_s, "output_equal": True,
                "states_equal": states_equal},
    }
    print("resnet50 " + json.dumps(stats), flush=True)
    del net
    torch.cuda.empty_cache()
    return launches


def resnet_bf16_twins(net_card):
    """One batch of RESNET_TWIN_BATCH from ``net_card``'s weights and
    states: the card's bf16 gradients (train mode) against the CPU's f64
    ones, over the CPU's own bf16 distance from them (:func:`ratio_form`,
    RESNET_BF16_TENSOR_FLOOR)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import (
        export_params, export_states, load_reference_params,
        load_reference_states)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    params, states = export_params(net_card), export_states(net_card)
    x, y = resnet_images(RESNET_TWIN_BATCH, seed=5)
    x, y = x.cpu().numpy(), y.cpu().numpy()

    def twin(device, dtype, compute_dtype):
        conf = ResNet50(num_labels=RESNET_LABELS, seed=1).conf()
        conf.global_conf.dtype = dtype
        conf.global_conf.compute_dtype = compute_dtype
        net = ComputationGraph(conf, device=device).init()
        return load_reference_states(load_reference_params(net, params), states)

    def grads(net):
        loss, g, _ = net._gradients({"input": net._as_tensor(x)},
                                    [net._as_tensor(y)], train=True)
        return g, float(loss)

    g64, l64 = grads(twin("cpu", "float64", None))
    g_cpu, l_cpu = grads(twin("cpu", "float32", "bfloat16"))
    g_card, l_card = grads(twin("cuda", "float32", "bfloat16"))
    return ratio_form(g_card, g_cpu, g64, l_card, l_cpu, l64,
                      RESNET_BF16_TENSOR_FLOOR)


def resnet50_bf16_phase(ck, card, peaks):
    """bench.py's headline in bf16: the zoo's ResNet-50 (1000 labels, seed
    1) with ``compute_dtype = "bfloat16"`` trained at RESNET_BATCH x
    224x224x3 through ``ComputationGraph.fit``: images/s over RESNET_TIMED
    steps, median step, peak memory, busy share and the FLOP bound share at
    the tensor cores' bf16 rate; every running statistic f32 and moved; no
    launch of the port's kernels (cuDNN's bf16 convolutions and the eager
    BatchNorm, as the reference has no Pallas kernel there); the zip
    restored with ``output`` equal bit for bit; the card's bf16 step at
    batch 2 against the CPU's in the ratio form. Returns the launches."""
    import tempfile

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = ResNet50(num_labels=RESNET_LABELS, seed=1).conf()
    conf.global_conf.compute_dtype = "bfloat16"  # as bench.py sets it
    net = ComputationGraph(conf).init()
    batch = RESNET_BATCH
    x, labels = resnet_images(batch, seed=1)
    zero_launches(ck)
    before = {v: {n: t.clone() for n, t in st.items()}
              for v, st in net.states.items() if st}
    for _ in range(RESNET_WARMUP):
        net.fit(x, labels)
    events, losses = [], []
    for _ in range(RESNET_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(x, labels)
        end.record()
        events.append((start, end))
        losses.append(net._score)
    torch.cuda.synchronize()
    launches = read_launches(ck)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    window_ms = events[0][0].elapsed_time(events[-1][1])
    unmoved = [f"{v}/{n}" for v, st in before.items() for n, t in st.items()
               if torch.equal(net.states[v][n], t)]
    states_f32 = all(t.dtype == torch.float32 for st in net.states.values()
                     for t in st.values())
    masters_f32 = all(t.dtype == torch.float32 for named in net.params.values()
                      for t in named.values())
    profile = profile_steps(net, x, labels, fits=RESNET_PROFILED,
                            groups=RESNET_GROUPS)
    flops = cnn_train_flops(net.conf, batch)
    bound_ms = flops / peaks["bf16"] * 1e3
    median_step = float(np.median(step_ms))
    out_ms = median_ms(lambda: net.output(x), runs=5, warmup=1)
    out = net.output(x)
    out_ok = (out.dtype == torch.bfloat16 and tuple(out.shape) == (batch, RESNET_LABELS)
              and bool(torch.isfinite(out.float()).all()))
    del out, x, labels
    torch.cuda.empty_cache()

    # the zip (f32 params.npz and states.npz, compute_dtype in the
    # configuration), restored on the card
    probe, _ = resnet_images(4, seed=7)
    torch.backends.cudnn.deterministic = True
    try:
        want = net.output(probe)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "resnet50_bf16.zip")
            net.save(path, save_updater=False)
            back = ComputationGraph.load(path)
        got = back.output(probe)
    finally:
        torch.backends.cudnn.deterministic = False
    zip_ok = (back.compute_dtype == torch.bfloat16 and torch.equal(got, want)
              and all(torch.equal(back.states[v][n], t)
                      for v, st in net.states.items() for n, t in st.items()))
    del back, got, want
    torch.cuda.empty_cache()
    twins = resnet_bf16_twins(net)
    stats = {
        "card": card, "compute_dtype": "bfloat16", "batch": batch,
        "image": [RESNET_SIDE, RESNET_SIDE, 3], "labels": RESNET_LABELS,
        "timed_steps": RESNET_TIMED, "losses": losses, "step_ms": step_ms,
        "median_step_ms": median_step, "window_ms": window_ms,
        "train_images_per_s": RESNET_TIMED * batch / (window_ms / 1e3),
        "train_images_per_s_at_median_step": batch / (median_step / 1e3),
        "peak_device_mem_gb": peak_gb, "launches": launches,
        "flops_per_step": flops, "flop_bound_ms_bf16": bound_ms,
        "bound_share_of_median_step": bound_ms / median_step,
        "device_busy_share_of_median_step":
            profile["device_ms_per_step"] / median_step,
        "profile_per_step": profile,
        "output_ms": out_ms, "output_images_per_s": batch / (out_ms / 1e3),
        "running_stats_f32": states_f32, "masters_f32": masters_f32,
        "unmoved_stats": unmoved[:5], "zip_output_equal": zip_ok,
        "twin_batch": RESNET_TWIN_BATCH, "twin": twins,
    }
    print("resnet50_bf16 " + json.dumps(stats), flush=True)
    if any(launches.values()):
        raise RuntimeError(f"ResNet-50 bf16 fit launched a kernel: {launches}")
    if not (np.isfinite(losses).all() and out_ok and states_f32 and masters_f32
            and not unmoved and zip_ok and twins["ok"]):
        raise RuntimeError("ResNet-50 bf16: losses finite "
                           f"{np.isfinite(losses).all()}, output {out_ok}, "
                           f"stats f32 {states_f32}, masters f32 {masters_f32}, "
                           f"unmoved {unmoved[:5]}, zip {zip_ok}, twins {twins}")
    del net
    torch.cuda.empty_cache()
    return launches


def vgg16_twins(net_card):
    """One batch of VGG_TWIN_BATCH from ``net_card``'s weights, through
    ``compute_gradient_and_score`` (no dropout): the card's bf16 gradients
    against the CPU's f64 ones, over the CPU's own bf16 distance from them
    (:func:`ratio_form`, RESNET_BF16_TENSOR_FLOOR), and the CPU's f32
    distance from f64 (how ill-conditioned the f32 step is: relative L2 of
    the whole gradient, the worst tensor's largest difference over its
    largest entry)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)
    from deeplearning4j_tpu_torch.zoo.models import VGG16

    params = export_params(net_card)
    x, y = resnet_images(VGG_TWIN_BATCH, seed=5)
    x, y = x.cpu().numpy(), y.cpu().numpy()

    def grads(device, dtype, compute_dtype):
        conf = VGG16(num_labels=RESNET_LABELS, seed=1).conf()
        conf.global_conf.dtype = dtype
        conf.global_conf.compute_dtype = compute_dtype
        net = load_reference_params(MultiLayerNetwork(conf, device=device).init(),
                                    params)
        g, loss = net.compute_gradient_and_score(x, y)
        return {k: {n: t.detach().cpu() for n, t in named.items()}
                for k, named in g.items()}, float(loss)

    g64, l64 = grads("cpu", "float64", None)
    g32, l32 = grads("cpu", "float32", None)
    diff = sum(((g32[k][n].double() - t) ** 2).sum().item()
               for k, named in g64.items() for n, t in named.items())
    norm = sum((t ** 2).sum().item() for named in g64.values() for t in named.values())
    worst = _worst_rel(g32, g64)
    g_cpu, l_cpu = grads("cpu", "float32", "bfloat16")
    g_card, l_card = grads("cuda", "float32", "bfloat16")
    out = ratio_form(g_card, g_cpu, g64, l_card, l_cpu, l64, RESNET_BF16_TENSOR_FLOOR)
    out["f32_conditioning"] = {"grad_rel_l2_whole": math.sqrt(diff / max(norm, 1e-300)),
                               "worst_tensor": list(worst),
                               "loss_rel_err": abs(l32 - l64) / abs(l64)}
    return out


def vgg16_bf16_phase(ck, card, peaks):
    """bench.py's VGG16 in bf16 (``_bench_vgg16``): the zoo's VGG16 (1000
    labels, seed 1) with ``compute_dtype = "bfloat16"`` through
    ``MultiLayerNetwork.fit`` at VGG_BATCH x 224x224x3, its Nesterovs
    updater: VGG_WARMUP warm-up and VGG_TIMED timed steps (median step,
    images/s, peak memory), VGG_PROFILED more under the profiler (busy
    share, device time by group: convolutions, bf16 and f32 matrix
    products, elementwise), the FLOP bound share at the tensor cores' bf16
    rate; losses finite, masters f32, no launch of K1, K2 or K3 (the
    reference's path has no kernel either); the zip restored with
    ``output`` equal bit for bit; the batch-2 gradients in the ratio form
    (:func:`vgg16_twins`). Returns the launches of the timed steps."""
    import tempfile

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo.models import VGG16

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = VGG16(num_labels=RESNET_LABELS, seed=1).conf()
    conf.global_conf.compute_dtype = "bfloat16"  # as bench.py sets it
    net = MultiLayerNetwork(conf).init()
    x, labels = resnet_images(VGG_BATCH, seed=1)
    for _ in range(VGG_WARMUP):
        net.fit(x, labels)
    zero_launches(ck)
    step_ms, losses = timed_fits(net, x, labels, VGG_TIMED)
    launches = read_launches(ck)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    masters_f32 = all(t.dtype == torch.float32 for named in net.params.values()
                      for t in named.values())
    profile = profile_steps(net, x, labels, fits=VGG_PROFILED, groups=VGG_GROUPS,
                            classify=gemm_group)
    flops = cnn_train_flops(net.conf, VGG_BATCH)
    bound_ms = flops / peaks["bf16"] * 1e3
    median_step = float(np.median(step_ms))
    out_ms = median_ms(lambda: net.output(x), runs=5, warmup=1)
    out = net.output(x)
    out_ok = (out.dtype == torch.bfloat16 and tuple(out.shape) == (VGG_BATCH, RESNET_LABELS)
              and bool(torch.isfinite(out.float()).all()))
    del out, x, labels
    torch.cuda.empty_cache()

    probe, _ = resnet_images(4, seed=7)
    torch.backends.cudnn.deterministic = True
    try:
        want = net.output(probe)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "vgg16_bf16.zip")
            net.save(path, save_updater=False)
            back = MultiLayerNetwork.load(path)
        got = back.output(probe)
    finally:
        torch.backends.cudnn.deterministic = False
    zip_ok = back.compute_dtype == torch.bfloat16 and torch.equal(got, want)
    del back, got, want, probe
    torch.cuda.empty_cache()
    twins = vgg16_twins(net)
    stats = {
        "card": card, "compute_dtype": "bfloat16", "params": net.conf.num_params(),
        "batch": VGG_BATCH, "image": [RESNET_SIDE, RESNET_SIDE, 3],
        "labels": RESNET_LABELS, "timed_steps": VGG_TIMED, "losses": losses,
        "step_ms": step_ms, "median_step_ms": median_step,
        "train_images_per_s_at_median_step": VGG_BATCH / (median_step / 1e3),
        "peak_device_mem_gb": peak_gb, "launches": launches,
        "flops_per_step": flops, "flop_bound_ms_bf16": bound_ms,
        "bound_share_of_median_step": bound_ms / median_step,
        "device_busy_share_of_median_step":
            profile["device_ms_per_step"] / median_step,
        "profile_per_step": profile,
        "output_ms": out_ms, "output_images_per_s": VGG_BATCH / (out_ms / 1e3),
        "masters_f32": masters_f32, "zip_output_equal": zip_ok,
        "twin_batch": VGG_TWIN_BATCH, "twin": twins,
    }
    print("vgg16_bf16 " + json.dumps(stats), flush=True)
    if any(launches.values()):
        raise RuntimeError(f"VGG16 bf16 fit launched a kernel: {launches}")
    if not (np.isfinite(losses).all() and out_ok and masters_f32 and zip_ok
            and twins["ok"]):
        raise RuntimeError(f"VGG16 bf16: losses {losses}, output {out_ok}, "
                           f"masters f32 {masters_f32}, zip {zip_ok}, twins {twins}")
    del net
    torch.cuda.empty_cache()
    return launches


def encoder_bf16_phase(ck, card):
    """bench.py's BERT-base-shape encoder in bf16 (its ``_bench_bert_import``
    fallback): the zoo's TransformerEncoder (2 labels, seed 1, Adam(1e-4))
    with ``compute_dtype = "bfloat16"`` through ``ComputationGraph.fit`` at
    ENC_BATCH x ENC_T integer ids, with the fused updater, two ways in one
    process (see ENC_*), each a fresh network from the seed: (a) no
    attention helper, (b) the registered
    ``FlashAttentionHelper(causal=False)``. Each way: median step,
    tokens/s, peak memory, busy share and device time by group, its
    launches a step; (b) also one ``output`` and one batch's loss and
    gradients in the ratio form against an f32 twin on the plain
    attention, a bf16 twin on the plain attention the yardstick; then a
    masked batch with the helper registered. Returns the launches of each
    path."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)
    from deeplearning4j_tpu_torch.zoo.models import TransformerEncoder

    def encoder(compute_dtype="bfloat16"):
        conf = TransformerEncoder(num_labels=2, seed=1).conf()
        conf.global_conf.compute_dtype = compute_dtype
        return ComputationGraph(conf).init()

    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    ids = labels = net = None
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    ways = {}
    for way, helper in (("a", None), ("b", ck.FlashAttentionHelper(causal=False))):
        del net
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = encoder()
        if ids is None:
            vocab = net.conf.vertices["embed"].obj.n_in
            n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
            n_tensors = tensors_of(net)
            ids = torch.randint(0, vocab, (ENC_BATCH, ENC_T), generator=gen, device="cuda")
            labels = F.one_hot(torch.randint(0, 2, (ENC_BATCH,), generator=gen,
                                             device="cuda"), 2).float()
        if helper is not None:
            helpers.set_helper("attention", helper)
        losses = []
        for _ in range(ENC_WARMUP):
            net.fit(ids, labels)
            losses.append(net.score_)
        zero_launches(ck)
        step_ms, timed = timed_fits(net, ids, labels, ENC_TIMED)
        launches = read_launches(ck)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses += timed
        profile = profile_steps(net, ids, labels, groups=GPT2_BF16_GROUPS,
                                classify=gemm_group)
        median_step = float(np.median(step_ms))
        ways[way] = {"helper": None if helper is None else "FlashAttentionHelper(causal=False)",
                     "losses": losses, "step_ms": step_ms, "median_step_ms": median_step,
                     "tokens_per_s_at_median_step": ENC_BATCH * ENC_T / (median_step / 1e3),
                     "peak_device_mem_gb": peak_gb, "launches": launches,
                     "launches_per_step": {k: v / ENC_TIMED for k, v in launches.items()},
                     "device_busy_share_of_median_step":
                         profile["device_ms_per_step"] / median_step,
                     "profile_per_step": profile}
    want_a = {"fused_adam": n_tensors * ENC_TIMED}
    want_b = {"fused_adam": n_tensors * ENC_TIMED,
              **{f"{k}_bf16": n_layers * ENC_TIMED for k in (
                  "flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")}}

    # (b)'s one output: 12 K3a-bf16
    zero_launches(ck)
    out = net.output(ids)
    torch.cuda.synchronize()
    out_launches = read_launches(ck)
    out_ok = (out.dtype == torch.bfloat16 and tuple(out.shape) == (ENC_BATCH, 2)
              and bool(torch.isfinite(out.float()).all()))
    del out

    # (b)'s parity: the kernel path, a bf16 twin on the plain attention and
    # an f32 twin on the plain attention (the oracle), one batch
    weights = export_params(net)
    g_k, loss_k = net.compute_gradient_and_score(ids, labels)
    helpers.clear_helper("attention")
    plain = load_reference_params(encoder(), weights)
    g_p, loss_p = plain.compute_gradient_and_score(ids, labels)
    del plain
    ref = load_reference_params(encoder(None), weights)
    g_r, loss_r = ref.compute_gradient_and_score(ids, labels)
    parity = ratio_form(g_k, g_p, g_r, loss_k, loss_p, loss_r, BF16_TENSOR_FLOOR)
    grads_f32 = all(t.dtype == torch.float32 for named in g_k.values()
                    for t in named.values())
    masters_f32 = all(t.dtype == torch.float32 for named in net.params.values()
                      for t in named.values())
    del g_k, g_p, g_r

    # a padded batch with its mask takes the plain path, the helper
    # registered: a bf16 fit step and output, then in f32 the padded
    # output against its unpadded prefix's
    helpers.set_helper("attention", ck.FlashAttentionHelper(causal=False))
    mask = torch.zeros((ENC_MASK_ROWS, ENC_T), device="cuda")
    mask[:, :ENC_MASK_VALID] = 1.0
    padded = ids[:ENC_MASK_ROWS]
    zero_launches(ck)
    net.fit(MultiDataSet([padded], [labels[:ENC_MASK_ROWS]], [mask]))
    net.output(padded, masks=[mask])
    ref.output(padded, masks=[mask])
    torch.cuda.synchronize()
    mask_launches = read_launches(ck)
    got = ref.output(padded, masks=[mask]).double()
    want = ref.output(padded[:, :ENC_MASK_VALID]).double()
    mask_err = (got - want).abs().max().item()
    helpers.clear_helper("attention")
    helpers.clear_helper("updater")
    del ref, got, want
    stats = {
        "card": card, "compute_dtype": "bfloat16", "ids": "int64",
        "params": net.conf.num_params(), "batch": [ENC_BATCH, ENC_T],
        "tensors": n_tensors, "attention_layers": n_layers, "timed_steps": ENC_TIMED,
        "ways": ways, "output_launches_b": out_launches,
        "parity_b": {"loss_kernel": loss_k, "loss_plain_bf16": loss_p,
                     "loss_f32": loss_r, **parity},
        "grads_f32": grads_f32, "masters_f32": masters_f32,
        "masked": {"rows": ENC_MASK_ROWS, "valid": ENC_MASK_VALID,
                   "launches": mask_launches, "f32_prefix_max_abs_err": mask_err,
                   "limit": ENC_MASK_TOL},
    }
    print("encoder_bf16 " + json.dumps(stats), flush=True)
    bad = {"a": unexpected_launches(ways["a"]["launches"], want_a),
           "b": unexpected_launches(ways["b"]["launches"], want_b),
           "b_output": unexpected_launches(out_launches, {"flash_attention_fwd_bf16": n_layers}),
           "masked": unexpected_launches(mask_launches, {"fused_adam": n_tensors})}
    if n_tensors != ENC_TENSORS or any(bad.values()):
        raise RuntimeError(f"encoder_bf16: {n_tensors} tensors (expected "
                           f"{ENC_TENSORS}), unexpected launches {bad}")
    for way in ways.values():
        losses = way["losses"]
        if not (np.isfinite(losses).all()
                and np.mean(losses[-ENC_SETTLED:]) < losses[0]):
            raise RuntimeError(f"encoder_bf16 did not progress: {losses}")
    if not (out_ok and parity["ok"] and grads_f32 and masters_f32
            and mask_err <= ENC_MASK_TOL):
        raise RuntimeError(f"encoder_bf16: output {out_ok}, parity {parity}, f32 "
                           f"gradients {grads_f32}, f32 masters {masters_f32}, "
                           f"masked prefix error {mask_err}")
    del net, ids, labels, weights
    torch.cuda.empty_cache()
    return {"train_a": ways["a"]["launches"], "train_b": ways["b"]["launches"],
            "output_b": out_launches}


def zoo_smoke_phase(ck, card):
    """The zoo's other models at their published widths on the card, f32,
    batch ZOO_BATCH: AlexNet, VGG19 and GoogLeNet at 224x224x3,
    TextGenerationLSTM at its defaults (26 characters, T 40),
    VisionTransformer at ViT-B/16 numbers. Each takes one fit step and
    one output with the fused updater registered: the loss finite, the
    rows of output summing to 1 within ROWSUM_TOL, and no kernel launch
    but K2 on ViT's Adam (one a tensor): GravesLSTM takes no K1, and ViT's
    T = 196 is no multiple of 128. Returns the launches by model."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.zoo.models import (AlexNet, GoogLeNet,
                                                     TextGenerationLSTM, VGG19,
                                                     VisionTransformer)

    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    rows, bad = {}, {}
    for model in (AlexNet(), VGG19(), GoogLeNet(), TextGenerationLSTM(),
                  VisionTransformer(**VIT_B16)):
        name = type(model).__name__
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = model.init()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(9)
        if name == "TextGenerationLSTM":
            shape, n = (ZOO_BATCH, model.max_length, model.num_labels), model.num_labels
            idx = torch.randint(0, n, shape[:2], generator=gen, device="cuda")
            x = F.one_hot(idx, n).float()
            y = F.one_hot(torch.roll(idx, -1, 1), n).float()
        else:
            side = getattr(model, "image_size", 224)
            x = torch.randn((ZOO_BATCH, side, side, 3), generator=gen, device="cuda")
            y = F.one_hot(torch.randint(0, model.num_labels, (ZOO_BATCH,),
                                        generator=gen, device="cuda"),
                          model.num_labels).float()
        zero_launches(ck)
        t0 = time.perf_counter()
        net.fit(x, y)
        loss = net.score_
        fit_s = time.perf_counter() - t0
        out = net.output(x)
        torch.cuda.synchronize()
        launches = read_launches(ck)
        rowsum_dev = (out.double().sum(-1) - 1.0).abs().max().item()
        want = {"fused_adam": tensors_of(net)} if name == "VisionTransformer" else {}
        rows[name] = {"params": net.conf.num_params(), "loss": loss,
                      "first_fit_s": fit_s, "output_shape": list(out.shape),
                      "rowsum_max_dev": rowsum_dev, "launches": launches,
                      "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if (not math.isfinite(loss) or rowsum_dev > ROWSUM_TOL
                or unexpected_launches(launches, want)):
            bad[name] = rows[name]
        del net, x, y, out
    helpers.clear_helper("updater")
    torch.cuda.empty_cache()
    print("zoo_smoke " + json.dumps({"card": card, "batch": ZOO_BATCH, "dtype": "float32",
                                     "models": rows}), flush=True)
    if bad:
        raise RuntimeError(f"zoo_smoke: {bad}")
    return {name: row["launches"] for name, row in rows.items()}


def sl_ff_conf(compute_dtype=None):
    """Embedding(SL_VOCAB, SL_WIDTH) -> ElementWiseMultiplication -> PReLU
    -> a Dense(SL_WIDTH) for each of SL_ACTIVATIONS -> CenterLossOutput
    (SL_FF_LABELS), Adam(1e-3). The embedding is drawn from N(0, 1), so
    that the first dense layer sees inputs of order 1 (xavier over 10000
    rows draws them 70 times smaller)."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.nn.weights import Distribution

    b = (NeuralNetConfiguration.builder().seed(16).updater(Adam(1e-3)).list()
         .layer(L.EmbeddingLayer(n_in=SL_VOCAB, n_out=SL_WIDTH, activation="identity",
                                 weight_init="distribution",
                                 distribution=Distribution("normal", 0.0, 1.0)))
         .layer(L.ElementWiseMultiplicationLayer(activation="identity"))
         .layer(L.PReLULayer()))
    for act in SL_ACTIVATIONS:
        b.layer(L.DenseLayer(n_out=SL_WIDTH, activation=act))
    conf = (b.layer(L.CenterLossOutputLayer(n_out=SL_FF_LABELS))
            .set_input_type(InputType.feed_forward(1)).build())
    conf.global_conf.compute_dtype = compute_dtype
    return conf


def sl_seq_conf(compute_dtype=None):
    """[N, T, C] -> Convolution1D(128, k 5, elu) -> ZeroPadding1D(2, 2) ->
    Subsampling1D(max, 2) -> Upsampling1D(2) -> MaskLayer ->
    Convolution1D(SL_SEQ_LABELS, k 1) -> RnnLossLayer(mcxent, softmax)."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    _, t, c = SL_SEQ
    conf = (NeuralNetConfiguration.builder().seed(17).updater(Adam(1e-3)).list()
            .layer(L.Convolution1DLayer(n_out=128, kernel_size=5, activation="elu"))
            .layer(L.ZeroPadding1DLayer(padding=(2, 2)))
            .layer(L.Subsampling1DLayer(pooling_type="max", kernel_size=2, stride=2))
            .layer(L.Upsampling1DLayer(size=2))
            .layer(L.MaskLayer())
            .layer(L.Convolution1DLayer(n_out=SL_SEQ_LABELS, kernel_size=1,
                                        activation="identity"))
            .layer(L.RnnLossLayer(loss="mcxent", activation="softmax"))
            .set_input_type(InputType.recurrent1d(c, t)).build())
    conf.global_conf.compute_dtype = compute_dtype
    return conf


def sl_image_conf(compute_dtype=None):
    """NHWC [N, 64, 64, 3] -> Convolution(32, same, relu6) -> Depthwise(dm
    2, swish) -> Separable(64, mish) -> SpaceToDepth(2) -> Deconvolution
    (32, k 2, s 2) -> Crop(2) -> ZeroPadding(2) -> Upsampling(2) -> 1x1
    Convolution(SL_IMAGE_LABELS) -> CnnLossLayer(mcxent, softmax): 128 x
    128 maps of labels."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    _, h, w, c = SL_IMAGES
    conf = (NeuralNetConfiguration.builder().seed(18).updater(Adam(1e-3)).list()
            .layer(L.ConvolutionLayer(n_out=32, kernel_size=(3, 3), convolution_mode="same",
                                      activation="relu6"))
            .layer(L.DepthwiseConvolution2DLayer(depth_multiplier=2, kernel_size=(3, 3),
                                                 convolution_mode="same", activation="swish"))
            .layer(L.SeparableConvolution2DLayer(n_out=64, kernel_size=(3, 3),
                                                 convolution_mode="same", activation="mish"))
            .layer(L.SpaceToDepthLayer(block_size=2))
            .layer(L.Deconvolution2DLayer(n_out=32, kernel_size=(2, 2), stride=(2, 2),
                                          activation="identity"))
            .layer(L.CropLayer(crop=(2, 2, 2, 2)))
            .layer(L.ZeroPaddingLayer(padding=(2, 2)))
            .layer(L.UpsamplingLayer(size=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=SL_IMAGE_LABELS, kernel_size=(1, 1),
                                      activation="identity"))
            .layer(L.CnnLossLayer(loss="mcxent", activation="softmax"))
            .set_input_type(InputType.convolutional(h, w, c)).build())
    conf.global_conf.compute_dtype = compute_dtype
    return conf


def sl_data():
    """(name, conf builder, features, labels, step mask) of each small-layer
    network, made on the card from a seed: integer ids for the embedding
    (a bf16 id would round), and a step mask that ends a quarter of the
    1-D rows early."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    ids = torch.randint(0, SL_VOCAB, (SL_FF_BATCH, 1), generator=gen, device="cuda")
    ff_y = F.one_hot(torch.randint(0, SL_FF_LABELS, (SL_FF_BATCH,), generator=gen,
                                   device="cuda"), SL_FF_LABELS).float()
    n, t, c = SL_SEQ
    seq = torch.randn(SL_SEQ, generator=gen, device="cuda")
    seq_y = F.one_hot(torch.randint(0, SL_SEQ_LABELS, (n, t), generator=gen,
                                    device="cuda"), SL_SEQ_LABELS).float()
    mask = torch.ones((n, t), device="cuda")
    ends = torch.randint(t // 2, t, (n // 4,), generator=gen, device="cuda")
    for row, end in enumerate(ends.tolist()):
        mask[row, end:] = 0.0
    img = torch.randn(SL_IMAGES, generator=gen, device="cuda")
    img_y = F.one_hot(torch.randint(0, SL_IMAGE_LABELS,
                                    (SL_IMAGES[0], 2 * SL_IMAGES[1], 2 * SL_IMAGES[2]),
                                    generator=gen, device="cuda"), SL_IMAGE_LABELS).float()
    return [("feed_forward", sl_ff_conf, ids, ff_y, None),
            ("conv1d", sl_seq_conf, seq, seq_y, mask),
            ("conv2d", sl_image_conf, img, img_y, None)]


def sl_leaves(tree, path=""):
    """``{path: tensor}`` of a nested dict of tensors."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for key, sub in tree.items():
        out.update(sl_leaves(sub, f"{path}/{key}" if path else str(key)))
    return out


def sl_rel(a, b):
    """max |a - b| over max |b| (a moved to b's device and dtype)."""
    b = b.double()
    return ((a.double().to(b.device) - b).abs().max().item()
            / max(b.abs().max().item(), 1e-30))


def sl_against_cpu(card, cpu32, cpu64):
    """Each tensor of the card's tree against the CPU f32 twin's (within
    SL_TOL x its largest entry), else against the f64 twin's (within
    SL_F32_FACTOR x the CPU f32 twin's distance from it): the worst direct
    difference, the worst ratio where the direct one is over SL_TOL, and
    the tensors that fail both."""
    c32, c64 = sl_leaves(cpu32), sl_leaves(cpu64)
    worst, ratios, bad = (0.0, ""), [], []
    for path, t in sl_leaves(card).items():
        direct = sl_rel(t, c32[path])
        worst = max(worst, (direct, path))
        if direct <= SL_TOL:
            continue
        e_card, e_cpu = sl_rel(t, c64[path]), sl_rel(c32[path], c64[path])
        ratios.append((e_card / max(e_cpu, 1e-30), path, e_card, e_cpu))
        if e_card > SL_F32_FACTOR * e_cpu:
            bad.append(path)
    return {"max_rel_diff": list(worst), "over_tol": len(ratios),
            "worst_f64_ratio": list(max(ratios)) if ratios else None, "failing": bad}


def sl_fits(net, x, y, mask, steps=SL_STEPS):
    losses = []
    for _ in range(steps):
        net.fit(x, y, features_mask=mask)
        losses.append(net.score_)
    return losses


def sl_network(ck, name, conf_fn, x, y, mask):
    """One small-layer network f32 and bf16, card against CPU (see the
    constants). Returns its readings and each path's launches."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params

    xc, yc = x.cpu(), y.cpu()
    mc = None if mask is None else mask.cpu()
    cpu32 = MultiLayerNetwork(conf_fn(), device="cpu").init()
    weights = export_params(cpu32)
    tensors = tensors_of(cpu32)
    g_ref, loss_ref = cpu32.compute_gradient_and_score(xc, yc, features_mask=mc)
    cpu_losses = sl_fits(cpu32, xc, yc, mc)
    conf64 = conf_fn()
    conf64.global_conf.dtype = "float64"
    cpu64 = load_reference_params(MultiLayerNetwork(conf64, device="cpu").init(), weights)
    g_64, _ = cpu64.compute_gradient_and_score(xc, yc, features_mask=mc)
    sl_fits(cpu64, xc, yc, mc)
    row, paths = {"tensors": tensors}, {}

    card32 = load_reference_params(MultiLayerNetwork(conf_fn()).init(), weights)
    g_card, _ = card32.compute_gradient_and_score(x, y, features_mask=mask)
    zero_launches(ck)
    t0 = time.perf_counter()
    losses = sl_fits(card32, x, y, mask)
    torch.cuda.synchronize()
    row["f32_steps_s"] = time.perf_counter() - t0
    paths[f"small_layers_{name}_train"] = read_launches(ck)
    start = {k: {n: torch.from_numpy(a) for n, a in named.items()}
             for k, named in enumerate(weights)}
    unmoved = [p for p, t in sl_leaves(card32.params).items()
               if torch.equal(t.cpu(), sl_leaves(start)[p])]
    checks = {"grads": sl_against_cpu(g_card, g_ref, g_64),
              "params": sl_against_cpu(card32.params, cpu32.params, cpu64.params),
              "slots": sl_against_cpu(card32.updater_states, cpu32.updater_states,
                                      cpu64.updater_states)}
    row["f32"] = {"losses": losses, "cpu_losses": cpu_losses, "unmoved": unmoved, **checks}
    f32_ok = (not any(c["failing"] for c in checks.values()) and not unmoved
              and np.isfinite(losses).all())
    del card32, cpu32, cpu64, g_card, g_64

    card16 = load_reference_params(MultiLayerNetwork(conf_fn("bfloat16")).init(), weights)
    g_k, loss_k = card16.compute_gradient_and_score(x, y, features_mask=mask)
    cpu16 = load_reference_params(
        MultiLayerNetwork(conf_fn("bfloat16"), device="cpu").init(), weights)
    g_p, loss_p = cpu16.compute_gradient_and_score(xc, yc, features_mask=mc)
    del cpu16
    parity = ratio_form(g_k, g_p, g_ref, loss_k, loss_p, loss_ref, BF16_TENSOR_FLOOR)
    grads_f32 = all(t.dtype == torch.float32 for named in g_k.values()
                    for t in named.values())
    zero_launches(ck)
    losses16 = sl_fits(card16, x, y, mask)
    torch.cuda.synchronize()
    paths[f"small_layers_{name}_bf16_train"] = read_launches(ck)
    masters_f32 = all(t.dtype == torch.float32 for named in card16.params.values()
                      for t in named.values())
    row["bf16"] = {"losses": losses16, "loss": loss_k, "loss_cpu_bf16": loss_p,
                   "loss_f32": loss_ref, "grads_f32": grads_f32,
                   "masters_f32": masters_f32, **parity}
    bf16_ok = parity["ok"] and grads_f32 and masters_f32 and np.isfinite(losses16).all()
    del card16, g_k, g_p, g_ref
    want = {"fused_adam": tensors * SL_STEPS}
    bad = {p: c for p, c in paths.items() if unexpected_launches(c, want)}
    row["ok"] = f32_ok and bf16_ok and not bad
    return row, paths, bad


def sl_zoo_model(ck, model, compute_dtype, x, y, timed):
    """One zoo model on the card: a fit, ``timed`` timed fits (CUDA
    events), one output, the busy share of 2 profiled fits; the launches
    of all but the profiled fits."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = model.conf()
    conf.global_conf.compute_dtype = compute_dtype
    net_cls = ComputationGraph if hasattr(conf, "vertices") else MultiLayerNetwork
    net = net_cls(conf).init(seed=model.seed)
    zero_launches(ck)
    t0 = time.perf_counter()
    net.fit(x, y)
    first = net.score_
    first_s = time.perf_counter() - t0
    step_ms, losses = timed_fits(net, x, y, timed) if timed else ([], [])
    out = net.output(x)
    torch.cuda.synchronize()
    launches = read_launches(ck)
    rowsum_dev = (out.double().sum(-1) - 1.0).abs().max().item()
    row = {"params": net.conf.num_params(), "dtype": compute_dtype or "float32",
           "first_loss": first, "first_fit_s": first_s, "losses": losses,
           "step_ms": step_ms, "output_shape": list(out.shape),
           "output_dtype": str(out.dtype), "rowsum_max_dev": rowsum_dev,
           "rowsum_limit": ROWSUM_TOL if compute_dtype is None else ROWSUM_TOL_BF16,
           "launches": launches}
    if timed:
        row["median_step_ms"] = float(np.median(step_ms))
        row["images_per_s"] = x.shape[0] / (row["median_step_ms"] / 1e3)
        row.update(busy(lambda: [net.fit(x, y) for _ in range(2)], 2))
    row["peak_device_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["ok"] = (math.isfinite(first) and np.isfinite(losses).all()
                 and rowsum_dev <= row["rowsum_limit"]
                 and not unexpected_launches(launches, {}))
    del net, out
    return row


def small_layers_phase(ck, card):
    """The small-layer slice on the card (see the module docstring).
    Returns K2's launches by path."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.layers import SpaceToBatchLayer
    from deeplearning4j_tpu_torch.zoo.models import Darknet19, SimpleCNN

    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    rows, paths, failures = {}, {}, []
    try:
        for name, conf_fn, x, y, mask in sl_data():
            rows[name], got, bad = sl_network(ck, name, conf_fn, x, y, mask)
            paths.update(got)
            print("small_layers " + json.dumps({"network": name, **rows[name]}), flush=True)
            if not rows[name]["ok"]:
                failures.append(f"{name}: launches {bad}")
        # space-to-batch changes the batch: its forward against the CPU's
        s2b = SpaceToBatchLayer(blocks=(2, 2), padding=(1, 1, 0, 0))
        z = torch.randn((SL_IMAGES[0], 62, 64, 32), device="cuda")
        got = s2b.forward({}, z)
        rows["space_to_batch"] = {"shape": list(got.shape),
                                  "equal_to_cpu": bool(torch.equal(
                                      got.cpu(), s2b.forward({}, z.cpu())))}
        if not rows["space_to_batch"]["equal_to_cpu"]:
            failures.append(f"space_to_batch: {rows['space_to_batch']}")
        # the zoo's two models of this slice: no kernel launch (Nesterovs
        # and AdaDelta take none)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(19)
        for model, dtypes, timed in ((Darknet19(), (None, "bfloat16"), SL_ZOO_TIMED),
                                     (SimpleCNN(input_shape=SIMPLE_CNN_SHAPE), (None,), 0)):
            c, h, w = model.input_shape
            x = torch.randn((ZOO_BATCH, h, w, c), generator=gen, device="cuda")
            y = F.one_hot(torch.randint(0, model.num_labels, (ZOO_BATCH,), generator=gen,
                                        device="cuda"), model.num_labels).float()
            for dtype in dtypes:
                key = f"{type(model).__name__}_{dtype or 'float32'}"
                rows[key] = sl_zoo_model(ck, model, dtype, x, y, timed)
                print("small_layers " + json.dumps({"model": key, "card": card,
                                                    "batch": ZOO_BATCH, **rows[key]}),
                      flush=True)
                if not rows[key]["ok"]:
                    failures.append(f"{key}: {rows[key]}")
    finally:
        helpers.clear_helper("updater")
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"small_layers: {failures}")
    return {p: c["fused_adam"] for p, c in paths.items()}


# --------------------------------------------------------------- pretraining
class handed_draws:
    """A context in which ``nn/dropout.py``'s ``bernoulli``, ``normal`` and
    ``uniform`` hand out the given ``(kind, CPU tensor)`` draws in turn
    (cycling), moved to the asking device (and dtype), so that a network on
    the card and its twin on the CPU take the same draws. ``calls``
    counts them."""

    def __init__(self, draws):
        self.draws, self.calls = list(draws), 0

    def _take(self, kind, shape, device, dtype):
        k, t = self.draws[self.calls % len(self.draws)]
        if k != kind or tuple(t.shape) != tuple(shape):
            raise RuntimeError(f"draw {self.calls}: asked {kind}{tuple(shape)}, "
                               f"handed {k}{tuple(t.shape)}")
        self.calls += 1
        return t.to(device, dtype)

    def __enter__(self):
        from deeplearning4j_tpu_torch.nn import dropout as d
        self._saved = (d.bernoulli, d.normal, d.uniform)
        d.bernoulli = lambda p, shape, gen, device, dtype=None: self._take(
            "bernoulli", shape, device, torch.bool)
        d.normal = lambda shape, gen, device, dtype=torch.float32: self._take(
            "normal", shape, device, dtype)
        d.uniform = lambda shape, gen, device, dtype=torch.float32, low=0.0, high=1.0: \
            self._take("uniform", shape, device, dtype)
        return self

    def __exit__(self, *exc):
        from deeplearning4j_tpu_torch.nn import dropout as d
        d.bernoulli, d.normal, d.uniform = self._saved
        return False


class StepRecorder:
    """The batches of a ``pretrain`` call, handed out one by one: a CUDA
    event before each batch and after the last, and the network's loss
    (a device scalar, not read) after each step."""

    def __init__(self, net, batches):
        self.net, self.batches, self.events, self.losses = net, batches, [], []

    def _mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def __iter__(self):
        for ds in self.batches:
            self._mark()
            yield ds
            self.losses.append(self.net._score)
        self._mark()

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def pt_rows(n, seed):
    """``(rows, one-hot labels)`` on the card: n binarized 784-wide rows,
    each one of PT_PROTOTYPES seeded patterns (density PT_DENSITY) with
    PT_FLIP of its bits flipped, labelled by its pattern."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    protos = (torch.rand((PT_PROTOTYPES, 784), generator=gen, device="cuda")
              < PT_DENSITY).float()
    idx = torch.randint(0, PT_PROTOTYPES, (n,), generator=gen, device="cuda")
    flip = (torch.rand((n, 784), generator=gen, device="cuda") < PT_FLIP).float()
    return (protos[idx] - flip).abs(), F.one_hot(idx, PT_PROTOTYPES).float()


def pt_batches(rows, labels, start, count):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    return [DataSet(rows[i * PT_BATCH:(i + 1) * PT_BATCH],
                    labels[i * PT_BATCH:(i + 1) * PT_BATCH])
            for i in range(start, start + count)]


def vae_mnist_conf(dtype="float32"):
    """DL4J's VaeMNISTAnomaly network (see PT_BATCH's comment)."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(12345).updater(Adam(1e-3))
            .weight_init("xavier").l2(1e-4).list()
            .layer(L.VariationalAutoencoderLayer(
                **VAE_MNIST, activation="leakyrelu", pzx_activation="identity",
                reconstruction_distribution=L.BernoulliReconstructionDistribution(
                    activation="sigmoid")))
            .set_input_type(InputType.feed_forward(784)).build())
    conf.global_conf.dtype = dtype
    return conf


def pt_net(conf_fn, weights, device=None, dtype="float32", states=None, updater=None):
    """A network of ``conf_fn`` in ``dtype`` on ``device`` (the card by
    default) with the given weights (and layer and updater states)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import (
        load_reference_params,
        load_reference_states,
        load_reference_updater_state,
    )

    conf = conf_fn()
    conf.global_conf.dtype = dtype
    cls = ComputationGraph if hasattr(conf, "vertices") else MultiLayerNetwork
    net = load_reference_params(cls(conf, device=device).init(), weights)
    if states is not None:
        load_reference_states(net, states)
    if updater is not None:
        load_reference_updater_state(net, updater)
    return net


def pt_vae(ck, rows):
    """The VaeMNISTAnomaly network on the card: the timed pretraining run,
    one step against CPU twins, 3 steps against a stock-Adam twin, the
    reconstruction log probability against the CPU's."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import export_params

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = MultiLayerNetwork(vae_mnist_conf()).init()
    weights = export_params(net)
    tensors = tensors_of(net)
    rec = StepRecorder(net, pt_batches(rows, rows, 0, PT_BATCHES))
    zero_launches(ck)
    net.pretrain(rec)
    step_ms = rec.step_ms()
    launches = read_launches(ck)
    losses = [float(v) for v in rec.losses]
    profiled_batches = pt_batches(rows, rows, PT_BATCHES, PT_PROFILED)
    row = {"tensors": tensors, "batch": PT_BATCH, "steps": len(losses),
           "losses": losses, "iteration": net.iteration,
           "median_step_ms": float(np.median(step_ms)),
           "examples_per_s": PT_BATCH / (float(np.median(step_ms)) / 1e3),
           "step_ms": step_ms, "launches": launches,
           **busy(lambda: net.pretrain_layer(0, profiled_batches), PT_PROFILED),
           "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    falling = np.mean(losses[-5:]) < np.mean(losses[:5])
    bad = []
    if not (np.isfinite(losses).all() and falling and net.iteration == 0):
        bad.append("losses")
    if unexpected_launches(launches, {"fused_adam": tensors * PT_BATCHES}):
        bad.append("launches")

    # one step against the CPU twins, the same ε handed to each
    cpu_gen = torch.Generator().manual_seed(17)
    x = rows[:PT_BATCH]
    eps = [("normal", torch.randn((PT_BATCH, VAE_MNIST["n_out"]), generator=cpu_gen))]
    card = pt_net(vae_mnist_conf, weights)
    cpu32 = pt_net(vae_mnist_conf, weights, "cpu")
    cpu64 = pt_net(vae_mnist_conf, weights, "cpu", "float64")
    for twin, xx in ((card, x), (cpu32, x.cpu()), (cpu64, x.cpu())):
        with handed_draws(eps):
            twin.pretrain_layer(0, xx)
    row["one_step"] = {"loss": card.score_, "loss_cpu": cpu32.score_,
                       "params": sl_against_cpu(card.params, cpu32.params, cpu64.params),
                       "slots": sl_against_cpu(card.updater_states, cpu32.updater_states,
                                               cpu64.updater_states)}
    if any(row["one_step"][k]["failing"] for k in ("params", "slots")):
        bad.append("one_step")

    # 3 steps on the fused updater against 3 on stock Adam, both on the card
    fused = pt_net(vae_mnist_conf, weights)
    with handed_draws(eps):
        fused.pretrain_layer(0, [DataSet(x, x)] * 3)
    helpers.clear_helper("updater")
    try:
        stock = pt_net(vae_mnist_conf, weights)
        with handed_draws(eps):
            stock.pretrain_layer(0, [DataSet(x, x)] * 3)
    finally:
        helpers.set_helper("updater", ck.FusedUpdaterHelper())
    got = {**sl_leaves(fused.params, "p"), **sl_leaves(fused.updater_states, "u")}
    want = {**sl_leaves(stock.params, "p"), **sl_leaves(stock.updater_states, "u")}
    worst = max((sl_rel(got[k], want[k]), k) for k in want)
    row["stock_adam_3_steps"] = {"max_rel_diff": list(worst), "limit": PT_TOL}
    if worst[0] > PT_TOL:
        bad.append("stock_adam")

    # the reconstruction log probability, the same draws on both
    xr = rows[-PT_RECON_ROWS:]
    draws = [("normal", torch.randn((PT_RECON_ROWS, VAE_MNIST["n_out"]), generator=cpu_gen))
             for _ in range(PT_RECON_SAMPLES)]
    layer = card.layers[0]
    with torch.no_grad():
        with handed_draws(draws) as h:
            lp = layer.reconstruction_log_probability(card.params[0], xr,
                                                      card.dropout_generator,
                                                      PT_RECON_SAMPLES)
        with handed_draws(draws):
            lp_cpu = layer.reconstruction_log_probability(cpu32.params[0], xr.cpu(),
                                                          cpu32.dropout_generator,
                                                          PT_RECON_SAMPLES)
    row["reconstruction_log_probability"] = {
        "rows": PT_RECON_ROWS, "samples": h.calls, "mean": lp.mean().item(),
        "max_rel_diff": sl_rel(lp, lp_cpu), "limit": PT_TOL}
    if h.calls != PT_RECON_SAMPLES or sl_rel(lp, lp_cpu) > PT_TOL:
        bad.append("reconstruction_log_probability")
    row["ok"] = not bad
    return row, {"pretrain_vae": launches["fused_adam"]}, bad


def dae_conf(graph=False):
    """A stacked denoising autoencoder: AutoEncoder(256) -> AutoEncoder(64)
    -> softmax output (PT_PROTOTYPES), corruption 0.3, Adam(1e-3), as a
    list or as a graph ("ae1", "ae2", "out")."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    ae1 = L.AutoEncoderLayer(n_out=256, corruption_level=0.3)
    ae2 = L.AutoEncoderLayer(n_out=64, corruption_level=0.3)
    out = L.OutputLayer(n_out=PT_PROTOTYPES, loss="mcxent", activation="softmax")
    b = NeuralNetConfiguration.builder().seed(21).updater(Adam(1e-3)).weight_init("xavier")
    if not graph:
        return (b.list().layer(ae1).layer(ae2).layer(out)
                .set_input_type(InputType.feed_forward(784)).build())
    return (b.graph_builder().add_inputs("in").set_input_types(InputType.feed_forward(784))
            .add_layer("ae1", ae1, "in").add_layer("ae2", ae2, "ae1")
            .add_layer("out", out, "ae2").set_outputs("out").build())


def pt_dae(ck, rows, labels):
    """The stacked denoising autoencoder pretrained and fitted on the card
    as a MultiLayerNetwork and as a ComputationGraph from the same weights
    and draws (both networks' dropout generators start from the seed)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import export_params

    mln = MultiLayerNetwork(dae_conf()).init()
    w = export_params(mln)
    names = ("ae1", "ae2", "out")
    graph = pt_net(lambda: dae_conf(True), dict(zip(names, w)))
    batches = pt_batches(rows, labels, 0, PT_AE_BATCHES)
    x, y = rows[:PT_BATCH], labels[:PT_BATCH]
    paths, row = {}, {}
    for key, net in (("mln", mln), ("graph", graph)):
        zero_launches(ck)
        net.pretrain(batches)
        pretrain_loss = net.score_
        fit_losses = []
        for _ in range(PT_FIT_STEPS):
            net.fit(x, y)
            fit_losses.append(net.score_)
        paths[f"pretrain_dae_{key}"] = read_launches(ck)
        row[key] = {"pretrain_loss": pretrain_loss, "fit_losses": fit_losses,
                    "launches": paths[f"pretrain_dae_{key}"]}
    worst = (0.0, "")
    for i, name in enumerate(names):
        for n, t in mln.params[i].items():
            worst = max(worst, (sl_rel(graph.params[name][n], t), f"{name}/{n}"))
            for slot, s in mln.updater_states[i][n].items():
                worst = max(worst, (sl_rel(graph.updater_states[name][n][slot], s),
                                    f"{name}/{n}/{slot}"))
    want = {"fused_adam": 3 * 2 * PT_AE_BATCHES + tensors_of(mln) * PT_FIT_STEPS}
    bad = [k for k in paths if unexpected_launches(paths[k], want)]
    if worst[0] > PT_GRAPH_TOL:
        bad.append("graph_vs_multilayer")
    if not all(np.isfinite(row[k]["fit_losses"]).all() for k in ("mln", "graph")):
        bad.append("losses")
    row.update({"graph_vs_multilayer": list(worst), "limit": PT_GRAPH_TOL,
                "corruption": 0.3, "ok": not bad})
    return row, {p: c["fused_adam"] for p, c in paths.items()}, bad


def wrapper_confs():
    """``{name: conf builder}``: FrozenLayer(Dense 256) -> Dense(128) ->
    softmax; TimeDistributed convolution, pool and global pool over
    PT_TD_SEQ -> RnnOutputLayer; MixtureOfExperts(256, 8 experts, top 2,
    collecting its gates) -> softmax. Adam(1e-3) each."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    def base(seed):
        return NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3)).list()

    out = lambda: L.OutputLayer(n_out=PT_PROTOTYPES, loss="mcxent", activation="softmax")  # noqa: E731
    n, t, h, w, c = PT_TD_SEQ
    return {
        "frozen": lambda: (base(22).layer(L.FrozenLayer(layer=L.DenseLayer(
            n_out=256, activation="relu"))).layer(L.DenseLayer(n_out=128, activation="relu"))
            .layer(out()).set_input_type(InputType.feed_forward(784)).build()),
        "time_distributed": lambda: (base(23).layer(L.TimeDistributedWrapper(
            layer=L.ConvolutionLayer(n_out=8, kernel_size=(3, 3), convolution_mode="same",
                                     activation="relu")))
            .layer(L.TimeDistributedWrapper(layer=L.SubsamplingLayer(kernel_size=(2, 2),
                                                                     stride=(2, 2))))
            .layer(L.TimeDistributedWrapper(layer=L.GlobalPoolingLayer(pooling_type="avg")))
            .layer(L.RnnOutputLayer(n_out=PT_PROTOTYPES, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.recurrent_convolutional(h, w, c, t)).build()),
        "moe": lambda: (base(24).layer(L.MixtureOfExpertsLayer(
            n_out=256, n_experts=8, top_k=2, collect_gates=True)).layer(out())
            .set_input_type(InputType.feed_forward(784)).build()),
    }


def pt_wrapper(ck, name, conf_fn, x, y, carried):
    """PT_FIT_STEPS Adam steps on the card against CPU twins (f32, f64)
    from the same weights, and with ``carried`` from a non-zero Adam state
    of layer 0 (seeded) on all three."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import export_params, export_updater_state

    cpu = MultiLayerNetwork(conf_fn(), device="cpu").init()
    weights, upd = export_params(cpu), export_updater_state(cpu)
    if carried:
        rng = np.random.default_rng(25)
        for slots in upd[0].values():
            slots["m"] = (1e-3 * rng.standard_normal(slots["m"].shape)).astype(np.float32)
            slots["v"] = (1e-6 * rng.random(slots["v"].shape)).astype(np.float32)
    nets = {key: pt_net(conf_fn, weights, dev, dt, updater=upd)
            for key, dev, dt in (("card", None, "float32"), ("cpu32", "cpu", "float32"),
                                 ("cpu64", "cpu", "float64"))}
    for key in ("cpu32", "cpu64"):
        for _ in range(PT_FIT_STEPS):
            nets[key].fit(x.cpu(), y.cpu())
    zero_launches(ck)
    losses = []
    for _ in range(PT_FIT_STEPS):
        nets["card"].fit(x, y)
        losses.append(nets["card"].score_)
    launches = read_launches(ck)
    card = nets["card"]
    row = {"tensors": tensors_of(card), "carried_adam_state": carried, "losses": losses,
           "cpu_losses_f32": nets["cpu32"].score_,
           **{k: sl_against_cpu(getattr(card, a), getattr(nets["cpu32"], a),
                                getattr(nets["cpu64"], a))
              for k, a in (("params", "params"), ("slots", "updater_states"))}}
    bad = [k for k in ("params", "slots") if row[k]["failing"]]
    if name == "frozen":
        still = all(torch.equal(t.cpu(), torch.from_numpy(weights[0][n]))
                    for n, t in card.params[0].items())
        row["frozen_unchanged"] = still
        if still == carried:  # unchanged from a zero state, moved from a carried one
            bad.append("frozen")
    if name == "moe":
        gates = card.states[0]["gates"]
        row["gates"] = {"shape": list(gates.shape),
                        "experts_per_token": sorted(set((gates > 0).sum(-1).tolist()))}
        if row["gates"]["experts_per_token"] != [2]:
            bad.append("gates")
    if unexpected_launches(launches, {"fused_adam": row["tensors"] * PT_FIT_STEPS}):
        bad.append("launches")
    if not np.isfinite(losses).all():
        bad.append("losses")
    row["ok"] = not bad
    return row, launches["fused_adam"], bad


def pretrain_phase(ck, card):
    """Layerwise pretraining, the wrappers and the mixture of experts on
    the card (see the module docstring). Returns K2's launches by path."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers

    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    paths, failures = {}, []
    rows, labels = pt_rows(PT_BATCH * (PT_BATCHES + PT_PROFILED) + PT_RECON_ROWS, seed=17)
    try:
        row, got, bad = pt_vae(ck, rows)
        paths.update(got)
        print("pretrain " + json.dumps({"network": "vae_mnist_anomaly", "card": card,
                                        **VAE_MNIST, **row}), flush=True)
        failures += [f"vae: {b}" for b in bad]
        row, got, bad = pt_dae(ck, rows, labels)
        paths.update(got)
        print("pretrain " + json.dumps({"network": "stacked_denoising_autoencoder",
                                        **row}), flush=True)
        failures += [f"dae: {b}" for b in bad]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(26)
        seq = torch.randn(PT_TD_SEQ, generator=gen, device="cuda")
        seq_y = F.one_hot(torch.randint(0, PT_PROTOTYPES, PT_TD_SEQ[:2], generator=gen,
                                        device="cuda"), PT_PROTOTYPES).float()
        data = {"frozen": (rows[:PT_BATCH], labels[:PT_BATCH]),
                "time_distributed": (seq, seq_y),
                "moe": (rows[:PT_BATCH], labels[:PT_BATCH])}
        for name, conf_fn in wrapper_confs().items():
            for carried in ((False, True) if name == "frozen" else (False,)):
                row, launches, bad = pt_wrapper(ck, name, conf_fn, *data[name], carried)
                key = f"pretrain_{name}" + ("_carried" if carried else "")
                paths[key] = launches
                print("pretrain " + json.dumps({"network": key, **row}), flush=True)
                failures += [f"{key}: {b}" for b in bad]
    finally:
        helpers.clear_helper("updater")
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"pretrain: {failures}")
    return paths


# ------------------------------------------------------------------- yolo
def yolo_scenes(n, size, n_classes, seed):
    """``n`` scenes of example 18's kind at ``size``, on the card: noise,
    then 1 to 3 bright squares each, whose side (32 to 120 pixels) and
    channel encode the class; labels ``[size/32, size/32, 5 + n_classes]``
    (centre and size in absolute grid units, the object flag, one-hot)."""
    rng = np.random.default_rng(seed)
    g = size // 32
    x = rng.normal(0.0, 0.1, size=(n, size, size, 3)).astype(np.float32)
    lab = np.zeros((n, g, g, 5 + n_classes), np.float32)
    for i in range(n):
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(0, n_classes))
            side = min(32 + 8 * (cls % 12), size // 2)
            cy, cx = rng.uniform(side / 2, size - side / 2, 2)
            x[i, int(cy - side / 2):int(cy + side / 2),
              int(cx - side / 2):int(cx + side / 2), cls % 3] += 2.0
            gy, gx = int(cy // 32), int(cx // 32)
            lab[i, gy, gx, :5] = [cx / 32, cy / 32, side / 32, side / 32, 1.0]
            lab[i, gy, gx, 5:] = 0.0
            lab[i, gy, gx, 5 + cls] = 1.0
    return torch.from_numpy(x).cuda(), torch.from_numpy(lab).cuda()


def same_detections(got, want):
    """The two detection lists compared: count, order (example, class),
    the worst difference of a box or confidence."""
    out = {"count": len(got), "count_cpu": len(want)}
    if len(got) != len(want):
        return {**out, "ok": False}
    order = all((a.example, a.predicted_class) == (b.example, b.predicted_class)
                for a, b in zip(got, want))
    worst = max((abs(getattr(a, k) - getattr(b, k)) for a, b in zip(got, want)
                 for k in ("center_x", "center_y", "width", "height", "confidence")),
                default=0.0)
    return {**out, "order_equal": order, "max_diff": worst, "limit": YOLO_DET_TOL,
            "ok": order and worst <= YOLO_DET_TOL}


def yolo_twin(net, x, y):
    """One step's loss and gradients at YOLO_TWIN_BATCH on the card (f32)
    against the same on the CPU in f64 and f32, from ``net``'s weights and
    running statistics (batch statistics in the step)."""
    from deeplearning4j_tpu_torch.util.convert import export_params, export_states
    from deeplearning4j_tpu_torch.zoo.models import TinyYOLO

    weights, states = export_params(net), export_states(net)
    out = {}
    for key, dev, dt in (("card", None, "float32"), ("cpu64", "cpu", "float64"),
                         ("cpu32", "cpu", "float32")):
        twin = pt_net(lambda: TinyYOLO().conf(), weights, dev, dt, states=states)
        inputs, labels, _, _ = twin._batch(twin._wrap(x[:YOLO_TWIN_BATCH].to(twin.device),
                                                      y[:YOLO_TWIN_BATCH].to(twin.device)))
        loss, grads, _ = twin._gradients(inputs, labels, train=True)
        out[key] = (float(loss), torch.cat([g.reshape(-1).double().cpu()
                                            for named in grads.values()
                                            for g in named.values()]))
        del twin, grads
    ref = out["cpu64"][1]
    dist = {k: ((out[k][1] - ref).norm() / ref.norm()).item() for k in ("card", "cpu32")}
    rel = abs(out["card"][0] - out["cpu64"][0]) / abs(out["cpu64"][0])
    return {"batch": YOLO_TWIN_BATCH, "loss": out["card"][0], "loss_cpu_f64": out["cpu64"][0],
            "loss_cpu_f32": out["cpu32"][0], "loss_rel_diff": rel, "limit": YOLO_LOSS_TOL,
            "grad_l2_from_f64": dist["card"], "cpu_f32_grad_l2_from_f64": dist["cpu32"],
            "ok": rel <= YOLO_LOSS_TOL}


def yolo_phase(ck, card, peaks):
    """TinyYOLO and YOLO2 on the card (see the module docstring). Returns
    K2's launches by path."""
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.layers.objdetect import nms
    from deeplearning4j_tpu_torch.zoo.models import YOLO2, TinyYOLO

    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    paths, failures = {}, []
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = TinyYOLO()
        net = model.init()
        tensors = tensors_of(net)
        c, h, w = model.input_shape
        x, y = yolo_scenes(YOLO_BATCH, h, model.num_labels, seed=18)
        zero_launches(ck)
        net.fit(x, y)
        first = net.score_
        step_ms, losses = timed_fits(net, x, y, YOLO_TIMED)
        launches = read_launches(ck)
        paths["yolo_tiny_train"] = launches["fused_adam"]
        median = float(np.median(step_ms))
        flops = cnn_train_flops(net.conf, YOLO_BATCH)
        row = {"model": "TinyYOLO", "card": card, "input": [h, w, c],
               "labels": model.num_labels, "batch": YOLO_BATCH, "tensors": tensors,
               "params": net.conf.num_params(), "first_loss": first, "losses": losses,
               "step_ms": step_ms, "median_step_ms": median,
               "images_per_s": YOLO_BATCH / (median / 1e3), "launches": launches,
               "train_gflop": flops / 1e9, "flop_bound_ms": flops / peaks["f32"] * 1e3,
               "flop_bound_share": flops / peaks["f32"] * 1e3 / median,
               **busy(lambda: [net.fit(x, y) for _ in range(2)], 2),
               "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        bad = []
        if not (math.isfinite(first) and np.isfinite(losses).all() and losses[-1] < first):
            bad.append("losses")
        if unexpected_launches(launches, {"fused_adam": tensors * (1 + YOLO_TIMED)}):
            bad.append("launches")
        # detections from the card's output against the CPU's decode of it
        with torch.no_grad():
            raw = net.output(x)
        torch.cuda.synchronize()
        layer = net.conf.vertices["outputs"].obj
        t0 = time.perf_counter()
        dets = layer.get_predicted_objects(raw, YOLO_CONF, YOLO_NMS)
        decode_ms = (time.perf_counter() - t0) * 1e3
        candidates = layer.get_predicted_objects(raw, YOLO_CONF)
        t0 = time.perf_counter()
        nms(list(candidates), YOLO_NMS)
        nms_ms = (time.perf_counter() - t0) * 1e3
        row["detections"] = {
            "raw_shape": list(raw.shape), "conf": YOLO_CONF, "nms": YOLO_NMS,
            "candidates": len(candidates), "decode_and_nms_host_ms": decode_ms,
            "nms_host_ms": nms_ms,
            **same_detections(dets, layer.get_predicted_objects(raw.cpu(), YOLO_CONF,
                                                                YOLO_NMS))}
        if not row["detections"]["ok"]:
            bad.append("detections")
        row["twin"] = yolo_twin(net, x, y)
        if not row["twin"]["ok"]:
            bad.append("twin")
        row["ok"] = not bad
        print("yolo " + json.dumps(row), flush=True)
        failures += [f"TinyYOLO: {b}" for b in bad]
        del net, raw, x, y

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = YOLO2()
        net = model.init()
        tensors = tensors_of(net)
        c, h, w = model.input_shape
        x, y = yolo_scenes(YOLO2_BATCH, h, model.num_labels, seed=19)
        zero_launches(ck)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(x, y)
        end.record()
        with torch.no_grad():
            raw = net.output(x)
        torch.cuda.synchronize()
        launches = read_launches(ck)
        paths["yolo2_train"] = launches["fused_adam"]
        g = h // 32
        row = {"model": "YOLO2", "input": [h, w, c], "labels": model.num_labels,
               "batch": YOLO2_BATCH, "tensors": tensors, "params": net.conf.num_params(),
               "loss": net.score_, "first_step_ms": start.elapsed_time(end),
               "output_shape": list(raw.shape), "output_finite": bool(raw.isfinite().all()),
               "launches": launches,
               "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        bad = []
        if not (math.isfinite(row["loss"]) and row["output_finite"]
                and row["output_shape"] == [YOLO2_BATCH, g, g, 5 * (5 + model.num_labels)]):
            bad.append("output")
        if unexpected_launches(launches, {"fused_adam": tensors}):
            bad.append("launches")
        row["ok"] = not bad
        print("yolo " + json.dumps(row), flush=True)
        failures += [f"YOLO2: {b}" for b in bad]
        del net, raw, x, y
    finally:
        helpers.clear_helper("updater")
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"yolo: {failures}")
    return paths


# --------------------------------------------------------------- samediff
def sd_images(n, seed):
    """MNIST-shaped images of the verify skill's kind on the card: seeded
    Gaussian noise with row 2 + class raised by 2, and one-hot labels."""
    rng = np.random.default_rng(seed)
    y_idx = rng.integers(0, 10, n)
    x = rng.normal(0, 0.3, size=(n, 28, 28, 1)).astype(np.float32)
    x[np.arange(n), 2 + y_idx, :, 0] += 2.0
    return (torch.from_numpy(x).cuda(),
            torch.from_numpy(np.eye(10, dtype=np.float32)[y_idx]).cuda())


def sd_lenet(weights, device=None):
    """The zoo LeNet's widths in SameDiff ops (NHWC, HWIO), its variables
    the given zoo LeNet weights (``export_params`` layout): conv 5x5 "SAME"
    1 -> 20, max pool 2x2, conv 5x5 "SAME" 20 -> 50, max pool 2x2, a
    reshape to 2450, linear 500 and relu, linear 10; softmax cross
    entropy. 8 variables, 1,256,080 parameters."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    sd = SameDiff.create(device)
    x = sd.place_holder("input", shape=(None, 28, 28, 1))
    y = sd.place_holder("label", shape=(None, 10))
    w = {i: (sd.var(f"w{j}", value=weights[i]["W"]), sd.var(f"b{j}", value=weights[i]["b"]))
         for j, i in enumerate((0, 2, 4, 5))}
    h = sd.nn.conv2d(x, w[0][0], stride=(1, 1), padding="SAME") + w[0][1]
    h = sd.nn.max_pooling2d(h, size=(2, 2), stride=(2, 2))
    h = sd.nn.conv2d(h, w[2][0], stride=(1, 1), padding="SAME") + w[2][1]
    h = sd.nn.max_pooling2d(h, size=(2, 2), stride=(2, 2)).reshape(-1, 2450)
    h = sd.nn.relu(sd.nn.linear(h, *w[4]))
    logits = sd.nn.linear(h, *w[5], name="logits")
    sd.nn.softmax(logits, name="probs")
    sd.loss.softmax_cross_entropy(y, logits, name="loss")
    sd.set_loss_variables("loss")
    return sd


def sd_step_twin(sd, variables, states, ph):
    """One ``fit`` step of ``sd``'s graph on the given tensors (any device
    and dtype; ``SameDiff`` itself takes data in f32): the gradients of
    the summed loss variables, then the updater seam at step 1."""
    from deeplearning4j_tpu_torch.nn.train_step import apply_updates, gradients

    like = next(iter(variables.values()))
    fn = sd._build_fn(sd._loss_variables)
    consts = {k: v.to(like.device, like.dtype if v.is_floating_point() else v.dtype)
              for k, v in sd.constants_map.items()}
    upd = sd._training_config.updater
    _, grads, _ = gradients(
        lambda live: (sum(o.sum() for o in fn(live[""], ph, consts)), None),
        {"": variables})
    apply_updates({"": variables}, grads, {"": {k: upd for k in variables}},
                  {"": states}, 0, 0)


def sd_gradient_reading(sd, x, y):
    """One batch's gradients of ``sd`` (on the card, f32) and of its copy
    on the CPU (f32), each variable's largest difference from the CPU's
    f64 gradients (the lowered function in f64) over their largest entry;
    printed, not held: cuDNN's f32 weight gradients (ROADMAP §C)."""
    import tempfile

    from deeplearning4j_tpu_torch.nn.train_step import gradients

    feed = {"input": x.cpu().numpy(), "label": y.cpu().numpy()}
    card = sd.calculate_gradients(feed)
    with tempfile.TemporaryDirectory() as tmp:
        sd.save(os.path.join(tmp, "g"))
        cpu = type(sd).load(os.path.join(tmp, "g.npz"), device="cpu")
    cpu32 = cpu.calculate_gradients(feed)
    fn = cpu._build_fn(cpu._loss_variables)
    ph = {k: torch.from_numpy(v).double() for k, v in feed.items()}
    _, g64, _ = gradients(
        lambda live: (sum(o.sum() for o in fn(live[""], ph, {})), None),
        {"": {k: v.double() for k, v in cpu.variables_map.items()}})
    out = {}
    for k, ref in g64[""].items():
        ref = ref.numpy()
        scale = float(np.abs(ref).max())
        out[k] = {"card_f32": float(np.abs(card[k] - ref).max()) / scale,
                  "cpu_f32": float(np.abs(cpu32[k] - ref).max()) / scale}
    return out


def sd_trees(variables, states):
    return {"var": variables,
            "m": {k: s["m"] for k, s in states.items()},
            "v": {k: s["v"] for k, s in states.items()}}


def sd_lenet_run(ck, card):
    """The SameDiff LeNet on the card (see the module docstring)."""
    import tempfile

    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.eval import Evaluation
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    from deeplearning4j_tpu_torch.util.convert import export_params
    from deeplearning4j_tpu_torch.zoo import LeNet

    zoo = LeNet().init()
    sd = sd_lenet(export_params(zoo))
    sd.set_training_config(TrainingConfig(Adam(1e-3)))
    n_params = sum(v.numel() for v in sd.variables_map.values())
    x, y = sd_images(SD_BATCH * SD_BATCHES + SD_EVAL, seed=31)
    # the same function as the zoo LeNet: its output on the same weights
    with torch.no_grad():
        zoo_out = zoo.output(x[:SD_BATCH])
    sd_out = sd.output({"input": x[:SD_BATCH]}, "probs")["probs"]
    zoo_diff = float(np.abs(sd_out - zoo_out.cpu().numpy()).max())
    grads_from_f64 = sd_gradient_reading(sd, x[:SD_BATCH], y[:SD_BATCH])
    del zoo
    batches = [DataSet(x[i * SD_BATCH:(i + 1) * SD_BATCH], y[i * SD_BATCH:(i + 1) * SD_BATCH])
               for i in range(SD_BATCHES)]
    events, losses, step = [], [], sd._fit_step

    def timed_step(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss = step(*args)
        end.record()
        events.append((start, end))
        losses.append(loss)
        return loss

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(ck)
    sd._fit_step = timed_step
    try:
        sd.fit(batches)
    finally:
        del sd._fit_step
    torch.cuda.synchronize()
    launches = read_launches(ck)
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(v) for v in losses]
    median = float(np.median(step_ms))
    row = {"network": "samediff_lenet", "card": card, "variables": len(sd.variables_map),
           "params": n_params, "output_max_diff_from_zoo_lenet": zoo_diff,
           "gradients_from_f64": grads_from_f64, "batch": SD_BATCH, "steps": SD_BATCHES, "losses": losses,
           "step_ms": step_ms, "median_step_ms": median,
           "images_per_s": SD_BATCH / (median / 1e3), "launches": launches,
           "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    bad = []
    if (n_params, len(sd.variables_map)) != (SD_LENET_PARAMS, 8):
        bad.append("widths")
    if not (np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        bad.append("losses")
    if unexpected_launches(launches, {"fused_adam": 8 * SD_BATCHES}):
        bad.append("launches")

    # one more step on the card against CPU twins from the same variables
    # and Adam state (f32 within SD_TOL, else the f64 form)
    host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    snap = ({k: host(v) for k, v in sd.variables_map.items()},
            {k: {s: host(t) for s, t in st.items()} for k, st in sd._updater_state.items()})
    xb, yb = batches[0].features, batches[0].labels
    sd.fit(batches[0])
    twins = {}
    for dt in (torch.float32, torch.float64):
        variables = {k: v.to(dt).clone() for k, v in snap[0].items()}
        states = {k: {s: t.to(dt).clone() for s, t in st.items()} for k, st in snap[1].items()}
        sd_step_twin(sd, variables, states, {"input": xb.cpu().to(dt), "label": yb.cpu().to(dt)})
        twins[dt] = sd_trees(variables, states)
    row["twin"] = sl_against_cpu(sd_trees(sd.variables_map, sd._updater_state),
                                 twins[torch.float32], twins[torch.float64])
    if row["twin"]["failing"]:
        bad.append("twin")
    row.update(busy(lambda: [sd.fit(batches[i]) for i in range(2)], 2))

    # the npz on the card: output equal bit for bit; evaluate against
    # Evaluation on the same output
    xe, ye = x[-SD_EVAL:], y[-SD_EVAL:]
    with tempfile.TemporaryDirectory() as tmp:
        sd.save(os.path.join(tmp, "lenet"))
        loaded = type(sd).load(os.path.join(tmp, "lenet.npz"))
    out = sd.output({"input": xe}, "probs")["probs"]
    out_loaded = loaded.output({"input": xe}, "probs")["probs"]
    ev = sd.evaluate(DataSet(xe, ye), "probs")
    ev_ref = Evaluation()
    ev_ref.eval(ye.cpu().numpy(), out)
    row["npz_output_equal"] = bool(np.array_equal(out, out_loaded))
    row["evaluate"] = {"accuracy": ev.accuracy(), "f1": ev.f1(),
                       "equal": bool(ev.accuracy() == ev_ref.accuracy()
                                     and np.array_equal(ev.confusion, ev_ref.confusion))}
    if not (row["npz_output_equal"] and row["evaluate"]["equal"]):
        bad.append("npz or evaluate")
    row["ok"] = not bad
    return row, launches, bad


def sd_control_graph(device, bounded):
    """A bounded (``max_iterations``) or unbounded while loop stopping
    after ``n`` trips and an if_cond, over [SD_CF_ROWS, SD_CF_WIDTH]."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    rng = np.random.default_rng(33)
    sd = SameDiff.create(device)
    x = sd.place_holder("x", shape=(None, SD_CF_WIDTH))
    n = sd.place_holder("n", shape=())
    w = sd.var("w", value=rng.normal(0, 0.05, (SD_CF_WIDTH, SD_CF_WIDTH)))
    r = sd.var("r", value=np.float32(1.1))
    fin = sd.while_loop([sd.constant("i0", np.float32(0.0)), x],
                        lambda s, i, v: s.math.lt(i, n),
                        lambda s, i, v: [i + 1.0, s.math.tanh(v @ w) * r + 0.1],
                        name="loop", max_iterations=bounded)
    br = sd.if_cond(sd.math.gt(fin[1].mean(), 0.0),
                    lambda s: s.math.square(fin[1]) @ w,
                    lambda s: fin[1] - 1.0, name="branch")
    (br.mean() + fin[0]).rename("loss")
    sd.set_loss_variables("loss")
    return sd


def sd_close(got, want):
    """max |got - want| over max(1, max |want|)."""
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def sd_control_run():
    """Control flow on the card against the CPU (see the module docstring)."""
    rng = np.random.default_rng(34)
    xv = rng.normal(size=(SD_CF_ROWS, SD_CF_WIDTH)).astype(np.float32)
    feeds = [{"x": xv, "n": np.float32(5)}, {"x": -np.abs(xv), "n": np.float32(5)}]
    row, bad = {}, []
    for bounded in (SD_CF_BOUND, None):
        card, cpu = sd_control_graph(None, bounded), sd_control_graph("cpu", bounded)
        key = "bounded" if bounded else "unbounded"
        worst = 0.0
        for feed in feeds:
            names = ("branch", "loop_out0", "loss")
            a, b = card.output(feed, *names), cpu.output(feed, *names)
            worst = max([worst] + [sd_close(a[k], b[k]) for k in names])
            if bounded:
                ga, gb = card.calculate_gradients(feed), cpu.calculate_gradients(feed)
                worst = max([worst] + [sd_close(ga[k], gb[k]) for k in gb])
        row[key] = {"max_diff": worst, "limit": SD_CF_TOL}
        if worst > SD_CF_TOL:
            bad.append(key)
    row["shape"] = [SD_CF_ROWS, SD_CF_WIDTH]
    row["ok"] = not bad
    return row, bad


def sd_layer_confs():
    """The zoo LeNet with Adam(1e-3), and the same with its dense 500 a
    ``SameDiffLayer`` subclass computing relu(x @ W + b)."""
    import dataclasses

    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        DenseLayer,
        OutputLayer,
        SameDiffLayer,
        SubsamplingLayer,
        register_layer,
    )
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    @register_layer
    @dataclasses.dataclass
    class SmokeSameDiffDense(SameDiffLayer):
        def define_parameters(self):
            return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

        def define_layer(self, params, x):
            return torch.relu(x @ params["W"] + params["b"])

    def conf(dense):
        b = (NeuralNetConfiguration.builder().seed(123)
                .activation("identity").weight_init("xavier").updater(Adam(1e-3)).list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), convolution_mode="same"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), convolution_mode="same"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
                .layer(dense)
                .layer(OutputLayer(n_out=10, loss="mcxent", activation="softmax"))
                .set_input_type(InputType.convolutional(28, 28, 1)))
        if isinstance(dense, SameDiffLayer):
            # a SameDiffLayer asks for no flatten: DenseLayer's own one
            b.input_pre_processor(4, "cnn_to_ff")
        return b.build()

    return (lambda: conf(DenseLayer(n_out=500, activation="relu")),
            lambda: conf(SmokeSameDiffDense(n_out=500)))


def sd_layer_run(ck):
    """3 Adam steps of the SameDiffLayer LeNet against the zoo LeNet's from
    the same weights, both on the card."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params

    plain_conf, sd_conf = sd_layer_confs()
    plain = MultiLayerNetwork(plain_conf()).init()
    net = load_reference_params(MultiLayerNetwork(sd_conf()).init(), export_params(plain))
    x, y = sd_images(SD_BATCH, seed=35)
    zero_launches(ck)
    for _ in range(SD_LAYER_STEPS):
        net.fit(x, y)
    launches = read_launches(ck)
    for _ in range(SD_LAYER_STEPS):
        plain.fit(x, y)
    worst = max(max_rel_diff(net.params, plain.params),
                max_rel_diff(net.updater_states, plain.updater_states))
    row = {"network": "samediff_layer_lenet", "steps": SD_LAYER_STEPS, "launches": launches,
           "layer": type(net.layers[4]).__name__, "max_rel_diff": worst,
           "limit": SD_LAYER_TOL, "loss": net.score_, "loss_zoo": plain.score_}
    bad = []
    if worst > SD_LAYER_TOL:
        bad.append("against the zoo LeNet")
    if unexpected_launches(launches, {"fused_adam": 8 * SD_LAYER_STEPS}):
        bad.append("launches")
    row["ok"] = not bad
    return row, launches, bad


def samediff_phase(ck, card):
    """SameDiff on the card (see the module docstring). Returns each
    path's launches."""
    from deeplearning4j_tpu_torch.nn import helpers

    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    paths, failures = {}, []
    try:
        row, paths["samediff_lenet_fit"], bad = sd_lenet_run(ck, card)
        print("samediff " + json.dumps(row), flush=True)
        failures += [f"lenet: {b}" for b in bad]
        row, bad = sd_control_run()
        print("samediff " + json.dumps({"network": "control_flow", **row}), flush=True)
        failures += [f"control flow: {b}" for b in bad]
        row, paths["samediff_layer_fit"], bad = sd_layer_run(ck)
        print("samediff " + json.dumps(row), flush=True)
        failures += [f"layer: {b}" for b in bad]
    finally:
        helpers.clear_helper("updater")
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"samediff: {failures}")
    return paths


# --------------------------------------------------------------- transfer
def tr_images(n, seed):
    """224x224x3 images of TR_CLASSES classes on the card: noise, and a
    bright square whose position and channel encode the class."""
    rng = np.random.default_rng(seed)
    y_idx = rng.integers(0, TR_CLASSES, n)
    x = rng.normal(0.0, 0.5, size=(n, 224, 224, 3)).astype(np.float32)
    for i, c in enumerate(y_idx):
        x[i, 40 * c:40 * c + 40, 40 * c:40 * c + 40, c % 3] += 2.0
    return (torch.from_numpy(x).cuda(),
            torch.from_numpy(np.eye(TR_CLASSES, dtype=np.float32)[y_idx]).cuda())


def tr_pretrained(tmp):
    """The zoo's LeNet zip written into a cache, registered with its
    Adler32 and SHA-256, and restored through a file:// URL on the card:
    ``output`` equal bit for bit."""
    import hashlib
    import pathlib
    import zlib

    from deeplearning4j_tpu_torch.zoo import LeNet

    src = LeNet().init()
    origin = pathlib.Path(tmp) / "origin" / "lenet.zip"
    origin.parent.mkdir()
    src.save(str(origin))
    blob = origin.read_bytes()
    model = LeNet()
    model.PRETRAINED_URLS = {"mnist": origin.as_uri()}
    model.PRETRAINED_CHECKSUMS = {"mnist": zlib.adler32(blob)}
    model.PRETRAINED_SHA256 = {"mnist": hashlib.sha256(blob).hexdigest()}
    t0 = time.perf_counter()
    net = model.init_pretrained("mnist")
    seconds = time.perf_counter() - t0
    x, _ = sd_images(64, seed=36)
    equal = bool(torch.equal(net.output(x), src.output(x)))
    return {"model": "LeNet", "zip_mb": len(blob) / 1e6, "restore_s": seconds,
            "fetched_into_cache": os.path.exists(model._cache_path("mnist")),
            "device": str(net.device), "output_equal": equal, "ok": equal}


def tr_head_twin(helper, feats, ck):
    """``fit_featurized`` TR_STEPS times on the card and on CPU twins of
    the head (f32 and f64) fed the same features: parameters and Adam
    slots in the small-layer form (``sl_against_cpu``)."""
    import copy

    from deeplearning4j_tpu_torch.util.convert import export_params

    head = helper.unfrozen_mln
    weights = export_params(head)
    twins = {dt: pt_net(lambda: copy.deepcopy(head.conf), weights, "cpu", dt)
             for dt in ("float32", "float64")}
    zero_launches(ck)
    for _ in range(TR_STEPS):
        helper.fit_featurized(feats)
    launches = read_launches(ck)
    for twin in twins.values():
        for _ in range(TR_STEPS):
            twin.fit(feats.features.cpu(), feats.labels.cpu())
    tree = lambda net: {"params": net.params, "state": net.updater_states}  # noqa: E731
    got = sl_against_cpu(tree(head), tree(twins["float32"]), tree(twins["float64"]))
    return {"features": list(feats.features.shape), "head_tensors": tensors_of(head),
            "launches": launches, **got, "limit": SL_TOL,
            "ok": not got["failing"] and not unexpected_launches(
                launches, {"fused_adam": tensors_of(head) * TR_STEPS})}, launches


def tr_labels(tmp, out):
    """ImageNetLabels from a JSON written here; ``decode_predictions`` of
    the card's output against the CPU's decode of the same output."""
    from deeplearning4j_tpu_torch.zoo import ImageNetLabels

    path = os.path.join(tmp, "imagenet_class_index.json")
    with open(path, "w") as fh:
        json.dump({str(i): [f"n{i:08d}", f"class_{i}"] for i in range(1000)}, fh)
    labels = ImageNetLabels(path)
    got = labels.decode_predictions(out, top=5)
    want = labels.decode_predictions(out.cpu().numpy(), top=5)
    same = [[(c.number, c.probability) for c in r] for r in got] == [
        [(c.number, c.probability) for c in r] for r in want]
    return {"rows": len(got), "top1": [r[0].label for r in got[:4]], "equal": same,
            "ok": same}


def transfer_phase(ck, card):
    """The zoo's pretrained path and VGG16 fine-tuning on the card (see
    the module docstring). Returns each path's launches."""
    import tempfile

    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.conf import (
        MemoryUseMode,
        compiled_memory_analysis,
        network_memory_report,
    )
    from deeplearning4j_tpu_torch.nn.layers import FrozenLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration,
        TransferLearning,
        TransferLearningHelper,
    )
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.zoo import VGG16

    paths, failures = {}, []
    saved_dir = os.environ.get("DL4J_TPU_ZOO_DIR")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    os.environ["DL4J_TPU_ZOO_DIR"] = os.path.join(tmp, "zoo")
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        row = tr_pretrained(tmp)
        print("transfer " + json.dumps({"path": "init_pretrained", **row}), flush=True)
        if not row["ok"]:
            failures.append("init_pretrained")

        torch.cuda.empty_cache()
        source = VGG16().init()
        before = {k: {n: t.clone() for n, t in v.items()} for k, v in source.params.items()}
        net = (TransferLearning.Builder(source)
               .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-4), seed=123))
               .set_feature_extractor(TR_FROZEN_TILL)
               .remove_output_layer()
               .add_layer(OutputLayer(n_out=TR_CLASSES, activation="softmax", loss="mcxent"))
               .build())
        frozen = [i for i, layer in enumerate(net.layers) if isinstance(layer, FrozenLayer)]
        start = {k: {n: t.clone() for n, t in v.items()} for k, v in net.params.items()}
        x, y = tr_images(TR_BATCH * 2, seed=37)
        xb, yb = x[:TR_BATCH], y[:TR_BATCH]
        torch.cuda.reset_peak_memory_stats()
        zero_launches(ck)
        step_ms, losses = timed_fits(net, xb, yb, TR_STEPS)
        launches = read_launches(ck)
        paths["transfer_vgg16_fine_tune"] = launches
        peak = torch.cuda.max_memory_allocated()
        median = float(np.median(step_ms))
        frozen_equal = all(torch.equal(net.params[i][n], start[i][n])
                           for i in frozen for n in start[i])
        head = len(net.layers) - 1
        head_moved = all(not torch.equal(net.params[head][n], start[head][n])
                         for n in start[head])
        source_equal = all(torch.equal(source.params[k][n], t)
                           for k, v in before.items() for n, t in v.items())
        del before, start
        report = network_memory_report(net.conf, "VGG16-fine-tune")
        row = {"path": "vgg16_fine_tune", "card": card, "batch": TR_BATCH,
               "classes": TR_CLASSES, "frozen_layers": len(frozen),
               "tensors": tensors_of(net), "params": net.conf.num_params(),
               "losses": losses, "step_ms": step_ms, "median_step_ms": median,
               "images_per_s": TR_BATCH / (median / 1e3), "launches": launches,
               "frozen_unchanged": frozen_equal, "head_moved": head_moved,
               "source_unchanged": source_equal, "peak_device_mem_gb": peak / 1e9,
               "forecast_training_gb": report.get_total_memory_bytes(
                   TR_BATCH, MemoryUseMode.TRAINING) / 1e9,
               **busy(lambda: [net.fit(xb, yb) for _ in range(2)], 2)}
        # after the counts: its step launches K2 on copies of the tensors
        row["compiled_memory_analysis"] = compiled_memory_analysis(net, batch=TR_BATCH)
        bad = [k for k in ("frozen_unchanged", "head_moved", "source_unchanged") if not row[k]]
        if not np.isfinite(losses).all():
            bad.append("losses")
        if unexpected_launches(launches, {"fused_adam": tensors_of(net) * TR_STEPS}):
            bad.append("launches")
        row["ok"] = not bad
        print("transfer " + json.dumps(row), flush=True)
        failures += [f"vgg16: {b}" for b in bad]

        helper = TransferLearningHelper(net, frozen_till=TR_FROZEN_TILL)
        feats = helper.featurize(DataSet(x[TR_BATCH:], y[TR_BATCH:]))
        row, paths["transfer_featurized_head"] = tr_head_twin(helper, feats, ck)
        print("transfer " + json.dumps({"path": "featurized_head", **row}), flush=True)
        if not row["ok"]:
            failures.append("featurized head")

        with torch.no_grad():
            out = source.output(xb)
        row = tr_labels(tmp, out)
        print("transfer " + json.dumps({"path": "imagenet_labels", **row}), flush=True)
        if not row["ok"]:
            failures.append("labels")
        del source, net, helper, out
    finally:
        helpers.clear_helper("updater")
        if saved_dir is None:
            os.environ.pop("DL4J_TPU_ZOO_DIR", None)
        else:
            os.environ["DL4J_TPU_ZOO_DIR"] = saved_dir
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"transfer: {failures}")
    return paths


# ----------------------------------------------------------- checkpointing
def ck_gpt2(checkpointing, weights=None, attn_dropout=0.0):
    """GPT-2-small (f32, Adam(3e-4)) with or without gradient
    checkpointing, from ``weights`` where given."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import load_reference_params
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    conf = TransformerLM(attn_dropout=attn_dropout).conf()
    conf.global_conf.gradient_checkpointing = checkpointing
    net = ComputationGraph(conf).init(seed=123)
    return net if weights is None else load_reference_params(net, weights)


def ck_grads(net, x, labels):
    """One batch's train-mode loss and gradients."""
    inputs, targets, _, _ = net._batch(net._wrap(x, labels))
    loss, grads, _ = net._gradients(inputs, targets, train=True)
    torch.cuda.synchronize()
    return float(loss), grads


def ck_compare(loss_a, grads_a, loss_b, grads_b):
    rel = abs(loss_a - loss_b) / abs(loss_b)
    name, worst = worst_gradient(grads_a, grads_b)
    return {"loss": loss_a, "loss_plain": loss_b, "loss_rel": rel,
            "worst_grad": name, "worst_grad_rel_to_max": worst, "limit": CK_TOL,
            "ok": rel <= CK_TOL and worst <= CK_TOL}


def ck_host(grads):
    return {k: {n: g.cpu() for n, g in v.items()} for k, v in grads.items()}


def ck_gpt2_pair(ck, card, x, labels):
    """GPT-2-small plain and checkpointed from the same weights: CK_STEPS
    timed fits each (launches, peak memory), then one batch's train-mode
    gradients from the starting weights."""
    from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params

    row, paths, bad, grads, weights = {"card": card, "batch": [TRAIN_N, T]}, {}, [], {}, None
    for checkpointing in (False, True):
        torch.cuda.empty_cache()
        net = ck_gpt2(checkpointing, weights)
        if weights is None:
            weights = export_params(net)
        n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
        key = "checkpointed" if checkpointing else "plain"
        torch.cuda.reset_peak_memory_stats()
        zero_launches(ck)
        step_ms, losses = timed_fits(net, x, labels, CK_STEPS)
        launches = read_launches(ck)
        peak = torch.cuda.max_memory_allocated()
        # K3a runs again in each layer's recompute
        want = {"flash_attention_fwd": (1 + checkpointing) * n_layers * CK_STEPS,
                "flash_attention_bwd_dq": n_layers * CK_STEPS,
                "flash_attention_bwd_dkv": n_layers * CK_STEPS,
                "fused_adam": tensors_of(net) * CK_STEPS}
        paths[f"checkpointing_gpt2_{key}_train"] = launches
        row[key] = {"losses": losses, "step_ms": step_ms,
                    "median_step_ms": float(np.median(step_ms)), "launches": launches,
                    "launches_per_step": {k: v // CK_STEPS for k, v in launches.items()},
                    "peak_device_mem_gb": peak / 1e9}
        if unexpected_launches(launches, want):
            bad.append(f"{key} launches")
        if not np.isfinite(losses).all():
            bad.append(f"{key} losses")
        load_reference_params(net, weights)
        loss, g = ck_grads(net, x, labels)
        grads[key] = (loss, ck_host(g))
        del net, g
    row["parity"] = ck_compare(*grads["checkpointed"], *grads["plain"])
    if not row["parity"]["ok"]:
        bad.append("gradients")
    if not row["checkpointed"]["peak_device_mem_gb"] < row["plain"]["peak_device_mem_gb"]:
        bad.append("peak")
    return row, paths, bad


def ck_dropout_pair(x, labels):
    """The pair with attention dropout (the plain attention path): both from
    the same weights and dropout-generator state."""
    from deeplearning4j_tpu_torch.util.convert import export_params

    torch.cuda.empty_cache()
    plain = ck_gpt2(False, attn_dropout=GPT2_DROPOUT)
    state = plain.dropout_generator.get_state()
    loss_p, grads_p = ck_grads(plain, x, labels)
    grads_p = ck_host(grads_p)
    weights = export_params(plain)
    del plain
    torch.cuda.empty_cache()
    net = ck_gpt2(True, weights, attn_dropout=GPT2_DROPOUT)
    net.dropout_generator.set_state(state)
    loss_c, grads_c = ck_grads(net, x, labels)
    grads_c = ck_host(grads_c)
    del net
    return ck_compare(loss_c, grads_c, loss_p, grads_p)


def ck_remat_memory():
    """The reference's remat case (12 x Dense(512, tanh), output 8, input
    64, batch 256): compiled_memory_analysis with and without
    checkpointing."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
        compiled_memory_analysis,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    out = {}
    for remat in (False, True):
        b = NeuralNetConfiguration.builder().seed(1).gradient_checkpointing(remat).list()
        for _ in range(12):
            b.layer(DenseLayer(n_out=512, activation="tanh"))
        conf = b.layer(OutputLayer(n_out=8)).set_input_type(InputType.feed_forward(64)).build()
        out["remat" if remat else "plain"] = compiled_memory_analysis(
            MultiLayerNetwork(conf).init(), batch=256)
    out["ok"] = all(v.get("total", 0) > 0 for v in out.values())
    return out


def checkpointing_phase(ck, card):
    """Gradient checkpointing on the card (see the module docstring).
    Returns each path's launches."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers

    rng = np.random.default_rng(123)
    ids = torch.from_numpy(rng.integers(0, 50257, (TRAIN_N, T))).cuda()
    x = ids.float()
    labels = F.one_hot(torch.cat([ids[:, 1:], ids[:, -1:]], 1), 50257).float()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    failures = []
    try:
        row, paths, bad = ck_gpt2_pair(ck, card, x, labels)
        row["ok"] = not bad
        print("checkpointing " + json.dumps({"network": "gpt2_small", **row}), flush=True)
        failures += bad
    finally:
        helpers.clear_helper("updater")
        torch.cuda.empty_cache()
    row = ck_dropout_pair(x, labels)
    print("checkpointing " + json.dumps({"network": "gpt2_small_attn_dropout",
                                         "attn_dropout": GPT2_DROPOUT, **row}), flush=True)
    if not row["ok"]:
        failures.append("dropout gradients")
    del x, labels
    torch.cuda.empty_cache()
    row = ck_remat_memory()
    print("checkpointing " + json.dumps({"network": "remat_12x_dense512_batch256", **row}),
          flush=True)
    if not row["ok"]:
        failures.append("remat memory")
    if failures:
        raise RuntimeError(f"checkpointing: {failures}")
    return paths


def dl4j_import_phase(ck, card):
    """The DL4J-format fixtures restored on the card; the convnet one fits
    DL4J_FIT_STEPS more steps from its restored Adam state on the fused
    updater. Returns the five kernels' launches in that fit."""
    import warnings

    from deeplearning4j_tpu_torch.modelimport.dl4j import (
        restore_computation_graph, restore_multi_layer_network)
    from deeplearning4j_tpu_torch.nn import helpers

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    errors, restore_s = {}, {}
    for name in DL4J_FIXTURES:
        path = os.path.join(fixtures, f"dl4j_checkpoint_{name}.zip")
        exp = np.load(os.path.join(fixtures, f"dl4j_checkpoint_{name}_expected.npz"))
        restore = (restore_computation_graph if "graph" in name
                   else restore_multi_layer_network)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no order warning for these
            net = restore(path, device="cuda")
        restore_s[name] = time.perf_counter() - t0
        out = net.output(exp["x"])
        if not out.is_cuda:
            raise RuntimeError(f"DL4J {name}: output not on the card")
        got = out.cpu().numpy()
        errors[name] = float(np.abs(got - exp["out"]).max())
        np.testing.assert_allclose(got, exp["out"], rtol=DL4J_RTOL,
                                   atol=DL4J_ATOL, err_msg=f"DL4J {name}")
        if name == "convnet":
            convnet = net
    n_tensors = tensors_of(convnet)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8, 8, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        it0 = convnet.iteration
        losses = []
        zero_launches(ck)
        for _ in range(DL4J_FIT_STEPS):
            convnet.fit(x, y)
            losses.append(convnet.score_)
        torch.cuda.synchronize()
        launches = read_launches(ck)
    finally:
        helpers.clear_helper("updater")
    want = {"fused_adam": DL4J_CONVNET_TENSORS * DL4J_FIT_STEPS}
    if not (n_tensors == DL4J_CONVNET_TENSORS
            and not unexpected_launches(launches, want)
            and convnet.iteration == it0 + DL4J_FIT_STEPS
            and np.isfinite(losses).all()):
        raise RuntimeError(f"DL4J convnet fit: launches {launches} for "
                           f"{n_tensors} tensors, losses {losses}")
    stats = {"card": card, "max_abs_err": errors, "restore_s": restore_s,
             "convnet_fit_steps": DL4J_FIT_STEPS, "convnet_fit_losses": losses,
             "convnet_launches": launches,
             "convnet_k2_launches_per_step": launches["fused_adam"] // DL4J_FIT_STEPS,
             "convnet_running_mean": convnet.states[1]["mean"].tolist()}
    print("dl4j_import " + json.dumps(stats), flush=True)
    return launches


def tensor_leaves(tree):
    """The tensors of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in tensor_leaves(tree[k])]
    return [tree]


def max_rel_diff(got, want):
    """The worst matching tensor's largest difference over its largest
    entry in ``want`` (two trees of one layout)."""
    worst = 0.0
    for a, b in zip(tensor_leaves(got), tensor_leaves(want), strict=True):
        scale = max(b.float().abs().max().item(), 1e-30)
        worst = max(worst, (a.float() - b.float()).abs().max().item() / scale)
    return worst


def timed_window(net, window):
    """``net.fit_batches_on_device(window)`` with a CUDA event at each
    step's start and one at the window's end; from the first step to the
    window's end under ``torch.cuda.set_sync_debug_mode("error")`` (no host
    synchronisation between steps). Returns each step's ms."""
    events, step = [], net._train_step

    def timed_step(*args):
        torch.cuda.set_sync_debug_mode("error")
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return step(*args)

    net._train_step = timed_step
    try:
        net.fit_batches_on_device(window)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del net._train_step
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]


def timed_per_batch(net, window):
    """One ``fit`` call a batch of ``window``, each between two CUDA
    events; returns each call's ms."""
    events = []
    for ds in window:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(ds)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def busy(run, steps):
    """Wall ms (host clock to a synchronize) and device ms a step of
    ``run()`` under torch.profiler (device activity only), and their
    ratio."""
    _, wall_ms, by_kernel = profiled(run, cpu=False)
    wall_ms, device_ms = wall_ms / steps, sum(by_kernel.values()) / steps
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms}


def window_against_clone(ck, net, twin, window, name, want, paths):
    """The window on ``net`` and one fit a batch on ``twin`` (its clone
    from before the window), each path's launches counted; returns the
    readings (step ms, differences, generator equality) and the failures."""
    zero_launches(ck)
    window_ms = timed_window(net, window)
    paths[f"network_api_{name}_window"] = read_launches(ck)
    zero_launches(ck)
    fit_ms = timed_per_batch(twin, window)
    paths[f"network_api_{name}_fits"] = read_launches(ck)
    out = {"window_step_ms": window_ms, "fit_ms": fit_ms,
           "median_window_step_ms": float(np.median(window_ms)),
           "median_fit_ms": float(np.median(fit_ms)),
           "params_max_rel_diff": max_rel_diff(net.params, twin.params),
           "updater_state_max_rel_diff": max_rel_diff(net.updater_states,
                                                      twin.updater_states),
           "generators_equal": bool(torch.equal(net.dropout_generator.get_state(),
                                                twin.dropout_generator.get_state())),
           "iterations": [net.iteration, twin.iteration]}
    failures = [f"{name} {p}: {paths[f'network_api_{name}_{p}']}, expected {want}"
                for p in ("window", "fits")
                if unexpected_launches(paths[f"network_api_{name}_{p}"], want)]
    if not (out["params_max_rel_diff"] <= NA_WINDOW_TOL
            and out["updater_state_max_rel_diff"] <= NA_WINDOW_TOL
            and out["generators_equal"] and net.iteration == twin.iteration):
        failures.append(f"{name}: window against per-batch fit {out}")
    return out, failures


def network_api_phase(ck, card):
    """The networks' remaining API at full width (see the module
    docstring). Returns each path's launches by kernel."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.eval import (Evaluation, EvaluationCalibration,
                                               RegressionEvaluation, ROCBinary,
                                               ROCMultiClass)
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import LSTMLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.train_step import regularization, to_host
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    paths, stats, failures, seconds = {}, {"card": card}, [], {}
    stats["seconds"] = seconds
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        # (a) GPT-2-small in bf16: a window of NA_WINDOW batches (ids on the
        # host, one-hot labels on the card) against a clone's fit calls
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        conf = TransformerLM().conf()
        conf.global_conf.compute_dtype = "bfloat16"
        net = ComputationGraph(conf).init()
        twin = net.clone()
        vocab = net.conf.vertices["embed"].obj.n_in
        n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
        rng = np.random.default_rng(15)
        ids = [rng.integers(0, vocab, (TRAIN_N, T)) for _ in range(NA_WINDOW)]
        window = [DataSet(i, F.one_hot(torch.from_numpy(np.roll(i, -1, 1)).cuda(),
                                       vocab).float()) for i in ids]
        want = {"flash_attention_fwd_bf16": n_layers * NA_WINDOW,
                "flash_attention_bwd_dq_bf16": n_layers * NA_WINDOW,
                "flash_attention_bwd_dkv_bf16": n_layers * NA_WINDOW,
                "fused_adam": tensors_of(net) * NA_WINDOW}
        stats["gpt2_bf16"], bad = window_against_clone(ck, net, twin, window, "gpt2",
                                                       want, paths)
        failures += bad
        stats["gpt2_bf16"]["window_profiled"] = busy(
            lambda: net.fit_batches_on_device(window), NA_WINDOW)
        stats["gpt2_bf16"]["fits_profiled"] = busy(
            lambda: [twin.fit(ds) for ds in window], NA_WINDOW)
        del net, twin, window
        seconds["a_gpt2_bf16"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # (b) the bf16 char-RNN on standard LSTMs: the same check, then
        # to_computation_graph, two more steps on both, the evaluators
        torch.cuda.empty_cache()
        net = MultiLayerNetwork(lstm_bf16_conf(LSTMLayer)).init()
        twin = net.clone()
        eye = np.eye(LB_VOCAB, dtype=np.float32)
        chars = np.random.default_rng(16).integers(
            0, LB_VOCAB, (NA_WINDOW + NA_GRAPH_FITS, LB_BATCH, LB_T))
        batches = [DataSet(eye[c], eye[np.roll(c, -1, 1)]) for c in chars]
        window = batches[:NA_WINDOW]
        want = {"lstm_sequence_bf16": 2 * NA_WINDOW, "fused_adam": LB_TENSORS * NA_WINDOW}
        rnn, bad = window_against_clone(ck, net, twin, window, "char_rnn", want, paths)
        failures += bad
        del twin
        graph = net.to_computation_graph()
        x = batches[0].features
        zero_launches(ck)
        g_out = graph.output(x)
        torch.cuda.synchronize()
        paths["network_api_char_rnn_graph_output"] = read_launches(ck)
        n_out = net.output(x)
        rnn["graph_output_max_abs_diff"] = (g_out.float() - n_out.float()).abs().max().item()
        rnn["graph_output_limit"] = NA_GRAPH_OUT_TOL * max(1.0, n_out.float().abs().max().item())
        zero_launches(ck)
        for ds in batches[NA_WINDOW:]:
            graph.fit(ds)
        torch.cuda.synchronize()
        paths["network_api_char_rnn_graph_fits"] = read_launches(ck)
        for ds in batches[NA_WINDOW:]:
            net.fit(ds)
        names = [vd.name for vd in graph.conf.layer_vertices()]
        rnn["graph_fits_params_max_rel_diff"] = max_rel_diff(
            {i: graph.params[n] for i, n in enumerate(names)}, net.params)
        rnn["graph_fits_updater_state_max_rel_diff"] = max_rel_diff(
            {i: graph.updater_states[n] for i, n in enumerate(names)}, net.updater_states)
        lmask = (np.random.default_rng(17).random((LB_BATCH, LB_T)) > 0.25).astype(np.float32)
        ev_ds = DataSet(batches[0].features, batches[0].labels, None, lmask)
        zero_launches(ck)
        ev = net.evaluate(ev_ds)
        roc = net.evaluate_roc_multi_class(ev_ds)
        torch.cuda.synchronize()
        paths["network_api_char_rnn_evaluate"] = read_launches(ck)
        out = to_host(net.output(x))
        host_ev, host_roc = Evaluation(), ROCMultiClass()
        host_ev.eval(ev_ds.labels, out, mask=lmask)
        host_roc.eval(ev_ds.labels, out, mask=lmask)
        present = [c for c in range(LB_VOCAB) if (ev_ds.labels[lmask > 0][:, c] > 0).any()
                   and (ev_ds.labels[lmask > 0][:, c] == 0).any()]
        aucs = [roc.calculate_auc(c) for c in range(LB_VOCAB)]
        rnn["evaluate_equals_host"] = bool(
            np.array_equal(ev.confusion_matrix(), host_ev.confusion_matrix())
            and ev.stats() == host_ev.stats()
            and aucs == [host_roc.calculate_auc(c) for c in range(LB_VOCAB)])
        t1 = time.perf_counter()
        f32_conf = lstm_bf16_conf(LSTMLayer)
        f32_conf.global_conf.compute_dtype = None
        cpu = load_reference_params(MultiLayerNetwork(f32_conf, device="cpu").init(),
                                    export_params(net))
        cpu_roc, cpu_ev = cpu.evaluate_roc_multi_class(ev_ds), cpu.evaluate(ev_ds)
        seconds["b_f32_cpu_twin"] = time.perf_counter() - t1
        cpu_aucs = [cpu_roc.calculate_auc(c) for c in range(LB_VOCAB)]
        rnn.update({
            "accuracy_bf16_card": ev.accuracy(), "accuracy_f32_cpu": cpu_ev.accuracy(),
            "classes_with_both_labels": len(present),
            "mean_auc_bf16_card": float(np.mean([aucs[c] for c in present])),
            "mean_auc_f32_cpu": float(np.mean([cpu_aucs[c] for c in present])),
            "max_auc_diff_bf16_card_f32_cpu": float(max(abs(aucs[c] - cpu_aucs[c])
                                                        for c in present))})
        rnn["iterations_graph_network"] = [graph.iteration, net.iteration]
        if not (rnn["graph_output_max_abs_diff"] <= rnn["graph_output_limit"]
                and rnn["graph_fits_params_max_rel_diff"] <= NA_GRAPH_STEP_TOL
                and rnn["graph_fits_updater_state_max_rel_diff"] <= NA_GRAPH_STEP_TOL
                and rnn["evaluate_equals_host"] and graph.iteration == net.iteration):
            failures.append(f"char_rnn to_computation_graph and evaluators: {rnn}")
        rnn["window_profiled"] = busy(lambda: net.fit_batches_on_device(window), NA_WINDOW)
        rnn["fits_profiled"] = busy(lambda: [net.fit(ds) for ds in window], NA_WINDOW)
        stats["char_rnn_bf16"] = rnn
        seconds["b_char_rnn"] = time.perf_counter() - t0
        del net, graph, cpu, g_out, n_out
        t0 = time.perf_counter()

        # (c) GPT-2-small f32: score_examples at 8 x 1024 against each
        # example's score alone
        torch.cuda.empty_cache()
        net = TransformerLM().init()
        rng = np.random.default_rng(18)
        ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_N, T))).cuda()
        labels = F.one_hot(torch.roll(ids, -1, 1), vocab).float()
        zero_launches(ck)
        plain = net.score_examples(DataSet(ids, labels))
        torch.cuda.synchronize()
        paths["network_api_score_examples"] = read_launches(ck)
        with_reg = net.score_examples(DataSet(ids, labels), add_regularization=True)
        reg = float(regularization(net._named_layers(), net.params))
        alone = np.array([net.score(DataSet(ids[i:i + 1], labels[i:i + 1]))
                          for i in range(TRAIN_N)])
        se = {"scores": plain.tolist(), "alone": alone.tolist(), "regularization": reg,
              "max_rel_diff": float(np.max(np.abs(plain - (alone - reg))
                                           / np.abs(alone - reg))),
              "max_rel_diff_with_regularization": float(np.max(np.abs(with_reg - alone)
                                                               / np.abs(alone)))}
        stats["score_examples_f32"] = se
        if not (se["max_rel_diff"] <= NA_SCORE_RTOL
                and se["max_rel_diff_with_regularization"] <= NA_SCORE_RTOL
                and plain.shape == (TRAIN_N,)):
            failures.append(f"score_examples: {se}")
        del net, labels
        seconds["c_score_examples"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # (d) the regularized LeNet: clone, set_learning_rate, the flat
        # round trip, the evaluators over output
        torch.cuda.empty_cache()
        x, y = lenet_data()
        b0, b1 = DataSet(x[:LENET_BATCH], y[:LENET_BATCH]), DataSet(
            x[LENET_BATCH:2 * LENET_BATCH], y[LENET_BATCH:2 * LENET_BATCH])
        le = {}
        torch.backends.cudnn.deterministic = True
        try:
            net = MultiLayerNetwork(lenet_conf(regularized=True)).init()
            net.fit(b0)
            clone = net.clone()
            zero_launches(ck)
            net.fit(b1)
            clone.fit(b1)
            torch.cuda.synchronize()
            paths["network_api_lenet_clone_fits"] = read_launches(ck)
            le["clone_params_max_rel_diff"] = max_rel_diff(clone.params, net.params)
            le["clone_generators_equal"] = bool(torch.equal(
                clone.dropout_generator.get_state(), net.dropout_generator.get_state()))
            lr = net._updaters[0]["W"].learning_rate / 10
            net.set_learning_rate(lr)
            stock = net.clone()
            zero_launches(ck)
            net.fit(b0)
            torch.cuda.synchronize()
            paths["network_api_lenet_new_rate"] = read_launches(ck)
            helpers.clear_helper("updater")
            stock.fit(b0)
            helpers.set_helper("updater", ck.FusedUpdaterHelper())
            le["new_rate"] = lr
            le["new_rate_everywhere"] = all(
                u.learning_rate == lr for named in net._updaters.values()
                for u in named.values())
            le["new_rate_params_max_rel_diff_stock_adam"] = max_rel_diff(net.params,
                                                                         stock.params)
            ptrs = [t.data_ptr() for t in tensor_leaves(net.params)]
            flat = net.params_flat()
            net.set_params_flat(flat)
            le["flat_round_trip_bit_for_bit"] = bool(np.array_equal(net.params_flat(), flat))
            zero_launches(ck)
            net.fit(b1)
            torch.cuda.synchronize()
            paths["network_api_lenet_after_set_params_flat"] = read_launches(ck)
            le["storage_kept"] = ptrs == [t.data_ptr() for t in tensor_leaves(net.params)]
        finally:
            torch.backends.cudnn.deterministic = False
        ev_ds = DataSet(x[:LENET_OUT_BATCH], y[:LENET_OUT_BATCH])
        zero_launches(ck)
        rb, rg = net.evaluate_roc_binary(ev_ds), net.evaluate_regression(ev_ds)
        out = to_host(net.output(ev_ds.features))
        paths["network_api_lenet_evaluate"] = read_launches(ck)
        host_rb, host_rg, cal = ROCBinary(), RegressionEvaluation(), EvaluationCalibration()
        for e in (host_rb, host_rg, cal):
            e.eval(ev_ds.labels, out)
        rb_auc = [rb.calculate_auc(c) for c in range(10)]
        le.update({"roc_binary_auc": rb_auc,
                   "regression_mse": rg.average_mean_squared_error(),
                   "calibration_ece": cal.expected_calibration_error(),
                   "evaluators_equal_host": bool(
                       rb_auc == [host_rb.calculate_auc(c) for c in range(10)]
                       and rg.stats() == host_rg.stats())})
        stats["lenet_regularized"] = le
        seconds["d_lenet"] = time.perf_counter() - t0
        if not (le["clone_params_max_rel_diff"] <= NA_WINDOW_TOL
                and le["clone_generators_equal"] and le["new_rate_everywhere"]
                and le["new_rate_params_max_rel_diff_stock_adam"] <= LENET_PARAM_TOL
                and le["flat_round_trip_bit_for_bit"] and le["storage_kept"]
                and le["evaluators_equal_host"]
                and all(0.0 <= a <= 1.0 for a in rb_auc)
                and np.isfinite(le["calibration_ece"])):
            failures.append(f"lenet: {le}")
        del net, clone, stock
    finally:
        helpers.clear_helper("updater")
    want = {"network_api_char_rnn_graph_output": {"lstm_sequence_bf16": 2},
            "network_api_char_rnn_graph_fits": {"lstm_sequence_bf16": 2 * NA_GRAPH_FITS,
                                                "fused_adam": LB_TENSORS * NA_GRAPH_FITS},
            "network_api_char_rnn_evaluate": {"lstm_sequence_bf16": 4},
            "network_api_score_examples": {"flash_attention_fwd": n_layers},
            "network_api_lenet_clone_fits": {"fused_adam": 2 * LENET_TENSORS},
            "network_api_lenet_new_rate": {"fused_adam": LENET_TENSORS},
            "network_api_lenet_after_set_params_flat": {"fused_adam": LENET_TENSORS},
            "network_api_lenet_evaluate": {}}
    failures += [f"{p}: {paths[p]}, expected {w}" for p, w in want.items()
                 if unexpected_launches(paths[p], w)]
    stats["launches"] = paths
    print("network_api " + json.dumps(stats), flush=True)
    if failures:
        raise RuntimeError("network_api: " + "; ".join(failures))
    torch.cuda.empty_cache()
    return paths


# ------------------------------------------------------------ zoo face models
def fn_gradient_reading(net, x, y):
    """The first batch's loss and gradients in f32 on ``net`` against an f64
    twin on the card from the same weights and layer state."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import (export_params, export_states,
                                                       load_reference_params,
                                                       load_reference_states)

    g32, loss32 = net.compute_gradient_and_score(x, y)
    conf = type(net.conf).from_json(net.conf.to_json())
    conf.global_conf.dtype = "float64"
    twin = ComputationGraph(conf).init()
    load_reference_params(twin, export_params(net))
    load_reference_states(twin, export_states(net))
    g64, loss64 = twin.compute_gradient_and_score(x.double(), y.double())
    num = den = 0.0
    worst = (0.0, None)
    for key, named in g64.items():
        for n, want in named.items():
            d = (g32[key][n].double() - want).norm().item()
            w = want.norm().item()
            num, den = num + d * d, den + w * w
            if w > 0 and d / w > worst[0]:
                worst = (d / w, f"{key}/{n}")
    del twin, g64, g32
    torch.cuda.empty_cache()
    return {"loss_f32": float(loss32), "loss_f64": float(loss64),
            "loss_rel": abs(float(loss32) - float(loss64)) / abs(float(loss64)),
            "grad_rel_l2": math.sqrt(num / den), "worst_tensor_rel_l2": worst[0],
            "worst_tensor": worst[1], "limits": {"loss_rel": FN_LOSS_TOL,
                                                 "grad_rel_l2": FN_GRAD_TOL}}


def zoo_facenet_phase(ck, card):
    """InceptionResNetV1 and FaceNetNN4Small2 at their published widths on
    the fused updater (see FN_*). Returns each model's launches."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.zoo import FaceNetNN4Small2, InceptionResNetV1

    paths, failures = {}, []
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        for model, batch in ((InceptionResNetV1(), FN_IRV1_BATCH),
                             (FaceNetNN4Small2(), FN_NN4_BATCH)):
            name = type(model).__name__
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            c, h, w = model.input_shape
            gen = torch.Generator(device="cuda")
            gen.manual_seed(17)
            x = torch.rand((batch, h, w, c), generator=gen, device="cuda")
            y = F.one_hot(torch.randint(0, model.num_labels, (batch,), generator=gen,
                                        device="cuda"), model.num_labels).float()
            net = model.init()
            reading = fn_gradient_reading(net, x, y)
            net.fit(x, y)  # warm-up
            zero_launches(ck)
            step_ms, losses = timed_fits(net, x, y, FN_STEPS)
            launches = read_launches(ck)
            paths[f"zoo_facenet_{name}_train"] = launches
            median = float(np.median(step_ms))
            row = {"model": name, "card": card, "input": [h, w, c], "batch": batch,
                   "params": net.conf.num_params(), "tensors": tensors_of(net),
                   "step_ms": step_ms, "median_step_ms": median,
                   "images_per_s": batch / (median / 1e3), "losses": losses,
                   "launches": launches,
                   "k2_launches_per_step": launches["fused_adam"] / FN_STEPS,
                   "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "first_batch_f32_against_f64": reading,
                   **busy(lambda: [net.fit(x, y) for _ in range(2)], 2)}
            bad = []
            if unexpected_launches(launches, {"fused_adam": tensors_of(net) * FN_STEPS}):
                bad.append("launches")
            if not np.isfinite(losses).all():
                bad.append("losses")
            if not (reading["loss_rel"] <= FN_LOSS_TOL
                    and reading["grad_rel_l2"] <= FN_GRAD_TOL):
                bad.append("f64 twin")
            row["ok"] = not bad
            print("zoo_facenet " + json.dumps(row), flush=True)
            failures += [f"{name}: {b}" for b in bad]
            del net, x, y
    finally:
        helpers.clear_helper("updater")
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"zoo_facenet: {failures}")
    return paths


# ---------------------------------------------------------------- Keras import
class SeededKerasWeights:
    """``Hdf5Archive``'s read API (``get_groups``, ``get_data_sets``,
    ``read_dataset``) over weights drawn from a seed at the shapes Keras
    stores each layer's weights in, for the layers of an imported network:
    what ``copy_weights`` reads from a real ``.h5``. Test scaffolding: the
    card's machine has neither Keras nor h5py."""

    def __init__(self, km, net, seed):
        self._rng = np.random.default_rng(seed)
        if hasattr(net.conf, "vertices"):
            layers = {n: net.conf.vertices[n].obj for n in km.layer_names}
        else:
            layers = {layer.name: layer for layer in net.layers}
        self.tree = {name: self._keras_weights(layer) for name, layer in layers.items()
                     if name in km.layer_names}

    def _draw(self, shape, fan_in):
        return (self._rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)

    def _keras_weights(self, layer):
        cls = type(layer).__name__
        if cls in ("LastTimeStepWrapper", "BidirectionalWrapper"):
            inner = layer.layer
            if cls == "LastTimeStepWrapper":
                return self._keras_weights(inner)
            one = lambda: self._keras_weights(inner)  # noqa: E731
            return {"forward_lstm": one(), "backward_lstm": one()}
        if cls == "SelfAttentionLayer":
            d, h, dh = layer.n_in, layer.n_heads, layer._dh()
            proj = lambda: {"kernel": self._draw((d, h, dh), d),  # noqa: E731
                            "bias": self._draw((h, dh), 50.0)}
            return {"query": proj(), "key": proj(), "value": proj(),
                    "attention_output": {"kernel": self._draw((h, dh, d), h * dh),
                                         "bias": self._draw((d,), 50.0)}}
        shapes = layer.param_shapes()
        if not shapes:
            return {}
        if cls == "LayerNormalizationLayer":
            n = shapes["gamma"][0]
            return {"gamma": 1.0 + self._draw((n,), 2500.0), "beta": self._draw((n,), 2500.0)}
        if cls == "EmbeddingSequenceLayer":
            return {"embeddings": self._draw(shapes["W"], 2500.0)}
        if cls == "LSTMLayer":
            return {"kernel": self._draw(shapes["W"], shapes["W"][0]),
                    "recurrent_kernel": self._draw(shapes["RW"], shapes["RW"][0]),
                    "bias": self._draw(shapes["b"], 100.0)}
        out = {"kernel": self._draw(shapes["W"], int(np.prod(shapes["W"][:-1])))}
        if "b" in shapes:
            out["bias"] = self._draw(shapes["b"], 100.0)
        return out

    def _node(self, groups):
        node = self.tree
        for g in groups:
            node = node[g]
        return node

    def get_groups(self, *groups):
        return [k for k, v in self._node(groups).items() if isinstance(v, dict)]

    def get_data_sets(self, *groups):
        return [k for k, v in self._node(groups).items() if not isinstance(v, dict)]

    def read_dataset(self, name, *groups):
        return self._node(groups)[name]


def keras_fixture(name):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "keras", f"{name}.json")) as f:
        return json.load(f)


def keras_network(name, seed, device=None, dtype=None, compute_dtype=None, weights=None):
    """The fixture ``name`` imported through ``import_keras_model_from_json``
    onto ``device``, filled by ``copy_weights`` from seeded Keras-shaped
    weights (or given ``weights``, as ``export_params`` gives them)."""
    from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport
    from deeplearning4j_tpu_torch.util.convert import load_reference_params

    fixture = keras_fixture(name)
    km = KerasModelImport.import_keras_model_from_json(fixture["model_config"],
                                                       fixture["training_config"])
    if dtype is not None:
        km.conf.global_conf.dtype = dtype
    km.conf.global_conf.compute_dtype = compute_dtype
    net = km.init(device)
    if weights is None:
        km.copy_weights(net, SeededKerasWeights(km, net, seed))
    else:
        load_reference_params(net, weights)
    return net


def keras_bert(ck, card):
    """(a): the imported BERT-base in bf16 beside the zoo encoder."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import export_params
    from deeplearning4j_tpu_torch.zoo.models import TransformerEncoder

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = keras_network("bert_base", seed=31, compute_dtype="bfloat16")
    weights = export_params(net)  # as imported, for the f32 and f64 twins
    n_att = sum(1 for n in net.conf.topo_order if n.startswith("mha_"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tok = torch.randint(0, 30522, (KI_BERT_BATCH, ENC_T), generator=gen, device="cuda")
    pos = torch.arange(ENC_T, device="cuda").repeat(KI_BERT_BATCH, 1)
    y = F.one_hot(torch.randint(0, 2, (KI_BERT_BATCH,), generator=gen, device="cuda"),
                  2).float()
    data = MultiDataSet([tok, pos], [y])
    helpers.set_helper("attention", ck.FlashAttentionHelper(causal=False))
    try:
        net.fit(data)  # warm-up
        zero_launches(ck)
        step_ms, losses = timed_fits(net, data, None, KI_STEPS)
        launches = read_launches(ck)
        zero_launches(ck)
        out = net.output(tok, pos)
        torch.cuda.synchronize()
        out_launches = read_launches(ck)
        out_ok = (out.dtype == torch.bfloat16 and tuple(out.shape) == (KI_BERT_BATCH, 2)
                  and bool(torch.isfinite(out.float()).all()))
        prof = busy(lambda: [net.fit(data) for _ in range(2)], 2)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del net, out
        torch.cuda.empty_cache()
        # the zoo's encoder at the same shape (its Adam, stock), reported
        zconf = TransformerEncoder(num_labels=2, seed=1).conf()
        zconf.global_conf.compute_dtype = "bfloat16"
        zoo = ComputationGraph(zconf).init()
        zoo.fit(tok, y)
        zoo_ms, _ = timed_fits(zoo, tok, y, KI_STEPS)
        del zoo
        torch.cuda.empty_cache()
        # the imported weights' f32 output at batch 2 (f32 K3a) against an
        # f64 twin's (plain attention)
        f32 = keras_network("bert_base", 0, dtype="float32", weights=weights)
        zero_launches(ck)
        got = f32.output(tok[:2], pos[:2]).double()
        torch.cuda.synchronize()
        f32_launches = read_launches(ck)
        del f32
        f64 = keras_network("bert_base", 0, dtype="float64", weights=weights)
        want = f64.output(tok[:2], pos[:2])
        err = (got - want).abs().max().item()
        del f64
    finally:
        helpers.clear_helper("attention")
        torch.cuda.empty_cache()
    median = float(np.median(step_ms))
    want_launches = {f"{k}_bf16": n_att * KI_STEPS for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    row = {"model": "bert_base", "card": card, "compute_dtype": "bfloat16", "ids": "int64",
           "batch": [KI_BERT_BATCH, ENC_T], "attention_layers": n_att,
           "params": sum(int(np.prod(a.shape)) for v in weights.values() for a in v.values()),
           "step_ms": step_ms, "median_step_ms": median,
           "tokens_per_s": KI_BERT_BATCH * ENC_T / (median / 1e3), "losses": losses,
           "launches": launches,
           "launches_per_step": {k: v / KI_STEPS for k, v in launches.items()},
           "output_launches": out_launches, "peak_device_mem_gb": peak, **prof,
           "zoo_encoder_step_ms": zoo_ms, "zoo_encoder_median_step_ms": float(np.median(zoo_ms)),
           "f32_output_launches": f32_launches,
           "f32_output_against_f64": {"max_abs_err": err, "limit": KI_BERT_TOL}}
    bad = []
    if unexpected_launches(launches, want_launches):
        bad.append("launches")
    if unexpected_launches(out_launches, {"flash_attention_fwd_bf16": n_att}):
        bad.append("output launches")
    if unexpected_launches(f32_launches, {"flash_attention_fwd": n_att}):
        bad.append("f32 output launches")
    if not (out_ok and np.isfinite(losses).all() and err <= KI_BERT_TOL):
        bad.append("output or losses")
    row["ok"] = not bad
    print("keras_import " + json.dumps(row), flush=True)
    return {"keras_bert_train": launches, "keras_bert_output": out_launches,
            "keras_bert_f32_output": f32_launches}, bad


def keras_imdb(ck, card):
    """(b): keras-io's IMDB Bidirectional LSTM on K1."""
    from deeplearning4j_tpu_torch.nn import helpers

    net = keras_network("imdb_bilstm", seed=32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    x = torch.randint(0, 20000, (KI_IMDB_BATCH, 200), generator=gen, device="cuda")
    y = torch.randint(0, 2, (KI_IMDB_BATCH, 1), generator=gen, device="cuda").float()
    zero_launches(ck)
    got = net.output(x)
    torch.cuda.synchronize()
    out_launches = read_launches(ck)
    helpers.set_auto_fused_lstm(False)
    try:
        zero_launches(ck)
        plain = net.output(x)
        torch.cuda.synchronize()
        plain_launches = read_launches(ck)
    finally:
        helpers.set_auto_fused_lstm(True)
    err = (got - plain).abs().max().item()
    limit = LSTM_TOL * max(1.0, plain.abs().max().item())
    zero_launches(ck)
    step_ms, losses = timed_fits(net, x, y, KI_IMDB_STEPS)
    fit_launches = read_launches(ck)
    row = {"model": "imdb_bilstm", "card": card, "batch": [KI_IMDB_BATCH, 200],
           "params": net.conf.num_params(), "output_launches": out_launches,
           "plain_output_launches": plain_launches,
           "output_against_plain": {"max_abs_err": err, "limit": limit},
           "step_ms": step_ms, "losses": losses, "fit_launches": fit_launches}
    bad = []
    if unexpected_launches(out_launches, {"lstm_sequence": 4}) or any(plain_launches.values()):
        bad.append("output launches")
    if unexpected_launches(fit_launches, {"lstm_sequence": 4 * KI_IMDB_STEPS}):
        bad.append("fit launches")
    if not (err <= limit and np.isfinite(losses).all()):
        bad.append("output or losses")
    row["ok"] = not bad
    print("keras_import " + json.dumps(row), flush=True)
    del net
    return {"keras_imdb_output": out_launches, "keras_imdb_train": fit_launches}, bad


def keras_cnn(ck, card):
    """(c): keras-io's MNIST convnet on the card against the CPU."""
    from deeplearning4j_tpu_torch.util.convert import export_params

    net = keras_network("sequential_cnn", seed=33)
    cpu = keras_network("sequential_cnn", 0, device="cpu", weights=export_params(net))
    x = torch.rand((KI_CNN_BATCH, 28, 28, 1), generator=torch.Generator().manual_seed(7))
    zero_launches(ck)
    got = net.output(x.cuda()).cpu()
    torch.cuda.synchronize()
    launches = read_launches(ck)
    want = cpu.output(x)
    err = (got - want).abs().max().item()
    limit = KI_CNN_TOL * max(1.0, want.abs().max().item())
    row = {"model": "sequential_cnn", "card": card, "batch": KI_CNN_BATCH,
           "params": net.conf.num_params(), "layers": [type(l).__name__ for l in net.layers],
           "output_against_cpu": {"max_abs_err": err, "limit": limit},
           "output_launches": launches}
    bad = [] if err <= limit and not any(launches.values()) else ["output"]
    row["ok"] = not bad
    print("keras_import " + json.dumps(row), flush=True)
    return {"keras_cnn_output": launches}, bad


def keras_import_phase(ck, card):
    """The committed Keras configurations imported and driven on the card
    (see KI_*). Returns each path's launches."""
    paths, failures = {}, []
    for name, run in (("bert", keras_bert), ("imdb", keras_imdb), ("cnn", keras_cnn)):
        got, bad = run(ck, card)
        paths.update(got)
        failures += [f"{name}: {b}" for b in bad]
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"keras_import: {failures}")
    return paths


# ---------------------------------------------------------------- DL4J export
def me_graph_conf():
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex, MergeVertex

    g = (NeuralNetConfiguration.builder().seed(9).updater(Adam(1e-3))
         .graph_builder().add_inputs("a", "b")
         .set_input_types(InputType.feed_forward(256), InputType.feed_forward(128)))
    g.add_layer("da", DenseLayer(n_out=512, activation="relu"), "a")
    g.add_layer("db", DenseLayer(n_out=512, activation="tanh"), "b")
    g.add_vertex("sum", ElementWiseVertex(op="add"), "da", "db")
    g.add_vertex("cat", MergeVertex(), "sum", "da")
    g.add_layer("out", OutputLayer(n_out=10, activation="softmax", loss="mcxent"), "cat")
    return g.set_outputs("out").build()


def me_round_trip(ck, net, x, y, tmp, name):
    """``net`` trained ME_STEPS steps on the fused updater, exported as a
    DL4J zip and read back onto the card; returns (row, launches)."""
    from deeplearning4j_tpu_torch.modelimport import dl4j, dl4j_export
    from deeplearning4j_tpu_torch.util.model_guesser import load_model_guess

    graph = hasattr(net.conf, "vertices")
    zero_launches(ck)
    _, losses = timed_fits(net, x, y, ME_STEPS)
    launches = read_launches(ck)
    xs = x.features if graph else [x]
    path, own = os.path.join(tmp, f"{name}_dl4j.zip"), os.path.join(tmp, f"{name}_own.zip")
    t0 = time.perf_counter()
    (dl4j_export.export_computation_graph if graph
     else dl4j_export.export_multi_layer_network)(net, path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = (dl4j.restore_computation_graph if graph else dl4j.restore_multi_layer_network)(path)
    restore_s = time.perf_counter() - t0
    want = net.output(*xs)
    got = back.output(*xs)
    err = (got - want).abs().max().item()
    limit = 0.0 if graph else ME_LENET_TOL * max(1.0, want.abs().max().item())
    # the Adam state read back equal, but for a dense weight after a
    # convolution, whose rows come back in DL4J's order
    _, permuted = (({}, {}) if graph else dl4j_export._walk_boundaries(net.conf))
    kept = [(k, n) for k, named in net.updater_states.items() for n in named
            if not (k in permuted and n == "W")]
    state_equal = all(torch.equal(net.updater_states[k][n][slot],
                                  back.updater_states[k][n][slot])
                      for k, n in kept for slot in net.updater_states[k][n])
    net.save(own)
    kinds = {"dl4j": type(load_model_guess(path)).__name__,
             "own": type(load_model_guess(own)).__name__}
    row = {"network": name, "losses": losses, "fit_launches": launches,
           "zip_bytes": os.path.getsize(path), "export_s": export_s, "restore_s": restore_s,
           "restored_on": str(next(back.parameters()).device),
           "output_max_abs_err": err, "limit": limit,
           "adam_state_equal": state_equal, "adam_tensors_compared": len(kept),
           "guessed": kinds, "iteration": [net.iteration, back.iteration]}
    want_kind = type(net).__name__
    row["ok"] = (err <= limit and state_equal and kinds == {"dl4j": want_kind, "own": want_kind}
                 and back.iteration == net.iteration
                 and not unexpected_launches(launches,
                                             {"fused_adam": tensors_of(net) * ME_STEPS}))
    return row, launches


def model_export_phase(ck, card):
    """Networks trained on the card written as DL4J zips and read back (see
    ME_*). Returns each path's launches."""
    import shutil
    import tempfile

    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    paths, failures = {}, []
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        lenet = MultiLayerNetwork(lenet_conf()).init()
        x = torch.rand((ME_BATCH, 28, 28, 1), generator=gen, device="cuda")
        y = F.one_hot(torch.randint(0, 10, (ME_BATCH,), generator=gen, device="cuda"),
                      10).float()
        row, paths["model_export_lenet_train"] = me_round_trip(ck, lenet, x, y, tmp, "lenet")
        print("model_export " + json.dumps({"card": card, **row}), flush=True)
        if not row["ok"]:
            failures.append("lenet")
        graph = ComputationGraph(me_graph_conf()).init()
        data = MultiDataSet([torch.randn((ME_BATCH, 256), generator=gen, device="cuda"),
                             torch.randn((ME_BATCH, 128), generator=gen, device="cuda")], [y])
        row, paths["model_export_graph_train"] = me_round_trip(ck, graph, data, None, tmp,
                                                               "graph")
        print("model_export " + json.dumps({"card": card, **row}), flush=True)
        if not row["ok"]:
            failures.append("graph")
    finally:
        helpers.clear_helper("updater")
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"model_export: {failures}")
    return paths


def tu_lenet_conf(lr=1e-3, dense=500, dtype="float32", side=28, widths=(20, 50)):
    """The zoo's LeNet (``zoo/models.py``: two 5x5 "same" convolutions,
    each with a 2x2 max pool, a relu dense layer, a softmax output) with
    Adam(``lr``) in place of its AdaDelta, the dense width, the input
    side and the convolution widths as parameters (the zoo's at their
    defaults) and the dtype."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer,
                                                    OutputLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    return (NeuralNetConfiguration.builder().seed(123).dtype(dtype)
            .activation("identity").weight_init("xavier").updater(Adam(lr)).list()
            .layer(ConvolutionLayer(n_out=widths[0], kernel_size=(5, 5), stride=(1, 1),
                                    convolution_mode="same", activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=widths[1], kernel_size=(5, 5), stride=(1, 1),
                                    convolution_mode="same", activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=dense, activation="relu"))
            .layer(OutputLayer(n_out=10, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.convolutional(side, side, 1)).build())


def tu_data(n, seed, dtype=np.float32):
    """``n`` images with the verify skill's planted signal (row 2 + class
    raised by 2 over N(0, 0.3)) and one-hot labels."""
    rng = np.random.default_rng(seed)
    y_idx = rng.integers(0, 10, n)
    x = rng.normal(0, 0.3, size=(n, 28, 28, 1))
    x[np.arange(n), 2 + y_idx, :, 0] += 2.0
    return x.astype(dtype), np.eye(10, dtype=dtype)[y_idx]


def tu_solver_start():
    """The zoo LeNet's initial f64 weights (a CPU init from the conf's
    seed, the same in every process) and the full batch of (c)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import export_params

    weights = export_params(MultiLayerNetwork(tu_lenet_conf(dtype="float64"),
                                              device="cpu").init())
    return weights, tu_data(TU_SOLVER_N, 5, np.float64)


def tu_solver_run(algo, dtype, device):
    """``Solver(algo)`` for TU_SOLVER_ITERS iterations from (c)'s start on
    ``device`` in ``dtype``; returns (score history, the network)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import Solver
    from deeplearning4j_tpu_torch.util.convert import load_reference_params

    weights, (x, y) = tu_solver_start()
    net = load_reference_params(MultiLayerNetwork(tu_lenet_conf(dtype=dtype),
                                                  device=device).init(), weights)
    s = Solver(net, algo, max_iterations=TU_SOLVER_ITERS)
    s.optimize(DataSet(x, y))
    return s.score_history, net


def tu_cpu_twin():
    """(c)'s float64 runs on the CPU: each algorithm's score history, and
    the first loss and flat gradient."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.solvers import flat_leaves
    from deeplearning4j_tpu_torch.util.convert import load_reference_params

    out = {f"hist_{algo}": tu_solver_run(algo, "float64", "cpu")[0] for algo in TU_ALGOS}
    weights, (x, y) = tu_solver_start()
    net = load_reference_params(MultiLayerNetwork(tu_lenet_conf(dtype="float64"),
                                                  device="cpu").init(), weights)
    grads, loss = net.compute_gradient_and_score(x, y)
    out["first_loss"] = loss
    out["first_grad"] = torch.cat([g.reshape(-1) for _, _, g in flat_leaves(grads)])
    return out


class StepClock:
    """A listener, last in the list, that waits for the device at each
    iteration and keeps the host time between consecutive iterations (one
    step and the listeners before it; across an epoch's end, the
    evaluation too: the median leaves those out)."""

    def __init__(self):
        self.last, self.ms = None, []

    def iteration_done(self, model, iteration, epoch):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if self.last is not None:
            self.ms.append((now - self.last) * 1e3)
        self.last = now


class Snapshots:
    """Clones of the parameters at every ``every``-th iteration (the last
    ``keep``)."""

    def __init__(self, every, keep):
        self.every, self.keep, self.at = every, keep, {}

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.every == 0:
            self.at[iteration] = {k: {n: t.clone() for n, t in named.items()}
                                  for k, named in model.params.items()}
            for it in sorted(self.at)[:-self.keep]:
                del self.at[it]


def tu_early_stopping(ck, card, tmp):
    """(a): two early-stopping runs of the zoo LeNet and the timed steps.
    Returns (row, launches by path, the stats storage and session, the
    best model, the held-out iterator)."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import (
        CheckpointListener, ClassificationScoreCalculator,
        CollectScoresIterationListener, DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, EvaluativeListener, InvalidScoreIterationTerminationCondition,
        LocalFileModelSaver, MaxEpochsTerminationCondition,
        MaxTimeIterationTerminationCondition, PerformanceListener,
        ScoreImprovementEpochTerminationCondition, ScoreIterationListener)
    from deeplearning4j_tpu_torch.ui import FileStatsStorage, StatsListener

    x, y = tu_data(TU_N, 0)
    hx, hy = tu_data(TU_HELD, 1)
    train = ListDataSetIterator(DataSet(x, y), TU_BATCH)
    held = ListDataSetIterator(DataSet(hx, hy), TU_BATCH)
    printed, paths, row = [], {}, {"card": card}

    def config(calculator, saver_dir):
        return EarlyStoppingConfiguration(
            score_calculator=calculator,
            epoch_termination_conditions=[
                MaxEpochsTerminationCondition(TU_EPOCHS),
                ScoreImprovementEpochTerminationCondition(TU_PATIENCE)],
            iteration_termination_conditions=[
                InvalidScoreIterationTerminationCondition(),
                MaxTimeIterationTerminationCondition(TU_MAX_SECONDS)],
            model_saver=LocalFileModelSaver(saver_dir))

    # the median step of one epoch with no listener but the clock
    net = MultiLayerNetwork(tu_lenet_conf()).init()
    clock = StepClock()
    net.set_listeners(clock)
    net.fit(train, epochs=1)
    row["median_step_ms_no_listeners"] = float(np.median(clock.ms))

    # run 1: held-out loss, six listeners
    net = MultiLayerNetwork(tu_lenet_conf()).init()
    storage = FileStatsStorage(os.path.join(tmp, "stats.jsonl"))
    stats = StatsListener(storage, session_id="tu_lenet")
    collect, evaluative = CollectScoresIterationListener(), EvaluativeListener(held)
    ckpt = CheckpointListener(os.path.join(tmp, "ckpt"), save_every_n_iterations=TU_CKPT_EVERY,
                              keep_last=TU_CKPT_KEEP)
    snaps, clock = Snapshots(TU_CKPT_EVERY, TU_CKPT_KEEP), StepClock()
    net.set_listeners(ScoreIterationListener(TU_CKPT_EVERY, printer=printed.append),
                      PerformanceListener(TU_CKPT_EVERY, report_score=True,
                                          printer=printed.append),
                      collect, evaluative, ckpt, stats, snaps, clock)
    trainer = EarlyStoppingTrainer(config(DataSetLossCalculator(held),
                                          os.path.join(tmp, "es_loss")), net, train)
    zero_launches(ck)
    result = trainer.fit()
    torch.cuda.synchronize()
    paths["tu_lenet_early_stopping_loss"] = launches = read_launches(ck)
    steps = net.iteration
    best_again = DataSetLossCalculator(held).calculate_score(result.best_model)
    best_rel = abs(best_again - result.best_model_score) / abs(result.best_model_score)
    last = ckpt.available_checkpoints(ckpt.dir)[-1]
    back = CheckpointListener.load_checkpoint(ckpt.dir, last["number"])
    ckpt_diff = max((back.params[k][n] - t).abs().max().item()
                    for k, named in snaps.at[last["iteration"]].items()
                    for n, t in named.items())
    row["loss_run"] = {
        "reason": result.termination_reason, "details": result.termination_details,
        "best_epoch": result.best_model_epoch, "total_epochs": result.total_epochs,
        "scores": {str(k): v for k, v in result.score_vs_epoch.items()}, "steps": steps,
        "best_restored_score": best_again, "best_rel_err": best_rel, "limit": TU_BEST_RTOL,
        "checkpoints": [c["path"].name for c in ckpt.available_checkpoints(ckpt.dir)],
        "checkpoint_vs_live_max_abs": ckpt_diff, "launches": launches,
        "median_step_ms_all_listeners": float(np.median(clock.ms)),
        "step_ms_p90_all_listeners": float(np.percentile(clock.ms, 90)),
        "collected_scores": len(collect.scores), "evaluations": len(evaluative.evaluations),
        "held_out_accuracy": [e.accuracy() for e in evaluative.evaluations],
        "printed": printed[:2] + printed[-1:], "stats_bytes": os.path.getsize(storage.path),
        "stats_reports": storage.get_num_update_records_for("tu_lenet")}
    bad = unexpected_launches(launches, {"fused_adam": LENET_TENSORS * steps})
    if bad or best_rel > TU_BEST_RTOL or ckpt_diff != 0.0:
        raise RuntimeError(f"training_utilities (a): launches {bad}, best {best_rel}, "
                           f"checkpoint {ckpt_diff}")
    best = result.best_model

    # run 2: held-out accuracy, no listeners
    net2 = MultiLayerNetwork(tu_lenet_conf()).init()
    zero_launches(ck)
    result2 = EarlyStoppingTrainer(config(ClassificationScoreCalculator(held),
                                          os.path.join(tmp, "es_acc")), net2, train).fit()
    torch.cuda.synchronize()
    paths["tu_lenet_early_stopping_accuracy"] = launches2 = read_launches(ck)
    again = ClassificationScoreCalculator(held).calculate_score(result2.best_model)
    row["accuracy_run"] = {
        "reason": result2.termination_reason, "details": result2.termination_details,
        "best_epoch": result2.best_model_epoch, "total_epochs": result2.total_epochs,
        "scores": {str(k): v for k, v in result2.score_vs_epoch.items()},
        "steps": net2.iteration, "best_restored_score": again, "launches": launches2}
    bad = unexpected_launches(launches2, {"fused_adam": LENET_TENSORS * net2.iteration})
    if bad or again != result2.best_model_score:
        raise RuntimeError(f"training_utilities (a) accuracy run: launches {bad}, best "
                           f"{again} vs {result2.best_model_score}")
    print("training_utilities (a) " + json.dumps(row), flush=True)
    return paths, storage, best, held


def tu_gpt2_stats(ck, card, tmp):
    """(b): GPT-2-small bf16 with and without StatsListener; returns the
    launches by path."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.optimize import ProfilerListener
    from deeplearning4j_tpu_torch.ui import (FileStatsStorage, StatsListener,
                                             StatsUpdateConfiguration)
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    conf = TransformerLM().conf()  # GPT-2-small, seed 123
    conf.global_conf.compute_dtype = "bfloat16"
    net = ComputationGraph(conf).init()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    want = {"flash_attention_fwd_bf16": n_layers, "flash_attention_bwd_dq_bf16": n_layers,
            "flash_attention_bwd_dkv_bf16": n_layers, "fused_adam": tensors_of(net)}
    ids = torch.from_numpy(np.random.default_rng(123).integers(0, vocab, (TRAIN_N, T))).cuda()
    labels = F.one_hot(torch.cat([ids[:, 1:], ids[:, -1:]], 1), vocab).float()
    paths, row, failures = {}, {"card": card, "batch": [TRAIN_N, T]}, []
    prof = None
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        net.fit(ids, labels)  # warm-up
        for name, freq in (("none", None), ("stats_every_1", 1), ("stats_every_10", 10)):
            clock, listeners, storage = StepClock(), [], None
            if freq is not None:
                storage = FileStatsStorage(os.path.join(tmp, f"gpt2_{name}.jsonl"))
                cfg = StatsUpdateConfiguration(report_iterations=freq, collect_histograms=True)
                listeners.append(StatsListener(storage, cfg, session_id=name))
            if freq == 1:
                prof = ProfilerListener(os.path.join(tmp, "profile"),
                                        start_iteration=net.iteration + TU_PROFILE[0] - 1,
                                        n_iterations=TU_PROFILE[1])
                listeners.append(prof)
            net.set_listeners(*listeners, clock)
            zero_launches(ck)
            clock.iteration_done(net, net.iteration, net.epoch)  # the clock's start
            for _ in range(TU_GPT2_STEPS):
                net.fit(ids, labels)
            paths[f"tu_gpt2_bf16_{name}"] = launches = read_launches(ck)
            row[name] = {"median_step_ms": float(np.median(clock.ms)),
                         "step_ms": clock.ms, "launches": launches,
                         "stats_bytes": None if storage is None else os.path.getsize(storage.path),
                         "reports": None if storage is None
                         else storage.get_num_update_records_for(name)}
            bad = unexpected_launches(launches, {k: v * TU_GPT2_STEPS for k, v in want.items()})
            if bad:
                failures.append(f"{name} launches {bad}")
        net.set_listeners()
    finally:
        helpers.clear_helper("updater")
    with open(prof.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    traced = {k: any(k in n for n in names) for k in (
        "fused_adam_kernel", "flash_attention_fwd_bf16_wgmma_kernel",
        "flash_attention_bwd_dq_bf16_wgmma_kernel", "flash_attention_bwd_dkv_bf16_wgmma_kernel")}
    row["profile"] = {"trace_bytes": os.path.getsize(prof.trace_path), "kernels_named": traced,
                      "error": prof.last_error}
    for name in ("stats_every_1", "stats_every_10"):
        row[name]["over_no_listener_ms"] = row[name]["median_step_ms"] - row["none"]["median_step_ms"]
    # the host synchronisations of one report (the one read expected)
    import warnings

    lone = StatsListener(FileStatsStorage(os.path.join(tmp, "gpt2_sync.jsonl")),
                         StatsUpdateConfiguration(collect_histograms=True), session_id="sync")
    lone.iteration_done(net, net.iteration, net.epoch)  # its static report first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            lone.iteration_done(net, net.iteration, net.epoch)
            row["report_host_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    row["syncs_per_report"] = sum("synchroniz" in str(w.message) for w in caught)
    if row["syncs_per_report"] != 1:
        failures.append(f"{row['syncs_per_report']} host synchronisations a report")
    print("training_utilities (b) " + json.dumps(row), flush=True)
    if failures or not all(traced.values()):
        raise RuntimeError(f"training_utilities (b): {failures}, traced {traced}")
    del net, labels
    torch.cuda.empty_cache()
    return paths


def tu_solver(ck, card):
    """(c): Solver on the zoo LeNet at full batch on the card in f32 and
    f64, then the same f64 runs on the CPU (the phase's last work: the
    CPU's threads would slow the host-bound steps timed before it).
    Returns the launches."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.solvers import flat_leaves
    from deeplearning4j_tpu_torch.util.convert import load_reference_params

    row, failures = {"card": card, "batch": TU_SOLVER_N, "iterations": TU_SOLVER_ITERS}, []
    zero_launches(ck)
    t0 = time.perf_counter()
    runs = {}
    for algo in TU_ALGOS:
        for dtype in ("float32", "float64"):
            hist, _ = tu_solver_run(algo, dtype, "cuda")
            runs[(algo, dtype)] = hist
    row["card_seconds"] = time.perf_counter() - t0
    launches = read_launches(ck)
    weights, (x, y) = tu_solver_start()
    nets = {dt: load_reference_params(MultiLayerNetwork(tu_lenet_conf(dtype=dt)).init(), weights)
            for dt in ("float32", "float64")}
    grads, loss = nets["float32"].compute_gradient_and_score(x.astype(np.float32),
                                                             y.astype(np.float32))
    leaves = flat_leaves(grads)
    t0 = time.perf_counter()
    cpu = tu_cpu_twin()
    row["cpu_twin_seconds"] = time.perf_counter() - t0
    g64 = cpu["first_grad"]
    rel, offset = {}, 0
    for k, n, g in leaves:
        want = g64[offset:offset + g.numel()]
        rel[f"{k}_{n}"] = float((g.reshape(-1).double().cpu() - want).norm() / want.norm())
        offset += g.numel()
    g32 = torch.cat([g.reshape(-1) for _, _, g in leaves]).double().cpu()
    out_key = len(nets["float32"].layers) - 1

    def dense_pre(net, dt):
        """The relu dense layer's pre-activations."""
        h = net.feed_forward(x.astype(dt))[out_key - 1].reshape(len(x), -1)
        return h @ net.params[out_key - 1]["W"] + net.params[out_key - 1]["b"]

    flips = int(((dense_pre(nets["float32"], np.float32) > 0)
                 != (dense_pre(nets["float64"], np.float64) > 0)).sum())
    first = {"loss_f32": loss, "loss_f64_cpu": cpu["first_loss"],
             "loss_rel": abs(loss - cpu["first_loss"]) / abs(cpu["first_loss"]),
             "grad_rel_l2": float((g32 - g64).norm() / g64.norm()), "grad_rel_l2_by_tensor": rel,
             "dense_relu_flips": flips, "limit": TU_SOLVER_F32_TOL,
             "limit_below_output_layer": TU_SOLVER_F32_TIE_TOL}
    row["f32_first"] = first
    if not (first["loss_rel"] <= TU_SOLVER_F32_TOL
            and all(v <= (TU_SOLVER_F32_TOL if k.startswith(f"{out_key}_") else TU_SOLVER_F32_TIE_TOL)
                    for k, v in rel.items())):
        failures.append(f"f32 first {first}")
    for algo in TU_ALGOS:
        h32, h64, want = runs[(algo, "float32")], runs[(algo, "float64")], cpu[f"hist_{algo}"]
        rel = (max(abs(a - b) / abs(b) for a, b in zip(h64, want))
               if len(h64) == len(want) else None)
        row[algo] = {"f32": h32, "f64": h64, "f64_cpu": want, "f64_max_rel": rel,
                     "f32_non_increasing": all(b <= a for a, b in zip(h32, h32[1:]))}
        if rel is None or rel > TU_SOLVER_F64_RTOL or not row[algo]["f32_non_increasing"]:
            failures.append(f"{algo}: {row[algo]}")
    row["launches"] = launches
    print("training_utilities (c) " + json.dumps(row), flush=True)
    if failures or unexpected_launches(launches, {}):
        raise RuntimeError(f"training_utilities (c): {failures}, launches {launches}")
    return launches


def tu_gradient_checks(ck, card):
    """(d): check_model_gradients in f64 on the card. Returns the
    launches."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.gradient_check import check_model_gradients

    side, widths, dense, batch = TU_GC_LENET
    lenet = MultiLayerNetwork(tu_lenet_conf(dense=dense, side=side, widths=widths)).init()
    rng = np.random.default_rng(4)
    n, t_len, n_in, units, n_out = TU_GC_LSTM
    lstm = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(3).list()
        .layer(LSTMLayer(n_out=units, activation="tanh"))
        .layer(RnnOutputLayer(n_out=n_out, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.recurrent(n_in)).build()).init()
    cases = {"lenet": (lenet, rng.normal(size=(batch, side, side, 1)),
                       np.eye(10)[rng.integers(0, 10, batch)]),
             "lstm": (lstm, rng.normal(size=(n, t_len, n_in)),
                      np.eye(n_out)[rng.integers(0, n_out, (n, t_len))])}
    row, ok = {"card": card}, True
    zero_launches(ck)
    for name, (net, x, y) in cases.items():
        report = {}
        t0 = time.perf_counter()
        passed = check_model_gradients(net, x, y, report=report)
        row[name] = {"passed": passed, "worst_rel_err": report["max_rel_error_any"],
                     "worst_significant_rel_err": report["max_rel_error"],
                     "coordinates": len(report["coordinates"]),
                     "seconds": time.perf_counter() - t0}
        ok = ok and passed
    launches = read_launches(ck)
    row["launches"] = launches
    print("training_utilities (d) " + json.dumps(row), flush=True)
    if not ok or unexpected_launches(launches, {}):
        raise RuntimeError(f"training_utilities (d): {row}")
    return launches


def tu_search(ck, card):
    """(e): random and grid search over LeNet's learning rate and dense
    width. Returns the launches by path."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import DataSetLossCalculator
    from deeplearning4j_tpu_torch.optimize.hpo import (Choice, GridSearch, LogUniform,
                                                       RandomSearch)

    x, y = tu_data(TU_N, 0)
    hx, hy = tu_data(TU_HELD, 1)
    train = ListDataSetIterator(DataSet(x, y), TU_BATCH)
    held = ListDataSetIterator(DataSet(hx, hy), TU_BATCH)
    steps = []

    def model_fn(p):
        net = MultiLayerNetwork(tu_lenet_conf(lr=p["lr"], dense=p["n_out"])).init()
        net.fit(train, epochs=1)
        steps.append(net.iteration)
        return net

    def score_fn(net, p):
        return DataSetLossCalculator(held).calculate_score(net)

    space = {"lr": LogUniform(1e-4, 1e-2), "n_out": Choice(100, 500)}
    grid = {"lr": Choice(1e-4, 1e-2), "n_out": Choice(100, 500)}
    paths, row = {}, {"card": card}
    for name, search, run in (
            ("random", RandomSearch(space, model_fn, score_fn),
             lambda s: s.optimize(TU_HPO_TRIALS, seed=TU_HPO_SEED)),
            ("grid", GridSearch(grid, model_fn, score_fn), lambda s: s.optimize())):
        steps.clear()
        zero_launches(ck)
        best = run(search)
        torch.cuda.synchronize()
        paths[f"tu_hpo_{name}"] = launches = read_launches(ck)
        row[name] = {"trials": [[t.params, t.score] for t in search.trials],
                     "best": best.params, "launches": launches, "steps": sum(steps)}
        if unexpected_launches(launches, {"fused_adam": LENET_TENSORS * sum(steps)}):
            raise RuntimeError(f"training_utilities (e) {name}: launches {launches}")
    # the same seed's draws on the CPU, with no training
    cpu = RandomSearch(space, lambda p: None, lambda m, p: 0.0)
    cpu.optimize(TU_HPO_TRIALS, seed=TU_HPO_SEED)
    row["random_draws_equal_cpu"] = [t.params for t in cpu.trials] == \
        [p for p, _ in row["random"]["trials"]]
    print("training_utilities (e) " + json.dumps(row), flush=True)
    if not row["random_draws_equal_cpu"]:
        raise RuntimeError("training_utilities (e): the draws differ from the CPU's")
    return paths


def tu_ui(card, storage, best, held, tmp):
    """(f): the UI server over (a)'s stats and the ROC page of (a)'s best
    model."""
    import urllib.request

    from deeplearning4j_tpu_torch.eval.tools import export_roc_charts_to_html_file
    from deeplearning4j_tpu_torch.ui import UIServer

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return json.loads(r.read())

    server = UIServer(port=0)
    server.attach(storage)
    try:
        base = f"http://127.0.0.1:{server.start()}"
        sessions = get("/train/sessions")
        overview = get("/train/overview/tu_lenet")
        model = get("/train/model/tu_lenet")
    finally:
        server.stop()
    reports = storage.get_num_update_records_for("tu_lenet")
    page = os.path.join(tmp, "roc.html")
    export_roc_charts_to_html_file(best.evaluate_roc_multi_class(held), page)
    row = {"card": card, "sessions": sessions, "reports": reports,
           "overview_iterations": len(overview["iterations"]),
           "overview_scores": len(overview["scores"]), "model_layers": model["layer_names"],
           "roc_page_bytes": os.path.getsize(page)}
    print("training_utilities (f) " + json.dumps(row), flush=True)
    if not (sessions == ["tu_lenet"] and row["overview_iterations"] == reports
            == row["overview_scores"] and model["layer_names"]):
        raise RuntimeError(f"training_utilities (f): {row}")


def training_utilities_phase(ck, card):
    """Early stopping, listeners, Solver, gradient checks, search and the
    UI on the card (see TU_*). Returns each path's launches."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.nn import helpers

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tu_")
    paths = {}
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        es_paths, storage, best, held = tu_early_stopping(ck, card, tmp)
        paths.update(es_paths)
        paths.update(tu_search(ck, card))
    finally:
        helpers.clear_helper("updater")
    try:
        paths.update(tu_gpt2_stats(ck, card, tmp))
        paths["tu_gradient_check"] = tu_gradient_checks(ck, card)
        tu_ui(card, storage, best, held, tmp)
        paths["tu_solver"] = tu_solver(ck, card)
    finally:
        storage.close()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return paths


def sr_launch_check(ck, what, got, f32_forwards, bf16_forwards, layers):
    """Raises unless ``got`` (read_launches) holds ``layers`` K3a launches
    for each f32 forward, as many K3a-bf16 for each bf16 one, and no
    other kernel's launch."""
    want = {"flash_attention_fwd": layers * f32_forwards,
            "flash_attention_fwd_bf16": layers * bf16_forwards}
    bad = unexpected_launches(got, want)
    if bad:
        raise RuntimeError(f"serving_registry {what}: launches {bad}, want {want}")


def sr_answer_error(out, ref):
    """The served-answer limit's reading, max |a - b| - rtol |b|, and its
    limit SERVE_ATOL."""
    out, ref = (np.asarray(a, np.float32) for a in (out, ref))
    return float((np.abs(out - ref) - SERVE_RTOL * np.abs(ref)).max()), SERVE_ATOL


def sr_calibration_cpu(net, policy, sample):
    """The port's calibration on the CPU, of ``net``'s weights copied there."""
    from deeplearning4j_tpu_torch.serving import quantize
    from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    cpu = load_reference_params(TransformerLM().init(device="cpu"), export_params(net))
    return quantize.calibrate(cpu, quantize.quantize_model(cpu, policy), sample)


def serving_registry_phase(ck, card):
    """The model registry serving GPT-2-small in four versions, with a hot
    swap and a canary under load, a crash served through, tracing and the
    cost ledger (see SR_*). Returns each path's launches."""
    from deeplearning4j_tpu_torch.nn.train_step import to_host
    from deeplearning4j_tpu_torch.observe import cost, metrics, trace
    from deeplearning4j_tpu_torch.observe.export import text_timeline
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.serving.quantize import param_nbytes
    from deeplearning4j_tpu_torch.util import faultinject
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    t_phase = time.perf_counter()
    name, paths, row = "gpt2", {}, {"card": card}
    reg_metrics = metrics.MetricsRegistry()
    ledger = cost.CostLedger(reg_metrics)
    tracer = trace.enable_tracing(metrics=reg_metrics)
    reg = ModelRegistry(metrics=reg_metrics, max_batch_size=8, buckets=(1, 2, 4, 8),
                        max_dispatcher_restarts=2, breaker=SR_BREAKER, cost=ledger)
    try:
        v1_net = TransformerLM(seed=SR_SEEDS[0]).init()
        v2_net = TransformerLM(seed=SR_SEEDS[1]).init()
        vocab = v1_net.conf.vertices["embed"].obj.n_in
        layers = sum(1 for n in v1_net.conf.topo_order if n.endswith("-att"))
        rng = np.random.default_rng(21)
        reqs = rng.integers(0, vocab, (SR_REQUESTS, 1, SR_T)).astype(np.float32)
        sample = rng.integers(0, vocab, (SR_SAMPLE, SR_T)).astype(np.float32)
        t0 = time.perf_counter()
        reg.register(name, v1_net, input_shape=(SR_T,))
        reg.register(name, v2_net, activate=False, input_shape=(SR_T,))
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        req0 = torch.cuda.memory_stats().get("requested_bytes.all.current")
        reg.register(name, v2_net, activate=False, dtype_policy="int8", sample_input=sample)
        torch.cuda.synchronize()
        growth = torch.cuda.memory_allocated() - mem0
        req1 = torch.cuda.memory_stats().get("requested_bytes.all.current")
        reg.register(name, v2_net, activate=False, dtype_policy="bf16", sample_input=sample)
        row["register_s"] = time.perf_counter() - t0
        served = reg.get(name)
        versions = {v: mv.model for v, mv in served.versions.items()}
        v3_bytes, v2_bytes = versions[3].param_nbytes, param_nbytes(v2_net.params)
        row["int8_on_card"] = {"memory_growth_bytes": growth,
                               "requested_growth_bytes": None if req0 is None else req1 - req0,
                               "v3_param_nbytes": v3_bytes,
                               "v2_param_nbytes": v2_bytes, "growth_over_v3": growth / v3_bytes,
                               "int8_tensors_on_card": sorted({
                                   str(q.q.dtype) + "@" + q.q.device.type
                                   for named in versions[3].qparams.values()
                                   for q in named.values() if hasattr(q, "q")})}
        if not abs(growth / v3_bytes - 1.0) <= SR_GROWTH_TOL:
            raise RuntimeError(f"serving_registry: v3 grew the card by {growth} bytes, "
                               f"param_nbytes {v3_bytes}")

        # ---- hot swap and canary under load
        picks = []
        pick = served.pick_weighted

        def recorded_pick():
            v = pick()
            picks.append(v)
            return v

        served.pick_weighted = recorded_pick
        answers, lock = [None] * SR_REQUESTS, threading.Lock()
        done, errors = [0], []

        def client(c):
            try:
                for j in range(c, SR_REQUESTS, SR_CLIENTS):
                    t_req = time.perf_counter()
                    out, v = reg.predict_versioned(name, reqs[j])
                    answers[j] = (out, v, time.perf_counter() - t_req)
                    with lock:
                        done[0] += 1
                        n = done[0]
                    if n == SR_ACTIVATE_AT:
                        reg.activate(name, 2)
                    elif n == SR_SPLIT_AT:
                        reg.set_traffic_split(name, {3: SR_CANARY})
            except Exception as e:  # noqa: BLE001 — reported and failed below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(SR_CLIENTS)]
        batches0 = served.inference.batches_dispatched
        tracer.recorder.clear()
        zero_launches(ck)
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        paths["serving_registry_load"] = got = read_launches(ck)
        batches = served.inference.batches_dispatched - batches0
        served.pick_weighted = pick
        if errors or any(th.is_alive() for th in threads):
            raise RuntimeError(f"serving_registry: {errors or 'client hung'}")
        canary = [i for i, v in enumerate(picks) if v == 3]
        if not (picks and canary == list(range(2, len(picks), 4))):
            raise RuntimeError(f"serving_registry: split picks {picks}")
        sr_launch_check(ck, "load", got, batches + len(canary), 0, layers)
        spans = tracer.recorder.spans()

        # every answer against its served version's own output on its row
        worst = {}
        for j, (out, v, _) in enumerate(answers):
            ref = to_host(versions[v].output(reqs[j]))
            reading, limit = sr_answer_error(out, ref)
            worst[v] = max(worst.get(v, -math.inf), reading)
            if not reading <= limit:
                raise RuntimeError(f"serving_registry: request {j} on v{v}: {reading} "
                                   f"> {limit}")
        lat = {}
        for out, v, s in answers:
            lat.setdefault(v, []).append(s * 1e3)
        row["load"] = {
            "requests": SR_REQUESTS, "clients": SR_CLIENTS, "tokens_per_request": SR_T,
            "wall_s": wall, "requests_per_s": SR_REQUESTS / wall,
            "batches_dispatched": batches, "canary_picks": len(canary),
            "wrr_picks": len(picks),
            "by_version": {v: {"requests": len(ms), "p50_ms": float(np.percentile(ms, 50)),
                               "p99_ms": float(np.percentile(ms, 99)),
                               "worst_reading": worst[v]}
                           for v, ms in sorted(lat.items())},
            "answer_limit": {"rtol": SERVE_RTOL, "atol": SERVE_ATOL}}

        # one queue_wait per request and one batch_execute per batch, linked
        by = {}
        for sp in spans:
            by.setdefault(sp.name, []).append(sp)
        dispatched = [sp.span_id for b in by.get("batch_execute", []) for sp in b.links]
        waits = {}
        for q in by.get("queue_wait", []):
            waits[q.parent_id] = waits.get(q.parent_id, 0) + 1
        if not (len(by.get("batch_execute", [])) == batches
                and len(dispatched) == len(set(dispatched)) == SR_REQUESTS - len(canary)
                and all(waits.get(r) == 1 for r in dispatched)
                and sum(waits.values()) == len(dispatched)):
            raise RuntimeError(f"serving_registry: spans {dict((k, len(v)) for k, v in by.items())}"
                               f", {len(dispatched)} linked requests")
        cons = ledger.conservation()
        exemplars = metrics.exemplar_trace_ids(reg_metrics)
        trace_ids = {sp.trace_id for sp in spans}
        if not (cons["ok"] and exemplars and exemplars <= trace_ids):
            raise RuntimeError(f"serving_registry: conservation {cons}, exemplars {exemplars}")
        row["trace"] = {
            "spans": {k: len(v) for k, v in sorted(by.items())},
            "kernel_build_spans": sum(sp.name == "kernel_build"
                                      for sp in tracer.recorder.spans()),
            "compile_count": tracer.compile_count,
            "exemplar_trace_ids": len(exemplars),
            "ledger_device_ms_per_request": cons["device_ms"] / max(cons["requests"], 1),
            "ledger": {k: cons[k] for k in ("device_ms", "attributed_device_ms",
                                            "unattributed_device_ms", "requests",
                                            "batches", "error_ms", "ok")}}
        print("serving_registry timeline (last batch)\n"
              + text_timeline(spans, limit=6), flush=True)

        # ---- the bf16 version, pinned: every layer on K3a-bf16
        zero_launches(ck)
        bf16_outs = [reg.predict_versioned(name, reqs[j], version=4)
                     for j in range(SR_BF16_REQUESTS)]
        paths["serving_registry_bf16"] = got = read_launches(ck)
        sr_launch_check(ck, "bf16", got, 0, SR_BF16_REQUESTS, layers)
        readings = []
        for j, (out, v) in enumerate(bf16_outs):
            reading, limit = sr_answer_error(out, to_host(versions[4].output(reqs[j])))
            readings.append(reading)
            if v != 4 or not reading <= limit:
                raise RuntimeError(f"serving_registry: bf16 request {j}: v{v}, {reading} "
                                   f"> {limit}")
        row["bf16_pinned"] = {"requests": SR_BF16_REQUESTS, "worst_reading": max(readings),
                              "limit": {"rtol": SERVE_RTOL, "atol": SERVE_ATOL}}

        # ---- a crash served through the fallback chain
        reg.clear_traffic_split(name)
        reg.set_fallback(name, ["previous"])
        seq = served.inference._forward_seq
        faultinject.set_plan(faultinject.FaultPlan.parse({"faults": [
            {"type": "crash_forward", "model": name, "step": seq}]}))
        zero_launches(ck)
        crash = []
        for j in range(SR_CRASH_REQUESTS):
            out, v = reg.predict_versioned(name, reqs[j])
            crash.append((j, out, v, reg.breaker_state(name)))
        state = served.inference.restart_state()
        wait_s = max(SR_BREAKER["cooldown_s"], state["retry_after_s"] or 0.0) + 0.05
        time.sleep(wait_s)
        out, v = reg.predict_versioned(name, reqs[0])  # the probe: a restart
        crash.append((0, out, v, reg.breaker_state(name)))
        paths["serving_registry_crash"] = got = read_launches(ck)
        sr_launch_check(ck, "crash", got, len(crash), 0, layers)
        state = served.inference.restart_state()
        transitions = served.breakers[2].describe()["transitions"]
        moves = [(t["from"], t["to"]) for t in transitions]
        if not ([c[2] for c in crash] == [1] * SR_CRASH_REQUESTS + [2]
                and state["restarts_used"] == 1 and not state["crashed"]
                and moves == [("closed", "open"), ("open", "half_open"),
                              ("half_open", "closed")]):
            raise RuntimeError(f"serving_registry: crash served by {[c[2] for c in crash]}, "
                               f"{state}, {moves}")
        for j, out, v, _ in crash:
            reading, limit = sr_answer_error(out, to_host(versions[v].output(reqs[j])))
            if not reading <= limit:
                raise RuntimeError(f"serving_registry: crash request {j} on v{v}: "
                                   f"{reading} > {limit}")
        row["crash"] = {"served_by": [c[2] for c in crash], "breaker_after": [c[3] for c in crash],
                        "restart_state": state, "waited_s": wait_s,
                        "transitions": [{**t, "at": t["at"] - transitions[0]["at"]}
                                        for t in transitions],
                        "degraded": {",".join(f"{k}={v}" for k, v in key): n
                                     for key, n in metrics.parse_prometheus_text(
                                         reg_metrics.exposition())
                                     ["serving_degraded_requests_total"].items()}}
        faultinject.set_plan(None)
        # where a batch-8 dispatch spends its time: the forward (CUDA
        # events) and the copy of its [8, SR_T, vocab] f32 answer to the host
        x8 = torch.from_numpy(reqs[:8].reshape(8, SR_T)).cuda()
        fwd_ms = median_ms(lambda: v2_net.output(x8), runs=5, warmup=1)
        out8 = v2_net.output(x8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out8.cpu()
        row["batch8"] = {"forward_ms": fwd_ms,
                         "copy_to_host_ms": (time.perf_counter() - t0) * 1e3,
                         "answer_bytes": out8.numel() * out8.element_size()}
        del out8
        row["seconds_on_card"] = time.perf_counter() - t_phase

        # ---- calibration on the card beside the port's on the CPU
        quant = {v: served.versions[v].quant_error for v in (3, 4)}
        t0 = time.perf_counter()
        cpu = {v: sr_calibration_cpu(v2_net, p, sample) for v, p in ((3, "int8"), (4, "bf16"))}
        row["calibration"] = {f"v{v}": {"policy": p, "card_rel_err": quant[v]["rel_err"],
                                        "cpu_rel_err": cpu[v]["rel_err"],
                                        "card_max_abs_err": quant[v]["max_abs_err"],
                                        "cpu_max_abs_err": cpu[v]["max_abs_err"]}
                              for v, p in ((3, "int8"), (4, "bf16"))}
        row["cpu_calibration_s"] = time.perf_counter() - t0
        ratio = {v: quant[v]["rel_err"] / cpu[v]["rel_err"] for v in (3, 4)}
        if not (abs(ratio[3] - 1.0) <= SR_INT8_CAL_TOL
                and 1 / SR_BF16_CAL_BAND <= ratio[4] <= SR_BF16_CAL_BAND):
            raise RuntimeError(f"serving_registry: calibration {row['calibration']}")
    finally:
        faultinject.set_plan(None)
        reg.shutdown()
        trace.disable_tracing()
        torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    print("serving_registry " + json.dumps(row), flush=True)
    if not row["phase_s"] <= SR_MAX_SECONDS:
        raise RuntimeError(f"serving_registry: the phase took {row['phase_s']:.1f} s")
    return paths


class ResponseLog:
    """Wraps a ``ModelServingClient``'s request so each calling thread
    keeps its last response's headers and body (the served version, the
    device ms, the frame); the client's own spans and retries stay as
    they are."""

    def __init__(self, client):
        self.local = threading.local()
        self._request = client._request
        client._request = self

    def __call__(self, path, data=None, headers=None):
        status, body, hdrs = self._request(path, data, headers)
        self.local.last = (hdrs, body)
        return status, body, hdrs

    def last(self):
        return self.local.last


def count_syncs(fn):
    """``fn()`` and the host synchronisations it made
    (``torch.cuda.set_sync_debug_mode("warn")``'s warnings)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def hs_span_tree(spans):
    """Per client trace: the span names by parent, and the batch that
    linked its inference_request; the HTTP layer's ms (client_predict
    less inference_request) of each dispatched request."""
    by_id = {sp.span_id: sp for sp in spans}
    linked = {ln.span_id for sp in spans if sp.name == "batch_execute" for ln in sp.links}
    traces, http_ms = {}, []
    for sp in spans:
        if sp.name != "client_predict":
            continue
        kids = [c for c in spans if c.trace_id == sp.trace_id]
        names = {c.name: (by_id[c.parent_id].name if c.parent_id in by_id else None)
                 for c in kids}
        inf = [c for c in kids if c.name == "inference_request"]
        traces[sp.trace_id] = (names, bool(inf) and inf[0].span_id in linked)
        if inf:
            http_ms.append(sp.duration_ms - inf[0].duration_ms)
    return traces, http_ms


def hs_mlp():
    """A small MLP on the card (Dense 16→32 tanh, softmax over 3) for the
    JSON requests."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(DenseLayer(n_out=32, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(16)).build())
    return MultiLayerNetwork(conf).init()


def hs_training(ck, card):
    """The watchdog and the trace listener on the zoo LeNet's Adam steps,
    and example 26's diverging run under early stopping. Returns (row,
    launches by path)."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.observe import metrics, trace
    from deeplearning4j_tpu_torch.observe.health import TrainingWatchdog, attach_observability
    from deeplearning4j_tpu_torch.optimize import (
        DataSetLossCalculator, EarlyStoppingConfiguration, EarlyStoppingTrainer,
        MaxEpochsTerminationCondition)

    row, paths = {"card": card}, {}
    x, y = tu_data(HS_LENET_BATCH * HS_LENET_STEPS, 3)
    probe = tu_data(HS_LENET_BATCH, 4)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        bare = MultiLayerNetwork(tu_lenet_conf()).init()
        bare.fit(x[:HS_LENET_BATCH], y[:HS_LENET_BATCH])  # the first step: cuDNN's choices
        _, bare_syncs = count_syncs(lambda: bare.fit(ListDataSetIterator(
            DataSet(x, y), HS_LENET_BATCH), epochs=1))
        net = MultiLayerNetwork(tu_lenet_conf()).init()
        net.fit(x[:HS_LENET_BATCH], y[:HS_LENET_BATCH])
        reg_metrics, tracer = metrics.MetricsRegistry(), trace.Tracer()
        wd = TrainingWatchdog(model_name="lenet", metrics=reg_metrics, check_params_every=1,
                              gradient_batch=probe, action="raise")
        attach_observability(net, tracer=tracer, metrics=reg_metrics, model_name="lenet",
                             watchdog=wd)
        zero_launches(ck)
        t0 = time.perf_counter()
        _, syncs = count_syncs(lambda: net.fit(ListDataSetIterator(
            DataSet(x, y), HS_LENET_BATCH), epochs=1))
        torch.cuda.synchronize()
        row["lenet_watched_s"] = time.perf_counter() - t0
        paths["http_serving_watchdog"] = got = read_launches(ck)
        bad = unexpected_launches(got, {"fused_adam": tensors_of(net) * HS_LENET_STEPS})
        parsed = metrics.parse_prometheus_text(reg_metrics.exposition())
        steps = parsed["training_steps_total"][(("model", "lenet"),)]
        if bad or wd.events or steps != HS_LENET_STEPS:
            raise RuntimeError(f"http_serving watchdog: launches {bad}, events "
                               f"{[e.to_dict() for e in wd.events]}, steps {steps}")
        spans = sum(sp.name == "train_iteration" for sp in tracer.recorder.spans())
        # each read the listeners add, one at a time
        by_check = {
            "watchdog_score": count_syncs(lambda: wd._check_score(net))[1],
            "watchdog_params": count_syncs(lambda: wd._check_params(net))[1],
            "watchdog_gradient_probe": count_syncs(lambda: wd._check_gradients(net))[1],
            "trace_listener": count_syncs(lambda: net.listeners[0].iteration_done(
                net, net.iteration, net.epoch))[1]}
        row["watchdog"] = {
            "steps": HS_LENET_STEPS, "batch": HS_LENET_BATCH, "events": 0,
            "host_syncs_by_check": by_check,
            "k2_per_step": got["fused_adam"] / HS_LENET_STEPS,
            "host_syncs_per_step": syncs / HS_LENET_STEPS,
            "host_syncs_per_step_without_listeners": bare_syncs / HS_LENET_STEPS,
            "train_iteration_spans": spans}
    finally:
        helpers.clear_helper("updater")

    # example 26's explosive run: SGD at lr 1000 on MSE, ended as "Error"
    rng = np.random.default_rng(0)
    dx = rng.normal(size=(64, 8)).astype(np.float32)
    dy = dx @ rng.normal(size=(8, 1)).astype(np.float32)
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(1000.0)).list()
            .layer(DenseLayer(n_in=8, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=1, activation="identity", loss="mse"))
            .build())
    div = MultiLayerNetwork(conf).init()
    attach_observability(div, trace=False, watchdog={"action": "raise",
                                                     "divergence_windows": 3})
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(ListDataSetIterator(DataSet(dx, dy), 16)),
        epoch_termination_conditions=[MaxEpochsTerminationCondition(50)])
    zero_launches(ck)
    result = EarlyStoppingTrainer(cfg, div, ListDataSetIterator(DataSet(dx, dy), 16)).fit()
    paths["http_serving_diverging"] = got = read_launches(ck)
    row["diverging"] = {"termination_reason": result.termination_reason,
                        "termination_details": result.termination_details,
                        "total_epochs": result.total_epochs}
    if result.termination_reason != "Error" or unexpected_launches(got, {}):
        raise RuntimeError(f"http_serving diverging run: {row['diverging']}, launches {got}")
    return row, paths


def http_serving_phase(ck, card):
    """GPT-2-small served over HTTP through the port's ``ModelServer`` and
    ``ModelServingClient``, with the endpoints, resilience and the
    training-side watchdog (see HS_*). Returns each path's launches."""
    from deeplearning4j_tpu_torch.nn.train_step import to_host
    from deeplearning4j_tpu_torch.observe import alerts, cost, metrics, slo, trace
    from deeplearning4j_tpu_torch.parallel.inference import host_answer
    from deeplearning4j_tpu_torch.parallel.time_source import ManualTimeSource
    from deeplearning4j_tpu_torch.serving import (BrownoutController, ModelRegistry,
                                                  ModelServer, ModelServingClient,
                                                  RetryPolicy, ServingError)
    from deeplearning4j_tpu_torch.streaming.codec import serialize_array
    from deeplearning4j_tpu_torch.util import faultinject
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    t_phase = time.perf_counter()
    name, paths, row = "gpt2", {}, {"card": card}
    reg_metrics = metrics.MetricsRegistry()
    ledger = cost.CostLedger(reg_metrics)
    tracer = trace.enable_tracing(metrics=reg_metrics)
    reg = ModelRegistry(metrics=reg_metrics, max_batch_size=8, buckets=(1, 2, 4, 8),
                        max_dispatcher_restarts=2, breaker=SR_BREAKER, cost=ledger)
    servers, clients = [], []
    try:
        v1_net = TransformerLM(seed=SR_SEEDS[0]).init()
        v2_net = TransformerLM(seed=SR_SEEDS[1]).init()
        mlp = hs_mlp()
        vocab = v1_net.conf.vertices["embed"].obj.n_in
        layers = sum(1 for n in v1_net.conf.topo_order if n.endswith("-att"))
        rng = np.random.default_rng(22)
        reqs = rng.integers(0, vocab, (HS_REQUESTS, 1, SR_T)).astype(np.float32)
        sample = rng.integers(0, vocab, (SR_SAMPLE, SR_T)).astype(np.float32)
        json_x = rng.normal(size=(HS_JSON_REQUESTS, HS_JSON_ROWS, 16)).astype(np.float32)
        t0 = time.perf_counter()
        reg.register(name, v1_net, input_shape=(SR_T,))
        reg.register(name, v2_net, activate=False, input_shape=(SR_T,))
        reg.register(name, v2_net, activate=False, dtype_policy="int8", sample_input=sample)
        reg.register(name, v2_net, activate=False, dtype_policy="bf16", sample_input=sample)
        reg.register("mlp", mlp, input_shape=(16,))
        row["register_s"] = time.perf_counter() - t0
        served = reg.get(name)
        versions = {v: mv.model for v, mv in served.versions.items()}
        server = ModelServer(reg, metrics=reg_metrics, max_inflight=64, cost=ledger)
        servers.append(server)
        server.start()
        client = ModelServingClient(server.url, timeout=120.0)
        clients.append(client)
        log = ResponseLog(client)

        # ---- the load: binary frames from HS_CLIENTS threads, the canary on
        reg.set_traffic_split(name, {3: SR_CANARY})
        answers, lock, done, errors, probes = [None] * HS_REQUESTS, threading.Lock(), [0], [], {}

        def worker(c):
            try:
                for j in range(c, HS_REQUESTS, HS_CLIENTS):
                    t_req = time.perf_counter()
                    out = client.predict(name, reqs[j], binary=True)
                    hdrs, body = log.last()
                    answers[j] = (out, int(hdrs["X-Model-Version"]), hdrs.get("X-Device-Ms"),
                                  time.perf_counter() - t_req, len(body))
                    with lock:
                        done[0] += 1
            except Exception as e:  # noqa: BLE001 — reported and failed below
                errors.append(repr(e))

        def prober():
            """The operator's endpoints while the load runs."""
            try:
                while done[0] < HS_CLIENTS and not errors:
                    time.sleep(0.01)
                for path in ("/readyz", "/livez?verbose=1", "/v1/models", "/metrics"):
                    status, body, _ = client._request(path)
                    probes[path] = (status, body.decode() if path == "/metrics"
                                    else json.loads(body))
                probes["answered_before"] = done[0]
            except Exception as e:  # noqa: BLE001
                errors.append("prober " + repr(e))

        threads = [threading.Thread(target=worker, args=(c,)) for c in range(HS_CLIENTS)]
        threads.append(threading.Thread(target=prober))
        batches0 = served.inference.batches_dispatched
        tracer.recorder.clear()
        zero_launches(ck)
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        paths["http_serving_load"] = got = read_launches(ck)
        batches = served.inference.batches_dispatched - batches0
        if errors or any(th.is_alive() for th in threads):
            raise RuntimeError(f"http_serving: {errors or 'a client hung'}")
        canary = sum(1 for a in answers if a[1] == 3)
        sr_launch_check(ck, "http load", got, batches + canary, 0, layers)
        spans = tracer.recorder.spans()

        # ---- v4 pinned: bf16 frames
        zero_launches(ck)
        bf16_frames = []
        for j in range(HS_BF16_REQUESTS):
            client.predict(name, reqs[j], version=4, binary=True)
            hdrs, body = log.last()
            bf16_frames.append((int(hdrs["X-Model-Version"]), body))
        paths["http_serving_bf16"] = got = read_launches(ck)
        sr_launch_check(ck, "http bf16", got, 0, HS_BF16_REQUESTS, layers)

        # ---- JSON on the small network
        json_out = [client.predict("mlp", json_x[j]) for j in range(HS_JSON_REQUESTS)]
        status, body, _ = client._request("/metrics")
        scraped = metrics.parse_prometheus_text(body.decode())
        status, body, _ = client._request("/debug/capture?seconds=600")
        capture = json.loads(body)

        # every answer against its served version's own output on its row
        worst = {}
        for j, (out, v, _, _, _) in enumerate(answers):
            reading, limit = sr_answer_error(out, to_host(versions[v].output(reqs[j])))
            worst[v] = max(worst.get(v, -math.inf), reading)
            if not reading <= limit:
                raise RuntimeError(f"http_serving: request {j} on v{v}: {reading} > {limit}")
        bf16_equal = []
        for j, (v, body) in enumerate(bf16_frames):
            own = serialize_array(host_answer(versions[4].output(reqs[j])))
            header = json.loads(body[4:4 + int.from_bytes(body[:4], "big")])
            bf16_equal.append(v == 4 and body == own and header["dtype"] == "bfloat16")
        json_worst = max(sr_answer_error(np.asarray(o), to_host(mlp.output(json_x[j])))[0]
                         for j, o in enumerate(json_out))
        if not (all(bf16_equal) and json_worst <= SERVE_ATOL):
            raise RuntimeError(f"http_serving: bf16 frames equal {bf16_equal}, "
                               f"JSON reading {json_worst}")

        # the endpoints, the metrics against the clients' counts, the spans
        served_200 = HS_REQUESTS + HS_BF16_REQUESTS
        requests_200 = scraped["serving_requests_total"].get(
            (("model", name), ("status", "200")))
        probe_ok = (probes["/readyz"][0] == 200 and probes["/readyz"][1]["ready"]
                    and probes["/livez?verbose=1"][0] == 200
                    and probes["/livez?verbose=1"][1]["status"] == "ok"
                    and [len(m["versions"]) for m in probes["/v1/models"][1]["models"]
                         if m["name"] == name] == [4]
                    and "serving_requests_total" in probes["/metrics"][1])
        traces, http_ms = hs_span_tree(spans)
        linked = [t for t, (names, batched) in traces.items() if batched
                  and names.get("http_request") == "client_predict"
                  and names.get("inference_request") == "http_request"
                  and names.get("queue_wait") == "inference_request"]
        cap_names = {e["name"] for e in capture["trace"]["traceEvents"] if e["ph"] == "X"}
        device_ms = [float(a[2]) for a in answers if a[2] is not None]
        billed = reg_metrics.get("request_device_ms").sum(model=name, priority="1")
        if not (probe_ok and requests_200 == served_200
                and len(linked) == HS_REQUESTS - canary and len(traces) == HS_REQUESTS
                and {"client_predict", "http_request", "queue_wait",
                     "batch_execute"} <= cap_names
                and len(device_ms) == HS_REQUESTS - canary
                and abs(sum(device_ms) - billed) <= 1e-6 * len(device_ms)):
            raise RuntimeError(
                f"http_serving: probes {probe_ok}, 200s {requests_200} of {served_200}, "
                f"{len(linked)} linked traces of {len(traces)}, capture {sorted(cap_names)}, "
                f"X-Device-Ms {sum(device_ms)} against {billed}")
        lat = {}
        for _, v, _, s, _ in answers:
            lat.setdefault(v, []).append(s * 1e3)
        row["load"] = {
            "requests": HS_REQUESTS, "clients": HS_CLIENTS, "tokens_per_request": SR_T,
            "wall_s": wall, "requests_per_s": HS_REQUESTS / wall,
            "batches_dispatched": batches, "canary_answers": canary,
            "answer_frame_bytes": answers[0][4],
            "by_version": {v: {"requests": len(ms), "p50_ms": float(np.percentile(ms, 50)),
                               "p99_ms": float(np.percentile(ms, 99)),
                               "worst_reading": worst[v]}
                           for v, ms in sorted(lat.items())},
            "http_layer_ms": {"requests": len(http_ms),
                              "p50": float(np.percentile(http_ms, 50)),
                              "p99": float(np.percentile(http_ms, 99)),
                              "what": "client_predict span less inference_request span"},
            "x_device_ms_sum": sum(device_ms), "ledger_billed_ms": billed,
            "answer_limit": {"rtol": SERVE_RTOL, "atol": SERVE_ATOL}}
        row["bf16_pinned"] = {"requests": HS_BF16_REQUESTS, "frames_equal_own_output": True,
                              "frame_bytes": len(bf16_frames[0][1])}
        row["json"] = {"requests": HS_JSON_REQUESTS, "worst_reading": json_worst}
        row["endpoints"] = {"probed_after_answers": probes["answered_before"],
                            "serving_requests_total_200": requests_200,
                            "capture_spans": capture["bounds"]["span_count"],
                            "linked_traces": len(linked)}
        row["seconds_to_here"] = time.perf_counter() - t_phase

        # ---- resilience on a second server of one slot, over the same registry
        reg.clear_traffic_split(name)
        reg.set_fallback(name, [2])
        burst_metrics, clock, notes = metrics.MetricsRegistry(), ManualTimeSource(0), []
        mgr = alerts.AlertManager(burst_metrics, alerts.load_rules({"rules": [HS_BURN]}),
                                  [alerts.CallbackSink(notes.append)], time_source=clock)
        brown = BrownoutController(alerts=mgr, watch_rules=(HS_BURN["name"],),
                                   enter_after_s=0.0, exit_after_s=5.0, time_source=clock,
                                   metrics=burst_metrics)
        slos = slo.load_slos({"slos": [{"name": "gpt2_availability", "sli": "availability",
                                        "metric": "serving_requests_total",
                                        "error_labels": {"status": "429"},
                                        "objective": 0.99}]})
        small = ModelServer(reg, metrics=burst_metrics, max_inflight=1, cost=ledger,
                            alerts=mgr, brownout=brown, slo=slos)
        servers.append(small)
        small.start()
        sclient = ModelServingClient(small.url, timeout=120.0)
        clients.append(sclient)
        slog = ResponseLog(sclient)
        mgr.evaluate_once()
        for j in range(4):
            sclient.predict("mlp", json_x[j % HS_JSON_REQUESTS])
        clock.advance(10)
        mgr.evaluate_once()
        batches0 = served.inference.batches_dispatched
        zero_launches(ck)
        gate, burst = threading.Barrier(HS_CLIENTS), [None] * HS_CLIENTS

        def burster(c):
            try:
                gate.wait(timeout=60)
                sclient.predict(name, reqs[c], binary=True)
                burst[c] = 200
            except ServingError as e:
                burst[c] = (e.status, e.retry_after_s)
            except Exception as e:  # noqa: BLE001
                burst[c] = repr(e)

        threads = [threading.Thread(target=burster, args=(c,)) for c in range(HS_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        clock.advance(10)
        fired = mgr.evaluate_once()
        # the rule fires; the brownout it drives sheds priority 0 and
        # degrades an un-pinned request to the fallback version
        try:
            sclient.predict(name, reqs[0], binary=True, priority=0)
            shed = None
        except ServingError as e:
            shed = (e.status, e.retry_after_s)
        degraded_out = sclient.predict(name, reqs[1], binary=True)
        dh, _ = slog.last()
        degraded = (dh.get("X-Degraded"), int(dh["X-Model-Version"]))
        status, body, _ = sclient._request("/alerts")
        alerts_firing = json.loads(body)["firing"]
        clock.advance(10)
        held = mgr.evaluate_once()  # the shed 429 lands in this sample
        clock.advance(400)
        for j in range(HS_RECOVERY):
            sclient.predict("mlp", json_x[j % HS_JSON_REQUESTS])
        resolved = mgr.evaluate_once()  # the short window holds recovery alone
        status, body, _ = sclient._request("/slo")
        slo_status = json.loads(body)
        status, body, _ = sclient._request("/alerts")
        alerts_after = json.loads(body)["firing"]
        for _ in range(2):  # clear, then clear for exit_after_s: lifted
            clock.advance(10)
            sclient.predict("mlp", json_x[0])
        brownout_after = brown.describe()
        burst_batches = served.inference.batches_dispatched - batches0
        burst_ok = sum(1 for b in burst if b == 200)
        paths["http_serving_resilience"] = got = read_launches(ck)
        # the admitted burst requests' batches, the degraded forward on v2
        sr_launch_check(ck, "http resilience", got, burst_batches + 1, 0, layers)
        rejected = [b for b in burst if isinstance(b, tuple)]
        reading, limit = sr_answer_error(degraded_out, to_host(versions[2].output(reqs[1])))
        if not (rejected and all(b[0] == 429 and b[1] is not None for b in rejected)
                and burst_ok + len(rejected) == HS_CLIENTS
                and [n.state for n in fired] == ["firing"] and not held
                and [n.state for n in resolved] == ["resolved"]
                and [n.state for n in notes] == ["firing", "resolved"]
                and shed is not None and shed[0] == 429
                and degraded == ("brownout", 2) and reading <= limit
                and alerts_firing == [HS_BURN["name"]] and alerts_after == []
                and not brownout_after["active"]
                and [t["active"] for t in brownout_after["transitions"]] == [True, False]):
            raise RuntimeError(f"http_serving resilience: burst {burst}, fired {fired}, "
                               f"resolved {resolved}, shed {shed}, degraded {degraded}, "
                               f"{reading}, alerts {alerts_firing} then {alerts_after}, "
                               f"brownout {brownout_after}")
        row["resilience"] = {
            "burst": {"requests": HS_CLIENTS, "served": burst_ok, "rejected_429": len(rejected),
                      "retry_after_s": sorted({b[1] for b in rejected})},
            "burn_rule": {"fired_value": fired[0].value, "resolved_value": resolved[0].value,
                          "notifications": [n.state for n in notes]},
            "brownout": {"shed_priority_0": list(shed), "degraded": list(degraded),
                         "degraded_reading": reading,
                         "transitions": [t["active"] for t in brownout_after["transitions"]]},
            "slo": [{"name": e["name"], "compliance": e["compliance"],
                     "alert": e["alert"]["state"]} for e in slo_status["slos"]]}

        # a dropped response, retried by a client with a RetryPolicy
        rmetrics = metrics.MetricsRegistry()
        rclient = ModelServingClient(server.url, timeout=120.0, metrics=rmetrics,
                                     retry=RetryPolicy(max_retries=2, base_s=0.01))
        clients.append(rclient)
        rclient.predict("mlp", json_x[0])  # the connection the fault then drops
        seq = server._req_seq["mlp"]
        faultinject.set_plan(faultinject.FaultPlan.parse({"faults": [
            {"type": "drop_response", "model": "mlp", "step": seq}]}))
        dropped_out = rclient.predict("mlp", json_x[1])
        faultinject.set_plan(None)
        rparsed = metrics.parse_prometheus_text(rmetrics.exposition())
        reconnects = rparsed.get("client_reconnects_total", {}).get((), 0)
        dropped = metrics.parse_prometheus_text(reg_metrics.exposition())[
            "serving_dropped_responses_total"].get((("model", "mlp"),))
        reading, limit = sr_answer_error(np.asarray(dropped_out), to_host(mlp.output(json_x[1])))
        if not (reconnects == 1 and dropped == 1 and reading <= limit):
            raise RuntimeError(f"http_serving drop_response: reconnects {reconnects}, "
                               f"dropped {dropped}, {reading}")

        # a crash at the next dispatch, served through the fallback chain
        faultinject.set_plan(faultinject.FaultPlan.parse({"faults": [
            {"type": "crash_forward", "model": name, "step": served.inference._forward_seq}]}))
        zero_launches(ck)
        crash_out = client.predict(name, reqs[2], binary=True)
        ch, _ = log.last()
        faultinject.set_plan(None)
        paths["http_serving_crash"] = got = read_launches(ck)
        sr_launch_check(ck, "http crash", got, 1, 0, layers)
        crash_v = int(ch["X-Model-Version"])
        reading, limit = sr_answer_error(crash_out, to_host(versions[crash_v].output(reqs[2])))
        state = served.inference.restart_state()
        if not (crash_v == 2 and ch.get("X-Degraded") == "breaker" and reading <= limit
                and state["crashed"]):
            raise RuntimeError(f"http_serving crash: v{crash_v}, {ch.get('X-Degraded')}, "
                               f"{reading}, {state}")
        row["faults"] = {"drop_response": {"reconnects": reconnects, "dropped": dropped},
                         "crash_forward": {"served_by": crash_v,
                                           "x_degraded": ch.get("X-Degraded"),
                                           "restart_pending": state["restart_pending"]}}
    finally:
        faultinject.set_plan(None)
        for c in clients:
            c.close()
        for srv in servers:
            srv.stop(drain=False)
        reg.shutdown()
        trace.disable_tracing()
        torch.cuda.empty_cache()
    row["serving_s"] = time.perf_counter() - t_phase
    row["training"], train_paths = hs_training(ck, card)
    paths.update(train_paths)
    row["phase_s"] = time.perf_counter() - t_phase
    print("http_serving " + json.dumps(row), flush=True)
    load = row["load"]
    print(f"http_serving summary: {load['requests_per_s']:.2f} requests/s at "
          f"{HS_CLIENTS} clients; p50/p99 ms by version "
          + ", ".join(f"v{v} {d['p50_ms']:.1f}/{d['p99_ms']:.1f}"
                      for v, d in load["by_version"].items())
          + f"; HTTP layer {load['http_layer_ms']['p50']:.2f} ms a request (p50), "
          f"{load['http_layer_ms']['p99']:.2f} (p99); answer frame "
          f"{load['answer_frame_bytes']} bytes; the phase {row['phase_s']:.1f} s", flush=True)
    if not row["phase_s"] <= HS_MAX_SECONDS:
        raise RuntimeError(f"http_serving: the phase took {row['phase_s']:.1f} s")
    return paths


# ---------------------------------------------------------------- the NLP stack
def nlp_corpus():
    """This repository's .py and .md files in sorted path order (hidden and
    build directories skipped): ``[(path, lines)]``."""
    root = os.path.dirname(os.path.abspath(__file__))
    paths = []
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if not x.startswith(".") and x not in NLP_SKIP_DIRS]
        paths += [os.path.relpath(os.path.join(d, f), root) for f in files
                  if f.endswith((".py", ".md"))]
    out = []
    for rel in sorted(paths):
        with open(os.path.join(root, rel), encoding="utf-8", errors="replace") as f:
            out.append((rel, f.read().split("\n")))
    return out


def nlp_write_lines(path, lines):
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


def nlp_twin(model, device, dtype=None):
    """A copy of ``model`` whose lookup table holds copies of its tables on
    ``device`` (in ``dtype``): the same vocabulary and values."""
    import copy

    twin = copy.copy(model)
    twin.device = torch.device(device)
    twin.elements_algorithm = type(model.elements_algorithm)()
    table = twin.lookup_table = copy.copy(model.lookup_table)
    table.device = twin.device
    for n in ("_syn0", "syn1", "syn1neg"):
        t = getattr(table, n)
        if t is not None:
            setattr(table, n, t.detach().to(device, dtype or t.dtype, copy=True))
    table.touch()
    return twin


def nlp_tables(model):
    t = model.lookup_table
    return {n: getattr(t, n) for n in ("syn0", "syn1neg") if getattr(t, n) is not None}


class NlpHostSplit:
    """Host seconds of skip-gram's parts while it is installed: the window
    draws and pairs (``generate_sg_pairs``), the negative draws
    (``_sample_negatives``) and the rest of ``train_pairs`` (the index copy
    and the launches); each sentence's host ms and its words."""

    def __init__(self):
        from deeplearning4j_tpu_torch.nlp import learning

        self.learning, self.cls = learning, learning.ElementsLearningAlgorithm
        self.orig = (learning.generate_sg_pairs, self.cls._sample_negatives,
                     self.cls.train_pairs, learning.SkipGram.train_sequence)
        self.s = {"pairs": 0.0, "negatives": 0.0, "train_pairs": 0.0}
        self.step_ms, self.words = [], 0

    def _timed(self, key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[key] += time.perf_counter() - t0
        return run

    def __enter__(self):
        pairs, neg, train, seq = self.orig

        def train_sequence(algo, s, lr, keep=None):
            t0 = time.perf_counter()
            n = seq(algo, s, lr, keep)
            if n:
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.words += len(s)
            return n

        self.learning.generate_sg_pairs = self._timed("pairs", pairs)
        self.cls._sample_negatives = self._timed("negatives", neg)
        self.cls.train_pairs = self._timed("train_pairs", train)
        self.learning.SkipGram.train_sequence = train_sequence
        return self

    def __exit__(self, *exc):
        (self.learning.generate_sg_pairs, self.cls._sample_negatives,
         self.cls.train_pairs, self.learning.SkipGram.train_sequence) = self.orig

    def reading(self):
        steps = max(len(self.step_ms), 1)
        return {"steps": len(self.step_ms), "words": self.words,
                "median_step_host_ms": float(np.median(self.step_ms)) if self.step_ms else None,
                "host_ms_per_step": {
                    "pairs": self.s["pairs"] * 1e3 / steps,
                    "negative_draws": self.s["negatives"] * 1e3 / steps,
                    "copy_and_launches": (self.s["train_pairs"] - self.s["negatives"])
                    * 1e3 / steps}}


def nlp_device_events(prof):
    """(kernel launches, copies, device ms) of a finished torch.profiler run."""
    kernels = copies = 0
    ms = 0.0
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
        ms += us / 1e3
    return kernels, copies, ms


def nlp_word2vec(ck, files, tmp):
    """(a): the native scan against its fallback, Word2Vec over the corpus
    on the card (timed, the host split), its nearest words, and the twin
    over a prefix. Returns (model, row, failures, launches)."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.nlp import Word2Vec, vocab

    lines = [line for _, text in files for line in text]
    cut = lines if NLP_W2V_LINES is None else lines[:NLP_W2V_LINES]
    path = nlp_write_lines(os.path.join(tmp, "corpus.txt"), cut)
    failures = []
    available = native.native_available()
    t0 = time.perf_counter()
    scanned = vocab.scan_corpus_file(path)
    scan_s = time.perf_counter() - t0
    lib, failed = native._lib, native._build_failed
    native._lib, native._build_failed = None, True
    try:
        t0 = time.perf_counter()
        fallback = vocab.scan_corpus_file(path)
        fallback_s = time.perf_counter() - t0
    finally:
        native._lib, native._build_failed = lib, failed
    if not (available and list(scanned.items()) == list(fallback.items())):
        failures.append("native scan")
    model = Word2Vec(**NLP_W2V)
    t0 = time.perf_counter()
    model.build_vocab_from_file(path)
    vocab_s = time.perf_counter() - t0
    zero_launches(ck)
    with NlpHostSplit() as split:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit_file(path)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    launches = read_launches(ck)
    if unexpected_launches(launches, {}):
        failures.append(f"word2vec launches {launches}")
    reading = split.reading()
    nearest = {w: model.words_nearest(w, top_n=8) for w in NLP_NEAREST}
    # the twin: the prefix on the card (profiled), the CPU in f32 and f64
    prefix = nlp_write_lines(os.path.join(tmp, "prefix.txt"), lines[:NLP_TWIN_LINES])
    profiled_steps = []
    short = nlp_write_lines(os.path.join(tmp, "profiled.txt"), lines[:NLP_PROFILED_LINES])

    def prefix_run():
        with NlpHostSplit() as split:
            Word2Vec(**NLP_W2V).fit_file(short)
        profiled_steps.append(len(split.step_ms))

    t0 = time.perf_counter()
    prof, wall_ms, _ = profiled(prefix_run, cpu=False)
    kernels, copies, device_ms = nlp_device_events(prof)
    twin_steps = max(profiled_steps[-1], 1)
    t1 = time.perf_counter()
    card = Word2Vec(**NLP_W2V).fit_file(prefix)  # the same draws, unprofiled
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cpu32 = Word2Vec(**NLP_W2V, device="cpu").fit_file(prefix)
    t3 = time.perf_counter()
    cpu64 = Word2Vec(**NLP_W2V, device="cpu")
    cpu64.build_vocab_from_file(prefix)
    cpu64.lookup_table.to(dtype=torch.float64)
    cpu64.fit_file(prefix)
    twin_s = {"card_profiled": t1 - t0, "card": t2 - t1, "cpu_f32": t3 - t2,
              "cpu_f64": time.perf_counter() - t3}
    twin = sl_against_cpu(nlp_tables(card), nlp_tables(cpu32), nlp_tables(cpu64))
    if twin["failing"] or card.vocab.num_words() != cpu32.vocab.num_words():
        failures.append(f"word2vec twin {twin}")
    row = {"vocab": model.vocab.num_words(), "corpus_lines": len(lines),
           "trained_lines": len(cut), "cut": None if NLP_W2V_LINES is None else NLP_W2V_LINES,
           "native_available": available, "native_scan_s": scan_s,
           "fallback_scan_s": fallback_s, "scan_words": len(scanned),
           "build_vocab_s": vocab_s, "train_s": train_s,
           "words_per_s": reading["words"] / train_s, **reading,
           "launches": launches, "nearest": nearest,
           "twin": {"lines": NLP_TWIN_LINES, "vocab": card.vocab.num_words(),
                    "profiled_lines": NLP_PROFILED_LINES, "profiled_steps": profiled_steps[-1],
                    "kernel_launches_per_step": kernels / twin_steps,
                    "copies_per_step": copies / twin_steps,
                    "device_ms_per_step": device_ms / twin_steps,
                    "wall_ms_per_step": wall_ms / twin_steps,
                    "device_busy_share": device_ms / wall_ms,
                    "seconds": twin_s, "against_cpu": twin}}
    return model, row, failures, launches


def nlp_paragraph_and_glove(files):
    """(b): ParagraphVectors (DBOW, DM) and GloVe on the card against the
    CPU. Returns (row, failures)."""
    from deeplearning4j_tpu_torch.nlp import Glove, ParagraphVectors

    failures, row = [], {}
    docs = [(" ".join(text), [rel]) for rel, text in files
            if rel.startswith(NLP_PV_DIR)][:NLP_PV_FILES]
    for algo in ("dbow", "dm"):
        t0 = time.perf_counter()
        pv = ParagraphVectors(**NLP_PV, sequence_algorithm=algo).fit(docs)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        before = {n: t.clone() for n, t in nlp_tables(pv).items()}
        objects = dict(nlp_tables(pv))
        cpu32, cpu64 = nlp_twin(pv, "cpu"), nlp_twin(pv, "cpu", torch.float64)
        inferred = {}
        t0 = time.perf_counter()
        for i, (text, _) in enumerate(docs[:NLP_PV_INFER]):
            inferred[f"doc{i}"] = torch.from_numpy(pv.infer_vector(text))
        infer_s = time.perf_counter() - t0
        unchanged = all(torch.equal(t, before[n]) and t is objects[n]
                        for n, t in nlp_tables(pv).items())
        against = sl_against_cpu(
            inferred,
            {k: torch.from_numpy(cpu32.infer_vector(t)) for k, (t, _) in
             zip(inferred, docs)},
            {k: torch.from_numpy(cpu64.infer_vector(t)) for k, (t, _) in
             zip(inferred, docs)})
        row[f"paragraph_vectors_{algo}"] = {
            "documents": len(docs), "vocab": pv.vocab.num_words(),
            "labels": len(pv.labels), "fit_s": fit_s,
            "infer_ms": infer_s * 1e3 / NLP_PV_INFER, "table_unchanged": unchanged,
            "infer_against_cpu": against}
        if against["failing"] or not unchanged:
            failures.append(f"paragraph vectors {algo}")
    lines = [line for _, text in files for line in text][:NLP_GLOVE_LINES]
    t0 = time.perf_counter()
    card = Glove(**NLP_GLOVE).fit(lines)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu32 = Glove(**NLP_GLOVE, device="cpu").fit(lines)
    cpu64 = Glove(**NLP_GLOVE, device="cpu", dtype=torch.float64).fit(lines)
    cpu_s = time.perf_counter() - t0
    against = sl_against_cpu(nlp_tables(card), nlp_tables(cpu32), nlp_tables(cpu64))
    row["glove"] = {"lines": len(lines), "vocab": card.vocab.num_words(), "fit_s": fit_s,
                    "cpu_twins_s": cpu_s, "against_cpu": against}
    if against["failing"]:
        failures.append("glove")
    return row, failures


def nlp_file_bytes(path, fmt):
    """A file's bytes; a zip's members (its container holds write times)."""
    import zipfile

    if fmt == "zip":
        with zipfile.ZipFile(path) as zf:
            return {n: zf.read(n) for n in zf.namelist()}
    with open(path, "rb") as f:
        return f.read()


def nlp_serializer(model, tmp):
    """(c): the word vectors written from the card and from a CPU copy, and
    read back onto both. Returns (row, failures)."""
    from deeplearning4j_tpu_torch.nlp import WordVectorSerializer as S

    cpu = nlp_twin(model, "cpu")
    row, failures = {}, []
    for fmt, (write, read, name) in NLP_FORMATS.items():
        on_card, on_cpu = os.path.join(tmp, f"card_{name}"), os.path.join(tmp, f"cpu_{name}")
        t0 = time.perf_counter()
        getattr(S, write)(model, on_card)
        write_s = time.perf_counter() - t0
        getattr(S, write)(cpu, on_cpu)
        t0 = time.perf_counter()
        back = getattr(S, read)(on_card)
        read_s = time.perf_counter() - t0
        back_cpu = getattr(S, read)(on_card, device="cpu")
        got = back.lookup_table.syn0
        r = {"bytes": os.path.getsize(on_card), "write_s": write_s, "read_s": read_s,
             "same_bytes_as_cpu": nlp_file_bytes(on_card, fmt) == nlp_file_bytes(on_cpu, fmt),
             "read_on": str(got.device),
             "card_equals_cpu_read": torch.equal(got.cpu(), back_cpu.lookup_table.syn0),
             "max_abs_from_model": (got - model.lookup_table.syn0).abs().max().item(),
             "words_equal": back.vocab.words() == model.vocab.words()}
        # the text format keeps 6 decimals: 5e-7, and the f32 rounding of
        # what it reads back
        limit = NLP_TEXT_TOL if fmt == "text" else 0.0
        r["ok"] = (r["same_bytes_as_cpu"] and r["card_equals_cpu_read"] and r["words_equal"]
                   and got.device.type == "cuda" and r["max_abs_from_model"] <= limit)
        row[fmt] = r
        if not r["ok"]:
            failures.append(f"serializer {fmt}")
    return row, failures


def nlp_kim_conf():
    """DL4J's CnnSentenceClassificationExample graph at 300-wide vectors,
    NLP_LEN words and NLP_MAPS maps a kernel height."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        GlobalPoolingLayer,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.nn.vertices import MergeVertex

    width = NLP_W2V["layer_size"]
    g = (NeuralNetConfiguration.builder().seed(12345).weight_init("relu")
         .activation("leakyrelu").updater(Adam(0.01)).l2(1e-4)
         .graph_builder().add_inputs("input")
         .set_input_types(InputType.convolutional(NLP_LEN, width, 1)))
    for k in (3, 4, 5):
        g.add_layer(f"cnn{k}", ConvolutionLayer(
            n_out=NLP_MAPS, kernel_size=(k, width), stride=(1, width),
            convolution_mode="same", activation="leakyrelu"), "input")
    g.add_vertex("merge", MergeVertex(), "cnn3", "cnn4", "cnn5")
    g.add_layer("globalPool", GlobalPoolingLayer(pooling_type="max", dropout=0.5), "merge")
    g.add_layer("out", OutputLayer(n_out=2, activation="softmax", loss="mcxent"),
                "globalPool")
    return g.set_outputs("out").build()


def nlp_reviews(model, n, seed):
    """``n`` seeded two-class reviews of NLP_LEN words of ``model``'s
    vocabulary: NLP_PLANTED words of each from its class's planted set
    (drawn among the NLP_PLANTED_FROM frequent words, as a review's
    sentiment words are common ones), the rest from the long tail (the
    words past NLP_FILLER_FROM). Returns (texts, labels, planted)."""
    rng = np.random.default_rng(7)
    words = [w for w in model.vocab.words() if w.split() == [w]]
    frequent = words[NLP_PLANTED_FROM[0]:NLP_PLANTED_FROM[1]]
    chosen = rng.choice(len(frequent), 2 * NLP_PLANTED_SET, replace=False)
    planted = {"negative": [frequent[i] for i in chosen[:NLP_PLANTED_SET]],
               "positive": [frequent[i] for i in chosen[NLP_PLANTED_SET:]]}
    filler = words[NLP_FILLER_FROM:]
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for _ in range(n):
        label = ("negative", "positive")[int(rng.integers(0, 2))]
        tokens = list(rng.choice(filler, NLP_LEN))
        at = rng.choice(NLP_LEN, NLP_PLANTED, replace=False)
        for pos, word in zip(at, rng.choice(planted[label], NLP_PLANTED)):
            tokens[pos] = word
        texts.append(" ".join(tokens))
        labels.append(label)
    return texts, labels, planted


def nlp_batches(model, texts, labels, seed):
    """CnnSentenceDataSetIterator's batches over the reviews, each batch's
    host ms."""
    import random

    from deeplearning4j_tpu_torch.nlp import (
        CnnSentenceDataSetIterator,
        CollectionLabeledSentenceProvider,
    )

    it = CnnSentenceDataSetIterator(
        CollectionLabeledSentenceProvider(texts, labels, rng=random.Random(seed)), model,
        minibatch_size=NLP_BATCH, max_sentence_length=NLP_LEN,
        use_normalized_word_vectors=False, feature_format="NHWC")
    batches, ms = [], []
    while True:
        t0 = time.perf_counter()
        if not it.has_next():
            break
        batches.append(it.next())
        ms.append((time.perf_counter() - t0) * 1e3)
    return it, batches, ms


def nlp_classifier(ck, model, tmp):
    """(d): the CNN sentence classifier on the card. Returns (row,
    failures, paths)."""
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params

    failures, paths = [], {}
    texts, labels, planted = nlp_reviews(model, NLP_BATCH * (1 + NLP_TIMED), seed=1)
    held_texts, held_labels, _ = nlp_reviews(model, NLP_HELD_OUT, seed=2)
    it, batches, batch_ms = nlp_batches(model, texts, labels, seed=3)
    _, held, _ = nlp_batches(model, held_texts, held_labels, seed=4)
    shapes = {tuple(b.features.shape) for b in batches}
    masks = sum(b.features_mask is not None for b in batches + held)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = ComputationGraph(nlp_kim_conf()).init()
        # one batch's loss and gradients against an f64 twin, in the ratio form
        x0, y0 = batches[0].features, batches[0].labels
        g32, loss32 = net.compute_gradient_and_score(x0, y0)
        cpu = load_reference_params(
            ComputationGraph(type(net.conf).from_json(net.conf.to_json()), device="cpu").init(),
            export_params(net))
        gcpu, loss_cpu = cpu.compute_gradient_and_score(x0, y0)
        conf = type(net.conf).from_json(net.conf.to_json())
        conf.global_conf.dtype = "float64"
        twin = load_reference_params(ComputationGraph(conf).init(), export_params(net))
        g64, loss64 = twin.compute_gradient_and_score(x0, y0)
        grads = sl_against_cpu(g32, gcpu, g64)
        loss_rel = abs(loss32 - loss64) / abs(loss64)
        del cpu, twin, g32, gcpu, g64
        net.fit(batches[0].features, batches[0].labels)  # warm-up
        losses = [float(net.score_)]
        zero_launches(ck)
        step_ms = []
        for b in batches[1:]:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            net.fit(b.features, b.labels)
            end.record()
            step_ms.append((start, end))
            losses.append(float(net.score_))
        torch.cuda.synchronize()
        step_ms = [s.elapsed_time(e) for s, e in step_ms]
        paths["nlp_cnn_sentence_train"] = read_launches(ck)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        x, y = batches[-1].features, batches[-1].labels
        profile = profile_steps(net, x, y, fits=2, groups=NLP_GROUPS)
        zero_launches(ck)
        correct = total = 0
        for b in held:
            out = net.output(b.features)
            correct += int((out.argmax(1).cpu() == torch.from_numpy(b.labels).argmax(1)).sum())
            total += len(b.labels)
        paths["nlp_cnn_sentence_output"] = read_launches(ck)
        accuracy = correct / total
        path = os.path.join(tmp, "cnn_sentence.zip")
        net.save(path)
        back = ComputationGraph.load(path)
        want = net.output(held[0].features)
        zip_equal = torch.equal(back.output(held[0].features), want)
        on_cpu = ComputationGraph.load(path, device="cpu")
        single = it.load_single_sentence(held_texts[0])
        p_card = net.output(single).cpu()
        p_cpu = on_cpu.output(single)
        single_row = {"shape": list(single.shape), "card": p_card[0].tolist(),
                      "cpu": p_cpu[0].tolist(),
                      "same_class": int(p_card.argmax()) == int(p_cpu.argmax()),
                      "max_abs_diff": (p_card - p_cpu).abs().max().item()}
    finally:
        helpers.clear_helper("updater")
    median = float(np.median(step_ms))
    first5, last5 = float(np.mean(losses[1:6])), float(np.mean(losses[-5:]))
    row = {"batch_shape": [list(s) for s in shapes], "masks": masks,
           "params": net.conf.num_params(), "tensors": tensors_of(net),
           "iterator_host_ms_per_batch": float(np.median(batch_ms)),
           "iterator_host_ms": batch_ms, "step_ms": step_ms, "median_step_ms": median,
           "examples_per_s": NLP_BATCH / (median / 1e3), "losses": losses,
           "first5_mean": first5, "last5_mean": last5,
           "launches": paths["nlp_cnn_sentence_train"],
           "k2_per_step": paths["nlp_cnn_sentence_train"]["fused_adam"] / NLP_TIMED,
           "output_launches": paths["nlp_cnn_sentence_output"],
           "peak_device_mem_gb": peak_gb, "profile": profile,
           "held_out_accuracy": accuracy, "held_out": total,
           "planted": {k: v[:5] for k, v in planted.items()},
           "batch_against_f64": {"loss_f32": loss32, "loss_cpu_f32": loss_cpu,
                                 "loss_f64": loss64, "loss_rel": loss_rel, **grads},
           "zip_output_equal": zip_equal, "single_sentence": single_row}
    if shapes != {(NLP_BATCH, NLP_LEN, NLP_W2V["layer_size"], 1)} or masks:
        failures.append(f"batches {shapes} masks {masks}")
    if unexpected_launches(paths["nlp_cnn_sentence_train"],
                           {"fused_adam": tensors_of(net) * NLP_TIMED}) or tensors_of(net) != 8:
        failures.append(f"launches {paths['nlp_cnn_sentence_train']}")
    if unexpected_launches(paths["nlp_cnn_sentence_output"], {}):
        failures.append(f"output launches {paths['nlp_cnn_sentence_output']}")
    if not (np.isfinite(losses).all() and last5 < first5):
        failures.append("losses")
    if accuracy < NLP_MIN_ACCURACY:
        failures.append(f"held-out accuracy {accuracy}")
    if grads["failing"] or loss_rel > NLP_TOL:
        failures.append("f64 twin")
    if not zip_equal:
        failures.append("zip")
    if not (single_row["same_class"] and single_row["max_abs_diff"] <= NLP_TOL):
        failures.append("single sentence")
    return row, failures, paths


def nlp_text_classification_phase(ck, card):
    """DL4J's text-classification path on the card (see NLP_*): Word2Vec,
    ParagraphVectors, GloVe, the serializer and the CNN sentence
    classifier. Returns each path's launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nlp_")
    failures, parts_s = [], {}

    def report(name, t0, row, bad):
        parts_s[name] = time.perf_counter() - t0
        failures.extend(bad)
        print(f"nlp_text_classification {name} " + json.dumps({"card": card, **row}),
              flush=True)

    try:
        files = nlp_corpus()
        t0 = time.perf_counter()
        model, w2v, bad, w2v_launches = nlp_word2vec(ck, files, tmp)
        report("word2vec", t0, w2v, bad)
        t0 = time.perf_counter()
        cnn, bad, paths = nlp_classifier(ck, model, tmp)
        report("cnn_sentence", t0, cnn, bad)
        t0 = time.perf_counter()
        others, bad = nlp_paragraph_and_glove(files)
        report("paragraph_vectors_glove", t0, others, bad)
        t0 = time.perf_counter()
        ser, bad = nlp_serializer(model, tmp)
        report("serializer", t0, ser, bad)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print("nlp_text_classification summary " + json.dumps({
        "card": card, "vocab": w2v["vocab"], "words_per_s": w2v["words_per_s"],
        "word2vec_busy_share": w2v["twin"]["device_busy_share"],
        "cnn_median_step_ms": cnn["median_step_ms"],
        "cnn_examples_per_s": cnn["examples_per_s"],
        "iterator_host_ms_per_batch": cnn["iterator_host_ms_per_batch"],
        "held_out_accuracy": cnn["held_out_accuracy"], "phase_s": seconds,
        "parts_s": parts_s, "target_s": NLP_MAX_SECONDS, "failures": failures}), flush=True)
    if failures:
        raise RuntimeError(f"nlp_text_classification: {failures}")
    return {"nlp_word2vec_train": w2v_launches, **paths}


# ------------------------------------------------- graph embeddings and tools
def gc_edges():
    """The seeded BlogCatalog-sized block model (see GC_*): (edges [m, 2],
    each vertex's block)."""
    rng = np.random.default_rng(GC_SEED)
    n, m, k = GC_VERTICES, GC_EDGES, GC_GROUPS
    block = rng.permutation(np.arange(n) % k)
    theta = (1.0 - rng.random(n)) ** (-1.0 / (GC_EXPONENT - 1.0))
    theta = np.minimum(theta * (2.0 * m / n) / theta.mean(), n - 1)
    order = np.argsort(block, kind="stable")          # vertices by block
    cum = np.cumsum(theta[order])
    starts = np.searchsorted(block[order], np.arange(k))
    ends = np.searchsorted(block[order], np.arange(k), side="right")
    before = np.where(starts > 0, cum[np.maximum(starts - 1, 0)], 0.0)
    total = cum[ends - 1] - before
    everyone = np.cumsum(theta)
    keys = np.empty(0, np.int64)
    while keys.size < m:
        draws = int((m - keys.size) * 1.3) + 1000
        u = np.searchsorted(everyone, rng.random(draws) * everyone[-1])
        inside = rng.random(draws) >= GC_OUT_DRAW
        b = block[u]
        v_in = order[np.minimum(np.searchsorted(cum, before[b] + rng.random(draws) * total[b]),
                                n - 1)]
        v_out = np.searchsorted(everyone, rng.random(draws) * everyone[-1])
        v = np.where(inside, v_in, v_out)
        ok = (u != v) & (inside | (block[v] != b))
        keys = np.concatenate([keys, np.minimum(u, v)[ok] * n + np.maximum(u, v)[ok]])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]                   # distinct, in draw order
    keys = keys[:m]
    return np.stack([keys // n, keys % n], axis=1), block


def gc_graph(tmp):
    """(a): the graph written as an edge list and loaded. Returns (graph,
    edges, block, row)."""
    from deeplearning4j_tpu_torch.graph import GraphHuffman, GraphLoader

    t0 = time.perf_counter()
    edges, block = gc_edges()
    make_s = time.perf_counter() - t0
    path = os.path.join(tmp, "blogcatalog_sbm.csv")
    with open(path, "w") as f:
        f.write("\n".join(f"{a},{b}" for a, b in edges.tolist()) + "\n")
    t0 = time.perf_counter()
    graph = GraphLoader.load_undirected_graph_edge_list_file(path, GC_VERTICES)
    graph.csr()
    load_s = time.perf_counter() - t0
    degrees = graph.vertex_degrees()
    tree = GraphHuffman(GC_VERTICES).build_tree(degrees)
    row = {"vertices": graph.num_vertices(), "edges": int(degrees.sum()) // 2,
           "groups": GC_GROUPS, "mean_degree": float(degrees.mean()),
           "largest_degree": int(degrees.max()), "smallest_degree": int(degrees.min()),
           "out_of_block_share": float((block[edges[:, 0]] != block[edges[:, 1]]).mean()),
           "longest_code": max(tree.code_length), "mean_code": float(np.mean(tree.code_length)),
           "make_s": make_s, "load_s": load_s}
    failures = [] if (row["vertices"], row["edges"]) == (GC_VERTICES, GC_EDGES) else ["size"]
    return graph, edges, block, row, failures


def gc_score_pairs(graph, window, device, count=GC_SCORE_PAIRS):
    """``count`` skip-gram pairs of a fixed epoch of walks, on
    ``device``."""
    rng = np.random.default_rng(7)
    walks = graph.random_walks(rng.permutation(graph.num_vertices()),
                               GC_FIT["walk_length"], rng)
    pos = np.arange(window, walks.shape[1] - window)
    offsets = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    first = np.repeat(walks[:, pos][..., None], len(offsets), axis=2).reshape(-1)
    second = walks[:, pos[:, None] + offsets[None, :]].reshape(-1)
    pick = rng.choice(first.size, count, replace=False)
    return (torch.from_numpy(first[pick]).to(device), torch.from_numpy(second[pick]).to(device))


def gc_hs_score(table, firsts, seconds):
    """The mean of -log P(second | first) over the pairs, on the table's
    device."""
    vec = table.vertex_vectors[firsts]
    nodes, bits, mask = (t[seconds] for t in (table._path_nodes, table._path_bits,
                                              table._path_mask))
    dots = torch.einsum("bld,bd->bl", table.out_weights[nodes], vec)
    z = torch.where(bits > 0, dots, -dots)
    return float((torch.nn.functional.softplus(-z) * mask).sum(1).mean())


class GcFitSplit:
    """DeepWalk's parts while installed on a model: host seconds of the
    walks (``Graph.random_walks``), the pairs (``fit_walks`` less its
    steps) and the steps (``iterate_batch``: gathers, launches), each step
    between two CUDA events, and the score at each tenth of ``epochs``."""

    def __init__(self, model, epochs, score):
        self.model, self.score, self.every = model, score, max(epochs // GC_SCORE_POINTS, 1)
        self.s = {"walks": 0.0, "fit_walks": 0.0, "steps": 0.0}
        self.events, self.scores, self.epochs = [], [], 0

    def __enter__(self):
        model, graph, table = self.model, self.model.graph, self.model.lookup_table
        walks, fit_walks, step = graph.random_walks, model.fit_walks, table.iterate_batch

        def timed_walks(*a, **k):
            t0 = time.perf_counter()
            try:
                return walks(*a, **k)
            finally:
                self.s["walks"] += time.perf_counter() - t0

        def timed_step(firsts, seconds):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            step(firsts, seconds)
            end.record()
            self.s["steps"] += time.perf_counter() - t0
            self.events.append((start, end))

        def timed_fit_walks(w):
            t0 = time.perf_counter()
            fit_walks(w)
            self.s["fit_walks"] += time.perf_counter() - t0
            self.epochs += 1
            if self.epochs % self.every == 0:
                self.scores.append((self.epochs, self.score()))

        graph.random_walks, model.fit_walks, table.iterate_batch = (
            timed_walks, timed_fit_walks, timed_step)
        self.installed = (graph, model, table)
        return self

    def __exit__(self, *exc):
        graph, model, table = self.installed
        del graph.random_walks, model.fit_walks, table.iterate_batch

    def reading(self):
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in self.events]
        steps = max(len(ms), 1)
        return {"steps": len(ms), "median_step_ms": float(np.median(ms)) if ms else None,
                "host_ms_per_step": {
                    "walks": self.s["walks"] * 1e3 / steps,
                    "pairs": (self.s["fit_walks"] - self.s["steps"]) * 1e3 / steps,
                    "step": self.s["steps"] * 1e3 / steps},
                "scores": self.scores}


def gc_padding(table, firsts, seconds):
    """Step ms with the table's padded paths (every padded position adds
    0 into inner node 0) and with the padded positions sent to the pair's
    own last inner node (the same values: they add 0 there), in turns on
    copies of the tables; the padded share of the positions."""
    from deeplearning4j_tpu_torch.graph.deepwalk import _hs_batch_update

    nodes, bits, mask = table._path_nodes, table._path_bits, table._path_mask
    last = (mask.sum(1).long() - 1).clamp(min=0)
    spread = torch.where(mask > 0, nodes, nodes.gather(1, last[:, None]))
    vv, ow = table.vertex_vectors.clone(), table.out_weights.clone()

    def timed(path_nodes):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GC_PAD_STEPS):
            _hs_batch_update(vv, ow, firsts, path_nodes[seconds], bits[seconds],
                             mask[seconds], table.learning_rate)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / GC_PAD_STEPS

    timed(nodes)
    ms = {"node_0": [], "own_last_node": []}
    for name, arr in (("node_0", nodes), ("own_last_node", spread),
                      ("own_last_node", spread), ("node_0", nodes)):
        ms[name].append(timed(arr))
    return {"pairs": int(firsts.numel()), "steps": GC_PAD_STEPS,
            "padded_share": float(1.0 - mask[seconds].mean()),
            "ms_per_step": {k: float(np.mean(v)) for k, v in ms.items()}}


def gc_tables(model):
    t = model.lookup_table
    return {"vertex_vectors": t.vertex_vectors, "out_weights": t.out_weights}


def gc_deepwalk(graph):
    """(b): DeepWalk over the graph on the card (timed, the host split, the
    score at each tenth), a profiled epoch on a second model. Returns
    (model, row, failures)."""
    from deeplearning4j_tpu_torch.graph import DeepWalk

    failures = []
    model = DeepWalk(**GC_DEEPWALK)
    model.initialize(graph)
    firsts, seconds = gc_score_pairs(graph, GC_DEEPWALK["window_size"],
                                     model.lookup_table.device)
    start_score = gc_hs_score(model.lookup_table, firsts, seconds)
    with GcFitSplit(model, GC_FIT["epochs"],
                    lambda: gc_hs_score(model.lookup_table, firsts, seconds)) as split:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(graph, **GC_FIT)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    reading = split.reading()
    w = GC_DEEPWALK["window_size"]
    pairs = (GC_FIT["epochs"] * graph.num_vertices()
             * max(GC_FIT["walk_length"] + 1 - 2 * w, 0) * 2 * w)
    second = DeepWalk(**GC_DEEPWALK)
    second.initialize(graph)
    steps_per_epoch = reading["steps"] / GC_FIT["epochs"]
    prof, wall_ms, _ = profiled(
        lambda: second.fit(graph, walk_length=GC_FIT["walk_length"], epochs=1), cpu=False)
    kernels, copies, device_ms = nlp_device_events(prof)
    pad_firsts, pad_seconds = gc_score_pairs(graph, w, model.lookup_table.device,
                                             model.batch_size)
    padding = gc_padding(model.lookup_table, pad_firsts, pad_seconds)
    scores = [start_score] + [s for _, s in reading["scores"]]
    row = {"settings": {**GC_DEEPWALK, **GC_FIT, "batch_size": model.batch_size},
           "fit_s": fit_s, "pairs_per_s": pairs / fit_s, **reading,
           "profiled_epoch": {"steps": steps_per_epoch,
                              "kernel_launches_per_step": kernels / steps_per_epoch,
                              "copies_per_step": copies / steps_per_epoch,
                              "device_ms_per_step": device_ms / steps_per_epoch,
                              "wall_ms_per_step": wall_ms / steps_per_epoch,
                              "device_busy_share": device_ms / wall_ms},
           "score_at_start": start_score, "padding": padding}
    if not (np.isfinite(scores).all() and scores[-1] < scores[0]):
        failures.append(f"deepwalk scores {scores}")
    if model.lookup_table.vertex_vectors.device.type != "cuda":
        failures.append("deepwalk not on the card")
    return model, row, failures


def gc_subgraph(edges):
    """The twin's graph: the subgraph induced by GC_TWIN_VERTICES seeded
    vertices, renumbered (a new Graph each call)."""
    from deeplearning4j_tpu_torch.graph import Graph

    keep = np.sort(np.random.default_rng(11).choice(GC_VERTICES, GC_TWIN_VERTICES,
                                                    replace=False))
    new = np.full(GC_VERTICES, -1)
    new[keep] = np.arange(GC_TWIN_VERTICES)
    sub = new[edges]
    sub = sub[(sub >= 0).all(axis=1)]
    g = Graph(GC_TWIN_VERTICES)
    for a, b in sub.tolist():
        g.add_edge(a, b)
    return g


def gc_twin(edges):
    """(b)'s twin: the subgraph trained from the same carried tables on the
    card and the CPU in f32 and f64; the queries on the card's tables as
    on a CPU copy. Returns (row, failures)."""
    from deeplearning4j_tpu_torch.graph import DeepWalk
    from deeplearning4j_tpu_torch.util.convert import load_reference_graph_lookup_table

    def model(device, start=None, dtype=None):
        m = DeepWalk(**GC_DEEPWALK, device=device)
        m.initialize(gc_subgraph(edges))
        if start is not None:
            load_reference_graph_lookup_table(m, *start)
        if dtype is not None:
            m.lookup_table.to(dtype=dtype)
        return m

    cpu32 = model("cpu")
    start = tuple(t.numpy().copy() for t in gc_tables(cpu32).values())
    card, cpu64 = model(None, start), model("cpu", start, torch.float64)
    seconds = {}
    for name, m in (("card", card), ("cpu_f32", cpu32), ("cpu_f64", cpu64)):
        t0 = time.perf_counter()
        m.fit(m.graph, walk_length=GC_FIT["walk_length"], epochs=GC_TWIN_EPOCHS)
        if name == "card":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    against = sl_against_cpu(gc_tables(card), gc_tables(cpu32), gc_tables(cpu64))
    copy = model("cpu", tuple(t.cpu().numpy() for t in gc_tables(card).values()))
    probes = (0, 1, 17, GC_TWIN_VERTICES // 2, GC_TWIN_VERTICES - 1)
    nearest_equal = ties = 0
    for v in probes:
        mine, theirs = card.vertices_nearest(v, 10).tolist(), copy.vertices_nearest(v, 10).tolist()
        nearest_equal += mine == theirs
        # an order that differs must differ by similarities within GC_SIM_TOL
        ties += mine != theirs and all(
            abs(copy.similarity(v, a) - copy.similarity(v, b)) <= GC_SIM_TOL
            for a, b in zip(mine, theirs))
    sim_diff = max(abs(card.similarity(a, b) - copy.similarity(a, b))
                   for a in probes for b in probes)
    row = {"vertices": GC_TWIN_VERTICES, "edges": int(card.graph.vertex_degrees().sum()) // 2,
           "epochs": GC_TWIN_EPOCHS, "seconds": seconds, "against_cpu": against,
           "vertices_nearest_equal": nearest_equal,
           "vertices_nearest_within_ties": ties, "probes": len(probes),
           "similarity_max_diff": sim_diff}
    failures = []
    if against["failing"]:
        failures.append(f"twin {against}")
    if not (nearest_equal + ties == len(probes) and sim_diff <= GC_SIM_TOL):
        failures.append("twin queries")
    return row, failures


def gc_classifier(ck, vectors, block):
    """(c): the vertex classifier on the card. Returns (row, failures,
    paths)."""
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    rng = np.random.default_rng(5)
    perm = rng.permutation(GC_VERTICES)
    train, held = perm[:GC_VERTICES // 2], perm[GC_VERTICES // 2:]
    labels = np.eye(GC_GROUPS, dtype=np.float32)[block]
    conf = (NeuralNetConfiguration.builder().seed(12345).updater(Adam(0.01)).list()
            .layer(OutputLayer(n_in=vectors.shape[1], n_out=GC_GROUPS, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(vectors.shape[1])).build())
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        net = MultiLayerNetwork(conf).init()
        zero_launches(ck)
        events, losses = [], []
        for _ in range(GC_CLF_EPOCHS):
            order = train[rng.permutation(train.size)]
            for s in range(0, order.size, GC_CLF_BATCH):
                idx = order[s:s + GC_CLF_BATCH]
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                net.fit(vectors[idx], labels[idx])
                end.record()
                events.append((start, end))
                losses.append(float(net.score_))
        torch.cuda.synchronize()
        launches = read_launches(ck)
        out = net.output(vectors[held])
        accuracy = float((out.argmax(1).cpu().numpy() == block[held]).mean())
    finally:
        helpers.clear_helper("updater")
    step_ms = [s.elapsed_time(e) for s, e in events]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    row = {"train": int(train.size), "held_out": int(held.size), "steps": len(step_ms),
           "median_step_ms": float(np.median(step_ms)), "first5_mean": first5,
           "last5_mean": last5, "held_out_accuracy": accuracy, "chance": 1.0 / GC_GROUPS,
           "launches": launches, "k2_per_step": launches["fused_adam"] / len(step_ms)}
    failures = []
    if unexpected_launches(launches, {"fused_adam": 2 * len(step_ms)}) or tensors_of(net) != 2:
        failures.append(f"classifier launches {launches}")
    if not (np.isfinite(losses).all() and last5 < first5):
        failures.append("classifier losses")
    if accuracy < GC_MIN_ACCURACY:
        failures.append(f"classifier accuracy {accuracy}")
    return row, failures, {"graph_clustering_classifier_train": launches}


def gc_purity(assign, block):
    return float(sum(np.bincount(block[assign == c]).max() for c in np.unique(assign))
                 / assign.size)


def gc_kmeans(points, block):
    """(d): KMeans over every vector on the card; from its seeds, a CPU run.
    Returns (row, failures)."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering

    k, max_iter, distance, seed = GC_KMEANS
    km = KMeansClustering.setup(k, max_iter, distance, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km.fit(points)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    start = points[km.seed_indices]
    again = KMeansClustering.setup(k, max_iter, distance, seed=seed)
    t0 = time.perf_counter()
    again.iterate(points, start)
    iterate_s = time.perf_counter() - t0
    short = KMeansClustering.setup(k, GC_KMEANS_PROFILED, distance, seed=seed)
    prof, wall_ms, _ = profiled(lambda: short.iterate(points, start), cpu=False)
    _, _, device_ms = nlp_device_events(prof)
    cpu = KMeansClustering.setup(k, max_iter, distance, seed=seed, device="cpu")
    t0 = time.perf_counter()
    cpu.iterate(points.cpu(), start.cpu())
    cpu_s = time.perf_counter() - t0
    common = min(len(km.iteration_costs), len(cpu.iteration_costs))
    rel = max(abs(a - b) / abs(b) for a, b in zip(km.iteration_costs[:common],
                                                     cpu.iteration_costs[:common]))
    differ = int((km.assignments != cpu.assignments).sum())
    row = {"k": k, "iterations": len(km.iteration_costs),
           "cpu_iterations": len(cpu.iteration_costs), "fit_s": fit_s,
           "ms_per_iteration": iterate_s * 1e3 / len(again.iteration_costs),
           "device_busy_share": device_ms / wall_ms, "cpu_s": cpu_s,
           "purity": gc_purity(km.assignments, block), "first_cost": km.iteration_costs[0],
           "last_cost": km.iteration_costs[-1], "cost_max_rel_diff": rel,
           "assignments_differing": differ}
    failures = []
    if rel > GC_TOL or differ > (1 - GC_MIN_SAME_ASSIGN) * GC_VERTICES:
        failures.append(f"kmeans against cpu {rel} {differ}")
    return row, failures


def gc_block_agreement(points, block, k=GC_K):
    """The mean share of each point's k nearest (itself left out) that
    share its block."""
    from deeplearning4j_tpu_torch.clustering import BruteForceNearestNeighbors

    _, idx = BruteForceNearestNeighbors(points).search_excluding_self(k)
    return float((block[idx] == block[:, None]).mean())


def gc_tsne(vectors, block):
    """(e): exact t-SNE on the card (timed, profiled, its loop checked for
    host reads), the short twin against the CPU, Barnes-Hut on the host.
    Returns (row, failures)."""
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne
    from deeplearning4j_tpu_torch.plot import tsne as T

    rng = np.random.default_rng(9)
    sample = (np.arange(GC_VERTICES) if GC_TSNE_POINTS is None
              else np.sort(rng.choice(GC_VERTICES, GC_TSNE_POINTS, replace=False)))
    search, run = T._binary_search_betas, T._exact_tsne_run
    seen = {}

    def timed_search(*a, **k):
        t0 = time.perf_counter()
        out = search(*a, **k)
        seen["search_s"] = time.perf_counter() - t0
        return out

    def timed_run(p, y0, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = run(p, y0, *a)
        torch.cuda.synchronize()
        seen.update(run_s=time.perf_counter() - t0, p=p, y0=y0, args=a)
        return y

    T._binary_search_betas, T._exact_tsne_run = timed_search, timed_run
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = Tsne(**GC_TSNE).fit_transform(vectors[sample])
        fit_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        T._binary_search_betas, T._exact_tsne_run = search, run
    p, y0, args = seen["p"], seen["y0"], seen["args"]
    short = (GC_TSNE_PROFILED,) + args[1:]
    prof, wall_ms, _ = profiled(lambda: run(p, y0, *short), cpu=False)
    _, _, device_ms = nlp_device_events(prof)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(p, y0, *short)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    yt = torch.from_numpy(y).to(p.device, torch.float64)
    d2 = T.pairwise_distance(yt, yt, "sqeuclidean")
    num = 1.0 / (1.0 + d2)
    num.fill_diagonal_(0.0)
    q = torch.clamp(num / num.sum(), min=1e-12)
    pd = p.double()
    kl = float((pd * torch.log(pd / q)).sum())
    # the twin: GC_TSNE_TWIN_POINTS points on the card, the CPU in f32 and f64
    twin = vectors[sample[:GC_TSNE_TWIN_POINTS]]
    n = len(twin)
    tw = torch.from_numpy(twin)
    d2t = T.pairwise_distance(tw, tw, "sqeuclidean").numpy()
    np.fill_diagonal(d2t, np.inf)
    pc = T._binary_search_betas(np.where(np.isinf(d2t), 1e12, d2t),
                                min(GC_TSNE["perplexity"], (n - 1) / 3.0))
    pt = np.maximum((pc + pc.T) / (2.0 * n), 1e-12)
    yt0 = np.random.default_rng(0).standard_normal((n, 2)) * 1e-4
    twin_args = (GC_TSNE_TWIN_ITERS,) + args[1:3] + (max(n / 16.0, 50.0),)
    runs = {name: run(torch.tensor(pt, dtype=dt, device=dev), torch.tensor(yt0, dtype=dt,
                                                                            device=dev),
                      *twin_args)
            for name, dev, dt in (("card", p.device, torch.float32),
                                  ("cpu32", "cpu", torch.float32),
                                  ("cpu64", "cpu", torch.float64))}
    against = sl_against_cpu({"y": runs["card"]}, {"y": runs["cpu32"]}, {"y": runs["cpu64"]})
    bh_sample = np.sort(rng.choice(GC_VERTICES, GC_BH_POINTS, replace=False))
    t0 = time.perf_counter()
    bh = BarnesHutTsne(perplexity=GC_TSNE["perplexity"], n_iter=GC_BH_ITERS,
                       seed=0).fit_transform(vectors[bh_sample])
    bh_s = time.perf_counter() - t0
    row = {"points": len(sample), "cut": GC_TSNE_POINTS is not None, **GC_TSNE,
           "fit_s": fit_s, "perplexity_search_host_s": seen["search_s"],
           "ms_per_iteration": seen["run_s"] * 1e3 / GC_TSNE["n_iter"],
           "device_busy_share": device_ms / wall_ms, "peak_device_mem_gb": peak_gb,
           "final_kl": kl, "block_agreement_2d_10nn": gc_block_agreement(y, block[sample]),
           "block_agreement_128d_10nn": gc_block_agreement(vectors[sample], block[sample]),
           "sync_check": "no host read in the loop (sync debug mode error)",
           "twin": {"points": n, "iterations": GC_TSNE_TWIN_ITERS, "against_cpu": against},
           "barnes_hut": {"points": GC_BH_POINTS, "iterations": GC_BH_ITERS,
                          "host_s": bh_s, "host_s_per_iteration": bh_s / GC_BH_ITERS,
                          "finite": bool(np.isfinite(bh).all())}}
    failures = []
    if not (np.isfinite(y).all() and np.isfinite(kl)):
        failures.append("tsne not finite")
    if against["failing"]:
        failures.append(f"tsne twin {against}")
    if not row["barnes_hut"]["finite"]:
        failures.append("barnes-hut not finite")
    return row, failures


def gc_nearest(vectors, block):
    """(f), but the server: brute force against the host VPTree, every
    vertex's search_excluding_self, LSH against the CPU port. Returns
    (row, failures)."""
    from deeplearning4j_tpu_torch.clustering import (
        BruteForceNearestNeighbors,
        RandomProjectionLSH,
        VPTree,
        pairwise_distance,
    )

    failures = []
    index = BruteForceNearestNeighbors(vectors)
    index.search_excluding_self(GC_K)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, all_idx = index.search_excluding_self(GC_K)
    all_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(13)
    queries = rng.choice(GC_VERTICES, GC_VPTREE_QUERIES, replace=False)
    cd, ci = index.search(vectors[queries], GC_K)
    t0 = time.perf_counter()
    tree = VPTree(vectors)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [tree.search(vectors[q], GC_K) for q in queries]
    vptree_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    same_sets = tie_sets = 0
    for r, (hd, hi) in enumerate(host):
        mine, theirs = set(ci[r].tolist()), set(hi.tolist())
        if mine == theirs:
            same_sets += 1
            continue
        dist = {**dict(zip(hi.tolist(), hd.tolist())), **dict(zip(ci[r].tolist(), cd[r].tolist()))}
        kth = float(cd[r, -1])
        tie_sets += all(abs(dist[i] - kth) <= GC_TIE_BAND * kth for i in mine ^ theirs)
    tie_order = all(ci[r, j] < ci[r, j + 1] for r in range(len(ci))
                    for j in range(GC_K - 1) if cd[r, j] == cd[r, j + 1])
    # distances: the card's against the CPU port's (the same formula) and f64
    xq, xc = vectors[queries], vectors[ci]
    cpu32 = torch.stack([pairwise_distance(torch.from_numpy(xq[r:r + 1]),
                                           torch.from_numpy(xc[r]))[0]
                         for r in range(len(queries))])
    f64 = torch.from_numpy(np.sqrt(((xc.astype(np.float64)
                                     - xq[:, None, :].astype(np.float64)) ** 2).sum(-1)))
    dist = sl_against_cpu({"d": torch.from_numpy(cd)}, {"d": cpu32}, {"d": f64})
    # LSH on the card and the CPU port, recall@k against brute force
    lsh, lsh_cpu = RandomProjectionLSH(**GC_LSH), RandomProjectionLSH(**GC_LSH, device="cpu")
    t0 = time.perf_counter()
    lsh.make_index(vectors)
    index_s = time.perf_counter() - t0
    lsh_cpu.make_index(vectors)
    flipped = int((lsh.hash_signs(vectors) != lsh_cpu.hash_signs(vectors)).sum())
    lq = rng.choice(GC_VERTICES, GC_LSH_QUERIES, replace=False)
    _, truth = index.search(vectors[lq], GC_K)
    t0 = time.perf_counter()
    got = [lsh.get_all_nearest_neighbors(vectors[q], GC_K)[1] for q in lq]
    lsh_ms = (time.perf_counter() - t0) * 1e3 / len(lq)
    got_cpu = [lsh_cpu.get_all_nearest_neighbors(vectors[q], GC_K)[1] for q in lq]

    def recall(answers):
        return float(np.mean([len(set(a.tolist()) & set(t.tolist())) / GC_K
                              for a, t in zip(answers, truth)]))

    row = {"search_excluding_self_all_ms": all_ms, "all_shape": list(all_idx.shape),
           "vptree": {"queries": len(queries), "build_s": build_s, "ms_per_query": vptree_ms,
                      "same_sets": same_sets, "sets_differing_within_ties": tie_sets},
           "ties_lowest_index_first": tie_order, "distances_against_f64": dist,
           "lsh": {**GC_LSH, "index_s": index_s, "queries": len(lq), "ms_per_query": lsh_ms,
                   "recall_at_k": recall(got), "cpu_recall_at_k": recall(got_cpu),
                   "flipped_sign_bits": flipped,
                   "bits": GC_VERTICES * GC_LSH["hash_length"] * GC_LSH["num_tables"]}}
    if same_sets + tie_sets != len(queries) or not tie_order:
        failures.append(f"brute force against vptree {same_sets} {tie_sets}")
    if dist["failing"]:
        failures.append("brute force distances")
    if all_idx.shape != (GC_VERTICES, GC_K) or (all_idx == np.arange(GC_VERTICES)[:, None]).any():
        failures.append("search_excluding_self")
    return row, failures


def gc_http(url, path, body):
    """(status, JSON) of one request; a raw body is sent as it is."""
    import urllib.error
    import urllib.request

    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def gc_server(vectors, block):
    """(f)'s server: GC_CLIENTS threads of NearestNeighborsClient against
    NearestNeighborsServer on the card. Returns (row, failures)."""
    from deeplearning4j_tpu_torch.clustering import BruteForceNearestNeighbors
    from deeplearning4j_tpu_torch.clustering.server import (
        NearestNeighborsClient,
        NearestNeighborsServer,
    )
    from deeplearning4j_tpu_torch.observe.metrics import MetricsRegistry

    labels = [f"group{b}" for b in block]
    rng = np.random.default_rng(17)
    asks = [("knn", int(i)) if j % 2 == 0 else
            ("knnnew", (vectors[i] + rng.normal(0, 0.01, vectors.shape[1])).astype(np.float32))
            for j, i in enumerate(rng.integers(0, GC_VERTICES, GC_REQUESTS))]
    metrics = MetricsRegistry()
    server = NearestNeighborsServer(vectors, labels, port=0, metrics=metrics)
    on_device = server._index.points.device.type
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    answers, ms = [None] * len(asks), [0.0] * len(asks)
    try:
        def client(start):
            c = NearestNeighborsClient(url, timeout=30)
            for j in range(start, len(asks), GC_CLIENTS):
                kind, what = asks[j]
                t0 = time.perf_counter()
                answers[j] = c.knn(what, GC_K) if kind == "knn" else c.knn_new(what, GC_K)
                ms[j] = (time.perf_counter() - t0) * 1e3

        threads = [threading.Thread(target=client, args=(i,)) for i in range(GC_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        load_s = time.perf_counter() - t0
        alive = sum(t.is_alive() for t in threads)
        bad = [gc_http(url, "/knn", {"ndarray": GC_VERTICES, "k": 2})[0],
               gc_http(url, "/knnnew", {"ndarray": [1.0, 2.0], "k": 2})[0],
               gc_http(url, "/knn", b"{not json")[0]]
    finally:
        server.stop()
    local = BruteForceNearestNeighbors(vectors)
    wrong = 0
    for (kind, what), got in zip(asks, answers):
        if kind == "knn":
            d, i = local.search(vectors[what], GC_K + 1)
            pairs = [(int(a), float(b)) for a, b in zip(i[0], d[0]) if a != what][:GC_K]
        else:
            d, i = local.search(what, GC_K)
            pairs = [(int(a), float(b)) for a, b in zip(i[0], d[0])]
        want = {"results": [{"index": a, "distance": b} for a, b in pairs],
                "labels": [labels[a] for a, _ in pairs]}
        wrong += got != want
    text = metrics.exposition()

    def counted(path, status):
        m = re.search(r'http_requests_total\{server="knn",path="%s",status="%d"\} (\d+)'
                      % (path, status), text)
        return int(m.group(1)) if m else 0

    sent = {p: sum(k == p[1:] for k, _ in asks) for p in ("/knn", "/knnnew")}
    row = {"device": on_device, "clients": GC_CLIENTS, "requests": len(asks),
           "requests_per_s": len(asks) / load_s, "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)), "answers_wrong": wrong,
           "bad_body_statuses": bad,
           "exposition_200": {p: counted(p, 200) for p in sent},
           "exposition_400": counted("/knn", 400) + counted("/knnnew", 400)}
    failures = []
    if (wrong or alive or on_device != "cuda" or bad != [400, 400, 400]
            or row["exposition_200"] != sent or row["exposition_400"] != 3):
        failures.append(f"server {row}")
    return row, failures


def gc_node2vec_and_serializer(graph, model, firsts, seconds, tmp):
    """(g): Node2Vec on the same graph; the serializer from the card and a
    CPU copy. Returns (row, failures)."""
    from deeplearning4j_tpu_torch.graph import (
        GraphVectors,
        GraphVectorSerializer,
        InMemoryGraphLookupTable,
        Node2Vec,
    )

    failures = []
    nv = Node2Vec(**GC_NODE2VEC)
    walks = nv.generate_walks
    walk_s = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = walks(*a, **k)
        walk_s.append(time.perf_counter() - t0)
        return out

    nv.generate_walks = timed
    t0 = time.perf_counter()
    nv.fit(graph, **GC_N2V_FIT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    score = gc_hs_score(nv.lookup_table, firsts, seconds)
    n2v = {**GC_NODE2VEC, **GC_N2V_FIT, "walk_host_s": sum(walk_s), "fit_s": fit_s,
           "score": score, "device": str(nv.lookup_table.vertex_vectors.device)}
    if not np.isfinite(score) or nv.lookup_table.vertex_vectors.device.type != "cuda":
        failures.append("node2vec")
    on_card, on_cpu = os.path.join(tmp, "card.txt"), os.path.join(tmp, "cpu.txt")
    t0 = time.perf_counter()
    GraphVectorSerializer.write_graph_vectors(model, on_card)
    write_s = time.perf_counter() - t0
    table = model.lookup_table
    cpu_table = InMemoryGraphLookupTable(table.n_vertices, table.vector_size(), None,
                                         table.learning_rate, device="cpu")
    cpu_table.vertex_vectors = table.vertex_vectors.cpu()
    GraphVectorSerializer.write_graph_vectors(GraphVectors(cpu_table), on_cpu)
    with open(on_card, "rb") as a, open(on_cpu, "rb") as b:
        same = a.read() == b.read()
    t0 = time.perf_counter()
    back = GraphVectorSerializer.load_txt_vectors(on_card)
    read_s = time.perf_counter() - t0
    back_cpu = GraphVectorSerializer.load_txt_vectors(on_card, device="cpu")
    got = back.lookup_table.vertex_vectors
    ser = {"bytes": os.path.getsize(on_card), "write_s": write_s, "read_s": read_s,
           "same_bytes_as_cpu": same, "read_on": str(got.device),
           "card_read_equal": torch.equal(got, table.vertex_vectors),
           "cpu_read_equal": torch.equal(back_cpu.lookup_table.vertex_vectors,
                                         table.vertex_vectors.cpu())}
    if not (same and ser["card_read_equal"] and ser["cpu_read_equal"]
            and got.device.type == "cuda"):
        failures.append(f"serializer {ser}")
    return {"node2vec": n2v, "serializer": ser}, failures


def graph_clustering_phase(ck, card):
    """DL4J's graph-embedding path on the card (see GC_*): the graph,
    DeepWalk, the vertex classifier, KMeans, t-SNE, nearest neighbours and
    the k-NN server, Node2Vec and the serializer. Returns the classifier's
    launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graph_")
    failures, parts_s, rows = [], {}, {}

    def report(name, t0, row, bad):
        parts_s[name] = time.perf_counter() - t0
        rows[name] = row
        failures.extend(bad)
        print(f"graph_clustering {name} " + json.dumps({"card": card, **row}), flush=True)

    try:
        t0 = time.perf_counter()
        graph, edges, block, row, bad = gc_graph(tmp)
        report("(a) graph", t0, row, bad)
        t0 = time.perf_counter()
        model, row, bad = gc_deepwalk(graph)
        twin, twin_bad = gc_twin(edges)
        report("(b) deepwalk", t0, {**row, "twin": twin}, bad + twin_bad)
        vt = model.lookup_table.vertex_vectors
        vectors = vt.cpu().numpy()
        t0 = time.perf_counter()
        row, bad, paths = gc_classifier(ck, vectors, block)
        report("(c) classifier", t0, row, bad)
        t0 = time.perf_counter()
        row, bad = gc_kmeans(vt, block)
        report("(d) kmeans", t0, row, bad)
        t0 = time.perf_counter()
        row, bad = gc_tsne(vectors, block)
        report("(e) tsne", t0, row, bad)
        t0 = time.perf_counter()
        row, bad = gc_nearest(vectors, block)
        server, server_bad = gc_server(vectors, block)
        report("(f) nearest_neighbours", t0, {**row, "server": server}, bad + server_bad)
        t0 = time.perf_counter()
        firsts, seconds = gc_score_pairs(graph, GC_NODE2VEC["window_size"], vt.device)
        row, bad = gc_node2vec_and_serializer(graph, model, firsts, seconds, tmp)
        report("(g) node2vec_serializer", t0, row, bad)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    dw, clf = rows["(b) deepwalk"], rows["(c) classifier"]
    tsne, nn = rows["(e) tsne"], rows["(f) nearest_neighbours"]
    print("graph_clustering summary " + json.dumps({
        "card": card, "vertices": GC_VERTICES, "edges": GC_EDGES,
        "deepwalk_pairs_per_s": dw["pairs_per_s"], "deepwalk_median_step_ms": dw["median_step_ms"],
        "deepwalk_launches_per_step": dw["profiled_epoch"]["kernel_launches_per_step"],
        "deepwalk_busy_share": dw["profiled_epoch"]["device_busy_share"],
        "deepwalk_scores": dw["scores"], "held_out_accuracy": clf["held_out_accuracy"],
        "kmeans_purity": rows["(d) kmeans"]["purity"],
        "tsne_points": tsne["points"], "tsne_ms_per_iteration": tsne["ms_per_iteration"],
        "server_requests_per_s": nn["server"]["requests_per_s"],
        "server_p50_p99_ms": [nn["server"]["p50_ms"], nn["server"]["p99_ms"]],
        "phase_s": seconds, "parts_s": parts_s, "target_s": GC_MAX_SECONDS,
        "failures": failures}), flush=True)
    if failures:
        raise RuntimeError(f"graph_clustering: {failures}")
    return paths


# the continuous-training phase (37): DL4J's char LSTM (char_lstm_conf) as
# the serving baseline of ``python -m deeplearning4j_tpu_torch.cli
# pipeline``, fed CT_SEQS non-overlapping sequences of CHAR_LEN + 1
# characters from CT_CORPUS (text the port never edits), the tail
# CT_EVAL_FRACTION held out. Run 1 streams true labels and must PROMOTE;
# run 2, on the same state directory, streams labels through a seeded
# permutation of the 77 classes and must ROLLBACK at the gate. CT_CONFIG
# overrides examples/pipeline_config.json's fields. Each TRAIN stage runs
# mini_epochs x batches_per_mini_epoch x CHAR_LEN / CHAR_TBPTT chunks.
CT_CORPUS = ("ARCHITECTURE.md", "SURVEY.md", "PARITY.md", "KNOWN_GAPS.md", "VERDICT.md")
CT_SEQS, CT_EVAL_FRACTION, CT_PERM_SEED = 160, 0.2, 25
CT_CONFIG = {
    "name": "char",
    "train": {"batch_size": CHAR_BATCH, "batches_per_mini_epoch": 2, "mini_epochs": 2},
    "gate": {"metric": "loss", "rel_margin": 0.02},
    "canary": {"schedule": [{"fraction": 0.25, "hold_s": 1}, {"fraction": 0.5, "hold_s": 1}],
               "shadow_sample": 0.5, "poll_s": 0.05},
}
# (b) the broker-fed trainer against a twin fed the same batches from a
# list: each parameter within CT_TWIN_TOL x its largest entry; (c) SIGTERM
# sent when fit CT_PREEMPT_AFTER of CT_PREEMPT_FITS TBPTT fits ends; (e) one
# binary predict within SERVE_RTOL / SERVE_ATOL of ``output``; (f)
# CT_PROFILE_STEPS profiled fits of the first CHAR_BATCH sequences cut to
# CT_PROFILE_LEN characters (the profiler's cost grows with the launches
# it records: 2 fits of 1000 characters took 50 s on an H100). The phase
# is meant to take at most CT_MAX_SECONDS.
CT_TWIN_TOL, CT_PREEMPT_AFTER, CT_PREEMPT_FITS = 1e-6, 1, 2
CT_PROFILE_STEPS, CT_PROFILE_LEN = 1, 5 * CHAR_TBPTT
CT_MAX_SECONDS = 60.0


def ct_data(tmp):
    """The pipeline's two ``.npz`` files (true labels; streamed labels
    permuted), the profile's, and the host arrays: features and labels
    [CT_SEQS, CHAR_LEN, 77] one-hot f32."""
    v = len(CHARS)
    ids = char_corpus(CT_SEQS, CT_CORPUS)
    eye = np.eye(v, dtype=np.float32)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    n_eval = max(1, int(CT_SEQS * CT_EVAL_FRACTION))
    perm = np.random.default_rng(CT_PERM_SEED).permutation(v)
    y_bad = y.copy()
    y_bad[:-n_eval] = y[:-n_eval][..., perm]
    paths = tuple(os.path.join(tmp, f) for f in ("chars.npz", "chars_permuted.npz",
                                                "chars_profile.npz"))
    np.savez(paths[0], features=x, labels=y)
    np.savez(paths[1], features=x, labels=y_bad)
    np.savez(paths[2], features=x[:CHAR_BATCH, :CT_PROFILE_LEN],
             labels=y[:CHAR_BATCH, :CT_PROFILE_LEN])
    return paths, x, y, n_eval


class CtStages:
    """Wraps the pipeline's stages, the trainer's mini-epochs and the
    registry's predict while it is entered: each stage's and mini-epoch's
    seconds and launches (synchronised at both ends), and the predicts."""

    def __init__(self, ck):
        from deeplearning4j_tpu_torch.pipeline import runner, trainer
        from deeplearning4j_tpu_torch.serving import registry

        self.ck, self.log, self.predicts, self._saved = ck, [], 0, []
        for owner, name, kind in ((runner.ContinuousPipeline, "_stage_train", "TRAIN"),
                                  (runner.ContinuousPipeline, "_stage_eval", "EVAL"),
                                  (runner.ContinuousPipeline, "_stage_canary", "CANARY"),
                                  (trainer.ContinuousTrainer, "train_mini_epoch", "fit")):
            self._wrap(owner, name, kind)
        predict = registry.ModelRegistry.predict

        def counted(reg, *a, **k):
            self.predicts += 1
            return predict(reg, *a, **k)

        self._saved.append((registry.ModelRegistry, "predict", predict))
        registry.ModelRegistry.predict = counted

    def _wrap(self, owner, name, kind):
        orig = getattr(owner, name)

        def run(*a, **k):
            torch.cuda.synchronize()
            before, t0 = read_launches(self.ck), time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                torch.cuda.synchronize()
                after = read_launches(self.ck)
                self.log.append({"kind": kind, "s": time.perf_counter() - t0,
                                 "launches": {n: after[n] - before[n] for n in after
                                              if after[n] != before[n]}})

        self._saved.append((owner, name, orig))
        setattr(owner, name, run)

    def restore(self):
        for owner, name, orig in self._saved:
            setattr(owner, name, orig)

    def take(self):
        """The log since the last take, and the predicts."""
        log, predicts = self.log, self.predicts
        self.log, self.predicts = [], 0
        return log, predicts


def ct_run_summary(log, predicts, chunks, n_lstm, n_tensors, examples):
    """A pipeline run's stage seconds, TRAIN's characters/s and the
    canary's requests from the stage log, and its failed checks."""
    bad, fits = [], [e for e in log if e["kind"] == "fit"]
    stages = [e for e in log if e["kind"] != "fit"]
    fit_s = sum(e["s"] for e in fits)
    k1 = sum(e["launches"].get("lstm_sequence", 0) for e in fits)
    k2 = sum(e["launches"].get("fused_adam", 0) for e in fits)
    if (k1, k2) != (n_lstm * chunks, n_tensors * chunks):
        bad.append(f"TRAIN: {k1} K1 and {k2} K2 in {chunks} chunks, expected "
                   f"{n_lstm} and {n_tensors} a chunk")
    row = {"stages_s": {e["kind"]: e["s"] for e in stages},
           "stage_launches": {e["kind"]: e["launches"] for e in stages},
           "fit_s": fit_s, "train_chunks": chunks, "train_k1": k1, "train_k2": k2,
           "train_chars_per_s": examples * CHAR_LEN / fit_s if fit_s else None,
           "canary_requests": predicts}
    return row, bad


def ct_pipeline(ck, tmp, paths, baseline_zip, x, n_eval, net):
    """(a): the ``pipeline`` subcommand twice on one state directory."""
    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.pipeline import PipelineJournal
    from deeplearning4j_tpu_torch.util import model_serializer

    cfg = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "examples", "pipeline_config.json")))
    for section, values in CT_CONFIG.items():
        if isinstance(values, dict):
            cfg[section].update(values)
        else:
            cfg[section] = values
    cfg_path, state = os.path.join(tmp, "pipeline.json"), os.path.join(tmp, "state")
    json.dump(cfg, open(cfg_path, "w"))
    out_zip = os.path.join(tmp, "served.zip")
    train = cfg["train"]
    chunks = train["mini_epochs"] * train["batches_per_mini_epoch"] * CHAR_LEN // CHAR_TBPTT
    examples = train["mini_epochs"] * train["batches_per_mini_epoch"] * train["batch_size"]
    n_lstm = sum(1 for l in net.layers if type(l).__name__ == "LSTMLayer")
    n_tensors = tensors_of(net)
    bad, rows, counts, by_plan = [], {}, {}, {}
    stages = CtStages(ck)
    try:
        for run, data in ((1, paths[0]), (2, paths[1])):
            zero_launches(ck)
            t0 = time.perf_counter()
            rc = cli.main(["pipeline", "--modelPath", baseline_zip, "--dataPath", data,
                           "--config", cfg_path, "--state-dir", state,
                           "--eval-fraction", str(CT_EVAL_FRACTION),
                           "--modelOutputPath", out_zip])
            torch.cuda.synchronize()
            counts[f"continuous_training_pipeline_run{run}"] = read_launches(ck)
            by_plan[f"continuous_training_pipeline_run{run}"] = dict(
                ck.lstm_sequence.launches_by_plan)
            log, predicts = stages.take()
            row, run_bad = ct_run_summary(log, predicts, chunks, n_lstm, n_tensors, examples)
            row.update(rc=rc, s=time.perf_counter() - t0)
            bad += [f"run {run}: {b}" for b in run_bad] + ([f"run {run}: rc {rc}"] if rc else [])
            rows[f"run{run}"] = row
    finally:
        stages.restore()
    records = PipelineJournal(state).records()
    terminals = [(r["run"], r["stage"]) for r in records
                 if r.get("event") == "commit" and r.get("stage") in ("PROMOTE", "ROLLBACK")]
    if terminals != [(1, "PROMOTE"), (2, "ROLLBACK")]:
        bad.append(f"journal terminal commits {terminals}")
    gates = {r["run"]: r["data"] for r in records
             if (r.get("event"), r.get("stage")) == ("commit", "EVAL")}
    canary = {r["run"]: r["data"] for r in records
              if (r.get("event"), r.get("stage")) == ("commit", "CANARY")}
    g1, g2 = gates.get(1, {}), gates.get(2, {})
    if not (g1.get("passed") and g1["candidate"] < g1["baseline"]):
        bad.append(f"run 1 gate {g1}")
    if not (g2 and not g2["passed"] and g2["candidate"] > g2["threshold"]):
        bad.append(f"run 2 gate {g2}")
    for run in (1, 2):
        c = counts[f"continuous_training_pipeline_run{run}"]
        k1_out = c["lstm_sequence"] - rows[f"run{run}"]["train_k1"]
        rows[f"run{run}"]["output_k1"] = k1_out
        k3 = {k: n for k, n in c.items() if k.startswith("flash") and n}
        if k1_out <= 0 or k3 or c["lstm_sequence_bf16"]:
            bad.append(f"run {run}: output-path K1 {k1_out}, K3 {k3}, K1-bf16 "
                       f"{c['lstm_sequence_bf16']}")
    # the served zip against the promoted candidate's, on the card and the CPU
    xs = x[-n_eval:][:4]
    served = model_serializer.restore_model(out_zip)
    promoted = model_serializer.restore_model(os.path.join(state, "candidate_run0001.zip"))
    a, b = served.output(xs), promoted.output(xs)
    cpu_out = model_serializer.restore_model(out_zip, device="cpu").output(xs)
    cpu_diff = (a.cpu() - cpu_out).abs().max().item()
    if not torch.equal(a, b) or cpu_diff > CHAR_OUT_ATOL:
        bad.append(f"served zip: equal to the promoted candidate {torch.equal(a, b)}, "
                   f"CPU {cpu_diff}")
    row = {**rows, "journal_records": len(records), "terminals": terminals,
           "gate": {run: {k: g.get(k) for k in ("candidate", "baseline", "threshold", "passed")}
                    for run, g in gates.items()},
           "canary_shadow": {run: c.get("shadow") for run, c in canary.items()},
           "served_zip_cpu_max_abs_diff": cpu_diff}
    del served, promoted
    return row, bad, counts, by_plan


def ct_broker(ck, baseline_zip, x, y):
    """(b): the streamed batches as codec frames through an EmbeddedBroker
    topic, a Route onto a SocketPublisher, a SocketConsumer and a Route
    into a StreamBuffer; two mini-epochs of a ContinuousTrainer on a clone
    of the baseline against a twin fed the same batches from a list."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.pipeline import ContinuousTrainer, StreamBuffer
    from deeplearning4j_tpu_torch.streaming import (EmbeddedBroker, Route, SocketConsumer,
                                                    SocketPublisher, StreamingDataSetIterator,
                                                    deserialize_dataset, serialize_dataset)
    from deeplearning4j_tpu_torch.util import model_serializer

    n = 4 * CHAR_BATCH
    batches = [DataSet(x[i:i + CHAR_BATCH], y[i:i + CHAR_BATCH]) for i in range(0, n, CHAR_BATCH)]
    frames = [serialize_dataset(b) for b in batches]
    deserialize_dataset(frames[0])  # warm
    decode_ms = []
    for f in frames:
        t0 = time.perf_counter()
        deserialize_dataset(f)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    base = model_serializer.restore_model(baseline_zip)
    net, twin = base.clone(), base.clone()
    del base
    broker, consumer, buffer = EmbeddedBroker(), SocketConsumer(port=0), StreamBuffer()
    publisher = SocketPublisher("127.0.0.1", consumer.port)
    bad = []
    try:
        t0 = time.perf_counter()
        for f in frames:
            broker.publish("chars", f)
        out = Route().from_source(broker.poll("chars", timeout=30.0) for _ in frames) \
            .to_callable(publisher.publish).start()
        into = Route().from_source(StreamingDataSetIterator(
            consumer, num_batches=len(frames), poll_timeout=30.0)).to_callable(buffer.put).start()
        sent, got = out.join(timeout=60), into.join(timeout=60)
        stream_s = time.perf_counter() - t0
        if (sent, got) != (len(frames), len(frames)) or out.error or into.error:
            bad.append(f"routes delivered {sent}, {got} ({out.error!r}, {into.error!r})")
        trainer = ContinuousTrainer(net, buffer, batch_size=CHAR_BATCH,
                                    batches_per_mini_epoch=2, take_timeout_s=5.0,
                                    model_name="char-broker")
        zero_launches(ck)
        t0 = time.perf_counter()
        stats = [trainer.train_mini_epoch() for _ in range(2)]
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_launches(ck)
    finally:
        publisher.close()
        consumer.close()
    for k in range(2):
        twin.fit(batches[2 * k:2 * k + 2], epochs=1)
    worst = max((d.abs().max() / max(t.abs().max(), 1e-30)).item()
                for d, t in ((net.params[i][p] - twin.params[i][p], twin.params[i][p])
                             for i in twin.params for p in twin.params[i]))
    if worst > CT_TWIN_TOL:
        bad.append(f"broker-fed trainer {worst} from the list-fed twin")
    if [s["examples"] for s in stats] != [2 * CHAR_BATCH] * 2:
        bad.append(f"mini-epochs {stats}")
    row = {"frame_bytes": [len(f) for f in frames], "stream_s": stream_s,
           "examples_per_s_through_broker": n / stream_s,
           "decode_host_ms_per_frame": float(np.median(decode_ms)),
           "train_s": train_s, "mini_epochs": stats, "twin_worst_rel": worst,
           "launches": {k: v for k, v in counts.items() if v}}
    del net, twin
    return row, bad, {"continuous_training_broker": counts}


def ct_preemption(ck, tmp, baseline_zip, x, y):
    """(c): SIGTERM at a fixed iteration of the char LSTM's fit under an
    armed PreemptionHandler; the saved zip resumed against the parameters
    at that step boundary."""
    import signal

    from deeplearning4j_tpu_torch.util import model_serializer
    from deeplearning4j_tpu_torch.util.preemption import PreemptionHandler

    net = model_serializer.restore_model(baseline_zip)
    at = CT_PREEMPT_AFTER * math.ceil(CHAR_LEN / CHAR_TBPTT)  # an iteration a chunk
    path = os.path.join(tmp, "preempt.zip")
    handler = PreemptionHandler(net, path, exit_after_save=False)
    save, saves = handler.save, []

    def timed_save():
        t0 = time.perf_counter()
        got = save()
        saves.append(time.perf_counter() - t0)
        return got

    handler.save = timed_save
    boundaries = {}

    class Signaller:
        def iteration_done(self, model, iteration, epoch):
            boundaries[iteration] = (epoch, {(k, n): t.clone() for k, named in model.params.items()
                                             for n, t in named.items()})
            if iteration == at:
                os.kill(os.getpid(), signal.SIGTERM)

    net.listeners.append(Signaller())
    zero_launches(ck)
    handler.arm()
    try:
        for i in range(CT_PREEMPT_FITS):
            net.fit(x[i * CHAR_BATCH:(i + 1) * CHAR_BATCH], y[i * CHAR_BATCH:(i + 1) * CHAR_BATCH])
        torch.cuda.synchronize()
    finally:
        handler.disarm()
    counts = read_launches(ck)
    bad = []
    resumed, state = PreemptionHandler.resume(path)
    epoch, params = boundaries.get(at, (None, {}))
    same = all(torch.equal(resumed.params[k][n], t) for (k, n), t in params.items())
    if not (handler.preempted.is_set() and handler.saved.is_set() and len(saves) == 1
            and state == {"iteration": at, "epoch": epoch}
            and resumed.iteration == at and params and same):
        bad.append(f"preemption: saved {handler.saved.is_set()} ({len(saves)}), state {state}, "
                   f"boundary epoch {epoch}, parameters equal {same}")
    row = {"signal_at_iteration": at, "state": state, "save_s": saves,
           "zip_bytes": os.path.getsize(path), "params_bit_equal": same,
           "final_iteration": net.iteration}
    del net, resumed
    return row, bad, {"continuous_training_preemption": counts}


def ct_evaluate(ck, tmp):
    """(d): ``evaluate`` over a CSV of lenet_data()'s rows on a LeNet of
    InputType.convolutional_flat(28, 28, 1), against an Evaluation of the
    same network's ``output`` on the same batches."""
    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.train_step import to_host
    from deeplearning4j_tpu_torch.util import model_serializer

    x, y = lenet_data()
    flat = x.reshape(len(x), -1)
    net = MultiLayerNetwork(lenet_conf(flat_input=True)).init()
    net.fit(flat[:LENET_BATCH], y[:LENET_BATCH])
    zip_path, csv = os.path.join(tmp, "lenet.zip"), os.path.join(tmp, "lenet.csv")
    model_serializer.write_model(net, zip_path)
    np.savetxt(csv, np.concatenate([flat, y.argmax(1)[:, None]], axis=1), fmt="%.9g",
               delimiter=",")
    zero_launches(ck)
    t0 = time.perf_counter()
    got = cli.evaluate_main(["--model", zip_path, "--csv", csv, "--classes", "10"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = read_launches(ck)
    want = Evaluation(top_n=1)
    for i in range(0, len(flat), 64):
        want.eval(y[i:i + 64], to_host(net.output(flat[i:i + 64])))
    bad = [] if got.stats() == want.stats() else ["evaluate: stats differ from Evaluation"]
    row = {"rows": len(flat), "s": eval_s, "rows_per_s": len(flat) / eval_s,
           "accuracy": got.accuracy()}
    return row, bad, {"continuous_training_evaluate": counts}


def ct_serve(ck, baseline_zip, x):
    """(e): ``serve`` on the char LSTM zip, one binary predict."""
    import urllib.request

    from deeplearning4j_tpu_torch.cli import serve_main
    from deeplearning4j_tpu_torch.serving import ModelServingClient
    from deeplearning4j_tpu_torch.util import model_serializer

    zero_launches(ck)
    t0 = time.perf_counter()
    server = serve_main(["--model", f"char={baseline_zip}", "--port", "0",
                         "--max-batch-size", "4"], block=False)
    bad = []
    try:
        start_s = time.perf_counter() - t0
        with urllib.request.urlopen(server.url + "/readyz", timeout=30) as r:
            ready = r.status
        t0 = time.perf_counter()
        got = ModelServingClient(server.url, timeout=120.0).predict("char", x[:1], binary=True)
        predict_s = time.perf_counter() - t0
    finally:
        server.stop(drain=True, shutdown_registry=True)
    torch.cuda.synchronize()
    counts = read_launches(ck)
    want = model_serializer.restore_model(baseline_zip).output(x[:1]).cpu().numpy()
    close = np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    if ready != 200 or got.shape != want.shape or not close:
        bad.append(f"serve: /readyz {ready}, shape {got.shape}, within the limit {close}")
    row = {"readyz": ready, "start_s": start_s, "predict_s": predict_s,
           "max_abs_diff": float(np.abs(got - want).max())}
    return row, bad, {"continuous_training_serve": counts}


def ct_profile(ck, baseline_zip, data):
    """(f): ``profile`` on the char LSTM zip."""
    from deeplearning4j_tpu_torch.cli import profile_main

    zero_launches(ck)
    report = profile_main(["--modelPath", baseline_zip, "--dataPath", data,
                           "--batchSize", str(CHAR_BATCH), "--steps", str(CT_PROFILE_STEPS)])
    counts = read_launches(ck)
    buckets = report["buckets"]
    bad = []
    if not ("K1 lstm_sequence" in buckets and "K2 fused_adam" in buckets
            and report["device_ms_per_step"] > 0):
        bad.append(f"profile: {report}")
    return report, bad, {"continuous_training_profile": counts}


def continuous_training_phase(ck, card):
    """DL4J's char LSTM retrained and canaried through the ``pipeline``
    subcommand, the broker, preemption, ``evaluate``, ``serve`` and
    ``profile`` (see CT_*). Returns the launches of each path and K1's by
    plan in the pipeline's runs."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util import model_serializer

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ct_")
    failures, parts_s, rows, paths = [], {}, {}, {}

    def report(name, t0, row, bad, counts):
        """A part's seconds, row, failures and launches (by path)."""
        parts_s[name] = time.perf_counter() - t0
        rows[name] = row
        failures.extend(bad)
        paths.update(counts)
        print(f"continuous_training {name} " + json.dumps({"card": card, **row}), flush=True)

    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        t0 = time.perf_counter()
        data, x, y, n_eval = ct_data(tmp)
        net = MultiLayerNetwork(char_lstm_conf()).init()
        baseline_zip = os.path.join(tmp, "char_lstm.zip")
        model_serializer.write_model(net, baseline_zip)
        parts_s["data"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        row, bad, counts, by_plan = ct_pipeline(ck, tmp, data, baseline_zip, x, n_eval, net)
        report("(a) pipeline", t0, row, bad, counts)
        t0 = time.perf_counter()
        row, bad, counts = ct_broker(ck, baseline_zip, x, y)
        report("(b) broker", t0, row, bad, counts)
        t0 = time.perf_counter()
        row, bad, counts = ct_preemption(ck, tmp, baseline_zip, x, y)
        report("(c) preemption", t0, row, bad, counts)
        t0 = time.perf_counter()
        row, bad, counts = ct_evaluate(ck, tmp)
        report("(d) evaluate", t0, row, bad, counts)
        t0 = time.perf_counter()
        row, bad, counts = ct_serve(ck, baseline_zip, x)
        report("(e) serve", t0, row, bad, counts)
        t0 = time.perf_counter()
        row, bad, counts = ct_profile(ck, baseline_zip, data[2])
        report("(f) profile", t0, row, bad, counts)
    finally:
        helpers.clear_helper("updater")
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    pipe = rows["(a) pipeline"]
    print("continuous_training summary " + json.dumps({
        "card": card, "sequences": CT_SEQS, "held_out": n_eval,
        "outcomes": pipe["terminals"], "gate": pipe["gate"],
        "stages_s": {r: pipe[r]["stages_s"] for r in ("run1", "run2")},
        "train_chars_per_s": {r: pipe[r]["train_chars_per_s"] for r in ("run1", "run2")},
        "canary_requests": {r: pipe[r]["canary_requests"] for r in ("run1", "run2")},
        "canary_shadow": pipe["canary_shadow"], "k1_by_plan": by_plan,
        "phase_s": seconds, "parts_s": parts_s, "target_s": CT_MAX_SECONDS,
        "failures": failures}), flush=True)
    if failures:
        raise RuntimeError(f"continuous_training: {failures}")
    return paths, by_plan


# Data- and tensor-parallel training in a world of one NCCL rank (phase 38).
PT_STEPS, PT_AVG_BATCHES, PT_AVG_FREQ, PT_RULES_STEPS = 3, 4, 2, 2
PT_LOSS_RTOL, PT_PARAM_TOL = 1e-6, 1e-5
PT_ES_N, PT_ES_TEST, PT_ES_BATCH, PT_ES_EPOCHS = 512, 128, 64, 2
PT_MAX_SECONDS = 60.0


def pt_gpt2_batch(seed, vocab):
    """A seeded [TRAIN_N, T] batch of token ids (floats, as in serving) and
    its next-token one-hot labels, made on the card."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_N, T))).cuda()
    return ids.float(), F.one_hot(torch.cat([ids[:, 1:], ids[:, -1:]], 1), vocab).float()


def pt_worst(net, twin):
    """``(name, worst)``: the parameter whose largest difference from the
    twin's, over its largest entry, is the largest, and that ratio."""
    from deeplearning4j_tpu_torch.nn.dtensor import full

    worst, name = 0.0, None
    with torch.no_grad():
        for k, named in twin.params.items():
            for n, want in named.items():
                got = full(net.params[k][n])
                r = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
                if r > worst:
                    worst, name = r, f"{k}/{n}"
    return name, worst


def pt_timed(fn):
    """``fn()`` between two CUDA events; returns its device-clock ms."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def pt_gpt2_pair():
    """GPT-2-small (f32, seed 123) and a twin holding the same weights."""
    from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    net = TransformerLM().init()
    twin = load_reference_params(TransformerLM().init(), export_params(net))
    return net, twin


def pt_total(launches):
    """The launches of a list of steps, summed by kernel."""
    return {k: sum(step[k] for step in launches) for k in launches[0]}


def pt_check(part, losses, twin_losses, net, twin, launches, want, failures):
    """Each loss against the twin's (PT_LOSS_RTOL relative), every
    parameter (PT_PARAM_TOL of its largest entry) and the launches of each
    step against ``want``; the findings go into ``failures``."""
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, twin_losses)]
    name, worst = pt_worst(net, twin)
    if not all(np.isfinite(losses)) or max(rel) > PT_LOSS_RTOL:
        failures.append(f"{part}: losses {losses} against the twin's {twin_losses}")
    if worst > PT_PARAM_TOL:
        failures.append(f"{part}: {name} lies {worst} of its largest entry from the twin's")
    for i, got in enumerate(launches):
        bad = unexpected_launches(got, want)
        if bad:
            failures.append(f"{part}: step {i} launched {bad}, expected {want}")
    return {"losses": losses, "twin_losses": twin_losses, "loss_rel": rel,
            "worst_param": name, "worst_param_rel_to_max": worst,
            "launches_per_step": launches}


def pt_shared(ck, mesh, failures):
    """(b) shared gradients: the wrapper's steps against plain ``fit``."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net, twin = pt_gpt2_pair()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    want = {"flash_attention_fwd": n_layers, "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers, "fused_adam": tensors_of(net)}
    x, labels = pt_gpt2_batch(123, vocab)
    pw = ParallelWrapper(net, mesh, mode="shared_gradients")
    launches, losses, twin_losses, wrap_ms, plain_ms = [], [], [], [], []
    for _ in range(PT_STEPS):
        zero_launches(ck)
        wrap_ms.append(pt_timed(lambda: pw.fit(x, labels)))
        launches.append(read_launches(ck))
        losses.append(net.score_)
        plain_ms.append(pt_timed(lambda: twin.fit(x, labels)))
        twin_losses.append(twin.score_)
    row = pt_check("(b) shared_gradients", losses, twin_losses, net, twin, launches,
                   want, failures)
    placements = sorted({str(tuple(p.placements)) for named in net.params.values()
                         for p in named.values()})
    row.update({"wrapper_step_ms": wrap_ms, "plain_fit_step_ms": plain_ms,
                "wrapper_median_ms": float(np.median(wrap_ms)),
                "plain_median_ms": float(np.median(plain_ms)),
                "param_placements": placements,
                "busy": busy(lambda: pw.fit(x, labels), 1)})
    del net, twin, pw, x, labels
    torch.cuda.empty_cache()
    return row, pt_total(launches)


def pt_averaging(ck, mesh, failures):
    """(c) averaging: PT_AVG_BATCHES batches, a flush every PT_AVG_FREQ,
    against as many plain ``fit`` steps."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net, twin = pt_gpt2_pair()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    batches = [DataSet(*pt_gpt2_batch(1000 + i, vocab)) for i in range(PT_AVG_BATCHES)]
    heard = []

    class Flushes:
        def iteration_done(self, model, iteration, epoch):
            heard.append((iteration, model.score_))

    net.set_listeners(Flushes())
    pw = ParallelWrapper(net, mesh, mode="averaging", averaging_frequency=PT_AVG_FREQ)
    zero_launches(ck)
    # one flush a call: the first warms the fresh network, the rest are timed
    wrap_ms = [pt_timed(lambda: pw.fit(batches[i:i + PT_AVG_FREQ], prefetch_depth=0))
               for i in range(0, PT_AVG_BATCHES, PT_AVG_FREQ)]
    got_launches = read_launches(ck)
    twin_steps, plain_ms = [], []
    for ds in batches:
        plain_ms.append(pt_timed(lambda: twin.fit(ds)))
        twin_steps.append(twin.score_)
    # a flush's score is the mean of its local steps' losses
    twin_flush = [float(np.mean(twin_steps[i:i + PT_AVG_FREQ]))
                  for i in range(0, PT_AVG_BATCHES, PT_AVG_FREQ)]
    want_iters = list(range(PT_AVG_FREQ, PT_AVG_BATCHES + 1, PT_AVG_FREQ))
    if [it for it, _ in heard] != want_iters:
        failures.append(f"(c) averaging: iteration_done at {heard}, expected {want_iters}")
    per_step = {"flash_attention_fwd": n_layers, "flash_attention_bwd_dq": n_layers,
                "flash_attention_bwd_dkv": n_layers, "fused_adam": tensors_of(net)}
    want = {k: v * PT_AVG_BATCHES for k, v in per_step.items()}
    row = pt_check("(c) averaging", [sc for _, sc in heard], twin_flush, net, twin,
                   [got_launches], want, failures)
    row.update({"flushes": len(heard), "flush_ms": wrap_ms, "plain_fit_step_ms": plain_ms,
                "wrapper_ms_per_step": float(np.mean(wrap_ms[1:])) / PT_AVG_FREQ,
                "plain_ms_per_step": float(np.mean(plain_ms[PT_AVG_FREQ:]))})
    del net, twin, pw, batches
    torch.cuda.empty_cache()
    return row, got_launches


def pt_rules(ck, failures):
    """(d) ``DEFAULT_2D_RULES`` on a data=1, model=1 mesh: every parameter
    path matches a rule, then PT_RULES_STEPS of the network's own ``fit``
    on DTensors against plain ``fit``."""
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.parallel.sharding import (
        DEFAULT_2D_RULES, lint_partition_rules, match_partition_rules,
        shard_model_with_rules)

    net, twin = pt_gpt2_pair()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    unmatched = [w for w in lint_partition_rules(DEFAULT_2D_RULES, net.params)
                 if "matches no rule" in w]
    if unmatched:
        failures.append(f"(d) rules: {unmatched}")
    specs = match_partition_rules(DEFAULT_2D_RULES, net.params)
    shard_model_with_rules(net, make_mesh({"data": 1, "model": 1}))
    x, labels = pt_gpt2_batch(7, vocab)
    want = {"flash_attention_fwd": n_layers, "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers, "fused_adam": tensors_of(net)}
    launches, losses, twin_losses, wrap_ms = [], [], [], []
    for _ in range(PT_RULES_STEPS):
        zero_launches(ck)
        wrap_ms.append(pt_timed(lambda: net.fit(x, labels)))
        launches.append(read_launches(ck))
        losses.append(net.score_)
        twin.fit(x, labels)
        twin_losses.append(twin.score_)
    row = pt_check("(d) rules", losses, twin_losses, net, twin, launches, want, failures)
    row.update({"sharded_specs": sorted({f"{n}: {tuple(sp)}" for named in specs.values()
                                         for n, sp in named.items() if tuple(sp)}),
                "step_ms": wrap_ms,
                "placements": {k: str(tuple(net.params[k]["W"].placements))
                               for k in ("embed", "out")}})
    del net, twin, x, labels
    torch.cuda.empty_cache()
    return row, pt_total(launches)


def pt_early_stopping(ck, mesh, failures):
    """(e) ``EarlyStoppingParallelTrainer`` on LeNet (Adam, K2 on its 8
    tensors) against ``EarlyStoppingTrainer`` on a twin."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import earlystopping as es
    from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params

    rng = np.random.default_rng(11)
    n = PT_ES_N + PT_ES_TEST
    y_idx = rng.integers(0, 10, n)
    x = rng.normal(0, 0.3, size=(n, 28, 28, 1)).astype(np.float32)
    x[np.arange(n), 2 + y_idx, :, 0] += 2.0
    y = np.eye(10, dtype=np.float32)[y_idx]

    def run(trainer_cls, net, **kw):
        cfg = es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(ListDataSetIterator(
                DataSet(x[PT_ES_N:], y[PT_ES_N:]), PT_ES_BATCH), average=True),
            epoch_termination_conditions=[es.MaxEpochsTerminationCondition(PT_ES_EPOCHS)])
        train = ListDataSetIterator(DataSet(x[:PT_ES_N], y[:PT_ES_N]), PT_ES_BATCH)
        return trainer_cls(cfg, net, train, **kw).fit()

    net = MultiLayerNetwork(lenet_conf()).init()
    twin = load_reference_params(MultiLayerNetwork(lenet_conf()).init(), export_params(net))
    zero_launches(ck)
    t0 = time.perf_counter()
    result = run(es.EarlyStoppingParallelTrainer, net, mesh=mesh)
    torch.cuda.synchronize()
    es_s = time.perf_counter() - t0
    got = read_launches(ck)
    ref = run(es.EarlyStoppingTrainer, twin)
    steps = PT_ES_EPOCHS * (PT_ES_N // PT_ES_BATCH)
    want = {"fused_adam": tensors_of(net) * steps}
    if unexpected_launches(got, want):
        failures.append(f"(e) early stopping: launched {got}, expected {want}")
    scores = [result.score_vs_epoch[e] for e in sorted(result.score_vs_epoch)]
    twin_scores = [ref.score_vs_epoch[e] for e in sorted(ref.score_vs_epoch)]
    if (result.total_epochs != ref.total_epochs or len(scores) != PT_ES_EPOCHS
            or max(abs(a - b) / abs(b) for a, b in zip(scores, twin_scores)) > PT_LOSS_RTOL
            or not scores[-1] < scores[0]):
        failures.append(f"(e) early stopping: scores {scores} against {twin_scores}")
    name, worst = pt_worst(net, twin)
    if worst > PT_PARAM_TOL:
        failures.append(f"(e) early stopping: {name} lies {worst} of its largest entry off")
    row = {"epochs": result.total_epochs, "reason": result.termination_reason,
           "scores": scores, "twin_scores": twin_scores, "best_epoch": result.best_model_epoch,
           "worst_param": name, "worst_param_rel_to_max": worst, "launches": got,
           "fused_adam_per_step": got["fused_adam"] / steps, "seconds": es_s}
    del net, twin
    return row, got


def parallel_training_phase(ck, card):
    """Phase 38 (see the module's docstring). Returns each path's launches
    (all its steps)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh, mesh_axes

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    failures, rows, parts_s, paths = [], {}, {}, {}

    def report(name, t0, row):
        parts_s[name] = time.perf_counter() - t0
        rows[name] = row
        print(f"parallel_training {name} " + json.dumps({"card": card, **row}), flush=True)

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        mesh = make_mesh({"data": 1})  # on cuda: the world's backend
        report("(a) world", t0, {"backend": dist.get_backend(), "world": dist.get_world_size(),
                                 "mesh": mesh_axes(mesh), "device_type": mesh.device_type})
        t0 = time.perf_counter()
        row, paths["parallel_shared_gradients_train"] = pt_shared(ck, mesh, failures)
        report("(b) shared_gradients", t0, row)
        t0 = time.perf_counter()
        row, paths["parallel_averaging_train"] = pt_averaging(ck, mesh, failures)
        report("(c) averaging", t0, row)
        t0 = time.perf_counter()
        row, paths["parallel_rules_train"] = pt_rules(ck, failures)
        report("(d) rules", t0, row)
        t0 = time.perf_counter()
        row, paths["parallel_early_stopping_lenet_train"] = pt_early_stopping(ck, mesh, failures)
        report("(e) early_stopping", t0, row)
    finally:
        helpers.clear_helper("updater")
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    shared = rows["(b) shared_gradients"]
    if seconds > PT_MAX_SECONDS:
        failures.append(f"the phase took {seconds:.1f} s, more than {PT_MAX_SECONDS}")
    print("parallel_training summary " + json.dumps({
        "card": card, "batch": [TRAIN_N, T],
        "wrapper_median_step_ms": shared["wrapper_median_ms"],
        "plain_fit_median_step_ms": shared["plain_median_ms"],
        "wrapper_over_plain": shared["wrapper_median_ms"] / shared["plain_median_ms"],
        "averaging_ms_per_step": rows["(c) averaging"]["wrapper_ms_per_step"],
        "averaging_plain_ms_per_step": rows["(c) averaging"]["plain_ms_per_step"],
        "busy": shared["busy"], "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": paths, "phase_s": seconds, "parts_s": parts_s,
        "target_s": PT_MAX_SECONDS, "failures": failures}), flush=True)
    if failures:
        raise RuntimeError(f"parallel_training: {failures}")
    return paths


# Sharded serving and the training masters in a world of one NCCL rank (phase 39).
MS_REQUESTS, MS_CLIENTS, MS_SWAP_AT, MS_AFTER, MS_BUCKETS = 48, 8, 16, 16, (1, 2, 4, 8)
MS_STEPS, MS_THRESHOLD, MS_THRESHOLD_STEP = 3, 1e-4, 1e-5
MS_TIMED_STEPS = 4  # warm master steps and plain fits timed after the checked steps
MS_AVG_BATCHES, MS_AVG_FREQ = 4, 2
MS_BRIDGE_THRESHOLD, MS_BRIDGE_EPOCHS, MS_BRIDGE_BATCH, MS_BRIDGE_SPREAD = 1e-3, 2, 128, 4.0
MS_MAX_SECONDS = 60.0
# (b)'s zip: GPT-2-small at its full width cut to one block (the zip is
# written and read deflated: with all 12 blocks, 605 MB, (b) took 50 s of
# the phase on the host of an NVIDIA H100 80GB HBM3, 700.00 W)
MS_CLI_LAYERS = 1


def ms_serving(ck, card, failures):
    """(a) The registry serving GPT-2-small (T SR_T) placed by
    ``DEFAULT_2D_RULES`` on a ``data=1, model=1`` mesh, through the
    lockstep stream: MS_CLIENTS client threads send MS_REQUESTS one-row
    requests, v2 registers (placed, warmed, activated) after the
    MS_SWAP_AT-th answer while the others are in flight, and the last
    MS_AFTER requests wait for the swap; every answer against its
    version's own ``output`` on the same row, taken before the version
    was placed."""
    from deeplearning4j_tpu_torch.observe import trace
    from deeplearning4j_tpu_torch.parallel import lockstep
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh, mesh_axes
    from deeplearning4j_tpu_torch.parallel.sharding import DEFAULT_2D_RULES
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    mesh = make_mesh({"data": 1, "model": 1})
    nets = {v: TransformerLM(seed=s).init() for v, s in zip((1, 2), SR_SEEDS)}
    vocab = nets[1].conf.vertices["embed"].obj.n_in
    layers = sum(1 for n in nets[1].conf.topo_order if n.endswith("-att"))
    reqs = np.random.default_rng(39).integers(0, vocab, (MS_REQUESTS, 1, SR_T)).astype(np.float32)
    # each version's own answer to every row, unplaced, kept on the card
    with torch.no_grad():
        refs = {v: torch.cat([net.output(r) for r in reqs]) for v, net in nets.items()}
    tracer = trace.enable_tracing()
    reg = ModelRegistry(max_batch_size=8, buckets=MS_BUCKETS)
    row = {}
    try:
        t0 = time.perf_counter()
        reg.register("gpt2", nets[1], mesh=mesh, sharding_rules=DEFAULT_2D_RULES,
                     input_shape=(SR_T,))
        row["register_s"] = time.perf_counter() - t0
        served = reg.get("gpt2")
        row["describe_mesh"] = served.describe()["versions"][0]["mesh"]
        if row["describe_mesh"] != mesh_axes(mesh):
            failures.append(f"(a) describe gives {row['describe_mesh']}")
        answers, errors, done = [None] * MS_REQUESTS, [], [0]
        lock, swap_now, swapped = threading.Lock(), threading.Event(), threading.Event()

        def client(c):
            try:
                for j in range(c, MS_REQUESTS, MS_CLIENTS):
                    if j >= MS_REQUESTS - MS_AFTER:
                        swapped.wait(timeout=300)
                    t_req = time.perf_counter()
                    out, v = reg.predict_versioned("gpt2", reqs[j])
                    answers[j] = (out, v, time.perf_counter() - t_req)
                    with lock:
                        done[0] += 1
                        if done[0] == MS_SWAP_AT:
                            swap_now.set()
            except Exception as e:  # noqa: BLE001 - reported and failed below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(MS_CLIENTS)]
        builds0, batches0 = tracer.compile_count, served.inference.batches_dispatched
        ops0 = lockstep.stream().ops_sent
        zero_launches(ck)
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        swap_now.wait(timeout=300)
        t_swap = time.perf_counter()
        try:
            reg.register("gpt2", nets[2], mesh=mesh, sharding_rules=DEFAULT_2D_RULES,
                         input_shape=(SR_T,))
        finally:
            swapped.set()
        swap_s = time.perf_counter() - t_swap
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        got = read_launches(ck)
        batches = served.inference.batches_dispatched - batches0
        forwards = batches + len(MS_BUCKETS)  # the dispatches and v2's warm-ups
        want = {"flash_attention_fwd": layers * forwards}
        if errors or any(th.is_alive() for th in threads):
            failures.append(f"(a) clients: {errors or 'hung'}")
        if unexpected_launches(got, want):
            failures.append(f"(a) launched {got}, expected {want}")
        builds = tracer.compile_count - builds0
        if builds:
            failures.append(f"(a) {builds} kernel_build spans after the warm-up")
        worst, lat = {}, {}
        for j, a in enumerate(answers):
            if a is None:
                continue
            out, v, sec = a
            ref = refs[v][j:j + 1]
            got_j = torch.from_numpy(out).to(ref.device)
            reading = float(((got_j - ref).abs() - SERVE_RTOL * ref.abs()).max())
            worst[v] = max(worst.get(v, -math.inf), reading)
            lat.setdefault(v, []).append(sec * 1e3)
            if not reading <= SERVE_ATOL:
                failures.append(f"(a) request {j} on v{v}: {reading} > {SERVE_ATOL}")
        all_ms = [ms for v in lat for ms in lat[v]]
        if sorted(lat) != [1, 2] or served.current_version != 2:
            failures.append(f"(a) versions served {sorted(lat)}, live v{served.current_version}")
        row.update({
            "requests": MS_REQUESTS, "clients": MS_CLIENTS, "wall_s": wall,
            "requests_per_s": MS_REQUESTS / wall, "p50_ms": float(np.percentile(all_ms, 50)),
            "p99_ms": float(np.percentile(all_ms, 99)),
            "by_version": {v: {"requests": len(ms), "p50_ms": float(np.percentile(ms, 50)),
                               "worst_reading": worst[v]} for v, ms in sorted(lat.items())},
            "hot_swap_s": swap_s, "batches_dispatched": batches, "launches": got,
            "k3a_per_forward": got["flash_attention_fwd"] / forwards,
            "stream_ops": lockstep.stream().ops_sent - ops0, "kernel_builds": builds,
            "answer_limit": {"rtol": SERVE_RTOL, "atol": SERVE_ATOL}})
    finally:
        reg.shutdown()
        trace.disable_tracing()
    del nets, refs
    torch.cuda.empty_cache()
    return row, got


def ms_cli(ck, failures, tmp):
    """(b) ``cli.py serve --mesh data=1,model=1`` on a saved GPT-2-small
    (MS_CLI_LAYERS blocks): one binary answer against the unplaced
    network's; ``--mesh`` with ``--dtype-policy`` exits 2."""
    from deeplearning4j_tpu_torch.cli import serve_main
    from deeplearning4j_tpu_torch.nn.train_step import to_host
    from deeplearning4j_tpu_torch.serving import ModelServingClient
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    net = TransformerLM(n_layers=MS_CLI_LAYERS).init()
    layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    vocab = net.conf.vertices["embed"].obj.n_in
    path = os.path.join(tmp, "gpt2.zip")
    t0 = time.perf_counter()
    write_model(net, path, save_updater=False)  # a served model needs no Adam state
    save_s = time.perf_counter() - t0
    x = np.random.default_rng(40).integers(0, vocab, (1, SR_T)).astype(np.float32)
    argv = ["--model", f"gpt2={path}", "--port", "0", "--max-batch-size", "1",
            "--input-shape", f"gpt2={SR_T}", "--mesh", "data=1,model=1"]
    zero_launches(ck)
    t0 = time.perf_counter()
    server = serve_main(argv, block=False)
    try:
        start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = ModelServingClient(server.url, timeout=120.0).predict("gpt2", x, binary=True)
        predict_s = time.perf_counter() - t0
        mesh = server.registry.get("gpt2").describe()["versions"][0].get("mesh")
    finally:
        server.stop(drain=True, shutdown_registry=True)
    launches = read_launches(ck)
    want = {"flash_attention_fwd": 2 * layers}  # the warm-up and the request
    ref = to_host(net.output(x))
    reading = float((np.abs(got - ref) - SERVE_RTOL * np.abs(ref)).max())
    if got.shape != ref.shape or not reading <= SERVE_ATOL:
        failures.append(f"(b) serve answer {got.shape}, reading {reading}")
    if unexpected_launches(launches, want):
        failures.append(f"(b) launched {launches}, expected {want}")
    try:
        serve_main(argv + ["--dtype-policy", "gpt2=int8"], block=False)
        refused = None
    except SystemExit as e:
        refused = e.code
    if refused != 2 or mesh != {"data": 1, "model": 1}:
        failures.append(f"(b) --mesh with --dtype-policy exited {refused}; mesh {mesh}")
    del net
    torch.cuda.empty_cache()
    return {"reduced": f"depth only: {layers} of GPT-2-small's 12 blocks at full width "
                       "(the zip is written and read deflated on the host)",
            "save_s": save_s, "zip_bytes": os.path.getsize(path), "start_s": start_s,
            "predict_s": predict_s, "reading": reading,
            "answer_bytes": int(got.nbytes), "mesh": mesh, "launches": launches,
            "int8_with_mesh_exit": refused}, launches


def ms_twin_step(twin, helper, batch, residual, thr, it, ep):
    """The shared step written out on the twin: its gradient, Adam (the
    fused kernel) on a copy of each parameter, the update added to the
    residual and quantized to ±thr, the parameter less the quantized
    update. Returns the loss, the sparsity and the flat Adam update."""
    loss, grads, _ = twin._gradients(*batch, train=True)
    nz, total, updates = 0, 0, []
    lr_it, lr_ep = np.float32(it), np.float32(ep)
    with torch.no_grad():
        for k, named in twin.params.items():
            for n, p in named.items():
                u = twin._updaters[k][n]
                stepped = p.clone()
                helper.apply(u, stepped, grads[k][n], twin.updater_states[k][n],
                             u.lr_at(lr_it, lr_ep), float(it) + 1.0)
                update = p - stepped
                acc = residual[k][n] + update
                quant = torch.where(acc.abs() >= thr, torch.sign(acc) * thr,
                                    torch.zeros((), dtype=acc.dtype, device=acc.device))
                residual[k][n] = acc - quant
                p.sub_(quant)
                nz += int((quant != 0).sum())
                total += quant.numel()
                updates.append(update.reshape(-1))
    return float(loss), nz / total, torch.cat(updates)


def ms_adapt(thr, sparsity):
    """``SharedTrainingMaster._adapt_threshold`` at step_delay 0, written out."""
    if sparsity < 1e-4:
        return max(1e-5, thr - MS_THRESHOLD_STEP)
    if sparsity > 0.05:
        return thr + MS_THRESHOLD_STEP
    return thr


def ms_shared(ck, mesh, failures):
    """(c) ``SharedTrainingMaster`` through ``DistributedMultiLayerNetwork``
    on GPT-2-small, MS_STEPS steps against the written-out twin; then
    plain ``fit`` timed on the twin and one profiled master step."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import (DistributedMultiLayerNetwork,
                                                   SharedTrainingMaster)

    net, twin = pt_gpt2_pair()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    want = {"flash_attention_fwd": n_layers, "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers, "fused_adam": tensors_of(net)}
    x, labels = pt_gpt2_batch(123, vocab)
    ds = DataSet(x, labels)
    master = SharedTrainingMaster(batch_size_per_worker=TRAIN_N, threshold=MS_THRESHOLD,
                                  step_delay=0, threshold_step=MS_THRESHOLD_STEP, mesh=mesh)
    front = DistributedMultiLayerNetwork(net, master)
    helper = ck.FusedUpdaterHelper()
    batch = twin._batch(twin._to_mds(ds))
    residual = {k: {n: torch.zeros_like(p) for n, p in named.items()}
                for k, named in twin.params.items()}
    launches, losses, twin_losses, step_ms, sparsity, twin_sparsity = [], [], [], [], [], []
    thresholds, twin_thresholds, thr = [], [], MS_THRESHOLD
    update = None
    for step in range(MS_STEPS):
        zero_launches(ck)
        step_ms.append(pt_timed(lambda: front.fit([ds])))
        launches.append(read_launches(ck))
        losses.append(net.score_)
        thresholds.append(master.threshold)
        sparsity.append(master.last_sparsity)
        loss, sp, update = ms_twin_step(twin, helper, batch, residual, np.float32(thr),
                                        step, step)
        twin_losses.append(loss)
        twin_sparsity.append(sp)
        thr = ms_adapt(thr, sp)
        twin_thresholds.append(thr)
    if max(abs(a - b) for a, b in zip(sparsity, twin_sparsity)) > 1e-6:
        failures.append(f"(c) sparsity {sparsity} against the twin's {twin_sparsity}")
    row = pt_check("(c) shared", losses, twin_losses, net, twin, launches, want, failures)
    worst_res, worst_name = 0.0, None
    for k, named in residual.items():
        for n, want_r in named.items():
            got_r = master._residual[k][n][0]
            r = float((got_r - want_r).abs().max()) / max(float(want_r.abs().max()), 1e-30)
            if r > worst_res:
                worst_res, worst_name = r, f"{k}/{n}"
    if worst_res > PT_PARAM_TOL:
        failures.append(f"(c) residual {worst_name} lies {worst_res} of its largest entry off")
    if thresholds != twin_thresholds:
        failures.append(f"(c) thresholds {thresholds} against {twin_thresholds}")
    if not any(0.0 < s < 1.0 for s in sparsity):
        failures.append(f"(c) sparsity {sparsity}: no step between 0 and 1")
    # timed apart from the checked steps, whose first is cold
    warm_ms = [pt_timed(lambda: front.fit([ds])) for _ in range(MS_TIMED_STEPS)]
    plain_ms = [pt_timed(lambda: twin.fit(x, labels)) for _ in range(MS_TIMED_STEPS)]
    prof = busy(lambda: front.fit([ds]), 1)
    row.update({"threshold_start": MS_THRESHOLD, "thresholds": thresholds,
                "sparsity": sparsity, "twin_sparsity": twin_sparsity,
                "worst_residual": worst_name,
                "worst_residual_rel_to_max": worst_res, "checked_step_ms": step_ms,
                "master_step_ms": warm_ms, "master_median_ms": float(np.median(warm_ms)),
                "plain_fit_step_ms": plain_ms, "plain_median_ms": float(np.median(plain_ms)),
                "busy": prof, "stats": master.get_training_stats().as_dict()})
    flat = update.detach().clone()
    del net, twin, master, front, residual, x, labels, ds, batch, update
    torch.cuda.empty_cache()
    return row, pt_total(launches), flat


def ms_averaging(ck, mesh, failures):
    """(d) ``ParameterAveragingTrainingMaster`` (averaging_frequency
    MS_AVG_FREQ) through ``DistributedMultiLayerNetwork`` on MS_AVG_BATCHES
    GPT-2-small batches against as many plain ``fit`` steps on a twin."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import (DistributedMultiLayerNetwork,
                                                   ParameterAveragingTrainingMaster)

    net, twin = pt_gpt2_pair()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    batches = [DataSet(*pt_gpt2_batch(2000 + i, vocab)) for i in range(MS_AVG_BATCHES)]
    heard = []

    class Flushes:
        def iteration_done(self, model, iteration, epoch):
            heard.append((iteration, model.score_))

    net.set_listeners(Flushes())
    master = ParameterAveragingTrainingMaster(batch_size_per_worker=TRAIN_N,
                                              averaging_frequency=MS_AVG_FREQ, mesh=mesh)
    zero_launches(ck)
    fit_ms = pt_timed(lambda: DistributedMultiLayerNetwork(net, master).fit(batches))
    got = read_launches(ck)
    twin_steps = []
    for b in batches:
        twin.fit(b)
        twin_steps.append(twin.score_)
    twin_flush = [float(np.mean(twin_steps[i:i + MS_AVG_FREQ]))
                  for i in range(0, MS_AVG_BATCHES, MS_AVG_FREQ)]
    want_iters = list(range(MS_AVG_FREQ, MS_AVG_BATCHES + 1, MS_AVG_FREQ))
    if [it for it, _ in heard] != want_iters or net.epoch != 1:
        failures.append(f"(d) iteration_done at {heard}, epoch {net.epoch}")
    per_step = {"flash_attention_fwd": n_layers, "flash_attention_bwd_dq": n_layers,
                "flash_attention_bwd_dkv": n_layers, "fused_adam": tensors_of(net)}
    want = {k: v * MS_AVG_BATCHES for k, v in per_step.items()}
    row = pt_check("(d) averaging", [sc for _, sc in heard], twin_flush, net, twin, [got],
                   want, failures)
    row.update({"splits": len(master._repartition(batches)), "fit_ms": fit_ms,
                "stats": master.get_training_stats().as_dict()})
    del net, twin, batches, master
    torch.cuda.empty_cache()
    return row, got


def ms_encode(update, failures):
    """(e) ``threshold_encode`` / ``threshold_decode`` on GPT-2-small's
    flattened Adam update on the card and on a CPU copy."""
    from deeplearning4j_tpu_torch.parallel.compression import (optimal_capacity,
                                                               threshold_decode,
                                                               threshold_encode)

    thr = 0.5 * 3e-4  # half GPT-2's Adam step: a share of the entries reaches it
    cpu = update.cpu()
    msg, res = threshold_encode(update, thr)  # the first call: launches warm
    ms = pt_timed(lambda: threshold_encode(update, thr))
    dec = threshold_decode(msg, update.numel())
    t0 = time.perf_counter()
    cmsg, cres = threshold_encode(cpu, thr)
    cpu_s = time.perf_counter() - t0
    cdec = threshold_decode(cmsg, cpu.numel())
    same = {"indices": bool(torch.equal(msg.indices.cpu(), cmsg.indices)),
            "signs": bool(torch.equal(msg.signs.cpu(), cmsg.signs)),
            "count": int(msg.count) == int(cmsg.count),
            "residual": bool(torch.equal(res.cpu().view(torch.int32), cres.view(torch.int32))),
            "decoded": bool(torch.equal(dec.cpu(), cdec))}
    if not all(same.values()):
        failures.append(f"(e) the card's encode differs from the CPU's: {same}")
    passing = int((cpu.abs() >= thr).sum())
    return {"entries": int(update.numel()), "threshold": thr,
            "capacity": optimal_capacity(update.numel()), "count": int(msg.count),
            "passing": passing, "equal_to_cpu": same, "encode_ms": ms,
            "cpu_encode_ms": cpu_s * 1e3, "device": str(update.device)}


class MsEndpoint:
    """publish/poll over one EmbeddedBroker topic, keeping what it sent."""

    def __init__(self, broker, topic, group):
        self.broker, self.topic, self.group, self.sent = broker, topic, group, []
        broker.subscribe(topic, group)

    def publish(self, payload):
        self.sent.append(payload)
        self.broker.publish(self.topic, payload)

    def poll(self, timeout=0.0):
        return self.broker.poll(self.topic, self.group, timeout=timeout or 0.01)


class MsFrames:
    """A consumer handing out given frames."""

    def __init__(self, frames):
        self.frames = list(frames)

    def poll(self, timeout=0.0):
        return self.frames.pop(0) if self.frames else None


def ms_bridge(ck, failures):
    """(f) ``CrossSliceGradientBridge`` between two Adam LeNets on the card
    through an ``EmbeddedBroker``: each trains on its own half of the
    LeNet data, both publish and poll after every step; the last frame of
    A also applied to a CPU copy of B."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import CrossSliceGradientBridge
    from deeplearning4j_tpu_torch.streaming import EmbeddedBroker
    from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params

    x, y = lenet_data()
    half = len(x) // 2
    net_a = MultiLayerNetwork(lenet_conf()).init()
    net_b = load_reference_params(MultiLayerNetwork(lenet_conf()).init(), export_params(net_a))
    broker = EmbeddedBroker()
    end_a, end_b = MsEndpoint(broker, "grads", "a"), MsEndpoint(broker, "grads", "b")
    bridge_a = CrossSliceGradientBridge(end_a, end_a, threshold=MS_BRIDGE_THRESHOLD,
                                        slice_id="A")
    bridge_b = CrossSliceGradientBridge(end_b, end_b, threshold=MS_BRIDGE_THRESHOLD,
                                        slice_id="B")
    bridge_a.publish_update(net_a.params)  # the baseline: nothing moved yet
    bridge_b.publish_update(net_b.params)
    want = {"fused_adam": 2 * tensors_of(net_a)}
    frame_bytes, applied, launches, t0 = [], [], [], time.perf_counter()
    rounds = [(e, s) for e in range(MS_BRIDGE_EPOCHS) for s in range(0, half, MS_BRIDGE_BATCH)]
    cpu_b = cpu_frame = None
    for i, (_, s) in enumerate(rounds):
        zero_launches(ck)
        net_a.fit(DataSet(x[s:s + MS_BRIDGE_BATCH], y[s:s + MS_BRIDGE_BATCH]))
        net_b.fit(DataSet(x[half + s:half + s + MS_BRIDGE_BATCH],
                          y[half + s:half + s + MS_BRIDGE_BATCH]))
        launches.append(read_launches(ck))
        frame_bytes.append([bridge_a.publish_update(net_a.params),
                            bridge_b.publish_update(net_b.params)])
        if i == len(rounds) - 1:
            cpu_b = {k: {n: t.detach().cpu().clone() for n, t in named.items()}
                     for k, named in net_b.params.items()}
            cpu_frame = end_a.sent[-1]
        applied.append([bridge_a.poll_and_apply(net_a.params)[1],
                        bridge_b.poll_and_apply(net_b.params)[1]])
    exchange_s = time.perf_counter() - t0
    for i, got in enumerate(launches):
        if unexpected_launches(got, want):
            failures.append(f"(f) round {i} launched {got}, expected {want}")
    # each applies the other's frame of the round, where it sent one
    sent = [[int(b > 0), int(a > 0)] for a, b in frame_bytes]
    if applied != sent or not frame_bytes[-1][0]:
        failures.append(f"(f) frames applied each round: {applied}, sent {sent}")
    # A - B is what each still holds back: its residual less the other's
    a, b = export_params(net_a), export_params(net_b)
    spread = max(float(np.abs(a[k][n] - b[k][n]).max()) for k in range(len(a)) for n in a[k])
    identity = max(float(np.abs((a[k][n] - b[k][n]).ravel()
                                - (bridge_a._residual[k][n] - bridge_b._residual[k][n])).max())
                   for k in range(len(a)) for n in a[k])
    if spread > MS_BRIDGE_SPREAD * MS_BRIDGE_THRESHOLD or identity > 1e-5:
        failures.append(f"(f) replicas {spread} apart (limit {MS_BRIDGE_SPREAD} x "
                        f"{MS_BRIDGE_THRESHOLD}); A - B off the residuals by {identity}")
    CrossSliceGradientBridge(MsFrames([]), MsFrames([cpu_frame]), threshold=MS_BRIDGE_THRESHOLD,
                             slice_id="B-cpu").poll_and_apply(cpu_b)
    cpu_diff = max(float((net_b.params[k][n].detach().cpu() - cpu_b[k][n]).abs().max())
                   for k in cpu_b for n in cpu_b[k])
    if cpu_diff > 1e-6:
        failures.append(f"(f) A's last frame on a CPU copy of B lies {cpu_diff} from the card's")
    sizes = [n for pair in frame_bytes for n in pair if n]
    del net_a, net_b
    return {"rounds": len(rounds), "threshold": MS_BRIDGE_THRESHOLD,
            "frames": len(sizes), "bytes_per_frame": {"mean": float(np.mean(sizes)),
                                                      "min": min(sizes), "max": max(sizes)},
            "bytes_by_round": frame_bytes,
            "params": int(sum(np.asarray(v).size for layer in a for v in layer.values())),
            "spread": spread, "spread_over_threshold": spread / MS_BRIDGE_THRESHOLD,
            "residual_identity_err": identity, "cpu_copy_max_diff": cpu_diff,
            "fused_adam_per_step": launches[-1]["fused_adam"] / 2,
            "exchange_s": exchange_s}, pt_total(launches)


def mesh_serving_and_masters_phase(ck, card):
    """Phase 39 (see the module's docstring). Returns each path's launches."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    failures, rows, parts_s, paths = [], {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="ms_")

    def report(name, t0, row):
        parts_s[name] = time.perf_counter() - t0
        rows[name] = row
        print(f"mesh_serving_and_masters {name} " + json.dumps({"card": card, **row}),
              flush=True)

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh({"data": 1})
        t0 = time.perf_counter()
        row, paths["mesh_serving_registry"] = ms_serving(ck, card, failures)
        report("(a) sharded serving", t0, row)
        t0 = time.perf_counter()
        row, paths["mesh_serving_cli"] = ms_cli(ck, failures, tmp)
        report("(b) serve --mesh", t0, row)
        helpers.set_helper("updater", ck.FusedUpdaterHelper())
        t0 = time.perf_counter()
        row, paths["masters_shared_train"], update = ms_shared(ck, mesh, failures)
        report("(c) SharedTrainingMaster", t0, row)
        t0 = time.perf_counter()
        row, paths["masters_averaging_train"] = ms_averaging(ck, mesh, failures)
        report("(d) ParameterAveragingTrainingMaster", t0, row)
        t0 = time.perf_counter()
        row = ms_encode(update, failures)
        del update
        report("(e) threshold codec", t0, row)
        t0 = time.perf_counter()
        row, paths["masters_bridge_lenet_train"] = ms_bridge(ck, failures)
        report("(f) CrossSliceGradientBridge", t0, row)
    finally:
        helpers.clear_helper("updater")
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    if seconds > MS_MAX_SECONDS:
        failures.append(f"the phase took {seconds:.1f} s, more than {MS_MAX_SECONDS}")
    shared, serving = rows["(c) SharedTrainingMaster"], rows["(a) sharded serving"]
    print("mesh_serving_and_masters summary " + json.dumps({
        "card": card, "batch": [TRAIN_N, T],
        "serving_requests_per_s": serving["requests_per_s"], "serving_p50_ms": serving["p50_ms"],
        "shared_master_median_step_ms": shared["master_median_ms"],
        "plain_fit_median_step_ms": shared["plain_median_ms"],
        "master_over_plain": shared["master_median_ms"] / shared["plain_median_ms"],
        "sparsity": shared["sparsity"], "busy": shared["busy"],
        "reduced": {"(b)": rows["(b) serve --mesh"]["reduced"]},
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": paths, "phase_s": seconds, "parts_s": parts_s,
        "target_s": MS_MAX_SECONDS, "failures": failures}), flush=True)
    if failures:
        raise RuntimeError(f"mesh_serving_and_masters: {failures}")
    return paths


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this test needs an NVIDIA GPU")
    from deeplearning4j_tpu_torch.nn import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False)",
          flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"peaks: {peaks['label']}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"build: {ck.build_all():.3f} s for {len(ck.SOURCES)} kernel "
          f"source(s)", flush=True)
    for source in ck.SOURCES:
        print(f"ptxas {source} " + json.dumps(ptxas_report(ck, source)), flush=True)
    print("sass " + json.dumps(sass_check(ck)), flush=True)

    seconds = {}

    def timed(fn, *args):
        """``fn(*args)``, its wall seconds kept under the phase's name."""
        t0 = time.perf_counter()
        got = fn(*args)
        seconds[fn.__name__] = round(time.perf_counter() - t0, 1)
        return got

    served = timed(kernel_phase, ck, peaks)
    bwd = timed(backward_phase, ck, peaks)
    bf16, bf16_encoder = timed(flash_bf16_phase, ck, peaks)
    adam = timed(adam_phase, ck, peaks)
    serve_launches = timed(serving_phase, ck, card, served["ms"])
    train_launches = timed(training_phase, ck, card)
    lstm_rows = timed(lstm_kernel_phase, ck, peaks)
    lstm_bf16_rows = timed(lstm_bf16_kernel_phase, ck, peaks)
    char_launches, char_by_plan, char_adam_launches = timed(char_lstm_phase, ck, card)
    lenet_adam_launches = timed(lenet_phase, ck, card)
    timed(draws_phase, card)
    ex17_adam_launches = timed(ex17_phase, ck, card)
    lenet_reg_adam_launches = timed(lenet_regularized_phase, ck, card)
    gpt2_drop = timed(gpt2_attn_dropout_phase, ck, card)
    decode = timed(decode_phase, ck, card, peaks)
    tbptt = timed(gpt2_tbptt_phase, ck, card)
    resnet = timed(resnet50_phase, ck, card, peaks)
    dl4j = timed(dl4j_import_phase, ck, card)
    gpt2_bf16 = timed(gpt2_bf16_phase, ck, card)
    resnet_bf16 = timed(resnet50_bf16_phase, ck, card, peaks)
    lstm_bf16 = timed(lstm_bf16_phase, ck, card)
    stack = timed(recurrent_stack_phase, ck, card)
    vgg = timed(vgg16_bf16_phase, ck, card, peaks)
    enc = timed(encoder_bf16_phase, ck, card)
    zoo = timed(zoo_smoke_phase, ck, card)
    net_api = timed(network_api_phase, ck, card)
    small = timed(small_layers_phase, ck, card)
    pretrain = timed(pretrain_phase, ck, card)
    yolo = timed(yolo_phase, ck, card, peaks)
    sd_paths = timed(samediff_phase, ck, card)
    tr_paths = timed(transfer_phase, ck, card)
    ck_paths = timed(checkpointing_phase, ck, card)
    fn_paths = timed(zoo_facenet_phase, ck, card)
    ki_paths = timed(keras_import_phase, ck, card)
    me_paths = timed(model_export_phase, ck, card)
    tu_paths = timed(training_utilities_phase, ck, card)
    sr_paths = timed(serving_registry_phase, ck, card)
    hs_paths = timed(http_serving_phase, ck, card)
    nlp_paths = timed(nlp_text_classification_phase, ck, card)
    gc_paths = timed(graph_clustering_phase, ck, card)
    ct_paths, ct_by_plan = timed(continuous_training_phase, ck, card)
    pt_paths = timed(parallel_training_phase, ck, card)
    ms_paths = timed(mesh_serving_and_masters_phase, ck, card)
    print("phase_seconds " + json.dumps(seconds), flush=True)

    vit = zoo.pop("VisionTransformer")
    lstm = lstm_rows[LSTM_PATHS["train"]]
    lstm_bf16_row = lstm_bf16_rows[(LSTM_BF16_PATH, "auto")]

    def entry(name, source, replaces, row, launches, **extra):
        return {"name": name, "route": "cuda",
                "source": f"deeplearning4j_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                **{k: row[k] for k in ("bound_simt_ms", "k3b_total_ms") if k in row},
                **extra}

    fwd = "flash_attention_fwd"

    def later_paths(kernel):
        """The kernel's launches in each path after the char LSTM's, as
        each phase counted them."""
        return {"gpt2_attn_dropout_train": gpt2_drop["train"].get(kernel),
                "decode": decode["decode"].get(kernel),
                "gpt2_tbptt_train": tbptt["train"].get(kernel),
                "resnet50_train": resnet[kernel],
                "dl4j_import_train": dl4j[kernel],
                "gpt2_bf16_train": gpt2_bf16["train"].get(kernel),
                "resnet50_bf16_train": resnet_bf16.get(kernel),
                **{path: counts.get(kernel) for path, counts in lstm_bf16.items()},
                "vgg16_bf16_train": vgg[kernel],
                "encoder_bf16_train": enc["train_a"][kernel],
                "encoder_bf16_flash_train": enc["train_b"][kernel],
                "encoder_bf16_flash_output": enc["output_b"][kernel],
                "zoo_smoke_vit_train": vit[kernel],
                "zoo_smoke_other_models": sum(c[kernel] for c in zoo.values()),
                **api_paths(kernel), **workflow_paths(kernel)}

    def api_paths(kernel):
        """The kernel's launches on each path of the network_api phase."""
        return {path: counts[kernel] for path, counts in net_api.items()}

    def api_total(kernel):
        return sum(api_paths(kernel).values())

    def workflow_paths(kernel):
        """The kernel's launches on each path of the samediff, transfer,
        checkpointing, zoo_facenet, keras_import, model_export,
        training_utilities, serving_registry, http_serving,
        nlp_text_classification, graph_clustering, continuous_training,
        parallel_training and mesh_serving_and_masters phases."""
        return {path: counts[kernel] for paths in (sd_paths, tr_paths, ck_paths, fn_paths,
                                                   ki_paths, me_paths, tu_paths, sr_paths,
                                                   hs_paths, nlp_paths, gc_paths, ct_paths,
                                                   pt_paths, ms_paths)
                for path, counts in paths.items()}

    def workflow_total(kernel):
        return sum(workflow_paths(kernel).values())

    def bf16_paths(kernel):
        """The bf16 K3 kernel's launches on each path that counts them."""
        return {"gpt2_bf16_train": gpt2_bf16["train"][kernel],
                "gpt2_bf16_output": gpt2_bf16["output"][kernel],
                "vgg16_bf16_train": vgg[kernel],
                "encoder_bf16_train": enc["train_a"][kernel],
                "encoder_bf16_flash_train": enc["train_b"][kernel],
                "encoder_bf16_flash_output": enc["output_b"][kernel],
                **api_paths(kernel), **workflow_paths(kernel)}

    def encoder_row(name):
        """The bf16 kernel's row at the encoder's attention shape."""
        return {k: bf16_encoder[name][k] for k in (
            "shape", "causal", "max_abs_err", "ms", "device_ms", "plain_ms",
            "library_ms", "library_device_ms", "bound_ms", "bound_by")}

    def measured(by_path):
        return {p: n for p, n in by_path.items() if n is not None}

    print(json.dumps({"kernels": [
        entry(fwd, "flash_attention_fwd.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:359", served,
              serve_launches + train_launches[fwd] + gpt2_drop["output_fwd"]
              + decode["output_fwd"] + gpt2_bf16["output"][fwd] + api_total(fwd)
              + workflow_total(fwd),
              launches_by_path=measured({
                  "serve": serve_launches, "train": train_launches[fwd],
                  **later_paths(fwd),
                  "gpt2_attn_dropout_output": gpt2_drop["output_fwd"],
                  "decode_check_output": decode["output_fwd"],
                  "gpt2_bf16_output": gpt2_bf16["output"][fwd]})),
        entry("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bwd["dkv"],
              train_launches["flash_attention_bwd_dkv"]
              + api_total("flash_attention_bwd_dkv") + workflow_total("flash_attention_bwd_dkv"),
              launches_by_path=measured({
                  "train": train_launches["flash_attention_bwd_dkv"],
                  **later_paths("flash_attention_bwd_dkv")})),
        entry("flash_attention_bwd_dq", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bwd["dq"],
              train_launches["flash_attention_bwd_dq"]
              + api_total("flash_attention_bwd_dq") + workflow_total("flash_attention_bwd_dq"),
              launches_by_path=measured({
                  "train": train_launches["flash_attention_bwd_dq"],
                  **later_paths("flash_attention_bwd_dq")})),
        entry("fused_adam", "fused_adam.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:218", adam,
              train_launches["fused_adam"] + char_adam_launches
              + lenet_adam_launches + ex17_adam_launches
              + lenet_reg_adam_launches + gpt2_drop["fused_adam"]
              + tbptt["fused_adam"] + dl4j["fused_adam"]
              + gpt2_bf16["train"]["fused_adam"]
              + sum(c["fused_adam"] for c in lstm_bf16.values())
              + enc["train_a"]["fused_adam"] + enc["train_b"]["fused_adam"]
              + vit["fused_adam"] + api_total("fused_adam") + sum(small.values())
              + sum(pretrain.values()) + sum(yolo.values())
              + workflow_total("fused_adam"),
              launches_by_path=measured({
                  "train": train_launches["fused_adam"],
                  "char_lstm_train": char_adam_launches,
                  "lenet_train": lenet_adam_launches,
                  "ex17_train": ex17_adam_launches,
                  "lenet_regularized_train": lenet_reg_adam_launches,
                  **later_paths("fused_adam"), **small, **pretrain, **yolo})),
        entry("lstm_sequence", "lstm_sequence.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:66", lstm,
              sum(char_launches.values()) + stack["f32"] + api_total("lstm_sequence")
              + workflow_total("lstm_sequence"),
              launches_by_path=measured({
                  **char_launches, **later_paths("lstm_sequence"),
                  **{p: c["f32"] for p, c in lstm_bf16.items()},
                  "recurrent_stack": stack["f32"]}),
              launches_by_plan={**char_by_plan, **ct_by_plan},
              library="torch.nn.LSTM (cuDNN) with its input product: "
                      "compare with ms_with_input_product",
              ms_with_input_product=lstm["ms_with_input_product"],
              # device time a launch (profiler) at each path's shape; the
              # sample path's launches are [1,4,200] but for 2 at [12,4,200]
              shape_by_path={p: list(sh) for p, sh in LSTM_PATHS.items()},
              ms_by_path={p: lstm_rows[sh]["device_ms"] for p, sh in LSTM_PATHS.items()},
              bound_by_path={p: lstm_rows[sh]["bound_ms"] for p, sh in LSTM_PATHS.items()},
              chain_floor_by_path={p: lstm_rows[sh]["chain_floor_ms"]
                                   for p, sh in LSTM_PATHS.items()}),
        entry("lstm_sequence_bf16", "lstm_sequence.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:66 on bf16 xw", lstm_bf16_row,
              sum(c["bf16"] for c in lstm_bf16.values()) + stack["bf16"]
              + api_total("lstm_sequence_bf16") + workflow_total("lstm_sequence_bf16"),
              launches_by_path={**{p: c["bf16"] for p, c in lstm_bf16.items()},
                                "recurrent_stack": stack["bf16"],
                                **api_paths("lstm_sequence_bf16"),
                                **workflow_paths("lstm_sequence_bf16")},
              shape=list(LSTM_BF16_PATH), plan=lstm_bf16_row["plan"],
              device_ms=lstm_bf16_row["device_ms"],
              chain_floor_ms=lstm_bf16_row.get("chain_floor_ms"),
              library="torch.nn.LSTM in bf16 (cuDNN) with its input product: "
                      "compare with ms_with_input_product",
              ms_with_input_product=lstm_bf16_row["ms_with_input_product"],
              agreement={k: lstm_bf16_row[k] for k in (
                  "elem_units", "rel_frob", "f64_ratio", "limits")}),
        entry(f"{fwd}_bf16", "flash_attention_fwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:758 on bf16 "
              "q, k, v (via deeplearning4j_tpu/nn/pallas_kernels.py:359)",
              bf16["fwd"], sum(bf16_paths(f"{fwd}_bf16").values()),
              launches_by_path=bf16_paths(f"{fwd}_bf16"),
              encoder_attention=encoder_row("fwd"),
              **{k: bf16["fwd"][k] for k in ("device_ms", "library_device_ms", "design",
                                             "host_us_per_call")}),
        entry("flash_attention_bwd_dkv_bf16", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:941 on bf16 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bf16["dkv"],
              sum(bf16_paths("flash_attention_bwd_dkv_bf16").values()),
              launches_by_path=bf16_paths("flash_attention_bwd_dkv_bf16"),
              encoder_attention=encoder_row("dkv"),
              **{k: bf16["dkv"][k] for k in ("device_ms", "library_device_ms", "design",
                                             "host_us_per_call")}),
        entry("flash_attention_bwd_dq_bf16", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 on bf16 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bf16["dq"],
              sum(bf16_paths("flash_attention_bwd_dq_bf16").values()),
              launches_by_path=bf16_paths("flash_attention_bwd_dq_bf16"),
              encoder_attention=encoder_row("dq"),
              **{k: bf16["dq"][k] for k in ("device_ms", "library_device_ms", "design",
                                            "host_us_per_call")}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
