#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``llm_bci_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, a few lines each; any failure raises and the exit code is non-zero:

1. the card: ``torch.cuda.is_available()``, its name and power limit;
2. build the CUDA kernels from ``llm_bci_tpu_torch/csrc``, one ``nvcc`` a
   source, all started together;
3. kernels: the CTC kernels against the plain PyTorch version run in
   float64, on float32 log-probs: loss rtol 1e-4 / atol 1e-4, gradient atol
   1e-4 (the plain version's own float32 error over 121 sequential
   log-sum-exps is printed beside it). Every path: ``ctc_alpha_beta_kernel``
   (the forward with the gradient) with its lattice in shared memory at the
   NDT1-CTC flagship shapes (B=64, T'=121, V=41, S=64, partial input
   lengths, an empty and an infeasible target, repeated labels), with and
   without ``zero_infinity`` (the infeasible row: loss exactly 0 or the 1e30
   sentinel, gradient exactly 0), on a confident model (logits x 15) and with
   its lattice in a global scratch (B=8, T=1000); ``ctc_alpha_kernel`` (the
   forward without a gradient) on each, the same bits as the fused loss;
   torch's native CTC through the logits as an independent oracle; the
   launcher's refusal of a plan that differs in any field; device times from
   CUDA graphs of 20 launches (``graph_ms``), the eager calls, the float32
   plain version and ``torch.nn.functional.ctc_loss`` (eager; ``library_ms``,
   the port never calls it); the kernels' registers and stack as compiled;
4. kernels: the banded flash-attention forward, dQ and dK/dV kernels
   against the plain version on the card, in float32 (out atol 5e-5,
   gradients atol 2e-4 + rtol 2e-4: float32 sums in another order) and in
   bf16 against the float32 plain version of the same bf16 inputs (out atol
   2e-2, gradients atol 3e-2 + rtol 3e-2: p and ds are rounded to bf16
   before their products), over an unbounded band, narrow, causal and
   asymmetric bands with tiles inside and cut, right and left key padding,
   rows with no visible key (exactly 0, gradients 0), key tiles with no
   valid key, T one past a tile edge, a ragged T with small D, and dropout
   0.4 from a fixed seed (same keep mask as the plain version, kept
   fraction, same bits twice); ``flash_delta_kernel`` against its plain
   version in float32 (rtol 1e-6) and bf16 (rtol 1e-5); the backward
   launchers' refusal of a plan that differs from the kernels' own
   constants; then the NDT1-mlm
   shape (B=32, H=8, T=1024, D=128, bf16, dropout 0.4; the same bits twice
   for out, dq, dk, dv) with times from CUDA events, the bound of each
   kernel, the whole backward call (on a contiguous and on a strided
   ``dout``), and ``scaled_dot_product_attention`` and its one backward
   call timed beside them at T=1024 (also under a band of 128 / 128 and at
   D=64, H=16) and at T=128 (device times from a CUDA graph there), one
   ``einsum`` and one ``vecdot`` beside ``flash_delta_kernel``; the
   registers and stack of each kernel as compiled, which must not spill
   beyond what is known;
5. main path (NDT1-CTC): synthetic competition-format ``.mat`` files (64 train and
   64 test trials, 256 channels, 480-512 bins, real sentences for the G2P
   phoneme targets) through ``llm_bci_tpu_torch.main`` with
   ``configs/trainer_ctc_ndt1.yaml`` at full width (5 x 1024, bf16
   autocast): 4 training steps and one eval with the CER metric. The
   launch counters must show the CTC kernels ran (the fused kernel once a
   training step, the alpha kernel in the eval); the model's loss on a
   test batch must agree with the plain CTC on the same log-probs;
6. main path (NDT1-mlm): synthetic Poisson spikes (rate 1.0, 64 train and
   32 val trials of 896-1024 bins x 256 channels) in a pickle through
   ``llm_bci_tpu_torch.main`` with ``configs/trainer_ssl_ndt1.yaml`` at full
   width and depth (5 x 1024, 8 heads, D=128, B=32, T=1024, bf16 autocast,
   ``random`` masker ratio 0.3, left padding, ``flash_attention: auto``):
   4 training steps and one eval. The launch counters must show 5 forward
   launches a model call and 5 of each backward kernel (delta, dQ, dK/dV)
   a training step;
7. kernels: the int8 dequant-matmul kernels against ``int8_matmul_plain`` on
   the card: float32 ``x`` at small and ragged M, K, N (rtol 1e-4, atol
   1e-4 x max|out|); bf16 ``x`` at the four Llama-2-7B shapes x M in {1, 5,
   8, 40, 64, 137, 185, 685, 1480} (every M of phases 8, 9 and 12), at each
   rank's share of them under tensor parallelism at tp=2 ((4096, 2048),
   (4096, 5504), (2048, 4096), (5504, 4096)) and at ragged M, K, N (clusters of 1 to 8 ranks) against the
   plain version in float32 of the same bf16 inputs (rtol 2^-8: one bf16
   rounding of the output; atol 1e-4 x max|out|: the order of the float32
   sums), each call once more for the same bits; codes of +-127 with zero
   scale columns; ``dx`` through the custom op's backward; the cluster
   launcher's refusal of a plan that differs from the kernel's in any field;
   then device times from CUDA graphs of 20 calls at M = 8, 40 and 1480 beside
   the bound, ``torch.matmul`` on a bf16 copy of the weight timed the same
   way (``library_ms``; the port never calls it so), the eager times with the
   host's enqueue, the plain version and convert + ``torch.matmul``;
8. main path (BCI serving): ``BCI`` (NDT1 trunk 5 x 1024 -> projector ->
   Llama with LoRA r=8 on all seven projections) at the Llama-2-7B widths,
   32 layers, int8 base, seeded random weights, B=8, 512 bins x 256
   channels, prompt of 185 tokens: ``generate`` greedy (32 new tokens) and
   diverse beam (5 groups), each token step replayed from one CUDA graph a
   decode. The int8 launches must reconcile with prefills, eager steps,
   captures and replays (225 a model call); the graph's greedy ids must equal
   the un-graphed step's fed the same tokens; a 2-layer copy of the model is
   first held against the same model with the plain product on the card.
   Tokens/s, the prefill, the capture and the token step apart, and the
   device time of replayed steps; the same greedy decode on a bf16 base;
9. main path (BCI fine-tune): the same model through the port's ``Trainer``
   with ``configs/trainer_bci.yaml`` on pre-tokenized synthetic trials: 4
   steps and one eval; finite losses, only LoRA / encoder / projector
   leaves change, the frozen leaves keep their bits, 225 launches a forward
   and none in the backward; the metric readback's batches;
10. co-smoothing (``llm_bci_tpu_torch.eval.co_smoothing``): at the IBL shape of
   ``bench.py::bench_cosmooth`` (NDT1 5 x 1024, seeded weights, 256 channels in
   4 regions, T=100, 64 trials in batches of 32, dense attention) every
   neuron of the ``neuron`` mode; then the mlm model of phase 6 at T=1024
   (B=32, the flash path) in all three modes with 16 neurons: 5 flash forward
   launches a folded pass of 8 sweep points, every bits-per-spike finite or
   NaN, and two neurons of a folded pass against a pass of each alone
   (log-rates atol 2e-2, bits-per-spike 1e-3); the flash forward kernel at
   the folded pass's own inputs (256 rows, the pickle's key padding, no
   dropout) against the plain version in float32 (out atol 2e-2); neurons/s
   of the sweep, the host's scoring not timed;
11. PhonemeLLM at 32 layers x Llama-2-7B width, bf16 base, LoRA r=8 on all
   seven projections, B=8, 121 x 41 CTC posteriors spliced into a 64-token
   prompt: a forward with the loss and one step of LoRA + coupler (the
   frozen leaves keep their bits), greedy (32 tokens) and beam 5 through the
   graphed token step, the graph's greedy ids against the un-graphed step's;
   tokens/s and peak memory;
12. ``llm_bci_tpu_torch.eval_phonemes``: first the quantization-layout repair
   of ``BCI.load_checkpoint_params``, 2 layers deep at the Llama-2-7B widths:
   a bf16 checkpoint with its base served int8 (every int8 leaf
   ``quantize_int8`` of the saved weight), saved and served on a bf16 base
   again, the int8 logits against the dequantized bf16 model's (max 2^-5,
   mean 2^-8 of the largest logit); then the BCI of phase 9 trained 1 step
   on a bf16 base, saved without its frozen base (``training.component_blobs:
   false``), and evaluated on 4 pre-tokenized trials with ``beams=1,5`` and
   ``quantize=int8`` through a stub tokenizer (``WordTokenizer``); the int8
   base there holds fresh seeded codes beside the trained LoRA, encoder and
   projector. The int8 launches reconcile with the forwards, prefills, eager
   steps and captures, every int8 product is at a shape phase 7 checks, one
   predictions pickle a beam size, a finite WER; seconds a trial;
13. iTransformer at ``configs/itransformer.yaml``'s widths (768 x 5, 8 heads,
   MLP embedder, 1500 channel embeddings, region embeddings) through
   ``llm_bci_tpu_torch.main``, 4 steps and one eval each: the IBL shape of
   phase 10 (256 neurons in 4 regions, T=100; 48 train and 16 val trials
   in a pickle, with a ``choice`` in {-1, 1} and a ``wheel-speed`` trace,
   normalised where the config says) under ``trainer_ssl_itransformer.yaml``,
   ``trainer_choice_itransformer.yaml`` and ``trainer_wheel_itransformer.yaml``
   at B=16 (``max_n_bins`` pinned to 100, 4 regions; accuracy in [0, 1] and a
   finite r2 from ``behaviour_decoding_eval``), then the ``ctc`` head with the
   data, method and optimizer of ``trainer_ctc_ndt1.yaml`` (the ``.mat`` files
   of phase 5, B=64, T'=512, region embeddings off: speechbci has no regions):
   ``ctc_alpha_beta_kernel`` once a step on the global-scratch plan,
   ``ctc_alpha_kernel`` once an eval batch, the kernels at the head's own
   float32 log-probs against the plain version in float64 (phase 3's gates),
   graph-timed beside ``F.ctc_loss``, a CER within what 512 frames can give;
14. PatchTST at ``configs/patchtst.yaml``'s widths (d_model 256, 4 layers, 8
   heads, FFN 1024, BatchNorm, patches 10 / 10, pre-norm): ``mlm`` at the IBL
   shape (B=16, context 100, 10 patches) and ``ctc`` at the speechbci shape
   (B=64, context 520, 52 patches: 16,384 sequences a batch; the
   shared-memory plan, feasible and infeasible rows counted), each with
   BatchNorm's running averages finite, moved by training and left by an
   eval, and the CTC checks of phase 13;
15. the trainer contract (``trainer-state``): the flagship of phase 5 on 128
   train trials (2 steps an epoch), cuDNN asked for deterministic algorithms:
   leg A trains 6 steps through ``llm_bci_tpu_torch.main`` with
   ``profile.start_step=2, num_steps=2``, leg B the same run preempted
   (``request_preemption()``) after step 3, leg C a fresh ``python -m
   llm_bci_tpu_torch.main -k training.resume=true`` process to step 6; C
   must read A's batch indices at steps 4-6 (recorded by a wrapper of the
   train dataset) and end with A's losses and parameters bit for bit, one
   ``ctc_alpha_beta_kernel`` a step in every leg; the save and restore of a
   full flagship train state timed; the trace of steps 2-3 names
   ``ctc_alpha_beta_kernel`` twice; ``optimizer.grad_clip_norm=1.0``: the
   global norm before each update at most 1 + 1e-6, finite losses; remat
   off and on, one forward + backward from the same weights and generator
   state, for NDT1-mlm at phase 6's shape (10 flash forward launches
   against 5, every one on bf16 q, k, v; delta, dQ and dK/dV 5 each) and for
   the BCI of phase 9 with ``llm_remat`` (449 int8 launches against 225):
   the loss equal, the gradients bit-equal or within atol 3e-2 + rtol 3e-2,
   step times and peak memory of both; the BCI fine-tune's train state
   (``component_blobs: false``) saved after 2 steps and restored into a
   fresh trainer: the frozen int8 leaves bit-equal to the live ones, the
   trainable leaves and AdamW moments equal to the saved ones, its size on
   disk and seconds; ``entry()`` on the card within 1e-4 of
   ``entry(device="cpu")``, through ``ctc_alpha_kernel``;
16. checkpoint interop (``warm-start``), the card's name and power limit
   first: A. NDT1-mlm at phase 6's widths pretrained 2 steps through
   ``llm_bci_tpu_torch.main`` (``STEP2``: ``encoder.pt``, ``decoder.pt``,
   ``encoder_config.yaml``), then a ``ctc`` fine-tune of 2 steps from it by
   ``-k model.encoder.from_pt`` in a fresh CLI process (``warm_start_cli``)
   on speechbci files of 896-1024 bins: the encoder bit-equal to the saved one
   before the first update, the head the fresh init of the seed, unstacked by
   the re-merged config (T' up to 1024): 10 flash forward, delta, dQ and dK/dV
   launches and 2 of ``ctc_alpha_beta_kernel`` on the global-scratch plan; the
   first step's loss against the plain CTC on its log-probs (rtol 1e-4, atol
   1e-4 a row), and the kernels held to the plain version at those log-probs
   with phase 3's gates and timed; B. the flagship after 2 steps exported with
   ``ndt1_save_reference_checkpoint`` and built again by ``from_pt`` as
   ``ctc`` and as ``endtoend``: the eval loss bit-equal (cuDNN
   deterministic), the files' sizes and seconds; C. the BCI of phase 8 (int8
   base) trained one step, exported without its base (``encoder.bin``,
   ``projector.bin``, the PEFT adapter) and imported into a fresh int8 BCI
   whose base comes from the same seed: greedy ids equal, the imported
   model's ``cluster`` and ``tiled`` launches counted, neither
   ``transformers`` nor ``safetensors`` imported; D. iTransformer ssl ->
   choice and PatchTST mlm -> ``ctc`` (B=16) at their configs' widths, 2 + 2
   steps: the encoder (and the running averages) carried bit-equal, the
   PatchTST fine-tune on the CTC pair;
17. serving export (``serve-export``, ``llm_bci_tpu_torch.serving``), the
   card's name and power limit first: A. the BCI of phase 8 at 4 layers
   (``SERVE_LAYERS``; width kept: export and load take host time by the
   layer), int8 base, B=8, prompt 185, 32 new tokens, exported by
   ``export_decode`` under bf16 autocast, greedy and diverse beam 5: each
   archive under 1% of the weights' bytes, loaded by ``load_decode`` in a
   fresh process (a ``multiprocessing`` spawn child given the paths,
   ``params_of``'s tensors, shared with it on the card, and the batch; the
   model class made unbuildable there): greedy ids equal in-process
   ``generate``'s, diverse sequences equal and scores within atol 1e-4, the
   int8 launches of each decode {tiled 29 (the prefill), cluster 58 (an
   eager step and a capture)} with 30 replays; export, load and decode
   seconds, tokens/s and sequences/s of the loaded archives beside
   in-process ``generate`` in this process (loaded, in-process, in-process,
   loaded), the device time of 16 replayed token steps of the loaded
   archive; B. a 2-layer copy exported on the CPU, moved to the card by
   ``move_to_device_pass``: its greedy ids equal the card's in-process
   decode and the int8 kernels run; C. the NDT1-CTC flagship at phase 5's
   shape (B=64, T'=121, bf16 autocast) exported by ``export_forward`` with
   ``outputs=("preds",)`` (no ``llm_bci.ctc_*`` node, no CTC launch) and
   ``("loss", "preds")`` (one ``ctc_alpha_kernel`` launch a call), log-probs
   within atol 2e-2 of the in-process eval forward, the loss against the
   plain CTC on the archive's own log-probs (rtol 1e-5, atol 1e-3) and phase
   3's gates there; D. the real-time loop: the ``preds`` forward at B=1 over
   a window of 128 bins, 8 windows of a synthetic utterance streamed into
   ``CTCPrefixDecoder`` (beam 16): the live transcript's labels equal
   ``ctc_prefix_beam_search`` over all the frames; device ms a window and
   host ms a frame; E. NDT1-mlm at phase 6's shape (B=32, T=1024, flash): 5
   flash forward launches a call, preds within atol 2e-2 of the in-process
   eval forward; F. ``torch.library.opcheck`` of every ``llm_bci`` op on the
   card at small shapes (the launches of F are not counted).

18. multi-device training (``multi-device``, ``llm_bci_tpu_torch.parallel``), each
   leg through ``python -m torch.distributed.run ... chip_smoke.py --md-rank``,
   whose ranks run ``llm_bci_tpu_torch.main`` in process with ``-k
   parallelism....`` (cuDNN deterministic, as the in-process trainers held
   beside them): A-C on one rank of one NCCL group, the plan on trivial axes
   (FSDP2 ``fully_shard``, the tensor-parallel plan): A. the flagship of phase
   5, 4 steps + one eval, losses against the in-process trainer (rtol 1e-5;
   bit-equal expected), 1 ``ctc_alpha_beta_kernel`` a step; R. A's run with
   an ``fsdp_min_size`` that no leaf reaches (every parameter in the root's
   one FSDP2 group), held as A; B. NDT1-mlm at phase 6's shape, 2 steps, 5
   flash forward, delta, dQ and dK/dV launches a step, losses against the
   in-process trainer (rtol 1e-5); C. the BCI of phase 9 (32 layers, int8 base, LoRA r=8, B=8 x 185),
   ``parallelism.fsdp`` and ``tp`` named, 2 steps: 225 ``tiled`` launches a
   forward, losses against the in-process trainer (rtol 1e-5), peak memory,
   a greedy decode of 8 tokens under the plan (its all-reduces in the one
   captured CUDA graph) whose ids equal the unplanned in-process model's
   carrying the rank's trained leaves; D. two ranks on the one card (gloo
   with CUDA tensors: NCCL refuses two ranks on one device), the flagship with
   ``data=2`` and its stochastic parts off, 4 steps, losses against one
   process at B=64 (rtol 1e-3: bf16 products of 32 rows against 64); D2. in
   D's run of the two ranks, PatchTST ``ctc`` at the patchtst phase's widths
   with ``data=2`` and its stochastic parts off, B=64, 2 steps + eval: losses
   and trained parameters against one process (rtol 1e-3), the 16 BatchNorm
   running averages equal on both ranks and within 1e-5 of one process's
   (the statistics synced over ``data``), one ``ctc_alpha_beta_kernel`` a
   step on each rank's (32, 52, 41) and the eval's ``ctc_alpha_kernel`` as
   in one process; E. D's
   rank-0 checkpoint resumed in one process, every leaf bit-equal to the two
   ranks' final state; F. ``entry.dryrun_multichip(1)`` at its default, one
   NCCL rank on the card; S. sequence parallelism, two gloo ranks on the one
   card with ``sp=2``: S1. the flagship (stochastic parts on: every rank of a
   sequence draws its noise and dropout at the whole sequence's shape), 4
   steps + one eval, losses and trained parameters against one process (rtol
   1e-3), one ``ctc_alpha_beta_kernel`` a step on each rank on the gathered
   (64, 121, 41) log-probs, the train step's ``preds`` (what the CER fns read)
   the whole (64, 121, 41); S2. NDT1-mlm at phase 6's shape (T=1024, width
   kept, depth cut to ``MD_SP_LAYERS``), 2 steps, 0 flash launches (dense
   under ``sp``), losses against one process on the dense path (rtol 1e-3),
   each rank's peak memory beside one process's; S3. the BCI of leg C (32
   layers x 7B width, int8 base, LoRA dropout on), 2 steps: the trunk on the
   rank's frames, its output gathered, the Llama whole on each rank, 225
   ``tiled`` launches a forward on each rank, losses and trained parameters
   against leg C's in-process run (rtol 1e-3); S4. iTransformer ``ctc`` at
   the itransformer phase's widths (512 bins, the ``mlp`` embedder's first
   Linear row-parallel), 4 steps + eval; S5. PatchTST ``ctc`` at the patchtst
   phase's widths (26 / 26 of its 52 patches, BatchNorm synced), 2 steps +
   eval; S4 and S5 against one process (rtol 1e-3), the fused CTC kernel once
   a step on each rank on the whole (64, 512 | 52, 41) log-probs and the
   eval's CTC launches as in one process, S5's running averages equal on
   both ranks, S4's three leaves farthest from one process's named; T.
   sequence with tensor parallelism, four gloo ranks on the one card at
   ``sp=2 x tp=2``: the BCI of leg C (LoRA dropout on), 2 steps, the trunk
   under ``sp``, the Llama cut over ``tp``: 450 ``tiled`` launches on each
   rank at the ``tp=2`` shares and 0 ``cluster``, losses and trained
   parameters against leg C's in-process run (rtol 1e-3), the LoRA factors
   the same on every rank, each rank's peak memory, ``sp`` and ``tp``
   collective calls and wall time in a JSON line of its own. Chains and the
   batch pool under a group, the flagship on 256 trials (4 steps of B=64 an
   epoch): AK. in A-C's NCCL rank, ``chain_steps: 4`` for 8 steps, each
   chain's steps replayed from one step captured with FSDP2's collectives:
   eager steps, captures and replays (1, 1, 7), ``ctc_alpha_beta_kernel`` 2
   host launches (8 on the device), losses and trained leaves against AK1,
   the same run unchained (rtol 1e-5 / 2e-4; bit-equal expected), then one
   replayed step bit-equal to the same step run eagerly under the plan (loss,
   parameters, AdamW moments and steps, generator) and the step timed eager
   and replayed with its device-busy share and host launch calls; BK. in the
   same rank, the BCI of leg C chained (``chain_steps: 2``, 4 steps): (1, 1,
   3), 450 ``tiled`` host launches (900 on the device), its first 2 losses
   against leg C's, its frozen leaves' word sums equal to leg C's; DP. in
   D's two gloo ranks at ``data=2`` and SP. in S's at ``sp=2``: 12 steps over
   3 epochs with ``cache_device_batches`` and ``chain_steps: 4`` against the
   streaming unchained run, losses and trained leaves bit-equal, 4 batches
   from the host a rank against 12, every step eager on the step graphs'
   slots and 12 ``ctc_alpha_beta_kernel`` launches a rank either way, the
   pool's bytes a rank. Steps' ms beside the in-process trainer's,
   collective calls and peak memory in a JSON line of its own; no time of D,
   S, T, DP or SP is a speed.

19. ``training.chain_steps`` and ``training.cache_device_batches`` (``chain``,
   run right after phase 9, whose trainer leg B reuses; ``training/step_graph.py``,
   ``training/batch_cache.py``), cuDNN deterministic: A. the flagship of phase
   5 on 256 trials (4 steps of B=64 an epoch) with ``chain_steps: 4`` for 8
   steps (two chains, one graph: an eager step, a capture, 7 replays) against
   ``chain_steps: 1``: losses within rtol 1e-5, trainable leaves within rtol
   2e-4 / atol 1e-6 (the attention key biases, whose gradient is rounding
   noise, within 2 * lr * steps), ``ctc_alpha_beta_kernel``'s host launches =
   eager steps + captures; one replayed step against the same step run
   eagerly from the same state, batch and generator state under
   ``torch.use_deterministic_algorithms``: loss, parameters, AdamW moments and
   steps and the generator's state bit-equal; ms a step, the device-busy
   share and the host's launch calls a step, eager and replayed; D. the same
   flagship chained over 3 epochs (12 steps) with ``cache_device_batches``
   against streaming: the same examples in the same order, losses within rtol
   1e-5, 4 batches copied from the host (epoch 1) against 12; C. NDT1-mlm at
   phase 6's shape with ``CHAIN_MLM_LAYERS`` layers (widths kept), flash with
   dropout 0.4 and remat, ``chain_steps: 2`` for 4 steps against
   ``chain_steps: 1``: each step's flash dropout seeds (logged on the device by
   a wrapper of ``draw_seed``, so that a replay writes its own) and masker
   masks equal the unchained run's and differ from the other steps', every
   recompute drew its forward's seed, the flash launches = (eager steps +
   captures) x (4 forward, 2 dQ, dK/dV, delta); B. the BCI of phase 9 (32
   layers x Llama-2-7B width, int8 base), ``chain_steps: 2`` for 4 steps
   against ``chain_steps: 1`` from the same trainable leaves: losses within
   rtol 1e-5, LoRA leaves within rtol 2e-4 / atol 1e-6, the frozen leaves
   bit-identical, 225 ``tiled::int8_wgmma_kernel`` host launches a captured or
   eager step; ms a step, host launch calls and device kernels a step, the
   device-busy share and peak memory, eager and replayed, in a JSON line
   ``chain_bci`` of its own.

``--only ctc|flash|int8|ctc-main|mlm-main|bci-serve|bci-train|cosmooth|
phoneme-llm|eval-phonemes|itransformer|patchtst|trainer-state|warm-start|serve-export|
multi-device|chain`` runs
one phase (for development); ``--profile PATH`` writes ``torch.profiler`` tables of the
NDT1-CTC and mlm train steps, the replayed BCI greedy token steps, the
fine-tune step, one folded co-smoothing pass at each shape and the
iTransformer and PatchTST ``ctc`` steps to ``PATH``.

The second-to-last line is a JSON object with the kernels' launches,
errors and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Flagship CTC shapes: B=64 trials, T'=(512-32)/4+1=121 stacked frames,
# 41 phoneme classes, targets padded to 64 labels.
B, T, V, S = 64, 121, 41, 64

SENTENCES = [
    "the quick brown fox jumps over the lazy dog",
    "she sells sea shells by the sea shore every morning",
    "how are you doing today my friend",
    "i would like a glass of water please",
    "the weather was cold and windy all week long",
    "we walked to the store to buy some bread and milk",
    "please call me when you get home tonight",
    "my brother plays the piano in the evening",
]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def write_mat_dataset(root: str, n_train: int = 64, n_test: int = 64, n_holdout: int = 4,
                      bins=(480, 512), channels: int = 128, seed: int = 0) -> str:
    """Synthetic speechbci competition files: per split one ``.mat`` per
    day with ``tx1`` / ``spikePow`` cells of (T, channels), sentences and
    block ids. Two feature blocks of ``channels`` give 2*channels inputs.
    Every split needs at least 4 trials (2 per file)."""
    import scipy.io

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test), ("competitionHoldOut", n_holdout)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        per_day = [n - n // 2, n // 2]
        for day, k in enumerate(per_day):
            tx1 = np.empty((1, k), object)
            spow = np.empty((1, k), object)
            for i in range(k):
                # The first trial of each file has the longest length and the
                # second the shortest: the loader needs ragged trials per file.
                Ti = {0: bins[1], 1: bins[0]}.get(i) or int(rng.integers(bins[0], bins[1] + 1))
                tx1[0, i] = rng.poisson(1.0, size=(Ti, channels)).astype(np.float64)
                spow[0, i] = rng.normal(size=(Ti, channels)).astype(np.float64)
            sentences = np.array([SENTENCES[(day + i) % len(SENTENCES)] for i in range(k)])
            block = 1 + (np.arange(k) % 2)[:, None]
            scipy.io.savemat(
                os.path.join(root, split, f"t12.2022.{day + 5:02d}.10.mat"),
                {"tx1": tx1, "spikePow": spow, "sentenceText": sentences, "blockIdx": block},
            )
    return root


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls are captured into one
    CUDA graph and the graph is replayed, so the host's time to enqueue a call
    (tens of microseconds through an eager wrapper) is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The kernels that run at the main paths' shapes, by namespace and name in
# their sources (``KERNELS`` below).
FWD_WG = "fwd_wg::flash_fwd_wgmma_kernel"
DQ_WG = "bwd_wg::flash_dq_wgmma_kernel"
DKV_WG = "bwd_wg::flash_dkv_wgmma_kernel"
INT8_CLUSTER = "cluster::int8_cluster_kernel"
INT8_TILED = "tiled::int8_wgmma_kernel"


# Published dense peaks of one H100 SXM: operations a second by input type,
# and bytes a second of device memory.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound(ops: float, nbytes: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def ctc_case(device, n_batch: int = B, n_frames: int = T, scale: float = 1.0, seed: int = 0):
    """Flagship-shaped CTC inputs (logits) with the edge cases in the batch:
    an empty target, an infeasible one (64 labels in 40 frames), repeated
    labels, one label 30 times; ``scale`` multiplies the logits (15: a
    confident model, whose likeliest paths lie up to hundreds of nats below a
    frame's best slot)."""
    import torch

    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n_batch, n_frames, V)).astype(np.float32) * 2.0 * scale
    targets = rng.integers(1, V, size=(n_batch, S)).astype(np.int64)
    il = rng.integers(int(0.75 * n_frames), n_frames + 1, size=n_batch).astype(np.int64)
    il[0] = n_frames
    tl = rng.integers(20, S + 1, size=n_batch).astype(np.int64)
    tl[1] = 0                                  # empty target
    il[2], tl[2] = 40, S                       # infeasible: 64 labels in 40 frames
    targets[3, :12] = [5, 5, 5, 7, 7, 9, 9, 9, 9, 2, 2, 5]   # repeated labels
    tl[3] = 12
    targets[4] = 6                             # all one label, 30 repeats
    tl[4] = 30
    t = lambda a: torch.from_numpy(a).to(device)
    return t(logits), t(targets), t(il), t(tl)


CTC_INFEASIBLE = 2     # the row of ctc_case with no feasible alignment


def min_frames(targets, tl) -> "torch.Tensor":
    """Frames an alignment of each target needs: its labels and a blank
    between each pair of equal neighbours."""
    import torch

    S_ = targets.shape[1]
    live = torch.arange(1, S_, device=targets.device)[None, :] < tl[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & live).sum(1)
    return tl + repeats


def ctc_check(label: str, lp, targets, il, tl, zero_infinity: bool, lattice: str) -> dict:
    """One CTC path at log-probs ``lp`` against the plain version in float64:
    the loss and the gradient through ``ctc_loss`` with a gradient
    (``ctc_alpha_beta_kernel``, its lattice where ``lattice`` says) and the
    loss without one (``ctc_alpha_kernel``, the same bits). Gates on the rows
    with a feasible alignment: loss rtol 1e-4 / atol 1e-4, gradient atol 1e-4;
    on the infeasible rows (fewer input frames than ``min_frames``): loss
    exactly 0 under ``zero_infinity`` and the float32 sentinel 1e30 without it,
    gradient exactly 0 (the JAX package's convention; the plain version's
    autograd leaves -0.5 on such a row's last frame's terminal slots without
    ``zero_infinity``, so that row's gradient is held to 0 and not to the
    plain version). Returns the errors and the count of feasible rows."""
    import torch
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops.ctc import NEG_INF, ctc_loss, ctc_loss_plain

    lp = lp.detach().float().contiguous()
    Bx, Tx, Vx = lp.shape
    Sx = targets.shape[1]
    plan = ctc_cuda.ctc_plan(Tx, Sx, Vx, want_grad=True)
    if plan.lattice != lattice:
        raise AssertionError(f"CTC {label}: plan {plan}, expected the lattice in {lattice}")
    x = lp.clone().requires_grad_(True)
    fused0 = ctc_cuda.FUSED_LAUNCHES
    loss = ctc_loss(x, targets, il, tl, zero_infinity=zero_infinity)
    (grad,) = torch.autograd.grad(loss.sum(), x)
    fwd0 = ctc_cuda.FWD_LAUNCHES
    with torch.no_grad():
        loss_fwd = ctc_loss(lp, targets, il, tl, zero_infinity=zero_infinity)
    if (ctc_cuda.FUSED_LAUNCHES - fused0, ctc_cuda.FWD_LAUNCHES - fwd0) != (1, 1):
        raise AssertionError(f"CTC {label}: expected one fused and one forward-only launch")
    xr = lp.double().requires_grad_(True)
    ref = ctc_loss_plain(xr, targets, il, tl, zero_infinity=zero_infinity)
    (ref_grad,) = torch.autograd.grad(ref.sum(), xr)
    torch.cuda.synchronize()
    if not (torch.isfinite(loss).all() and torch.isfinite(grad).all()):
        raise AssertionError(f"CTC {label}: non-finite values")
    infeasible = il.long() < min_frames(targets.long(), tl.long())
    sentinel = 0.0 if zero_infinity else float(np.float32(-NEG_INF))
    if infeasible.any() and not (bool((loss[infeasible] == sentinel).all())
                                 and grad[infeasible].abs().max().item() == 0.0):
        raise AssertionError(f"CTC {label}: infeasible rows: loss {loss[infeasible].tolist()} "
                             f"(expected {sentinel}) or a non-zero gradient")
    if not torch.equal(loss, loss_fwd):
        raise AssertionError(f"CTC {label}: the forward without a gradient differs from the fused one")
    feasible = ~infeasible
    ref_loss = ref.detach().float()
    loss_err = (loss - ref_loss).abs().max().item()
    grad_err = (grad[feasible].double() - ref_grad[feasible]).abs().max().item()
    n_feasible = int(feasible.sum())
    say("kernels", f"CTC {label} (B={Bx} T={Tx} V={Vx} S={Sx}, zero_infinity={zero_infinity}, "
        f"lattice in {plan.lattice}, {plan.smem_bytes} B shared; {n_feasible} feasible rows, "
        f"{Bx - n_feasible} infeasible): against the plain version in float64: loss "
        f"max|err|={loss_err:.3e}, grad max|err|={grad_err:.3e}")
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(grad[feasible].double(), ref_grad[feasible], rtol=0.0, atol=1e-4)
    return {"loss_err": loss_err, "grad_err": grad_err, "feasible": n_feasible,
            "infeasible": infeasible}


def kernel_phase(results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops.ctc import ctc_loss, ctc_loss_plain

    dev = torch.device("cuda")

    def case(label, zero_infinity, lattice, **kw):
        logits, targets, il, tl = ctc_case(dev, **kw)
        out = ctc_check(label, torch.log_softmax(logits, -1), targets, il, tl, zero_infinity,
                        lattice)
        if not out["infeasible"][CTC_INFEASIBLE]:
            raise AssertionError(f"CTC {label}: row {CTC_INFEASIBLE} counted feasible")
        return out

    flag = case("flagship", True, "shared")
    case("flagship", False, "shared")
    case("confident (logits x 15)", True, "shared", scale=15.0)
    case("confident (logits x 15)", False, "shared", scale=15.0)
    case("unstacked trials", True, "global", n_batch=8, n_frames=1000, seed=1)

    logits, targets, il, tl = ctc_case(dev)
    lp = torch.log_softmax(logits, -1).detach()
    xf = lp.clone().requires_grad_(True)
    f_loss = ctc_loss_plain(xf, targets, il, tl)
    (f_grad,) = torch.autograd.grad(f_loss.sum(), xf)
    xr = lp.double().requires_grad_(True)
    r_loss = ctc_loss_plain(xr, targets, il, tl)
    (r_grad,) = torch.autograd.grad(r_loss.sum(), xr)
    say("kernels", f"for scale, the plain version in float32 against float64: loss max|err|="
        f"{(f_loss.double() - r_loss).abs().max().item():.3e}, grad max|err|="
        f"{(f_grad.double() - r_grad).abs().max().item():.3e}")

    # Independent oracle: torch's native CTC in float64, compared through the
    # logits (its log_probs gradient assumes log-softmax's backward follows).
    grads = []
    for use_kernel in (True, False):
        x = logits.clone().requires_grad_(True)
        if use_kernel:
            loss = ctc_loss(torch.log_softmax(x, -1), targets, il, tl)
        else:
            loss = F.ctc_loss(torch.log_softmax(x.double(), -1).transpose(0, 1), targets, il,
                              tl, reduction="none", zero_infinity=True)
        (g,) = torch.autograd.grad(loss.sum(), x)
        grads.append((loss.detach().float(), g))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(grads[0][1], grads[1][1].float(), rtol=0.0, atol=1e-4)
    say("kernels", "CTC kernel vs torch native CTC in float64 (through the logits): agree, "
        f"grad max|err|={(grads[0][1] - grads[1][1]).abs().max().item():.3e}")

    # The launcher refuses a plan that is not the kernel's, in any field.
    plan = ctc_cuda.ctc_plan(T, S, V, want_grad=True)
    args = (lp, targets.int(), il.int(), tl.int(), 0, True)
    loss_buf = torch.empty(B, device=dev)
    occ_buf = torch.empty_like(lp)
    for field, value in (("kernel", ctc_cuda.FWD_KERNEL), ("slots", plan.slots + 1),
                         ("threads", plan.threads + 32), ("smem_bytes", plan.smem_bytes + 16),
                         ("lattice", "global"), ("cluster", 1)):
        rc = ctc_cuda.raw_launch(plan._replace(**{field: value}), *args, loss_buf, occ_buf)
        if rc == 0:
            raise AssertionError(f"CTC launcher took a plan with {field}={value}")
    torch.cuda.synchronize()
    say("kernels", "CTC launcher refuses a plan that differs in kernel, slots, threads, shared "
        "memory, lattice or cluster")

    t = {**ctc_times(lp, targets.int(), il.int(), tl.int()),
         **ctc_eager_times(lp, targets.int(), il.int(), tl.int(), with_plain=True)}
    say("kernels", f"CTC device time (CUDA graphs of 20 launches): ctc_alpha_kernel "
        f"{t['fwd_ms']:.4f} ms ({t['fwd_ms'] * 1e3 / T:.3f} us a frame), "
        f"ctc_alpha_beta_kernel {t['fused_ms']:.4f} ms ({t['fused_ms'] * 1e3 / T:.3f} us a "
        f"frame), with the backward's multiply {t['pair_ms']:.4f} ms; eager, with the host's "
        f"enqueue: forward {t['fwd_eager_ms']:.4f} ms, forward with the gradient + backward "
        f"{t['pair_eager_ms']:.4f} ms; plain (float32) forward {t['plain_fwd_ms']:.3f} ms, "
        f"forward + backward {t['plain_pair_ms']:.3f} ms; F.ctc_loss (eager) forward "
        f"{t['lib_fwd_ms']:.4f} ms, forward + backward {t['lib_pair_ms']:.4f} ms")
    fwd_bound, fused_bound = ctc_bounds(lp, targets, il, tl)
    results["ctc_alpha_kernel"] = dict(
        max_abs_err=flag["loss_err"], ms=t["fwd_ms"], plain_ms=t["plain_fwd_ms"],
        library_ms=t["lib_fwd_ms"], **fwd_bound)
    results["ctc_alpha_beta_kernel"] = dict(
        max_abs_err=max(flag["loss_err"], flag["grad_err"]), ms=t["fused_ms"],
        plain_ms=t["plain_pair_ms"], library_ms=t["lib_pair_ms"], **fused_bound)

    found = _build_resources("ctc", ("ctc_",))
    say("kernels", "CTC kernels as compiled (registers a thread, stack bytes): " + ", ".join(
        f"{name} {reg}/{stack}" for name, (reg, stack) in sorted(found.items())))


def ctc_bounds(lp, targets, il, tl) -> tuple:
    """Bounds of the forward without and with the gradient at these inputs:
    the (B, T, V) float32 log-probs read once, int32 labels and lengths, the
    loss (and the (B, T, V) occupancy sums) written once; about 10 float
    operations a lattice slot and frame that the recursion visits, each
    example's input length x (2 x its target length + 1), twice with the
    gradient (alpha and beta)."""
    Bx, Tx, Vx = lp.shape
    slots = int((il.long() * (2 * tl.long() + 1)).sum())
    in_bytes = Bx * Tx * Vx * 4 + targets.numel() * 4 + 2 * Bx * 4
    return (bound(10 * slots, in_bytes + Bx * 4, "float32"),
            bound(20 * slots, in_bytes + Bx * 4 + Bx * Tx * Vx * 4, "float32"))


def ctc_times(lp, targets, il, tl) -> dict:
    """Device times of the CTC kernels at one shape, from CUDA graphs of 20
    launches on preallocated outputs (``graph_ms``): the forward without a
    gradient, the fused forward, and the pair a training step runs (the fused
    forward and the backward's multiply)."""
    import torch
    from llm_bci_tpu_torch.ops import ctc_cuda

    Bx, Tx, Vx = lp.shape
    Sx = targets.shape[1]
    dev = lp.device
    fwd_plan = ctc_cuda.ctc_plan(Tx, Sx, Vx, want_grad=False)
    fused_plan = ctc_cuda.ctc_plan(Tx, Sx, Vx, want_grad=True)
    loss = torch.empty(Bx, device=dev)
    occ = torch.empty_like(lp)
    grad = torch.empty_like(lp)
    neg_g = -torch.ones(Bx, 1, 1, device=dev)
    scratch = (torch.empty(ctc_cuda.scratch_shape(Bx, Tx, Sx), device=dev, dtype=torch.float64)
               if fused_plan.lattice == "global" else None)
    args = (lp, targets, il, tl, 0, True, loss)

    def pair():
        ctc_cuda.launch(fused_plan, *args, occ, scratch)
        torch.mul(occ, neg_g, out=grad)

    return {
        "fwd_ms": graph_ms(lambda: ctc_cuda.launch(fwd_plan, *args), 20),
        "fused_ms": graph_ms(lambda: ctc_cuda.launch(fused_plan, *args, occ, scratch), 20),
        "pair_ms": graph_ms(pair, 20),
    }


def ctc_eager_times(lp, targets, il, tl, with_plain: bool) -> dict:
    """Through autograd, one call at a time (CUDA events; the host's enqueue
    included): ``ctc_loss``'s forward and its forward + backward, the
    float32 plain version's (``with_plain``) and ``F.ctc_loss``'s on the same
    log-probs, time-major (eager: its CUDA-tensor lengths go to the host, so it
    cannot be captured; timed only, the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops.ctc import ctc_loss, ctc_loss_plain

    ones = torch.ones(lp.shape[0], device=lp.device)

    def pair(fn, inp):
        x = inp.clone().requires_grad_(True)
        return lambda: torch.autograd.grad(fn(x), x, ones)

    t64, il64, tl64 = targets.long(), il.long(), tl.long()
    lib = lambda v: F.ctc_loss(v, t64, il64, tl64, reduction="none", zero_infinity=True)
    kernel = lambda v: ctc_loss(v, targets, il, tl)
    plain = lambda v: ctc_loss_plain(v, targets, il, tl)
    xt = lp.transpose(0, 1).contiguous()
    out = {}
    with torch.no_grad():
        out["fwd_eager_ms"] = cuda_ms(lambda: kernel(lp), 50)
        out["lib_fwd_ms"] = cuda_ms(lambda: lib(xt), 50)
        if with_plain:
            out["plain_fwd_ms"] = cuda_ms(lambda: plain(lp), 5)
    out["pair_eager_ms"] = cuda_ms(pair(kernel, lp), 50)
    out["lib_pair_ms"] = cuda_ms(pair(lib, xt), 50)
    if with_plain:
        out["plain_pair_ms"] = cuda_ms(pair(plain, lp), 5)
    return out


# ---------------------------------------------------------------------------
# Flash attention kernels
# ---------------------------------------------------------------------------

FLASH_TOL = {
    # (out atol, grad atol, grad rtol)
    "float32": (5e-5, 2e-4, 2e-4),
    "bfloat16": (2e-2, 3e-2, 3e-2),
}

FLASH_CASES = [
    # name, B, T, H, D, forward, backward, padding, dropout
    ("unbounded", 2, 200, 2, 64, None, None, "none", 0.0),
    ("band 3/5, right padding", 2, 200, 2, 64, 3, 5, "right", 0.0),
    ("causal, left padding", 2, 130, 2, 32, 0, None, "left", 0.0),
    ("band 70/90 over several tiles", 1, 300, 2, 128, 70, 90, "left", 0.0),
    ("rows with no visible key", 2, 100, 2, 64, 0, 2, "dead", 0.0),
    ("ragged T=77, D=16 (padded to 32)", 2, 77, 3, 16, None, None, "right", 0.0),
    ("dropout 0.4, band 40/None", 2, 150, 2, 64, 40, None, "right", 0.4),
    # the diagonal tiles lie wholly inside the band (no visibility test in the
    # forward), their neighbours are cut by it
    ("band 100/100, tiles inside and cut", 2, 320, 2, 64, 100, 100, "none", 0.0),
    ("band 100/100, tiles inside and cut, left padding", 2, 320, 2, 64, 100, 100, "left", 0.0),
    ("band 100/100, D=128, dropout 0.4, right padding", 2, 320, 2, 128, 100, 100, "right", 0.4),
    ("T=40, shorter than one tile", 2, 40, 2, 64, None, None, "right", 0.0),
    # what the wgmma backward kernels can get wrong (bf16; float32 runs them
    # through the mma kernels): query tiles wholly inside an asymmetric band
    # and cut by it, T one past a tile edge, dead rows at D=128, key tiles
    # with no valid key
    ("band 150/70, D=128, tiles inside and cut, left padding, dropout 0.4",
     2, 400, 2, 128, 150, 70, "left", 0.4),
    ("T=65, one past a tile edge, right padding", 2, 65, 2, 128, None, None, "right", 0.0),
    ("T=129, one past a tile edge, right padding, dropout 0.4",
     2, 129, 2, 64, None, None, "right", 0.4),
    ("rows with no visible key, D=128", 2, 200, 2, 128, 0, 2, "dead", 0.0),
    ("key_valid empties whole key tiles", 2, 300, 2, 128, None, None, "hole", 0.0),
    ("key_valid empties whole key tiles, band 80/40, D=64", 2, 300, 2, 64, 80, 40, "hole", 0.0),
]


def flash_inputs(B, T, H, D, pad, dtype, device, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    q, k, v, w = (torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32))
                  .to(device=device, dtype=dtype) for _ in range(4))
    valid = np.ones((B, T), np.int32)
    if pad == "right":
        valid[0, T - T // 5:] = 0
    elif pad == "left":
        valid[0, :T // 3] = 0
        if B > 1:
            valid[1, :5] = 0
    elif pad == "dead":
        valid[0, :] = 0           # a whole example without keys
        valid[1, :T // 2] = 0     # under a causal band: padded queries see nothing
    elif pad == "hole":
        valid[0, 64:192] = 0      # two whole 64-key tiles, halves of two 128-key tiles
        valid[1, 128:256] = 0     # one whole 128-key tile
    return q, k, v, w, torch.from_numpy(valid).to(device)


def flash_run(fn, q, k, v, w, valid, fwd, bwd, drop, seed, dtype=None):
    """out and the gradients of sum(out * w) w.r.t. q, k, v through ``fn``
    (the public function or the plain version), optionally in ``dtype``."""
    import torch

    q, k, v = (x.detach().to(dtype or x.dtype).requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v, valid, fwd, bwd, drop, seed=seed)
    grads = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    return [out.detach().float()] + [g.float() for g in grads]


def flash_kernel_phase(results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from llm_bci_tpu_torch.ops import flash_attention as fa
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    dev = torch.device("cuda")
    kernel = lambda q, k, v, valid, fwd, bwd, drop, seed: fa.banded_flash_attention(
        q, k, v, valid, fwd, bwd, dropout_rate=drop, seed=seed)
    plain = lambda q, k, v, valid, fwd, bwd, drop, seed: fa.banded_flash_attention_plain(
        q, k, v, valid, fwd, bwd, drop, seed)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        o_atol, g_atol, g_rtol = FLASH_TOL[name]
        for case, B, T, H, D, fwd, bwd, pad, drop in FLASH_CASES:
            q, k, v, w, valid = flash_inputs(B, T, H, D, pad, dtype, dev)
            seed = 1234 if drop else None
            got = flash_run(kernel, q, k, v, w, valid, fwd, bwd, drop, seed)
            ref = flash_run(plain, q, k, v, w, valid, fwd, bwd, drop, seed, torch.float32)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"flash {name} {case}: non-finite values")
            errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
            torch.testing.assert_close(got[0], ref[0], atol=o_atol, rtol=0.0,
                                       msg=lambda m: f"flash {name} {case}: out: {m}")
            for which, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
                torch.testing.assert_close(a, b, atol=g_atol, rtol=g_rtol,
                                           msg=lambda m: f"flash {name} {case}: {which}: {m}")
            if pad == "dead":
                dead = ~fa.visibility_mask(T, valid, *fa._band_bounds(fwd, bwd, T), dev).any(-1)
                dead = dead[:, 0].expand(B, T)                       # (B, T) queries
                if not dead.any() or any(t[dead].abs().max().item() != 0.0
                                         for t in (got[0], got[1])):
                    raise AssertionError(f"flash {name} {case}: dead rows are not exactly 0")
                if got[2][0].abs().max().item() != 0.0 or got[3][0].abs().max().item() != 0.0:
                    raise AssertionError(f"flash {name} {case}: dK/dV of a dead example not 0")
            if drop:
                again = flash_run(kernel, q, k, v, w, valid, fwd, bwd, drop, seed)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"flash {name} {case}: same seed, different bits")
                other = flash_run(kernel, q, k, v, w, valid, fwd, bwd, drop, seed + 1)
                if torch.equal(got[0], other[0]):
                    raise AssertionError(f"flash {name} {case}: the seed changes nothing")
            if dtype == torch.bfloat16:
                worst["fwd"] = max(worst["fwd"], errs[0])
                worst["dq"] = max(worst["dq"], errs[1])
                worst["dkv"] = max(worst["dkv"], errs[2], errs[3])
            say("kernels", f"flash {name} {case}: max|err| out {errs[0]:.2e} dq {errs[1]:.2e} "
                f"dk {errs[2]:.2e} dv {errs[3]:.2e}")

    # Kept fraction, read from the kernel itself: with q = 0 the probabilities
    # are uniform and with v = 1 each output is kept_count / T / (1 - p).
    z = torch.zeros((4, 1024, 8, 32), device=dev)
    frac = fa.banded_flash_attention(z, z, torch.ones_like(z), dropout_rate=0.4, seed=99)
    frac = frac.mean().item() * 0.6
    if abs(frac - 0.6) > 0.006:
        raise AssertionError(f"flash dropout keeps {frac:.4f} of the entries, expected 0.6")
    say("kernels", f"flash dropout 0.4: kept fraction {frac:.4f} over 4*8*1024*1024 entries")

    # flash_delta_kernel against its plain version, in both dtypes. The sums
    # run in another order: rtol 1e-6 (float32) or 1e-5 (bf16 inputs, the same
    # float32 arithmetic on them) with atol the same share of the largest
    # sum of |dO * O| of a row, which is what a cancelling sum is held to.
    delta_err = 0.0
    for dtype, rtol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-5)):
        for Bd, Td, Hd, Dd in ((32, 1024, 8, 128), (3, 77, 3, 32), (2, 129, 5, 64)):
            o_, g_, _, _, _ = flash_inputs(Bd, Td, Hd, Dd, "none", dtype, dev, seed=5)
            got = fc.flash_delta(o_, g_)
            ref = fa.flash_delta_plain(o_, g_)
            torch.cuda.synchronize()
            atol = rtol * (o_.float() * g_.float()).abs().sum(-1).max().item()
            torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
            delta_err = max(delta_err, (got - ref).abs().max().item())
    say("kernels", f"flash_delta_kernel float32 and bfloat16 at D=128, 32, 64: "
        f"max|err| {delta_err:.2e}")

    # The backward launchers refuse a plan that differs from the kernel's own
    # constants in any field (the wgmma kernels and the mma kernels).
    real_plan, refused = fc.backward_plan, 0
    fields = fc.KernelPlan._fields[1:]
    try:
        for dtype, Dp in ((torch.bfloat16, 128), (torch.bfloat16, 64), (torch.float32, 32)):
            q, k, v, w, valid = flash_inputs(2, 128, 2, Dp, "none", dtype, dev)
            for field in fields:
                fc.backward_plan = lambda D_, bf16, f=field: fc.BackwardPlan(*(
                    one._replace(**{f: getattr(one, f) + 1}) for one in real_plan(D_, bf16)))
                before = (fc.BWD_DQ_LAUNCHES, fc.BWD_DKV_LAUNCHES)
                try:
                    flash_run(kernel, q, k, v, w, valid, None, None, 0.0, None)
                except RuntimeError:
                    refused += 1
                else:
                    raise AssertionError(f"flash D={Dp}: a plan with another {field} was launched")
                if before != (fc.BWD_DQ_LAUNCHES, fc.BWD_DKV_LAUNCHES):
                    raise AssertionError("flash: a refused launch was counted")
    finally:
        fc.backward_plan = real_plan
    flash_run(kernel, q, k, v, w, valid, None, None, 0.0, None)
    say("kernels", f"flash backward launchers refused {refused} plans that differ from the "
        f"kernels' own in one of {', '.join(fields)}")

    # The NDT1-mlm shape: one layer's attention at full width.
    B, T, H, D, drop, seed = 32, 1024, 8, 128, 0.4, 4321
    q, k, v, w, valid = flash_inputs(B, T, H, D, "none", torch.bfloat16, dev, seed=1)
    lengths = np.random.default_rng(2).integers(896, T + 1, size=B)
    lengths[0] = T
    valid = torch.from_numpy((np.arange(T)[None, :] >= (T - lengths)[:, None]).astype(np.int32))
    valid = valid.to(dev)                                   # left padding
    got = flash_run(kernel, q, k, v, w, valid, None, None, drop, seed)
    ref = flash_run(plain, q, k, v, w, valid, None, None, drop, seed, torch.float32)
    torch.cuda.synchronize()
    o_atol, g_atol, g_rtol = FLASH_TOL["bfloat16"]
    errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
    torch.testing.assert_close(got[0], ref[0], atol=o_atol, rtol=0.0)
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b, atol=g_atol, rtol=g_rtol)
    del ref
    again = flash_run(kernel, q, k, v, w, valid, None, None, drop, seed)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("flash at the full-width shape: same seed, different bits")
    worst = {"fwd": max(worst["fwd"], errs[0]), "dq": max(worst["dq"], errs[1]),
             "dkv": max(worst["dkv"], errs[2], errs[3])}
    say("kernels", f"flash bfloat16 B={B} H={H} T={T} D={D} dropout {drop}, left padding: "
        f"max|err| out {errs[0]:.2e} dq {errs[1]:.2e} dk {errs[2]:.2e} dv {errs[3]:.2e}; "
        f"out, dq, dk, dv the same bits twice")
    del got, again

    e = 2                                                    # bytes of a bf16

    def timings(B, T, H, D, valid, drop, seed, band=None, with_plain=False):
        """Kernel and SDPA times at one bf16 shape, with each kernel's bound
        from this run's mask; ``band`` is the (forward, backward) context,
        unbounded when None. A (query, key) pair counts when the key is
        visible; 2*D operations a pair and product: 2 products forward, 3 for
        dQ (s, dp, ds.K), 4 for dK/dV (s, dp, p^T.dO, ds^T.Q)."""
        q, k, v, w, _ = flash_inputs(B, T, H, D, "none", torch.bfloat16, dev, seed=1)
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        seed_t = torch.tensor([seed], dtype=torch.int32, device=dev)
        scale = 1.0 / math.sqrt(D)
        fwd, bwd = band if band is not None else (T, T)
        args = (q, k, v, valid, seed_t, fwd, bwd, scale, drop)
        # one library call: SDPA on (B, H, T, D) with a boolean mask of the
        # same padding and band and the same dropout rate; its backward gives
        # dq, dk and dv in one call
        qh, kh, vh, wh = (x.detach().transpose(1, 2).contiguous() for x in (q, k, v, w))
        qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
        mask = fa.visibility_mask(T, valid, fwd, bwd, dev).expand(B, 1, T, T)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, dropout_p=drop)
        pairs = float(mask.sum().item()) * H
        qkv, small = B * T * H * D * e, B * H * T * 4
        t = {"bound_fwd": bound(2 * 2 * D * pairs, 4 * qkv + small + B * T * 4, "bfloat16"),
             "bound_dq": bound(3 * 2 * D * pairs, 5 * qkv + 2 * small + B * T * 4, "bfloat16"),
             "bound_dkv": bound(4 * 2 * D * pairs, 6 * qkv + 2 * small + B * T * 4, "bfloat16"),
             "bound_delta": bound(2 * B * T * H * D, 2 * qkv + small, "float32")}
        with torch.no_grad():
            t["fwd"] = cuda_ms(lambda: fa.flash_core(*args), 20)
            t["sdpa_fwd"] = cuda_ms(sdpa, 20)
            if T <= 256:     # the host's enqueue time exceeds the kernel's
                t["fwd_device"] = graph_ms(lambda: fa.flash_core(*args), 20)
                t["sdpa_fwd_device"] = graph_ms(sdpa, 20)
        out = fa.flash_core(*args)
        # the whole backward call: delta and both kernels on a contiguous dout
        # of the kernels' dtype, which the cast passes on as it is, ...
        t["bwd"] = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), w, retain_graph=True), 20)
        # ... and on a dout that arrives strided (the (B, H, T, D) memory of a
        # transpose), which the call first copies
        w_t = w.transpose(1, 2).contiguous().transpose(1, 2)
        t["bwd_strided"] = cuda_ms(
            lambda: torch.autograd.grad(out, (q, k, v), w_t, retain_graph=True), 20)
        # the backward kernels alone, on the tensors the backward would get
        meta = fc.kernel_meta(q, fwd, bwd, scale, drop)
        with torch.no_grad():
            _, lse = fc.flash_fwd(q, k, v, valid, seed_t, meta)
            o = out.detach()
            delta = fc.flash_delta(o, w)
            back = (q, k, v, valid, seed_t, w, lse, delta, meta)
            t["delta"] = cuda_ms(lambda: fc.flash_delta(o, w), 20)
            t["plain_delta"] = cuda_ms(lambda: fa.flash_delta_plain(o, w), 20)
            # one library call for the same sums, einsum or vecdot (whose
            # (B, T, H) result is read as (B, H, T) through a view): in the
            # inputs' dtype (for bf16 it rounds the result to bf16, which the
            # kernel does not), and on float32 copies made outside the timing
            einsum = lambda a, b: torch.einsum("bthd,bthd->bht", a, b)
            vecdot = lambda a, b: torch.linalg.vecdot(a, b).transpose(1, 2)
            o32, w32 = o.float(), w.float()
            atol = 1e-4 * float((o32 * w32).abs().sum(-1).max())
            for call in (einsum, vecdot):
                torch.testing.assert_close(call(o32, w32), delta, rtol=1e-4, atol=atol)
            t["einsum_delta"] = cuda_ms(lambda: einsum(o, w), 20)
            t["vecdot_delta"] = cuda_ms(lambda: vecdot(o, w), 20)
            t["einsum_delta_f32"] = cuda_ms(lambda: einsum(o32, w32), 20)
            t["vecdot_delta_f32"] = cuda_ms(lambda: vecdot(o32, w32), 20)
            t["lib_delta"] = min(t["einsum_delta"], t["vecdot_delta"])
            del o32, w32
            t["dq"] = cuda_ms(lambda: fc.flash_dq(*back), 20)
            t["dkv"] = cuda_ms(lambda: fc.flash_dkv(*back), 20)
            if T <= 256:
                t["delta_device"] = graph_ms(lambda: fc.flash_delta(o, w), 20)
                t["dq_device"] = graph_ms(lambda: fc.flash_dq(*back), 20)
                t["dkv_device"] = graph_ms(lambda: fc.flash_dkv(*back), 20)
        del out
        if with_plain:
            p_out = fa.banded_flash_attention_plain(q, k, v, valid, fwd, bwd, drop, seed_t)
            with torch.no_grad():
                t["plain_fwd"] = cuda_ms(lambda: fa.banded_flash_attention_plain(
                    q, k, v, valid, fwd, bwd, drop, seed_t), 3)
            t["plain_dq"] = cuda_ms(
                lambda: torch.autograd.grad(p_out, q, w, retain_graph=True), 3)
            t["plain_dkv"] = cuda_ms(
                lambda: torch.autograd.grad(p_out, (k, v), w, retain_graph=True), 3)
            del p_out
        s_out = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(s_out, (qh, kh, vh), wh, retain_graph=True)
        t["sdpa_bwd"] = cuda_ms(sdpa_bwd, 20)   # autograd's engine cannot be captured: eager
        return t

    def backward_line(label, t):
        pair = t["dq"] + t["dkv"]
        say("kernels", f"flash backward at {label}: flash_dq_kernel {t['dq']:.3f} ms (bound "
            f"{t['bound_dq']['bound_ms']:.3f}, {t['bound_dq']['bound_by']}), flash_dkv_kernel "
            f"{t['dkv']:.3f} ms (bound {t['bound_dkv']['bound_ms']:.3f}, "
            f"{t['bound_dkv']['bound_by']}), the pair {pair:.3f} ms, the whole backward call "
            f"{t['bwd']:.3f} ms ({t['bwd_strided']:.3f} with the copy of a strided dout); one "
            f"SDPA backward (dq, dk, dv) {t['sdpa_bwd']:.3f} ms: the pair "
            f"{pair / t['sdpa_bwd']:.2f}x, the call {t['bwd'] / t['sdpa_bwd']:.2f}x "
            f"({t['bwd_strided'] / t['sdpa_bwd']:.2f}x) its time")

    t = timings(B, T, H, D, valid, drop, seed, with_plain=True)
    for key, label in (("fwd", FWD_WG), ("dq", DQ_WG), ("dkv", DKV_WG),
                       ("delta", "flash_delta_kernel")):
        # one SDPA backward gives dq, dk and dv: both backward kernels are
        # held against that one call; delta against the faster of one einsum
        # and one vecdot on the same bf16 tensors
        library = {"fwd": t["sdpa_fwd"], "dq": t["sdpa_bwd"], "dkv": t["sdpa_bwd"],
                   "delta": t["lib_delta"]}[key]
        err = delta_err if key == "delta" else worst[key]
        results[label] = dict(max_abs_err=err, ms=t[key], plain_ms=t[f"plain_{key}"],
                              library_ms=library, **t[f"bound_{key}"])
        say("kernels", f"{label} at B={B} H={H} T={T} D={D} bf16 dropout {drop}: "
            f"{t[key]:.4f} ms, bound {t['bound_' + key]['bound_ms']:.4f} ms "
            f"({t['bound_' + key]['bound_by']}), plain {t['plain_' + key]:.3f} ms, library "
            f"{library:.4f} ms")
    say("kernels", f"flash_delta_kernel's library calls on the bf16 tensors (bf16 result) and "
        f"on float32 copies: torch.einsum('bthd,bthd->bht') {t['einsum_delta']:.4f} and "
        f"{t['einsum_delta_f32']:.4f} ms, torch.linalg.vecdot {t['vecdot_delta']:.4f} and "
        f"{t['vecdot_delta_f32']:.4f} ms")
    backward_line(f"B={B} H={H} T={T} D={D} bf16 dropout {drop}", t)
    q0, k0, v0, _, _ = flash_inputs(B, T, H, D, "none", torch.bfloat16, dev, seed=1)
    with torch.no_grad():
        no_drop = cuda_ms(lambda: fa.flash_core(
            q0, k0, v0, valid, None, T, T, 1.0 / math.sqrt(D), 0.0), 20)
    say("kernels", f"flash_fwd_kernel without dropout: {no_drop:.3f} ms "
        f"(the keep mask costs {t['fwd'] - no_drop:.3f} ms)")
    k_all = t["fwd"] + t["bwd"]
    s_all = t["sdpa_fwd"] + t["sdpa_bwd"]
    say("kernels", f"flash vs SDPA at T={T}: forward {t['fwd'] / t['sdpa_fwd']:.2f}x its time, "
        f"forward+backward {k_all:.3f} ms vs {s_all:.3f} ms ({k_all / s_all:.2f}x)")

    # Under a band and at D=64: the visible pairs of this run's mask give the
    # bounds, SDPA gets the same mask.
    for label, Bx, Hx, Dx, band in ((f"D={D} band 128/128", B, H, D, (128, 128)),
                                    ("D=64 unbounded", B, 2 * H, 64, None)):
        tx = timings(Bx, T, Hx, Dx, valid, drop, seed, band=band)
        bx = tx["bound_fwd"]
        say("kernels", f"flash_fwd_kernel at B={Bx} H={Hx} T={T}, {label}, bf16 dropout "
            f"{drop}: {tx['fwd']:.3f} ms, bound {bx['bound_ms']:.3f} ms ({bx['bound_by']}), "
            f"SDPA {tx['sdpa_fwd']:.3f} ms ({tx['fwd'] / tx['sdpa_fwd']:.2f}x)")
        backward_line(f"B={Bx} H={Hx} T={T}, {label}, bf16 dropout {drop}", tx)

    # The short length of the stacked CTC path, for the auto threshold.
    Bs, Ts = 64, 128
    valid_s = torch.ones((Bs, Ts), dtype=torch.int32, device=dev)
    ts = timings(Bs, Ts, H, D, valid_s, drop, seed, with_plain=True)
    k_all = ts["fwd"] + ts["bwd"]
    s_all = ts["sdpa_fwd"] + ts["sdpa_bwd"]
    say("kernels", f"flash vs SDPA at B={Bs} T={Ts}: forward {ts['fwd']:.3f} ms vs "
        f"{ts['sdpa_fwd']:.3f} ms ({ts['fwd'] / ts['sdpa_fwd']:.2f}x), forward+backward "
        f"{k_all:.3f} ms vs {s_all:.3f} ms ({k_all / s_all:.2f}x); plain forward "
        f"{ts['plain_fwd']:.3f} ms, plain backward {ts['plain_dq'] + ts['plain_dkv']:.3f} ms")
    say("kernels", f"at B={Bs} T={Ts}, device time from a CUDA graph of 20 launches: "
        f"flash_fwd_kernel {ts['fwd_device']:.4f} ms, SDPA forward {ts['sdpa_fwd_device']:.4f} "
        f"ms; flash_delta_kernel {ts['delta_device']:.4f}, flash_dq_kernel "
        f"{ts['dq_device']:.4f}, flash_dkv_kernel {ts['dkv_device']:.4f} ms (eager, with "
        f"the host's enqueue time: {ts['delta']:.4f}, {ts['dq']:.4f}, {ts['dkv']:.4f}, the "
        f"whole backward call {ts['bwd']:.4f}, one SDPA backward {ts['sdpa_bwd']:.4f} ms)")

    # Registers and spills of the kernels, as the compiler left them. A kernel
    # that spills is right and slow, so the stack is held to what is known:
    # none, but for 64 bytes in dK/dV at D=64 (two blocks an SM at 128
    # registers, which measured faster than one block without spills).
    found = _build_resources("flash_attention", ("wgmma", "flash_delta"))
    for kernel_name, (reg, stack) in sorted(found.items()):
        allowed = 64 if kernel_name == "flash_dkv_wgmma_kernelILi64" else 0
        say("kernels", f"{kernel_name}: {reg} registers a thread, {stack} bytes of stack "
            f"(at most {allowed})")
        if stack > allowed:
            raise AssertionError(f"{kernel_name} spills: {stack} bytes of stack, {allowed} allowed")
    wgmma = [n for n in found if "wgmma" in n]
    if len(wgmma) != 6 or not any("flash_delta" in n for n in found):
        raise AssertionError(f"resource usage: expected the six wgmma kernels and delta: {found}")


def _build_resources(name: str, patterns) -> dict:
    """``cuobjdump --dump-resource-usage`` of a built library: (registers a
    thread, stack bytes) of each kernel whose name holds one of ``patterns``,
    by the part of its mangled name that holds kernel, dtype and head size."""
    from llm_bci_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-resource-usage", _build.build(name)],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    found, current = {}, None
    for raw in out.splitlines():
        raw = raw.strip()
        if raw.startswith("Function "):
            current = raw[len("Function "):].rstrip(":")
        elif raw.startswith("REG:") and current and any(p in current for p in patterns):
            short = re.search(r"flash_(?:fwd|dq|dkv|delta)_\w*?kernelI\w*?Li\d+"
                              r"|ctc_alpha(?:_beta)?_kernel", current)
            reg, stack = re.search(r"REG:(\d+)", raw), re.search(r"STACK:(\d+)", raw)
            found[short.group(0) if short else current] = (int(reg.group(1)), int(stack.group(1)))
    return found


# ---------------------------------------------------------------------------
# Int8 dequant-matmul kernels
# ---------------------------------------------------------------------------

# (K, N) of the frozen Llama-2-7B base: q/k/v/o, gate/up, down, lm_head.
INT8_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
# one rank's share of q/k/v/o, gate/up and down at tp=2 (parallel/tensor_parallel.py)
INT8_TP2_SHAPES = [(4096, 2048), (4096, 5504), (2048, 4096), (5504, 4096)]
# a token step at one row, 5 beams of one trial, greedy (B=8), 5 beams (B=8),
# the cluster kernel's largest M; the prefill of one trial, the forward of one
# trial (eval-phonemes), its prefill with 5 beams; prefill / fine-tune (B=8)
INT8_MS = (1, 5, 8, 40, 64, 137, 185, 685, 1480)
INT8_TIMED_MS = (8, 40, 1480)


def int8_inputs(M, K, N, dtype, device, seed=0):
    """x ~ N(0, 1), codes uniform in [-127, 127], scales around 0.02 * 4 / 127."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=device, dtype=torch.float32).to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=g, device=device, dtype=torch.int8)
    scale = (0.5 + torch.rand((N,), generator=g, device=device)) * (0.02 * 4.0 / 127.0)
    return x, q, scale


def int8_plan_text(M, K, N, dtype) -> str:
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic
    import torch

    kind = ic.regime(M, dtype == torch.bfloat16)
    if kind == "f32":
        return "float32 128 x 128 tiles"
    if kind == "cluster":
        p = ic.cluster_plan(M, K, N)
        return (f"cluster C={p.cluster} x {p.grid[1]} column tiles, {p.k_per_rank // 64} k-tiles "
                f"a rank, {p.stages} stages, {p.m_tiles} x 8 rows, {p.threads} threads, "
                f"{p.smem_bytes} B")
    t = ic.tile_plan(M, K, N)
    return f"wgmma {t.tile_m} x 128 tiles, grid {t.grid}, {t.smem_bytes} B"


def raw_cluster_launch(x, q, scale, out, plan) -> int:
    """The cluster launcher's own return code for ``plan``, through its C
    entry point, with no check of the plan on this side (the wrapper checks
    first, so a refusal of the launcher is seen only from here)."""
    import torch
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    M, K = x.shape
    with torch.cuda.device(x.device):
        return ic._lib().int8_matmul_cluster_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, q.shape[1],
            int(out.dtype == torch.float32), plan.m_tiles, plan.cluster, plan.k_per_rank,
            plan.grid[1], plan.threads, plan.stages, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)


def int8_launches() -> dict:
    """The int8 wrapper's launches since its last reset, by the kernel of the
    regime each took; a float32 launch (no main path makes one) is in
    ``LAUNCHES`` only, so that it shows as a difference of the two."""
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    return {INT8_CLUSTER: ic.REGIME_LAUNCHES["cluster"], INT8_TILED: ic.REGIME_LAUNCHES["tiled"]}


def int8_kernel_phase(results: dict, power_line: str) -> None:
    import torch
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic
    from llm_bci_tpu_torch.ops import quant

    dev = torch.device("cuda")

    def reference(x, q, scale):
        """The plain version in float32 on the same inputs."""
        return quant.int8_matmul_plain(x.float(), q, scale, torch.float32)

    # float32 x: small and ragged M, small K / N (multiples of 16, not of the
    # tiles). rtol 1e-4 and atol 1e-4 * max|out|: float32 sums in another order.
    for M, K, N in [(1, 32, 32), (8, 48, 80), (40, 1024, 272), (185, 160, 4096),
                    (70, 4096, 144)]:
        x, q, scale = int8_inputs(M, K, N, torch.float32, dev, seed=M)
        got = quant.int8_matmul(x, q, scale)
        ref = reference(x, q, scale)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item(),
                                   msg=lambda m: f"int8 float32 M={M} K={K} N={N}: {m}")
        say("int8", f"float32 M={M} K={K} N={N}: max|err| {err:.2e} "
            f"(max|out| {ref.abs().max().item():.2e})")

    # bf16 x against the plain version in float32 of the same bf16 inputs.
    # rtol 2^-8: one bf16 rounding of the output (half an ulp is 2^-9 of the
    # value); atol 1e-4 * max|out|: float32 sums in another order, which matter
    # where the sum cancels to near zero. Every call twice: the same bits (the
    # cluster kernel adds its ranks' partials in rank order).
    worst = {"small": 0.0, "tiled": 0.0}

    def check_bf16(M, K, N, seed, what=""):
        x, q, scale = int8_inputs(M, K, N, torch.bfloat16, dev, seed=seed)
        before = ic.LAUNCHES
        got = quant.int8_matmul(x, q, scale).float()
        if ic.LAUNCHES != before + 1:
            raise AssertionError(f"int8 bf16 M={M} K={K} N={N}: {ic.LAUNCHES - before} launches")
        ref = reference(x, q, scale)
        torch.cuda.synchronize()
        top = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, rtol=2.0 ** -8, atol=1e-4 * top,
                                   msg=lambda m: f"int8 bf16 M={M} K={K} N={N}: {m}")
        if not torch.equal(got, quant.int8_matmul(x, q, scale).float()):
            raise AssertionError(f"int8 bf16 M={M} K={K} N={N}: same input, different bits")
        key = "small" if M <= ic.CLUSTER_MAX_M else "tiled"
        worst[key] = max(worst[key], err)
        say("int8", f"bf16{what} M={M} K={K} N={N} ({int8_plan_text(M, K, N, torch.bfloat16)}): "
            f"max|err| {err:.3e} of max|out| {top:.3e}; same bits twice")

    for K, N in INT8_SHAPES:
        for M in INT8_MS:
            check_bf16(M, K, N, seed=M + K)
    # Each rank's share of the products under tensor parallelism, tp=2: q/k/v
    # and gate/up cut along N (column-parallel), o and down along K
    # (row-parallel); M in both regimes.
    for K, N in INT8_TP2_SHAPES:
        for M in INT8_MS:
            check_bf16(M, K, N, seed=M + N, what=" tp=2 share")
    # Ragged edges: M off every 8-row tile and on the regimes' border, N off
    # the 128-column tile (and exactly on it), K off the 64-deep k-tile, K and
    # N smaller than one tile; clusters of 1 to 8 ranks.
    for K, N in [(160, 144), (4112, 272), (4112, 11008), (160, 4096), (32, 48), (1024, 4096)]:
        for M in (1, 3, 9, 17, 33, 41, 64, 65, 129, 185, 1480):
            check_bf16(M, K, N, seed=M + N, what=" ragged")
    # float32 output from bf16 x (the kernels' other store path), both regimes
    for M in (40, 185):
        x, q, scale = int8_inputs(M, 4096, 4096, torch.bfloat16, dev, seed=5)
        got = quant.int8_matmul(x, q, scale, out_dtype=torch.float32)
        ref = reference(x, q, scale)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())

    # Codes of +-127 only, and a scale column of zeros: exactly 0 there.
    for M in (8, 40, 185):
        x, q, scale = int8_inputs(M, 4096, 4096, torch.bfloat16, dev, seed=9)
        q = torch.where(q >= 0, torch.full_like(q, 127), torch.full_like(q, -127))
        scale[::7] = 0.0
        got = quant.int8_matmul(x, q, scale).float()
        ref = reference(x, q, scale)
        torch.testing.assert_close(got, ref, rtol=2.0 ** -8, atol=1e-4 * ref.abs().max().item())
        if got[:, ::7].abs().max().item() != 0.0 or not torch.isfinite(got).all():
            raise AssertionError("int8: a zero scale column is not exactly 0")
    say("int8", "codes of +-127 with zero scale columns: agree, zero columns exactly 0")

    # dx through the Function against autograd of the plain version.
    for dtype, M, K, N, rtol in ((torch.float32, 40, 256, 512, 1e-4),
                                 (torch.bfloat16, 40, 4096, 11008, 2.0 ** -7),
                                 (torch.bfloat16, 1480, 4096, 11008, 2.0 ** -7)):
        x, q, scale = int8_inputs(M, K, N, dtype, dev, seed=3)
        w = torch.randn((M, N), device=dev, dtype=torch.float32)
        grads = []
        for fn in (quant.int8_matmul, quant.int8_matmul_plain):
            xi = x.clone().requires_grad_(True)
            (g,) = torch.autograd.grad((fn(xi, q, scale).float() * w).sum(), xi)
            grads.append(g.float())
        torch.testing.assert_close(grads[0], grads[1], rtol=rtol,
                                   atol=rtol * grads[1].abs().max().item())
        say("int8", f"dx {str(dtype).split('.')[-1]} M={M} K={K} N={N}: max|err| "
            f"{(grads[0] - grads[1]).abs().max().item():.3e} of max "
            f"{grads[1].abs().max().item():.3e}")

    # The cluster launcher refuses a plan that differs from the kernel's own
    # in any field, and launches nothing then.
    x, q, scale = int8_inputs(8, 4096, 4096, torch.bfloat16, dev, seed=4)
    out = torch.empty((8, 4096), device=dev, dtype=torch.bfloat16)
    plan = ic.cluster_plan(8, 4096, 4096)
    refused = []
    for field in ic.ClusterPlan._fields:
        value = getattr(plan, field)
        bad = plan._replace(**{field: (value[0], value[1] + 1) if field == "grid" else value + 1})
        rc = raw_cluster_launch(x, q, scale, out, bad)
        if rc == 0:
            raise AssertionError(f"int8 cluster launcher took a plan with another {field}: {bad}")
        refused.append(f"{field} ({rc})")
    if raw_cluster_launch(x, q, scale, out, plan) != 0:
        raise AssertionError("int8 cluster launcher refused its own plan")
    torch.cuda.synchronize()
    say("int8", f"the cluster launcher refused plans with another {', '.join(refused)} "
        f"(CUDA error codes), and took its own")

    # Times. Each call reads another copy of the weight, from a ring larger
    # than the 50 MB L2, as a model's layers do. Device times from CUDA graphs
    # of 20 calls (graph_ms); the eager time of the same calls, with the
    # host's enqueue through the wrapper, beside it.
    def ring(t, total=128e6):
        return [t.clone() for _ in range(max(2, int(total // (t.numel() * t.element_size())) + 1))]

    for K, N in INT8_SHAPES:
        _, q, scale = int8_inputs(8, K, N, torch.bfloat16, dev, seed=1)
        qs, ws = ring(q), ring(q.to(torch.bfloat16))
        state = {"i": 0}

        def nxt(pool):
            state["i"] += 1
            return pool[state["i"] % len(pool)]

        for M in INT8_TIMED_MS:
            x = int8_inputs(M, K, N, torch.bfloat16, dev, seed=M)[0]
            reps = 20
            kernel = lambda: ic.int8_matmul_cuda(x, nxt(qs), scale, torch.bfloat16)
            library = lambda: torch.matmul(x, nxt(ws))
            with torch.no_grad():
                t_kernel = graph_ms(kernel, reps)
                t_lib = graph_ms(library, reps)
                t_eager = cuda_ms(kernel, reps)
                t_lib_eager = cuda_ms(library, reps)
                t_plain = cuda_ms(lambda: quant.int8_matmul_plain(x, nxt(qs), scale), 5)
                t_convert = cuda_ms(lambda: torch.matmul(x, nxt(qs).to(torch.bfloat16)), 5)
            b = bound(2.0 * M * K * N, M * K * 2 + K * N + N * 4 + M * N * 2, "bfloat16")
            say("int8", f"M={M} K={K} N={N} bf16 ({int8_plan_text(M, K, N, torch.bfloat16)}): "
                f"kernel {t_kernel:.4f} ms of device time (CUDA graph of {reps}), bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {b['bound_ms'] / t_kernel:.0%} of it); "
                f"torch.matmul on a bf16 weight {t_lib:.4f} ms the same way (kernel / matmul "
                f"{t_kernel / t_lib:.2f}); eager, with the host's enqueue: kernel {t_eager:.4f}, "
                f"matmul {t_lib_eager:.4f} ms; plain {t_plain:.4f} ms, convert + matmul "
                f"{t_convert:.4f} ms; card {power_line}")
            if (K, N) == (4096, 11008) and M != 40:
                name = INT8_CLUSTER if M == 8 else INT8_TILED
                results[name] = dict(
                    max_abs_err=worst["small" if M == 8 else "tiled"], ms=t_kernel,
                    plain_ms=t_plain, library_ms=t_lib, eager_ms=t_eager,
                    convert_matmul_ms=t_convert, **b)
        del qs, ws


# ---------------------------------------------------------------------------
# BCI main paths: serving and the LoRA fine-tune at Llama-2-7B width
# ---------------------------------------------------------------------------

# meta-llama/Llama-2-7b-hf config.json (the widths; the weights are random)
LLAMA2_7B = {
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
    "max_position_embeddings": 4096, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": False,
}
BCI_B, BCI_BINS, BCI_CHANNELS, BCI_TEXT, BCI_SPLIT = 8, 512, 256, 64, 8
BCI_PROMPT = BCI_TEXT + (BCI_BINS - 32) // 4 + 1      # 64 text + 121 spike tokens = 185
INT8_PER_FORWARD = 7 * 32 + 1                         # 7 projections a layer + lm_head
LORA = {"r": 8, "alpha": 32, "dropout": 0.0, "modules_to_save": [],
        "target_modules": ["q_proj", "v_proj", "k_proj", "o_proj", "gate_proj", "up_proj",
                           "down_proj"]}


def write_llama_config(root: str, n_layers: int) -> str:
    """A directory with the Llama-2-7B ``config.json`` at ``n_layers`` and no
    weight files: the model's widths, random weights."""
    path = os.path.join(root, f"llama2_7b_{n_layers}l")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**LLAMA2_7B, "num_hidden_layers": n_layers}, f)
    return path


def bci_rows(n: int, seed: int) -> list:
    """Pre-tokenized BCI trials: 512 bins x 256 channels of Poisson spikes, 64
    text tokens with the spikes spliced in at 8, the loss on the last 48."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ids = rng.integers(3, LLAMA2_7B["vocab_size"], size=(BCI_TEXT,)).astype(np.int64)
        rows.append({
            "spikes": rng.poisson(1.0, size=(BCI_BINS, BCI_CHANNELS)).astype(np.float32),
            "input_ids": ids, "attention_mask": np.ones(BCI_TEXT, np.int64),
            "input_split": np.atleast_1d(BCI_SPLIT),
            "labels": np.concatenate([np.full(16, -100, np.int64), ids[16:]]),
            "sentence": "a b c", "day_idx": np.asarray(i % 2), "block_idx": np.asarray(i % 2),
        })
    return rows


class WordTokenizer:
    """A stand-in for the Llama tokenizer over a fixed word list (the words of
    ``SENTENCES``): ids 0, 1, 2 are unk, bos and eos, which
    ``skip_special_tokens`` drops; any other id decodes to a word."""

    unk_token_id, bos_token_id, eos_token_id = 0, 1, 2
    WORDS = sorted({w for s in SENTENCES for w in s.split()})

    def decode(self, ids, skip_special_tokens=True):
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        return " ".join(self.WORDS[i % len(self.WORDS)] for i in ids
                        if not (skip_special_tokens and i < 3))


def bci_serving_batch(device):
    import torch

    rows = bci_rows(BCI_B, seed=0)
    stack = lambda key: torch.from_numpy(np.stack([r[key] for r in rows])).to(device)
    T = BCI_BINS
    return {
        "input_ids": stack("input_ids"), "attention_mask": stack("attention_mask"),
        "input_split": stack("input_split"), "spikes": stack("spikes"),
        "spikes_mask": torch.ones((BCI_B, T), dtype=torch.int64, device=device),
        "spikes_timestamp": torch.arange(T, device=device).expand(BCI_B, T).contiguous(),
        "block_idx": stack("block_idx"), "day_idx": stack("day_idx"),
    }


def device_profile(fn, label: str, power_line: str, path=None, wall_ms_unprofiled=None,
                   phase: str = "bci") -> dict:
    """``torch.profiler`` over ``fn()``: device-busy time (the sum of the
    kernel rows) and its split by kind of kernel, beside the wall time under
    the profiler and, where given, the wall time of the same call without it
    (the profiler slows the host's launches, not the kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and not ev.key.startswith("Optimizer.")]
    dev_us = lambda ev: getattr(ev, "self_device_time_total", None) or getattr(
        ev, "self_cuda_time_total", 0)
    rows = sorted(((dev_us(ev), ev.count, ev.key) for ev in events if dev_us(ev) > 0),
                  reverse=True)
    total = sum(us for us, _, _ in rows)
    groups = {"int8 matmul kernels": ("int8_",), "flash attention kernels": ("flash_",),
              "GEMMs": ("nvjet", "gemm", "cutlass", "gemv"),
              "copies and casts": ("copy", "Memcpy"), "softmax": ("softmax",),
              "index / gather / scatter": ("index", "gather", "scatter"),
              "random draws": ("distribution", "philox", "rand"),
              "AdamW": ("multi_tensor", "adam")}
    other = "other (elementwise, reductions, norms)"
    shares = dict.fromkeys([*groups, other], 0.0)
    n_launches = 0
    for us, count, key in rows:
        name = next((g for g, pats in groups.items() if any(p in key for p in pats)), other)
        shares[name] += us
        n_launches += count
    # the host's launch calls (a replayed graph is one cudaGraphLaunch)
    host_launches = sum(ev.count for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CPU
                        and ev.key.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch")))
    busy = (f"{total / 1e3 / wall_ms_unprofiled:.3f} of the {wall_ms_unprofiled:.1f} ms the call "
            f"takes without the profiler, " if wall_ms_unprofiled else "")
    say(phase, f"{label}: device busy {total / 1e3:.1f} ms ({busy}"
        f"{total / 1e3 / wall_ms:.3f} of the {wall_ms:.1f} ms under the profiler), "
        f"{n_launches} kernel launches on the device, {host_launches} launch calls on the "
        f"host; card {power_line}")
    for name, us in shares.items():
        say(phase, f"  {us / 1e3:9.3f} ms {us / max(total, 1):7.3%} {name}")
    if path:
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(f"\n{label}; card: {power_line}\nwall under the profiler {wall_ms:.1f} ms, "
                    f"without {wall_ms_unprofiled} ms, device busy {total / 1e3:.1f} ms, "
                    f"{n_launches} launches\n")
            for name, us in shares.items():
                f.write(f"{us / 1e3:10.3f} ms {us / max(total, 1):7.3%} {name}\n")
            for us, count, key in rows[:30]:
                f.write(f"{us / 1e3:10.3f} ms {us / total:7.3%} x{count:<6d} {key[:110]}\n")
    return {"wall_ms": wall_ms, "busy_ms": total / 1e3, "launches": n_launches,
            "host_launches": host_launches}


def build_bci(llm_path: str, quant, device):
    """BCI as ``configs/bci.yaml`` + ``configs/ndt1.yaml`` give it (NDT1 trunk
    5 x 1024, stack 32 / 4, projector 1024 -> 2048 -> 4096), LoRA r=8 on all
    seven projections, the Llama widths from ``llm_path/config.json``."""
    import torch
    from llm_bci_tpu_torch.config import DictConfig
    from llm_bci_tpu_torch.models.bci import BCI

    torch.manual_seed(0)
    t0 = time.perf_counter()
    model = BCI.from_config(
        DictConfig({"ndt1": {"encoder": {"embedder": {"n_channels": BCI_CHANNELS}}}}),
        method_name="endtoend", llm_path=llm_path, lora=dict(LORA), freeze_llm=False,
        quantize=quant, compute_dtype="bfloat16", device=device,
    ).eval()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def prefill_step(model, batch, new_tokens: int):
    """The eager prefill of ``generate``'s greedy decode and the
    :class:`TokenStep` over its cache, not yet run: ``(first ids, step, P)``."""
    import torch
    from llm_bci_tpu_torch.models.decode_graph import TokenStep

    embeds, mask, _ = model.prepare_embeds(**batch)
    B, P, _ = embeds.shape
    key_mask = mask.new_zeros((B, P + new_tokens))
    key_mask[:, :P] = mask
    decode = lambda e, km, c, idx: model.llm(inputs_embeds=e, attention_mask=km, cache=c,
                                             cache_index=idx)
    logits, cache = decode(embeds, key_mask, model.llm.init_cache(B, P + new_tokens), 0)
    return torch.argmax(logits[:, -1, :], -1), TokenStep(decode, cache, key_mask), P


def bci_serve_phase(power_line: str, profile) -> dict:
    import torch
    from llm_bci_tpu_torch.models import decode_graph
    from llm_bci_tpu_torch.models import llama as tllama
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic
    from llm_bci_tpu_torch.ops import quant

    dev = torch.device("cuda")
    new_tokens, beams = 32, 5
    batch = bci_serving_batch(dev)
    vocab = LLAMA2_7B["vocab_size"]
    autocast = lambda: torch.autocast("cuda", dtype=torch.bfloat16)

    def check_ids(ids, shape, what):
        if tuple(ids.shape) != shape or ids.dtype != torch.int64:
            raise AssertionError(f"{what}: shape {tuple(ids.shape)} {ids.dtype}, want {shape}")
        if int(ids.min()) < 0 or int(ids.max()) >= vocab:
            raise AssertionError(f"{what}: token ids out of [0, {vocab})")

    def timed(fn, reps=2):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    def greedy(m, n=new_tokens):
        with autocast():
            return m.generate(**batch, max_new_tokens=n, eos_token_id=-1)

    def diverse(m):
        with autocast():
            return m.generate(**batch, max_new_tokens=new_tokens, num_beams=beams,
                              num_beam_groups=beams, diversity_penalty=1.2,
                              num_return_sequences=beams, eos_token_id=2)

    def decode_times(m, label):
        """Greedy tokens/s of a whole decode (its eager prefill, its eager
        first token step, its capture and 30 replays) and its parts: the
        prefill alone, the capture, the token steps; then a profile of 16
        replayed greedy steps (argmax, embedding, key mask and the graph of
        the step)."""
        decode_graph.reset_counters()
        g_s = timed(lambda: greedy(m))
        capture_s = decode_graph.CAPTURE_SECONDS / decode_graph.CAPTURES
        with torch.no_grad(), autocast():
            prefill_s = timed(lambda: prefill_step(m, batch, new_tokens))
        step_ms = (g_s - prefill_s) * 1e3 / (new_tokens - 1)
        say("bci", f"{label}: greedy {BCI_B * new_tokens / g_s:.1f} tokens/s ({g_s * 1e3:.1f} ms "
            f"for {new_tokens} tokens of B={BCI_B}, each decode capturing its own token step): "
            f"prefill (M={BCI_B * BCI_PROMPT}, eager) {prefill_s * 1e3:.1f} ms, {step_ms:.3f} ms a "
            f"token step (the rest over {new_tokens - 1} steps: one eager, the capture "
            f"{capture_s * 1e3:.1f} ms, {new_tokens - 2} replays); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; card {power_line}")
        with torch.no_grad(), autocast():
            token, step, P = prefill_step(m, batch, 40)
            step.key_mask[:, P] = 1
            step(m.llm.embed(token[:, None]), P)          # the first step and the capture

            def steps(n=16):
                tok = token
                for t in range(1, n + 1):
                    step.key_mask[:, P + t] = 1
                    tok = torch.argmax(step(m.llm.embed(tok[:, None]), P + t), -1)
                return tok

            wall_ms = timed(steps) * 1e3
            prof = device_profile(steps, f"16 replayed greedy token steps, {label}", power_line,
                                  profile, wall_ms)
        say("bci", f"{label}: a replayed greedy token step {prof['busy_ms'] / 16:.3f} ms of "
            f"device time, {wall_ms / 16:.3f} ms of wall time")
        return g_s, wall_ms / 16

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # Kernel path against the plain matmul on the card, 2 layers deep.
        small, _ = build_bci(write_llama_config(tmp, 2), "int8", dev)
        with torch.no_grad(), autocast():
            embeds, mask, _ = small.prepare_embeds(**batch)
            k_logits, _ = small.llm(inputs_embeds=embeds, attention_mask=mask)
            decode_graph.reset_counters()
            k_tokens = small.generate(**batch, max_new_tokens=new_tokens, eos_token_id=-1)
            kernel_matmul = tllama.int8_matmul
            tllama.int8_matmul = quant.int8_matmul_plain
            try:
                p_logits, _ = small.llm(inputs_embeds=embeds, attention_mask=mask)
                p_tokens = small.generate(**batch, max_new_tokens=new_tokens, eos_token_id=-1)
            finally:
                tllama.int8_matmul = kernel_matmul
        # each decode captured its own step: the second from the plain product
        if decode_graph.CAPTURES != 2:
            raise AssertionError(f"{decode_graph.CAPTURES} captures for two decodes, want 2")
        top = p_logits.abs().max().item()
        err = (k_logits - p_logits).abs()
        # bf16 activations through 15 products in a chain (2 layers and
        # lm_head): each output is rounded to bf16 (the plain version twice,
        # before and after the scale) and summed in another order, so single
        # entries of the 47 M logits differ by a few bf16 steps of the largest
        # logit (2^-8 of it each) while the mean stays under one step: 15
        # independent roundings of 2^-9 relative each give about sqrt(15) *
        # 2^-9 = 2^-7 of a typical logit, itself a fraction of the largest.
        if not (err.max().item() <= 2.0 ** -5 * top and err.mean().item() <= 2.0 ** -8 * top):
            raise AssertionError(f"kernel and plain logits disagree: max|err| {err.max().item()} "
                                 f"mean|err| {err.mean().item()} of max|logit| {top}")
        same = (k_tokens == p_tokens).float().mean().item()
        say("bci", f"2-layer int8 model, kernel against plain matmul on the card: prompt logits "
            f"max|err| {err.max().item():.3e}, mean|err| {err.mean().item():.3e} of max {top:.3e} "
            f"(held to 2^-5 and 2^-8 of it); "
            f"{same:.3f} of {k_tokens.numel()} greedy tokens equal, "
            f"{int((k_tokens[:, 0] == p_tokens[:, 0]).sum())} of {BCI_B} first tokens (an argmax "
            f"can flip on a near-tie of bf16 logits and the row then goes its own way; the "
            f"logits are what is held)")
        del small, embeds, k_logits, p_logits, err

        # Main path: 32 layers, int8 base.
        path32 = write_llama_config(tmp, 32)
        torch.cuda.reset_peak_memory_stats()
        model, build_s = build_bci(path32, "int8", dev)
        if dataclasses.asdict(model.llama_config) != LLAMA2_7B:
            raise AssertionError(f"not Llama-2-7B: {model.llama_config}")
        weights_gib = torch.cuda.memory_allocated() / 2 ** 30
        say("bci", f"BCI with a 32-layer int8 Llama-2-7B-width base built on the card in "
            f"{build_s:.1f} s, {weights_gib:.2f} GiB allocated")

        ic.reset_counters()
        decode_graph.reset_counters()
        tokens = greedy(model)
        result = diverse(model)
        torch.cuda.synchronize()
        launches = int8_launches()
        graphs = (decode_graph.EAGER_STEPS, decode_graph.CAPTURES, decode_graph.REPLAYS)
        check_ids(tokens, (BCI_B, new_tokens), "greedy")
        check_ids(result.sequences, (BCI_B, beams, new_tokens), "diverse beam")
        if tuple(result.scores.shape) != (BCI_B, beams) or not torch.isfinite(result.scores).all():
            raise AssertionError("diverse beam scores have the wrong shape or are not finite")
        if (result.scores[:, :-1] < result.scores[:, 1:]).any():
            raise AssertionError("diverse beam hypotheses are not sorted best-first")
        # Each decode: one eager prefill (M = B x 185 rows or 5 times that:
        # wgmma tiles), then 31 token steps (M = 8 greedy, 40 with 5 beams:
        # the cluster kernel): the first eager, then captured once and
        # replayed 30 times. The wrappers count on the host: the eager step
        # and the capture; the device runs the eager step and the replays.
        if graphs != (2, 2, 2 * (new_tokens - 2)):
            raise AssertionError(f"eager steps, captures, replays {graphs}, "
                                 f"want (2, 2, {2 * (new_tokens - 2)})")
        want = {INT8_TILED: 2 * INT8_PER_FORWARD,
                INT8_CLUSTER: (graphs[0] + graphs[1]) * INT8_PER_FORWARD}
        if launches != want or ic.LAUNCHES != sum(want.values()):
            raise AssertionError(f"int8 launches {launches} (total {ic.LAUNCHES}), want {want}")
        on_device = (graphs[0] + graphs[2]) * INT8_PER_FORWARD
        say("bci", f"greedy ({new_tokens} tokens) + diverse beam ({beams} groups) at 32 layers: "
            f"2 prefills, {graphs[0]} eager token steps, {graphs[1]} captures, {graphs[2]} "
            f"replays; int8 launches on the host {launches} = {INT8_PER_FORWARD} a model call x "
            f"(2 prefills | {graphs[0]} eager steps + {graphs[1]} captures); cluster kernel runs "
            f"on the device {on_device} = {INT8_PER_FORWARD} x ({graphs[0]} + {graphs[2]}) = "
            f"{INT8_PER_FORWARD} x 2 x {new_tokens - 1}")

        # The graph's greedy ids against the un-graphed step function on the
        # card, fed the same tokens: the same argmax at every step.
        with torch.no_grad(), autocast():
            first, step, P = prefill_step(model, batch, new_tokens)
            eager = [first]
            for t in range(new_tokens - 1):
                step.key_mask[:, P + t] = 1
                step.embeds = model.llm.embed(tokens[:, t:t + 1])
                step.position.fill_(P + t)
                eager.append(torch.argmax(step.run_eager(), -1))
            eager = torch.stack(eager, 1)
        if not torch.equal(eager, tokens):
            raise AssertionError(f"greedy ids from the graph differ from the eager step's at "
                                 f"{int((eager != tokens).sum())} of {tokens.numel()} places")
        say("bci", f"greedy ids from the replayed graph equal the un-graphed step's on the card "
            f"({tokens.numel()} ids)")
        del step

        g_s, g_step_ms = decode_times(model, "int8 base, 32 layers")
        d_s = timed(lambda: diverse(model), reps=1)
        say("bci", f"int8 base, diverse beam ({beams} groups, M={BCI_B * beams}): "
            f"{BCI_B / d_s:.2f} sequences/s ({d_s * 1e3:.0f} ms for {BCI_B} x {beams} "
            f"hypotheses of {new_tokens} tokens, each decode capturing its own token step); "
            f"card {power_line}")
        del model
        torch.cuda.empty_cache()

        # The same greedy decode on a bf16 base, through the same graph.
        torch.cuda.reset_peak_memory_stats()
        model, build_s = build_bci(path32, None, dev)
        before = ic.LAUNCHES
        tokens_bf16 = greedy(model)
        check_ids(tokens_bf16, (BCI_B, new_tokens), "greedy (bf16 base)")
        if ic.LAUNCHES != before:
            raise AssertionError("the bf16 base launched the int8 kernel")
        b_s, b_step_ms = decode_times(model, f"bf16 base, 32 layers (built in {build_s:.1f} s)")
        say("bci", f"int8 / bf16 base greedy tokens/s = {b_s / g_s:.3f}, a replayed token step "
            f"{g_step_ms:.3f} / {b_step_ms:.3f} ms of wall time; card {power_line}")
        del model
        torch.cuda.empty_cache()
    return launches


def build_bci_trainer(tmp: str, steps: int):
    """The BCI LoRA fine-tune's trainer (``configs/trainer_bci.yaml``, 32
    layers at Llama-2-7B width, int8 base) on pre-tokenized synthetic trials:
    ``steps`` steps and an eval at the last."""
    from llm_bci_tpu_torch import main as port_main

    dataset = {"train": bci_rows(32, seed=1), "test": bci_rows(BCI_B, seed=2)}
    args = port_main.parse_args([
        "-c", os.path.join(REPO, "configs", "trainer_bci.yaml"),
        "-k", f"method.model_kwargs.llm_path={write_llama_config(tmp, 32)}",
        "method.model_kwargs.quantize=int8", f"training.train_batch_size={BCI_B}",
        f"training.test_batch_size={BCI_B}", f"training.max_steps={steps}",
        f"training.eval_every={steps}", "training.save_every=null",
        f"dirs.checkpoint_dir={os.path.join(tmp, 'ckpt')}", "dirs.log_dir=null",
        "verbosity=1",
    ])
    return port_main.build_trainer(args, dataset=dataset)


# The BCI fine-tune's trainer, kept by phase 9 for the chain phase (leg B)
# when both run: the 7B-width model is built once.
KEPT: dict = {}


def bci_train_phase(power_line: str, profile) -> dict:
    import torch
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    steps = 4
    losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        losses.append(float(outputs["loss"]) / float(outputs["n_examples"]))
        return losses[-1]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = build_bci_trainer(tmp, steps)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        model = trainer.model
        trainer.metric_fns["loss_per_token"] = record
        if dataclasses.asdict(model.llama_config) != LLAMA2_7B:
            raise AssertionError(f"not Llama-2-7B: {model.llama_config}")
        if model.quant != "int8" or model.lora_r != 8 or model.dtype != torch.bfloat16:
            raise AssertionError("not the int8 LoRA model of configs/trainer_bci.yaml")
        trains = {k for k, p in model.named_parameters() if p.requires_grad}
        stray = [k for k in trains if not (".lora_" in k or k.startswith(("ndt1_encoder.",
                                                                         "projector_")))]
        if stray or not any(".lora_" in k for k in trains):
            raise AssertionError(f"unexpected trainable leaves: {stray[:5]}")
        state = model.state_dict()
        frozen = {k: v.clone() for k, v in state.items() if k not in trains}
        moving = {k: v.clone() for k, v in state.items() if k in trains}
        n_train = sum(v.numel() for v in moving.values())
        say("bci", f"trainer built in {build_s:.1f} s: {n_train:,} trainable parameters in "
            f"{len(trains)} leaves, {len(frozen)} frozen leaves "
            f"({sum(v.numel() * v.element_size() for v in frozen.values()) / 2 ** 30:.2f} GiB)")

        ic.reset_counters()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = int8_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

    eval_batches = len(trainer.test_dataloader)
    want = {INT8_CLUSTER: 0, INT8_TILED: INT8_PER_FORWARD * (steps + eval_batches)}
    if launches != want or ic.LAUNCHES != sum(want.values()):
        raise AssertionError(f"int8 launches {launches}, want {want} (0 in the backward)")
    hist = trainer.eval_history
    if len(hist) != 1 or hist[0]["step"] != steps:
        raise AssertionError(f"expected one eval at step {steps}, got {hist}")
    h = hist[0]
    # the recorder ran on every train step and on every eval batch
    if len(losses) != steps + eval_batches or not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    losses = losses[:steps]
    if not (np.isfinite(h["train_avg_loss"]) and np.isfinite(h["test_avg_loss"])):
        raise AssertionError(f"eval losses not finite: {h}")
    # 4 steps inside the warm-up of lr 5e-5 cannot fit anything yet: the loss
    # must stay of the order of ln(32000) = 10.4 and not blow up
    if not (losses[-1] <= 1.25 * losses[0] and max(losses) < 2 * math.log(32000)):
        raise AssertionError(f"train loss per token rose: {losses}")
    state = model.state_dict()
    for key, before in frozen.items():
        if not torch.equal(state[key], before):
            raise AssertionError(f"frozen leaf changed: {key}")
    moved = sum(not torch.equal(state[key], before) for key, before in moving.items())
    if moved < 0.9 * len(moving):
        raise AssertionError(f"only {moved} of {len(moving)} trainable leaves changed")
    say("bci", f"{steps} steps + eval ({eval_batches} batch) through the Trainer in {wall:.1f} s "
        f"(metric_lag {trainer.metric_lag}: {trainer.readback.drains} readbacks of the train "
        f"steps' losses and metric inputs): "
        f"loss per token {[round(x, 4) for x in losses]}, test_avg_loss "
        f"{h['test_avg_loss']:.4f}; int8 launches {launches} = {INT8_PER_FORWARD} a forward, "
        f"none in the backward; {len(frozen)} frozen leaves bit-identical, {moved} of "
        f"{len(moving)} trainable leaves changed")
    del frozen, moving, state

    batch = trainer.to_device(next(iter(trainer.train_dataloader))[0])
    if tuple(batch["spikes"].shape) != (BCI_B, BCI_BINS, BCI_CHANNELS):
        raise AssertionError(f"unexpected batch shape {tuple(batch['spikes'].shape)}")
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    say("bci", f"LoRA fine-tune step (B={BCI_B} x {BCI_PROMPT} tokens, 32 layers, int8 base, "
        f"bf16 autocast): {step_s * 1e3:.2f} ms/step, {BCI_B / step_s:.2f} samples/s; peak "
        f"memory {max(peak, torch.cuda.max_memory_allocated() / 2 ** 30):.2f} GiB; "
        f"card {power_line}")
    device_profile(lambda: [trainer.train_step(batch) for _ in range(2)],
                   "2 fine-tune steps, int8 base, 32 layers", power_line, profile,
                   2 * step_s * 1e3)
    if "keep_bci" in KEPT:
        KEPT["bci"] = trainer
    del trainer, model
    torch.cuda.empty_cache()
    return launches


def drive_main(cfg_path: str, overrides: list, tmp: str) -> tuple:
    """4 training steps and one eval through ``llm_bci_tpu_torch.main``, with
    the CTC launch counters set to 0 just before and read just after. Checks
    one eval at step 4 with finite losses; returns (trainer, launches, wall
    seconds, peak bytes)."""
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.ops import ctc_cuda

    args = port_main.parse_args([
        "-c", cfg_path, "-k", *overrides, "training.max_steps=4", "training.eval_every=4",
        "training.save_every=null", f"dirs.checkpoint_dir={os.path.join(tmp, 'ckpt')}",
        "dirs.log_dir=null", "verbosity=1",
    ])
    torch.cuda.reset_peak_memory_stats()
    ctc_cuda.reset_counters()
    t0 = time.perf_counter()
    trainer = port_main.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ctc_alpha_kernel": ctc_cuda.FWD_LAUNCHES,
                "ctc_alpha_beta_kernel": ctc_cuda.FUSED_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.eval_history
    if len(hist) != 1 or hist[0]["step"] != 4:
        raise AssertionError(f"{cfg_path}: expected one eval at step 4, got {hist}")
    for key in ("train_avg_loss", "test_avg_loss"):
        if not np.isfinite(hist[0][key]):
            raise AssertionError(f"{cfg_path}: {key} is not finite: {hist[0][key]}")
    return trainer, launches, wall, peak


def steady_step_ms(trainer, reps: int = 20) -> tuple:
    """ms of a full train step on one fixed batch (3 warm-up steps first),
    and that batch."""
    import torch

    batch = trainer.to_device(next(iter(trainer.train_dataloader))[0])
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, batch


def add_launches(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def main_path_phase(power_line: str, profile) -> dict:
    import torch
    from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain
    from llm_bci_tpu_torch.models.ndt1 import stacked_lengths

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        write_mat_dataset(os.path.join(tmp, "mat"))
        say("main", f"synthetic speechbci files written in {time.perf_counter() - t0:.1f} s")
        trainer, launches, wall, peak = drive_main(
            os.path.join(REPO, "configs", "trainer_ctc_ndt1.yaml"),
            [f"data.data_dir={os.path.join(tmp, 'mat')}"], tmp)

    h = trainer.eval_history[0]
    cer = h["test_avg_metrics"].get("CER")
    if cer is None or not 0.0 <= cer <= 2.0:
        raise AssertionError(f"eval CER missing or out of range: {cer}")
    # a training step forms its gradient in the forward (the fused kernel);
    # the eval's forward needs none (the alpha kernel)
    if launches["ctc_alpha_beta_kernel"] < 4 or launches["ctc_alpha_kernel"] < 1:
        raise AssertionError(f"CTC kernels not on the main path: launches {launches}")
    say("main", f"4 steps + eval through llm_bci_tpu_torch.main in {wall:.1f} s "
        f"(data, G2P and model set-up included): train_avg_loss={h['train_avg_loss']:.4f} "
        f"test_avg_loss={h['test_avg_loss']:.4f} CER={cer:.4f} launches={launches}")

    # The model's loss on a test batch (through the kernel) agrees with the
    # plain CTC on the same log-probs.
    model_inputs, _ = next(iter(trainer.test_dataloader))
    batch = trainer.to_device(model_inputs)
    trainer.model.eval()
    with torch.no_grad(), trainer.autocast():
        out = trainer.model(**batch)
    stack = trainer.config.model.encoder.embedder.stack
    lens = stacked_lengths(batch["spikes_lengths"], stack.size, stack.stride, stack.active)
    plain = ctc_loss_plain(out.preds.double(), batch["targets"], lens,
                           batch["targets_lengths"]).sum().float()
    if tuple(out.preds.shape) != (batch["spikes"].shape[0], T, V):
        raise AssertionError(f"unexpected preds shape {tuple(out.preds.shape)}")
    torch.testing.assert_close(out.loss, plain, rtol=1e-5, atol=1e-3)
    say("main", f"eval batch loss through the kernel {out.loss.item():.4f} "
        f"== plain CTC {plain.item():.4f}")

    # Steady-state train step at full width on one fixed batch.
    step_ms, batch = steady_step_ms(trainer)
    step_s = step_ms / 1e3
    n = int(batch["spikes"].shape[0])
    say("main", f"full-width train step (B={n}, 5x1024, bf16 autocast): "
        f"{1.0 / step_s:.3f} steps/s, {n / step_s:.1f} samples/s, "
        f"{step_s * 1e3:.2f} ms/step; peak memory of the main run "
        f"{peak / 2**30:.3f} GiB; card {power_line}")
    if profile:
        profile_step(trainer, batch, power_line, profile, "ctc", "NDT1-CTC",
                     {"CTC kernels": ("ctc_",),
                      "convolutions": ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad")})
    return launches


def write_spike_pickle(path: str, n_train: int = 64, n_val: int = 32, bins=(896, 1024),
                       channels: int = 256, seed: int = 0, n_regions: int = 0,
                       data_config=None) -> str:
    """Synthetic Poisson spikes (rate 1.0) as ``{split: [{"spikes": (T, N)
    float32}]}``; the first trial of each split has the longest length. With
    ``n_regions`` each row also names the region of each channel (``R0`` ..,
    in turn), as an IBL session does. With a trainer config's ``data``
    section, each row also has the behaviours an IBL session gives it: a
    ``choice`` in {-1, 1} and a ``wheel-speed`` trace of T bins, normalised
    over all trials when ``norm_behaviours`` says so (``data/ibl.py``'s rule)."""
    import pickle

    rng = np.random.default_rng(seed)
    regions = [f"R{i % n_regions}" for i in range(channels)] if n_regions else None
    data = {}
    for split, n in (("train", n_train), ("val", n_val)):
        lengths = rng.integers(bins[0], bins[1] + 1, size=n)
        lengths[0] = bins[1]
        data[split] = [{"spikes": rng.poisson(1.0, size=(int(t), channels)).astype(np.float32),
                        **({"neuron_regions": list(regions)} if regions else {})}
                       for t in lengths]
    if data_config is not None:
        rows = [row for split in data.values() for row in split]
        for row in rows:
            spikes = row["spikes"]
            row["choice"] = np.atleast_1d(np.float32(rng.choice([-1.0, 1.0])))
            # a trace that the spikes carry: a few channels' smoothed rate
            row["wheel-speed"] = (np.convolve(spikes[:, :8].mean(1), np.ones(5) / 5, "same")
                                  + 0.1 * rng.normal(size=len(spikes))).astype(np.float32)
        if data_config.get("norm_behaviours"):
            for beh in data_config.get("dynamic_behaviours") or []:
                trials = np.stack([row[beh] for row in rows])
                mean, std = trials.mean(), trials.std()
                for row in rows:
                    row[beh] = (row[beh] - mean) / std
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


MLM_OVERRIDES = [
    "data.data_load=file", "training.train_batch_size=32", "training.test_batch_size=32",
    "model.encoder.masker.neuron.active=true", "model.encoder.masker.neuron.mode=random",
    "model.encoder.masker.neuron.ratio=0.3", "model.encoder.embedder.stack.active=false",
    "model.encoder.transformer.flash_attention=auto", "precision.compute_dtype=bfloat16",
]


def mlm_main_path_phase(power_line: str, profile) -> dict:
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    n_layers, steps = 5, 4
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        write_spike_pickle(os.path.join(tmp, "spikes.pkl"))
        say("mlm", f"synthetic spike pickle written in {time.perf_counter() - t0:.1f} s")
        args = port_main.parse_args([
            "-c", os.path.join(REPO, "configs", "trainer_ssl_ndt1.yaml"),
            "-k", *MLM_OVERRIDES, f"data.data_dir={tmp}", "data.data_file=spikes.pkl",
            f"training.max_steps={steps}", f"training.eval_every={steps}",
            "training.save_every=null", f"dirs.checkpoint_dir={os.path.join(tmp, 'ckpt')}",
            "dirs.log_dir=null", "verbosity=1",
        ])
        torch.cuda.reset_peak_memory_stats()
        fc.reset_counters()
        t0 = time.perf_counter()
        trainer = port_main.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {FWD_WG: fc.FWD_LAUNCHES, DQ_WG: fc.BWD_DQ_LAUNCHES,
                    DKV_WG: fc.BWD_DKV_LAUNCHES, "flash_delta_kernel": fc.BWD_DELTA_LAUNCHES}
        peak = torch.cuda.max_memory_allocated()

    tr = trainer.config.model.encoder.transformer
    if (tr.n_layers, tr.hidden_size, tr.n_heads) != (n_layers, 1024, 8):
        raise AssertionError(f"not the full-width model: {dict(tr)}")
    hist = trainer.eval_history
    if len(hist) != 1 or hist[0]["step"] != steps:
        raise AssertionError(f"expected one eval at step {steps}, got {hist}")
    h = hist[0]
    for key in ("train_avg_loss", "test_avg_loss"):
        if not np.isfinite(h[key]):
            raise AssertionError(f"{key} is not finite: {h[key]}")
    eval_batches = len(trainer.test_dataloader)
    want = {FWD_WG: n_layers * (steps + eval_batches), DQ_WG: n_layers * steps,
            DKV_WG: n_layers * steps, "flash_delta_kernel": n_layers * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want}")
    say("mlm", f"{steps} steps + eval ({eval_batches} batch) through llm_bci_tpu_torch.main in "
        f"{wall:.1f} s (data and model set-up included): train_avg_loss={h['train_avg_loss']:.4f} "
        f"test_avg_loss={h['test_avg_loss']:.4f} launches={launches}")

    # One training-mode forward: shapes, the masked share, finite values.
    batch = trainer.to_device(next(iter(trainer.train_dataloader))[0])
    n, T, N = batch["spikes"].shape
    if (n, T, N) != (32, 1024, 256):
        raise AssertionError(f"unexpected batch shape {(n, T, N)}")
    if int(batch["spikes_mask"][:, 0].sum()) == n:
        raise AssertionError("expected left padding in the batch")
    trainer.model.train()
    with torch.no_grad(), trainer.autocast():
        out = trainer.model(**batch, generator=trainer.generator)
    valid_bins = float(batch["spikes_mask"].sum()) * N
    share = float(out.n_examples) / valid_bins
    if tuple(out.preds.shape) != (n, T, N) or not torch.isfinite(out.preds).all():
        raise AssertionError("mlm preds have the wrong shape or are not finite")
    if not torch.isfinite(out.loss) or abs(share - 0.3) > 0.01:
        raise AssertionError(f"mlm loss {out.loss.item()} / masked share {share:.4f} (want 0.3)")
    say("mlm", f"training forward: loss/n_examples={out.loss.item() / float(out.n_examples):.4f}, "
        f"n_examples is {share:.4f} of the valid bins")

    # Steady-state train step at full width on one fixed batch.
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    say("mlm", f"full-width train step (B={n}, T={T}, 5x1024, 8 heads, bf16 autocast): "
        f"{step_s * 1e3:.2f} ms/step, {n / step_s:.1f} samples/s; peak memory of the main run "
        f"{peak / 2**30:.3f} GiB; card {power_line}")
    if profile:
        profile_step(trainer, batch, power_line, profile, "mlm", "NDT1-mlm",
                     {"flash attention kernels": ("flash_",)})
    return launches


# ---------------------------------------------------------------------------
# Co-smoothing, PhonemeLLM, eval_phonemes
# ---------------------------------------------------------------------------

# bench.py::bench_cosmooth's IBL shape: 256 channels in 4 regions, T=100 bins,
# 64 trials in test batches of 32
COSMOOTH_IBL = {"channels": 256, "regions": 4, "bins": 100, "trials": 64, "batch": 32}


def neuron_sweep(trainer, n_points: int, label: str, power_line: str, profile=None):
    """The neuron-mode sweep's held-out rates of the first ``n_points``
    channels, ``(n_points, trials, T)``, and its neurons/s; one chunk runs
    first as a warm-up. The scoring on the host is not timed. With
    ``profile``, a table of one chunk's kernels goes there."""
    import torch
    from llm_bci_tpu_torch.eval import co_smoothing as cs

    batches, region_list = cs.sweep_inputs(trainer)
    run = lambda points: np.concatenate([
        rates for _, rates in cs.run_sweep(trainer, batches, cs.SWEEP_MASKERS["neuron"],
                                           cs.mode_overrides("neuron", region_list), points,
                                           channel_for=lambda n: n)])
    run(list(range(cs.SWEEP_BATCH)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rates = run(list(range(n_points)))
    seconds = time.perf_counter() - t0
    if profile:
        chunk = list(range(cs.SWEEP_BATCH))
        device_profile(lambda: run(chunk), f"co-smoothing, one folded pass of "
                       f"{cs.SWEEP_BATCH} neurons, {label}", power_line, profile,
                       seconds * 1e3 * cs.SWEEP_BATCH / n_points, phase="cosmooth")
    return rates, n_points / seconds


def check_bps(res: dict, want: dict, label: str) -> None:
    for mode, n in want.items():
        bps = np.asarray(res[mode]["bps"], np.float64)
        if len(bps) != n or np.isinf(bps).any():
            raise AssertionError(f"{label} {mode}: {len(bps)} bits-per-spike (want {n}), "
                                 f"finite or NaN: {bps[:8]}")


def cosmooth_phase(power_line: str, profile=None) -> dict:
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.config import DictConfig, resolve_path, update_config
    from llm_bci_tpu_torch.eval import co_smoothing as cs
    from llm_bci_tpu_torch.eval.metrics import bits_per_spike
    from llm_bci_tpu_torch.models import ndt1
    from llm_bci_tpu_torch.ops import flash_attention as fa
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc
    from llm_bci_tpu_torch.training.trainer import Trainer

    # IBL shape, dense attention (T=100 < FLASH_AUTO_MIN_T): every neuron
    ibl = COSMOOTH_IBL
    C, Tb = ibl["channels"], ibl["bins"]
    rng = np.random.default_rng(0)
    rows = [{"spikes": rng.poisson(0.5, size=(Tb, C)).astype(np.float32),
             "neuron_regions": [f"R{i % ibl['regions']}" for i in range(C)]}
            for _ in range(ibl["trials"])]
    pad = {"dim": 0, "side": "right", "value": 0, "truncate": None, "min_length": None}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trainer = Trainer(DictConfig({
            "savestring": "cosmooth", "verbosity": 3, "seed": 0,
            "dirs": {"checkpoint_dir": tmp, "log_dir": None},
            "training": {"num_epochs": 1, "train_batch_size": ibl["batch"],
                         "test_batch_size": ibl["batch"], "save_on_preemption": False},
            "model": update_config(resolve_path("configs/ndt1.yaml"), {"encoder": {
                "masker": {"neuron": {"active": True, "mode": "co-smooth", "ratio": 1.0,
                                      "channels": [0]}},
                "embedder": {"n_channels": C, "max_F": Tb, "input_dim": 256,
                             "stack": {"active": False}}}}),
            "data": {"dataset_class": "base"},
            "method": {"model_kwargs": {"method_name": "mlm", "loss": "poisson_nll",
                                        "log_input": True},
                       "dataset_kwargs": {}, "metric_kwargs": {},
                       "dataloader_kwargs": {"pad_dict": {
                           k: dict(pad) for k in ("spikes", "spikes_mask", "spikes_timestamp")}}},
            "optimizer": {"lr": 1e-3, "scheduler": "cosine", "warmup_pct": 0.1},
            "precision": {"compute_dtype": "bfloat16"},
        }), dataset={"train": rows, "test": rows})
    tr = trainer.config.model.encoder.transformer
    if (tr.n_layers, tr.hidden_size) != (5, 1024) or trainer.model.encoder._use_flash_now(Tb):
        raise AssertionError("not the full-width NDT1 on the dense path")
    fc.reset_counters()
    t0 = time.perf_counter()
    res = cs.co_smoothing_eval(trainer, modes=["neuron"])
    wall = time.perf_counter() - t0
    if fc.FWD_LAUNCHES:
        raise AssertionError(f"{fc.FWD_LAUNCHES} flash launches at T={Tb} (the dense path)")
    check_bps(res, {"neuron": C}, "IBL shape")
    bps = np.asarray(res["neuron"]["bps"])
    _, rate = neuron_sweep(trainer, C, "IBL shape", power_line, profile)
    say("cosmooth", f"IBL shape (NDT1 5 x 1024, {C} channels in {ibl['regions']} regions, "
        f"T={Tb}, {ibl['trials']} trials, dense attention, bf16): co_smoothing_eval of all {C} "
        f"neurons in {wall:.2f} s with the scoring; the sweep alone {rate:.1f} neurons/s "
        f"({cs.SWEEP_BATCH} neurons a folded pass of {cs.SWEEP_BATCH * ibl['batch']} rows); "
        f"bps median {np.nanmedian(bps):.4f}, {int(np.isnan(bps).sum())} NaN; card {power_line}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # The mlm model of the mlm main path at T=1024 (B=32): the flash path
    max_N, n_regions = 16, 4
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        write_spike_pickle(os.path.join(tmp, "spikes.pkl"), n_train=8, n_regions=n_regions)
        trainer = port_main.build_trainer(port_main.parse_args([
            "-c", os.path.join(REPO, "configs", "trainer_ssl_ndt1.yaml"),
            "-k", *MLM_OVERRIDES, f"data.data_dir={tmp}", "data.data_file=spikes.pkl",
            "training.save_every=null", f"dirs.checkpoint_dir={os.path.join(tmp, 'ckpt')}",
            "dirs.log_dir=null", "verbosity=3",
        ]))
    batches, region_list = cs.sweep_inputs(trainer)
    n, T, N = batches[0]["spikes"].shape
    if (len(batches), n, T, N) != (1, 32, 1024, 256) or not trainer.model.encoder._use_flash_now(T):
        raise AssertionError(f"not the mlm shape on the flash path: {len(batches)} x {(n, T, N)}")
    fc.reset_counters()
    t0 = time.perf_counter()
    res = cs.co_smoothing_eval(trainer, max_N=max_N)
    wall = time.perf_counter() - t0
    launches = {FWD_WG: fc.FWD_LAUNCHES}
    passes = 2 * -(-max_N // cs.SWEEP_BATCH) + n_regions
    if launches[FWD_WG] != 5 * passes:
        raise AssertionError(f"{launches[FWD_WG]} flash forward launches, want 5 a folded pass "
                             f"x {passes} passes")
    check_bps(res, {"neuron": max_N, "intra-region": max_N, "inter-region": max_N}, "mlm")

    # Two neurons of a folded pass of 8 against a pass of each alone (K=1).
    # The folded pass's first flash call is recorded, to hold the kernel
    # against its plain version on those inputs below.
    seen, wrapped = [], ndt1.banded_flash_attention

    def record(q, k, v, key_valid, **kw):
        if not seen:
            seen.append((q.clone(), k.clone(), v.clone(), key_valid.clone(), dict(kw)))
        return wrapped(q, k, v, key_valid, **kw)

    ndt1.banded_flash_attention = record
    try:
        ((_, folded),) = cs.run_sweep(trainer, batches, cs.SWEEP_MASKERS["neuron"],
                                      cs.mode_overrides("neuron", region_list), list(range(8)),
                                      channel_for=lambda c: c)
    finally:
        ndt1.banded_flash_attention = wrapped
    spikes = batches[0]["spikes"]
    worst = [0.0, 0.0]
    for c in (0, 5):
        ((_, alone),) = cs.run_sweep(trainer, batches, cs.SWEEP_MASKERS["neuron"],
                                     cs.mode_overrides("neuron", region_list), [c],
                                     channel_for=lambda x: x, sweep_batch=1)
        err = float(np.abs(np.log(folded[c]) - np.log(alone[0])).max())
        d_bps = abs(bits_per_spike(folded[c][:, :, None], spikes[:, :, [c]])
                    - bits_per_spike(alone[0][:, :, None], spikes[:, :, [c]]))
        if not (err <= 2e-2 and d_bps <= 1e-3):
            raise AssertionError(f"neuron {c}: the folded pass differs from a pass alone: "
                                 f"log-rate max|err| {err}, bps {d_bps}")
        worst = [max(worst[0], err), max(worst[1], d_bps)]

    # The flash forward at the folded pass's own inputs (K x B rows, the
    # pickle's key padding, no dropout) against the plain version in float32,
    # 32 rows at a time (its (B, H, T, T) logits), at the bf16 out tolerance
    # of the flash phase.
    q, k, v, key_valid, kw = seen[0]
    if (tuple(q.shape) != (8 * n, T, 8, 128) or q.dtype != torch.bfloat16
            or kw["dropout_rate"] != 0.0 or not (key_valid == 0).any()):
        raise AssertionError(f"the folded pass's flash call: {tuple(q.shape)} {q.dtype} "
                             f"dropout {kw['dropout_rate']}, padded keys "
                             f"{int((key_valid == 0).sum())}")
    band = {b: kw[b] for b in ("context_forward", "context_backward")}
    got = fa.banded_flash_attention(q, k, v, key_valid, **band).float()
    ref = torch.cat([fa.banded_flash_attention_plain(
        q[i:i + n].float(), k[i:i + n].float(), v[i:i + n].float(), key_valid[i:i + n],
        **band) for i in range(0, len(q), n)])
    torch.cuda.synchronize()
    o_atol = FLASH_TOL["bfloat16"][0]
    flash_err = (got - ref).abs().max().item()
    torch.testing.assert_close(got, ref, atol=o_atol, rtol=0.0,
                               msg=lambda m: f"flash forward at the folded shape: {m}")
    say("cosmooth", f"{FWD_WG} at the folded pass's inputs (B={len(q)}, T={T}, H=8, D=128, "
        f"bf16, no dropout, {int((key_valid == 0).sum())} padded keys, band {band}) against "
        f"the plain version in float32: out max|err| {flash_err:.2e} (atol {o_atol})")
    del q, k, v, key_valid, got, ref, seen

    _, rate = neuron_sweep(trainer, max_N, "mlm shape", power_line, profile)
    say("cosmooth", f"mlm model (5 x 1024, 8 heads, D=128, B={n}, T={T}, bf16, flash): "
        f"co_smoothing_eval of {max_N} neurons in 3 modes ({passes} folded passes, "
        f"{launches[FWD_WG]} flash forward launches = 5 a pass) in {wall:.2f} s with the "
        f"scoring; neuron sweep {rate:.1f} neurons/s ({cs.SWEEP_BATCH * n} rows a pass); "
        f"folded against alone (neurons 0, 5): log-rate max|err| {worst[0]:.2e} "
        f"(atol 2e-2), bps {worst[1]:.2e} (1e-3); card {power_line}")
    del trainer, batches
    torch.cuda.empty_cache()
    return launches


PHONEME_FRAMES, PHONEME_VOCAB = (BCI_BINS - 32) // 4 + 1, 41     # 121 CTC frames x 41


def phoneme_batch(device, seed: int = 0) -> tuple:
    """B=8: CTC posteriors (softmax of seeded normals, 121 frames x 41) spliced
    into a 64-token prompt at 8; the loss on the last 48 text tokens."""
    import torch

    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(BCI_B, PHONEME_FRAMES, PHONEME_VOCAB))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = rng.integers(3, LLAMA2_7B["vocab_size"], size=(BCI_B, BCI_TEXT))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    batch = {"input_ids": t(ids), "attention_mask": t(np.ones_like(ids)),
             "input_split": t(np.full((BCI_B,), BCI_SPLIT)),
             "phoneme_probs": t(probs.astype(np.float32)),
             "phonemes_mask": t(np.ones((BCI_B, PHONEME_FRAMES), np.int64))}
    return batch, t(np.where(np.arange(BCI_TEXT) >= 16, ids, -100))


def phoneme_llm_phase(power_line: str) -> dict:
    import torch
    from llm_bci_tpu_torch.config import DictConfig
    from llm_bci_tpu_torch.models import decode_graph
    from llm_bci_tpu_torch.models.phoneme_llm import PhonemeLLM

    dev = torch.device("cuda")
    new_tokens, beams = 32, 5
    vocab = LLAMA2_7B["vocab_size"]
    autocast = lambda: torch.autocast("cuda", dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        torch.manual_seed(0)
        t0 = time.perf_counter()
        model = PhonemeLLM.from_config(DictConfig({}), llm_path=write_llama_config(tmp, 32),
                                       lora=dict(LORA), compute_dtype="bfloat16", device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    if dataclasses.asdict(model.llama_config) != LLAMA2_7B or model.dtype != torch.bfloat16:
        raise AssertionError(f"not a bf16 Llama-2-7B: {model.llama_config}")
    batch, targets = phoneme_batch(dev)
    trains = {k for k, p in model.named_parameters() if p.requires_grad}
    if not trains or any(".lora_" not in k and not k.startswith("coupler") for k in trains):
        raise AssertionError(f"unexpected trainable leaves: {sorted(trains)[:5]}")
    state = model.state_dict()
    frozen = {k: v.clone() for k, v in state.items() if k not in trains}
    moving = {k: v.clone() for k, v in state.items() if k.endswith("lora_B") or
              k.startswith("coupler")}

    # one forward with a loss, one step of LoRA + coupler
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=1e-4)
    model.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with autocast():
        out = model(**batch, targets=targets)
    out.loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    n_tokens = BCI_B * (BCI_TEXT - 16)
    if tuple(out.preds.shape) != (BCI_B, BCI_TEXT + PHONEME_FRAMES, vocab):
        raise AssertionError(f"logits shape {tuple(out.preds.shape)}")
    if not torch.isfinite(out.loss) or int(out.n_examples) != n_tokens:
        raise AssertionError(f"loss {out.loss.item()} over {int(out.n_examples)} tokens")
    state = model.state_dict()
    for key, before in frozen.items():
        if not torch.equal(state[key], before):
            raise AssertionError(f"frozen leaf changed: {key}")
    stuck = [k for k, before in moving.items() if torch.equal(state[k], before)]
    if stuck:
        raise AssertionError(f"{len(stuck)} LoRA B / coupler leaves did not move: {stuck[:3]}")
    say("phoneme", f"PhonemeLLM (32 layers x Llama-2-7B width, bf16 base, LoRA r=8 on 7 "
        f"projections, B={BCI_B}, {PHONEME_FRAMES} x {PHONEME_VOCAB} posteriors spliced into "
        f"{BCI_TEXT} tokens) built in {build_s:.1f} s; a forward with the loss and one "
        f"LoRA + coupler step {step_s * 1e3:.1f} ms (the first): loss/token "
        f"{out.loss.item() / n_tokens:.4f}; {len(frozen)} frozen leaves bit-identical, "
        f"{len(moving)} LoRA B and coupler leaves moved")
    del frozen, moving, state, opt, out

    model.eval()

    def greedy():
        with autocast():
            return model.generate(**batch, max_new_tokens=new_tokens, eos_token_id=-1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    decode_graph.reset_counters()
    tokens = greedy()
    again, g_s = timed(greedy)
    with autocast():
        result, b_s = timed(lambda: model.generate(
            **batch, max_new_tokens=new_tokens, num_beams=beams, num_return_sequences=beams,
            eos_token_id=2))
    graphs = (decode_graph.EAGER_STEPS, decode_graph.CAPTURES, decode_graph.REPLAYS)
    if graphs != (3, 3, 3 * (new_tokens - 2)):
        raise AssertionError(f"eager steps, captures, replays {graphs}")
    if tuple(tokens.shape) != (BCI_B, new_tokens) or not torch.equal(tokens, again):
        raise AssertionError("greedy ids have the wrong shape or differ between two decodes")
    if (tuple(result.sequences.shape) != (BCI_B, beams, new_tokens)
            or not torch.isfinite(result.scores).all()
            or (result.scores[:, :-1] < result.scores[:, 1:]).any()):
        raise AssertionError("beam hypotheses have the wrong shape, or are not finite and sorted")
    for ids in (tokens, result.sequences):
        if int(ids.min()) < 0 or int(ids.max()) >= vocab:
            raise AssertionError("token ids out of range")
    # the graph's greedy ids against the un-graphed step, fed the same tokens
    with torch.no_grad(), autocast():
        first, step, P = prefill_step(model, batch, new_tokens)
        eager = [first]
        for t in range(new_tokens - 1):
            step.key_mask[:, P + t] = 1
            step.embeds = model.llm.embed(tokens[:, t:t + 1])
            step.position.fill_(P + t)
            eager.append(torch.argmax(step.run_eager(), -1))
        eager = torch.stack(eager, 1)
    if not torch.equal(eager, tokens):
        raise AssertionError(f"greedy ids from the graph differ from the eager step's at "
                             f"{int((eager != tokens).sum())} of {tokens.numel()} places")
    say("phoneme", f"greedy {BCI_B * new_tokens / g_s:.1f} tokens/s ({g_s * 1e3:.1f} ms for "
        f"{new_tokens} tokens of B={BCI_B}, its capture included), beam {beams} "
        f"{BCI_B / b_s:.2f} sequences/s ({b_s * 1e3:.0f} ms); the graph's greedy ids equal the "
        f"un-graphed step's ({tokens.numel()} ids); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; card {power_line}")
    del model, step
    torch.cuda.empty_cache()
    return {}


def quantization_repair_check(tmp: str, power_line: str) -> None:
    """``BCI.load_checkpoint_params`` puts a saved LLM blob into the model's
    quantization layout, on the card, 2 layers deep at Llama-2-7B width: a
    bf16 checkpoint (the whole base) served int8, and that int8 checkpoint
    served on a bf16 base again. Every int8 leaf must equal ``quantize_int8``
    (axis 0, the JAX package's rule) of the saved weight; the int8 model's
    prompt logits, through the int8 kernels, must agree with those of the bf16
    model that holds the dequantized codes within the tolerance of the
    kernel's own check in the bci-serve phase (2^-5 and 2^-8 of the largest
    logit, max and mean)."""
    import torch
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic
    from llm_bci_tpu_torch.ops import quant

    dev = torch.device("cuda")
    batch = bci_serving_batch(dev)
    path = write_llama_config(tmp, 2)

    def logits(model):
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            embeds, mask, _ = model.prepare_embeds(**batch)
            return model.llm(inputs_embeds=embeds, attention_mask=mask)[0].float()

    def saved(model, name):
        os.makedirs(os.path.join(tmp, name))
        model.save_checkpoint(os.path.join(tmp, name))
        return os.path.join(tmp, name)

    t0 = time.perf_counter()
    trained, _ = build_bci(path, None, dev)
    ck_bf16, bf16_logits = saved(trained, "repair_bf16"), logits(trained)
    del trained
    served, _ = build_bci(path, "int8", dev)          # its own codes, replaced below
    served.load_checkpoint_params(ck_bf16)
    blob = torch.load(os.path.join(ck_bf16, "llm.pt"), map_location="cpu", weights_only=True)
    state, n = served.llm.state_dict(), 0
    for key, w in blob.items():
        prefix = key[:-len(".weight")]
        if key.endswith(".weight") and prefix + ".kernel" in state:
            q, scale = quant.quantize_int8(w.float().numpy().T, axis=0)
            if not (np.array_equal(state[prefix + ".kernel"].cpu().numpy(), q)
                    and np.array_equal(state[prefix + ".kernel_scale"].cpu().numpy(), scale)):
                raise AssertionError(f"{prefix}: the int8 leaves are not quantize_int8 of the "
                                     f"saved weight")
            n += 1
    if n != 7 * 2 + 1:
        raise AssertionError(f"{n} layers quantized from the bf16 checkpoint, want 15")
    del blob, state
    before = ic.LAUNCHES
    int8_logits = logits(served)
    if ic.LAUNCHES == before:
        raise AssertionError("the int8 model launched no int8 kernel")
    ck_int8 = saved(served, "repair_int8")
    del served
    back, _ = build_bci(path, None, dev)
    back.load_checkpoint_params(ck_int8)
    if any(k.endswith((".kernel", ".kernel_scale")) for k in back.llm.state_dict()):
        raise AssertionError("the bf16 model holds int8 leaves")
    ref = logits(back)
    del back
    seconds = time.perf_counter() - t0
    top = ref.abs().max().item()
    err = (int8_logits - ref).abs()
    if not (err.max().item() <= 2.0 ** -5 * top and err.mean().item() <= 2.0 ** -8 * top):
        raise AssertionError(f"int8 logits against the dequantized bf16 model: max|err| "
                             f"{err.max().item()} mean|err| {err.mean().item()} of {top}")
    q_err = (int8_logits - bf16_logits).abs()
    say("eval-ph", f"quantization-layout repair, 2 layers at 7B width: a bf16 checkpoint "
        f"served int8 ({n} layers quantized, each equal to quantize_int8 of the saved "
        f"weight), saved and served on a bf16 base again: int8 logits against the "
        f"dequantized bf16 model max|err| {err.max().item():.3e}, mean|err| "
        f"{err.mean().item():.3e} of max {top:.3e} (held to 2^-5 and 2^-8 of it); against "
        f"the trained bf16 model (the quantization's own error, not held) max|err| "
        f"{q_err.max().item():.3e}, mean|err| {q_err.mean().item():.3e}; {seconds:.1f} s "
        f"with two saves and loads; card {power_line}")
    del int8_logits, bf16_logits, ref, err, q_err
    gc.collect()
    torch.cuda.empty_cache()


def eval_phonemes_phase(power_line: str) -> dict:
    import pickle

    import torch
    from llm_bci_tpu_torch import eval_phonemes as tep
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.models import decode_graph
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    trials, beam_sizes, new_tokens = 4, (1, 5), 20
    test = bci_rows(trials, seed=3)
    for i, row in enumerate(test):
        row["sentence"] = SENTENCES[i]
    dataset = {"train": bci_rows(BCI_B, seed=1), "test": test}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        quantization_repair_check(tmp, power_line)
        # One step on a bf16 base, saved without the frozen base (a 7B base
        # is gigabytes a save). The eval builds its int8 base from the same
        # seed, but an int8 layer draws its codes directly: it serves fresh
        # int8 codes with the trained LoRA factors, encoder and projector.
        # The repair of a saved base is held above, 2 layers deep.
        t0 = time.perf_counter()
        trainer = port_main.main(port_main.parse_args([
            "-c", os.path.join(REPO, "configs", "trainer_bci.yaml"),
            "-k", f"method.model_kwargs.llm_path={write_llama_config(tmp, 32)}",
            f"training.train_batch_size={BCI_B}", f"training.test_batch_size={BCI_B}",
            "training.max_steps=1", "training.eval_every=null", "training.save_every=1",
            "training.component_blobs=false", f"dirs.checkpoint_dir={os.path.join(tmp, 'ck')}",
            "dirs.log_dir=null", "verbosity=1",
        ]), dataset=dataset)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        if trainer.model.quant is not None or trainer.model.dtype != torch.bfloat16:
            raise AssertionError("not a bf16 base")
        ckpt = os.path.join(trainer.checkpoint_dir, "STEP1")
        saved = torch.load(os.path.join(ckpt, "llm.pt"), map_location="cpu", weights_only=True)
        if not saved or any(".lora_" not in k for k in saved):
            raise AssertionError("llm.pt holds more than the LoRA factors")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # the shapes of every int8 product are recorded on the way, to show
        # that the int8 phase held each kernel against its plain version there
        save, shapes, wrapped = os.path.join(tmp, "wer"), set(), ic.int8_matmul_cuda

        def record(x, q, scale, out_dtype):
            shapes.add((x.shape[0], *q.shape, x.dtype, out_dtype))
            return wrapped(x, q, scale, out_dtype)

        ic.int8_matmul_cuda = record
        ic.reset_counters()
        decode_graph.reset_counters()
        try:
            metrics = tep.main(tep.parse_args([
                "-k", f"from_pt={ckpt}", f"beams={','.join(map(str, beam_sizes))}",
                f"savestring={save}", f"test_len={trials}", "quantize=int8",
            ]), dataset=dataset, tokenizer=WordTokenizer())
        finally:
            ic.int8_matmul_cuda = wrapped
        torch.cuda.synchronize()
        launches = int8_launches()
        graphs = (decode_graph.EAGER_STEPS, decode_graph.CAPTURES, decode_graph.REPLAYS)
        for k in beam_sizes:
            with open(f"{save}_{k}.pkl", "rb") as f:
                preds = pickle.load(f)
            if len(preds) != trials or any(t.shape != (k, new_tokens) for t, _ in preds):
                raise AssertionError(f"{save}_{k}.pkl: {[t.shape for t, _ in preds]}")
    # a trial: the eval's forward (M = 185) and a decode: its prefill (M = 137,
    # 5 x 137 with beams), its eager first token step and the capture of the
    # step (M = 1 or 5), then the replays
    decodes = trials * len(beam_sizes)
    if graphs != (decodes, decodes, decodes * (new_tokens - 2)):
        raise AssertionError(f"eager steps, captures, replays {graphs}")
    want = {INT8_TILED: INT8_PER_FORWARD * 2 * decodes, INT8_CLUSTER: INT8_PER_FORWARD * 2 * decodes}
    if launches != want or ic.LAUNCHES != sum(want.values()):
        raise AssertionError(f"int8 launches {launches} (total {ic.LAUNCHES}), want {want}")
    unchecked = sorted((M, K, N) for M, K, N, dt, out in shapes
                       if M not in INT8_MS or (K, N) not in INT8_SHAPES
                       or dt != torch.bfloat16 or out != torch.bfloat16)
    if unchecked:
        raise AssertionError(f"int8 products at shapes the int8 phase does not check: {unchecked}")
    say("eval-ph", f"int8 products at M = {sorted({sh[0] for sh in shapes})} on the "
        f"Llama-2-7B (K, N), bf16: each held against the plain version by the int8 phase")
    if sorted(metrics) != list(beam_sizes) or not all(np.isfinite(m["WER"])
                                                      for m in metrics.values()):
        raise AssertionError(f"WER {metrics}")
    per_trial = ", ".join(f"beams={k}: {metrics[k]['seconds'] / trials:.3f} s/trial, WER "
                          f"{metrics[k]['WER']:.3f}" for k in beam_sizes)
    say("eval-ph", f"BCI at 32 layers x Llama-2-7B width trained 1 step on a bf16 base "
        f"({train_s:.1f} s with the build), saved without its base, served int8 by "
        f"llm_bci_tpu_torch.eval_phonemes on {trials} trials ({new_tokens} new tokens, diverse "
        f"beam): {per_trial}; int8 launches {launches} = {INT8_PER_FORWARD} x {2 * decodes} "
        f"(forwards + prefills | eager steps + captures), {graphs[2]} replays; card {power_line}")
    return launches


# ---------------------------------------------------------------------------
# iTransformer and PatchTST (ROADMAP slice 7)
# ---------------------------------------------------------------------------

CTC_KERNELS = ("ctc_alpha_kernel", "ctc_alpha_beta_kernel")
# the IBL behaviour session: COSMOOTH_IBL's 256 neurons in 4 regions and
# T=100 bins, its 64 trials split 48 / 16
IBL_SPLIT = (48, 16)
PATCHTST_CTC_BATCH = 64


def trainer_yaml(tmp: str, base: str, model: str) -> str:
    """``configs/<base>`` with ``model: include:configs/<model>``, written to
    ``tmp``."""
    import yaml

    with open(os.path.join(REPO, "configs", base)) as f:
        cfg = yaml.safe_load(f)
    cfg["model"] = f"include:configs/{model}"
    path = os.path.join(tmp, f"{os.path.splitext(base)[0]}_{model}")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def report_run(phase: str, label: str, trainer, launches: dict, wall: float, peak: int,
               power_line: str) -> tuple:
    """Prints a run's wall time, the steady train step, steps/s, peak memory
    and the CTC launches; returns (ms a step, the batch it was timed on)."""
    ms, batch = steady_step_ms(trainer)
    n = int(batch["spikes"].shape[0])
    h = trainer.eval_history[0]
    say(phase, f"{label}: 4 steps + eval through llm_bci_tpu_torch.main in {wall:.1f} s (data "
        f"and model set-up included): train_avg_loss={h['train_avg_loss']:.4f} test_avg_loss="
        f"{h['test_avg_loss']:.4f} {h['test_avg_metrics']}; steady train step (B={n}) "
        f"{ms:.2f} ms, {1e3 / ms:.2f} steps/s, {n * 1e3 / ms:.1f} samples/s; peak memory of "
        f"the run {peak / 2**30:.3f} GiB; CTC launches {launches}; card {power_line}")
    return ms, batch


def ctc_head_check(phase: str, label: str, trainer, lens_of, lattice: str,
                   power_line: str) -> dict:
    """The model's own float32 log-probs on a test batch (eval, autocast as
    trained) through the CTC kernels against the plain version in float64
    (``ctc_check``), then the pair's device time (CUDA graphs), ``F.ctc_loss``
    (eager) and the bound at those inputs."""
    import torch

    batch = trainer.to_device(next(iter(trainer.test_dataloader))[0])
    trainer.model.eval()
    with torch.no_grad(), trainer.autocast():
        out = trainer.model(**batch)
    lp = out.preds
    if lp.dtype != torch.float32:
        raise AssertionError(f"{label}: log-probs in {lp.dtype}, not float32")
    il = lens_of(batch).int()
    targets, tl = batch["targets"].int(), batch["targets_lengths"].int()
    res = ctc_check(label, lp, targets, il, tl, True, lattice)
    t = {**ctc_times(lp, targets, il, tl), **ctc_eager_times(lp, targets, il, tl, False)}
    fwd_bound, fused_bound = ctc_bounds(lp, targets, il, tl)
    say(phase, f"{label} CTC at (B, T', V, S) = {tuple(lp.shape)} + ({targets.shape[1]},), "
        f"{res['feasible']} of {lp.shape[0]} rows feasible, lattice in {lattice}: device time "
        f"(CUDA graphs of 20) ctc_alpha_kernel {t['fwd_ms']:.4f} ms (bound "
        f"{fwd_bound['bound_ms']:.5f}, {fwd_bound['bound_by']}), ctc_alpha_beta_kernel "
        f"{t['fused_ms']:.4f} ms, the pair with the backward's multiply {t['pair_ms']:.4f} ms "
        f"(bound {fused_bound['bound_ms']:.5f}, {fused_bound['bound_by']}); eager forward "
        f"{t['fwd_eager_ms']:.4f} ms, pair {t['pair_eager_ms']:.4f} ms; F.ctc_loss (eager) "
        f"forward {t['lib_fwd_ms']:.4f} ms, forward + backward {t['lib_pair_ms']:.4f} ms; "
        f"card {power_line}")
    return res


def check_ctc_run(label: str, trainer, launches: dict, frames: int) -> None:
    """A CTC run: the fused kernel once a training step, the forward-only
    kernel once an eval batch, a CER in [0, max(2, frames / the shortest
    test target)]: an edit distance is at most the longer string, and the
    greedy decode of ``frames`` frames has at most ``frames`` labels (an
    untrained head over 512 frames decodes far more labels than a target
    has)."""
    want = {"ctc_alpha_beta_kernel": 4, "ctc_alpha_kernel": len(trainer.test_dataloader)}
    if launches != want:
        raise AssertionError(f"{label}: CTC launches {launches}, want {want}")
    data = trainer.test_dataset
    shortest = min(len(row[data.targets_name]) for row in data.dataset)
    cer = trainer.eval_history[0]["test_avg_metrics"].get("CER")
    if cer is None or not 0.0 <= cer <= max(2.0, frames / shortest):
        raise AssertionError(f"{label}: eval CER missing or out of range: {cer} (at most "
                             f"max(2, {frames} frames / {shortest} labels))")


def itransformer_phase(power_line: str, profile=None) -> dict:
    """iTransformer at ``configs/itransformer.yaml``'s widths: the three IBL
    configs (mlm, choice, wheel speed) with behaviour decoding, then the
    ``ctc`` head at the speechbci shape (T' = 512: the global-scratch plan)."""
    import torch
    from llm_bci_tpu_torch.config import update_config
    from llm_bci_tpu_torch.eval.behaviour_decoding import behaviour_decoding_eval

    ibl = COSMOOTH_IBL
    total = dict.fromkeys(CTC_KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name in ("ssl", "choice", "wheel"):
            cfg_path = os.path.join(REPO, "configs", f"trainer_{name}_itransformer.yaml")
            write_spike_pickle(os.path.join(tmp, f"{name}.pkl"), *IBL_SPLIT,
                               bins=(ibl["bins"], ibl["bins"]), channels=ibl["channels"],
                               n_regions=ibl["regions"],
                               data_config=update_config(cfg_path, None).data)
            trainer, launches, wall, peak = drive_main(cfg_path, [
                "data.data_load=file", f"data.data_dir={tmp}", f"data.data_file={name}.pkl"],
                tmp)
            add_launches(total, launches)
            enc = trainer.model.config["encoder"]
            width = (enc["hidden_size"], enc["n_layers"], enc["n_heads"], enc["max_n_channels"],
                     enc["embedder"]["mode"], enc["embedder"]["max_n_bins"], len(enc["regions"]))
            if width != (768, 5, 8, 1500, "mlp", ibl["bins"], ibl["regions"]):
                raise AssertionError(f"{name}: not the config's widths, or max_n_bins / regions "
                                     f"not pinned: {width}")
            if any(launches.values()):
                raise AssertionError(f"{name}: CTC launches without a CTC head: {launches}")
            report_run("itransformer", f"{name} (trainer_{name}_itransformer.yaml, B=16, "
                       f"{ibl['channels']} neurons, T={ibl['bins']})", trainer, launches, wall,
                       peak, power_line)
            if name == "choice":
                acc = trainer.eval_history[0]["test_avg_metrics"]["accuracy"]
                dec = behaviour_decoding_eval(trainer, is_cls=True)
                if trainer.model.n_labels != 2 or not (0 <= acc <= 1 and 0 <= dec["acc"] <= 1):
                    raise AssertionError(f"choice: n_labels {trainer.model.n_labels}, accuracy "
                                         f"{acc}, behaviour decoding {dec}")
                say("itransformer", f"choice: eval accuracy {acc:.4f}; behaviour_decoding_eval "
                    f"{dec}")
            elif name == "wheel":
                dec = behaviour_decoding_eval(trainer, is_cls=False,
                                              regression_metrics=["r2", "mse"])
                if not np.isfinite(list(dec.values())).all():
                    raise AssertionError(f"wheel: behaviour decoding {dec}")
                say("itransformer", f"wheel: behaviour_decoding_eval {dec}")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()

        mat = write_mat_dataset(os.path.join(tmp, "mat"))
        cfg_path = trainer_yaml(tmp, "trainer_ctc_ndt1.yaml", "itransformer.yaml")
        # speechbci trials carry no brain regions
        trainer, launches, wall, peak = drive_main(
            cfg_path, [f"data.data_dir={mat}", "model.encoder.embed_region=false"], tmp)
    add_launches(total, launches)
    enc = trainer.model.config["encoder"]
    if (enc["hidden_size"], enc["n_layers"], enc["embedder"]["max_n_bins"]) != (768, 5, 512):
        raise AssertionError(f"ctc: widths or max_n_bins {enc}")
    check_ctc_run("iTransformer ctc", trainer, launches, enc["embedder"]["max_n_bins"])
    _, batch = report_run("itransformer", "ctc (trainer_ctc_ndt1.yaml with itransformer.yaml, "
                          "B=64, 480-512 bins x 256 inputs)", trainer, launches, wall, peak,
                          power_line)
    ctc_head_check("itransformer", "iTransformer ctc head", trainer,
                   lambda b: b["spikes_lengths"], "global", power_line)
    if profile:
        profile_step(trainer, batch, power_line, profile, "itransformer", "iTransformer-CTC",
                     {"CTC kernels": ("ctc_",)})
    del trainer
    return total


def running_stats(model) -> dict:
    return {n: b.clone() for n, b in model.named_buffers() if n.endswith(("_mean", "_var"))}


def check_running_stats(label: str, trainer) -> None:
    """BatchNorm's running averages are finite and moved from their start (0,
    1) by training, and an eval leaves them."""
    import torch

    stats = running_stats(trainer.model)
    if len(stats) != 2 * 2 * trainer.config.model.encoder.num_hidden_layers:
        raise AssertionError(f"{label}: running statistics {sorted(stats)}")
    for n, v in stats.items():
        start = torch.zeros_like(v) if n.endswith("_mean") else torch.ones_like(v)
        if not torch.isfinite(v).all() or torch.equal(v, start):
            raise AssertionError(f"{label}: {n} not finite or not moved by training")
    trainer.evaluate()
    if any(not torch.equal(v, stats[n]) for n, v in running_stats(trainer.model).items()):
        raise AssertionError(f"{label}: an eval moved the running statistics")


def patchtst_phase(power_line: str, profile=None) -> dict:
    """PatchTST at ``configs/patchtst.yaml``'s widths: ``mlm`` at the IBL shape
    (context 100, 10 patches) and ``ctc`` at the speechbci shape (context 520,
    52 patches: the shared-memory plan)."""
    import torch

    ibl = COSMOOTH_IBL
    total = dict.fromkeys(CTC_KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        write_spike_pickle(os.path.join(tmp, "ibl.pkl"), *IBL_SPLIT,
                           bins=(ibl["bins"], ibl["bins"]), channels=ibl["channels"],
                           n_regions=ibl["regions"])
        cfg_path = trainer_yaml(tmp, "trainer_ssl_itransformer.yaml", "patchtst.yaml")
        trainer, launches, wall, peak = drive_main(cfg_path, [
            "data.data_load=file", f"data.data_dir={tmp}", "data.data_file=ibl.pkl"], tmp)
        add_launches(total, launches)
        enc = trainer.model.config["encoder"]
        width = (enc["d_model"], enc["num_hidden_layers"], enc["num_attention_heads"],
                 enc["ffn_dim"], enc["norm_type"], enc["num_input_channels"],
                 enc["context_length"])
        if width != (256, 4, 8, 1024, "batchnorm", ibl["channels"], ibl["bins"]):
            raise AssertionError(f"mlm: not the config's widths or the pinned context: {width}")
        if any(launches.values()):
            raise AssertionError(f"mlm: CTC launches without a CTC head: {launches}")
        check_running_stats("PatchTST mlm", trainer)
        report_run("patchtst", f"mlm (trainer_ssl_itransformer.yaml with patchtst.yaml, B=16, "
                   f"{ibl['channels']} channels, T={ibl['bins']}, 10 patches)", trainer,
                   launches, wall, peak, power_line)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        mat = write_mat_dataset(os.path.join(tmp, "mat"))
        cfg_path = trainer_yaml(tmp, "trainer_ctc_ndt1.yaml", "patchtst.yaml")
        trainer, launches, wall, peak = drive_main(cfg_path, [
            f"data.data_dir={mat}", f"training.train_batch_size={PATCHTST_CTC_BATCH}",
            f"training.test_batch_size={PATCHTST_CTC_BATCH}"], tmp)
    add_launches(total, launches)
    enc = trainer.model.config["encoder"]
    if (enc["d_model"], enc["num_hidden_layers"], enc["context_length"]) != (256, 4, 520):
        raise AssertionError(f"ctc: widths or context {enc}")
    pl, ps = enc["patch_length"], enc["patch_stride"]
    check_ctc_run("PatchTST ctc", trainer, launches, 1 + (enc["context_length"] - pl) // ps)
    check_running_stats("PatchTST ctc", trainer)
    _, batch = report_run("patchtst", f"ctc (trainer_ctc_ndt1.yaml with patchtst.yaml, "
                          f"B={PATCHTST_CTC_BATCH}: {PATCHTST_CTC_BATCH * 256} sequences of 52 "
                          f"patches)", trainer, launches, wall, peak, power_line)
    ctc_head_check("patchtst", "PatchTST ctc head", trainer,
                   lambda b: torch.div(b["spikes_lengths"] - pl, ps, rounding_mode="floor") + 1,
                   "shared", power_line)
    if profile:
        profile_step(trainer, batch, power_line, profile, "patchtst", "PatchTST-CTC",
                     {"CTC kernels": ("ctc_",), "BatchNorm": ("batch_norm", "welford")})
    del trainer
    return total


# ---------------------------------------------------------------------------
# The trainer contract: resume, gradient clipping, remat, profiling, entry()
# ---------------------------------------------------------------------------

RESUME_STEPS = 6       # the flagship legs: 2 steps an epoch, saved at step 3


class IndexSpy:
    """A train dataset that records the indices each batch reads."""

    def __init__(self, dataset):
        self.dataset, self.batch = dataset, []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        self.batch.append(int(i))
        return self.dataset[i]

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def take(self) -> list:
        batch, self.batch = self.batch, []
        return batch


class spied_trainer:
    """Within the block every ``Trainer`` records, a training step each
    (single or chained), its global step, the indices of its batch and its
    loss in ``log``; ``stop_at`` asks for preemption after that (single)
    step."""

    def __init__(self, log: list, stop_at=None):
        self.log, self.stop_at = log, stop_at
        self.trainers: list = []          # every Trainer built within the block

    def __enter__(self):
        from llm_bci_tpu_torch.training.trainer import Trainer

        self.saved = Trainer.build_dataloaders, Trainer.train_step, Trainer.chain
        build, step, chain = self.saved
        log, stop_at, trainers = self.log, self.stop_at, self.trainers

        def spy_build(trainer):
            build(trainer)
            trainer.train_dataloader.dataset = IndexSpy(trainer.train_dataloader.dataset)
            trainers.append(trainer)

        def record(trainer, out):
            preds = out.get("preds")
            log.append({"step": trainer.n_micro, "indices": trainer.train_dataloader.dataset.take(),
                        "loss": float(out["loss"]),
                        "preds_shape": list(preds.shape) if hasattr(preds, "shape") else None})

        def spy_step(trainer, batch):
            out = step(trainer, batch)
            record(trainer, out)
            if trainer.n_micro == stop_at:
                trainer.request_preemption()
            return out

        def spy_chain(trainer, items):
            # a chain reads its K batches first: the first step holds their
            # indices
            for out in chain(trainer, items):
                record(trainer, out)
                yield out

        Trainer.build_dataloaders, Trainer.train_step, Trainer.chain = (spy_build, spy_step,
                                                                        spy_chain)
        return self

    def __exit__(self, *exc):
        from llm_bci_tpu_torch.training.trainer import Trainer

        Trainer.build_dataloaders, Trainer.train_step, Trainer.chain = self.saved
        return False


def spied_cli(argv: list) -> None:
    """``python -m llm_bci_tpu_torch.main <argv[1:]>`` in this process, its
    training steps recorded (``spied_trainer``) into the JSON file
    ``argv[0]`` with the CTC kernels' launches; cuDNN picks deterministic
    algorithms, as in the legs it is compared with."""
    import runpy

    import torch
    from llm_bci_tpu_torch.ops import ctc_cuda

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out, sys.argv = argv[0], ["llm_bci_tpu_torch.main", *argv[1:]]
    log: list = []
    ctc_cuda.reset_counters()
    with spied_trainer(log):
        runpy.run_module("llm_bci_tpu_torch.main", run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump({"steps": log, "launches": {"ctc_alpha_kernel": ctc_cuda.FWD_LAUNCHES,
                                              "ctc_alpha_beta_kernel": ctc_cuda.FUSED_LAUNCHES}}, f)


def flagship_args(mat: str, ckpt: str, *extra) -> list:
    return ["-c", os.path.join(REPO, "configs", "trainer_ctc_ndt1.yaml"),
            "-k", f"data.data_dir={mat}", f"dirs.checkpoint_dir={ckpt}", "dirs.log_dir=null",
            "verbosity=1", f"training.max_steps={RESUME_STEPS}", "training.eval_every=null",
            "training.save_every=null", *extra]


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def max_abs_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def flagship_resume(tmp: str, power_line: str) -> tuple:
    """Legs A (6 steps, steps 2-3 profiled), B (the same run preempted after
    step 3) and C (a fresh ``python -m llm_bci_tpu_torch.main -k
    training.resume=true`` to step 6), then the save and restore of the full
    train state timed. Returns (fused CTC launches of the three legs, the
    trace's fused launches)."""
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.training import checkpoint

    mat = write_mat_dataset(os.path.join(tmp, "mat128"), n_train=128, n_test=4)
    prof_dir = os.path.join(tmp, "profile")
    legs = {}
    launches = {}
    for leg, stop_at, extra in (
            ("A", None, [f"profile.start_step=2", "profile.num_steps=2",
                         f"profile.dir={prof_dir}"]),
            ("B", 3, [])):
        log: list = []
        ctc_cuda.reset_counters()
        with spied_trainer(log, stop_at):
            trainer = port_main.main(port_main.parse_args(
                flagship_args(mat, os.path.join(tmp, leg), *extra)))
        torch.cuda.synchronize()
        launches[leg] = ctc_cuda.FUSED_LAUNCHES
        legs[leg] = (trainer, log)
    (ta, log_a), (tb, log_b) = legs["A"], legs["B"]
    tr = ta.config.model.encoder.transformer
    if (tr.n_layers, tr.hidden_size, ta.train_dataloader.batch_size,
            len(ta.train_dataloader)) != (5, 1024, 64, 2):
        raise AssertionError("not the flagship at full width with 2 steps an epoch")
    if [e["step"] for e in log_a] != list(range(1, 7)) or [e["step"] for e in log_b] != [1, 2, 3]:
        raise AssertionError(f"legs A / B ran steps {[e['step'] for e in log_a]} / "
                             f"{[e['step'] for e in log_b]}")
    if not os.path.isdir(os.path.join(tb.checkpoint_dir, "train_state", "3")):
        raise AssertionError("leg B saved no train state at step 3")
    del tb
    # leg C: a fresh process of the CLI
    spy_out = os.path.join(tmp, "leg_c.json")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import sys, chip_smoke; chip_smoke.spied_cli("
                    "sys.argv[1:])", spy_out,
                    *flagship_args(mat, os.path.join(tmp, "B"), "training.resume=true",
                                   f"training.save_every={RESUME_STEPS}")],
                   cwd=REPO, check=True, timeout=600)
    wall_c = time.perf_counter() - t0
    with open(spy_out) as f:
        leg_c = json.load(f)
    log_c = leg_c["steps"]
    launches["C"] = leg_c["launches"]["ctc_alpha_beta_kernel"]
    if [e["step"] for e in log_c] != [4, 5, 6]:
        raise AssertionError(f"leg C ran steps {[e['step'] for e in log_c]}, want 4-6")
    if [e["indices"] for e in log_c] != [e["indices"] for e in log_a[3:]]:
        raise AssertionError("leg C consumed other batches than leg A at steps 4-6")
    want = {"A": RESUME_STEPS, "B": 3, "C": 3}
    if launches != want:
        raise AssertionError(f"ctc_alpha_beta_kernel launches {launches}, want one a step {want}")
    _, parts = checkpoint.load_train_state(os.path.join(tmp, "B", "ndt1_ctc", "train_state"))
    final_a = {k: v.cpu() for k, v in ta.model.state_dict().items()}
    final_c = parts["model"]
    loss_a = [e["loss"] for e in log_a[3:]]
    loss_c = [e["loss"] for e in log_c]
    bits = loss_a == loss_c and all(torch.equal(final_a[k], final_c[k]) for k in final_a)
    if not bits:
        # cuDNN was asked for deterministic algorithms: the run must repeat
        raise AssertionError(
            f"leg C is not bit-equal to leg A: losses {loss_c} vs {loss_a}, parameters "
            f"max|diff| {max_abs_diff(final_a, final_c):.3e}")
    say("state", f"flagship resume (5 x 1024, B=64, 2 steps an epoch, cuDNN deterministic): leg "
        f"C (a fresh CLI process, {wall_c:.1f} s with its start-up) replayed steps 4-6 of leg A "
        f"on the same batches {[e['indices'][:3] for e in log_c]}...; losses {loss_c} and all "
        f"{len(final_a)} parameter tensors bit-equal to leg A's; ctc_alpha_beta_kernel "
        f"launches {launches}")

    # the save and restore of a full flagship train state, timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ta.save_train_state()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = ta.resume_from()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != RESUME_STEPS:
        raise AssertionError(f"restored step {step}")
    say("state", f"flagship train state (model, AdamW, counters, generators): "
        f"{dir_bytes(path) / 2**20:.1f} MiB on disk, save {save_s:.2f} s, restore "
        f"{restore_s:.2f} s; card {power_line}")

    # the profiler's Chrome trace of steps 2-3
    (name,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    fused = [e for e in events if e.get("cat") == "kernel"
             and "ctc_alpha_beta_kernel" in e.get("name", "")]
    if name != "ndt1_ctc_steps2-3.trace.json" or len(fused) != 2:
        raise AssertionError(f"trace {name}: {len(fused)} ctc_alpha_beta_kernel events, want 2")
    kernels = sum(e.get("cat") == "kernel" for e in events)
    say("state", f"profile.start_step=2, num_steps=2: {name} names ctc_alpha_beta_kernel twice "
        f"({fused[0]['name'][:60]}, {fused[0].get('dur')} us), among {kernels} kernel events")
    del ta
    return launches, len(fused)


def flagship_clip(tmp: str) -> int:
    """``optimizer.grad_clip_norm=1.0`` on the flagship: the global norm of the
    gradients that reach AdamW, read by a hook just before each update."""
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.ops import ctc_cuda

    log: list = []
    ctc_cuda.reset_counters()
    with spied_trainer(log):
        trainer = port_main.build_trainer(port_main.parse_args(flagship_args(
            os.path.join(tmp, "mat128"), os.path.join(tmp, "clip"), "training.max_steps=3",
            "optimizer.grad_clip_norm=1.0")))
        norms = []
        trainer.optimizer.register_step_pre_hook(lambda opt, args, kwargs: norms.append((
            float(torch.stack([p.grad.float().square().sum() for p in trainer.trainable])
                  .sum().sqrt()), float(trainer.grad_norm))))
        trainer.train()
    losses = [e["loss"] for e in log]
    if len(norms) != 3 or not all(post <= 1.0 + 1e-6 for post, _ in norms):
        raise AssertionError(f"post-clip global norms {norms}")
    if not all(np.isfinite(losses)) or not all(pre > 1.0 for _, pre in norms):
        raise AssertionError(f"losses {losses}, pre-clip norms {norms}")
    say("state", f"grad_clip_norm=1.0: global norm before / after the clip "
        f"{[(round(pre, 2), round(post, 7)) for post, pre in norms]}; losses {losses}")
    del trainer
    return ctc_cuda.FUSED_LAUNCHES


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}


def remat_pair(label: str, trainer, batch, set_remat, counters, want: dict,
               power_line: str) -> dict:
    """One forward / backward from the same weights and generator state with
    remat off and on: the loss equal, the gradients bit-equal or within the
    flash gates' bf16 tolerance (atol 3e-2 + rtol 3e-2), the launches as
    ``want``; then train steps timed with their peak memory. Returns the
    launches of the remat run."""
    import torch

    model, gen = trainer.model.train(), trainer.generator
    state = gen.get_state()
    runs = {}
    for remat in (False, True):
        set_remat(remat)
        gen.set_state(state)
        model.zero_grad(set_to_none=True)
        counters.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with trainer.autocast():
            out = model(**batch, generator=gen)
        out.loss.backward()
        torch.cuda.synchronize()
        runs[remat] = (out.loss.detach().clone(), grads_of(model), counters.read(),
                       torch.cuda.max_memory_allocated(), gen.get_state())
    (l0, g0, c0, m0, s0), (l1, g1, c1, m1, s1) = runs[False], runs[True]
    if c0 != want[False] or c1 != want[True]:
        raise AssertionError(f"{label}: launches off {c0} / on {c1}, want {want}")
    if not torch.equal(l0, l1) or not torch.equal(s0, s1) or g0.keys() != g1.keys():
        raise AssertionError(f"{label}: loss {l0.item()} vs {l1.item()} or the generator "
                             "or the gradient set differs with remat")
    bit_equal = all(torch.equal(g0[k], g1[k]) for k in g0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=3e-2, rtol=3e-2, msg=lambda m: f"{k}: {m}")
    worst = max_abs_diff(g0, g1)
    model.zero_grad(set_to_none=True)
    timing = {}
    for remat in (False, True):
        set_remat(remat)
        for _ in range(2):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        timing[remat] = ((time.perf_counter() - t0) / 5 * 1e3,
                         torch.cuda.max_memory_allocated() / 2**30)
    say("state", f"{label} remat off / on, one forward + backward from the same state: loss "
        f"{l0.item():.6f} equal, {len(g0)} gradients "
        f"{'bit-equal' if bit_equal else f'max|diff| {worst:.3e} (within 3e-2 + 3e-2)'}, "
        f"launches {c0} / {c1}, peak memory of the pass {m0 / 2**30:.2f} / {m1 / 2**30:.2f} "
        f"GiB; train step {timing[False][0]:.2f} / {timing[True][0]:.2f} ms "
        f"(+{timing[True][0] / timing[False][0] - 1:.1%}), peak memory of the steps "
        f"{timing[False][1]:.2f} / {timing[True][1]:.2f} GiB; card {power_line}")
    return c1


class FlashCounters:
    """The flash kernels' launches, and the dtype of q each forward saw."""

    def __init__(self):
        from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

        self.fc, self.dtypes = fc, []
        real = fc.flash_fwd

        def spy(q, *args):
            self.dtypes.append(q.dtype)
            return real(q, *args)

        fc.flash_fwd = spy
        self.restore = lambda: setattr(fc, "flash_fwd", real)

    def reset(self):
        self.fc.reset_counters()
        self.dtypes = []

    def read(self) -> dict:
        import torch

        if any(d != torch.bfloat16 for d in self.dtypes):
            raise AssertionError(f"a flash forward saw {self.dtypes}: not the bf16 fwd_wg kernel")
        fc = self.fc
        return {FWD_WG: fc.FWD_LAUNCHES, DQ_WG: fc.BWD_DQ_LAUNCHES, DKV_WG: fc.BWD_DKV_LAUNCHES,
                "flash_delta_kernel": fc.BWD_DELTA_LAUNCHES}


class Int8Counters:
    def reset(self):
        from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

        ic.reset_counters()

    def read(self) -> dict:
        return int8_launches()


def mlm_remat(tmp: str, power_line: str) -> dict:
    from llm_bci_tpu_torch import main as port_main

    write_spike_pickle(os.path.join(tmp, "spikes.pkl"))
    trainer = port_main.build_trainer(port_main.parse_args([
        "-c", os.path.join(REPO, "configs", "trainer_ssl_ndt1.yaml"),
        "-k", *MLM_OVERRIDES, f"data.data_dir={tmp}", "data.data_file=spikes.pkl",
        f"dirs.checkpoint_dir={os.path.join(tmp, 'mlm')}", "dirs.log_dir=null", "verbosity=1",
        "model.encoder.remat=true"]))
    encoder = trainer.model.encoder
    if not encoder.remat or encoder.layers[0].attn.dropout <= 0:
        raise AssertionError("remat off or no dropout in the mlm config")
    batch = trainer.to_device(next(iter(trainer.train_dataloader))[0])
    if tuple(batch["spikes"].shape) != (32, 1024, 256):
        raise AssertionError(f"unexpected batch {tuple(batch['spikes'].shape)}")
    n = len(encoder.layers)
    counters = FlashCounters()
    try:
        want = {r: {FWD_WG: n * (2 if r else 1), DQ_WG: n, DKV_WG: n, "flash_delta_kernel": n}
                for r in (False, True)}
        tr = trainer.config.model.encoder.transformer
        label = (f"NDT1-mlm (B=32, T=1024, {n} x {tr.hidden_size}, bf16, dropout "
                 f"{encoder.layers[0].attn.dropout})")
        launches = remat_pair(label, trainer, batch, lambda r: setattr(encoder, "remat", r), counters, want,
                              power_line)
    finally:
        counters.restore()
    del trainer
    return launches


def bci_state_and_remat(tmp: str, power_line: str) -> dict:
    """The BCI fine-tune (32 layers x 7B width, int8 base, LoRA, component
    blobs off): 2 steps saved, a fresh trainer restored from them; then remat
    (``llm_remat``) off and on at that state."""
    import torch
    from llm_bci_tpu_torch import main as port_main

    dataset = {"train": bci_rows(16, seed=1), "test": bci_rows(BCI_B, seed=2)}
    llm_path = write_llama_config(tmp, 32)

    def build(max_steps, *extra):
        return port_main.build_trainer(port_main.parse_args([
            "-c", os.path.join(REPO, "configs", "trainer_bci.yaml"),
            "-k", f"method.model_kwargs.llm_path={llm_path}", "method.model_kwargs.quantize=int8",
            f"training.train_batch_size={BCI_B}", f"training.test_batch_size={BCI_B}",
            f"training.max_steps={max_steps}", "training.eval_every=null",
            "training.save_every=2", "training.component_blobs=false",
            f"dirs.checkpoint_dir={os.path.join(tmp, 'bci')}", "dirs.log_dir=null",
            "verbosity=1", *extra]), dataset=dataset)

    first = build(2)
    first.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = first.save_train_state()
    save_s = time.perf_counter() - t0
    trains = set(first.trainable_names)
    saved = {k: v.detach().cpu() for k, v in first.model.state_dict().items() if k in trains}
    moments = [{k: v.detach().cpu() for k, v in s.items()}
               for s in first.optimizer.state_dict()["state"].values()]
    del first
    gc.collect()
    torch.cuda.empty_cache()

    second = build(3, "model.llm_remat=true")
    model = second.model
    if not model.llm.remat or model.quant != "int8" or len(model.llm.model.layers) != 32:
        raise AssertionError("not the 32-layer int8 BCI with llm_remat")
    frozen = {k: v.clone() for k, v in model.state_dict().items() if k in second.frozen_state_keys()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = second.resume_from()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    now = model.state_dict()
    if step != 2 or any(not torch.equal(now[k], v) for k, v in frozen.items()):
        raise AssertionError(f"restored step {step}, or a frozen leaf changed in the restore")
    if any(not torch.equal(now[k].cpu(), v) for k, v in saved.items()):
        raise AssertionError("a trainable leaf differs from the saved one")
    restored = list(second.optimizer.state_dict()["state"].values())
    if len(restored) != len(moments) or any(
            not torch.equal(r[k].cpu(), m[k]) for r, m in zip(restored, moments)
            for k in ("exp_avg", "exp_avg_sq", "step")):
        raise AssertionError("AdamW moments differ from the saved ones")
    int8_leaves = sum(v.dtype == torch.int8 for v in frozen.values())
    say("state", f"BCI train state (32 layers x 7B width, int8 base, component_blobs false): "
        f"{len(saved)} trainable leaves + AdamW, {dir_bytes(path) / 2**20:.1f} MiB on disk, "
        f"save {save_s:.2f} s, restore {restore_s:.2f} s; {len(frozen)} frozen leaves "
        f"({int8_leaves} int8) bit-equal to the live ones after the restore, the trainable "
        f"leaves and AdamW moments equal to the saved ones; card {power_line}")

    batch = second.to_device(next(iter(second.train_dataloader))[0])
    want = {r: {INT8_CLUSTER: 0, INT8_TILED: INT8_PER_FORWARD + (INT8_PER_FORWARD - 1) * r}
            for r in (False, True)}
    launches = remat_pair("BCI fine-tune (B=8 x 185 tokens, 32 layers, int8 base, LoRA dropout "
                          "0.2)", second, batch, lambda r: setattr(model.llm, "remat", r),
                          Int8Counters(), want, power_line)
    del second, model
    return launches


def entry_check() -> int:
    """``entry()`` on the card against ``entry(device="cpu")``: loss within
    1e-4, through ``ctc_alpha_kernel``."""
    from llm_bci_tpu_torch.entry import entry
    from llm_bci_tpu_torch.ops import ctc_cuda

    fn, args = entry()
    ctc_cuda.reset_counters()
    loss = float(fn(*args))
    launches = ctc_cuda.FWD_LAUNCHES
    cpu_fn, cpu_args = entry(device="cpu")
    cpu_loss = float(cpu_fn(*cpu_args))
    if launches != 1 or ctc_cuda.FUSED_LAUNCHES or not abs(loss - cpu_loss) <= 1e-4:
        raise AssertionError(f"entry(): loss {loss} on the card, {cpu_loss} on the CPU, "
                             f"ctc_alpha_kernel launches {launches}")
    say("state", f"entry(): NDT1-CTC loss {loss:.6f} on the card (ctc_alpha_kernel x{launches}), "
        f"{cpu_loss:.6f} on the CPU, |diff| {abs(loss - cpu_loss):.2e}")
    return launches


def trainer_state_phase(power_line: str, profile=None) -> dict:
    """The trainer contract at full width: flagship resume across processes,
    the save and restore of full train states, gradient clipping, remat on the
    flash and int8 paths, the profiler's trace and ``entry()``."""
    import torch

    total: dict = {}
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            resume_launches, _ = flagship_resume(tmp, power_line)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        add_launches(total, {"ctc_alpha_beta_kernel": sum(resume_launches.values())
                             + flagship_clip(tmp)})
        gc.collect()
        torch.cuda.empty_cache()
        add_launches(total, mlm_remat(tmp, power_line))
        gc.collect()
        torch.cuda.empty_cache()
        add_launches(total, bci_state_and_remat(tmp, power_line))
    add_launches(total, {"ctc_alpha_kernel": entry_check()})
    return total


def profile_step(trainer, batch, power_line: str, path: str, phase: str, label: str,
                 own: dict) -> None:
    """``torch.profiler`` over 3 steady train steps: device time by kernel,
    appended as a table to ``path``; ``own`` names the groups of kernels that
    are looked for before the common ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: the operator rows and the optimizer's annotation
    # repeat their kernels' device time
    from torch.autograd import DeviceType

    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and not ev.key.startswith("Optimizer.")]
    dev_us = lambda ev: getattr(ev, "self_device_time_total", None) or getattr(
        ev, "self_cuda_time_total", 0)
    total = sum(dev_us(ev) for ev in events)
    rows = sorted(((dev_us(ev), ev.count, ev.key) for ev in events if dev_us(ev) > 0),
                  reverse=True)
    groups = {**own, "GEMMs": ("nvjet", "gemm", "cutlass"),
              "copies and casts": ("copy", "Memcpy"), "LayerNorm": ("layer_norm",),
              "random draws": ("distribution", "philox", "rand"),
              "AdamW": ("multi_tensor", "adam")}
    other = "other (elementwise, reductions, softmax)"
    shares = dict.fromkeys([*groups, other], 0.0)
    for us, _, key in rows:
        name = next((g for g, pats in groups.items() if any(p in key for p in pats)), other)
        shares[name] += us
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(f"\ncard: {power_line}\n3 {label} train steps: wall {wall_ms:.1f} ms, device "
                f"busy {total / 1e3:.1f} ms ({total / 1e3 / wall_ms:.3f} of the wall time)\n")
        for name, us in shares.items():
            f.write(f"{us / 1e3 / 3:10.3f} ms/step {us / total:7.3%} {name}\n")
        for us, count, key in rows[:40]:
            f.write(f"{us / 1e3:10.3f} ms {us / total:7.3%} x{count:<5d} {key[:110]}\n")
    say(phase, f"profile of 3 {label} steps: wall {wall_ms:.1f} ms, device busy "
        f"{total / 1e3:.1f} ms ({total / 1e3 / wall_ms:.3f}); table in "
        f"{os.path.relpath(path, REPO)}")
    for name, us in shares.items():
        say(phase, f"  {us / 1e3 / 3:9.3f} ms/step {us / total:7.3%} {name}")


# ---------------------------------------------------------------------------
# Warm start and checkpoint interop: the pretrain -> fine-tune chains and the
# reference format
# ---------------------------------------------------------------------------


def warm_start_cli(argv: list) -> None:
    """``python -m llm_bci_tpu_torch.main <argv[1:]>`` in this process, a
    fine-tune with ``model.encoder.from_pt``; writes to the JSON file
    ``argv[0]``, and its log-probs and CTC inputs to ``argv[0] + ".pt"``:
    whether the encoder was carried bit-equal from the ``from_pt``
    directory's ``encoder.pt`` and the head is a fresh init (the model built
    again from the same seed on the CPU) before the first update, the first
    step's loss and CTC inputs, T' and the CTC plan, the flash and CTC
    kernels' launches of the run."""
    import runpy

    import torch
    from llm_bci_tpu_torch.config import DictConfig
    from llm_bci_tpu_torch.models.ndt1 import NDT1, stacked_lengths
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc
    from llm_bci_tpu_torch.training.trainer import Trainer

    out, sys.argv = argv[0], ["llm_bci_tpu_torch.main", *argv[1:]]
    record: dict = {}
    real_step = Trainer.train_step

    def first_step(trainer, batch):
        if trainer.n_micro:
            return real_step(trainer, batch)
        enc_pt = trainer.config.model.encoder.from_pt
        saved = torch.load(os.path.join(enc_pt, "encoder.pt"), map_location="cpu",
                           weights_only=True)
        live = trainer.model.encoder.state_dict()
        record.update(
            encoder_tensors=len(saved),
            encoder_carried=set(live) == set(saved) and all(
                torch.equal(live[k].cpu(), v) for k, v in saved.items()))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(trainer.config.seed))
            fresh = NDT1.from_config(DictConfig(trainer.config.model),
                                     **dict(trainer.config.method.model_kwargs))
        res = real_step(trainer, batch)
        lp = res["preds"]
        stack = trainer.model.config["encoder"]["embedder"]["stack"]
        il = stacked_lengths(batch["spikes_lengths"], stack["size"], stack["stride"],
                             stack["active"])
        torch.save({"log_probs": lp.cpu(), "targets": batch["targets"].cpu(),
                    "input_lengths": il.cpu(), "target_lengths": batch["targets_lengths"].cpu()},
                   out + ".pt")
        record.update(
            decoder_fresh=all(torch.equal(v, trainer_head[k]) for k, v in
                              fresh.decoder.state_dict().items()),
            loss=float(res["loss"]), frames=int(lp.shape[1]), batch=int(lp.shape[0]),
            layers=len(trainer.model.encoder.layers),
            plan=ctc_cuda.ctc_plan(int(lp.shape[1]), int(batch["targets"].shape[1]),
                                   int(lp.shape[2]), want_grad=True).lattice)
        return res

    real_warm = NDT1.warm_start
    trainer_head: dict = {}

    def warm_start(model):
        real_warm(model)
        trainer_head.update({k: v.clone() for k, v in model.decoder.state_dict().items()})

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctc_cuda.reset_counters()
    fc.reset_counters()
    Trainer.train_step, NDT1.warm_start = first_step, warm_start
    try:
        runpy.run_module("llm_bci_tpu_torch.main", run_name="__main__", alter_sys=True)
    finally:
        Trainer.train_step, NDT1.warm_start = real_step, real_warm
    torch.cuda.synchronize()
    record["launches"] = {
        FWD_WG: fc.FWD_LAUNCHES, DQ_WG: fc.BWD_DQ_LAUNCHES, DKV_WG: fc.BWD_DKV_LAUNCHES,
        "flash_delta_kernel": fc.BWD_DELTA_LAUNCHES, "ctc_alpha_kernel": ctc_cuda.FWD_LAUNCHES,
        "ctc_alpha_beta_kernel": ctc_cuda.FUSED_LAUNCHES}
    with open(out, "w") as f:
        json.dump(record, f)


def cli_kwargs(data: list, ckpt: str, steps: int, *extra) -> list:
    """``-k`` pairs of a run of ``steps`` steps on ``data``, saved under ``ckpt``."""
    return ["-k", *data, f"dirs.checkpoint_dir={ckpt}", "dirs.log_dir=null", "verbosity=1",
            f"training.max_steps={steps}", *extra]


def carried(model, step_dir: str, prefix: str = "encoder.") -> int:
    """The model's tensors under ``prefix`` equal ``step_dir/encoder.pt``'s
    bit for bit; returns their count."""
    import torch

    saved = torch.load(os.path.join(step_dir, "encoder.pt"), map_location="cpu",
                       weights_only=True)
    live = {k[len(prefix):]: v.cpu() for k, v in model.state_dict().items()
            if k.startswith(prefix)}
    if set(live) != set(saved) or any(not torch.equal(live[k], v) for k, v in saved.items()):
        raise AssertionError(f"the encoder was not carried bit-equal from {step_dir}")
    return len(saved)


def ndt1_mlm_to_ctc(tmp: str, power_line: str, device: str = "cuda") -> dict:
    """Leg A: NDT1-mlm pretrained 2 steps at the mlm phase's widths, then a
    ``ctc`` fine-tune of 2 steps in a fresh CLI process from its ``STEP2``
    (unstacked by the re-merged config: T' up to 1024, the flash kernels and
    the CTC kernels' global-scratch plan); ``ctc_alpha_beta_kernel`` timed
    at the fine-tune's first log-probs. Returns the fine-tune's launches."""
    import torch
    from llm_bci_tpu_torch import main as port_main

    write_spike_pickle(os.path.join(tmp, "spikes.pkl"))
    t0 = time.perf_counter()
    pre = port_main.main(port_main.parse_args([
        "-c", os.path.join(REPO, "configs", "trainer_ssl_ndt1.yaml"),
        *cli_kwargs([*MLM_OVERRIDES, f"data.data_dir={tmp}", "data.data_file=spikes.pkl"],
                  os.path.join(tmp, "pre"), 2, "training.eval_every=null",
                  "training.save_every=2")]))
    pre_s = time.perf_counter() - t0
    step = os.path.join(pre.checkpoint_dir, "STEP2")
    files = sorted(os.listdir(step))
    if files != ["decoder.pt", "encoder.pt", "encoder_config.yaml", "optimizer.pt",
                 "trainer_config.yaml"]:
        raise AssertionError(f"mlm STEP2 holds {files}")
    del pre
    gc.collect()
    torch.cuda.empty_cache()

    mat = write_mat_dataset(os.path.join(tmp, "mat_long"), n_train=64, n_test=4,
                            bins=(896, 1024), channels=128)
    out = os.path.join(tmp, "ft.json")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import sys, chip_smoke; chip_smoke.warm_start_cli("
                    "sys.argv[1:])", out, "-c",
                    os.path.join(REPO, "configs", "trainer_ctc_ndt1.yaml"),
                    *cli_kwargs([f"data.data_dir={mat}"], os.path.join(tmp, "ft"), 2,
                              f"model.encoder.from_pt={step}", "training.eval_every=null",
                              "training.save_every=null")],
                   cwd=REPO, check=True, timeout=600)
    ft_s = time.perf_counter() - t0
    with open(out) as f:
        rec = json.load(f)
    launches = rec["launches"]
    flash = rec["layers"] * 2          # a launch a layer a step
    want = {FWD_WG: flash, DQ_WG: flash, DKV_WG: flash, "flash_delta_kernel": flash,
            "ctc_alpha_kernel": 0, "ctc_alpha_beta_kernel": 2}
    if not (rec["encoder_carried"] and rec["decoder_fresh"]):
        raise AssertionError(f"fine-tune: encoder carried {rec['encoder_carried']}, decoder "
                             f"fresh {rec['decoder_fresh']}")
    if launches != want or rec["plan"] != "global" or rec["frames"] < 512:
        raise AssertionError(f"fine-tune: launches {launches} (want {want}), T'={rec['frames']}, "
                             f"plan {rec['plan']}")
    # the first step's loss against the plain CTC on its own log-probs (the
    # kernels' launches of this check are not the main path's)
    from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain

    inputs = torch.load(out + ".pt", weights_only=True)
    lp = inputs["log_probs"].to(device)
    targets, il, tl = (inputs[k].to(device).int() for k in
                       ("targets", "input_lengths", "target_lengths"))
    plain = ctc_loss_plain(lp.double(), targets, il, tl).sum().item()
    if not abs(rec["loss"] - plain) <= 1e-4 * abs(plain) + 1e-4 * lp.shape[0]:
        raise AssertionError(f"fine-tune step 1 loss {rec['loss']} vs the plain CTC {plain}")
    ctc_check("warm-start ctc fine-tune", lp, targets, il, tl, True, "global")
    t = {**ctc_times(lp, targets, il, tl), **ctc_eager_times(lp, targets, il, tl, False)}
    fwd_bound, fused_bound = ctc_bounds(lp, targets, il, tl)
    say("warm", f"A. NDT1 mlm -> ctc ({rec['layers']} layers): mlm pretrain 2 steps + save in {pre_s:.1f} s "
        f"(STEP2: {files[:3]}); ctc fine-tune from it in a fresh CLI process, 2 steps in "
        f"{ft_s:.1f} s with its start-up: {rec['encoder_tensors']} encoder tensors bit-equal to "
        f"encoder.pt before the first update, the head the fresh init; B={rec['batch']} "
        f"T'={rec['frames']} unstacked, CTC plan {rec['plan']}; step 1 loss {rec['loss']:.4f} "
        f"vs plain {plain:.4f}; launches {launches}; at these log-probs (CUDA graphs of 20) "
        f"ctc_alpha_kernel {t['fwd_ms']:.4f} ms (bound {fwd_bound['bound_ms']:.5f} ms, "
        f"{fwd_bound['bound_by']}), ctc_alpha_beta_kernel {t['fused_ms']:.4f} ms, the pair "
        f"{t['pair_ms']:.4f} ms (bound {fused_bound['bound_ms']:.5f} ms, "
        f"{fused_bound['bound_by']}); F.ctc_loss (eager) forward {t['lib_fwd_ms']:.4f} ms, "
        f"forward + backward {t['lib_pair_ms']:.4f} ms; card {power_line}")
    return launches


def flagship_round_trip(tmp: str, power_line: str) -> dict:
    """Leg B: the NDT1-CTC flagship after 2 steps exported to the reference
    format, and built again from it by ``from_pt``, as ``ctc`` and as
    ``endtoend``: the eval loss bit-equal to the exporting model's."""
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.config import DictConfig
    from llm_bci_tpu_torch.interop.torch_export import ndt1_save_reference_checkpoint
    from llm_bci_tpu_torch.models.ndt1 import NDT1
    from llm_bci_tpu_torch.ops import ctc_cuda

    mat = write_mat_dataset(os.path.join(tmp, "mat"), n_train=64, n_test=8)
    trainer = port_main.main(port_main.parse_args(flagship_args(mat, os.path.join(tmp, "flag"))
                                                  + ["training.max_steps=2"]))
    ref = os.path.join(tmp, "flagship_ref")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ndt1_save_reference_checkpoint(trainer.model, ref)
    export_s = time.perf_counter() - t0
    sizes = {name: os.path.getsize(os.path.join(ref, name)) for name in sorted(os.listdir(ref))}
    batch = trainer.to_device(next(iter(trainer.test_dataloader))[0])
    kwargs = dict(trainer.config.method.model_kwargs)

    def eval_loss(model) -> "torch.Tensor":
        model.eval()
        with torch.no_grad(), trainer.autocast():
            return model(**batch).loss

    ctc_cuda.reset_counters()
    losses = {"exporting": eval_loss(trainer.model)}
    import_s = {}
    for method in ("ctc", "endtoend"):
        cfg = DictConfig(trainer.config.model)
        cfg["encoder"]["from_pt"] = ref
        t0 = time.perf_counter()
        model = NDT1.from_config(cfg, **{**kwargs, "method_name": method})
        model.warm_start()
        model = model.to(trainer.device)
        torch.cuda.synchronize()
        import_s[method] = time.perf_counter() - t0
        losses[method] = eval_loss(model)
        del model
    launches = {"ctc_alpha_kernel": ctc_cuda.FWD_LAUNCHES}
    if launches["ctc_alpha_kernel"] != 3 or ctc_cuda.FUSED_LAUNCHES:
        raise AssertionError(f"round trip: CTC launches {launches}")
    if not all(torch.equal(losses["exporting"], v) for v in losses.values()):
        raise AssertionError(f"round trip: eval losses {[float(v) for v in losses.values()]}")
    say("warm", f"B. NDT1-CTC flagship (5 x 1024, stack 32/4) after 2 steps, exported to the "
        f"reference format in {export_s:.2f} s ({', '.join(f'{k} {v / 2**20:.1f} MiB' for k, v in sizes.items())}); "
        f"built again by from_pt as ctc in {import_s['ctc']:.2f} s and as endtoend in "
        f"{import_s['endtoend']:.2f} s: eval loss {float(losses['exporting']):.6f} bit-equal in "
        f"all three (B={batch['spikes'].shape[0]}, cuDNN deterministic); card {power_line}")
    del trainer
    return launches


def bci_reference_round_trip(tmp: str, power_line: str, device: str = "cuda") -> dict:
    """Leg C: the BCI at Llama-2-7B width (32 layers, int8 base) trained one
    step (LoRA B non-zero), exported without its base (the inner NDT1's
    ``encoder.bin``, ``projector.bin`` and the PEFT adapter), imported into a
    fresh int8 BCI whose base comes from the same seed: the same greedy
    tokens, the int8 launches of the imported model's decode counted."""
    import torch
    from llm_bci_tpu_torch.config import DictConfig
    from llm_bci_tpu_torch.interop.torch_export import bci_save_reference_checkpoint
    from llm_bci_tpu_torch.models.bci import BCI
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    llm_path = write_llama_config(tmp, 32)
    model, _ = build_bci(llm_path, "int8", device)
    batch = bci_serving_batch(device)
    rows = bci_rows(BCI_B, seed=0)
    targets = torch.from_numpy(np.stack([r["labels"] for r in rows])).to(device)
    model.train()
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=1e-3)
    with torch.autocast(device, dtype=torch.bfloat16):
        model(**batch, targets=targets).loss.backward()
    opt.step()
    del opt
    model.zero_grad(set_to_none=True)
    model.eval()
    if any(float(p.detach().abs().max()) == 0.0 for n, p in model.named_parameters()
           if n.endswith("lora_B")):
        raise AssertionError("a LoRA B stayed zero after the training step")
    with torch.autocast(device, dtype=torch.bfloat16):
        want = model.generate(**batch, max_new_tokens=32, eos_token_id=-1)
    ref = os.path.join(tmp, "bci_ref")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bci_save_reference_checkpoint(model, ref, include_base=False)
    export_s = time.perf_counter() - t0
    sizes = {name: os.path.getsize(os.path.join(ref, name)) for name in sorted(os.listdir(ref))}
    del model
    gc.collect()
    torch.cuda.empty_cache()

    torch.manual_seed(0)              # build_bci's seed: the same int8 base
    t0 = time.perf_counter()
    fresh = BCI.from_config(
        DictConfig({"from_pt": ref, "ndt1": {"encoder": {"embedder": {
            "n_channels": BCI_CHANNELS}}}}),
        method_name="endtoend", llm_path=llm_path, lora=dict(LORA), freeze_llm=False,
        quantize="int8", compute_dtype="bfloat16", device=device)
    fresh.warm_start()
    fresh = fresh.to(device).eval()
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    ic.reset_counters()
    with torch.autocast(device, dtype=torch.bfloat16):
        got = fresh.generate(**batch, max_new_tokens=32, eos_token_id=-1)
    torch.cuda.synchronize()
    launches = int8_launches()
    if not torch.equal(got, want):
        raise AssertionError(f"greedy tokens after the reference-format import differ: "
                             f"{(got != want).sum().item()} of {got.numel()}")
    if not (launches[INT8_TILED] and launches[INT8_CLUSTER]):
        raise AssertionError(f"int8 launches of the imported model's decode: {launches}")
    present = [m for m in ("transformers", "safetensors") if m in sys.modules]
    if present:
        raise AssertionError(f"the reference-format round trip imported {present}")
    say("warm", f"C. BCI (32 layers x 7B width, int8 base, LoRA r=8 trained 1 step) exported "
        f"without its base in {export_s:.2f} s ({', '.join(f'{k} {v / 2**20:.1f} MiB' for k, v in sizes.items())}); "
        f"a fresh int8 BCI from the same seed built and imported in {import_s:.2f} s: greedy "
        f"{tuple(got.shape)} tokens equal to the exporting model's; int8 launches of its decode "
        f"{launches}; neither transformers nor safetensors imported; card {power_line}")
    del fresh
    return launches


def itransformer_patchtst_chains(tmp: str, power_line: str) -> dict:
    """Leg D: iTransformer ssl -> ``stat_behaviour`` (choice) and PatchTST mlm
    -> ``ctc`` at their phases' widths, 2 steps each side: the encoder carried
    bit-equal (PatchTST's BatchNorm running averages with it), the PatchTST
    ``ctc`` fine-tune on the CTC pair."""
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.config import update_config
    from llm_bci_tpu_torch.ops import ctc_cuda

    ibl = COSMOOTH_IBL
    total = dict.fromkeys(CTC_KERNELS, 0)
    steps = {}
    for model, pre_cfg, pre_data, ft_cfg, ft_data in (
            ("itransformer", "trainer_ssl_itransformer.yaml", "ibl",
             "trainer_choice_itransformer.yaml", "ibl"),
            ("patchtst", "trainer_ssl_itransformer.yaml", "ibl", "trainer_ctc_ndt1.yaml", "mat")):
        root = os.path.join(tmp, model)
        os.makedirs(root)
        cfg_of = lambda base: (os.path.join(REPO, "configs", base) if model == "itransformer"
                               else trainer_yaml(root, base, "patchtst.yaml"))
        data = {"ibl": ["data.data_load=file", f"data.data_dir={root}", "data.data_file=ibl.pkl"],
                "mat": [f"data.data_dir={os.path.join(root, 'mat')}",
                        "training.train_batch_size=16", "training.test_batch_size=16"]}
        if ft_data == "mat":
            write_mat_dataset(os.path.join(root, "mat"), n_train=32, n_test=16)
        write_spike_pickle(os.path.join(root, "ibl.pkl"), *IBL_SPLIT,
                           bins=(ibl["bins"], ibl["bins"]), channels=ibl["channels"],
                           n_regions=ibl["regions"],
                           data_config=update_config(
                               os.path.join(REPO, "configs", "trainer_choice_itransformer.yaml"),
                               None).data)
        pre = port_main.main(port_main.parse_args([
            "-c", cfg_of(pre_cfg), *cli_kwargs(data[pre_data], os.path.join(root, "pre"), 2,
                                             "training.eval_every=null", "training.save_every=2")]))
        step = os.path.join(pre.checkpoint_dir, "STEP2")
        del pre
        ctc_cuda.reset_counters()
        ft = port_main.build_trainer(port_main.parse_args([
            "-c", cfg_of(ft_cfg), *cli_kwargs(data[ft_data], os.path.join(root, "ft"), 2,
                                            f"model.encoder.from_pt={step}",
                                            "training.eval_every=2", "training.save_every=null")]))
        n = carried(ft.model, step)
        stats = sum(k.endswith(("running_mean", "running_var")) for k in ft.model.state_dict())
        ft.train()
        torch.cuda.synchronize()
        launches = {"ctc_alpha_kernel": ctc_cuda.FWD_LAUNCHES,
                    "ctc_alpha_beta_kernel": ctc_cuda.FUSED_LAUNCHES}
        h = ft.eval_history[0]
        if not (np.isfinite(h["train_avg_loss"]) and np.isfinite(h["test_avg_loss"])):
            raise AssertionError(f"{model} fine-tune: losses {h}")
        if model == "patchtst":
            want = {"ctc_alpha_kernel": len(ft.test_dataloader), "ctc_alpha_beta_kernel": 2}
            if launches != want or stats != 4 * ft.config.model.encoder.num_hidden_layers:
                raise AssertionError(f"PatchTST ctc fine-tune: CTC launches {launches} (want "
                                     f"{want}), {stats} running statistics")
        elif any(launches.values()):
            raise AssertionError(f"iTransformer choice: CTC launches {launches}")
        add_launches(total, launches)
        steps[model] = (n, stats, ft.config.model.model_class, h["test_avg_loss"], launches)
        del ft
        gc.collect()
        torch.cuda.empty_cache()
    for model, (n, stats, cls, loss, launches) in steps.items():
        say("warm", f"D. {cls}: {'ssl -> choice' if model == 'itransformer' else 'mlm -> ctc'} "
            f"at the config's widths, 2 + 2 steps: {n} encoder tensors carried bit-equal "
            f"({stats} BatchNorm running statistics among them), fine-tune eval loss "
            f"{loss:.4f}, CTC launches {launches}; card {power_line}")
    return total


def warm_start_phase(power_line: str, profile=None) -> dict:
    """Checkpoint interop at full width: legs A-D (``ndt1_mlm_to_ctc``,
    ``flagship_round_trip``, ``bci_reference_round_trip``,
    ``itransformer_patchtst_chains``)."""
    import torch

    say("warm", f"card: {nvidia_smi_line()}")
    total: dict = {}
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        add_launches(total, ndt1_mlm_to_ctc(tmp, power_line))
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            add_launches(total, flagship_round_trip(tmp, power_line))
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        gc.collect()
        torch.cuda.empty_cache()
        add_launches(total, bci_reference_round_trip(tmp, power_line))
        gc.collect()
        torch.cuda.empty_cache()
        add_launches(total, itransformer_patchtst_chains(tmp, power_line))
    return total

# ---------------------------------------------------------------------------
# Serving export (phase 17)
# ---------------------------------------------------------------------------

SERVE_NEW, SERVE_BEAMS = 32, 5
SERVE_LAYERS = 4          # A's depth at Llama-2-7B width: torch.export and the
                          # archive's load take host time by the layer
SERVE_WINDOW, SERVE_WINDOWS = 128, 8     # spike bins a window of the real-time loop, windows
BIN_MS = 20                              # a bin of the competition data


def _refuse_model(*args, **kwargs):
    raise AssertionError("a model was built in the serving process")


def serve_child(paths: dict, params: dict, batch: dict, out) -> None:
    """A fresh process given only the archives' paths, the weights and the
    batch (CUDA tensors shared with the parent, no copy): loads each archive
    with ``load_decode``, with the model class made unbuildable, and decodes
    once; puts the results, the load seconds and the launches on ``out``."""
    import traceback

    try:
        import torch
        from llm_bci_tpu_torch import serving
        from llm_bci_tpu_torch.models import bci, decode_graph
        from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

        bci.BCI.__init__ = _refuse_model
        res = {}
        for name, path in paths.items():
            t0 = time.perf_counter()
            fn = serving.load_decode(path)
            load_s = time.perf_counter() - t0
            ic.reset_counters()
            decode_graph.reset_counters()
            t0 = time.perf_counter()
            got = fn(params, batch)
            if fn.device.type == "cuda":
                torch.cuda.synchronize()
            res[name] = {       # numpy: nothing of the result is shared through /dev/shm
                "load_s": load_s, "run_s": time.perf_counter() - t0,
                "out": got.cpu().numpy() if torch.is_tensor(got) else
                (got.sequences.cpu().numpy(), got.scores.cpu().numpy()),
                "launches": int8_launches(),
                "graphs": (decode_graph.EAGER_STEPS, decode_graph.CAPTURES, decode_graph.REPLAYS),
            }
        res["modules"] = sorted(m for m in sys.modules if m in ("jax", "llm_bci_tpu"))
        out.put(res)
    except BaseException:
        out.put({"error": traceback.format_exc()})


def archive_step(fn, params: dict, batch: dict):
    """The prefill of a loaded decode archive and the :class:`TokenStep` over
    its cache, not yet run (``prefill_step`` for an archive): ``(first ids,
    step, P, embed)``."""
    import torch
    from llm_bci_tpu_torch.models.decode_graph import TokenStep

    decode_step, embed, embeds, mask, cache = fn.parts(params, batch)
    B, P, _ = embeds.shape
    key_mask = mask.new_zeros((B, cache[0]["k"].shape[1]))
    key_mask[:, :P] = mask
    logits, cache = decode_step(embeds, key_mask, cache, 0)
    return torch.argmax(logits[:, -1, :], -1), TokenStep(decode_step, cache, key_mask), P, embed


def serve_bci_decode(tmp: str, power_line: str, profile, device: str = "cuda") -> dict:
    """A: the 7B-width int8 BCI of phase 8, cut to ``SERVE_LAYERS`` layers,
    exported (greedy and diverse beam 5), loaded in a fresh process, held against in-process ``generate``.
    ``device="cpu"`` rehearses it (the card's timings then mean nothing)."""
    import multiprocessing

    import torch
    from llm_bci_tpu_torch import serving
    from llm_bci_tpu_torch.models import decode_graph
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    dev = torch.device(device)
    batch = bci_serving_batch(dev)
    model, build_s = build_bci(write_llama_config(tmp, SERVE_LAYERS), "int8", dev)
    per_forward = 7 * SERVE_LAYERS + 1                 # 7 projections a layer + lm_head
    params = serving.params_of(model)
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    autocast = lambda: torch.autocast(dev.type, dtype=torch.bfloat16)
    gens = {"greedy": dict(eos_token_id=-1),
            "diverse": dict(num_beams=SERVE_BEAMS, num_beam_groups=SERVE_BEAMS,
                            diversity_penalty=1.2, num_return_sequences=SERVE_BEAMS,
                            eos_token_id=2)}
    with autocast():
        ref = {name: model.generate(**batch, max_new_tokens=SERVE_NEW, **gen)
               for name, gen in gens.items()}
    paths = {}
    for name, gen in gens.items():
        paths[name] = os.path.join(tmp, f"bci_{name}.pt2")
        t0 = time.perf_counter()
        serving.export_decode(model, params, batch, paths[name], max_new_tokens=SERVE_NEW,
                              autocast=torch.bfloat16, **gen)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(paths[name])
        say("serve", f"A. {name} decode archive ({SERVE_LAYERS} layers) exported in {export_s:.1f} s: "
            f"{size / 2 ** 20:.2f} MiB against {weight_bytes / 2 ** 30:.2f} GiB of weights "
            f"({size / weight_bytes:.3%}), 4 programs")
        if size >= 0.01 * weight_bytes:
            raise AssertionError(f"the {name} archive holds {size} bytes: a weight in it?")

    # a fresh process with the path, the weights and the batch
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    child = ctx.Process(target=serve_child, args=(paths, params, batch, queue))
    t0 = time.perf_counter()
    child.start()
    try:
        res = queue.get(timeout=600)
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.kill()
    if "error" in res:
        raise AssertionError(f"the serving process failed:\n{res['error']}")
    say("serve", f"A. fresh serving process: {time.perf_counter() - t0:.1f} s with its start-up; "
        f"modules of JAX loaded: {res['modules']}")
    if res["modules"]:
        raise AssertionError(f"the serving process imported {res['modules']}")
    greedy = torch.from_numpy(res["greedy"]["out"])
    if not torch.equal(greedy, ref["greedy"].cpu()):
        raise AssertionError(f"loaded greedy ids differ from generate's at "
                             f"{int((greedy != ref['greedy'].cpu()).sum())} places")
    seqs, scores = (torch.from_numpy(a) for a in res["diverse"]["out"])
    if not torch.equal(seqs, ref["diverse"].sequences.cpu()):
        raise AssertionError("loaded diverse-beam sequences differ from generate's")
    err = (scores - ref["diverse"].scores.cpu()).abs().max().item()
    if err > 1e-4:
        raise AssertionError(f"loaded diverse-beam scores differ from generate's by {err}")
    launches = {}
    # on the card one eager token step, one capture, the rest replays; on the
    # CPU (a rehearsal) every step runs eagerly
    want_graphs = (1, 1, SERVE_NEW - 2) if dev.type == "cuda" else (SERVE_NEW - 1, 0, 0)
    for name in gens:
        r = res[name]
        graphs = r["graphs"]
        want = {INT8_TILED: per_forward,
                INT8_CLUSTER: (graphs[0] + graphs[1]) * per_forward}
        if graphs != want_graphs or r["launches"] != want:
            raise AssertionError(f"A. {name}: int8 launches {r['launches']} with (eager steps, "
                                 f"captures, replays) {graphs}, want {want} with {want_graphs}")
        add_launches(launches, r["launches"])
        say("serve", f"A. {name} in the fresh process: loaded in {r['load_s']:.2f} s, decoded "
            f"in {r['run_s']:.2f} s (its capture included); int8 launches {r['launches']} = "
            f"{per_forward} a model call x (1 prefill | 1 eager step + 1 capture), "
            f"{SERVE_NEW - 2} replays")
    say("serve", f"A. loaded greedy ids equal generate's ({greedy.numel()} ids); diverse beam "
        f"sequences equal, scores max|err| {err:.2e}")

    # the loaded archives beside in-process generate, in turns, in this process
    loaded = {name: serving.load_decode(path) for name, path in paths.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def in_process(name):
        with autocast():        # the archive has it inside
            return model.generate(**batch, max_new_tokens=SERVE_NEW, **gens[name])

    runs = {"loaded": lambda name: loaded[name](params, batch), "in-process": in_process}
    times = {(who, name): [] for who in runs for name in gens}
    for name in gens:
        runs["loaded"](name)                      # warm: the first call of each program
        for who in ("loaded", "in-process", "in-process", "loaded"):
            times[(who, name)].append(timed(lambda: runs[who](name)))
    for who in runs:
        g, d = times[(who, "greedy")], times[(who, "diverse")]
        say("serve", f"A. {who}: greedy {BCI_B * SERVE_NEW / max(g):.1f}-"
            f"{BCI_B * SERVE_NEW / min(g):.1f} tokens/s, diverse beam "
            f"{BCI_B / max(d):.2f}-{BCI_B / min(d):.2f} sequences/s (each decode with its "
            f"capture); card {power_line}")

    with torch.no_grad():
        token, step, P, embed = archive_step(loaded["greedy"], params, batch)
        step.key_mask[:, P] = 1
        step(embed(token[:, None]), P)             # the first step and the capture

        def steps(n=16):
            tok = token
            for t in range(1, n + 1):
                step.key_mask[:, P + t] = 1
                tok = torch.argmax(step(embed(tok[:, None]), P + t), -1)
            return tok

        wall_ms = timed(steps) * 1e3
        prof = device_profile(steps, "16 replayed token steps of the loaded archive",
                              power_line, profile, wall_ms, phase="serve")
    say("serve", f"A. a replayed token step of the loaded archive {prof['busy_ms'] / 16:.3f} ms "
        f"of device time, {wall_ms / 16:.3f} ms of wall time (build {build_s:.1f} s)")
    del step, loaded, model, params
    return launches


def serve_cpu_exported(tmp: str, power_line: str, device: str = "cuda") -> dict:
    """B: a 2-layer copy of A's model exported on the CPU, moved to the card
    by ``move_to_device_pass`` and run there: the op nodes pick the kernels."""
    import copy

    import torch
    from llm_bci_tpu_torch import serving
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    dev = torch.device(device)
    batch = bci_serving_batch(dev)
    model, _ = build_bci(write_llama_config(tmp, 2), "int8", dev)
    with torch.no_grad():
        ref = model.generate(**batch, max_new_tokens=SERVE_NEW, eos_token_id=-1)
    on_cpu = copy.deepcopy(model).to("cpu")
    path = os.path.join(tmp, "bci_cpu.pt2")
    t0 = time.perf_counter()
    serving.export_decode(on_cpu, serving.params_of(on_cpu),
                          {k: v.cpu() for k, v in batch.items()}, path,
                          max_new_tokens=SERVE_NEW, eos_token_id=-1, device=device)
    export_s = time.perf_counter() - t0
    del on_cpu
    fn = serving.load_decode(path)
    ic.reset_counters()
    got = fn(serving.params_of(model), batch)
    torch.cuda.synchronize()
    launches = int8_launches()
    if fn.device != dev or not torch.equal(got, ref):
        raise AssertionError(f"B. the CPU-exported archive on {fn.device}: ids differ from the "
                             f"card's in-process decode at {int((got != ref).sum())} places")
    per_forward = INT8_PER_FORWARD // 32 * 2 + INT8_PER_FORWARD % 32    # 2 layers and lm_head
    want = {INT8_TILED: per_forward, INT8_CLUSTER: 2 * per_forward}
    if launches != want:
        raise AssertionError(f"B. int8 launches {launches}, want {want}")
    say("serve", f"B. a 2-layer copy exported on the CPU in {export_s:.1f} s and moved to "
        f"{fn.device}: greedy ids equal the card's in-process decode, int8 launches {launches}")
    return launches


def serve_flagship(tmp: str, power_line: str) -> dict:
    """C and D: the flagship NDT1-CTC's eval forwards, then the real-time
    loop over one-window archives."""
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch import serving
    from llm_bci_tpu_torch.eval.ctc_decode import CTCPrefixDecoder, ctc_prefix_beam_search
    from llm_bci_tpu_torch.models.ndt1 import stacked_lengths
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain

    write_mat_dataset(os.path.join(tmp, "mat"))
    trainer = port_main.build_trainer(port_main.parse_args([
        "-c", os.path.join(REPO, "configs", "trainer_ctc_ndt1.yaml"),
        "-k", f"data.data_dir={os.path.join(tmp, 'mat')}", "dirs.log_dir=null", "verbosity=1",
        f"dirs.checkpoint_dir={os.path.join(tmp, 'ctc')}"]))
    model = trainer.model.eval()
    batch = trainer.to_device(next(iter(trainer.test_dataloader))[0])
    serve = {k: v for k, v in batch.items() if not k.startswith("targets")}
    const = {k: v for k, v in batch.items() if k.startswith("targets")}
    params = serving.params_of(model)
    served = None if trainer.compute_dtype == torch.float32 else trainer.compute_dtype
    with torch.no_grad(), trainer.autocast():
        ref = model(**batch)
    launches = {}
    for outputs in (("preds",), ("loss", "preds")):
        path = os.path.join(tmp, f"ctc_{len(outputs)}.pt2")
        t0 = time.perf_counter()
        serving.export_forward(model, params, serve, path, outputs=outputs,
                               const_inputs=const, autocast=served)
        export_s = time.perf_counter() - t0
        fn = serving.load_decode(path)
        ctc_nodes = [t for t in fn.archive.graph_targets("forward") if t.startswith("llm_bci.")]
        fn(params, serve)
        ctc_cuda.reset_counters()
        out = fn(params, serve)
        torch.cuda.synchronize()
        got = {"ctc_alpha_kernel": ctc_cuda.FWD_LAUNCHES,
               "ctc_alpha_beta_kernel": ctc_cuda.FUSED_LAUNCHES}
        want = ({"ctc_alpha_kernel": 1, "ctc_alpha_beta_kernel": 0} if "loss" in outputs
                else {"ctc_alpha_kernel": 0, "ctc_alpha_beta_kernel": 0})
        nodes = ["llm_bci.ctc_alpha.default"] if "loss" in outputs else []
        if ctc_nodes != nodes or got != want:
            raise AssertionError(f"C. outputs {outputs}: llm_bci nodes {ctc_nodes}, CTC "
                                 f"launches {got}; want {nodes}, {want}")
        add_launches(launches, got)
        err = (out["preds"].float() - ref.preds.float()).abs().max().item()
        if tuple(out["preds"].shape) != tuple(ref.preds.shape) or err > 2e-2:
            raise AssertionError(f"C. the archive's log-probs differ from the eval forward's "
                                 f"by {err}")
        fwd_ms = cuda_ms(lambda: fn(params, serve), 10)
        say("serve", f"C. NDT1-CTC eval forward, outputs {outputs} (B="
            f"{batch['spikes'].shape[0]}, 5 x 1024, T'={out['preds'].shape[1]}, bf16 autocast): "
            f"exported in {export_s:.1f} s, {os.path.getsize(path) / 2 ** 20:.2f} MiB, "
            f"llm_bci nodes {ctc_nodes}, CTC launches a call {got}, {fwd_ms:.2f} ms a call; "
            f"log-probs max|err| {err:.2e} against the in-process eval forward's (atol 2e-2)")
    stack = trainer.config.model.encoder.embedder.stack
    lens = stacked_lengths(batch["spikes_lengths"], stack.size, stack.stride, stack.active)
    lp = out["preds"].float()
    plain = ctc_loss_plain(lp.double(), batch["targets"], lens, batch["targets_lengths"]).sum()
    torch.testing.assert_close(out["loss"].double(), plain, rtol=1e-5, atol=1e-3)
    ctc_check("at the served log-probs", lp, batch["targets"].int(), lens.int(),
              batch["targets_lengths"].int(), True, "shared")
    say("serve", f"C. the archive's loss {out['loss'].item():.4f} against the plain CTC's "
        f"{plain.item():.4f} on its own log-probs")

    # D. The real-time loop: one window of B=1 a call, streamed into the
    # prefix beam search.
    T_full = batch["spikes"].shape[1]
    window = {k: (v[:1, :SERVE_WINDOW].contiguous() if v.dim() >= 2 and v.shape[1] == T_full
                  else v[:1].contiguous()) for k, v in serve.items()}
    window["spikes_lengths"] = torch.full_like(window["spikes_lengths"], SERVE_WINDOW)
    path = os.path.join(tmp, "ctc_window.pt2")
    serving.export_forward(model, params, window, path, outputs=("preds",),
                           const_inputs={k: v[:1] for k, v in const.items()},
                           autocast=served)
    fn = serving.load_decode(path)
    fn(params, window)
    rng = np.random.default_rng(7)
    decoder = CTCPrefixDecoder(beam_width=16, blank_id=0)
    frames, dev_ms, host_ms = [], [], 0.0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(SERVE_WINDOWS):
        spikes = rng.poisson(1.0, size=tuple(window["spikes"].shape)).astype(np.float32)
        window["spikes"] = torch.from_numpy(spikes).to(window["spikes"].device)
        start.record()
        lp_w = fn(params, window)["preds"][0]
        end.record()
        lp_w = lp_w.double().cpu().numpy()
        dev_ms.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        live, _ = decoder.step(lp_w)
        host_ms += (time.perf_counter() - t0) * 1e3
        frames.append(lp_w)
    final, _ = decoder.best()
    whole = ctc_prefix_beam_search(np.concatenate(frames), beam_width=16, blank_id=0)[0][0]
    if final != whole:
        raise AssertionError(f"D. the live transcript {final} differs from the search over all "
                             f"frames {whole}")
    n_frames = sum(len(f) for f in frames)
    frame_ms = stack.stride * BIN_MS
    say("serve", f"D. real-time loop, {SERVE_WINDOWS} windows of {SERVE_WINDOW} bins (B=1, "
        f"{len(frames[0])} frames each): forward {min(dev_ms):.2f}-{max(dev_ms):.2f} ms a window "
        f"(CUDA events), host prefix search (beam 16) {host_ms / n_frames:.3f} ms a frame, "
        f"against {frame_ms} ms of signal a stacked frame; the live transcript ({len(final)} "
        f"labels) equals the search over all {n_frames} frames; card {power_line}")
    del trainer, model
    return launches


def serve_mlm(tmp: str, power_line: str) -> dict:
    """E: the NDT1-mlm eval forward at phase 6's shape, on the flash path."""
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch import serving
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    write_spike_pickle(os.path.join(tmp, "spikes.pkl"))
    trainer = port_main.build_trainer(port_main.parse_args([
        "-c", os.path.join(REPO, "configs", "trainer_ssl_ndt1.yaml"),
        "-k", *MLM_OVERRIDES, f"data.data_dir={tmp}", "data.data_file=spikes.pkl",
        f"dirs.checkpoint_dir={os.path.join(tmp, 'mlm')}", "dirs.log_dir=null", "verbosity=1"]))
    model = trainer.model.eval()
    batch = trainer.to_device(next(iter(trainer.test_dataloader))[0])
    params = serving.params_of(model)
    with torch.no_grad(), trainer.autocast():
        ref = model(**batch).preds
    path = os.path.join(tmp, "mlm.pt2")
    t0 = time.perf_counter()
    serving.export_forward(model, params, batch, path, outputs=("preds",),
                           autocast=None if trainer.compute_dtype == torch.float32
                           else trainer.compute_dtype)
    export_s = time.perf_counter() - t0
    fn = serving.load_decode(path)
    fn(params, batch)
    fc.reset_counters()
    out = fn(params, batch)["preds"]
    torch.cuda.synchronize()
    launches = {FWD_WG: fc.FWD_LAUNCHES, DQ_WG: fc.BWD_DQ_LAUNCHES, DKV_WG: fc.BWD_DKV_LAUNCHES,
                "flash_delta_kernel": fc.BWD_DELTA_LAUNCHES}
    n_layers = trainer.config.model.encoder.transformer.n_layers
    if launches != {FWD_WG: n_layers, DQ_WG: 0, DKV_WG: 0, "flash_delta_kernel": 0}:
        raise AssertionError(f"E. flash launches {launches}, want {n_layers} forwards")
    err = (out.float() - ref.float()).abs().max().item()
    if tuple(out.shape) != tuple(ref.shape) or err > 2e-2:
        raise AssertionError(f"E. the mlm archive's preds differ from the eval forward's: {err}")
    fwd_ms = cuda_ms(lambda: fn(params, batch), 10)
    say("serve", f"E. NDT1-mlm eval forward (B={batch['spikes'].shape[0]}, T="
        f"{batch['spikes'].shape[1]}, flash): exported in {export_s:.1f} s, "
        f"{os.path.getsize(path) / 2 ** 20:.2f} MiB, {launches[FWD_WG]} flash forward launches "
        f"a call, preds max|err| {err:.2e} against the eval forward (atol 2e-2), {fwd_ms:.2f} ms "
        f"a call; card {power_line}")
    del trainer, model
    return launches


def serve_opcheck() -> None:
    """F: ``torch.library.opcheck`` on each ``llm_bci`` op on the card, at
    small shapes (the CUDA bodies: the kernels)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    lp = torch.log_softmax(torch.randn(4, 20, 8, device=dev, generator=g), -1)
    targets = torch.randint(1, 8, (4, 5), device=dev, dtype=torch.int32, generator=g)
    il = torch.tensor([20, 18, 15, 20], device=dev, dtype=torch.int32)
    tl = torch.tensor([5, 3, 0, 4], device=dev, dtype=torch.int32)
    cases = [("ctc_alpha", (lp, targets, il, tl, 0, True)),
             ("ctc_alpha_beta", (lp.clone().requires_grad_(True), targets, il, tl, 0, True))]
    for dtype, D in ((torch.bfloat16, 64), (torch.float32, 32)):
        q, k, v = (torch.randn(2, 80, 2, D, device=dev, dtype=dtype, generator=g)
                   .requires_grad_(True) for _ in range(3))
        valid = torch.ones(2, 80, device=dev, dtype=torch.int32)
        valid[1, 60:] = 0
        seed = torch.tensor([5], device=dev, dtype=torch.int32)
        args = (q, k, v, valid, seed, 80, 16, D ** -0.5, 0.2)
        cases.append(("flash_fwd", args))
        with torch.no_grad():
            out, lse = torch.ops.llm_bci.flash_fwd(*args)
        dout = torch.randn_like(out)
        cases.append(("flash_bwd", (q.detach(), k.detach(), v.detach(), valid, seed, out, lse,
                                    dout, 80, 16, D ** -0.5, 0.2)))
    for M, dtype in ((8, torch.bfloat16), (96, torch.bfloat16), (8, torch.float32)):
        x = torch.randn(M, 256, device=dev, dtype=dtype, generator=g).requires_grad_(True)
        qw = torch.randint(-127, 128, (256, 128), device=dev, dtype=torch.int8, generator=g)
        scale = torch.rand(128, device=dev, generator=g) * 0.01
        cases.append(("int8_matmul", (x, qw, scale, dtype)))
    for name, args in cases:
        torch.library.opcheck(getattr(torch.ops.llm_bci, name).default, args)
    say("serve", f"F. torch.library.opcheck passed on the card for {len(cases)} calls of "
        f"{sorted({name for name, _ in cases})}")


def serve_export_phase(power_line: str, profile=None) -> dict:
    import torch

    say("serve", f"card: {power_line}")
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for part in (lambda: serve_bci_decode(tmp, power_line, profile),
                     lambda: serve_cpu_exported(tmp, power_line),
                     lambda: serve_flagship(tmp, power_line),
                     lambda: serve_mlm(tmp, power_line)):
            add_launches(launches, part())
            gc.collect()
            torch.cuda.empty_cache()
    serve_opcheck()
    return launches


# ---------------------------------------------------------------------------
# 18. multi-device (torch.distributed) on the one card
# ---------------------------------------------------------------------------

# torch.distributed's collectives as FSDP2 (by torch version) and the port call them
MD_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_single",
                  "reduce_scatter_tensor", "reduce_scatter_single", "broadcast", "barrier")
MD_DETERMINISTIC = 1e-5        # legs A / R / B / C against the in-process trainer (bit-equal
                               # expected)
MD_ONE_GROUP = 1 << 40         # leg R: an fsdp_min_size no leaf reaches (the root group only)
MD_DATA2_RTOL = 1e-3           # leg D: 2 x 32 rows against 64 rows in one process, bf16
MD_DECODE = 8                  # leg C: greedy tokens under the plan
MD_SP_RTOL = 1e-3              # leg S: sp=2 against one process, bf16 (K / V gradients summed
                               # from two ranks' partials)
MD_SP_LAYERS = 3               # leg S2: the mlm's depth (width kept)
MD_SP_PT_STEPS = 2             # leg S5: PatchTST ctc steps (each gathers K / V of 64 x 256
                               # sequences through the host); leg D2's too
MD_RUNNING_RTOL = 1e-5         # leg D2: BatchNorm's running averages against one process's
MD_CHAIN = 4                   # legs AK, DP, SP: chain_steps (one chain an epoch)
MD_POOL_EPOCHS = 3             # legs DP / SP: epochs of CHAIN_TRAIN trials, 4 steps each
MD_BCI_CHAIN, MD_BCI_CHAIN_STEPS = 2, 4     # leg BK: chain_steps, steps
MD_T_MESH = {"data": 1, "fsdp": 1, "sp": 2, "tp": 2}     # leg T: four gloo ranks on the card
# leg D2: PatchTST ctc at data=2 without its stochastic parts (a data rank
# other than 0 draws a stream of its own, so one process could not match)
MD_PT_QUIET = ["model.encoder.attention_dropout=0.0", "model.encoder.ff_dropout=0.0",
               "model.encoder.do_mask_input=false"]


def kernel_launches() -> dict:
    """Every kernel's launches since the counters' last reset."""
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    return {"ctc_alpha_kernel": ctc_cuda.FWD_LAUNCHES,
            "ctc_alpha_beta_kernel": ctc_cuda.FUSED_LAUNCHES,
            FWD_WG: fc.FWD_LAUNCHES, DQ_WG: fc.BWD_DQ_LAUNCHES, DKV_WG: fc.BWD_DKV_LAUNCHES,
            "flash_delta_kernel": fc.BWD_DELTA_LAUNCHES, **int8_launches()}


def reset_kernel_counters() -> None:
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    ctc_cuda.reset_counters()
    fc.reset_counters()
    ic.reset_counters()


class CollectiveCounter:
    """Counts the calls of ``torch.distributed``'s collectives (FSDP2's and the
    tensor-parallel products' go through the same functions), in all and by
    the process group they name (``by_group``: ``(name, the group's
    group_name)``)."""

    def __init__(self):
        import torch.distributed as dist

        names = [n for n in MD_COLLECTIVES if hasattr(dist, n)]
        self.counts = dict.fromkeys(names, 0)
        self.by_group: dict = {}
        for name in names:
            real = getattr(dist, name)

            def spy(*args, _real=real, _name=name, **kwargs):
                self.counts[_name] += 1
                key = (_name, (kwargs.get("group") or dist.group.WORLD).group_name)
                self.by_group[key] = self.by_group.get(key, 0) + 1
                return _real(*args, **kwargs)

            setattr(dist, name, spy)

    def take(self) -> dict:
        counts, self.counts = self.counts, dict.fromkeys(self.counts, 0)
        self.by_group = {}
        return {k: v for k, v in counts.items() if v}

    def on_axes(self, mesh, axes=("sp", "tp")) -> dict:
        """The calls since the last ``take`` on each of ``axes``' groups of
        ``mesh`` (``"<axis> <collective>": calls``)."""
        ids = {mesh[a].get_group().group_name: a for a in axes}
        return {f"{ids[g]} {name}": n for (name, g), n in sorted(self.by_group.items())
                if g in ids}


def md_rank(spec_path: str) -> None:
    """One rank of phase 18 under ``torch.distributed.run``: each leg of the
    spec is ``python -m llm_bci_tpu_torch.main <argv>`` run in this process
    (``runpy``), its steps recorded; with ``"backend": "gloo"`` the group is
    started here first on the spec's device (two ranks share the one card,
    which NCCL refuses). Writes the legs' records to the spec's ``out``, or
    the traceback of a failure beside it (``.err``)."""
    import torch
    import torch.distributed as dist
    from llm_bci_tpu_torch.parallel import process

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if spec.get("backend") == "gloo":
        process.init_process(spec["device"], backend="gloo")
    counter = CollectiveCounter()
    from llm_bci_tpu_torch.ops import ctc_cuda

    ctc_shapes: list = []      # the log-probs each CTC training launch was given
    real_fused = ctc_cuda.ctc_alpha_beta_cuda

    def fused(log_probs, *args):
        ctc_shapes.append(list(log_probs.shape))
        return real_fused(log_probs, *args)

    ctc_cuda.ctc_alpha_beta_cuda = fused
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    int8_shapes: dict = {}      # "M x K x N" of each int8 product: launches
    real_int8 = ic.int8_matmul_cuda

    def int8(x, q, *args):
        key = f"{x.shape[0]}x{q.shape[0]}x{q.shape[1]}"
        int8_shapes[key] = int8_shapes.get(key, 0) + 1
        return real_int8(x, q, *args)

    ic.int8_matmul_cuda = int8
    records = {}
    try:
        md_legs(spec, records, counter, ctc_shapes, int8_shapes)
    except BaseException:
        # the traceback for torchrun()'s report (the launcher keeps only the
        # tail of the ranks' output), then the failure goes on
        with open(spec["out"].format(rank=dist.get_rank()) + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(spec["out"].format(rank=dist.get_rank()), "w") as f:
        json.dump(records, f)
    dist.destroy_process_group()


def md_legs(spec: dict, records: dict, counter, ctc_shapes: list, int8_shapes: dict) -> None:
    """``md_rank``'s legs, in order, each recorded into ``records``."""
    import runpy

    import torch
    import torch.distributed as dist
    from llm_bci_tpu_torch.models import decode_graph
    from llm_bci_tpu_torch.parallel.mesh import fsdp_groups
    from llm_bci_tpu_torch.training import distributed as tdist

    from llm_bci_tpu_torch.training import step_graph

    for leg in spec["legs"]:
        log: list = []
        ctc_shapes.clear()
        int8_shapes.clear()
        reset_kernel_counters()
        step_graph.reset_counters()
        counter.take()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with spied_trainer(log) as spy:
            sys.argv = ["llm_bci_tpu_torch.main", *leg["argv"]]
            runpy.run_module("llm_bci_tpu_torch.main", run_name="__main__", alter_sys=True)
        torch.cuda.synchronize()
        trainer = spy.trainers[-1]
        axes = counter.on_axes(trainer.mesh) if trainer.mesh is not None else {}
        rec = {"wall_s": time.perf_counter() - t0, "steps": log, "launches": kernel_launches(),
               "axis_collectives": axes, "collectives": counter.take(), "rank": dist.get_rank(),
               "world": dist.get_world_size(), "backend": dist.get_backend(),
               "mesh": {k: int(v) for k, v in trainer.mesh_sizes.items()},
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "eval": trainer.eval_history, "ctc_shapes": list(ctc_shapes),
               "int8_shapes": dict(int8_shapes),
               "flash_fallback": getattr(getattr(trainer.model, "encoder", None),
                                         "flash_fallback", None),
               "running": running_averages(trainer.model),
               "coords": dict(trainer.coords),
               "fsdp_groups": len(fsdp_groups(trainer.model, int(
                   (trainer.config.get("parallelism") or {}).get("fsdp_min_size", 1 << 20)))),
               "graph": graph_counts(), "host_batches": trainer.host_batches,
               "lr": float(trainer.config.optimizer.lr),
               "pool_bytes": (trainer.batch_cache.bytes if trainer.batch_cache is not None
                              else None)}
        if leg.get("frozen_sum"):
            rec["frozen_sum"] = frozen_checksum(trainer)
        if leg.get("step_reps"):
            rec["step_ms"] = steady_step_ms(trainer, leg["step_reps"])[0]
            rec["step_collectives"] = {k: v / (leg["step_reps"] + 3)
                                       for k, v in counter.take().items()}
        if leg.get("decode"):
            batch = bci_serving_batch(trainer.device)
            decode_graph.reset_counters()
            reset_kernel_counters()
            with trainer.unsharded(), torch.no_grad(), trainer.autocast():
                ids = trainer.model.generate(**batch, max_new_tokens=leg["decode"])
            torch.cuda.synchronize()
            rec["decode"] = {"ids": ids.cpu().tolist(), "launches": kernel_launches(),
                             "captures": decode_graph.CAPTURES, "replays": decode_graph.REPLAYS,
                             "collectives": counter.take()}
        if leg.get("lora"):
            # the LoRA factors this rank holds (each whole on every tp
            # rank) by their bytes' digest, to hold against the other ranks'
            rec["lora"] = {n: hashlib.sha1((p.to_local() if hasattr(p, "to_local") else p)
                                           .detach().cpu().numpy().tobytes()).hexdigest()
                           for n, p in trainer.model.named_parameters() if ".lora_" in n}
        if leg.get("trained_out"):
            trained = {}
            for n, p in trainer.model.named_parameters():
                if p.requires_grad:
                    whole = tdist.full_tensor(p, trainer.plan.tp_dims.get(n), trainer.plan)
                    trained[n] = whole.cpu()
            if trainer.is_main_process:
                torch.save(trained, leg["trained_out"])
        if leg.get("state_out"):
            state = trainer.whole_state()["model"]
            if trainer.is_main_process:
                torch.save(state, leg["state_out"])
        if leg.get("chain_check"):
            # after the run's state is kept: these steps train on
            rec["chain_check"] = md_chain_check(trainer, leg["chain_check"], spec["power_line"])
        records[leg["name"]] = rec
        del trainer, spy
        gc.collect()
        torch.cuda.empty_cache()


def frozen_checksum(trainer) -> list:
    """Two sums of each frozen leaf's 32-bit words (plain, and weighted by
    their position mod 1009), taken on the device, in the leaves' order: a
    leaf that changed in any bit changes them (short of a collision)."""
    import torch

    leaves = {**dict(trainer.model.named_parameters()), **dict(trainer.model.named_buffers())}
    out = []
    for name in sorted(trainer.frozen_state_keys()):
        t = local(leaves[name]).detach().contiguous().reshape(-1)
        words = t.view(torch.uint8)
        words = (words[:words.numel() // 4 * 4].view(torch.int32).to(torch.int64)
                 if words.numel() >= 4 else words.to(torch.int64))
        weight = torch.arange(words.numel(), device=words.device) % 1009 + 1
        out.append([name, int(words.sum()), int((words * weight).sum())])
    return out


def md_chain_check(trainer, K: int, power_line: str) -> dict:
    """A chained rank's checks after its run: one replayed step against the
    same step run eagerly under the same plan, bit for bit
    (``replay_against_eager``), then the step timed eager and replayed on
    one batch on the device, each with its device-busy share and host launch
    calls (``device_profile``)."""
    import torch

    items = [(None, mi, ui) for mi, ui in trainer.train_dataloader][:3]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        differ = replay_against_eager(trainer, items)
    finally:
        torch.use_deterministic_algorithms(False)
    if differ:
        raise AssertionError(f"the replayed step differs from the eager one in {differ[:8]} "
                             f"({len(differ)} in all)")
    mi, ui = items[0][1], items[0][2]
    batch = trainer.to_device(mi)
    pooled = [(trainer.to_device(mi, every_row=True), mi, ui)] * K
    eager_ms = steady_step_ms_on(trainer, batch, 10)
    eager = device_profile(lambda: [trainer.train_step(batch) for _ in range(K)],
                           f"{K} eager steps under the plan", power_line, None, K * eager_ms,
                           phase="multi")
    chain_ms = steady_chain_ms(trainer, pooled, 5)
    chained = device_profile(lambda: list(trainer.chain(pooled)),
                             f"{K} replayed steps under the plan (one chain)", power_line, None,
                             K * chain_ms, phase="multi")
    trainer.free_graphs()
    return {"differ": differ, "params": len(trainer.trainable), "eager_ms": eager_ms,
            "chain_ms": chain_ms,
            "busy": [eager["busy_ms"] / K / eager_ms, chained["busy_ms"] / K / chain_ms],
            "host_launches": [eager["host_launches"] / K, chained["host_launches"] / K]}


def running_averages(model) -> dict:
    """Each BatchNorm running average as a list (float64): a rank's, to hold
    against another's and one process's."""
    return {n: b.double().cpu().tolist() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def torchrun(tmp: str, tag: str, n: int, spec: dict, timeout: float) -> list:
    """``python -m torch.distributed.run`` of ``n`` ranks of ``md_rank`` on
    this host (a free port); each rank's records. Fails when any rank
    fails or the run outlives ``timeout``."""
    from llm_bci_tpu_torch.parallel.process import free_port

    spec = {**spec, "out": os.path.join(tmp, f"{tag}_rank{{rank}}.json")}
    path = os.path.join(tmp, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
           "--master-addr", "localhost", "--master-port", str(free_port()),
           os.path.join(REPO, "chip_smoke.py"), "--md-rank", path]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        errors = ""
        for r in range(n):
            err = spec["out"].format(rank=r) + ".err"
            if os.path.exists(err):
                with open(err) as f:
                    errors += f"\nrank {r}:\n{f.read()[-4000:]}"
        raise AssertionError(f"torchrun {tag} ({n} ranks) exited with {run.returncode}:\n"
                             f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}{errors}")
    out = []
    for r in range(n):
        with open(spec["out"].format(rank=r)) as f:
            out.append(json.load(f))
    say("multi", f"torchrun {tag}: {n} rank(s), {wall:.1f} s of wall clock with process start")
    return out


def in_process(argv: list, step_reps: int = 0, keep=None) -> tuple:
    """``llm_bci_tpu_torch.main`` in this process without a group (cuDNN
    deterministic, as the ranks): its recorded steps, its trainer, its peak
    memory in GiB and, with ``step_reps``, the ms of a steady step timed as
    the ranks time theirs. With a dict ``keep``, ``keep["trained"]`` gets the
    trainable parameters (on the host) as the run left them, before any
    timed step."""
    import runpy

    import torch

    log: list = []
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.cuda.reset_peak_memory_stats()
    try:
        with spied_trainer(log) as spy:
            saved, sys.argv = sys.argv, ["llm_bci_tpu_torch.main", *argv]
            try:
                runpy.run_module("llm_bci_tpu_torch.main", run_name="__main__", alter_sys=True)
            finally:
                sys.argv = saved
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if keep is not None:
            keep["trained"] = {n: p.detach().cpu().clone()
                               for n, p in trainer_trained(spy.trainers[-1]).items()}
        step_ms = steady_step_ms(spy.trainers[-1], step_reps)[0] if step_reps else None
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    return log, spy.trainers[-1], peak, step_ms


def losses(log: list) -> list:
    return [s["loss"] for s in log]


def check_losses(label: str, got: list, want: list, rtol: float) -> float:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{label}: losses {got.tolist()} against {want.tolist()}")
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if rel > rtol:
        raise AssertionError(f"{label}: losses {got.tolist()} against the in-process "
                             f"{want.tolist()}: relative difference {rel:.3g} > {rtol}")
    return rel


def multi_device_phase(power_line: str, profile=None) -> dict:
    import pickle

    import torch

    say("multi", f"card: {power_line}")
    launches: dict = {}
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        mat = write_mat_dataset(os.path.join(tmp, "mat"))
        write_spike_pickle(os.path.join(tmp, "spikes.pkl"))
        with open(os.path.join(tmp, "bci.pkl"), "wb") as f:
            pickle.dump({"train": bci_rows(32, seed=1), "test": bci_rows(BCI_B, seed=2)}, f)
        llama = write_llama_config(tmp, 32)
        common = ["dirs.log_dir=null", "verbosity=1", "training.save_every=null"]
        flagship = ["-c", os.path.join(REPO, "configs", "trainer_ctc_ndt1.yaml"), "-k",
                    f"data.data_dir={mat}", "training.max_steps=4", "training.eval_every=4",
                    *common]
        mlm = ["-c", os.path.join(REPO, "configs", "trainer_ssl_ndt1.yaml"), "-k",
               *MLM_OVERRIDES, f"data.data_dir={tmp}", "data.data_file=spikes.pkl",
               "training.max_steps=2", "training.eval_every=null", *common]
        bci = ["-c", os.path.join(REPO, "configs", "trainer_bci.yaml"), "-k",
               f"method.model_kwargs.llm_path={llama}", "method.model_kwargs.quantize=int8",
               "data.data_load=file", f"data.data_dir={tmp}", "data.data_file=bci.pkl",
               f"training.train_batch_size={BCI_B}", f"training.test_batch_size={BCI_B}",
               "training.max_steps=2", "training.eval_every=null", *common]
        ck = lambda leg: f"dirs.checkpoint_dir={os.path.join(tmp, 'ck' + leg)}"
        # the chained and pooled legs: the flagship on CHAIN_TRAIN trials,
        # 4 steps an epoch
        mat_pool = write_mat_dataset(os.path.join(tmp, "mat_pool"), n_train=CHAIN_TRAIN,
                                     n_test=4)
        pooled = ["-c", os.path.join(REPO, "configs", "trainer_ctc_ndt1.yaml"), "-k",
                  f"data.data_dir={mat_pool}", "training.eval_every=null", *common]
        ak = [*pooled, "training.max_steps=8", "training.num_epochs=2", "parallelism.data=1",
              "parallelism.fsdp=1"]

        # A-C: one rank, one NCCL group, the plan on trivial axes; AK / BK
        # chained under it (captured), AK1 AK unchained
        legs = [
            {"name": "A", "argv": [*flagship, ck("A"), "parallelism.data=1",
                                   "parallelism.fsdp=1"], "step_reps": 10},
            # the flagship again with every parameter in the root's one group
            {"name": "R", "argv": [*flagship, ck("R"), "parallelism.data=1", "parallelism.fsdp=1",
                                   f"parallelism.fsdp_min_size={MD_ONE_GROUP}"], "step_reps": 10},
            {"name": "B", "argv": [*mlm, ck("B"), "parallelism.data=1", "parallelism.fsdp=1"]},
            {"name": "C", "argv": [*bci, ck("C"), "parallelism.fsdp=1", "parallelism.tp=1"],
             "step_reps": 5, "decode": MD_DECODE, "frozen_sum": True,
             "trained_out": os.path.join(tmp, "C_trained.pt")},
            {"name": "AK1", "argv": [*ak, ck("AK1"), "training.chain_steps=1"],
             "trained_out": os.path.join(tmp, "AK1_trained.pt")},
            {"name": "AK", "argv": [*ak, ck("AK"), f"training.chain_steps={MD_CHAIN}"],
             "trained_out": os.path.join(tmp, "AK_trained.pt"), "chain_check": MD_CHAIN},
            {"name": "BK", "argv": [*bci, ck("BK"), "parallelism.fsdp=1", "parallelism.tp=1",
                                    f"training.max_steps={MD_BCI_CHAIN_STEPS}",
                                    f"training.chain_steps={MD_BCI_CHAIN}"],
             "frozen_sum": True},
        ]
        rank_a_c = torchrun(tmp, "A-C", 1, {"legs": legs, "power_line": power_line},
                            timeout=900)[0]
        a, r, b, c = rank_a_c["A"], rank_a_c["R"], rank_a_c["B"], rank_a_c["C"]
        for name, rec in rank_a_c.items():
            if rec["backend"] != "nccl" or rec["world"] != 1:
                raise AssertionError(f"leg {name}: {rec['backend']} group of {rec['world']}")
            add_launches(launches, {k: v for k, v in rec["launches"].items() if v})
        if a["launches"]["ctc_alpha_beta_kernel"] != 4 or a["launches"]["ctc_alpha_kernel"] < 1:
            raise AssertionError(f"leg A: CTC launches {a['launches']}")
        ref_a, trainer, peak_a, ms_a = in_process([*flagship, ck("A_ref")], step_reps=10)
        del trainer
        rel_a = check_losses("leg A", losses(a["steps"]), losses(ref_a), MD_DETERMINISTIC)
        say("multi", f"A flagship under the plan (1-rank NCCL, mesh {a['mesh']}): losses "
            f"{[round(x, 4) for x in losses(a['steps'])]}, max rel. difference to the in-process "
            f"trainer {rel_a:.3g} ({'bit-equal' if rel_a == 0 else 'not bit-equal'}); CTC "
            f"{a['launches']['ctc_alpha_beta_kernel']} fused + "
            f"{a['launches']['ctc_alpha_kernel']} alpha launches; step {a['step_ms']:.2f} ms "
            f"against {ms_a:.2f} in process (both cuDNN deterministic), collectives a step "
            f"{a['step_collectives']}; peak {a['peak_gib']:.2f} GiB against {peak_a:.2f}; "
            f"{a['wall_s']:.1f} s")
        if r["fsdp_groups"] != 0 or a["fsdp_groups"] == 0 or \
                r["launches"]["ctc_alpha_beta_kernel"] != 4:
            raise AssertionError(f"leg R: {r['fsdp_groups']} module groups (A: "
                                 f"{a['fsdp_groups']}), CTC launches {r['launches']}")
        rel_r = check_losses("leg R", losses(r["steps"]), losses(ref_a), MD_DETERMINISTIC)
        say("multi", f"R the flagship with one root group (fsdp_min_size={MD_ONE_GROUP}; A had "
            f"{a['fsdp_groups']} module groups): losses "
            f"{[round(x, 4) for x in losses(r['steps'])]}, max rel. difference to the in-process "
            f"trainer {rel_r:.3g}; step {r['step_ms']:.2f} ms, collectives a step "
            f"{r['step_collectives']}; {r['wall_s']:.1f} s")
        want_b = {FWD_WG: 10, DQ_WG: 10, DKV_WG: 10, "flash_delta_kernel": 10}
        got_b = {k: b["launches"][k] for k in want_b}
        if got_b != want_b:
            raise AssertionError(f"leg B: flash launches {got_b}, want {want_b}")
        ref_b, trainer, peak_b, _ = in_process([*mlm, ck("B_ref")])
        del trainer
        rel_b = check_losses("leg B", losses(b["steps"]), losses(ref_b), MD_DETERMINISTIC)
        say("multi", f"B mlm T=1024 under the plan: losses "
            f"{[round(x, 4) for x in losses(b['steps'])]}, max rel. difference to the "
            f"in-process trainer {rel_b:.3g}; flash launches {got_b} (5 each a step); "
            f"collectives {b['collectives']}; peak {b['peak_gib']:.2f} GiB against "
            f"{peak_b:.2f}; {b['wall_s']:.1f} s")
        want_c = {INT8_CLUSTER: 0, INT8_TILED: 2 * INT8_PER_FORWARD}
        got_c = {k: c["launches"][k] for k in want_c}
        if got_c != want_c:
            raise AssertionError(f"leg C: int8 launches {got_c}, want {want_c}")
        # one process's 2 steps, its parameters before the timed steps: leg
        # C's reference, and leg S3's
        bci_ref = {}
        ref_c, trainer, peak_c, ms_c = in_process([*bci, ck("C_ref")], step_reps=5,
                                                  keep=bci_ref)
        bci_ref.update(steps=ref_c, peak_gib=peak_c)
        rel_c = check_losses("leg C", losses(c["steps"]), losses(ref_c), MD_DETERMINISTIC)
        trained = torch.load(os.path.join(tmp, "C_trained.pt"), weights_only=True)
        diff = max((trained[n].to(p.device) - p.detach()).abs().max().item()
                   for n, p in trainer.model.named_parameters() if p.requires_grad)
        trainer.model.load_state_dict(trained, strict=False)
        batch = bci_serving_batch(trainer.device)
        with torch.no_grad(), trainer.autocast():
            ids = trainer.model.generate(**batch, max_new_tokens=MD_DECODE)
        dec = c["decode"]
        if ids.cpu().tolist() != dec["ids"] or dec["captures"] != 1:
            raise AssertionError(f"leg C: the planned decode's ids {dec['ids']} (captures "
                                 f"{dec['captures']}) against the unplanned {ids.cpu().tolist()}")
        add_launches(launches, {k: v for k, v in dec["launches"].items() if v})
        say("multi", f"C BCI int8 LoRA at 7B width under the plan (fsdp=1, tp=1 named): losses "
            f"{[round(x, 4) for x in losses(c['steps'])]}, max rel. difference to the "
            f"in-process trainer {rel_c:.3g}; trained leaves max |diff| {diff:.3g}; int8 "
            f"launches {got_c} ({INT8_PER_FORWARD} tiled a forward); step {c['step_ms']:.2f} ms "
            f"against {ms_c:.2f} in process, collectives a step {c['step_collectives']}; peak "
            f"{c['peak_gib']:.2f} GiB against {peak_c:.2f}; greedy "
            f"8 tokens under the plan, one CUDA graph ({dec['replays']} replays, collectives "
            f"{dec['collectives']}), ids equal the unplanned decode's; {c['wall_s']:.1f} s")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        report["AK"], report["BK"] = nccl_chain_legs(tmp, rank_a_c, power_line)

        pt = ["-c", trainer_yaml(tmp, "trainer_ctc_ndt1.yaml", "patchtst.yaml"), "-k",
              f"data.data_dir={mat}", f"training.train_batch_size={PATCHTST_CTC_BATCH}",
              f"training.test_batch_size={PATCHTST_CTC_BATCH}",
              f"training.max_steps={MD_SP_PT_STEPS}", f"training.eval_every={MD_SP_PT_STEPS}",
              *common]
        # D: two ranks on the one card (gloo: NCCL refuses two ranks on one
        # device), data=2, stochastic parts off so that one process can match;
        # D2 PatchTST ctc at data=2 in the same two ranks
        quiet = ["model.encoder.embedder.dropout=0.0", "model.encoder.transformer.dropout=0.0",
                 "model.encoder.smooth_and_noise.noise=false"]
        d_args = [*flagship, *quiet, "training.save_every=4"]
        d2_args = [*pt, *MD_PT_QUIET]
        data2 = ["parallelism.data=2", "parallelism.fsdp=1", "--device", "cuda:0"]
        state_out = os.path.join(tmp, "D_state.pt")
        d2_trained = os.path.join(tmp, "D2_trained.pt")
        ranks_d = torchrun(tmp, "D", 2, {"backend": "gloo", "device": "cuda:0", "legs": [
            {"name": "D", "argv": [*d_args, ck("D"), *data2], "state_out": state_out},
            {"name": "D2", "argv": [*d2_args, ck("D2"), *data2], "trained_out": d2_trained},
            *pool_legs("D", pooled, data2, tmp, ck)]}, timeout=900)
        d0, d1 = ranks_d[0]["D"], ranks_d[1]["D"]
        if losses(d0["steps"]) != losses(d1["steps"]) or d0["mesh"]["data"] != 2:
            raise AssertionError(f"leg D: ranks disagree: {losses(d0['steps'])} / "
                                 f"{losses(d1['steps'])}, mesh {d0['mesh']}")
        for rec in (d0, d1):
            if rec["launches"]["ctc_alpha_beta_kernel"] != 4:
                raise AssertionError(f"leg D: CTC launches {rec['launches']}")
        for rank in ranks_d:
            for rec in rank.values():
                add_launches(launches, {k: v for k, v in rec["launches"].items() if v})
        ref_d, trainer, _, _ = in_process([*d_args, ck("D_ref")])
        rel_d = check_losses("leg D", losses(d0["steps"]), losses(ref_d), MD_DATA2_RTOL)
        say("multi", f"D flagship data=2 on two gloo ranks of the one card: losses "
            f"{[round(x, 4) for x in losses(d0['steps'])]} against one process at B=64 "
            f"{[round(x, 4) for x in losses(ref_d)]}: max rel. difference {rel_d:.3g} (<= "
            f"{MD_DATA2_RTOL}); collectives {d0['collectives']}; {d0['wall_s']:.1f} s (gloo "
            "stages through the host: no speed figure)")

        # E: D's rank-0 checkpoint resumed in one process on the card
        t0 = time.perf_counter()
        step = trainer.resume_from(os.path.join(tmp, "ckD", trainer.config.savestring,
                                                "train_state"))
        saved = torch.load(state_out, weights_only=True)
        live = trainer.model.state_dict()
        unequal = [k for k, v in saved.items() if not torch.equal(live[k].cpu(), v)]
        if step != 4 or unequal or set(saved) != set(live):
            raise AssertionError(f"leg E: resumed step {step}, unequal leaves {unequal[:5]}")
        say("multi", f"E D's rank-0 checkpoint resumed in one process: step {step}, "
            f"{len(saved)} leaves bit-equal to the two ranks' final state "
            f"({time.perf_counter() - t0:.1f} s)")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        report["D2"] = patchtst_data_parallel_leg(ranks_d, d2_args, d2_trained, ck)
        report["DP"] = check_pool_legs("D", ranks_d, tmp)

        # F: the port's dry run entry point at its default, one rank a card
        from llm_bci_tpu_torch.entry import dryrun_multichip

        t0 = time.perf_counter()
        dry = dryrun_multichip(1)
        if "dryrun_multichip(1) OK" not in dry:
            raise AssertionError(f"leg F: dryrun_multichip(1) printed {dry!r}")
        say("multi", f"F {dry.strip()} (NCCL on cuda:0, {time.perf_counter() - t0:.1f} s)")

        itr = ["-c", trainer_yaml(tmp, "trainer_ctc_ndt1.yaml", "itransformer.yaml"), "-k",
               f"data.data_dir={mat}", "model.encoder.embed_region=false",
               "training.max_steps=4", "training.eval_every=4", *common]
        report["S"] = sequence_parallel_legs(
            tmp, {"flagship": flagship, "mlm": mlm, "bci": bci, "itr": itr, "pt": pt,
                  "pooled": pooled}, bci_ref, ck, launches)
        report["T"] = sequence_tensor_parallel_leg(tmp, bci, bci_ref, ck, launches, power_line)
        report = {**report, "A": {"step_ms": a["step_ms"], "in_process_step_ms": ms_a,
                        "peak_gib": a["peak_gib"], "in_process_peak_gib": peak_a, "rel": rel_a,
                        "collectives_a_step": a["step_collectives"], "wall_s": a["wall_s"]},
                  "R": {"step_ms": r["step_ms"], "rel": rel_r, "wall_s": r["wall_s"],
                        "collectives_a_step": r["step_collectives"]},
                  "B": {"peak_gib": b["peak_gib"], "in_process_peak_gib": peak_b, "rel": rel_b,
                        "wall_s": b["wall_s"], "collectives": b["collectives"]},
                  "C": {"step_ms": c["step_ms"], "in_process_step_ms": ms_c,
                        "peak_gib": c["peak_gib"], "in_process_peak_gib": peak_c, "rel": rel_c,
                        "collectives_a_step": c["step_collectives"], "wall_s": c["wall_s"]},
                  "D": {"rel": rel_d, "wall_s": d0["wall_s"], "collectives": d0["collectives"]}}
    print(json.dumps({"multi_device": report, "card": power_line}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def trainer_trained(trainer) -> dict:
    """The trainer's trainable parameters by name."""
    return {n: p for n, p in trainer.model.named_parameters() if p.requires_grad}


def worst_leaves(trained: dict, want: dict, n: int = 3) -> list:
    """The ``n`` leaves of ``want`` farthest from ``trained``'s by relative
    L2, ``[(name, relative L2), ...]``, the farthest first."""
    rel = []
    for name, p in want.items():
        w = p.detach().float()
        d = float((trained[name].to(w.device).float() - w).norm())
        rel.append((name, d / max(float(w.norm()), 1e-30)))
    return sorted(rel, key=lambda item: -item[1])[:n]


def params_rel(trained: dict, want: dict) -> tuple:
    """``(|a - b| / |b|, max |a - b|)`` over every tensor of ``want`` against
    the whole tensors ``trained`` (one flattened vector)."""
    num = den = 0.0
    worst = 0.0
    for n, p in want.items():
        d = trained[n].to(p.device).float() - p.detach().float()
        num += float(d.square().sum())
        den += float(p.detach().float().square().sum())
        worst = max(worst, float(d.abs().max()))
    return math.sqrt(num / den), worst


def sequence_parallel_legs(tmp: str, argv: dict, bci_ref: dict, ck, launches: dict) -> dict:
    """Leg S of phase 18: ``sp=2`` on two gloo ranks of the one card, one
    ``torchrun`` for all its legs: S1 the flagship, S2 the mlm at T=1024, S3
    the BCI int8 LoRA fine-tune at Llama-2-7B width (leg C's model, held
    against leg C's in-process reference), S4 iTransformer ``ctc`` and S5
    PatchTST ``ctc`` at their phases' widths; each against one process in
    this one."""
    import torch

    t0 = time.perf_counter()
    sp = ["parallelism.data=1", "parallelism.fsdp=1", "parallelism.sp=2"]
    s2_args = [*argv["mlm"], f"model.encoder.transformer.n_layers={MD_SP_LAYERS}"]
    legs = {"S1": argv["flagship"], "S2": s2_args, "S3": argv["bci"], "S4": argv["itr"],
            "S5": argv["pt"]}
    trained_out = {name: os.path.join(tmp, f"{name}_trained.pt")
                   for name in ("S1", "S3", "S4", "S5")}
    sp_args = [*sp, "--device", "cuda:0"]
    ranks = torchrun(tmp, "S", 2, {"backend": "gloo", "device": "cuda:0", "legs": [
        *({"name": name, "argv": [*args, ck(name), *sp_args],
           **({"trained_out": trained_out[name]} if name in trained_out else {})}
          for name, args in legs.items()),
        *pool_legs("S", argv["pooled"], sp_args, tmp, ck)]}, timeout=1200)
    flash = (FWD_WG, DQ_WG, DKV_WG, "flash_delta_kernel")
    for rank, rec in enumerate(ranks):
        s1, s2, s3 = rec["S1"], rec["S2"], rec["S3"]
        if any(rec[name]["mesh"]["sp"] != 2 for name in legs):
            raise AssertionError(f"leg S: rank {rank} meshes "
                                 f"{ {name: rec[name]['mesh'] for name in legs} }")
        # one fused CTC launch a step on the gathered log-probs, one alpha
        # launch for the eval, on every rank
        if s1["launches"]["ctc_alpha_beta_kernel"] != 4 or \
                s1["launches"]["ctc_alpha_kernel"] != 1 or \
                s1["ctc_shapes"] != [[B, T, V]] * 4:
            raise AssertionError(f"leg S1 rank {rank}: CTC launches {s1['launches']}, "
                                 f"shapes {s1['ctc_shapes']}")
        if any(step["preds_shape"] != [B, T, V] for step in s1["steps"]):
            raise AssertionError(f"leg S1 rank {rank}: the metric fns' preds "
                                 f"{[step['preds_shape'] for step in s1['steps']]}")
        got = {k: s2["launches"][k] for k in flash}
        if any(got.values()) or "sequence-parallel" not in (s2["flash_fallback"] or ""):
            raise AssertionError(f"leg S2 rank {rank}: flash launches {got}, fallback "
                                 f"{s2['flash_fallback']!r}")
        # the whole Llama on every rank: each forward's int8 products
        want3 = {INT8_CLUSTER: 0, INT8_TILED: 2 * INT8_PER_FORWARD}
        if {k: s3["launches"][k] for k in want3} != want3:
            raise AssertionError(f"leg S3 rank {rank}: int8 launches {s3['launches']}, want "
                                 f"{want3}")
        for name in legs:
            add_launches(launches, {k: v for k, v in rec[name]["launches"].items() if v})
    for name in legs:
        if losses(ranks[0][name]["steps"]) != losses(ranks[1][name]["steps"]):
            raise AssertionError(f"leg {name}: the two sp ranks' losses differ: "
                                 f"{losses(ranks[0][name]['steps'])} / "
                                 f"{losses(ranks[1][name]['steps'])}")
    s1, s2, s3, s4, s5 = (ranks[0][name] for name in legs)
    peaks = lambda name: " / ".join(f"{r[name]['peak_gib']:.2f}" for r in ranks)
    report = {}

    ref1, trainer, peak1, _ = in_process([*argv["flagship"], ck("S1_ref")])
    rel1 = check_losses("leg S1", losses(s1["steps"]), losses(ref1), MD_SP_RTOL)
    rel_p, worst = params_rel(torch.load(trained_out["S1"], weights_only=True),
                              trainer_trained(trainer))
    if not rel_p <= MD_SP_RTOL:
        raise AssertionError(f"leg S1: trained parameters {rel_p:.3g} from one process's "
                             f"(> {MD_SP_RTOL})")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    say("multi", f"S1 flagship sp=2 on two gloo ranks of the one card (T=512 bins, T'=121: "
        "frames 61 / 60, noise and dropout on): losses "
        f"{[round(x, 4) for x in losses(s1['steps'])]} against one process "
        f"{[round(x, 4) for x in losses(ref1)]}: max rel. difference {rel1:.3g}; trained "
        f"parameters {rel_p:.3g} (relative L2; max |diff| {worst:.3g}) (<= {MD_SP_RTOL}); "
        f"ctc_alpha_beta_kernel 4 a rank on {s1['ctc_shapes'][0]}, ctc_alpha_kernel 1 a rank; "
        f"the CER fns read preds {s1['steps'][0]['preds_shape']}; collectives "
        f"{s1['collectives']}; peak {peaks('S1')} GiB a rank against {peak1:.2f} in one "
        f"process; {s1['wall_s']:.1f} s (gloo: no speed)")
    report["S1"] = {"rel": rel1, "params_rel": rel_p, "params_max_abs": worst,
                    "peak_gib": [r["S1"]["peak_gib"] for r in ranks],
                    "in_process_peak_gib": peak1, "collectives": s1["collectives"],
                    "wall_s": s1["wall_s"]}

    ref2, trainer, peak2, _ = in_process(
        [*s2_args, ck("S2_ref"), "model.encoder.transformer.flash_attention=off"])
    del trainer
    rel2 = check_losses("leg S2", losses(s2["steps"]), losses(ref2), MD_SP_RTOL)
    say("multi", f"S2 mlm T=1024 sp=2 ({MD_SP_LAYERS} layers x 1024): losses "
        f"{[round(x, 4) for x in losses(s2['steps'])]} against one process on the dense path "
        f"{[round(x, 4) for x in losses(ref2)]}: max rel. difference {rel2:.3g}; flash launches "
        f"0 a rank (dense under sp: {s2['flash_fallback']}); peak {peaks('S2')} GiB a rank "
        f"against {peak2:.2f} in one process (dense); collectives {s2['collectives']}; "
        f"{s2['wall_s']:.1f} s (gloo: no speed)")
    report["S2"] = {"rel": rel2, "peak_gib": [r["S2"]["peak_gib"] for r in ranks],
                    "in_process_peak_gib": peak2, "collectives": s2["collectives"],
                    "wall_s": s2["wall_s"]}

    # S3: leg C's in-process run is one process of the same model and data
    rel3 = check_losses("leg S3", losses(s3["steps"]), losses(bci_ref["steps"]), MD_SP_RTOL)
    rel_p3, worst3 = params_rel(torch.load(trained_out["S3"], weights_only=True),
                                bci_ref["trained"])
    if not rel_p3 <= MD_SP_RTOL:
        raise AssertionError(f"leg S3: trained parameters {rel_p3:.3g} from one process's "
                             f"(> {MD_SP_RTOL})")
    say("multi", f"S3 BCI int8 LoRA at 32 layers x Llama-2-7B width sp=2 (the flagship trunk "
        f"on 61 / 60 frames, its 1024-wide output gathered; the projector, splice and Llama "
        f"whole on each rank; LoRA dropout on): losses "
        f"{[round(x, 4) for x in losses(s3['steps'])]} against one process (leg C's) "
        f"{[round(x, 4) for x in losses(bci_ref['steps'])]}: max rel. difference {rel3:.3g}; "
        f"trained parameters {rel_p3:.3g} (relative L2; max |diff| {worst3:.3g}) (<= "
        f"{MD_SP_RTOL}); {INT8_TILED} {s3['launches'][INT8_TILED]} a rank "
        f"({INT8_PER_FORWARD} a forward), {INT8_CLUSTER} 0; collectives {s3['collectives']}; "
        f"peak {peaks('S3')} GiB a rank against {bci_ref['peak_gib']:.2f} in one process; "
        f"{s3['wall_s']:.1f} s (gloo: no speed)")
    report["S3"] = {"rel": rel3, "params_rel": rel_p3, "params_max_abs": worst3,
                    "peak_gib": [r["S3"]["peak_gib"] for r in ranks],
                    "in_process_peak_gib": bci_ref["peak_gib"],
                    "launches": {k: s3["launches"][k] for k in (INT8_TILED, INT8_CLUSTER)},
                    "collectives": s3["collectives"], "wall_s": s3["wall_s"]}

    for name, label, steps, frames in (
            ("S4", "iTransformer ctc (768 x 5, mlp embedder, max_n_bins 512: bins 256 / 256, "
                   "the first Linear row-parallel)", 4, 512),
            ("S5", f"PatchTST ctc (256 x 4, BatchNorm synced over sp, context 520: patches "
                   f"26 / 26, B={PATCHTST_CTC_BATCH})", MD_SP_PT_STEPS, 52)):
        rec = ranks[0][name]
        reset_kernel_counters()
        ref, trainer, peak, _ = in_process([*legs[name], ck(f"{name}_ref")])
        ref_launches = {k: v for k, v in kernel_launches().items() if k in CTC_KERNELS}
        rel = check_losses(f"leg {name}", losses(rec["steps"]), losses(ref), MD_SP_RTOL)
        rank0_trained = torch.load(trained_out[name], weights_only=True)
        rel_p, worst = params_rel(rank0_trained, trainer_trained(trainer))
        farthest = worst_leaves(rank0_trained, trainer_trained(trainer))
        running = running_averages(trainer.model)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        if not rel_p <= MD_SP_RTOL:
            raise AssertionError(f"leg {name}: trained parameters {rel_p:.3g} from one "
                                 f"process's (> {MD_SP_RTOL})")
        for rank, r in enumerate(ranks):
            got = {k: r[name]["launches"][k] for k in CTC_KERNELS}
            # the CTC kernels on the whole log-probs on each rank, as often as
            # one process launches them
            if got != ref_launches or got["ctc_alpha_beta_kernel"] != steps or \
                    r[name]["ctc_shapes"] != [[B, frames, V]] * steps:
                raise AssertionError(f"leg {name} rank {rank}: CTC launches {got} on "
                                     f"{r[name]['ctc_shapes']}, one process {ref_launches}")
            # BatchNorm's running averages: the same on both ranks, one
            # process's within the tolerance
            if r[name]["running"] != rec["running"] or set(rec["running"]) != set(running):
                raise AssertionError(f"leg {name}: rank {rank}'s running averages differ")
        run_rel = params_rel({k: torch.tensor(v) for k, v in rec["running"].items()},
                             {k: torch.tensor(v) for k, v in running.items()})[0] \
            if running else 0.0
        if not run_rel <= MD_SP_RTOL:
            raise AssertionError(f"leg {name}: running averages {run_rel:.3g} from one "
                                 f"process's (> {MD_SP_RTOL})")
        stats = (f"{len(running)} running averages equal on both ranks, {run_rel:.3g} from "
                 "one process's (relative L2); " if running else "")
        leaves = ", ".join(f"{n} {r:.3g}" for n, r in farthest)
        say("multi", f"{name} {label} sp=2, {steps} steps + eval: losses "
            f"{[round(x, 4) for x in losses(rec['steps'])]} against one process "
            f"{[round(x, 4) for x in losses(ref)]}: max rel. difference {rel:.3g}; trained "
            f"parameters {rel_p:.3g} (relative L2; max |diff| {worst:.3g}) (<= {MD_SP_RTOL}), "
            f"the farthest leaves (relative L2) {leaves}; "
            f"{stats}CTC launches {ref_launches} a rank as in one process, the fused one "
            f"on the whole {rec['ctc_shapes'][0]}; collectives {rec['collectives']}; peak "
            f"{peaks(name)} GiB a rank against {peak:.2f} in one process; {rec['wall_s']:.1f} s "
            "(gloo: no speed)")
        report[name] = {"rel": rel, "params_rel": rel_p, "params_max_abs": worst,
                        "farthest_leaves": farthest, "running_rel": run_rel,
                        "peak_gib": [r[name]["peak_gib"] for r in ranks],
                        "in_process_peak_gib": peak, "launches": ref_launches,
                        "collectives": rec["collectives"], "wall_s": rec["wall_s"]}
    report["SP"] = check_pool_legs("S", ranks, tmp)
    for rec in ranks:
        for name in ("SP1", "SP"):
            add_launches(launches, {k: v for k, v in rec[name]["launches"].items() if v})
    wall = time.perf_counter() - t0
    say("multi", f"S in {wall:.1f} s with the process start of its two ranks and the "
        "in-process references")
    return {**report, "wall_s": wall}


def nccl_chain_legs(tmp: str, rank: dict, power_line: str) -> tuple:
    """Legs AK and BK of phase 18, chained on one NCCL rank under the plan
    (FSDP2's module groups), each step of a chain replayed from the graph
    captured with the step's collectives: AK the flagship (``MD_CHAIN``, 8
    steps on ``CHAIN_TRAIN`` trials) against AK1, the same run unchained,
    and one replayed step against the eager one; BK the 7B-width int8
    fine-tune against leg C's unchained steps and frozen leaves."""
    import torch

    ak, ak1, bk, c = rank["AK"], rank["AK1"], rank["BK"], rank["C"]
    steps = len(ak1["steps"])
    eager_steps, captures, replays = ak["graph"]
    if (eager_steps, captures, replays) != (1, 1, steps - 1):
        raise AssertionError(f"leg AK: eager steps, captures, replays {ak['graph']}, want "
                             f"(1, 1, {steps - 1})")
    fused, fused1 = ak["launches"]["ctc_alpha_beta_kernel"], ak1["launches"][
        "ctc_alpha_beta_kernel"]
    if fused != eager_steps + captures or fused1 != steps:
        raise AssertionError(f"leg AK: ctc_alpha_beta_kernel host launches {fused} (want eager "
                             f"steps + captures = {eager_steps + captures}), {fused1} "
                             f"unchained (want {steps})")
    rel = check_losses("leg AK chained against AK1", losses(ak["steps"]), losses(ak1["steps"]),
                       CHAIN_LOSS_RTOL)
    worst = check_params("leg AK chained against AK1",
                         torch.load(os.path.join(tmp, "AK_trained.pt"), weights_only=True),
                         torch.load(os.path.join(tmp, "AK1_trained.pt"), weights_only=True),
                         noise_atol=2 * ak["lr"] * steps)
    chk = ak["chain_check"]
    say("multi", f"AK flagship chained (chain_steps {MD_CHAIN}, {steps} steps) on one NCCL rank "
        f"under FSDP2's {ak['fsdp_groups']} module groups, each chain's steps replayed from one "
        f"captured step: losses within {rel:.3g} of AK1 unchained (bit-equal: "
        f"{losses(ak['steps']) == losses(ak1['steps'])}), trained leaves within {worst:.3g}; "
        f"ctc_alpha_beta_kernel {fused} host launches = eager steps {eager_steps} + captures "
        f"{captures}, {eager_steps + replays} on the device = eager steps + replays {replays}; "
        f"one replayed step bit-equal to the eager one under the same plan (loss, "
        f"{chk['params']} parameters, AdamW moments and steps, generator); step "
        f"{chk['eager_ms']:.2f} ms eager against {chk['chain_ms']:.2f} replayed, device busy "
        f"{chk['busy'][0]:.3f} against {chk['busy'][1]:.3f}, host launch calls a step "
        f"{chk['host_launches'][0]:.0f} against {chk['host_launches'][1]:.0f}; card {power_line}")
    say("time", f"multi legs AK1 {ak1['wall_s']:.1f} s, AK {ak['wall_s']:.1f} s in the rank")

    eager_steps, captures, replays = bk["graph"]
    if (eager_steps, captures, replays) != (1, 1, MD_BCI_CHAIN_STEPS - 1):
        raise AssertionError(f"leg BK: eager steps, captures, replays {bk['graph']}")
    want = {INT8_CLUSTER: 0, INT8_TILED: INT8_PER_FORWARD * (eager_steps + captures)}
    got = {k: bk["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"leg BK: int8 host launches {got}, want {want}")
    n_ref = len(c["steps"])
    rel_b = check_losses("leg BK chained against leg C", losses(bk["steps"])[:n_ref],
                         losses(c["steps"]), CHAIN_LOSS_RTOL)
    if bk["frozen_sum"] != c["frozen_sum"] or not bk["frozen_sum"]:
        bad = [x[0] for x, y in zip(bk["frozen_sum"], c["frozen_sum"]) if x != y]
        raise AssertionError(f"leg BK: frozen leaves differ from leg C's: {bad[:5]}")
    say("multi", f"BK BCI int8 LoRA fine-tune at 32 layers x Llama-2-7B width chained "
        f"(chain_steps {MD_BCI_CHAIN}, {MD_BCI_CHAIN_STEPS} steps) on one NCCL rank: the first "
        f"{n_ref} losses within {rel_b:.3g} of leg C's unchained (bit-equal: "
        f"{losses(bk['steps'])[:n_ref] == losses(c['steps'])}); {len(bk['frozen_sum'])} frozen "
        f"leaves bit-equal to leg C's (word sums); {INT8_TILED} {got[INT8_TILED]} host launches "
        f"= {INT8_PER_FORWARD} x (eager steps {eager_steps} + captures {captures}), "
        f"{INT8_PER_FORWARD * (eager_steps + replays)} on the device; peak "
        f"{bk['peak_gib']:.2f} GiB; {bk['wall_s']:.1f} s")
    say("time", f"multi leg BK {bk['wall_s']:.1f} s in the rank")
    return ({"rel": rel, "params_max_abs": worst, "graph": ak["graph"], "launches": fused,
             **{k: v for k, v in chk.items() if k != "differ"}, "wall_s": ak["wall_s"]},
            {"rel": rel_b, "graph": bk["graph"], "launches": got, "peak_gib": bk["peak_gib"],
             "wall_s": bk["wall_s"]})


def pool_legs(tag: str, argv: list, par: list, tmp: str, ck) -> list:
    """Legs ``<tag>P1`` and ``<tag>P`` of phase 18 for ranks under ``par``:
    the flagship on ``CHAIN_TRAIN`` trials for ``MD_POOL_EPOCHS`` epochs,
    streaming and unchained, then with ``training.cache_device_batches`` and
    ``chain_steps`` ``MD_CHAIN``."""
    steps = MD_POOL_EPOCHS * CHAIN_TRAIN // B
    run = [*argv, f"training.max_steps={steps}", f"training.num_epochs={MD_POOL_EPOCHS}"]
    return [{"name": f"{tag}P1", "argv": [*run, ck(f"{tag}P1"), *par],
             "trained_out": os.path.join(tmp, f"{tag}P1_trained.pt")},
            {"name": f"{tag}P", "argv": [*run, ck(f"{tag}P"), "training.cache_device_batches=true",
                                        f"training.chain_steps={MD_CHAIN}", *par],
             "trained_out": os.path.join(tmp, f"{tag}P_trained.pt")}]


def check_pool_legs(tag: str, ranks: list, tmp: str) -> dict:
    """The pooled and chained run of :func:`pool_legs` against the
    streaming one on gloo ranks sharing the card: the same losses on every
    rank and trained leaves, bit for bit; batches copied from the host in
    the first epoch only; every step eager on the step graphs' slots (gloo's
    collectives are not captured), the CTC kernel launched once a step."""
    import torch

    steps = MD_POOL_EPOCHS * CHAIN_TRAIN // B
    first_epoch = CHAIN_TRAIN // B
    for rank, rec in enumerate(ranks):
        pooled, stream = rec[f"{tag}P"], rec[f"{tag}P1"]
        if losses(pooled["steps"]) != losses(stream["steps"]) or len(pooled["steps"]) != steps:
            raise AssertionError(f"leg {tag}P rank {rank}: losses {losses(pooled['steps'])} "
                                 f"against streaming {losses(stream['steps'])}")
        if losses(pooled["steps"]) != losses(ranks[0][f"{tag}P"]["steps"]):
            raise AssertionError(f"leg {tag}P: the ranks' losses differ")
        if pooled["host_batches"] != first_epoch or stream["host_batches"] != steps:
            raise AssertionError(f"leg {tag}P rank {rank}: {pooled['host_batches']} batches "
                                 f"from the host pooled (want {first_epoch}), "
                                 f"{stream['host_batches']} streaming (want {steps})")
        fused = {k: r["launches"]["ctc_alpha_beta_kernel"] for k, r in (("pooled", pooled),
                                                                       ("stream", stream))}
        if tuple(pooled["graph"]) != (steps, 0, 0) or fused != {"pooled": steps,
                                                                  "stream": steps}:
            raise AssertionError(f"leg {tag}P rank {rank}: eager steps, captures, replays "
                                 f"{pooled['graph']} (want ({steps}, 0, 0)), "
                                 f"ctc_alpha_beta_kernel {fused}")
    got = torch.load(os.path.join(tmp, f"{tag}P_trained.pt"), weights_only=True)
    want = torch.load(os.path.join(tmp, f"{tag}P1_trained.pt"), weights_only=True)
    unequal = [k for k, v in want.items() if not torch.equal(got[k], v)]
    if unequal or set(got) != set(want):
        raise AssertionError(f"leg {tag}P: trained leaves differ from streaming: {unequal[:5]}")
    rec = ranks[0][f"{tag}P"]
    pool = [r[f"{tag}P"]["pool_bytes"] for r in ranks]
    say("multi", f"{tag}P flagship at {rec['mesh']} on {len(ranks)} gloo ranks of the one card, "
        f"{CHAIN_TRAIN} trials, {steps} steps over {MD_POOL_EPOCHS} epochs, "
        f"cache_device_batches and chain_steps {MD_CHAIN} against streaming unchained: losses "
        f"and {len(want)} trained leaves bit-equal on every rank; batches from the host "
        f"{first_epoch} a rank against {steps}; every step eager on the step graphs' slots "
        f"(graph {rec['graph']}), ctc_alpha_beta_kernel {steps} a rank either way; the pool "
        f"{' / '.join(str(b) for b in pool)} bytes a rank ({pool[0] / 2 ** 20:.1f} MiB)")
    say("time", f"multi legs {tag}P1 {ranks[0][tag + 'P1']['wall_s']:.1f} s, {tag}P "
        f"{rec['wall_s']:.1f} s in the ranks")
    return {"pool_bytes": pool, "host_batches": [first_epoch, steps],
            "wall_s": [ranks[0][f"{tag}P1"]["wall_s"], rec["wall_s"]]}


def patchtst_data_parallel_leg(ranks: list, argv: list, trained_out: str, ck) -> dict:
    """Leg D2 of phase 18: PatchTST ``ctc`` at ``data=2`` (the two ranks'
    records of leg D's run) against one process in this one: losses, trained
    parameters, BatchNorm's running averages (the same on both ranks: the
    statistics are the global batch's) and the CTC launches on each rank's
    rows."""
    import torch

    recs = [r["D2"] for r in ranks]
    reset_kernel_counters()
    ref, trainer, peak, _ = in_process([*argv, ck("D2_ref")])
    ref_launches = {k: v for k, v in kernel_launches().items() if k in CTC_KERNELS}
    running = running_averages(trainer.model)
    rel_p, worst = params_rel(torch.load(trained_out, weights_only=True),
                              trainer_trained(trainer))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    rel = check_losses("leg D2", losses(recs[0]["steps"]), losses(ref), MD_DATA2_RTOL)
    if not rel_p <= MD_DATA2_RTOL:
        raise AssertionError(f"leg D2: trained parameters {rel_p:.3g} from one process's "
                             f"(> {MD_DATA2_RTOL})")
    rows = [[PATCHTST_CTC_BATCH // 2, 52, V]] * MD_SP_PT_STEPS     # 52 patches of 520 bins
    for rank, rec in enumerate(recs):
        got = {k: rec["launches"][k] for k in CTC_KERNELS}
        if rec["mesh"]["data"] != 2 or losses(rec["steps"]) != losses(recs[0]["steps"]):
            raise AssertionError(f"leg D2 rank {rank}: mesh {rec['mesh']}, losses "
                                 f"{losses(rec['steps'])} / {losses(recs[0]['steps'])}")
        # one fused launch a step on the rank's rows; the eval's as often as
        # one process launches them
        if got["ctc_alpha_beta_kernel"] != MD_SP_PT_STEPS or rec["ctc_shapes"] != rows or \
                not 1 <= got["ctc_alpha_kernel"] == ref_launches["ctc_alpha_kernel"]:
            raise AssertionError(f"leg D2 rank {rank}: CTC launches {got} on "
                                 f"{rec['ctc_shapes']}, one process {ref_launches}")
        if rec["running"] != recs[0]["running"] or set(rec["running"]) != set(running) or \
                len(running) != 16:
            raise AssertionError(f"leg D2: rank {rank}'s {len(rec['running'])} running "
                                 "averages differ from rank 0's or one process's set")
    run_rel = params_rel({k: torch.tensor(v) for k, v in recs[0]["running"].items()},
                         {k: torch.tensor(v) for k, v in running.items()})[0]
    if not run_rel <= MD_RUNNING_RTOL:
        raise AssertionError(f"leg D2: running averages {run_rel:.3g} from one process's "
                             f"(> {MD_RUNNING_RTOL})")
    say("multi", f"D2 PatchTST ctc data=2 on the two gloo ranks of D (256 x 4, context 520, "
        f"52 patches, B={PATCHTST_CTC_BATCH}: 32 rows a rank, dropout and patch masking off), "
        f"{MD_SP_PT_STEPS} steps + eval: losses {[round(x, 4) for x in losses(recs[0]['steps'])]}"
        f" against one process {[round(x, 4) for x in losses(ref)]}: max rel. difference "
        f"{rel:.3g}; trained parameters {rel_p:.3g} (relative L2; max |diff| {worst:.3g}) (<= "
        f"{MD_DATA2_RTOL}); the 16 running averages equal on both ranks, {run_rel:.3g} from "
        f"one process's (<= {MD_RUNNING_RTOL}); ctc_alpha_beta_kernel {MD_SP_PT_STEPS} a rank "
        f"on {rows[0]}, ctc_alpha_kernel {ref_launches['ctc_alpha_kernel']} a rank as in one "
        f"process; collectives {recs[0]['collectives']}; peak "
        f"{' / '.join(format(r['peak_gib'], '.2f') for r in recs)} "
        f"GiB a rank against {peak:.2f} in one process; {recs[0]['wall_s']:.1f} s (gloo: no "
        "speed)")
    return {"rel": rel, "params_rel": rel_p, "params_max_abs": worst, "running_rel": run_rel,
            "launches": {k: recs[0]["launches"][k] for k in CTC_KERNELS},
            "peak_gib": [r["peak_gib"] for r in recs], "in_process_peak_gib": peak,
            "collectives": recs[0]["collectives"], "wall_s": recs[0]["wall_s"]}


def tp2_int8_shares(n_layers: int, steps: int) -> dict:
    """The int8 products of the BCI's Llama-2-7B-width forwards on a rank of
    ``tp=2`` at M = 8 x 185, ``"M x K x N": launches`` over ``steps``
    forwards: the column-parallel q / k / v and gate / up keep half their
    output features, the row-parallel o and down half their input features,
    ``lm_head`` stays whole."""
    H, I, V_ = (LLAMA2_7B[k] for k in ("hidden_size", "intermediate_size", "vocab_size"))
    M = BCI_B * BCI_PROMPT
    out: dict = {}
    for (k, n), per_forward in (((H, H // 2), 3 * n_layers), ((H // 2, H), n_layers),
                                ((H, I // 2), 2 * n_layers), ((I // 2, H), n_layers),
                                ((H, V_), 1)):
        key = f"{M}x{k}x{n}"          # at small widths two products can share a shape
        out[key] = out.get(key, 0) + per_forward * steps
    return out


def sequence_tensor_parallel_leg(tmp: str, bci: list, bci_ref: dict, ck, launches: dict,
                                 power_line: str) -> dict:
    """Leg T of phase 18: the BCI of leg C (32 layers x Llama-2-7B width,
    int8 base, LoRA dropout on) at ``sp=2 x tp=2`` on four gloo ranks of the
    one card, 2 steps, against leg C's in-process run: the trunk under
    ``sp``, the Llama cut over ``tp``, each rank's int8 products at the
    ``tp=2`` shares. Prints each rank's peak memory, ``sp`` and ``tp``
    collective calls and wall time in a JSON line of its own."""
    import torch

    mesh = [f"parallelism.{k}={v}" for k, v in MD_T_MESH.items()]
    trained_out = os.path.join(tmp, "T_trained.pt")
    t0 = time.perf_counter()
    ranks = [r["T"] for r in torchrun(tmp, "T", 4, {"backend": "gloo", "device": "cuda:0", "legs": [
        {"name": "T", "argv": [*bci, ck("T"), *mesh, "--device", "cuda:0"],
         "trained_out": trained_out, "lora": True}]}, timeout=900)]
    wall = time.perf_counter() - t0
    want = {INT8_CLUSTER: 0, INT8_TILED: 2 * INT8_PER_FORWARD}
    shares = tp2_int8_shares(LLAMA2_7B["num_hidden_layers"], 2)
    cells = set()
    for rank, rec in enumerate(ranks):
        got = {k: rec["launches"][k] for k in want}
        if rec["mesh"] != MD_T_MESH or got != want or rec["int8_shapes"] != shares:
            raise AssertionError(f"leg T rank {rank}: mesh {rec['mesh']}, int8 launches {got} "
                                 f"(want {want}) on {rec['int8_shapes']} (want {shares})")
        if losses(rec["steps"]) != losses(ranks[0]["steps"]):
            raise AssertionError(f"leg T: rank {rank}'s losses {losses(rec['steps'])} differ "
                                 f"from rank 0's {losses(ranks[0]['steps'])}")
        # every LoRA factor whole and the same on every rank (the two tp
        # ranks of each sp index, and the sp ranks)
        if not rec["lora"] or rec["lora"] != ranks[0]["lora"]:
            raise AssertionError(f"leg T: rank {rank}'s LoRA factors differ from rank 0's")
        if not rec["axis_collectives"].get("tp all_reduce") or \
                not rec["axis_collectives"].get("sp all_gather"):
            raise AssertionError(f"leg T rank {rank}: collectives on the axes "
                                 f"{rec['axis_collectives']}")
        cells.add((rec["coords"]["sp"], rec["coords"]["tp"]))
        add_launches(launches, {k: v for k, v in rec["launches"].items() if v})
    if cells != {(0, 0), (0, 1), (1, 0), (1, 1)}:
        raise AssertionError(f"leg T: the ranks' (sp, tp) {sorted(cells)}")
    rel = check_losses("leg T", losses(ranks[0]["steps"]), losses(bci_ref["steps"]), MD_SP_RTOL)
    rel_p, worst = params_rel(torch.load(trained_out, weights_only=True), bci_ref["trained"])
    if not rel_p <= MD_SP_RTOL:
        raise AssertionError(f"leg T: trained parameters {rel_p:.3g} from one process's "
                             f"(> {MD_SP_RTOL})")
    per_rank = [{"rank": r["rank"], "coords": r["coords"], "peak_gib": r["peak_gib"],
                 "axis_collectives": r["axis_collectives"], "wall_s": r["wall_s"]}
                for r in ranks]
    print(json.dumps({"leg_T_ranks": per_rank, "card": power_line}), flush=True)
    say("multi", f"T BCI int8 LoRA at 32 layers x Llama-2-7B width sp=2 x tp=2 on four gloo "
        f"ranks of the one card (the trunk on 61 / 60 frames, its output gathered over sp; q / "
        f"k / v / gate / up / o / down cut over tp, lm_head whole; LoRA dropout on), 2 steps: "
        f"losses {[round(x, 4) for x in losses(ranks[0]['steps'])]} against one process (leg "
        f"C's) {[round(x, 4) for x in losses(bci_ref['steps'])]}: max rel. difference "
        f"{rel:.3g}; trained parameters {rel_p:.3g} (relative L2; max |diff| {worst:.3g}) (<= "
        f"{MD_SP_RTOL}); {INT8_TILED} {2 * INT8_PER_FORWARD} a rank at the tp=2 shares "
        f"{shares}, {INT8_CLUSTER} 0; the LoRA factors equal on all four ranks; peak "
        f"{' / '.join(format(r['peak_gib'], '.2f') for r in ranks)} GiB a rank against "
        f"{bci_ref['peak_gib']:.2f} in one process; {wall:.1f} s with the ranks' start (gloo: "
        "no speed)")
    return {"rel": rel, "params_rel": rel_p, "params_max_abs": worst,
            "launches": {k: ranks[0]["launches"][k] for k in want},
            "peak_gib": [r["peak_gib"] for r in ranks], "in_process_peak_gib": bci_ref["peak_gib"],
            "collectives": ranks[0]["collectives"], "wall_s": wall}


# ---------------------------------------------------------------------------
# training.chain_steps and training.cache_device_batches (phase 19)
# ---------------------------------------------------------------------------

CHAIN_TRAIN = 256        # legs A / D: flagship trials, 4 steps of B=64 an epoch
CHAIN_LOSS_RTOL = 1e-5   # the JAX test's tolerance (tests/test_trainer_ndt1.py, chain_steps)
CHAIN_PARAM_TOL = {"rtol": 2e-4, "atol": 1e-6}
CHAIN_MLM_LAYERS = 2     # leg C's depth (widths kept)


def graph_counts() -> tuple:
    from llm_bci_tpu_torch.training import step_graph

    return step_graph.EAGER_STEPS, step_graph.CAPTURES, step_graph.REPLAYS


def reset_chain_counters() -> None:
    from llm_bci_tpu_torch.training import step_graph

    reset_kernel_counters()
    step_graph.reset_counters()


def record_steps(trainer, log: list, extra=None) -> None:
    """Replace the trainer's metric fns by one that appends each train step's
    loss (and ``extra(model_inputs)``) to ``log``."""
    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        log.append((float(outputs["loss"]), extra(model_inputs) if extra else None))
        return 0.0

    trainer.metric_fns = {"record": record}
    trainer.eval_metric_fns = {}


# An attention key bias's gradient is rounding noise (0 in exact arithmetic):
# Adam moves such a leaf by up to lr a step whatever the gradient's size, so
# it is held to 2 * lr * steps (the rule of the multi-device phase's tests).
NOISE_ONLY = re.compile(r"attn\.key\.bias$")


def check_params(label: str, got: dict, want: dict, names=None, noise_atol: float = 0.0
                 ) -> float:
    """Every leaf of ``want`` (or those in ``names``) within
    ``CHAIN_PARAM_TOL`` of ``got``'s, a noise-only leaf within
    ``noise_atol``; returns the largest difference of the others."""
    import torch

    worst = 0.0
    for name in names or want:
        a, b = got[name].float(), want[name].float()
        diff = float((a - b).abs().max())
        if NOISE_ONLY.search(name):
            ok = diff <= noise_atol
        else:
            ok = bool(torch.allclose(a, b, **CHAIN_PARAM_TOL))
            worst = max(worst, diff)
        if not ok:
            raise AssertionError(f"{label}: {name} differs by {diff:.3g}")
    return worst


def flagship_chain_trainer(mat: str, ckpt: str, chain: int, steps: int, epochs: int,
                           dataset=None, *extra):
    """The flagship of phase 5 (``configs/trainer_ctc_ndt1.yaml``, 5 x 1024,
    bf16) on the ``CHAIN_TRAIN`` trials, ``chain_steps`` = ``chain``."""
    from llm_bci_tpu_torch import main as port_main

    args = port_main.parse_args([
        "-c", os.path.join(REPO, "configs", "trainer_ctc_ndt1.yaml"),
        "-k", f"data.data_dir={mat}", f"dirs.checkpoint_dir={ckpt}", "dirs.log_dir=null",
        "verbosity=1", f"training.max_steps={steps}", f"training.num_epochs={epochs}",
        "training.eval_every=null", "training.save_every=null",
        f"training.chain_steps={chain}", *extra])
    return port_main.build_trainer(args, dataset=dataset)


def local(t):
    """The rank's local tensor of a DTensor (FSDP2's parameters, gradients
    and moments), the tensor itself otherwise: what a step graph writes."""
    return getattr(t, "_local_tensor", t)


def trainer_snapshot(trainer) -> dict:
    """Parameters, AdamW state, gradients, generator state and step counts,
    copied (the rank's shards under a process group)."""
    opt = trainer.optimizer.state
    return {
        "params": {n: local(p).detach().clone() for n, p in zip(trainer.trainable_names,
                                                                 trainer.trainable)},
        "opt": {n: {k: local(v).clone() for k, v in opt[p].items()}
                for n, p in zip(trainer.trainable_names, trainer.trainable) if p in opt},
        "grads": {n: local(p.grad).clone() for n, p in zip(trainer.trainable_names,
                                                            trainer.trainable)
                  if p.grad is not None},
        "generator": trainer.generator.get_state(),
        "counts": (trainer.n_micro, trainer.n_updates),
    }


def restore_snapshot(trainer, snap: dict) -> None:
    """Write ``snap`` back in place (a step graph holds these addresses)."""
    import torch

    with torch.no_grad():
        for n, p in zip(trainer.trainable_names, trainer.trainable):
            local(p).copy_(snap["params"][n])
            if n in snap["grads"]:
                local(p.grad).copy_(snap["grads"][n])
            for k, v in snap["opt"].get(n, {}).items():
                local(trainer.optimizer.state[p][k]).copy_(v)
    trainer.generator.set_state(snap["generator"])
    trainer.n_micro, trainer.n_updates = snap["counts"]


def replay_against_eager(trainer, items: list) -> list:
    """One step replayed from the graph of its signature against the same
    step run eagerly from the same state, batch and generator state (the
    graph's eager first step and its capture run first): the names of what
    differs in any bit among the loss, the parameters, the AdamW moments and
    steps, and the generator's state after the step."""
    import torch

    list(trainer.chain(items[:2]))
    snap = trainer_snapshot(trainer)
    replayed = next(trainer.chain(items[2:3]))
    after = trainer_snapshot(trainer)
    restore_snapshot(trainer, snap)
    update = (trainer.n_micro + 1) % trainer.grad_accum == 0
    eager = trainer.backward(trainer.to_device(items[2][1]), update)
    trainer._advance(update)
    torch.cuda.synchronize()
    now = trainer_snapshot(trainer)
    differ = [] if torch.equal(replayed["loss"], eager["loss"]) else ["loss"]
    differ += [f"param {n}" for n, v in after["params"].items()
               if not torch.equal(v, now["params"][n])]
    differ += [f"AdamW {k} of {n}" for n, state in after["opt"].items() for k, v in state.items()
               if not torch.equal(v, now["opt"][n][k])]
    if not torch.equal(after["generator"], now["generator"]):
        differ.append("generator state")
    trainer.free_graphs()
    return differ


def steady_chain_ms(trainer, items: list, reps: int) -> float:
    """ms a step of chains over ``items`` (their graph made first)."""
    import torch

    list(trainer.chain(items))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        list(trainer.chain(items))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (reps * len(items)) * 1e3


def chain_flagship_leg(tmp: str, mat: str, power_line: str) -> tuple:
    """Leg A: the flagship with ``chain_steps: 4`` for 8 steps (2 epochs of
    one chain) against ``chain_steps: 1``; a replayed step against the same
    step run eagerly, bit for bit; the fused CTC kernel's launches
    reconciled; step times and the device-busy share of both."""
    import torch
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.training import step_graph

    steps, K = 8, 4
    runs, dataset, launches = {}, None, {}
    for chain in (1, K):
        trainer = flagship_chain_trainer(mat, os.path.join(tmp, f"a{chain}"), chain, steps, 2,
                                         dataset)
        dataset = trainer.dataset
        log: list = []
        record_steps(trainer, log)
        reset_chain_counters()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        runs[chain] = {"trainer": trainer, "losses": [l for l, _ in log],
                       "trained": {n: p.detach().clone() for n, p in
                                   trainer_trained(trainer).items()},
                       "fused": ctc_cuda.FUSED_LAUNCHES, "alpha": ctc_cuda.FWD_LAUNCHES,
                       "graph": graph_counts(), "wall": time.perf_counter() - t0,
                       "capture_s": step_graph.CAPTURE_SECONDS}
        add_launches(launches, kernel_launches())
    one, chained = runs[1], runs[K]
    eager_steps, captures, replays = chained["graph"]
    if (eager_steps, captures, replays) != (1, 1, steps - 1):
        raise AssertionError(f"leg A: eager steps, captures, replays {chained['graph']}, want "
                             f"(1, 1, {steps - 1}): two chains of {K}, one graph")
    if chained["fused"] != eager_steps + captures or one["fused"] != steps or chained["alpha"]:
        raise AssertionError(f"leg A: ctc_alpha_beta_kernel host launches {chained['fused']} "
                             f"(want eager steps + captures = {eager_steps + captures}), "
                             f"{one['fused']} unchained (want {steps})")
    rel = check_losses("leg A chained against chain_steps: 1", chained["losses"], one["losses"],
                       CHAIN_LOSS_RTOL)
    lr = float(chained["trainer"].config.optimizer.lr)
    worst = check_params("leg A chained against chain_steps: 1", chained["trained"],
                         one["trained"], noise_atol=2 * lr * steps)
    trainer = chained["trainer"]
    say("chain", f"A. flagship, chain_steps {K}, {steps} steps (two chains) in "
        f"{chained['wall']:.1f} s against {one['wall']:.1f} s unchained: losses within "
        f"{rel:.3g} (bit-equal: {chained['losses'] == one['losses']}), trained leaves within "
        f"{worst:.3g} of chain_steps: 1 (the attention key biases, rounding noise, within "
        f"2 * lr * steps); "
        f"ctc_alpha_beta_kernel {chained['fused']} host launches = eager steps {eager_steps} + "
        f"captures {captures}, {eager_steps + replays} on the device = eager steps + replays "
        f"{replays}; the capture took {chained['capture_s']:.2f} s of the host")

    items = [(None, mi, ui) for mi, ui in trainer.train_dataloader][:3]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        differ = replay_against_eager(trainer, items)
    finally:
        torch.use_deterministic_algorithms(False)
    if differ:
        raise AssertionError(f"leg A: the replayed step differs from the eager one in "
                             f"{differ[:8]} ({len(differ)} in all)")
    say("chain", f"A. one replayed step against the same step run eagerly (deterministic "
        f"algorithms): loss, {len(trainer.trainable)} parameters, their AdamW moments and "
        "steps and the generator's state bit-equal")

    # both timed on one batch on the device: the chained steps copy it into
    # the graph's slots, the eager ones read it where it lies
    eager_trainer = one["trainer"]
    batch = eager_trainer.to_device(items[0][1])
    batch_items = [(batch, items[0][1], items[0][2])] * K
    eager_ms = steady_step_ms_on(eager_trainer, batch, 10)
    eager_prof = device_profile(lambda: [eager_trainer.train_step(batch) for _ in range(K)],
                                f"{K} eager flagship steps", power_line, None, K * eager_ms,
                                phase="chain")
    chain_ms = steady_chain_ms(trainer, batch_items, 5)
    chain_prof = device_profile(lambda: list(trainer.chain(batch_items)),
                                f"{K} replayed flagship steps (one chain)", power_line, None,
                                K * chain_ms, phase="chain")
    trainer.free_graphs()
    say("chain", f"A. flagship step (B=64, T'=121, 5x1024, bf16): {eager_ms:.2f} ms eager, "
        f"{chain_ms:.2f} ms replayed; device busy {eager_prof['busy_ms'] / K / eager_ms:.3f} "
        f"against {chain_prof['busy_ms'] / K / chain_ms:.3f}; host launch calls a step "
        f"{eager_prof['host_launches'] / K:.0f} against {chain_prof['host_launches'] / K:.0f}; "
        f"card {power_line}")
    del runs, trainer, eager_trainer
    return launches, dataset


def steady_step_ms_on(trainer, batch, reps: int) -> float:
    import torch

    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def chain_cache_leg(tmp: str, mat: str, dataset, power_line: str) -> dict:
    """Leg D: the flagship chained (``chain_steps: 4``) for 3 epochs with
    ``cache_device_batches`` against the same run streaming: the same
    examples in the same order and the same losses; the cached run copies
    its first epoch's batches from the host and none after."""
    import torch

    steps, launches, runs = 12, {}, {}
    fingerprint = lambda mi: np.asarray(mi["spikes"], np.float64).sum(axis=(1, 2)).tolist()
    for cache in (False, True):
        trainer = flagship_chain_trainer(mat, os.path.join(tmp, f"d{cache}"), 4, steps, 3,
                                         dataset, f"training.cache_device_batches={cache}")
        log: list = []
        record_steps(trainer, log, fingerprint)
        reset_chain_counters()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        runs[cache] = {"log": log, "host": trainer.host_batches, "graph": graph_counts(),
                       "wall": time.perf_counter() - t0}
        add_launches(launches, kernel_launches())
        del trainer
    stream, cached = runs[False], runs[True]
    per_epoch = CHAIN_TRAIN // 64
    if [o for _, o in cached["log"]] != [o for _, o in stream["log"]]:
        raise AssertionError("leg D: the cached epochs visit other examples than streaming")
    if stream["host"] != steps or cached["host"] != per_epoch:
        raise AssertionError(f"leg D: {cached['host']} batches copied from the host with the "
                             f"cache (want {per_epoch}, the first epoch's), {stream['host']} "
                             f"streaming (want {steps})")
    rel = check_losses("leg D cached against streaming", [l for l, _ in cached["log"]],
                       [l for l, _ in stream["log"]], CHAIN_LOSS_RTOL)
    say("chain", f"D. cache_device_batches, flagship chained over 3 epochs ({steps} steps, "
        f"graph eager / captures / replays {cached['graph']}): epochs 2-3 visit the streaming "
        f"order; batches copied from the host {cached['host']} (epoch 1) against "
        f"{stream['host']}; losses within {rel:.3g} of the streaming run (bit-equal: "
        f"{[l for l, _ in cached['log']] == [l for l, _ in stream['log']]}); "
        f"{cached['wall']:.1f} s against {stream['wall']:.1f} s")
    return launches


class SeedLog:
    """Every flash dropout seed a step draws (``draw_seed`` in NDT1), copied
    on the device into ``buf`` in the order drawn: a copy that a capture
    holds, so that a replay writes its own seeds there."""

    def __init__(self, n: int):
        import torch
        from llm_bci_tpu_torch.models import ndt1

        self.ndt1, self.real, self.n = ndt1, ndt1.draw_seed, n
        self.buf = torch.zeros(n, dtype=torch.int32, device="cuda")
        self.pos = 0

        def logged(generator, device):
            seed = self.real(generator, device)
            self.buf[self.pos:self.pos + 1].copy_(seed)
            self.pos += 1
            return seed

        ndt1.draw_seed = logged

    def restore(self) -> None:
        self.ndt1.draw_seed = self.real


def trace_steps(trainer, log: SeedLog, seeds: list, masks: list) -> None:
    """After each train step of ``trainer`` (chained or single), its seeds and
    its masker's mask."""
    chain, single = trainer.chain, trainer.train_step

    def traced_chain(items):
        steps = chain(items)
        while True:
            log.pos = 0
            out = next(steps, None)
            if out is None:
                return
            seeds.append(log.buf.clone())
            masks.append(out["mask"])
            yield out

    def traced_single(batch):
        log.pos = 0
        out = single(batch)
        if log.pos != log.n:
            raise AssertionError(f"leg C: {log.pos} flash seeds drawn in a step, want {log.n}")
        seeds.append(log.buf.clone())
        masks.append(out["mask"].clone())
        return out

    trainer.chain, trainer.train_step = traced_chain, traced_single


def chain_mlm_leg(tmp: str, power_line: str) -> dict:
    """Leg C: NDT1-mlm at T=1024 (``CHAIN_MLM_LAYERS`` layers, widths kept)
    through the flash kernels with dropout 0.4 and remat, ``chain_steps: 2``
    over 4 steps against ``chain_steps: 1``: each step's flash seeds (its
    forward's and its recompute's) and masker mask differ from the other
    steps' and equal the unchained run's; the flash launches reconciled."""
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    steps, K, L = 4, 2, CHAIN_MLM_LAYERS
    write_spike_pickle(os.path.join(tmp, "spikes.pkl"))
    log = SeedLog(2 * L)         # a forward's seed and its recompute's, a layer
    runs, dataset, launches = {}, None, {}
    try:
        for chain in (1, K):
            args = port_main.parse_args([
                "-c", os.path.join(REPO, "configs", "trainer_ssl_ndt1.yaml"),
                "-k", *MLM_OVERRIDES, f"data.data_dir={tmp}", "data.data_file=spikes.pkl",
                f"model.encoder.transformer.n_layers={L}", "model.encoder.remat=true",
                f"training.max_steps={steps}", "training.num_epochs=2",
                "training.eval_every=null", "training.save_every=null",
                f"training.chain_steps={chain}",
                f"dirs.checkpoint_dir={os.path.join(tmp, f'c{chain}')}", "dirs.log_dir=null",
                "verbosity=1"])
            trainer = port_main.build_trainer(args, dataset=dataset)
            dataset = trainer.dataset
            losses_log: list = []
            record_steps(trainer, losses_log)
            seeds, masks = [], []
            trace_steps(trainer, log, seeds, masks)
            reset_chain_counters()
            trainer.train()
            torch.cuda.synchronize()
            runs[chain] = {"seeds": [s.cpu() for s in seeds], "masks": masks,
                           "losses": [l for l, _ in losses_log], "graph": graph_counts(),
                           "flash": {FWD_WG: fc.FWD_LAUNCHES, DQ_WG: fc.BWD_DQ_LAUNCHES,
                                     DKV_WG: fc.BWD_DKV_LAUNCHES,
                                     "flash_delta_kernel": fc.BWD_DELTA_LAUNCHES}}
            add_launches(launches, kernel_launches())
            del trainer
    finally:
        log.restore()
    one, chained = runs[1], runs[K]
    eager_steps, captures, replays = chained["graph"]
    if eager_steps + replays != steps or captures != 1:
        raise AssertionError(f"leg C: eager steps, captures, replays {chained['graph']}")
    host = eager_steps + captures
    want = {FWD_WG: 2 * L * host, DQ_WG: L * host, DKV_WG: L * host,
            "flash_delta_kernel": L * host}
    if chained["flash"] != want or one["flash"][FWD_WG] != 2 * L * steps:
        raise AssertionError(f"leg C: flash host launches {chained['flash']}, want {want} "
                             f"(a forward and a recompute a layer); unchained {one['flash']}")
    for i in range(steps):
        s, e = chained["seeds"][i], one["seeds"][i]
        if not torch.equal(s, e) or not torch.equal(chained["masks"][i], one["masks"][i]):
            raise AssertionError(f"leg C: step {i + 1}'s seeds {s.tolist()} / mask differ from "
                                 f"the unchained run's {e.tolist()}")
        if not torch.equal(s[L:], s[:L].flip(0)):
            raise AssertionError(f"leg C: step {i + 1}'s recompute drew seeds {s[L:].tolist()}, "
                                 f"its forward {s[:L].tolist()}")
    firsts = [tuple(s[:L].tolist()) for s in chained["seeds"]]
    if len(set(firsts)) != steps or any(torch.equal(chained["masks"][i], chained["masks"][i + 1])
                                        for i in range(steps - 1)):
        raise AssertionError(f"leg C: replays repeat their seeds {firsts} or masks")
    rel = float(np.max(np.abs(np.subtract(chained["losses"], one["losses"]))
                       / np.abs(one["losses"])))
    say("chain", f"C. NDT1-mlm T=1024, {L} x 1024, flash with dropout 0.4 and remat, chain_steps "
        f"{K}, {steps} steps (graph eager / captures / replays {chained['graph']}): every "
        f"step's flash seeds (forward = recompute) and masks differ from the others' and equal "
        f"the unchained run's; flash host launches {chained['flash']} = (eager steps + "
        f"captures) x (forward {2 * L}, dQ / dK/dV / delta {L}); losses within {rel:.3g} of "
        "the unchained run's")
    return launches


def chain_bci_leg(tmp: str, power_line: str, base) -> dict:
    """Leg B: the BCI LoRA fine-tune (32 layers at Llama-2-7B width, int8
    base) of phase 9's trainer ``base``, ``chain_steps: 2`` for 4 steps
    against ``chain_steps: 1`` from the same trainable leaves: losses and LoRA
    leaves within the chain tolerance, the frozen leaves bit-identical, the
    int8 launches reconciled; host launch calls, step ms, device-busy share
    and peak memory of both."""
    import torch
    from llm_bci_tpu_torch.config import update_config
    from llm_bci_tpu_torch.training.trainer import Trainer

    steps, K = 4, 2
    model = base.model
    trains = trainer_trained(base)
    start = {n: p.detach().clone() for n, p in trains.items()}
    frozen = {k: v.clone() for k, v in model.state_dict().items() if k not in trains}
    runs, launches = {}, {}
    for chain in (1, K):
        with torch.no_grad():
            for n, p in trains.items():
                p.copy_(start[n])
        cfg = update_config(base.config, {
            "training": {"chain_steps": chain, "max_steps": steps, "eval_every": None},
            "dirs": {"checkpoint_dir": os.path.join(tmp, f"b{chain}")}})
        trainer = Trainer(cfg, model=model, dataset=base.dataset, device=base.device)
        log: list = []
        record_steps(trainer, log)
        reset_chain_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        runs[chain] = {"trainer": trainer, "losses": [l for l, _ in log],
                       "trained": {n: p.detach().clone() for n, p in trains.items()},
                       "int8": int8_launches(), "graph": graph_counts(),
                       "wall": time.perf_counter() - t0,
                       "peak": torch.cuda.max_memory_allocated() / 2 ** 30}
        add_launches(launches, kernel_launches())
    one, chained = runs[1], runs[K]
    eager_steps, captures, replays = chained["graph"]
    if (eager_steps, captures, replays) != (1, 1, steps - 1):
        raise AssertionError(f"leg B: eager steps, captures, replays {chained['graph']}")
    want = {INT8_CLUSTER: 0, INT8_TILED: INT8_PER_FORWARD * (eager_steps + captures)}
    if chained["int8"] != want or one["int8"][INT8_TILED] != INT8_PER_FORWARD * steps:
        raise AssertionError(f"leg B: int8 host launches {chained['int8']}, want {want}; "
                             f"unchained {one['int8']}")
    rel = check_losses("leg B chained against chain_steps: 1", chained["losses"], one["losses"],
                       CHAIN_LOSS_RTOL)
    lora = [n for n in one["trained"] if ".lora_" in n]
    worst = check_params("leg B LoRA leaves", chained["trained"], one["trained"], lora)
    others = max(float((chained["trained"][n] - one["trained"][n]).abs().max())
                 for n in one["trained"] if n not in lora)
    state = model.state_dict()
    changed = [k for k, v in frozen.items() if not torch.equal(state[k], v)]
    if changed:
        raise AssertionError(f"leg B: frozen leaves changed: {changed[:5]}")
    del frozen, state
    say("chain", f"B. BCI fine-tune, 32 layers x Llama-2-7B width, int8 base, chain_steps {K}, "
        f"{steps} steps: losses within {rel:.3g} of chain_steps: 1, {len(lora)} LoRA leaves "
        f"within {worst:.3g} (encoder and projector within {others:.3g}), the frozen leaves "
        f"bit-identical; {INT8_TILED} {chained['int8'][INT8_TILED]} host launches = "
        f"{INT8_PER_FORWARD} x (eager steps {eager_steps} + captures {captures}), "
        f"{INT8_PER_FORWARD * (eager_steps + replays)} on the device; peak memory "
        f"{chained['peak']:.2f} GiB chained against {one['peak']:.2f} GiB")

    # the two trainers share the model: the eager one's steps first, then
    # the chained one's, each path timed on one batch on the device
    eager, chained_trainer = one["trainer"], chained["trainer"]
    _, mi, ui = next(iter(chained_trainer.batches(chained_trainer.train_dataloader)))
    batch = eager.to_device(mi)
    items = [(batch, mi, ui)] * K
    torch.cuda.reset_peak_memory_stats()
    eager_ms = steady_step_ms_on(eager, batch, 5)
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eager_prof = device_profile(lambda: [eager.train_step(batch) for _ in range(K)],
                                f"{K} eager fine-tune steps", power_line, None, K * eager_ms,
                                phase="chain")
    torch.cuda.reset_peak_memory_stats()
    chain_ms = steady_chain_ms(chained_trainer, items, 3)
    chain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    chain_prof = device_profile(lambda: list(chained_trainer.chain(items)),
                                f"{K} replayed fine-tune steps (one chain)", power_line, None,
                                K * chain_ms, phase="chain")
    chained_trainer.free_graphs()
    say("chain", f"B. fine-tune step (B={BCI_B} x {BCI_PROMPT} tokens): {eager_ms:.1f} ms eager, "
        f"{chain_ms:.1f} ms replayed; host launch calls a step "
        f"{eager_prof['host_launches'] / K:.0f} against {chain_prof['host_launches'] / K:.0f}, "
        f"device kernels a step {eager_prof['launches'] / K:.0f} against "
        f"{chain_prof['launches'] / K:.0f}; device busy "
        f"{eager_prof['busy_ms'] / K / eager_ms:.3f} against "
        f"{chain_prof['busy_ms'] / K / chain_ms:.3f}; peak memory of steady steps "
        f"{eager_peak:.2f} GiB eager, {chain_peak:.2f} GiB with the graph ({reserved:.2f} GiB "
        f"reserved); card {power_line}")
    print(json.dumps({"chain_bci": {
        "eager_ms": eager_ms, "chain_ms": chain_ms,
        "host_launches": [eager_prof["host_launches"] / K, chain_prof["host_launches"] / K],
        "device_kernels": [eager_prof["launches"] / K, chain_prof["launches"] / K],
        "busy": [eager_prof["busy_ms"] / K / eager_ms, chain_prof["busy_ms"] / K / chain_ms],
        "peak_gib": [eager_peak, chain_peak], "reserved_gib": reserved,
        "run_peak_gib": [one["peak"], chained["peak"]]}}), flush=True)
    del runs, eager, chained_trainer
    return launches


def chain_phase(power_line: str, profile=None) -> dict:
    """Phase 19, ``training.chain_steps`` and ``training.cache_device_batches``:
    legs A, D, C, then B on phase 9's trainer (built here under ``--only
    chain``). cuDNN picks deterministic algorithms in the legs, as in the
    runs they are held against."""
    import torch

    launches: dict = {}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            t0 = time.perf_counter()
            mat = write_mat_dataset(os.path.join(tmp, "mat"), n_train=CHAIN_TRAIN, n_test=4)
            say("chain", f"{CHAIN_TRAIN} synthetic speechbci trials written in "
                f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            counts, dataset = chain_flagship_leg(tmp, mat, power_line)
            add_launches(launches, counts)
            say("time", f"chain leg A {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            add_launches(launches, chain_cache_leg(tmp, mat, dataset, power_line))
            say("time", f"chain leg D {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            add_launches(launches, chain_mlm_leg(tmp, power_line))
            say("time", f"chain leg C {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            base = KEPT.pop("bci", None)
            if base is None:
                base = build_bci_trainer(tmp, 4)
            add_launches(launches, chain_bci_leg(tmp, power_line, base))
            del base
            say("time", f"chain leg B {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = False
        KEPT.clear()
    return launches


KERNELS = {
    # name of the kernel that runs at the timed shape: (source, the TPU kernel
    # it replaces). Float32 and head sizes without a wgmma plan take other
    # kernels of the same sources (flash_fwd_kernel, flash_dq_kernel,
    # flash_dkv_kernel, int8_f32_kernel); no main path runs them.
    # the forward without a gradient (eval), and the one with it (a training
    # step: alpha and beta at once, the gradient written in the forward)
    "ctc_alpha_kernel": ("llm_bci_tpu_torch/csrc/ctc.cu", "llm_bci_tpu/ops/ctc_pallas.py:77"),
    "ctc_alpha_beta_kernel": ("llm_bci_tpu_torch/csrc/ctc.cu",
                              "llm_bci_tpu/ops/ctc_pallas.py:93"),
    FWD_WG: ("llm_bci_tpu_torch/csrc/flash_attention.cu", "llm_bci_tpu/ops/flash_attention.py:103"),
    DQ_WG: ("llm_bci_tpu_torch/csrc/flash_attention.cu", "llm_bci_tpu/ops/flash_attention.py:237"),
    DKV_WG: ("llm_bci_tpu_torch/csrc/flash_attention.cu",
             "llm_bci_tpu/ops/flash_attention.py:294"),
    # the expression that XLA fuses into one pass there
    "flash_delta_kernel": ("llm_bci_tpu_torch/csrc/flash_attention.cu",
                           "llm_bci_tpu/ops/flash_attention.py:367"),
    # one TPU kernel, two kernels of the port: M <= 64 (a decode step) and M >
    # 64 (prefill, fine-tune), timed at (K, N) = (4096, 11008)
    INT8_CLUSTER: ("llm_bci_tpu_torch/csrc/int8_matmul.cu", "llm_bci_tpu/ops/quant.py:127"),
    INT8_TILED: ("llm_bci_tpu_torch/csrc/int8_matmul.cu", "llm_bci_tpu/ops/quant.py:127"),
}


def main(only=None, profile=None) -> int:
    if not os.path.isdir(os.path.join(REPO, "llm_bci_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout (llm_bci_tpu_torch/ is missing)")
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    power_line = nvidia_smi_line()
    say("device", f"{kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvidia-smi: {power_line}")

    from llm_bci_tpu_torch.ops import _build

    # One nvcc a source, all started together.
    def timed_build(name: str):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(timed_build, name)
                  for name in ("ctc", "flash_attention", "int8_matmul")]
        for future in builds:
            lib, secs = future.result()      # a failed build raises here
            say("build", f"{os.path.relpath(lib, REPO)} built in {secs:.1f} s")

    if profile:
        os.makedirs(os.path.dirname(os.path.abspath(profile)), exist_ok=True)
        open(os.path.abspath(profile), "w").close()     # the phases append their tables
    results: dict = {}
    launches: dict = {}
    start = time.perf_counter()

    def clock(phase: str, t0: float) -> None:
        """The phase's wall clock and the run's so far (host clock, with
        its processes' start): where the time limit goes."""
        now = time.perf_counter()
        say("time", f"{phase} {now - t0:.1f} s, {now - start:.1f} s since the builds")

    for phase, run in (("ctc", lambda: kernel_phase(results)),
                       ("flash", lambda: flash_kernel_phase(results)),
                       ("int8", lambda: int8_kernel_phase(results, power_line)),
                       ("ctc-main", lambda: launches.update(main_path_phase(power_line, profile))),
                       ("mlm-main",
                        lambda: launches.update(mlm_main_path_phase(power_line, profile)))):
        if only in (None, phase):
            t0 = time.perf_counter()
            run()
            clock(phase, t0)
    if only is None:
        KEPT["keep_bci"] = True       # phase 9's trainer for the chain phase's leg B
    for phase, run in (("bci-serve", bci_serve_phase), ("bci-train", bci_train_phase),
                       ("chain", chain_phase), ("cosmooth", cosmooth_phase),
                       ("phoneme-llm", lambda p, _: phoneme_llm_phase(p)),
                       ("eval-phonemes", lambda p, _: eval_phonemes_phase(p)),
                       ("itransformer", itransformer_phase), ("patchtst", patchtst_phase),
                       ("trainer-state", trainer_state_phase),
                       ("warm-start", warm_start_phase),
                       ("serve-export", serve_export_phase),
                       ("multi-device", multi_device_phase)):
        if only in (None, phase):
            t0 = time.perf_counter()
            add_launches(launches, run(power_line, profile))
            clock(phase, t0)
            # a trainer holds reference cycles: free what the phase left, so
            # that the next phase's peak memory is its own
            gc.collect()
            torch.cuda.empty_cache()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if only is None or (name in results and name in launches):
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], **results[name],
            })
    print(power_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default=None,
                        choices=["ctc", "flash", "int8", "ctc-main", "mlm-main", "bci-serve",
                                 "bci-train", "cosmooth", "phoneme-llm", "eval-phonemes",
                                 "itransformer", "patchtst", "trainer-state", "warm-start",
                                 "serve-export", "multi-device", "chain"])
    parser.add_argument("--profile", metavar="PATH", default=None,
                        help="write the torch.profiler tables of the CTC and mlm train steps, "
                             "the BCI greedy decode, the BCI fine-tune step, a folded "
                             "co-smoothing pass and the iTransformer and PatchTST ctc steps "
                             "to PATH")
    parser.add_argument("--md-rank", metavar="SPEC", default=None,
                        help="run as one rank of phase 18 under torch.distributed.run "
                             "(the phase starts these itself)")
    cli = parser.parse_args()
    if cli.md_rank:
        sys.path.insert(0, REPO)
        md_rank(cli.md_rank)
        sys.exit(0)
    sys.exit(main(cli.only, cli.profile))
