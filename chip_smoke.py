#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase35    # phase 35 alone

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the kernels and prints the build time and each kernel's
   registers and spills (ptxas);
3. holds each kernel against its plain PyTorch version on the card: at every
   conv call of an ENet-512 batch-4 forward (recorded from the forward
   itself) and at edge cases (stride-2 stem, k2 s2, 5x1/1x5, SAME-even,
   Cin 3 and 4, Cout 4, 8 and 19, a weight slab too large to stay
   resident, every epilogue spec, d = 2, 4, 8, 16, transposed k3 Cout
   19/k4/k2/k<s and k16 with its weights streamed per plane);
4. serves one batch of 4 segmentation requests through ENet (19 classes,
   512x512, seeded random weights) with ``backend="kernels"``, checks the
   launch counters show every conv went through the two kernels (and the
   conv2d launches by variant), and holds the logits against the same
   module's ``backend="torch"`` output;
5. times the forward, each kernel per forward, the kernels' plain versions,
   one PyTorch library call per kernel (the yardstick), and the naive
   zero-laden forward, and prints a table per conv geometry (calls, ms,
   bound and what bounds it, x bound, library ms, launch plan) with the
   geometry furthest from its bound;
6. records every kernel call made inside one ENet-512 batch-4 backward of
   the loss-scaled objective the train step differentiates
   (``repro_torch.launch.train_recipes`` loss times 2^15, 19 classes) and
   holds each against its plain version at 1e-4 x max|plain| (the
   cotangents are small, so the bar has no floor), shows that a zeroed or
   a 2%-off output would fail that bar, prints the geometries and the
   variants they took, and checks that the backward ran no library conv and no plain
   version, and that its only ``torch.matmul`` calls are the weight
   gradients' tap correlations;
7. holds backward edge cases against ``backend="torch"`` autograd (cuDNN,
   TF32 off), per gradient tensor at max |err| <= 1e-4 x max(1, max|ref|):
   dx through the transposed kernel (k2 s2 p0, k3 s2 SAME, k4 s2 p1),
   5x1/1x5, a k3 s2 op1 transposed conv with Cout 19, a strided-dilated
   composition, odd-k dilated convs through their own adjoint, and every
   epilogue spec's operand gradients (dense and transposed);
8. trains ENet-512 (19 classes, batch 4, seeded weights with BN/PReLU
   redrawn as in phase 4) on ``SegDataPipeline`` batches: the launches of
   a step's forward and backward, its step-0 gradients against the torch
   backend's per tensor at 1e-4 x max(1, max|ref|) and at 2e-3 x max|ref|,
   three ``make_train_step``
   steps on both backends from one state on successive batches (losses
   agree, are finite and fall or hold), and a NaN-image step that leaves parameters and AdamW state bit-identical
   and halves the loss scale;
9. times the train step on both backends (median of 10 warm steps), the
   device's busy share of a step (``torch.profiler``), every backward
   kernel call per geometry beside its bound and library call, and the
   weight gradients' matmuls;
10. holds the matmul and flash-attention kernels against their plain
   versions at edge cases (ragged M/N/K, K not a multiple of the 64-deep
   K step, Sq != Sk both ways, Sq = 1, lengths 300 and 4097, B*H > 1, head
   dims 16 to 256, fp32, bf16 and mixed operand types), each through the
   variant its wrapper picks (bf16 ``wgmma`` on the tensor cores, else
   ``simt`` on the CUDA cores);
11. runs one layer of the port's transformer
   (``repro_torch.models.transformer.apply_layer``) at the widths of
   StableLM-2-1.6B (hf:stabilityai/stablelm-2-1_6b; d_model 2048, 32
   heads of 64, MHA, d_ff 5632) on one 4096-token prefill at batch 1, in
   fp32 and in bf16, with seeded random weights: the q/k/v projections,
   RoPE, causal attention, the output projection and the gated MLP.  It
   checks that the launch counters show every product and the attention
   went through a kernel (7 + 1), the bf16 layer's on the ``wgmma``
   variants and the fp32 layer's on ``simt``, and holds each recorded call
   against its plain version;
12. times each of those calls: the kernel, its plain version and the library
   yardstick (``torch.matmul`` in the input dtype, TF32 off;
   ``F.scaled_dot_product_attention(is_causal=True)``);
13. prints the ``{"kernels": [...]}`` line (all four kernels on their
   paths, the two conv kernels again on the ENet backward, both again
   in bf16 on the forward and the backward, both on each path of
   phases 18-23, on phase 24's tuned forwards, and kernels 3 and 4 on
   phase 25's served prefill and decode step, on phase 26's train
   step, kernels 1, 3 and 4 on phase 27's whisper-small, kernels 3
   and 4 on phase 28's Gemma-3-12B served and trained, kernel 3, its
   batched form and kernel 4 on phase 29's Qwen3-MoE-30B-A3B and
   Llama-4-Scout served, and on phase 30's trained, and kernel 3 on
   phase 31's xLSTM-1.3B and Jamba Mamba mixer) and, last, ``{"ok":
   true, "device": {...}}``;

and, before those two lines, the bf16 slice:

14. holds the bf16 forms of both conv kernels against their plain versions
   on the card, per element at 2^-7 |plain| + 1e-4 x max(1, max|plain|)
   (backward calls of the 2^15-scaled loss without the max(1, .) floor):
   every conv call of an ENet-512 batch-4 bf16 forward and of its
   backward, recorded from the runs themselves, and phase 3's edge cases in
   bf16 (stem Cin 3, Cin 4, Cout 4/8/13/19, the Cin-19 head dx, base
   pointers 2 and 8 bytes off a 16-byte boundary, a streamed weight slab,
   every epilogue spec, d = 2, 4, 8, 16, transposed k3/k4/k2/k<s/k16), and
   shows that a zeroed output and one 2% off fail that bar;
15. serves ENet-512 (batch 4, 19 classes) with ``compute_dtype="bf16"``
   and ``backend="kernels"``: 86 + 3 launches, every conv2d launch on a
   bf16 form, no plain version and no library conv, bf16 logits within
   the reference's 5% of the fp32 range (DESIGN.md §12) of the torch
   backend's bf16 logits and of the fp32 kernels' logits;
16. trains it in bf16: the launches of a step (86 + 3, 165 + 4, bf16 forms,
   no matmul but the weight gradients' tap correlations), step-0
   gradients against the torch backend's bf16 ones at 10% relative L2
   per tensor (the 81 scalar PReLU slopes, whose gradients are cancelling
   sums that bf16 rounding moves by more than that on either backend,
   together; and all 332 together), three
   ``make_train_step("enet", compute_dtype="bf16")`` steps on both
   backends (losses finite and within 5% of the fp32 run's, the step-0
   gradient norm within 10%, masters fp32), and the NaN-image skip;
17. times the bf16 forward and step on both backends, the busy share, and
   every bf16 kernel call per geometry beside its bound (2 bytes an
   element at 3.35 TB/s, or 2 x MACs at the 989 TFLOP/s bf16 peak), its
   library call in bf16 and the fp32 kernel on the same geometry.

and then the conv models of the port, each at full width with seeded
weights (BN, GroupNorm and PReLU redrawn around their init): ESPNet-512
(phase 18; 19 classes, batch 4), DCGAN-64 (19; nz 100, ngf 64, batch
128), DCGAN-128 (20), the U-Net denoiser (21; widths 256/128/64 from an
8x8 mid-block to 64x64, batch 8) and the whisper-small frontend (22; 80
mels, 3000 frames, d_model 768, batch 4).  For each, in fp32 and in bf16
where the reference takes ``compute_dtype`` (the Whisper frontend is fp32
only):

a. every kernel call of a forward and of a backward (ESPNet's and
   DCGAN-64's recipe loss scaled by 2^15, the denoiser's noise-prediction
   loss, fp32), recorded from the runs, against its plain version at
   phases 3, 6 and 14's bars, showing that a zeroed output and one 2% off
   fail them, and each run's launches as counted on the CPU (ESPNet 38 +
   3 and 39 + 3, DCGAN 0 + 4 and 4 + 3, DCGAN-128 0 + 5, denoiser 11 + 3
   and 16 + 3, Whisper 2 + 0) with no library conv, no plain version and
   no ``torch.matmul`` but the model's own (DCGAN's projection, the
   timestep MLP) and the weight gradients' tap correlations;
b. one served batch per dtype against ``backend="torch"``: fp32 at
   relative L2 1e-4, bf16 within 5% of the fp32 output's range;
c. ESPNet's and DCGAN-64's recipes (``make_train_step("espnet" /
   "dcgan")``), three steps per dtype on both backends: the launches of
   each step, finite losses agreeing at 1e-4 (fp32) and 5% (bf16), fp32
   masters, and a NaN batch skipped bit for bit; the denoiser's
   gradients against the torch backend's at phase 8's bars;
d. forward and step times on both backends, the busy share of the fp32
   forward and step, and every recorded call per geometry beside its
   bound and library call; their sums are the kernels line's entries
   ``conv2d (ESPNet-512 bf16 backward)`` etc.

and last, the served generative path (23), ``repro_torch.launch.serve_gen.
GenServer`` on the card with seeded weights (GroupNorm, BN and PReLU
redrawn as in phase 21) carried in as ``params=``:

a. a denoiser lane (widths 256/128/64 from an 8x8 mid-block, 64x64
   images), batch 8, 4 DDIM steps a tick, ``backend="kernels"``: 24
   requests cycling over 50, 25, 10 and 1 steps and the realtime,
   standard and batch classes, one cancelled in flight and one timed out.
   Each tick (counts 0 just before, read just after) launches 4 x (11 +
   3) conv kernels, 4 x 2 ``torch.matmul`` calls (the timestep MLP) and
   no library conv or plain version; every sample is held to the port's
   unbatched loop at batch 1 and to the same drain on
   ``backend="torch"`` at 1e-5 x max(1, max|ref|) (the reference's
   cross-backend bar), with what a zeroed sample and one 2% off would
   read, and one 50-step trajectory's kernels-vs-torch error is printed
   step by step;
b. the same drain at 1 step a tick (bitwise the same images, the same
   substeps, more dispatches) and with ``autoscale=True`` (max batch 16);
c. a bf16 lane: the state bf16 after every tick, samples finite and
   within 5% of the fp32 sample's range of the unbatched bf16 loop; the
   error against the torch backend's bf16 drain printed per step budget;
d. a DCGAN-64 lane (nz 100, ngf 64), batch 32, 64 requests in 2 ticks of
   0 + 4 launches: each image against the batch-1 forward of its latent at
   1e-5 x max(1, max|ref|) and the drain against ``backend="torch"`` at
   relative L2 1e-4;
e. fault drills: a broken kernels backend degrades the lane to torch
   (``degraded == 1``, samples within (a)'s bar of the clean drain); a
   kill at a mid tick restored from per-tick snapshots under
   ``chiprun_out/`` finishes bit for bit; a corrupted slot re-runs bit
   for bit.  Every other drain ends with no retry and no degraded lane;
f. times of both lanes on both backends in fp32 and bf16, each lane on
   drains of its own of several hundred denoiser or thousands of DCGAN
   requests: a saturated drain (the queue topped up to two batches before
   every tick) gives the warm images/s, substeps/s and mean tick wall; a
   paced drain (a fixed number of arrivals a tick, 75% of the lane's
   capacity) the p50/p99 latency; a backlog drain (every request queued
   before the first tick; fp32, kernels) the rates behind a long queue;
   each printed beside its request count, ticks and warm window.
   One tick's device ms and busy share (``torch.profiler``); and every
   kernel call of one tick against its plain version and per geometry
   beside its bound and library call: the kernels line's ``conv2d
   (GenServer unet_dec tick)``, ``transposed_conv2d (GenServer unet_dec
   tick)`` and ``transposed_conv2d (GenServer dcgan64 tick)``.

At start the port's plan table is pointed at a fresh, emptied
``chiprun_out/autotune/`` with tuning off (and its calibration cache at
``chiprun_out/calibration/``), so phases 1-23 run every launch on its
shape's default plan.  Last, phase 24 drives the plan table, the
calibration and the cycle model on the card:

a. every distinct kernel-1 and kernel-2 launch of an ENet-512 (batch 4),
   DCGAN-128 (batch 128) and denoiser-substep (batch 8) forward, fp32 and
   bf16, recorded from the forwards: for each plan of the full grid (7
   tiles, resident or streamed) the policy's shared-memory footprint
   (``kernels/tiling_policy.py``) equals the size the kernel asks for
   (``conv2d_smem_bytes``, ``tconv_smem_bytes``) byte for byte; every plan
   the policy admits launches and matches the plain version at phase 3's
   and 14's bars; every plan it scores inf is refused by the kernel or over
   the card's per-block shared memory;
b. autotune (``kernels/autotune.py``) of each geometry: the policy's top
   ``POLICY_TOP`` plans and the default timed on the card, the winner
   saved to the table.  Each forward then runs on the table read back from
   disk: its output against the untuned forward's at 1e-4 x max(1,
   max|untuned|) (fp32) or 5% of max|untuned| (bf16), with what a zeroed
   output and one 2% off would read; as many launches as untuned, each on
   the plan its table entry names; every tuned call against its plain
   version and per geometry beside its bound and library call (the kernels
   line's ``conv2d (tuned ENet-512 fp32 forward)`` etc.); per geometry the
   default and tuned device ms beside the bound; per forward the untuned
   and tuned wall ms; and the host's cost of a launch's plan lookup (us a
   call: the shape's plan alone, as before the table; a repeated launch's
   lookup; a geometry's first lookup in a process);
c. calibration capture (``core/calibrate.py``) of the reference's
   ``default_cases(smoke=False)`` on both backends in fp32 and bf16: the
   fit's MAPE per key, every slope positive, the fit saved; a denoiser lane
   served with it and ``scan_steps="auto"``: the K it picks (within 1..8),
   the ``est_us`` stamped on a request, every request of the drain done,
   and the cycle model's ``serve_report`` beside the measured stats; every
   24b geometry tuned again with the fit (``tune(calibration=)``: the
   policy's per-wave term weighed by the fitted dispatch overhead), each
   key's weight printed and the timed sets and winners against 24b's;
d. the paper's Figure 10 per layer: for each dilated and transposed layer
   of ENet-512 at batch 4, the cycle model's decomposed-vs-naive speedup
   (its 168-MAC array, not this card) beside the measured one: kernel 1 on
   the zero-laden operands (the zero-filled (k-1)d+1 weight; the
   zero-inserted input) over the decomposed call, device time, the two
   outputs held equal; and the totals against ``report()`` and
   ``headline()``;
e. tuning switched on (``$REPRO_TORCH_AUTOTUNE=1``) over an empty table,
   so each miss tunes inside the launch that meets it: one fp32 forward
   and backward of the denoiser's training objective (batch 8), then the
   same on the table read back with tuning off, every launch on its
   entry's plan, the loss and every gradient against the untuned ones at
   phase 8's bars, 1e-4 x max(1, max|untuned|) and 2e-3 x max|untuned|;
   and an autoscaled denoiser drain (phase
   23b's requests, batch up to 16) tuning each batch size it packs, its
   samples against the untuned autoscaled drain's at phase 23's bar (a
   tuned table is not bitwise across batch sizes: a plan's summation order
   follows its tile).

and last, phase 25 serves an LM through the port's
``repro_torch.launch.serve.Server``: StableLM-2-1.6B at its published widths
(d_model 2048, 32 heads of 64, d_ff 5632, vocab 100352, bf16), depth cut to
1 of its 24 layers (b-e; the script's time), weights drawn on the card from
a seeded CUDA generator, batch 4, a 1024-token prompt drawn from ``SEED``,
64 generated tokens:

a. the main path, counts 0 just before and read just after a prefill, a
   decode step and ``Server.generate``: each serve step launches 6 x 7 +
   1 matmuls and 6 attentions, every one ``"wgmma"``;
b. every kernel call of one prefill and one decode step (position 1024),
   recorded, against its plain version at phase 10's bf16 bar, with what
   a zeroed output and one 2% off would read;
c. the logits against ``backend="torch"`` (``torch.matmul``,
   ``F.scaled_dot_product_attention``) on the same tokens through the
   prefill and 8 teacher-forced decode steps: max |err| <= 5% of
   max|torch| (DESIGN.md §12), greedy tokens equal wherever the torch
   top-2 margin exceeds that bar;
d. the parallel prefill against the ``slow=True`` token loop: the same
   next token, caches within the reference test's 2e-2 bound;
e. per backend: prefill wall ms (time to first token), decode ms a step
   and tokens/s, the busy share of a prefill and of a decode step and the
   device ms of their copies (``torch.profiler``), peak memory; per kernel
   and shape, the device ms of one prefill and one decode step beside its
   bound and the library call (the kernels line's ``matmul (StableLM-2-1.6B
   served, batch 4: prefill)`` etc.);
f. the same model in fp32, depth cut to 1 layer: ``"simt"`` launches,
   logits against the plain path at the fp32 bar;
g. GQA, qk-norm and head dim 128: Qwen3-32B at its published widths, depth
   cut to 1 of 64 layers, one prefill and 4 decode steps with a-c's
   gates.

and last, phase 26 trains it through ``repro_torch.launch.steps.
make_train_step``: StableLM-2-1.6B at its published widths, depth cut to 1
of its 24 layers (the script's time), weights drawn on the card from a
seeded CUDA generator, bf16 with fp32
AdamW masters and moments, per-layer remat, sequence length 4096 (the
reference's ``train_4k``), global batch 4 in 2 microbatches of 2,
``LMDataPipeline(seed=SEED)`` batches, warmup 2 of 100 steps:

a. the main path, counts 0 just before one step and read just after, by
   part (forward, the remat recompute, backward: the counters read on
   entry to and exit from the backward pass and each ``MatmulFn.backward``):
   the kernel-3 and kernel-4 launches that ``lm_train_launches`` works out
   (tested on the CPU: 6 x 7 + 8 head chunks a forward, again in the
   recompute, twice that in the backward, 200 a microbatch; 12
   attentions), every one ``"wgmma"``; no library conv or attention and no
   plain version; the attention backward's own fp32 products (``bmm``,
   ``baddbmm``) and the transposes counted apart;
b. every kernel call of one microbatch's forward, recompute and backward
   against its plain version as it is made, at phase 10's bf16 bar (the
   backward's products without the max(1, .) floor), with what a zeroed
   output and one 2% off would read; the calls by part are half of a's;
c. step-0 loss, gradient norm and every gradient tensor against
   ``backend="torch"`` (``torch.matmul``, SDPA): 5%, 10% and 10% relative
   L2 (DESIGN.md §12), the worst tensor printed;
d. three steps on both backends from one state on successive batches:
   finite losses within 5%, fp32 masters, bf16 parameters, step 3;
e. ``launch.train.train`` at the reduced configuration on the card with a
   checkpoint every 2 steps and a failure injected at step 3: one
   recovery, the final step, and the resumed run's last loss and state
   equal to an uninterrupted run's bit for bit;
f. per backend: step wall ms (median of 5 warm steps), tokens/s, 6ND
   model FLOP/s against the bf16 peak, busy share and device ms by kernel
   class (``torch.profiler``), peak memory; the kernels step's pieces
   timed alone (the attention backward's recompute, the transposes,
   AdamW); every distinct kernel-3 and kernel-4 shape of the step beside
   its bound, plain version and library call: the kernels line's
   ``matmul (StableLM-2-1.6B train step forward)``, ``... backward)`` and
   ``flash_attention (StableLM-2-1.6B train step)``.

and last, phase 27 runs whisper-small's encoder-decoder
(``repro_torch.models.encdec``) at its published widths (d_model 768, 12
heads of 64, d_ff 3072, vocab 51865, encoder_ctx 1500, bf16), depth cut
from 12 + 12 to 1 + 1 layers (the script's time), weights drawn on the card
from a seeded CUDA generator:

a. the frontend on kernel 1 (fp32) turns batch 8 seeded (3000, 80)
   log-mels into (8, 1500, 768) frames: 2 conv2d launches, each call
   against its plain version, the frames against ``backend="torch"``; then
   ``Server`` with ``backend="kernels"``, counts 0 just before and read
   just after an encode (2 x 7 matmuls, 2 attentions), the 4-token
   prompt loop, a decode step (2 x 11 + 1 and 4: self and cross
   attention) and ``Server.generate(frames=)`` (224 tokens, caches of 448
   slots), every launch ``"wgmma"`` but the LM head's (N = 51865 is no
   multiple of 8: ``"simt"``);
b. every kernel call of an encode and of a decode step against its plain
   version at phase 10's bar; the encoder output and the logits of the
   prompt loop and 8 teacher-forced decode steps against
   ``backend="torch"`` within 5% of max|torch|; per backend encode ms,
   decode ms a step, tokens/s, busy shares, peak memory, and every kernel
   shape beside its bound and library call (the kernels line's ``conv2d
   (Whisper frontend, batch 8)``, ``matmul (whisper-small served, batch
   8: encode)`` etc.);
c. ``make_train_step`` at decoder sequence 448, global batch 16 in 2
   microbatches, seeded fp32 frames, fp32 AdamW, remat: phase 26's a-d
   and f (launches by part: 37 / 36 / 74 matmuls and 6 / 6 / 0
   attentions a microbatch, the head's 3 products ``"simt"``; the losses
   of 3 steps a backend within 0.1%), with tokens/s and frames/s;
d. 26e's loop drill at the reduced configuration, zero frames fed;
e. the same model in fp32 at depth 1 + 1: an encode and each serve step
   on the ``"simt"`` variants, the encoder output and the logits of the
   prompt loop and 4 decode steps against ``backend="torch"`` at 1e-4 x
   max(1, max|torch|).

and last, phase 28 runs Gemma-3-12B's sliding-window attention
(``attn_local``) at its published widths (d_model 3840, 16 heads on 8 KV
heads of 256, d_ff 15360, vocab 262144 tied, window 1024, 5 local : 1
global, qk-norm, bf16), served at 12 of its 48 layers (b; the script's
time), weights drawn on the card from a seeded CUDA generator:

a. kernel 4 with a window against its plain version at phase 10's bf16 bar:
   ``"simt"`` at Gemma's dh 256 (1 x 16 heads x 4096, window 1024, and the
   causal call without one), ``"wgmma"`` at dh 128 and 64 with windows 1024,
   100 (no tile multiple) and 1, and at 700 rows with window 200 (rows whose
   band begins mid-tile or past their q tile's first kv tile); one windowed
   launch counted for each band; a zeroed output and one 2% off shown to
   fail; the 4096-row calls timed beside their bound and SDPA with the same
   mask (windowed over causal, against the work's ratio);
b. ``make_prefill_step`` over batch 1 x 4096 tokens, counts 0 just before
   and read just after: 12 x 7 + 1 matmuls (``"wgmma"``, the tied
   262144-wide head included) and 12 attentions (``"simt"``), 10 of them
   windowed; the logits against ``backend="torch"`` (SDPA with the band)
   within 5% of max|torch|, in chunks of rows; ``Server`` at batch 4: a
   16-token prompt through the token loop, a decode step and
   ``Server.generate`` (16 tokens), as many launches a serve step and none
   windowed (the rings hold only the band); every kernel call of the prefill
   and of a decode step against its plain version as it is made; 8
   teacher-forced steps against the torch backend; per backend prefill ms,
   decode ms a step, tokens/s, busy shares and peak memory, and each kernel
   shape beside its bound and library call (the kernels line's ``matmul
   (Gemma-3-12B served: prefill)`` etc.);
c. the rings past their wrap at one pattern period (6 layers, full widths):
   batch 2, a 1040-token prompt through the token loop, then 8
   teacher-forced steps at positions 1040-1047 (1024-slot rings, wrapped by
   24), each step's logits against the torch backend's cache-free forward of
   the same tokens at b's bar;
d. training at one pattern period: seq 4096, global batch 2 in 2
   microbatches, phase 26's schedule.  A full step's peak is reckoned first
   (32 bytes a parameter with fp32 AdamW, and the update's temporaries over
   the embedding); where it exceeds the card, the step's loss and gradients
   (``make_value_and_grad``) stand in for it: 26a's gates by part (20 of the
   24 attentions windowed), 26b's calls, 26c's loss, gradient norm and every
   gradient against the torch backend, then ``FlashAttentionFn`` at Gemma's
   attention shape against SDPA's autograd with the band in place of 26d's
   steps, and 26f's times of the loss and gradients;
e. the kernels line's entries of b and d.

and last, phase 29 runs the MoE FFN (``repro_torch.models.moe``: top-k
routing, grouped capacity dispatch, a shared expert), whose experts' three
products a layer take kernel 3's batched form (``matmul_batched``, the
experts on the grid's z axis), weights drawn on the card from a seeded CUDA
generator:

a. the batched form against its plain version (fp32 ``torch.bmm``) at
   phase 10's bars, ``"wgmma"`` in bf16 and ``"simt"`` in fp32, at
   Qwen3-MoE's expert shapes at a 1 x 4096 prefill's 320 capacity rows and
   at decode's 1 ((128, 320, 2048) @ (128, 2048, 768), (128, 320, 768) @
   (128, 768, 2048), the same at M = 1) and Llama-4-Scout's (16, 320, 5120)
   @ (16, 5120, 8192), and one K = 36 case that takes ``"simt"`` in bf16;
   one batched launch counted for each; a zeroed output and one 2% off
   shown to fail; each timed beside its bound and ``torch.bmm``;
b. Qwen3-MoE-30B-A3B at its published widths (d_model 2048, 32 heads on 4
   KV heads of 128, 128 experts top-8 of 768, vocab 151936, bf16), depth cut
   to 6 of its 48 layers (the script's time):
   ``make_prefill_step`` over 1 x 4096 tokens, counts 0 just before and read
   just after: 6 x (4 + 1) + 1 two-dimensional matmuls (the 6 fp32
   routers on ``"simt"``, the rest ``"wgmma"``), 6 x 3 batched and 6
   attentions; every layer's routes recorded on both
   backends (``moe.route``), the (token, layer, slot) routes that differ
   counted and their share printed; the logits of both backends each on its
   own routes read (not gated: a swapped route is a jump no arithmetic bar
   covers), then held within 5% of max|torch| in chunks of rows against the
   torch backend run on the kernels run's routes (``route(experts=)``);
   ``Server`` at batch 4: a 16-token prompt in one parallel prefill, a
   decode step and ``Server.generate`` (16 tokens), as many launches a
   serve step; every kernel call of the prefill and of a decode step
   against its plain version as it is made; 8 teacher-forced steps held the
   same way (tokens and routes of the kernels run fed to the torch one);
   per backend prefill ms, decode ms a step, tokens/s, busy shares and peak
   memory, and each kernel shape beside its bound and library call;
c. Llama-4-Scout at its published widths (d_model 5120, 40 heads on 8 KV
   heads of 128, 16 experts top-1 of 8192 and a shared expert of 8192, vocab
   202048), depth cut to 1 of its 48 layers (107.8 B parameters need three
   cards): b's gates, a 1 x 4096 prefill through ``Server`` and 8
   teacher-forced steps at batch 1, 4 + 1 + 3 + 1 two-dimensional and 3
   batched launches;
d. the kernels line's entries of b and c: kernel 3 (``matmul``), its
   batched form (``matmul_batched``) and kernel 4.

and last, phase 30 trains the MoE (``repro_torch.models.moe`` under autograd:
the experts' products forward and backward on kernel 3's batched form,
``kernels.matmul.BatchedMatmulFn``), weights drawn on the card from a seeded
CUDA generator:

a. ``BatchedMatmulFn``'s dA = dC @ B^T and dB = A^T @ dC, one batched
   launch each, against their plain versions (fp32 ``torch.bmm`` of the
   same operands) at phase 10's bars, ``"wgmma"`` in bf16 and ``"simt"`` in
   fp32, at Qwen3-MoE's training shapes (R = 640 capacity rows: (128, 640,
   2048) @ (128, 2048, 768) and (128, 640, 768) @ (128, 768, 2048)) and
   Llama-4-Scout's ((16, 320, 5120) @ (16, 5120, 8192)); in bf16 an R and N
   whose contractions end in a partial 64-deep K tile and an R = 36 whose dB
   takes ``"simt"``; a zeroed output and one 2% off shown to fail; each
   gradient timed beside its bound, ``torch.bmm`` and its operand's
   transpose;
b. Qwen3-MoE-30B-A3B at its published widths, depth cut to 1 of 48 layers
   (the full step's peak reckoned first, over its largest leaf, an expert
   stack; one layer less while it does not fit), ``make_train_step``: seq
   4096, global batch 4 in 2 microbatches, phase 26's schedule, fp32 AdamW,
   remat.  26a's gates by part with the batched launches apart (each MoE
   layer 3 forward, 3 in the recompute, 6 backward; the fp32 routers'
   products ``"simt"``: forward, recompute, dA and dB) and every layer's
   routes in the remat recompute equal to its forward's bit for bit; 26b's
   calls, each against its plain version as it is made; 26c's loss,
   gradient norm and gradients against the torch backend run on the kernels
   run's routes (``moe_recording(force=)``, replayed in call order over the
   forward and the recompute), and the share of routes that differ when
   each backend takes its own (read, not gated); 3 steps, losses finite;
   26f's times, with the batched form, the routers' ``"simt"`` products and
   the dispatch and combine apart;
c. Llama-4-Scout at its published widths, 1 of 48 layers, batch 1 x 4096,
   ``make_value_and_grad``: b's gates, and the top-1 router's gradient
   exactly zero on both backends (its one gate is the constant 1);
d. the kernels line's entries of b and c: kernel 3's 2-D and batched
   launches forward (with the recompute) and backward, and kernel 4.

and last, phase 31 serves the recurrent mixers (``repro_torch.models.mamba``
and ``.xlstm``), every projection on kernel 3, weights drawn on the card
from a seeded CUDA generator:

a. kernel 3 against its plain version at phase 10's bars at the slice's
   shapes (``REC_CALLS``): xLSTM-1.3B's ``up_proj``, ``wq``/``wk``/``wv``
   and ``out_proj`` on ``"wgmma"``, its fp32 ``w_if``, decode products and
   recurrent ``r_gates`` on ``"simt"``, its odd-width sLSTM FFN (2730) on
   bf16 ``"simt"``, and Jamba-1.5-Large's ``in_proj``, ``x_proj``, fp32
   ``dt_proj`` and ``out_proj``; one launch on its rule's variant each; a
   zeroed output and one 2% off shown to fail;
b. xLSTM-1.3B at all 48 layers and its published widths (3.09 B
   parameters, bf16): ``make_prefill_step`` over 1 x 1024 tokens (the
   mLSTM's chunkwise form in 2 chunks, a 1,024-step sLSTM loop a layer) and
   ``Server`` at batch 4, a 32-token prompt through the token loop
   (``parallel_prefill_ok`` is false) and 32 tokens; counts 0 just before
   and read just after each (24,793 kernel-3 launches a forward, 24,648 of
   them ``"simt"``; 241 a serve step, 168 ``"simt"``); the kernels backend
   held to the torch backend layer by layer, each layer run again on the
   kernels from the torch run's recorded input x to it, its change got - x
   held to the torch run's y - x within 5% of max|y - x| plus one bf16 step
   of y (``replay_layers``; a layer that added nothing shown to fail at
   every call), over the forward and over the torch ``Server.generate``'s
   prompt loop and 31 decode steps (the replay's caches its own), and the
   head on the torch run's last hidden states; the decode forms held to the
   parallel ones the same way on the kernels backend (the forward over the
   prompts replayed as decode steps); the forward's end-to-end logits read
   and not gated (bf16 roundings of either backend grow over 48 layers and
   1,024 steps past any bar: PERF.md); every kernel call of a decode step,
   and the first of each geometry in the forward's replay, against its
   plain version; forward and prefill ms, decode ms a step, tokens/s, busy
   shares (the forward's at one pattern period over 1 x 256) and peak
   memory, and each kernel shape beside its bound and ``torch.matmul``;
c. one Mamba mixer of Jamba-1.5-Large alone at full width (d_model 8192,
   d_inner 16384, d_state 16, dt_rank 512; 0.42 B parameters):
   ``mamba_block`` over 1 x 4096 rows (8 scan chunks, 18 launches) on both
   backends, held within 5%; 16 decode steps at batch 4 from a zero cache
   against one scan over the same tokens on each backend, and the kernels
   backend against the torch backend; every kernel call against its plain
   version; ms, busy shares, peak memory and each shape beside its bound
   and ``torch.matmul``;
d. the kernels line's entries of b and c: kernel 3 in xLSTM's forward and
   decode step and in the Jamba mixer's forward and decode step.

and last, phase 32 trains the recurrent mixers (the two modules under
autograd: every product forward and backward on kernel 3 through
``MatmulFn``; the selective scan's chunks each under a checkpoint):

a. ``MatmulFn``'s dA = dC @ B^T and dB = A^T @ dC at the recurrent training
   path's new shapes (``REC_TRAIN_CALLS``): the sLSTM's recurrent product at
   batch 1 and 4 (dB contracts over K = the batch), the mLSTM's ``w_if`` (N
   = 8), Jamba's fp32 ``dt_proj`` (dB over a 512-token chunk) and the
   2730-wide sLSTM FFN on bf16 ``"simt"``; each gradient against its plain
   version at phase 10's bars on its rule's variant, a zeroed output and
   one 2% off shown to fail, each timed beside its bound, ``torch.matmul``
   and its operand's transpose;
b. xLSTM-1.3B at its published widths, depth cut to one pattern period (2
   of 48 layers: an mLSTM and an sLSTM; 326 M parameters with the untied
   embedding and head), ``make_train_step`` with fp32 AdamW and remat at 1 x
   4096 tokens (the mLSTM's 8 chunks, a 4,096-step sLSTM loop): 3 steps on
   each backend from one state, the kernels backend's first the main path
   (26a's launches by part and variant, ``recurrent_train_launches``), the
   losses within 5% step by step; the step-0 gradient norm and gradients
   end to end read, not gated (the sLSTM's backward grows ~e^(0.0041 t):
   over 4,096 steps any two implementations' gradients part), and held
   layer by layer instead: each layer's VJP from the torch run's recorded
   input and output cotangent, kernels against torch at 10% relative L2
   per gradient, the mLSTM over the whole sequence and the sLSTM over its
   first XL_REPLAY_SEQ tokens; the same weights' loss and gradients in
   fp32 on both backends, each gradient's largest error within 1e-4 of its
   largest entry at 1 x XL_WITNESS_SHORT and within 1e-4 relative L2 at
   1 x XL_WITNESS_SEQ; each distinct kernel-3 shape of the step on seeded
   operands against its plain version; step ms, tokens/s, peak memory,
   busy share and device ms by class (profiled over a 1 x
   XL_TRAIN_PROFILE_SEQ step: the profiler takes ~0.5 ms a launch to
   digest), and each shape beside its bound and ``torch.matmul``;
c. one Mamba mixer of Jamba-1.5-Large at full width, forward and backward
   over 1 x 4096 rows (8 chunks, each recomputed in the backward): launches
   by part and variant (``mixer_train_split``), the first call of each
   shape against its plain version, the gradients of x and of every leaf
   against the torch backend's at 10% relative L2, peak memory under
   ``JM_TRAIN_PEAK_GIB``; ms, busy share and each shape's times;
d. the kernels line's entries of b and c: kernel 3 forward (with the
   recomputes) and backward.

Phase 33 runs the data axis (DESIGN.md §13) on N ranks that share the one
card (``repro_torch.launch.mesh.launch``: spawned processes, gloo over CUDA
tensors; one spawn of 4 ranks runs ``repro_torch.launch.data_axis``'s jobs
in a 4-rank world, then in a 1-rank world on rank 0 beside a 2-rank world
on ranks 2-3, at the same time), on a plan table of its own
(``Smoke.da_plan_table``).  A plan can change a row's bits, and a rank's
share of a batch is another shape than the whole, which a table may give
another plan, so a share's launches take the whole batch's plan
(``autotune.whole_batch_plans``).  The phase first runs every launch
geometry of 33a's forwards and of 33c's lanes at every plan its kernel
builds, each row alone bitwise itself in the whole batch, and counts the
geometries whose plans give other bits; its table gives each whole batch
its default plan and each share of 2 and 4 ranks such a plan, so only the
pin keeps the ranks' bitwise gates:

a. ``shard_conv2d`` at ENet-512's layer shapes, batch 5 (the padding
   remainder): the 3x3 of a stage-2 bottleneck, its dilated convs at d =
   2, 4, 8, 16 (the folded phase batch split over the ranks) and the
   transposed convs of the decoder (b4.0's upsampler and the 19-class
   output head): the forward bitwise equal to the unsharded call on every
   rank and across the worlds, dx and dw within 1e-5 x max(1, max|ref|) of
   the unsharded call's, and kernel 1 or 2 launched on every rank;
b. ``make_sharded_train_step("enet", backend="kernels")``: ENet-512 (19
   classes, seeded weights with BN and PReLU redrawn as phase 4's), fp32,
   a batch of 8 in 8 virtual shards, 3 steps: parameters, AdamW state and
   losses bitwise equal on every rank of worlds 1, 2 and 4 (dense
   transport); the bf16 transport (2 ranks) within 5e-3 of the dense
   losses per step, its step-0 grad norm off the dense one by more than 0
   and at most 1e-4 of it, its parameters not the dense run's; the 1-rank
   kernels step held to the torch backend's at
   phase 8's bars (loss 1e-4, grad norm 1e-3); each rank's launches of a
   step (its chunks x (86 + 165, 3 + 4)); per-world step ms;
c. ``GenServer(mesh=)`` over the denoiser and DCGAN-64 lanes (phase 23's
   weights, batch 4, 2 DDIM steps a tick): each world's drain bitwise equal
   to the 1-rank drain on every rank; a snapshot taken at 4 ranks
   restored on 2 finishes bitwise;
d. ``FailoverPool`` of three in-process hosts on the card, one killed
   before it serves: the drain bitwise equal to one server's no-fault
   drain;

and the kernels line's entries ``conv2d (phase 33)`` and
``transposed_conv2d (phase 33)``: 33a's forwards as the 1-rank world
launches them, timed in this process beside their plain versions, bound
and library calls.

34. the model axis, in phase 33's one spawn as further worlds (``(1, 4)``
on the four ranks, then ``(2, 2)``, then ``(1, 2)`` on ranks 2-3; the
unmeshed and 1-rank references run in this process meanwhile), on phase
33's plan table (a band's launch must take the whole image's plan, which
the table gives other bits than a band's default):

a. ``shard_conv2d(spatial=True)`` at 33a's ENet-512 shapes (64x64x32
   maps: the 3x3 of b2.1, the dilated convs at d = 2, 4, 8, 16, b4.0's
   upsampler), batch 2, on ``(1, 4)`` and ``(2, 2)``: the rows in bands
   over ``model`` with exchanged halos, the forward bitwise the unsharded
   call on every rank, dx and dw within 1e-5 x max(1, max|ref|), kernel 1
   or 2 launched once on every rank at band shapes; the halo rows and
   bytes of each case;
b. ``GenServer(spatial=True)``: the denoiser lane at full widths (256/128/
   64, 64x64, phase 23's weights), batch 4, on ``(1, 2)``, ``(1, 4)`` and
   ``(2, 2)``, each drain bitwise the unmeshed drain, a ``(2, 2)``
   snapshot restored on ``(1, 2)`` bitwise;
c. the LM ``Server(mesh=)``: StableLM-2-1.6B at full width, bf16, 2 of
   its 24 layers, kernels 3 and 4 on each rank's heads, FFN and vocab
   blocks (FSDP over ``data``), on ``(1, 2)``, ``(1, 4)`` and ``(2, 2)``:
   a 4 x 1024 prefill's last logits and each layer's output, and 16
   decode steps' logits on the same seeded tokens, within 5% of max|ref|
   of the 1-rank server on the same weights; the greedy tokens of
   ``Server.generate`` and the share that agrees; each rank's parameter
   bytes against the whole;

and the entries ``conv2d (phase 34, every rank's row band)``,
``transposed_conv2d (phase 34, every rank's row band)`` (34a's band
launches of one middle band, replayed here against their plain versions
and timed) and ``matmul (phase 34c, every rank's heads)``,
``flash_attention (phase 34c, every rank's heads)`` (a ``(1, 4)`` rank's
prefill and first decode step, replayed on seeded operands).

35. the LM trained over the mesh, in phase 33's one spawn as further
worlds: first the 1-rank reference (the one-device step,
``steps.make_train_step`` without a mesh: its 3 steps on rank 0, its
first loss and gradients on ranks 1-3 at the same time; each rank keeps
the gradients to hold its own blocks to), then
``make_train_step(mesh=)``
on ``(2, 2)``, ``(1, 4)`` and ``(1, 2)`` (ranks 0-1), each rank holding
its blocks of the parameters and the AdamW state (FSDP over ``data``,
heads, FFN and vocab over ``model``; every product on kernel 3 and every
attention on kernel 4, on the rank's blocks and heads):
StableLM-2-1.6B at full width, 2 of its 24 layers, bf16 with fp32 AdamW,
3 steps of a 4 x 4096 batch in 2 microbatches whose masks differ, from
one seeded draw.  Each mesh's losses of all 3 steps within 5% of the
1-rank run's, its step-0 grad norm within 10% and every gradient of
step 0 within 10% relative L2 (phase 26's bars; each rank's blocks
against its own reference, the sums added over the ranks); the
metrics the same on every rank; per rank the launches of kernels 3 and 4
by part (forward, recompute, backward) one device's step launches, and
``1 / (data x model)`` of every leaf whose spec names both axes; the
``(2, 2)`` state checkpointed (gathered whole onto rank 0, which writes
it) and restored into ``(1, 4)``'s blocks, each rank's blocks bitwise
(by sha256) the writer's cut of the state; an fp32 witness at 1
layer and 4 x 256 on ``(2, 2)``: loss within 1e-5 relative, every
gradient within 1e-4 x max(1, max|ref|); per mesh the step ms and the
seconds the gloo gathers took.  The entries ``matmul (phase 35, every
rank's blocks)`` and ``flash_attention (phase 35, every rank's heads)``:
every launch shape of rank 0's first step on each mesh (kernel 3's
forward, dA and dB, kernel 4's forward and recompute), replayed on seeded
operands against its plain version at the bf16 bar and timed.

It exits non-zero, with no result line, without a CUDA device or outside a
checkout of the repository, or if any phase fails.  Phases 1-9 are fp32
with TF32 off.  The full per-call results go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the spin kernel's cycles a second: the H100's 1.98 GHz boost clock (a
# slower clock spins longer, never shorter)
SPIN_CYCLES_PER_S = 1.98e9

# NVIDIA H100 SXM data-sheet peaks (at the 700 W limit)
PEAK_FP32_FLOPS = 67e12        # CUDA cores, no tensor cores
PEAK_BF16_FLOPS = 989e12       # tensor cores, dense
PEAK_BYTES_S = 3.35e12         # HBM3

SEED = 0
BATCH, HW, CLASSES = 4, 512, 19
# kernel vs plain, fp32 outputs: max |kernel - plain| <= TOL * max(1,
# max |plain|).  Both are fp32 with fp32 accumulation; only the summation
# order differs.
TOL = 1e-4
# bf16 outputs, at every element: |kernel - plain| <= BF16_STEP * |plain| +
# TOL * max(1, max |plain|).  Both sides compute in fp32 (sums in another
# order: the TOL term) and round once to bf16, where two nearly equal values
# may land one bf16 step apart: at most 2^-7 of the value.
BF16_STEP = 2.0 ** -7
# ENet forward, kernels vs torch backend (cuDNN, TF32 off): relative L2
REL_L2_TOL = 1e-4
LAUNCHES_PER_FORWARD = {"conv2d": 86, "transposed_conv2d": 3,
                        "matmul": 0, "flash_attention": 0}
# the conv2d variants of one forward: the stem (Cin 3) takes the 4-byte
# copies, every other conv the 16-byte ones; every weight slab is resident;
# no launch takes a bf16 form
CONV_VARIANTS_PER_FORWARD = {
    "vec4-resident": 85, "vec4-streamed": 0, "scalar-resident": 1,
    "scalar-streamed": 0, "bf16-vec8-resident": 0, "bf16-vec8-streamed": 0,
    "bf16-vec4-resident": 0, "bf16-vec4-streamed": 0,
    "bf16-scalar-resident": 0, "bf16-scalar-streamed": 0}
# the conv2d variants of a bf16 forward and backward: 2-byte plain loads
# for the odd channel counts (the stem's Cin 3, the head dx's Cin-19
# cotangent), 8-byte copies for Cin 4, 16-byte ones for the rest
BF16_VARIANTS = {
    "forward": {"bf16-vec8-resident": 82, "bf16-vec4-resident": 3,
                "bf16-scalar-resident": 1},
    "backward": {"bf16-vec8-resident": 157, "bf16-vec4-resident": 7,
                 "bf16-scalar-resident": 1}}
# bf16 against fp32 and against the torch backend: the reference's bars
# (DESIGN.md §12), forward within 5% of the fp32 output range, gradients
# within 10% relative L2
BF16_FWD_RTOL = 0.05
BF16_GRAD_RTOL = 0.10
# ENet's scalar PReLU slopes (phase 16 holds their gradients together)
SLOPES = ("a1", "a2", "a3")
# one ENet training step's launches: the forward's, then the backward's
# (the 79 fused convs and 2 fused upsamplers recomputed without their
# epilogue, 86 dense dx: 75 square stride-1, 8 rectangular and the 3
# transposed convs' dx, and the dx of the 2 k2 s2 downsample reduces on the
# transposed kernel; the stem needs no dx)
LAUNCHES_PER_STEP = {
    "forward": {"conv2d": 86, "transposed_conv2d": 3, "matmul": 0,
                "flash_attention": 0},
    "backward": {"conv2d": 165, "transposed_conv2d": 4, "matmul": 0,
                 "flash_attention": 0}}
TRAIN_STEPS = 3
# kernels vs torch backend losses of the same steps: relative difference
TRAIN_LOSS_RTOL = 1e-4
# step-0 gradients, kernels vs torch backend, per tensor: max |err| <=
# TOL * max(1, max |ref|) and <= GRAD_RTOL * max |ref|; the second bar
# scales with the gradients, which are far below 1.  Above TOL because the
# two backends round in another order through every layer, and a PReLU
# slope's gradient is a sum over the whole activation that cancels to
# ~1e-4 of its terms (PERF.md §6 has the readings it was set from: at most
# 8.4e-4); still 10x under a 2% error
GRAD_RTOL = 2e-3
# StableLM-2-1.6B (the port's src/repro_torch/configs/stablelm_1_6b.py):
# phase 11 runs one layer of the port's transformer on a 4096-token prefill
# at batch 1, its published context length; these are its kernel calls
LM_ARCH, LM_SEQ = "stablelm-1.6b", 4096
LM_LAYER_CALLS = (("q projection", "matmul"), ("k projection", "matmul"),
                  ("v projection", "matmul"),
                  ("causal attention", "flash_attention"),
                  ("o projection", "matmul"), ("mlp gate", "matmul"),
                  ("mlp up", "matmul"), ("mlp down", "matmul"))
LAUNCHES_PER_LM_LAYER = {"conv2d": 0, "transposed_conv2d": 0, "matmul": 7,
                         "flash_attention": 1}
# the variant every matmul and attention launch of the layer takes, by dtype
LM_VARIANT = {"torch.float32": "simt", "torch.bfloat16": "wgmma"}
# LM logits are held to the torch backend's this many rows at a time in fp32
# (a 4096-token Gemma prefill's logits are 2 GB in bf16)
LOGIT_CHUNK = 512
# phase 25: StableLM-2-1.6B served at its published widths (bf16), depth cut
# from 24 to SERVE_LM_LAYERS layers (to keep the whole script within its
# time), through repro_torch.launch.serve.Server: batch 4,
# a 1024-token prompt drawn from SEED, 64 generated tokens (KV caches of
# 1,088 slots); the logits held to the torch backend's through the prefill
# and 8 teacher-forced decode steps
LM_NAME = "StableLM-2-1.6B"
SERVE_LM_LAYERS = 1
SERVE_LM_BATCH, SERVE_LM_PROMPT, SERVE_LM_GEN = 4, 1024, 64
SERVE_LM_FORCED = 8
# parallel vs sequential prefill caches: |a - b| <= tol + tol |b|, the
# reference's bf16 bound (tests/test_launch.py)
PREFILL_CACHE_TOL = 2e-2
# 25f: the same model in fp32, depth cut to 1 of 24 layers
SERVE_LM_FP32_LAYERS = 1
# 25g: GQA, qk-norm and head dim 128: Qwen3-32B (hf:Qwen/Qwen3-32B) at its
# published widths, depth cut to 1 of 64 layers (4.1 GB of bf16 weights),
# one prefill and 4 decode steps
GQA_ARCH, GQA_NAME, GQA_LAYERS, GQA_DECODE = "qwen3-32b", "Qwen3-32B", 1, 4
# phase 26: StableLM-2-1.6B trained at its published widths (bf16), depth cut
# from 24 to TRAIN_LM_LAYERS layers (to keep the whole script within its
# time), through make_train_step: seq 4096 (the reference's train_4k
# length), global batch 4 in 2 microbatches of 2, fp32 AdamW masters and
# moments, per-layer remat, LMDataPipeline(seed=SEED) batches, warmup 2 of
# 100 steps; 3 steps a backend (26d) and the median of 5 warm ones (26f)
TRAIN_LM_LAYERS = 1
TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_MICRO = 4, 4096, 2
TRAIN_LM_WARMUP, TRAIN_LM_TOTAL = 2, 100
TRAIN_LM_STEPS, TRAIN_LM_TIMED = 3, 5
# 26e: the train loop at the reduced configuration: 4 steps of 4 x 1024
# tokens, a checkpoint every 2 steps, a failure injected at step 3
DRILL_LM_STEPS, DRILL_LM_EVERY, DRILL_LM_FAIL, DRILL_LM_SEQ = 4, 2, 3, 1024
# phase 27: whisper-small (src/repro_torch/configs/whisper_small.py) at its
# published widths (d_model 768, 12 heads of 64, d_ff 3072, vocab 51865,
# encoder_ctx 1500, bf16), depth cut from 12 + 12 to WH_LAYERS + WH_LAYERS
# layers (to keep the whole script within its time).
# 27b serves batch
# 8 clips of 30 s, each a seeded (3000, 80) log-mel that the frontend (kernel
# 1, fp32) turns into 1500 frames: a 4-token prompt (Whisper's
# start-of-transcript, language, task and no-timestamps slots, drawn from
# SEED), 224 greedy tokens (Whisper's default sample length), caches of 448
# slots (the published text context); the logits held to the torch
# backend's through the encoder output, the prompt loop and 8 teacher-forced
# decode steps; decode ms from a loop of 32 steps
WH_ARCH = "whisper-small"
WH_LAYERS = 1
WH_BATCH, WH_PROMPT, WH_GEN, WH_CTX = 8, 4, 224, 448
WH_FORCED, WH_LOOP = 8, 32
# 27c: decoder sequence 448, global batch 16 in 2 microbatches, seeded fp32
# frames, LMDataPipeline(seed=SEED) tokens, phase 26's schedule; losses of 3
# steps a backend within 0.1% of each other
WH_TRAIN_BATCH, WH_TRAIN_SEQ, WH_TRAIN_MICRO = 16, 448, 2
WH_LOSS_RTOL = 1e-3
# 27e: fp32 at depth 1 + 1 (of 12 + 12), the prompt loop and 4 decode steps
WH_FP32_LAYERS, WH_FP32_DECODE = 1, 4
# phase 28: Gemma-3-12B (src/repro_torch/configs/gemma3_12b.py) at its
# published widths (d_model 3840, 16 heads on 8 KV heads of 256, d_ff 15360,
# vocab 262144 tied, window 1024, 5 local : 1 global, qk-norm, bf16), served
# at GM_LAYERS of its 48 layers (to keep the whole script within its time),
# weights drawn on the card from a seeded CUDA generator.  28a: kernel 4's band against its plain version, (q shape,
# window) in bf16: simt at Gemma's dh 256, wgmma at dh 128 and 64 with
# windows of 1024, 100 (no tile multiple) and 1, and at 700 rows with window
# 200, where the rows of a q tile begin their band mid-tile or past its first
# kv tile
GM_ARCH, GM_NAME, GM_LAYERS = "gemma3-12b", "Gemma-3-12B", 12
GM_BANDS = [((1, 16, 4096, 256), 1024), ((1, 16, 4096, 256), 0),
            *[((1, 16, 4096, dh), w) for dh in (128, 64)
              for w in (1024, 100, 1, 0)],
            ((2, 4, 700, 128), 200), ((2, 4, 700, 64), 200)]
# 28b: make_prefill_step over batch 1 x 4096 tokens (the cache-free forward,
# 10 windowed attentions at 12 layers); Server.generate at batch 4, a 16-token prompt
# through the token loop (parallel_prefill_ok is false for a windowed
# config), 16 generated tokens, 8 teacher-forced steps held to the torch
# backend
GM_SEQ = 4096
GM_BATCH, GM_PROMPT, GM_GEN, GM_FORCED = 4, 16, 16, 8
# 28c: one pattern period (6 layers, full widths): batch 2, a 1040-token
# prompt through the token loop, then 8 teacher-forced steps (positions up to
# 1047: the 1024-slot rings wrap by 24), held to the torch backend's
# cache-free forward
GM_RING_BATCH, GM_RING_PROMPT, GM_RING_FORCED = 2, 1040, 8
# 28d: training at one pattern period: seq 4096, global batch 2 in 2
# microbatches, phase 26's schedule; 3 warm runs timed
GM_TRAIN_BATCH, GM_TRAIN_MICRO, GM_TRAIN_TIMED = 2, 2, 3
# phase 29: the MoE FFN (src/repro_torch/models/moe.py).  29a: kernel 3's
# batched form against its plain version, (E, M, K, N) in bf16 ("wgmma") and
# fp32 ("simt"): Qwen3-MoE's expert products at a 1 x 4096 prefill's 320
# capacity rows (8 groups of 512 tokens, 40 slots an expert) and at a
# batch-4 decode's 1, Llama-4-Scout's at E = 16; and one case whose K = 36
# takes "simt" in bf16
MOE_BATCHED = [(128, 320, 2048, 768), (128, 320, 768, 2048),
               (128, 1, 2048, 768), (128, 1, 768, 2048),
               (16, 320, 5120, 8192)]
MOE_UNALIGNED = (16, 40, 36, 40)
# 29b: Qwen3-MoE-30B-A3B (src/repro_torch/configs/qwen3_moe_30b_a3b.py) at
# its published widths (d_model 2048, 32 heads on 4 KV heads of 128, 128
# experts top-8 of 768, vocab 151936, bf16), depth cut from 48 to MOE_LAYERS
# layers (to keep the whole script within its time):
# make_prefill_step over 1 x MOE_SEQ tokens, the routes of both backends
# layer by layer, Server at batch 4 (a 16-token prompt in one parallel
# prefill, 16 tokens), 8 teacher-forced steps
MOE_ARCH, MOE_NAME, MOE_LAYERS = "qwen3-moe-30b-a3b", "Qwen3-MoE-30B-A3B", 6
MOE_SEQ = 4096
MOE_BATCH, MOE_PROMPT, MOE_GEN, MOE_FORCED = 4, 16, 16, 8
# 29c: Llama-4-Scout (src/repro_torch/configs/llama4_scout_17b_a16e.py) at
# its published widths (d_model 5120, 40 heads on 8 KV heads of 128, 16
# experts top-1 of 8192 and a shared expert of 8192, vocab 202048), depth
# cut from 48 to SCOUT_LAYERS layers (107.8 B parameters need three cards):
# a 1 x MOE_SEQ prefill and 8 teacher-forced decode steps
SCOUT_ARCH, SCOUT_NAME, SCOUT_LAYERS = ("llama4-scout-17b-a16e",
                                        "Llama-4-Scout-17B-16E", 1)
# phase 30: MoE training (src/repro_torch/models/moe.py under autograd: the
# experts' products forward and backward on kernel 3's batched form,
# kernels.matmul.BatchedMatmulFn).  30a: dA and dB of the batched form against
# its plain version, (E, R, K, N) of the forward product (E, R, K) @ (E, K,
# N), in bf16 ("wgmma") and fp32 ("simt"): Qwen3-MoE's expert products at a
# training microbatch's R = 640 capacity rows (2 x 4096 tokens: 16 groups of
# 512, 40 slots an expert) and Llama-4-Scout's at R = 320 (1 x 4096 tokens);
# then, in bf16, R = 200 and N = 264, whose dB and dA contract over a last
# 64-deep K tile of 8 rows ("wgmma"), and R = 36, whose dB contracts over K =
# 36 and so takes "simt"
MOE_TRAIN_BATCHED = [(128, 640, 2048, 768), (128, 640, 768, 2048),
                     (16, 320, 5120, 8192)]
MOE_TRAIN_EDGES = [(8, 200, 256, 264), (16, 36, 64, 40)]
# 30b: Qwen3-MoE-30B-A3B at its published widths, depth cut from 48 to
# MOE_TRAIN_LAYERS layers (to keep the whole script within its time; one
# card holds the full step's fp32 AdamW state of 1.87 B parameters at 2
# layers, and 30.5 B would need ~977 GB), through make_train_step:
# seq MOE_SEQ, global batch 4 in 2 microbatches, phase 26's schedule, remat,
# weights drawn on the card; 3 steps on the kernels backend, the median of
# MOE_TRAIN_TIMED warm steps a backend timed
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_BATCH, MOE_TRAIN_MICRO, MOE_TRAIN_TIMED = 4, 2, 3
# 30c: Llama-4-Scout at its published widths, 1 of 48 layers (to keep the
# whole script within its time; at 2 layers, 6.47 B parameters, a full step
# would reckon ~207 GB), seq MOE_SEQ, batch 1: the loss and gradients
# (make_value_and_grad)
SCOUT_TRAIN_LAYERS = 1
# phase 31: the recurrent mixers (src/repro_torch/models/{mamba,xlstm}.py),
# every projection on kernel 3.  31a: kernel 3 against its plain version at
# the slice's shapes, (what, M, K, N, dtype): xLSTM-1.3B's products at a
# 1 x 1024 forward's M (the sLSTM's recurrent product at M = 1, a step) and
# at a batch-4 decode's, and Jamba-1.5-Large's Mamba mixer at a 1 x 4096
# forward's (x_proj and dt_proj once a 512-token scan chunk)
REC_CALLS = [
    ("xLSTM up_proj, sLSTM w_gates", 1024, 2048, 8192, "bf16"),
    ("xLSTM wq, wk, wv", 1024, 4096, 4096, "bf16"),
    ("xLSTM out_proj", 1024, 4096, 2048, "bf16"),
    ("xLSTM w_if", 1024, 4096, 8, "fp32"),
    ("xLSTM ff_up", 1024, 2048, 2730, "bf16"),
    ("xLSTM ff_down", 1024, 2730, 2048, "bf16"),
    ("xLSTM r_gates, a forward step", 1, 2048, 8192, "fp32"),
    ("xLSTM decode wq, wk, wv", 4, 4096, 4096, "fp32"),
    ("xLSTM decode w_if", 4, 4096, 8, "fp32"),
    ("xLSTM decode r_gates", 4, 2048, 8192, "fp32"),
    ("xLSTM decode ff_up", 4, 2048, 2730, "bf16"),
    ("xLSTM decode ff_down", 4, 2730, 2048, "bf16"),
    ("Jamba in_proj", 4096, 8192, 32768, "bf16"),
    ("Jamba x_proj", 512, 16384, 544, "bf16"),
    ("Jamba dt_proj", 512, 512, 16384, "fp32"),
    ("Jamba out_proj", 4096, 16384, 8192, "bf16"),
]
# 31b: xLSTM-1.3B (src/repro_torch/configs/xlstm_1_3b.py) at all 48 layers
# and its published widths (d_model 2048, 4 heads, mLSTM up-projection 2x
# and head width 1024, sLSTM FFN 2730, vocab 50304, bf16), weights drawn on
# the card: make_prefill_step over 1 x XL_SEQ tokens (the mLSTM's chunkwise
# form in 2 chunks, a 1,024-step sLSTM loop), and Server at batch XL_BATCH:
# a XL_PROMPT-token prompt through the token loop, XL_GEN tokens
XL_ARCH, XL_NAME = "xlstm-1.3b", "xLSTM-1.3B"
XL_SEQ, XL_BATCH, XL_PROMPT, XL_GEN = 1024, 4, 32, 32
# the forward's busy share is read at one pattern period over the first
# XL_PROFILE_SEQ tokens: the profiler takes ~0.5 ms a launched op to digest,
# and the sLSTM loop's steps are alike
XL_PROFILE_SEQ = 256
# 31c: one Mamba mixer of Jamba-1.5-Large (src/repro_torch/configs/
# jamba_1_5_large_398b.py) alone at its full width (d_model 8192, d_inner
# 16384, d_state 16, dt_rank 512, bf16): mamba_block over 1 x JM_SEQ
# unit-normal rows (8 scan chunks), and JM_DECODE decode steps at batch
# JM_BATCH from a zero cache against one scan over the same tokens
JM_ARCH, JM_NAME = "jamba-1.5-large-398b", "Jamba-1.5-Large Mamba mixer"
JM_SEQ, JM_BATCH, JM_DECODE = 4096, 4, 16
# phase 32: the recurrent mixers trained.  32a: kernel 3's backward (dA and
# dB through MatmulFn) at the new shapes of that path, (what, M, K, N,
# dtype) of the forward product
REC_TRAIN_CALLS = [
    ("sLSTM r_gates, batch 1", 1, 2048, 8192, "fp32"),
    ("sLSTM r_gates, batch 4", 4, 2048, 8192, "fp32"),
    ("mLSTM w_if", 4096, 4096, 8, "fp32"),
    ("Jamba dt_proj", 512, 512, 16384, "fp32"),
    ("sLSTM ff_up", 4096, 2048, 2730, "bf16"),
    ("sLSTM ff_down", 4096, 2730, 2048, "bf16"),
]
# 32b: xLSTM-1.3B at one pattern period (2 of 48 layers), the full step at
# 1 x XL_TRAIN_SEQ (the reference's train_4k length), the fp32 witness at 1 x
# XL_WITNESS_SEQ, the busy share read over a 1 x XL_TRAIN_PROFILE_SEQ step
XL_TRAIN_LAYERS, XL_TRAIN_SEQ, XL_TRAIN_BATCH = 2, 4096, 1
XL_TRAIN_PROFILE_SEQ = 64
# the sLSTM's backward grows by ~e^(0.0041 t) over t steps at these widths,
# so any two implementations' gradients part chaotically over 4,096: the
# fp32 witness runs at 1 x XL_WITNESS_SHORT (growth ~1.3x; each gradient's
# largest error held) and at 1 x XL_WITNESS_SEQ (~2.9x; relative L2), and
# the sLSTM layer's bf16 VJP is held on its first XL_REPLAY_SEQ tokens
XL_WITNESS_SHORT = 64
XL_WITNESS_SEQ = XL_REPLAY_SEQ = 256
# 32c: the Jamba mixer's forward and backward at 1 x JM_SEQ must peak under
# this (the per-chunk checkpoint keeps one chunk's scan live: ~12-15 GiB)
JM_TRAIN_PEAK_GIB = 20.0
# phase 33, the data axis on ranks sharing one card: the worlds, in order
# (4 before 2: 2 restores 4's snapshot); 33a's convs at ENet-512's layer
# shapes (core/enet_spec.py), batch 5 so the padding remainder runs
DA_WORLDS = (4, 1, 2)
# the global ranks of each world in the one spawn, and how the script names
# them: worlds 1 and 2 run at the same time on disjoint ranks
DA_RANKS = {4: (0, 1, 2, 3), 1: (0,), 2: (2, 3)}
DA_LABEL = {4: "4 ranks sharing one card",
            1: "1 rank, beside the 2-rank world (3 ranks sharing one card)",
            2: "2 ranks, beside the 1-rank world (3 ranks sharing one card)"}
DA_CASES = (
    [("3x3 b2.1", (5, 64, 64, 32), (3, 3, 32, 32), {})]
    + [(f"dilated d={d}", (5, 64, 64, 32), (3, 3, 32, 32), {"dilation": d})
       for d in (2, 4, 8, 16)]
    + [("transposed b4.0", (5, 64, 64, 16), (3, 3, 16, 16),
        {"transposed": True, "stride": 2, "output_padding": 1}),
       ("transposed fullconv", (5, 256, 256, 16), (3, 3, 16, CLASSES),
        {"transposed": True, "stride": 2, "output_padding": 1})])
DA_GRAD_TOL = 1e-5
# 33b: ENet-512 steps, batch 8 in 8 virtual shards; the bf16 transport's
# losses within DA_BF16_TOL x max(1, |dense|) of the dense run's
DA_TRAIN_BATCH, DA_SHARDS = 8, 8
DA_BF16_TOL = 5e-3
# and step 0's grad norm (one state, only the wire differs) within this of
# the dense one's, but not equal to it (4.1e-5 read on the CPU's tiny ENet)
DA_BF16_GRAD_NORM = 1e-4
# 33c: both lanes at batch 4 (a 4-rank share is one slot), 2 steps a tick
DA_SERVE_KW = {"batch": 4, "scan_steps": 2}
DA_SERVE_STEPS = (4, 2, 3, 5, 1, 6)
DA_GAN_REQUESTS, DA_SNAP_TICK = 4, 2
# 33d: the failover pool's hosts, the one killed, the heartbeat staleness
DA_HOSTS, DA_VICTIM, DA_HB_TIMEOUT = 3, 1, 2.0
# phase 34, the model axis, in phase 33's spawn: the meshes (data, model)
# and their global ranks, in order ((2, 2) snapshots before (1, 2)
# restores); 34a's convs at 33a's shapes but the 256x256 head, batch 2
MA_MESHES = {(1, 4): (0, 1, 2, 3), (2, 2): (0, 1, 2, 3), (1, 2): (2, 3)}
MA_CONV_MESHES = ((1, 4), (2, 2))
MA_CASES = tuple((label, (2, *xs[1:]), ws, dict(kw, spatial=True))
                 for label, xs, ws, kw in DA_CASES
                 if label != "transposed fullconv")
# 34b: the denoiser lane (and one DCGAN-64 request, whose rows stay whole)
MA_SERVE_KW = {"batch": 4, "scan_steps": 2, "spatial": True}
MA_SERVE_STEPS = (4, 2, 3, 5)
MA_SNAP_TICK = 1
# 34c: StableLM-2-1.6B at 2 of 24 layers (widths kept), bf16, a 4 x 1024
# prefill and 16 decode steps on seeded tokens, held to the 1-rank server
# at DESIGN.md §12's bf16 bar; Server.generate's greedy tokens
MA_LM_ARCH, MA_LM_LAYERS, MA_LM_REDUCED = "stablelm-1.6b", 2, False
MA_LM_BATCH, MA_LM_PROMPT, MA_LM_DECODE = 4, 1024, 16
MA_LM_BAR = 5e-2
# phase 35, the LM trained over (data, model) meshes, in phase 33's spawn:
# StableLM-2-1.6B at 2 of 24 layers (widths kept), bf16 with fp32 AdamW, a
# global batch of 4 in 2 microbatches of 4096 tokens, 3 steps a mesh from
# one seeded draw, held to the same steps on one rank (each rank runs it
# first, unmeshed) at phase 26's bars; the (2, 2) state checkpointed and
# restored on (1, 4), bitwise; an fp32 witness at 1 layer and 256 tokens
# on (2, 2), held at the fp32 bars.  The meshes and their global ranks, in
# order.
TA_ARCH, TA_LAYERS, TA_REDUCED = "stablelm-1.6b", 2, False
TA_BATCH, TA_MICRO, TA_SEQ, TA_STEPS = 4, 2, 4096, 3
TA_MESHES = {(2, 2): (0, 1, 2, 3), (1, 4): (0, 1, 2, 3), (1, 2): (0, 1)}
TA_CKPT = ((2, 2), (1, 4))
TA_WITNESS_LAYERS, TA_WITNESS_SEQ, TA_WITNESS_MESH = 1, 256, (2, 2)
TA_LOSS_RTOL, TA_GNORM_RTOL, TA_GRAD_RL2 = 0.05, 0.10, 0.10
TA_FP32_LOSS, TA_FP32_GRAD = 1e-5, 1e-4
# phase 3's edge cases (and phase 14's, in bf16)
DENSE_EDGES = [  # label, x shape, w shape, stride, pads
    ("stem Cin3 Cout13 s2", (2, 37, 41, 3), (3, 3, 3, 13), 2,
     ((1, 1), (1, 1))),
    ("k2 s2 p0", (2, 32, 30, 16), (2, 2, 16, 32), 2, ((0, 0), (0, 0))),
    ("5x1 SAME", (2, 21, 19, 32), (5, 1, 32, 32), 1, ((2, 2), (0, 0))),
    ("1x5 SAME", (2, 21, 19, 32), (1, 5, 32, 32), 1, ((0, 0), (2, 2))),
    ("k2 SAME-even", (2, 15, 17, 8), (2, 2, 8, 24), 1, ((0, 1), (0, 1))),
    ("k4 SAME-even s2", (2, 15, 17, 8), (4, 4, 8, 70), 2, ((1, 2), (1, 2))),
    ("Cin4 3x3 (16-byte copies)", (2, 17, 19, 4), (3, 3, 4, 16), 1,
     ((1, 1), (1, 1))),
    ("Cout4 1x1", (2, 20, 18, 16), (1, 1, 16, 4), 1, ((0, 0), (0, 0))),
    ("Cout8 3x3", (2, 17, 19, 16), (3, 3, 16, 8), 1, ((1, 1), (1, 1))),
    ("Cout19 3x3", (2, 16, 15, 16), (3, 3, 16, 19), 1, ((1, 1), (1, 1))),
    ("3x3 128->64, streamed slab", (2, 9, 10, 128), (3, 3, 128, 64), 1,
     ((1, 1), (1, 1))),
]
TCONV_EDGES = [  # label, x shape, k, s, p_lo, output_padding, cin, cout
    ("k3 s2 op1 Cout19", (2, 16, 16), 3, 2, 1, 1, 16, 19),
    ("k4 s2 p_lo2", (2, 13, 11), 4, 2, 2, 0, 16, 24),
    ("k2 s2 p_lo0", (2, 13, 11), 2, 2, 0, 0, 16, 24),
    ("k2 s3 k<s + epilogue", (2, 9, 7), 2, 3, 1, 0, 8, 12),
    ("k16 s2 Cout32, streamed taps", (2, 11, 9), 16, 2, 7, 1, 16, 32),
]
# the conv models of phases 18-22, at their published widths: DCGAN
# (Radford et al. 2016) nz 100, ngf 64, batch 128; the U-Net denoiser's
# widths (256, 128, 64) from an 8x8 mid-block to 64x64, batch 8;
# whisper-small's frontend (80 mels, 3000 frames, d_model 768), batch 4.
# ESPNet-512 takes ENet's BATCH, HW and CLASSES.
DCGAN_NZ, DCGAN_NGF, DCGAN_BATCH = 100, 64, 128
UNET_MID, UNET_BATCH = 8, 8
WHISPER_BATCH = 4
# each model's launches of a forward and of a backward (counted on the CPU
# by tests/test_torch_{espnet,generative,whisper}.py): ESPNet's 38 dense
# (stem, 5 a module over 7 ESP modules, skip2, head) and 3 transposed;
# its backward's 2 recomputes (stem, up1), 35 dense dx and the two
# stride-2 d=1 branches' dx on the transposed kernel; DCGAN's stages and,
# backward, its 3 fused stages recomputed and 4 strided dx; the
# denoiser's 4 encoders, 6 decoder convs, head and 3 upsamplers, and
# backward 9 recomputes, 7 dense and 3 strided dx; Whisper's two convs
MODEL_LAUNCHES = {
    "ESPNet-512": {"forward": {"conv2d": 38, "transposed_conv2d": 3},
                   "backward": {"conv2d": 39, "transposed_conv2d": 3}},
    "DCGAN-64": {"forward": {"conv2d": 0, "transposed_conv2d": 4},
                 "backward": {"conv2d": 4, "transposed_conv2d": 3}},
    "DCGAN-128": {"forward": {"conv2d": 0, "transposed_conv2d": 5}},
    "U-Net denoiser": {"forward": {"conv2d": 11, "transposed_conv2d": 3},
                       "backward": {"conv2d": 16, "transposed_conv2d": 3}},
    "Whisper frontend": {"forward": {"conv2d": 2, "transposed_conv2d": 0}},
}
# launches of each timed call in phases 18-22 (median of 3 rounds)
MODEL_REPS = 5
# phase 23, the served generative path: GenServer's denoiser lane at the
# widths of phase 21 (256/128/64 from an 8x8 mid-block, 64x64 images), batch
# 8, 4 DDIM steps a tick; 24 requests cycling over these step budgets and
# SLO classes; request 0 cancelled after 8 substeps and request 12 timed out
# after 24 (ticks scale with the depth, so every depth does the same work)
SERVE_BATCH, SERVE_SCAN, SERVE_REQUESTS = 8, 4, 24
SERVE_STEPS = (50, 25, 10, 1)
SERVE_SLOS = ("realtime", "standard", "batch")
SERVE_CANCEL, SERVE_TIMEOUT = (0, 8), (12, 24)   # (rid, substeps)
# per DDIM substep: the denoiser's launches and its timestep MLP's matmuls
SERVE_SUBSTEP = {"conv2d": 11, "transposed_conv2d": 3, "matmul": 2}
# served samples against the unbatched loop and the torch backend: max
# |err| <= SERVE_BAR x max(1, max|ref|), the reference's cross-backend bar
# (tests/test_serve_gen.py)
SERVE_BAR = 1e-5
# the fault drills' requests (step budgets cycled), on the denoiser lane
DRILL_STEPS, DRILL_REQUESTS = (25, 10, 1), 10
# the DCGAN-64 lane (nz 100, ngf 64): batch 32, 64 requests in 2 ticks of
# 0 + 4 launches and the projection's matmul
GAN_BATCH, GAN_REQUESTS = 32, 64
GAN_TICK = {"conv2d": 0, "transposed_conv2d": 4, "matmul": 1}
# 23f's timed drains, each lane on its own at the widths and batch above:
# (requests, arrivals a tick when paced).  A denoiser request holds a slot
# for 6 ticks on average over SERVE_STEPS at 4 steps a tick (13, 7, 3, 1),
# so 8 slots serve 4/3 requests a tick and 1 a tick loads them to 75%;
# DCGAN's 24 a tick fill 75% of its 32 slots.  A saturated drain tops the
# queue up to two batches before every tick, so the lane never waits for
# work; a backlog drain queues every request before the first tick, so the
# scheduler works through a long queue.
TIMED = {"unet_dec": (160, 1), "dcgan64": (4096, 24)}
ARRIVALS = ("saturated", "paced", "backlog")
# a learnable PReLU slope's name: ``stem_a``, ``down1.a``, ``dec.l0_a1``,
# ``dec.l2_aup``
SLOPE_NAME = re.compile(r"[._]a(\d|up)?$")
# phase 24c: requests of the calibrated denoiser drain (step budgets and SLO
# classes cycled as phase 23's)
CALIB_REQUESTS = 8
# the port's plan-table switches, cleared at start so that no environment
# tunes or sweeps a launch of phases 1-23
AUTOTUNE_SWITCHES = ("REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_AUTOTUNE_SWEEP")
# phase 24b: calls of each kind timed to price a launch's plan lookup
LOOKUP_CALLS = 2000
SOURCES = {  # kernel -> (CUDA source, the TPU kernel's pallas_call)
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:195"),
    "transposed_conv2d": ("src/repro_torch/kernels/csrc/transposed_conv.cu",
                          "src/repro/kernels/transposed_conv.py:235"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:51"),
    # kernel 3's batched form (the MoE experts; counted in matmul's launches)
    "matmul_batched": ("src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:51"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
}


def layer_products(cfg) -> int:
    """A dense layer's products: q, k, v and o, and the MLP's three."""
    return 4 + (3 if cfg.d_ff > 0 else 0)


def ffn_products(cfg, pattern_idx: int) -> tuple[int, int]:
    """(2-D, batched) products of the FFN at a pattern position, whose kind
    is the reference's (``transformer._ffn_kind``): a MoE FFN's router and
    its shared expert's three, and kernel 3's batched form for the
    experts' three; a dense MLP's three; none."""
    m = cfg.moe
    if m is not None and (pattern_idx + 1) % m.every_n_layers == 0:
        return 1 + (3 if m.shared_expert_ff else 0), 3
    return (3 if cfg.d_ff > 0 else 0), 0


def moe_layers(cfg) -> int:
    """The decoder layers with a MoE FFN."""
    return cfg.repeat * sum(ffn_products(cfg, pi)[1] > 0
                            for pi in range(len(cfg.block_pattern)))


def kernel3_variant(k: int, n: int, dtype: str) -> str:
    """The variant kernel 3 takes for an (M, ``k``) @ (``k``, ``n``) product
    of ``dtype`` (``"bf16"`` or ``"fp32"``) operands by its rule
    (``kernels.matmul.matmul_variant``, less the bases' alignment, which the
    allocator gives): ``"wgmma"`` for bf16 with K and N multiples of 8,
    else ``"simt"``."""
    return ("wgmma" if dtype == "bf16" and k > 0 and k % 8 == 0
            and n % 8 == 0 else "simt")


def mixer_products(cfg, kind: str, seq: int = 1) -> dict:
    """Kernel 3's launches of one sequence mixer of ``kind`` over ``seq``
    tokens (a cache-free forward, or a decode step at ``seq`` 1), by the
    variant each takes (``kernel3_variant`` of its K, N and dtype):
    ``{"wgmma": n, "simt": n}``.  Attention's q, k, v and o (on
    ``"wgmma"``); a Mamba block's ``in_proj`` and ``out_proj``, and its
    ``x_proj`` and fp32 ``dt_proj`` once a scan chunk (``mamba.
    SCAN_CHUNK``, the reference's rule); an mLSTM block's ``up_proj``,
    ``out_proj`` and ``wq``, ``wk`` and ``wv``, these in the model's dtype
    in the forward and in fp32 in a decode step, beside the fp32 gates
    ``w_if``; an sLSTM block's ``w_gates``, its fp32 recurrent product
    once a step, and its FFN."""
    if kind in ("attn", "attn_local"):
        return {"wgmma": 4, "simt": 0}
    out = {"wgmma": 0, "simt": 0}
    for _, k, n, dtype in mixer_matmuls(cfg, kind, seq):
        out[kernel3_variant(k, n, dtype)] += 1
    return out


def scan_chunks(cfg, seq: int) -> int:
    """The Mamba scan's chunks over ``seq`` tokens (``mamba.SCAN_CHUNK``,
    the reference's rule): ``seq // chunk`` for a longer multiple of the
    chunk, else 1 (one scan)."""
    from repro_torch.models import mamba

    chunk = mamba.SCAN_CHUNK
    return seq // chunk if seq > chunk and seq % chunk == 0 else 1


def mixer_matmuls(cfg, kind: str, seq: int = 1, rows: int = 1) -> list:
    """The kernel-3 products ``(M, K, N, dtype)`` of one recurrent mixer of
    ``kind`` over ``rows`` x ``seq`` tokens, in launch order where it
    matters (``mixer_products`` reads their variants): a Mamba block's
    ``in_proj`` and ``out_proj``, and its ``x_proj`` and fp32 ``dt_proj``
    once a scan chunk (M the chunk's tokens); an mLSTM block's
    ``up_proj``, ``out_proj``, the fp32 gates ``w_if`` and ``wq``, ``wk``
    and ``wv`` (fp32 in a decode step); an sLSTM block's ``w_gates``, its
    FFN, and its fp32 recurrent product once a step at M = ``rows``."""
    from repro_torch.models import mamba, xlstm

    dt = "bf16" if cfg.dtype == "bfloat16" else "fp32"
    d, tokens = cfg.d_model, rows * seq
    if kind == "mamba":
        m, d_in, dt_rank = mamba._cfg(cfg)
        n = scan_chunks(cfg, seq)
        per = tokens // n
        return ([(tokens, d, 2 * d_in, dt), (tokens, d_in, d, dt)]
                + n * [(per, d_in, dt_rank + 2 * m.d_state, dt),
                       (per, dt_rank, d_in, "fp32")])
    if kind == "mlstm":
        _, d_in, _ = xlstm._dims(cfg)
        qkv = dt if seq > 1 else "fp32"
        return ([(tokens, d, 2 * d_in, dt), (tokens, d_in, d, dt),
                 (tokens, d_in, 2 * cfg.num_heads, "fp32")]
                + 3 * [(tokens, d_in, d_in, qkv)])
    if kind == "slstm":
        dff = int(cfg.xlstm.s_ff_factor * d)
        return ([(tokens, d, 4 * d, dt), (tokens, d, dff, dt),
                 (tokens, dff, d, dt)]
                + seq * [(rows, d, 4 * d, "fp32")])
    raise ValueError(f"unknown mixer {kind!r}")


RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


def autograd_launches(forward, recompute=(), no_da=()) -> list:
    """Kernel 3's launches under autograd, one ``(part, M, K, N, dtype)``
    each, part ``"forward"``, ``"recompute"`` or ``"backward"``: the
    ``forward`` products ``(M, K, N, dtype)``, the ``recompute`` ones run
    again, and each forward product's dA = dC @ B^T, (M, N) @ (N, K), and
    dB = A^T @ dC, (K, M) @ (M, N), but no dA for the forward products at
    the indices in ``no_da``."""
    out = [("forward", *p) for p in forward]
    out += [("recompute", *p) for p in recompute]
    for i, (m, k, n, dt) in enumerate(forward):
        if i not in no_da:
            out.append(("backward", m, n, k, dt))
        out.append(("backward", k, m, n, dt))
    return out


def mixer_train_launches(cfg, kind: str, seq: int, rows: int = 1,
                         remat: bool = False) -> list:
    """``autograd_launches`` of one recurrent mixer of ``kind`` over
    ``rows`` x ``seq`` tokens: its forward products (``mixer_matmuls``);
    under ``remat`` (the layer checkpoint) each again; a chunked Mamba
    scan's ``x_proj`` and ``dt_proj`` once more a chunk (each chunk runs
    under its checkpoint when grad is on); no dA for an sLSTM layer's first
    recurrent product (its h, the zero state, needs no gradient)."""
    products = mixer_matmuls(cfg, kind, seq, rows)
    again = list(products) if remat else []
    if kind == "mamba" and scan_chunks(cfg, seq) > 1:
        again += products[2:]
    return autograd_launches(products, again,
                             no_da=(3,) if kind == "slstm" else ())


def head_train_launches(cfg, seq: int, rows: int = 1) -> list:
    """``autograd_launches`` of the LM head over ``rows`` x ``seq`` tokens:
    one product a CE chunk (``layers.ce_chunks``), each checkpointed and so
    run again when there are several; an encoder-decoder takes the full
    logits, one product not checkpointed."""
    from repro_torch.models.layers import ce_chunks

    dt = "bf16" if cfg.dtype == "bfloat16" else "fp32"
    heads = 1 if cfg.encoder_layers else ce_chunks(seq)
    head = heads * [(rows * seq // heads, cfg.d_model, cfg.vocab, dt)]
    return autograd_launches(head, head if heads > 1 else [])


def recurrent_train_launches(cfg, seq: int, rows: int) -> list:
    """``autograd_launches`` of one microbatch of ``rows`` x ``seq`` tokens
    through a model of recurrent mixers only (no attention, no FFN of its
    own: xLSTM's): each layer's ``mixer_train_launches`` under
    ``cfg.remat``, then the head's (``head_train_launches``)."""
    if cfg.d_ff or cfg.moe or any(k not in RECURRENT_KINDS
                                  for k in cfg.block_pattern):
        raise ValueError(f"{cfg.name}: not a model of recurrent mixers only")
    out = []
    for kind in cfg.repeat * cfg.block_pattern:
        out += mixer_train_launches(cfg, kind, seq, rows, cfg.remat)
    return out + head_train_launches(cfg, seq, rows)


def train_variants(launches) -> dict:
    """``autograd_launches`` by part and the variant each takes
    (``kernel3_variant`` of its K, N and dtype): ``{"forward" |
    "recompute" | "backward": {"wgmma": n, "simt": n}}``."""
    out = {p: {"wgmma": 0, "simt": 0}
           for p in ("forward", "recompute", "backward")}
    for part, _, k, n, dt in launches:
        out[part][kernel3_variant(k, n, dt)] += 1
    return out


def mixer_train_split(cfg, seq: int, rows: int = 1) -> dict:
    """``train_variants`` of one Mamba mixer over ``rows`` x ``seq`` tokens
    differentiated alone, without the layer checkpoint (phase 32c)."""
    return train_variants(mixer_train_launches(cfg, "mamba", seq, rows))


def decoder_launches(cfg, seq: int = 1) -> tuple[int, int]:
    """(products, attentions) of the decoder layers over ``seq`` tokens:
    each layer's mixer's products (``mixer_products``) and its FFN's
    (``ffn_products``, the batched ones included), and 1 attention an
    attention layer; an encoder-decoder's decoder layer adds its cross
    attention's 4 products and 1 attention."""
    cross = 1 if cfg.encoder_layers else 0
    ffn = sum(sum(ffn_products(cfg, pi))
              for pi in range(len(cfg.block_pattern)))
    mix = sum(sum(mixer_products(cfg, kind, seq).values())
              for kind in cfg.block_pattern)
    attn = sum(kind.startswith("attn") for kind in cfg.block_pattern)
    return (cfg.repeat * (mix + ffn) + 4 * cross * cfg.num_layers,
            (cfg.repeat * attn) + cross * cfg.num_layers)


def recurrent_simt(cfg, seq: int = 1) -> int:
    """The launches of kernel 3's mixer products in a forward over ``seq``
    tokens, or a decode step at ``seq`` 1, that take ``"simt"``
    (``mixer_products``): in bf16 the recurrent mixers' fp32 products and
    any product of a width its rule refuses (xLSTM-1.3B's 2730-wide sLSTM
    FFN)."""
    return cfg.repeat * sum(mixer_products(cfg, kind, seq)["simt"]
                            for kind in cfg.block_pattern)


def encode_launches(cfg) -> dict:
    """The launches of an encoder-decoder's ``encode``: each bidirectional
    layer's products and 1 attention."""
    return {"conv2d": 0, "transposed_conv2d": 0,
            "matmul": layer_products(cfg) * cfg.encoder_layers,
            "flash_attention": cfg.encoder_layers}


def lm_step_launches(cfg, seq: int = 1) -> dict:
    """The launches of one LM serve step, prefill or decode, or of a
    forward over ``seq`` tokens (a recurrent mixer's count depends on it,
    ``mixer_products``): each decoder layer's products and attentions
    (``decoder_launches``), and the LM head's matmul.  ``matmul`` counts
    kernel 3's batched launches too, as its counter does;
    ``batched_launches`` gives them apart."""
    products, attentions = decoder_launches(cfg, seq)
    return {"conv2d": 0, "transposed_conv2d": 0, "matmul": products + 1,
            "flash_attention": attentions}


def batched_launches(cfg) -> int:
    """Kernel 3's batched launches of one LM serve step or forward: three
    a MoE layer (the experts' gate, up and down products)."""
    return 3 * moe_layers(cfg)


def windowed_launches(cfg) -> int:
    """The attention launches of a cache-free forward (``make_prefill_step``,
    training) that take a band: one a sliding-window layer.  A decode step
    takes none (the ring holds only the band)."""
    if not cfg.window:
        return 0
    return cfg.repeat * sum(k == "attn_local" for k in cfg.block_pattern)


def lm_train_launches(cfg, seq_len: int, microbatches: int) -> dict:
    """The kernel launches of one ``make_train_step`` step on
    ``backend="kernels"``, by part: ``{"matmul": {"forward", "recompute",
    "backward"}, "flash_attention": {...}}``.

    Per microbatch: each layer's products over ``seq_len`` tokens
    (``decoder_launches``; an encoder-decoder's encoder layers and decoder
    layers), run again in the backward under ``cfg.remat``, with dA and dB
    each in the backward; but a recurrent mixer's as
    ``mixer_train_launches`` has them, and the LM head's as
    ``head_train_launches``.  Attention runs kernel 4 in the forward and in
    the recompute; its backward launches no kernel."""
    body, attn = decoder_launches(cfg, seq_len)
    if cfg.encoder_layers:
        enc = encode_launches(cfg)
        body, attn = body + enc["matmul"], attn + enc["flash_attention"]
    rec = [part for kind in cfg.repeat * cfg.block_pattern
           if kind in RECURRENT_KINDS
           for part, *_ in mixer_train_launches(cfg, kind, seq_len,
                                                remat=cfg.remat)]
    head = [part for part, *_ in head_train_launches(cfg, seq_len)]
    other = body - rec.count("forward")
    mm = {"forward": other, "recompute": other if cfg.remat else 0,
          "backward": 2 * other}
    mm = {k: v + rec.count(k) + head.count(k) for k, v in mm.items()}
    fa = {"forward": attn, "recompute": attn if cfg.remat else 0,
          "backward": 0}
    return {"matmul": {k: v * microbatches for k, v in mm.items()},
            "flash_attention": {k: v * microbatches for k, v in fa.items()}}


def lm_train_split(cfg, seq_len: int, microbatches: int) -> dict:
    """``lm_train_launches`` with kernel 3's batched launches apart:
    ``"matmul"`` the 2-D ones, ``"matmul_batched"`` the batched form's (the
    experts' three products a MoE layer forward, again in the recompute
    under ``cfg.remat``, and their dA and dB in the backward,
    ``BatchedMatmulFn``), ``"flash_attention"`` as there."""
    out = lm_train_launches(cfg, seq_len, microbatches)
    n = batched_launches(cfg) * microbatches
    batched = {"forward": n, "recompute": n if cfg.remat else 0,
               "backward": 2 * n}
    out["matmul"] = {k: v - batched[k] for k, v in out["matmul"].items()}
    out["matmul_batched"] = batched
    return out


def router_train_launches(cfg, microbatches: int) -> int:
    """The 2-D launches of a step that take ``"simt"``: the fp32 routers'
    product a MoE layer forward, again in the recompute under
    ``cfg.remat``, and its dA and dB."""
    return moe_layers(cfg) * microbatches * (3 + (1 if cfg.remat else 0))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The port's smoke run on one "
                                 "CUDA card (the module docstring).")
    ap.add_argument("--phase35", action="store_true",
                    help="phase 35 alone: its worlds in one spawn of 4 "
                         "ranks, its gates and kernels-line entries")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    fresh_tables()
    if args.phase35:
        return Smoke(torch).train_axis_alone()
    return Smoke(torch).run()


def fresh_tables() -> None:
    """Point the port's plan table at a fresh, emptied
    ``chiprun_out/autotune/`` with tuning off, and its calibration cache at
    an emptied ``chiprun_out/calibration/``: no table left by an earlier
    run moves a plan in phases 1-23, whose gates are bitwise; phase 24
    fills both."""
    out = os.path.join(ROOT, "chiprun_out")
    for var, sub in (("REPRO_TORCH_AUTOTUNE_CACHE", "autotune"),
                     ("REPRO_TORCH_CALIBRATION_CACHE", "calibration")):
        path = os.path.join(out, sub)
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        os.environ[var] = path
    for var in AUTOTUNE_SWITCHES:
        os.environ.pop(var, None)


class ModelPath:
    """One model of phases 18-22: how to run it and what it must launch.

    ``forward(params, backend, compute_dtype)`` runs the main path on a
    flat parameter dict; ``objective(params, backend, compute_dtype)`` is
    the scalar its backward differentiates (a recipe's loss).  A model
    with a ``recipe`` trains on ``batches`` (the last spoiled by
    ``spoil`` for the NaN step).
    """

    def __init__(self, label, forward, params, out_shape, launches, *,
                 dtypes=(None, "bf16"), objective=None,
                 grad_dtypes=(None, "bf16"), matmuls=0, recipe=None,
                 batches=None, spoil=None, items=1, unit="items"):
        self.label, self.forward, self.params = label, forward, params
        self.out_shape, self.launches = out_shape, launches
        self.dtypes, self.objective = dtypes, objective
        self.grad_dtypes, self.matmuls = grad_dtypes, matmuls
        self.recipe, self.batches, self.spoil = recipe, batches, spoil
        self.items, self.unit = items, unit


class Smoke:
    def __init__(self, torch):
        from repro_torch.kernels import autotune, build
        from repro_torch.kernels import conv2d as kconv
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import matmul as kmm
        from repro_torch.kernels import tiling_policy
        from repro_torch.kernels import transposed_conv as ktr
        from repro_torch.launch import serve_gen

        self.torch = torch
        self.at = autotune
        self.tp = tiling_policy
        self.sg = serve_gen
        self.build = build
        self.kconv = kconv
        self.ktr = ktr
        self.kmm = kmm
        self.kfa = kfa
        self.dev = torch.device("cuda", 0)
        # name -> (kernel launcher, plain version, counted wrapper)
        self.kernels = {
            "conv2d": (kconv.conv2d_cuda, kconv.conv2d_plain, kconv.conv2d),
            "transposed_conv2d": (ktr.tconv_cuda, ktr.tconv_plain,
                                  ktr.transposed_conv2d),
        }
        # every kernel's counted wrapper, by kernel name
        self.counters = {"conv2d": kconv.conv2d,
                         "transposed_conv2d": ktr.transposed_conv2d,
                         "matmul": kmm.matmul,
                         "flash_attention": kfa.flash_attention}
        self.report = {"checks": [], "calls": [], "lm_calls": []}
        self.worst = {name: 0.0 for name in self.counters}
        # phase 23: each lane's launches in one tick, by kernel
        self.serve_launches = {}

    # ---------------------------------------------------------------- utils
    def rand(self, g, *shape):
        return self.torch.randn(shape, generator=g).to(self.dev)

    def bar(self, got, want, floor=1.0, rtol=TOL):
        """(max abs err, mean|plain|, max|plain|, tolerance, err/bar) of
        ``got`` against ``want``.

        fp32: max |err| <= rtol * max(floor, max|plain|).  bf16: |err| <=
        BF16_STEP * |plain| + rtol * max(floor, max|plain|) at every
        element; the tolerance reported is that bar at an element of mean
        size.  err/bar is the worst element's error over its bar, at most 1
        when the check passes."""
        torch = self.torch
        fp32 = want.dtype == torch.float32
        got, want = got.float(), want.float()
        diff, mag = (got - want).abs(), want.abs()
        err, mean, top = (diff.max().item(), mag.mean().item(),
                          mag.max().item())
        scale = max(floor, top)
        if fp32:
            tol = rtol * scale
            worst = err / tol if tol else (0.0 if err == 0 else math.inf)
        else:
            tol = BF16_STEP * mean + rtol * scale
            worst = (diff / (BF16_STEP * mag + rtol * scale)).max().item()
        return err, mean, top, tol, worst

    def specs(self):
        """Every epilogue spec: BN, PReLU and the residual placements."""
        from repro_torch.kernels.epilogue import EpilogueSpec

        return [EpilogueSpec(bn=b, prelu=p, residual=r)
                for b in (False, True) for p in (False, True)
                for r in ("none", "pre_act", "post_act")]

    def ep_args(self, g, spec, out_shape, dtype=None):
        """Random operands of ``spec`` for an output of ``out_shape``, drawn
        from ``g``: fp32 channel operands, the residual in ``dtype`` (fp32
        by default)."""
        cout = out_shape[-1]
        kw = {}
        if spec.bn:
            kw.update(scale=self.rand(g, cout), shift=self.rand(g, cout))
        if spec.prelu:
            kw["alpha"] = self.rand(g, cout if cout % 2 else 1)
        if spec.residual != "none":
            res = self.rand(g, *out_shape)
            kw["residual"] = res if dtype is None else res.to(dtype)
        return tuple(kw[s] for s in spec.slots)

    def compare(self, label, name, got, want, quiet=False, floor=1.0,
                rtol=TOL):
        """Hold a kernel's output against its plain version at
        :meth:`bar`; raise on a miss.  Returns (max abs err, max rel err,
        tolerance)."""
        torch = self.torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{label}: {tuple(got.shape)} {got.dtype} != "
                               f"{tuple(want.shape)} {want.dtype}")
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{label}: non-finite kernel output")
        err, mean, top, tol, worst = self.bar(got, want, floor, rtol)
        rel, ok = err / max(floor, top, 1e-30), worst <= 1.0
        self.report["checks"].append({
            "label": label, "kernel": name, "max_abs_err": err,
            "max_rel_err": rel, "tol": tol, "err_over_bar": worst,
            "mean_abs_plain": mean, "max_abs_plain": top, "ok": ok})
        self.worst[name] = max(self.worst.get(name, 0.0), err)
        if not quiet:
            log(f"  {label}: max abs {err:.2e} rel {rel:.2e} err/bar "
                f"{worst:.3f} tol {tol:.2e} mean|plain| {mean:.2e}")
        if not ok:
            raise RuntimeError(f"{label}: error {worst:.3f} x its bar (max "
                               f"abs err {err:.3e}, tol {tol:.3e})")
        return err, rel, tol

    def sensitivity(self, got, want, floor, rtol):
        """err/bar that ``got`` zeroed and ``got`` off by 2% would reach:
        both must exceed 1 for the check to catch a wrong output."""
        return (self.bar(self.torch.zeros_like(got), want, floor, rtol)[4],
                self.bar(got * 1.02, want, floor, rtol)[4])

    @contextlib.contextmanager
    def recording(self, calls):
        """Record every kernel launch's arguments as (name, args)."""
        kconv, ktr = self.kconv, self.ktr
        orig = (kconv.conv2d_cuda, ktr.tconv_cuda)

        def rec(name, fn):
            def wrapper(*args, **kw):
                calls.append((name, args))
                return fn(*args, **kw)
            return wrapper

        kconv.conv2d_cuda = rec("conv2d", orig[0])
        ktr.tconv_cuda = rec("transposed_conv2d", orig[1])
        try:
            yield
        finally:
            kconv.conv2d_cuda, ktr.tconv_cuda = orig

    def device_ms(self, fn, reps=10, rounds=3):
        """Median device time of one ``fn()``, in ms: the median over
        ``rounds`` of ``reps`` back-to-back calls.

        A spin kernel holds the stream while the host enqueues ``reps``
        calls, so the events bracket back-to-back device work and not the
        host's launch latency: it spins 4x the host's time to enqueue them
        (read from the second warm-up call), at least 1 ms.
        """
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        spin = int(max(4 * reps * (time.perf_counter() - t0), 1e-3)
                   * SPIN_CYCLES_PER_S)
        times = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)

    def reset_counts(self):
        for wrapper in self.counters.values():
            wrapper.launches = 0
            by_variant = getattr(wrapper, "launches_by_variant", {})
            for variant in by_variant:
                by_variant[variant] = 0
        self.counters["flash_attention"].launches_windowed = 0
        self.counters["matmul"].launches_batched = 0

    def read_counts(self):
        return {name: w.launches for name, w in self.counters.items()}

    def read_variants(self):
        """Launches by variant of the kernels that have variants."""
        return {name: dict(w.launches_by_variant)
                for name, w in self.counters.items()
                if hasattr(w, "launches_by_variant")}

    def wall_ms(self, fn, reps=10, warmup=2):
        """Median wall time of ``fn()`` ending in a synchronize, in ms,
        after ``warmup`` untimed calls."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    # -------------------------------------------------------------- phases
    def run(self) -> int:
        torch = self.torch
        card = card_line()
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

        t0 = time.perf_counter()
        libs = self.build.build()
        log(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
        self.report["phase_seconds"] = {"2 (build)": time.perf_counter() - t0}
        self.report["resources"] = {}
        for name in libs:
            for fn, use in self.build.resource_usage(name).items():
                self.report["resources"][fn] = use
                log(f"  {fn}: {use.get('registers')} registers, "
                    f"{use.get('spill_stores')} B spill stores, "
                    f"{use.get('spill_loads')} B spill loads (ptxas)")
        timed = self.timed
        model, x = self.make_model()
        calls = timed("3", self.phase_kernels, model, x)
        y = timed("4", self.phase_main, model, x)
        kernels_line, times = timed("5", self.phase_times, model, x, calls)
        self.report.update(times)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        del model, x, calls
        torch.cuda.empty_cache()

        batch = self.seg_batch(0)
        bwd_calls, taps = timed("6", self.phase_backward_kernels, params,
                                batch)
        timed("7", self.phase_backward_edges)
        steps = timed("8", self.phase_train, params, batch)
        kernels_line["kernels"] += timed("9", self.phase_train_times, steps,
                                         batch, bwd_calls, taps)
        fp32_train = {b: {k: run[k] for k in ("losses", "grad_norms")}
                      for b, run in steps.items()}
        del params, batch, bwd_calls, taps, steps
        torch.cuda.empty_cache()

        timed("10", self.phase_lm_kernels)
        lm_calls = timed("11", self.phase_lm_main)
        kernels_line["kernels"] += timed("12", self.phase_lm_times, lm_calls)
        del lm_calls
        torch.cuda.empty_cache()

        kernels_line["kernels"] += timed("14-17", self.run_bf16, fp32_train)
        kernels_line["kernels"] += timed("18-22", self.run_models)
        for phase, run in (("23", self.run_serving), ("24", self.run_tuning)):
            kernels_line["kernels"] += timed(phase, run)
            torch.cuda.empty_cache()
        for phase, run in (("25", self.run_lm_serving),
                           ("26", self.run_lm_training),
                           ("27", self.run_whisper), ("28", self.run_gemma),
                           ("29", self.run_moe),
                           ("30", self.run_moe_training),
                           ("31", self.run_recurrent),
                           ("32", self.run_rec_training),
                           ("33", self.run_data_axis)):
            kernels_line["kernels"] += timed(phase, run)
            torch.cuda.empty_cache()
        log("seconds by phase: " + ", ".join(
            f"{k} {v:.1f}" for k, v in self.report["phase_seconds"].items())
            + f"; in all {time.perf_counter() - t0:.1f} s")
        self.write_report(card)
        log(f"class maps: {tuple(y.argmax(-1).shape)}")
        log(card)
        log(json.dumps(kernels_line))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    def timed(self, phase, fn, *args):
        """``fn(*args)``, its seconds logged and kept under phase
        ``phase``."""
        t0 = time.perf_counter()
        out = fn(*args)
        secs = self.report["phase_seconds"][phase] = time.perf_counter() - t0
        log(f"phase {phase}: {secs:.1f} s")
        return out

    def write_report(self, card):
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
                  "w") as f:
            json.dump({"card": card, **self.report}, f, indent=1)

    def make_model(self):
        """ENet-512 (19 classes) with seeded random weights.  BN scales and
        shifts and the PReLU slopes are drawn too: at init every closing BN
        scale is zero and would hide each bottleneck's conv chain."""
        torch = self.torch
        from repro_torch.models.enet import ENet

        g = torch.Generator().manual_seed(SEED)
        model = ENet(CLASSES, generator=g)
        with torch.no_grad():
            for name, p in model.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if name.endswith(".g"):
                    k = 0.4 if ".bn3." in name else 1.0
                    p.copy_(k * (0.5 + 0.5 * torch.rand(p.shape, generator=g)))
                elif name.endswith(".b"):
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))
                elif leaf in ("a1", "a2", "a3"):
                    p.copy_(0.1 + 0.3 * torch.rand(p.shape, generator=g))
        x = self.rand(g, BATCH, HW, HW, 3)
        return model, x

    def phase_kernels(self, model, x):
        torch = self.torch
        from repro_torch.core.dilated import dilated_conv2d_reference
        from repro_torch.kernels.dilated_conv import dilated_conv2d
        from repro_torch.kernels.epilogue import (EpilogueSpec,
                                                  apply_reference)

        log("phase 3: kernel vs plain version on the card "
            f"(tol {TOL} x max(1, max|plain|))")
        calls = []
        with torch.no_grad(), self.recording(calls):
            model(x)
        torch.cuda.synchronize()
        seen = {}
        for i, (name, args) in enumerate(calls):
            kern, plain, _ = self.kernels[name]
            key = (name, self.geometry(name, args))
            seen.setdefault(key, []).append(self.compare(
                f"enet call {i}", name, kern(*args), plain(*args),
                quiet=True))
        for (name, geo), errs in seen.items():
            log(f"  {name} {geo} x{len(errs)}: max abs "
                f"{max(e[0] for e in errs):.2e} rel "
                f"{max(e[1] for e in errs):.2e} tol "
                f"{min(e[2] for e in errs):.2e}")
        log(f"  {len(calls)} ENet calls, {len(seen)} distinct geometries: ok")

        g = torch.Generator().manual_seed(SEED + 1)
        kconv, ktr = self.kconv, self.ktr
        for label, xs, ws, s, pads in DENSE_EDGES:
            xx, ww = self.rand(g, *xs), self.rand(g, *ws)
            self.compare(label, "conv2d",
                         kconv.conv2d(xx, ww, stride=s, padding=pads),
                         kconv.conv2d_plain(xx, ww, s, pads,
                                            EpilogueSpec(), ()))
        xx, ww = self.rand(g, 2, 19, 23, 24), self.rand(g, 3, 3, 24, 40)
        for spec in self.specs():
            eps = self.ep_args(g, spec, (2, 19, 23, 40))
            self.compare(f"epilogue {spec}", "conv2d",
                         kconv.conv2d_cuda(xx, ww, 1, ((1, 1), (1, 1)), spec,
                                           eps),
                         kconv.conv2d_plain(xx, ww, 1, ((1, 1), (1, 1)), spec,
                                            eps))
        spec = EpilogueSpec(bn=True, prelu=True, residual="pre_act")
        for d in (2, 4, 8, 16):
            xx, ww = self.rand(g, 2, 45, 38, 32), self.rand(g, 3, 3, 32, 32)
            eps = self.ep_args(g, spec, (2, 45, 38, 32))
            kw = dict(zip(spec.slots, eps))
            self.compare(f"dilated d={d}", "conv2d",
                         dilated_conv2d(xx, ww, d, epilogue=spec, **kw),
                         apply_reference(spec, dilated_conv2d_reference(
                             xx, ww, d), eps))
        for label, (n, h, w_), k, s, p_lo, op, cin, cout in TCONV_EDGES:
            xx, ww = self.rand(g, n, h, w_, cin), self.rand(g, k, k, cin, cout)
            sp = (EpilogueSpec(bn=True, residual="post_act") if "k<s" in label
                  else EpilogueSpec())
            oh, ow = (h - 1) * s + 2 * p_lo + op - k + 2, \
                (w_ - 1) * s + 2 * p_lo + op - k + 2
            eps = self.ep_args(g, sp, (n, oh, ow, cout))
            self.compare(label, "transposed_conv2d",
                         ktr.tconv_cuda(xx, ww, s, p_lo, p_lo + op, sp, eps),
                         ktr.tconv_plain(xx, ww, s, p_lo, p_lo + op, sp, eps))
        worst = {k: float(f"{self.worst[k]:.3e}") for k in self.kernels}
        log(f"  all ok; worst max abs err {json.dumps(worst)}")
        return calls

    def phase_main(self, model, x):
        torch = self.torch
        log("phase 4: ENet-512 forward, batch 4, backend=kernels")
        self.reset_counts()
        with torch.no_grad():
            y = model(x)
        torch.cuda.synchronize()
        self.launches = self.read_counts()
        variants = self.read_variants()["conv2d"]
        log(f"  launches per forward: {self.launches}; conv2d by variant "
            f"{variants}")
        if self.launches != LAUNCHES_PER_FORWARD:
            raise RuntimeError(f"launch counts {self.launches} != "
                               f"{LAUNCHES_PER_FORWARD}")
        if variants != CONV_VARIANTS_PER_FORWARD:
            raise RuntimeError(f"conv2d launches by variant {variants} != "
                               f"{CONV_VARIANTS_PER_FORWARD}")
        if tuple(y.shape) != (BATCH, HW, HW, CLASSES):
            raise RuntimeError(f"logits shape {tuple(y.shape)}")
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError("non-finite logits")
        with torch.no_grad():
            y_torch = model(x, backend="torch")
            y_naive = model(x, decomposed=False, backend="torch")
        for label, ref in (("torch backend", y_torch),
                           ("naive zero-laden", y_naive)):
            rel = ((y - ref).norm() / ref.norm()).item()
            self.report["checks"].append({"label": f"enet vs {label}",
                                          "rel_l2": rel, "tol": REL_L2_TOL})
            log(f"  kernels vs {label}: rel L2 {rel:.3e} (tol {REL_L2_TOL})")
            if not rel <= REL_L2_TOL:
                raise RuntimeError(f"ENet kernels vs {label}: rel L2 {rel}")
        log(f"  logits {tuple(y.shape)}, max |y| {y.abs().max().item():.3f}")
        return y

    def phase_times(self, model, x, calls):
        torch = self.torch
        log("phase 5: times (fp32, TF32 off)")
        times = {}
        with torch.no_grad():
            for label, kw in (("kernels", {}),
                              ("torch", {"backend": "torch"}),
                              ("naive", {"backend": "torch",
                                         "decomposed": False})):
                ms = self.wall_ms(lambda: model(x, **kw))
                times[f"forward_{label}_ms"] = ms
                log(f"  ENet forward {label}: {ms:.3f} ms/batch, "
                    f"{BATCH / ms * 1e3:.1f} images/s")
        times["naive_over_kernels"] = (times["forward_naive_ms"]
                                       / times["forward_kernels_ms"])

        def forward():
            with torch.no_grad():
                model(x)

        times["profile"] = self.profile_device(forward, "forward",
                                               times["forward_kernels_ms"])
        rows, per = self.time_calls(calls)
        self.report["calls"] = rows
        entries = []
        for name, p in per.items():
            log(f"  {name}: {p['ms']:.3f} ms/forward over "
                f"{self.launches[name]} launches; bound {p['bound_ms']:.3f} "
                f"ms ({p['flops'] / 1e9:.2f} GFLOP, {p['bytes'] / 1e6:.1f} MB)"
                f"; plain {p['plain_ms']:.3f} ms; library "
                f"{p['library_ms']:.3f} ms")
            entries.append(self.kernel_entry(name, name, self.launches[name],
                                             p))
            times[f"{name}_per_forward"] = p
        times["geometries"] = self.geometry_table(rows, "a forward")
        return {"kernels": entries}, times

    def time_calls(self, calls, fp32_too=False, reps=10):
        """Per recorded kernel call: device ms of the kernel, its plain
        version and its library call, beside its work and bound (at the
        peak of the call's dtype: the CUDA cores' fp32 rate, or the bf16
        tensor-core rate for bf16).  ``fp32_too``: also the kernel's ms on
        the same call in fp32.  Returns the rows and their sums per
        kernel."""
        torch = self.torch
        keys = ["ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
                "bytes_ms", "flops", "bytes"] + (["fp32_ms"] if fp32_too
                                                 else [])
        per = {name: dict.fromkeys(keys, 0.0) for name in self.kernels}
        rows = []
        with torch.no_grad():
            for name, args in calls:
                kern, plain, _ = self.kernels[name]
                lib = self.library_call(name, args)
                flops, nbytes = self.work(name, args)
                peak = (PEAK_FP32_FLOPS if args[0].dtype == torch.float32
                        else PEAK_BF16_FLOPS)
                ops_ms = 1e3 * flops / peak
                bytes_ms = 1e3 * nbytes / PEAK_BYTES_S
                row = {"kernel": name, "geometry": self.geometry(name, args),
                       "variant": self.variant(name, args),
                       "ms": self.device_ms(lambda: kern(*args), reps=reps),
                       "plain_ms": self.device_ms(lambda: plain(*args),
                                                  reps=3),
                       "library_ms": self.device_ms(lib, reps=reps),
                       "flops": flops, "bytes": nbytes,
                       "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                       "bound_ms": max(ops_ms, bytes_ms)}
                if fp32_too:
                    args32 = self.as_fp32(args)
                    row["fp32_ms"] = self.device_ms(lambda: kern(*args32),
                                                    reps=reps)
                rows.append(row)
                for key in keys:
                    per[name][key] += row[key]
        return rows, per

    def as_fp32(self, args):
        """A recorded call's arguments with its tensors (x, w, the residual)
        widened to fp32."""
        torch = self.torch

        def up(a):
            if isinstance(a, tuple):
                return tuple(up(e) for e in a)
            if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
                return a.float()
            return a

        return up(args)

    def kernel_entry(self, name, label, launches, p):
        """One entry of the ``{"kernels": [...]}`` line from per-kernel
        sums ``p`` (``time_calls``)."""
        return {
            "name": label, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches,
            "max_abs_err": self.worst[label], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": ("operations" if p["ops_ms"] >= p["bytes_ms"]
                         else "bytes"),
            "library_ms": p["library_ms"]}

    def geometry_table(self, rows, per):
        """Per-geometry sums of the timed calls (of ``per``, e.g. "a
        forward"), logged as a table: calls, device ms, bound ms and what
        bounds it, x bound, library ms and the launch plan; then the
        geometry furthest from its bound."""
        sums = ["ms", "bound_ms", "ops_ms", "bytes_ms", "library_ms",
                "flops", "bytes"] + (["fp32_ms"] if "fp32_ms" in rows[0]
                                     else [])
        groups = {}
        for r in rows:
            g = groups.setdefault((r["kernel"], r["geometry"]), {
                "kernel": r["kernel"], "geometry": r["geometry"],
                "variant": r["variant"], "calls": 0,
                **dict.fromkeys(sums, 0.0)})
            g["calls"] += 1
            for k in sums:
                g[k] += r[k]
        table = sorted(groups.values(), key=lambda g: -g["ms"])
        fp32 = "fp32_ms" in sums
        log(f"  per geometry (sums over {per}'s calls; device ms):")
        log(f"    {'kernel':18s} {'calls':>5s} {'ms':>7s} {'bound':>7s} "
            f"{'by':5s} {'xbound':>6s} {'library':>7s} "
            + (f"{'fp32':>7s} " if fp32 else "") + " variant  geometry")
        for g in table:
            by = "ops" if g["ops_ms"] >= g["bytes_ms"] else "bytes"
            g["bound_by"] = "operations" if by == "ops" else "bytes"
            g["x_bound"] = g["ms"] / g["bound_ms"]
            log(f"    {g['kernel']:18s} {g['calls']:5d} {g['ms']:7.4f} "
                f"{g['bound_ms']:7.4f} {by:5s} {g['x_bound']:6.1f} "
                f"{g['library_ms']:7.4f} "
                + (f"{g['fp32_ms']:7.4f} " if fp32 else "")
                + f" {g['variant']}  {g['geometry']}")
        worst = max(table, key=lambda g: g["x_bound"])
        log(f"  worst x bound: {worst['x_bound']:.1f} ({worst['kernel']} "
            f"{worst['geometry']}, {worst['ms']:.4f} ms against "
            f"{worst['bound_ms']:.4f})")
        return table

    def profile_device(self, fn, what, wall_ms, classes=None, warmup=True):
        """Device time of one ``fn()`` (a ``what``) by kernel name and by
        the op that launched it (``torch.profiler``), and the device's busy
        share of its wall time measured without the profiler.  Busy time
        sums the device's own events (kernels, copies) only: an op's
        device time is its kernels' time again, so adding both counts it
        twice.  ``classes`` ({class: name substrings}, first match wins)
        also sums every device event by class, the rest under "rest".
        ``warmup=False`` skips the untimed call before the profiled one
        (for a ``fn`` already warm)."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        if warmup:
            fn()
        torch.cuda.synchronize()
        # a profiled window now and then records no device event at all;
        # up to three windows are taken before the share is "not measured"
        for _ in range(3):
            kernels, ops = [], []
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = getattr(e, "self_cuda_time_total", 0)
                if us > 0:
                    (kernels if e.device_type == DeviceType.CUDA
                     else ops).append((us / 1e3, e.count, e.key))
            if kernels:
                break
        kernels.sort(reverse=True)
        ops.sort(reverse=True)
        busy = sum(r[0] for r in kernels)
        if not kernels:
            log("  profiler: no device time recorded (busy share not "
                "measured)")
            return {"device_ms": None}
        log(f"  profiler: device busy {busy:.3f} ms of a {wall_ms:.3f} ms "
            f"{what} ({100 * busy / wall_ms:.1f}%); top kernels:")
        for ms, count, key in kernels[:10]:
            log(f"    {ms:8.3f} ms  x{count:<5d} {key[:90]}")
        log("  device time by the op that launched it:")
        for ms, count, key in ops[:10]:
            log(f"    {ms:8.3f} ms  x{count:<5d} {key[:90]}")
        by_class = None
        if classes:
            by_class = dict.fromkeys([*classes, "rest"], 0.0)
            for ms, _, key in kernels:
                cls = next((c for c, subs in classes.items()
                            if any(sub in key for sub in subs)), "rest")
                by_class[cls] += ms
            log("  device ms by class: " + ", ".join(
                f"{c} {ms:.3f}" for c, ms in by_class.items()))
        return {"device_ms": busy, "busy_share": busy / wall_ms,
                "classes": by_class,
                "top": [{"ms": ms, "count": c, "name": k}
                        for ms, c, k in kernels[:25]],
                "top_ops": [{"ms": ms, "count": c, "name": k}
                            for ms, c, k in ops[:25]]}

    # ------------------------------------------------ ENet-512 training
    def seg_batch(self, step):
        """``SegDataPipeline`` batch ``step`` (batch 4, 512x512, 19
        classes) on the card."""
        from repro_torch.data import SegDataPipeline
        from repro_torch.launch.train_recipes import batch_to

        pipe = SegDataPipeline(BATCH, hw=HW, classes=CLASSES, seed=SEED)
        return batch_to(pipe.batch_at(step), self.dev)

    @contextlib.contextmanager
    def watching(self, counts, taps):
        """Count the library convs, plain versions and ``torch.matmul``
        calls made inside the block, and record every weight-gradient
        tap correlation's arguments."""
        torch = self.torch
        from repro_torch.core import adjoints

        F = torch.nn.functional
        targets = [(F, "conv2d"), (F, "conv_transpose2d"),
                   (self.kconv, "conv2d_plain"), (self.ktr, "tconv_plain"),
                   (torch, "matmul"), (adjoints, "tap_correlation")]
        orig = [getattr(mod, attr) for mod, attr in targets]

        def wrap(attr, fn):
            def wrapper(*args, **kw):
                counts[attr] = counts.get(attr, 0) + 1
                if attr == "tap_correlation":
                    taps.append((args, kw))
                return fn(*args, **kw)
            return wrapper

        for (mod, attr), fn in zip(targets, orig):
            setattr(mod, attr, wrap(attr, fn))
        try:
            yield
        finally:
            for (mod, attr), fn in zip(targets, orig):
                setattr(mod, attr, fn)

    def phase_backward_kernels(self, params, batch):
        torch = self.torch
        from repro_torch.launch import train_recipes as ttr
        from repro_torch.optim import DynamicLossScale

        log("phase 6: ENet-512 backward of the loss-scaled objective, batch "
            f"4: kernel calls vs plain (tol {TOL} x max|plain| per call)")
        scaler = DynamicLossScale()
        scale = scaler.init(self.dev)
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = scaler.scale(scale, ttr.loss_fn("enet")(leaves, batch))
        calls, taps, counts = [], [], {}
        with self.recording(calls), self.watching(counts, taps):
            torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        matmuls = sum(a[2] * a[3] for a, _ in taps)
        log(f"  {len(calls)} kernel calls; {len(taps)} weight gradients as "
            f"{matmuls} tap matmuls; other calls {counts}")
        want = {"conv2d": 0, "conv_transpose2d": 0, "conv2d_plain": 0,
                "tconv_plain": 0, "matmul": matmuls,
                "tap_correlation": len(taps)}
        if {k: counts.get(k, 0) for k in want} != want:
            raise RuntimeError(f"backward calls {counts} != {want}: a conv "
                               f"left the kernels or a matmul is not a tap")
        seen, caught = {}, []
        for i, (name, args) in enumerate(calls):
            kern, plain, _ = self.kernels[name]
            got, ref = kern(*args), plain(*args)
            key = (name, self.geometry(name, args), self.variant(name, args))
            # the cotangents are small (mean |dx| down to ~1e-3 at the
            # 2^15 loss scale), so the bar scales with each call's values:
            # no max(1, .) floor
            seen.setdefault(key, []).append(self.compare(
                f"enet backward call {i}", f"{name} (ENet backward)",
                got, ref, quiet=True, floor=0.0))
            caught.append((*self.sensitivity(got, ref, 0.0, TOL),
                           self.bar(torch.zeros_like(got), ref)[4]))
        for (name, geo, variant), errs in seen.items():
            log(f"  {name} [{variant}] {geo} x{len(errs)}: max abs "
                f"{max(e[0] for e in errs):.2e} tol "
                f"{min(e[2] for e in errs):.2e}")
        zero, off, old = (min(c[i] for c in caught) for i in range(3))
        loose = sum(c[2] <= 1.0 for c in caught)
        log(f"  {len(calls)} backward calls, {len(seen)} distinct geometries "
            f"and variants: ok; a zeroed output would reach >= {zero:.3g} x "
            f"the bar and one 2% off >= {off:.3g} x; under a bar of {TOL} x "
            f"max(1, max|plain|) {loose} of the {len(calls)} zeroed outputs "
            f"would pass (min {old:.3g} x)")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("the backward check would pass a zeroed or a "
                               "2%-off kernel output")
        self.report["backward_check"] = {
            "loss_scale": scale.scale.item(), "rtol": TOL, "floor": 0.0,
            "calls": len(calls), "min_zeroed_over_bar": zero,
            "min_off_2pct_over_bar": off,
            "min_zeroed_over_floored_bar": old,
            "zeroed_passing_floored_bar": loose}
        return calls, taps

    def grad_cases(self):
        """(label, conv kwargs, x shape, w shape, epilogue spec, the kernel
        the backward must launch) of phase 7."""
        specs = self.specs()
        tconv = dict(stride=2, transposed=True, output_padding=1)
        return [
            ("dx on kernel 2: k2 s2 p0", dict(stride=2, padding=0),
             (2, 32, 30, 16), (2, 2, 16, 32), None, "transposed_conv2d"),
            ("dx on kernel 2: k3 s2 SAME", dict(stride=2), (2, 33, 31, 16),
             (3, 3, 16, 24), None, "transposed_conv2d"),
            ("dx on kernel 2: k4 s2 p1", dict(stride=2, padding=1),
             (2, 32, 30, 8), (4, 4, 8, 20), None, "transposed_conv2d"),
            ("dx of 5x1", {}, (2, 21, 19, 32), (5, 1, 32, 32), None,
             "conv2d"),
            ("dx of 1x5", {}, (2, 21, 19, 32), (1, 5, 32, 32), None,
             "conv2d"),
            ("tconv dx k3 s2 op1 Cout19", tconv, (2, 16, 16, 16),
             (3, 3, 16, 19), None, "conv2d"),
            ("strided dilated d2 s2", dict(dilation=2, stride=2),
             (2, 24, 22, 16), (3, 3, 16, 16), None, "conv2d"),
            ("dilated d2, own adjoint", dict(dilation=2), (2, 25, 23, 16),
             (3, 3, 16, 16), None, "conv2d"),
            ("dilated d4, own adjoint", dict(dilation=4), (2, 45, 38, 32),
             (3, 3, 32, 32), None, "conv2d"),
            *[(f"dense epilogue {sp}", {}, (2, 19, 23, 24), (3, 3, 24, 40),
               sp, "conv2d") for sp in specs],
            *[(f"transposed epilogue {sp}", tconv, (2, 9, 11, 16),
               (3, 3, 16, 20), sp, "conv2d") for sp in specs],
        ]

    def phase_backward_edges(self):
        torch = self.torch
        from repro_torch.core.decompose import conv2d

        log("phase 7: backward edge cases, kernels vs backend=torch autograd "
            f"(cuDNN, TF32 off); per tensor max |err| <= {TOL} x max(1, "
            "max|ref|)")
        g = torch.Generator().manual_seed(SEED + 2)
        for label, kw, xs, ws, spec, must in self.grad_cases():
            # He-scaled weights keep y O(1): at |y| ~ 50, sin'(y) would
            # turn the forward's fp32 rounding into cotangent errors near
            # the bar whatever the backward does
            x = self.rand(g, *xs)
            w = self.rand(g, *ws) * (ws[0] * ws[1] * ws[2]) ** -0.5
            with torch.no_grad():
                cout = conv2d(x, w, backend="torch", **kw).shape
            ops = {}
            if spec is not None and spec.bn:
                ops["scale"] = self.rand(g, cout[-1])
                ops["shift"] = self.rand(g, cout[-1])
            if spec is not None and spec.prelu:
                ops["alpha"] = 0.3 * self.rand(g, 1 if spec.bn else cout[-1])
            if spec is not None and spec.residual != "none":
                ops["residual"] = self.rand(g, *cout)
            grads = {}
            for backend in ("kernels", "torch"):
                prims = [t.detach().requires_grad_()
                         for t in (x, w, *ops.values())]
                y = conv2d(prims[0], prims[1], backend=backend,
                           epilogue=spec, **dict(zip(ops, prims[2:])), **kw)
                if backend == "kernels" and "own adjoint" in label and \
                        type(y.grad_fn).__name__ != "_DilatedFnBackward":
                    raise RuntimeError(f"{label}: took {y.grad_fn}")
                self.reset_counts()
                grads[backend] = torch.autograd.grad(torch.sin(y).sum(),
                                                     prims)
                torch.cuda.synchronize()
                if backend == "kernels" and not self.read_counts()[must]:
                    raise RuntimeError(f"{label}: the backward launched no "
                                       f"{must}")
            for part, got, want in zip(["x", "w", *ops], grads["kernels"],
                                       grads["torch"]):
                self.compare(f"{label} d{part}", "gradients vs torch", got,
                             want, quiet=True)
            log(f"  {label}: {len(grads['torch'])} gradients ok")

    def phase_train(self, params, batch):
        torch = self.torch
        from repro_torch.launch import train_recipes as ttr

        log("phase 8: ENet-512 training, batch 4, 19 classes, "
            f"SegDataPipeline batches 0-{TRAIN_STEPS - 1}")
        if not (torch.get_float32_matmul_precision() == "highest"
                and not torch.backends.cuda.matmul.allow_tf32
                and not torch.backends.cudnn.allow_tf32):
            raise RuntimeError("TF32 is on: fp32 matmuls or convs would "
                               "round their inputs")
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        self.reset_counts()
        loss = ttr.loss_fn("enet")(leaves, batch)
        torch.cuda.synchronize()
        launches = {"forward": self.read_counts()}
        self.reset_counts()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        launches["backward"] = self.read_counts()
        variants = self.read_variants()["conv2d"]
        log(f"  launches per step: {launches}; backward conv2d by variant "
            f"{variants}")
        if launches != LAUNCHES_PER_STEP:
            raise RuntimeError(f"launches {launches} != {LAUNCHES_PER_STEP}")
        value_t, grads_t = ttr.loss_and_grads(
            ttr.loss_fn("enet", backend="torch"), params, batch)
        rel = abs(loss.item() - value_t.item()) / abs(value_t.item())
        log(f"  step-0 loss {loss.item():.6f}, torch backend "
            f"{value_t.item():.6f} (rel {rel:.2e})")
        if not rel <= TRAIN_LOSS_RTOL:
            raise RuntimeError(f"step-0 loss differs by {rel:.3e}")
        # err / max|ref| per tensor, the readings GRAD_RTOL was set from
        ratios = sorted(((self.bar(got, grads_t[name], 0.0, 1.0)[4], name)
                         for name, got in zip(leaves, grads)), reverse=True)
        log("  step-0 gradients, largest max|err| / max|ref|: " + ", ".join(
            f"{name} {r:.2e}" for r, name in ratios[:5]))
        caught = []
        for name, got in zip(leaves, grads):
            self.compare(f"step-0 grad {name}", "gradients vs torch", got,
                         grads_t[name], quiet=True)
            self.compare(f"step-0 grad {name}, relative",
                         "gradients vs torch", got, grads_t[name],
                         quiet=True, floor=0.0, rtol=GRAD_RTOL)
            caught.append(self.sensitivity(got, grads_t[name], 0.0,
                                           GRAD_RTOL))
        zero, off = (min(c[i] for c in caught) for i in range(2))
        log(f"  step-0 gradients: {len(grads)} tensors ok at {TOL} x max(1, "
            f"max|ref|) and at {GRAD_RTOL} x max|ref|; against the latter a "
            f"zeroed tensor would reach >= {zero:.3g} x the bar, one 2% off "
            f">= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("the gradient check would pass a zeroed or a "
                               "2%-off gradient")

        state0 = ttr.init_state(params)
        steps = {}
        per_step = {k: launches["forward"][k] + launches["backward"][k]
                    for k in launches["forward"]}
        batches = [batch] + [self.seg_batch(i)
                             for i in range(1, TRAIN_STEPS + 1)]
        for backend in ("kernels", "torch"):
            step = ttr.make_train_step("enet", backend=backend)
            state, losses, gnorms = state0, [], []
            for i in range(TRAIN_STEPS):
                self.reset_counts()
                state, m = step(state, batches[i])
                torch.cuda.synchronize()
                counts = self.read_counts()
                want = (per_step if backend == "kernels"
                        else dict.fromkeys(per_step, 0))
                if counts != want:
                    raise RuntimeError(f"{backend} step launches {counts} != "
                                       f"{want}")
                if m["skipped"].item():
                    raise RuntimeError(f"{backend} step skipped")
                losses.append(m["loss"].item())
                gnorms.append(m["grad_norm"].item())
            steps[backend] = {"step": step, "state": state, "losses": losses,
                              "grad_norms": gnorms}
            log(f"  {backend}: losses {losses}, launches per step {counts}")
        lk, lt = steps["kernels"]["losses"], steps["torch"]["losses"]
        rels = [abs(a - b) / abs(b) for a, b in zip(lk, lt)]
        if not (all(r <= TRAIN_LOSS_RTOL for r in rels)
                and all(map(math.isfinite, lk)) and lk[-1] <= lk[0]):
            raise RuntimeError(f"losses {lk} vs torch {lt} (rel {rels}): "
                               f"not within {TRAIN_LOSS_RTOL}, not finite or "
                               f"rising")
        log(f"  losses agree (rel {max(rels):.2e}), finite, fall "
            f"{lk[0]:.6f} -> {lk[-1]:.6f}")

        state = steps["kernels"]["state"]
        bad = batches[TRAIN_STEPS]
        bad["image"][0, 5, 7, 1] = float("nan")
        after, m = steps["kernels"]["step"](state, bad)
        same = all(torch.equal(a, b) for a, b in zip(
            self.leaves((after.params, after.opt)),
            self.leaves((state.params, state.opt))))
        halved = after.scale.scale.item() == state.scale.scale.item() / 2
        log(f"  NaN batch: skipped {m['skipped'].item()}, params and AdamW "
            f"state bit-identical {same}, scale {state.scale.scale.item()} "
            f"-> {after.scale.scale.item()}")
        if not (m["skipped"].item() == 1.0 and same and halved):
            raise RuntimeError("the NaN batch was not skipped cleanly")
        self.report["train"] = {
            "launches_per_step": launches, "backward_variants": variants,
            "step0_loss": loss.item(), "step0_loss_torch": value_t.item(),
            "losses": {"kernels": lk, "torch": lt},
            "step0_grad_rtol": GRAD_RTOL,
            "step0_grad_err_over_max_ref": dict(
                (name, r) for r, name in ratios),
            "worst_grad_abs_err": self.worst["gradients vs torch"]}
        return steps

    def leaves(self, tree):
        """The tensors of a tree of dicts and tuples, in order."""
        if isinstance(tree, dict):
            return [t for k in sorted(tree) for t in self.leaves(tree[k])]
        if isinstance(tree, tuple):
            return [t for item in tree for t in self.leaves(item)]
        return [] if tree is None else [tree]

    def phase_train_times(self, steps, batch, bwd_calls, taps):
        torch = self.torch
        from repro_torch.core import adjoints

        from repro_torch.launch import train_recipes as ttr

        log("phase 9: train-step times (fp32, TF32 off)")
        times = {}
        for backend, run in steps.items():
            state = run["state"]

            def one():
                nonlocal state
                state, _ = run["step"](state, batch)

            ms = self.wall_ms(one)
            loss = ttr.loss_fn("enet", backend=backend)
            grad_ms = self.wall_ms(
                lambda: ttr.loss_and_grads(loss, state.params, batch))
            torch.cuda.reset_peak_memory_stats()
            one()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            times[f"step_{backend}_ms"] = ms
            times[f"loss_and_grads_{backend}_ms"] = grad_ms
            times[f"peak_gib_{backend}"] = peak
            log(f"  ENet-512 train step, backend={backend}: {ms:.3f} ms, "
                f"{BATCH / ms * 1e3:.1f} images/s (median of 10); of it "
                f"forward + backward {grad_ms:.3f} ms, the loss scaling, "
                f"skip and AdamW the other {ms - grad_ms:.3f}; peak device "
                f"memory {peak:.2f} GiB")
            if backend == "kernels":
                times["profile"] = self.profile_device(
                    one, "train step", ms)
        rows, per = self.time_calls(bwd_calls)
        self.report["backward_calls"] = rows
        times["geometries"] = self.geometry_table(rows, "a backward")
        tap_ms = sum(self.device_ms(
            lambda a=a, kw=kw: adjoints.tap_correlation(*a, **kw), reps=3,
            rounds=1) for a, kw in taps)
        matmuls = sum(a[2] * a[3] for a, _ in taps)
        times["weight_gradients"] = {"tap_correlations": len(taps),
                                     "matmuls": matmuls, "ms": tap_ms}
        log(f"  weight gradients: {len(taps)} tap correlations, {matmuls} "
            f"torch.matmul calls, {tap_ms:.3f} ms of device time a step")
        entries = []
        for name, p in per.items():
            label = f"{name} (ENet backward)"
            n = self.report["train"]["launches_per_step"]["backward"][name]
            log(f"  {label}: {p['ms']:.3f} ms over {n} launches; bound "
                f"{p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f} ms; "
                f"library {p['library_ms']:.3f} ms")
            entries.append(self.kernel_entry(name, label, n, p))
            times[f"{name}_per_backward"] = p
        self.report["train"].update(times)
        return entries

    # ------------------------------------------------------ the bf16 slice
    def run_bf16(self, fp32_train):
        """Phases 14-17 on phase 4's ENet-512 (the same seeded weights, fp32
        masters): kernels, serving, training and times in bf16.  Returns
        the bf16 entries of the kernels line."""
        torch = self.torch
        model, x = self.make_model()
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        batch = self.seg_batch(0)
        fwd_calls, bwd_calls = self.phase_bf16_kernels(model, x, params,
                                                       batch)
        self.phase_bf16_main(model, x)
        steps = self.phase_bf16_train(params, fp32_train)
        entries = self.phase_bf16_times(model, x, batch, steps, fwd_calls,
                                        bwd_calls)
        del model, x, params, batch, fwd_calls, bwd_calls, steps
        torch.cuda.empty_cache()
        return entries

    def phase_bf16_kernels(self, model, x, params, batch):
        torch = self.torch
        from repro_torch.core.dilated import dilated_conv2d_reference
        from repro_torch.kernels.dilated_conv import dilated_conv2d
        from repro_torch.kernels.epilogue import (EpilogueSpec,
                                                  apply_reference)
        from repro_torch.launch import train_recipes as ttr
        from repro_torch.optim import DynamicLossScale

        bf16 = torch.bfloat16
        log("phase 14: bf16 kernels vs plain on the card (each element: "
            f"2^-7 |plain| + {TOL} x max(1, max|plain|); backward calls of "
            "the 2^15-scaled loss without the max(1, .) floor)")
        fwd_calls, bwd_calls = [], []
        with torch.no_grad(), self.recording(fwd_calls):
            model(x, compute_dtype="bf16")
        scaler = DynamicLossScale()
        scale = scaler.init(self.dev)
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = scaler.scale(scale, ttr.loss_fn("enet", compute_dtype="bf16")(
            leaves, batch))
        with self.recording(bwd_calls):
            torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        del loss, leaves
        caught = []
        for part, calls, floor in (("forward", fwd_calls, 1.0),
                                   ("backward", bwd_calls, 0.0)):
            seen = {}
            for i, (name, args) in enumerate(calls):
                if args[0].dtype != bf16 or args[1].dtype != bf16:
                    raise RuntimeError(f"bf16 {part} call {i} of {name} "
                                       f"took {args[0].dtype} operands")
                kern, plain, _ = self.kernels[name]
                label = (f"{name} (bf16)" if part == "forward"
                         else f"{name} (bf16, ENet backward)")
                got, ref = kern(*args), plain(*args)
                key = (name, self.geometry(name, args),
                       self.variant(name, args))
                seen.setdefault(key, []).append(self.compare(
                    f"bf16 {part} call {i}", label, got, ref, quiet=True,
                    floor=floor))
                caught.append(self.sensitivity(got, ref, floor, TOL))
            for (name, geo, variant), errs in seen.items():
                log(f"  {part} {name} [{variant}] {geo} x{len(errs)}: max "
                    f"abs {max(e[0] for e in errs):.2e} tol "
                    f"{min(e[2] for e in errs):.2e}")
            log(f"  {len(calls)} bf16 {part} calls, {len(seen)} distinct "
                "geometries and variants: ok")

        g = torch.Generator().manual_seed(SEED + 5)

        def rand16(*shape):
            return self.rand(g, *shape).to(bf16)

        def ep_args(spec, out_shape):
            return self.ep_args(g, spec, out_shape, bf16)

        kconv, ktr = self.kconv, self.ktr
        none = EpilogueSpec()

        def check(label, name, got, want):
            self.compare(f"bf16 {label}", f"{name} (bf16)", got, want)
            caught.append(self.sensitivity(got, want, 1.0, TOL))

        dense = DENSE_EDGES + [
            ("head dx: Cin-19 cotangent, 3x3 s2 VALID", (2, 33, 35, 19),
             (3, 3, 19, 16), 2, ((0, 0), (0, 0)))]
        for label, xs, ws, s, pads in dense:
            xx, ww = rand16(*xs), rand16(*ws)
            check(label, "conv2d",
                  kconv.conv2d(xx, ww, stride=s, padding=pads),
                  kconv.conv2d_plain(xx, ww, s, pads, none, ()))
        # base pointers 2 and 8 bytes past a 16-byte boundary: plain
        # 2-byte loads and 8-byte copies
        for skip in (1, 4):
            flat = rand16(skip + 2 * 17 * 19 * 32)
            xx = flat[skip:].view(2, 17, 19, 32)
            ww = rand16(3, 3, 32, 16)
            variant = kconv.launch_plan(xx, ww, 1).variant
            check(f"x {2 * skip} bytes off 16 ({variant})", "conv2d",
                  kconv.conv2d_cuda(xx, ww, 1, ((1, 1), (1, 1)), none, ()),
                  kconv.conv2d_plain(xx, ww, 1, ((1, 1), (1, 1)), none, ()))
            xt = flat[skip:skip + 2 * 9 * 11 * 16].view(2, 9, 11, 16)
            wt = rand16(3, 3, 16, 16)
            check(f"transposed x {2 * skip} bytes off 16", "transposed_conv2d",
                  ktr.tconv_cuda(xt, wt, 2, 1, 2, none, ()),
                  ktr.tconv_plain(xt, wt, 2, 1, 2, none, ()))
        xx, ww = rand16(2, 19, 23, 24), rand16(3, 3, 24, 40)
        for spec in self.specs():
            eps = ep_args(spec, (2, 19, 23, 40))
            check(f"epilogue {spec}", "conv2d",
                  kconv.conv2d_cuda(xx, ww, 1, ((1, 1), (1, 1)), spec, eps),
                  kconv.conv2d_plain(xx, ww, 1, ((1, 1), (1, 1)), spec, eps))
            eps_t = ep_args(spec, (2, 38, 46, 20))
            xt, wt = rand16(2, 19, 23, 16), rand16(3, 3, 16, 20)
            check(f"transposed epilogue {spec}", "transposed_conv2d",
                  ktr.tconv_cuda(xt, wt, 2, 1, 2, spec, eps_t),
                  ktr.tconv_plain(xt, wt, 2, 1, 2, spec, eps_t))
        spec = EpilogueSpec(bn=True, prelu=True, residual="pre_act")
        for d in (2, 4, 8, 16):
            xx, ww = rand16(2, 45, 38, 32), rand16(3, 3, 32, 32)
            eps = ep_args(spec, (2, 45, 38, 32))
            kw = dict(zip(spec.slots, eps))
            # the kernel's semantics: fp32 conv of the widened operands
            # (cuDNN, TF32 off), fp32 epilogue, one rounding
            eps32 = eps[:-1] + (eps[-1].float(),)
            check(f"dilated d={d}", "conv2d",
                  dilated_conv2d(xx, ww, d, epilogue=spec, **kw),
                  apply_reference(spec, dilated_conv2d_reference(
                      xx.float(), ww.float(), d), eps32).to(bf16))
        for label, (n, h, w_), k, s, p_lo, op, cin, cout in TCONV_EDGES:
            xx, ww = rand16(n, h, w_, cin), rand16(k, k, cin, cout)
            sp = (EpilogueSpec(bn=True, residual="post_act") if "k<s" in label
                  else none)
            oh, ow = (h - 1) * s + 2 * p_lo + op - k + 2, \
                (w_ - 1) * s + 2 * p_lo + op - k + 2
            eps = ep_args(sp, (n, oh, ow, cout))
            check(label, "transposed_conv2d",
                  ktr.tconv_cuda(xx, ww, s, p_lo, p_lo + op, sp, eps),
                  ktr.tconv_plain(xx, ww, s, p_lo, p_lo + op, sp, eps))
        zero, off = (min(c[i] for c in caught) for i in range(2))
        log(f"  {len(caught)} bf16 checks ok; a zeroed output would reach "
            f">= {zero:.3g} x its bar and one 2% off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("the bf16 check would pass a zeroed or a "
                               "2%-off kernel output")
        worst = {k: float(f"{v:.3e}") for k, v in self.worst.items()
                 if "bf16" in k}
        log(f"  worst max abs err {json.dumps(worst)}")
        self.report["bf16_check"] = {
            "calls": {"forward": len(fwd_calls), "backward": len(bwd_calls)},
            "checks": len(caught), "min_zeroed_over_bar": zero,
            "min_off_2pct_over_bar": off}
        return fwd_calls, bwd_calls

    def phase_bf16_main(self, model, x):
        torch = self.torch
        log("phase 15: serve ENet-512 in bf16, batch 4, 19 classes, "
            "backend=kernels")
        counts, taps = {}, []
        self.reset_counts()
        with torch.no_grad(), self.watching(counts, taps):
            y = model(x, compute_dtype="bf16")
        torch.cuda.synchronize()
        launches = self.read_counts()
        variants = self.read_variants()["conv2d"]
        log(f"  launches per forward: {launches}; conv2d by variant "
            f"{ {k: v for k, v in variants.items() if v} }; other calls "
            f"{counts}")
        want = dict.fromkeys(variants, 0)
        want.update(BF16_VARIANTS["forward"])
        if launches != LAUNCHES_PER_FORWARD or variants != want:
            raise RuntimeError(f"bf16 launches {launches}, {variants} != "
                               f"{LAUNCHES_PER_FORWARD}, {want}")
        if any(counts.values()):
            raise RuntimeError(f"the bf16 forward left the kernels: {counts}")
        if y.dtype != torch.bfloat16 or tuple(y.shape) != (BATCH, HW, HW,
                                                            CLASSES):
            raise RuntimeError(f"bf16 logits {y.dtype} {tuple(y.shape)}")
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError("non-finite bf16 logits")
        with torch.no_grad():
            y_torch = model(x, backend="torch", compute_dtype="bf16")
            y32 = model(x)
        bar = BF16_FWD_RTOL * y32.abs().max().item() + 1e-3
        ratios = {}
        for label, ref in (("torch backend bf16", y_torch),
                           ("fp32 kernels", y32)):
            err = (y.float() - ref.float()).abs().max().item()
            ratios[label] = err / bar
            log(f"  bf16 kernels vs {label}: max |err| {err:.4f}, "
                f"{err / y32.abs().max().item():.4%} of the fp32 range "
                f"(bar {BF16_FWD_RTOL:.0%}): {err / bar:.3f} x the bar")
        if not all(r <= 1.0 for r in ratios.values()):
            raise RuntimeError(f"bf16 logits off the fp32 range: {ratios}")
        self.bf16_launches = {"forward": launches}
        self.report["bf16_serve"] = {"launches": launches,
                                     "conv2d_variants": variants,
                                     "err_over_bar": ratios}

    def phase_bf16_train(self, params, fp32_train):
        torch = self.torch
        from repro_torch.launch import train_recipes as ttr

        log("phase 16: ENet-512 training in bf16 (compute_dtype=\"bf16\", "
            f"fp32 masters), batch 4, SegDataPipeline batches 0-"
            f"{TRAIN_STEPS - 1}")
        batches = [self.seg_batch(i) for i in range(TRAIN_STEPS + 1)]
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        counts, taps = {}, []
        self.reset_counts()
        with self.watching(counts, taps):
            loss = ttr.loss_fn("enet", compute_dtype="bf16")(leaves,
                                                            batches[0])
            torch.cuda.synchronize()
            launches = {"forward": self.read_counts()}
            self.reset_counts()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            torch.cuda.synchronize()
        launches["backward"] = self.read_counts()
        variants = self.read_variants()["conv2d"]
        matmuls = sum(a[2] * a[3] for a, _ in taps)
        log(f"  launches per step: {launches}; backward conv2d by variant "
            f"{ {k: v for k, v in variants.items() if v} }; other calls "
            f"{counts}")
        want = dict.fromkeys(variants, 0)
        want.update(BF16_VARIANTS["backward"])
        other = {"conv2d": 0, "conv_transpose2d": 0, "conv2d_plain": 0,
                 "tconv_plain": 0, "matmul": matmuls,
                 "tap_correlation": len(taps)}
        if (launches != LAUNCHES_PER_STEP or variants != want
                or {k: counts.get(k, 0) for k in other} != other):
            raise RuntimeError(f"bf16 step launches {launches}, {variants}, "
                               f"{counts}: not the kernels' bf16 forms only")
        # step-0 gradients against the torch backend's bf16 ones, per tensor
        _, g16_t = ttr.loss_and_grads(
            ttr.loss_fn("enet", backend="torch", compute_dtype="bf16"),
            params, batches[0])
        _, g32_t = ttr.loss_and_grads(ttr.loss_fn("enet", backend="torch"),
                                      params, batches[0])

        def rel(a, b):
            return ((a.float() - b.float()).norm()
                    / b.float().norm().clamp_min(1e-30)).item()

        mine = dict(zip(leaves, grads))
        if any(t.dtype != torch.float32 for t in grads):
            raise RuntimeError("bf16 step-0 gradients are not fp32")
        # a scalar PReLU slope's gradient is one sum over a whole
        # activation that cancels to a small part of its terms, so bf16
        # rounding moves it by more than the bar on either backend (the
        # torch backend's bf16 vs fp32 spread is printed beside it); the
        # slopes are held together, every other tensor on its own
        slopes = [n for n in leaves if n.rsplit(".", 1)[-1] in SLOPES]
        per = {n: rel(mine[n], g16_t[n]) for n in leaves if n not in slopes}
        spread = {n: rel(g16_t[n], g32_t[n]) for n in leaves}
        def cat(gs, names):
            return torch.cat([gs[n].float().reshape(-1) for n in names])

        joint = rel(cat(mine, slopes), cat(g16_t, slopes))
        total = rel(cat(mine, list(leaves)), cat(g16_t, list(leaves)))
        worst = sorted(per.items(), key=lambda kv: -kv[1])[:5]
        wslope = sorted(slopes, key=lambda n: -rel(mine[n], g16_t[n]))[:4]
        log(f"  step-0 gradients vs torch backend bf16, relative L2: "
            f"{len(per)} tensors each <= {BF16_GRAD_RTOL} (worst "
            + ", ".join(f"{n} {r:.2e}" for n, r in worst) + f"); the "
            f"{len(slopes)} PReLU slopes together {joint:.2e} (worst alone "
            + ", ".join(f"{n} {rel(mine[n], g16_t[n]):.2e}, torch bf16 vs "
                        f"fp32 {spread[n]:.2e}" for n in wslope)
            + f"); all {len(leaves)} together {total:.2e}")
        zeroed = min(rel(torch.zeros_like(g16_t[n]), g16_t[n]) for n in per)
        if not (all(r <= BF16_GRAD_RTOL for r in per.values())
                and joint <= BF16_GRAD_RTOL and total <= BF16_GRAD_RTOL
                and zeroed > BF16_GRAD_RTOL):
            raise RuntimeError("bf16 step-0 gradients off the torch "
                               "backend's")
        del grads, g16_t, g32_t, mine, loss, leaves

        state0 = ttr.init_state(params)
        per_step = {k: launches["forward"][k] + launches["backward"][k]
                    for k in launches["forward"]}
        steps = {}
        for backend in ("kernels", "torch"):
            step = ttr.make_train_step("enet", backend=backend,
                                       compute_dtype="bf16")
            state, losses, gnorms = state0, [], []
            for i in range(TRAIN_STEPS):
                self.reset_counts()
                state, m = step(state, batches[i])
                torch.cuda.synchronize()
                counts = self.read_counts()
                want = (per_step if backend == "kernels"
                        else dict.fromkeys(per_step, 0))
                if counts != want:
                    raise RuntimeError(f"bf16 {backend} step launches "
                                       f"{counts} != {want}")
                if m["skipped"].item():
                    raise RuntimeError(f"bf16 {backend} step skipped")
                losses.append(m["loss"].item())
                gnorms.append(m["grad_norm"].item())
            fp32 = fp32_train[backend]
            rels = [abs(a / b - 1) for a, b in zip(losses, fp32["losses"])]
            g_rel = abs(gnorms[0] / fp32["grad_norms"][0] - 1)
            masters = all(t.dtype == torch.float32 for t in self.leaves(
                (state.params, state.opt)) if t.is_floating_point())
            log(f"  {backend}: losses {losses} (fp32 {fp32['losses']}, rel "
                f"{max(rels):.2e}); step-0 grad norm {gnorms[0]:.6f} (fp32 "
                f"{fp32['grad_norms'][0]:.6f}, rel {g_rel:.2e}); masters "
                f"fp32 {masters}")
            if not (all(map(math.isfinite, losses))
                    and all(r <= BF16_FWD_RTOL for r in rels)
                    and g_rel <= BF16_GRAD_RTOL and masters):
                raise RuntimeError(f"bf16 {backend} steps off the fp32 run")
            steps[backend] = {"step": step, "state": state, "losses": losses,
                              "grad_norms": gnorms}

        state = steps["kernels"]["state"]
        bad = batches[TRAIN_STEPS]
        bad["image"][0, 5, 7, 1] = float("nan")
        after, m = steps["kernels"]["step"](state, bad)
        same = all(torch.equal(a, b) for a, b in zip(
            self.leaves((after.params, after.opt)),
            self.leaves((state.params, state.opt))))
        halved = after.scale.scale.item() == state.scale.scale.item() / 2
        log(f"  NaN batch: skipped {m['skipped'].item()}, params and AdamW "
            f"state bit-identical {same}, scale {state.scale.scale.item()} "
            f"-> {after.scale.scale.item()}")
        if not (m["skipped"].item() == 1.0 and same and halved):
            raise RuntimeError("the bf16 NaN batch was not skipped cleanly")
        self.bf16_launches.update(launches)
        self.report["bf16_train"] = {
            "launches_per_step": launches, "backward_variants": variants,
            "losses": {b: r["losses"] for b, r in steps.items()},
            "grad_norms": {b: r["grad_norms"] for b, r in steps.items()},
            "step0_grad_rel_l2": per, "slopes_joint_rel_l2": joint,
            "all_rel_l2": total, "torch_bf16_vs_fp32_rel_l2": spread}
        return steps

    def phase_bf16_times(self, model, x, batch, steps, fwd_calls, bwd_calls):
        torch = self.torch
        log("phase 17: bf16 times (bound: 2 bytes an element at 3.35 TB/s "
            "or 2 x MACs at 989 TFLOP/s; library calls in bf16; fp32 the "
            "fp32 kernel on the same call)")
        times = {}
        with torch.no_grad():
            for label, kw in (("kernels", {}), ("torch", {"backend": "torch"})):
                ms = self.wall_ms(lambda: model(x, compute_dtype="bf16", **kw))
                times[f"forward_{label}_ms"] = ms
                log(f"  ENet bf16 forward {label}: {ms:.3f} ms/batch, "
                    f"{BATCH / ms * 1e3:.1f} images/s")

        def forward():
            with torch.no_grad():
                model(x, compute_dtype="bf16")

        times["forward_profile"] = self.profile_device(
            forward, "bf16 forward", times["forward_kernels_ms"])
        for backend, run in steps.items():
            state = run["state"]

            def one():
                nonlocal state
                state, _ = run["step"](state, batch)

            ms = self.wall_ms(one)
            torch.cuda.reset_peak_memory_stats()
            one()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            times[f"step_{backend}_ms"] = ms
            times[f"peak_gib_{backend}"] = peak
            log(f"  ENet-512 bf16 train step, backend={backend}: {ms:.3f} "
                f"ms, {BATCH / ms * 1e3:.1f} images/s (median of 10); peak "
                f"device memory {peak:.2f} GiB")
            if backend == "kernels":
                times["step_profile"] = self.profile_device(
                    one, "bf16 train step", ms)
        entries = []
        for part, calls in (("forward", fwd_calls), ("backward", bwd_calls)):
            rows, per = self.time_calls(calls, fp32_too=True)
            times[f"{part}_calls"] = rows
            times[f"{part}_geometries"] = self.geometry_table(
                rows, f"a bf16 {part}")
            for name, p in per.items():
                label = (f"{name} (bf16)" if part == "forward"
                         else f"{name} (bf16, ENet backward)")
                n = self.bf16_launches[part][name]
                log(f"  {label}: {p['ms']:.3f} ms over {n} launches; bound "
                    f"{p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f} ms; "
                    f"library {p['library_ms']:.3f} ms; fp32 kernel "
                    f"{p['fp32_ms']:.3f} ms")
                entries.append(self.kernel_entry(name, label, n, p))
        self.report["bf16_times"] = times
        return entries

    # ---------------------------------------------------- the conv models
    def run_models(self):
        """Phases 18-22: ESPNet-512, DCGAN-64, DCGAN-128, the U-Net
        denoiser and the Whisper frontend, each through :meth:`run_path`.
        Returns their entries of the kernels line."""
        torch = self.torch
        entries = []
        self.report["models"] = {}
        for phase, make in ((18, self.espnet_path),
                            (19, lambda: self.dcgan_path(64)),
                            (20, lambda: self.dcgan_path(128)),
                            (21, self.unet_path), (22, self.whisper_path)):
            path = make()
            entries += self.run_path(phase, path)
            del path
            torch.cuda.empty_cache()
        return entries

    def redraw(self, params, g):
        """BN and GroupNorm affines and PReLU slopes drawn as phase 4 draws
        ENet's, around their init: scales x U(0.7, 1.3), shifts 0.1 N(0,
        1), slopes U(0.1, 0.4) (a fixed init would hide the convs behind
        them).  ``params`` is a flat {name: tensor} dict, changed in place
        and returned."""
        torch = self.torch
        with torch.no_grad():
            for name, p in params.items():
                if name.endswith(".g"):
                    p.mul_((0.7 + 0.6 * torch.rand(p.shape, generator=g))
                           .to(p.device))
                elif name.endswith(".b"):
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))
                elif SLOPE_NAME.search(name):
                    p.copy_(0.1 + 0.3 * torch.rand(p.shape, generator=g))
        return params

    def espnet_path(self):
        torch = self.torch
        from repro_torch.launch import train_recipes as ttr
        from repro_torch.models.espnet import ESPNet

        g = torch.Generator().manual_seed(SEED + 10)
        model = ESPNet(CLASSES, generator=g)
        params = self.redraw({n: p.detach() for n, p in
                              model.named_parameters()}, g)
        x = self.rand(g, BATCH, HW, HW, 3)
        batches = [self.seg_batch(i) for i in range(TRAIN_STEPS + 1)]

        def forward(p, backend, cd):
            return ttr.model_forward("espnet", backend=backend,
                                     compute_dtype=cd)(p, x)

        def objective(p, backend, cd):
            return ttr.loss_fn("espnet", backend=backend,
                               compute_dtype=cd)(p, batches[0])

        def spoil(batch):
            batch["image"][0, 5, 7, 1] = float("nan")

        return ModelPath(
            "ESPNet-512", forward, params, (BATCH, HW, HW, CLASSES),
            MODEL_LAUNCHES["ESPNet-512"], objective=objective,
            recipe="espnet", batches=batches, spoil=spoil,
            items=BATCH, unit="images")

    def dcgan_path(self, size):
        torch = self.torch
        from repro_torch.launch import train_recipes as ttr
        from repro_torch.models.dcgan import DCGAN

        label = f"DCGAN-{size}"
        g = torch.Generator().manual_seed(SEED + size)
        model = DCGAN(size, nz=DCGAN_NZ, ngf=DCGAN_NGF, generator=g)
        params = self.redraw({n: p.detach() for n, p in
                              model.named_parameters()}, g)
        z = self.rand(g, DCGAN_BATCH, DCGAN_NZ)

        def forward(p, backend, cd):
            return ttr.model_forward("dcgan", backend=backend,
                                     compute_dtype=cd)(p, z)

        kw = dict(matmuls=1)
        if size == 64:     # the recipe's generator: served and trained
            batches = [{"z": self.rand(g, DCGAN_BATCH, DCGAN_NZ),
                        "target": torch.rand(
                            (DCGAN_BATCH, size, size, 3), generator=g).to(
                                self.dev) * 2 - 1}
                       for _ in range(TRAIN_STEPS + 1)]

            def objective(p, backend, cd):
                return ttr.loss_fn("dcgan", backend=backend,
                                   compute_dtype=cd)(p, batches[0])

            def spoil(batch):
                batch["z"][1, 7] = float("nan")

            kw.update(objective=objective, recipe="dcgan", batches=batches,
                      spoil=spoil)
        return ModelPath(label, forward, params,
                         (DCGAN_BATCH, size, size, 3), MODEL_LAUNCHES[label],
                         items=DCGAN_BATCH, unit="images", **kw)

    def unet_path(self):
        torch = self.torch
        from repro_torch.models import unet_decoder as ud
        from repro_torch.models.common import flatten_tree, unflatten_tree

        g = torch.Generator().manual_seed(SEED + 11)
        tree = ud.init_denoiser_params(g)
        params = self.redraw(flatten_tree(tree), g)
        s = UNET_MID * 2 ** len(ud.UNET_WIDTHS)
        x_t = self.rand(g, UNET_BATCH, s, s, 3)
        noise = self.rand(g, UNET_BATCH, s, s, 3)
        t = torch.randint(0, 1000, (UNET_BATCH,), generator=g).to(self.dev)

        def forward(p, backend, cd):
            return ud.denoise(unflatten_tree(p), x_t, t, backend=backend,
                              compute_dtype=cd)

        def objective(p, backend, cd):
            eps = forward(p, backend, cd)
            return (eps.float() - noise).square().mean()

        return ModelPath(
            "U-Net denoiser", forward, params, (UNET_BATCH, s, s, 3),
            MODEL_LAUNCHES["U-Net denoiser"], objective=objective,
            grad_dtypes=(None,), matmuls=2, items=UNET_BATCH,
            unit="images")

    def whisper_path(self):
        torch = self.torch
        from repro_torch.models import whisper as wh

        g = torch.Generator().manual_seed(SEED + 12)
        params = wh.init_frontend_params(g)
        mel = self.rand(g, WHISPER_BATCH, wh.N_FRAMES, wh.N_MELS)

        def forward(p, backend, cd):
            return wh.frontend(p, mel, backend=backend)

        return ModelPath(
            "Whisper frontend", forward, params,
            (WHISPER_BATCH, (wh.N_FRAMES + 1) // 2, wh.D_MODEL),
            MODEL_LAUNCHES["Whisper frontend"], dtypes=(None,),
            items=WHISPER_BATCH, unit="clips")

    def run_path(self, phase, path):
        """Drive one model as phases 3-9 and 14-17 drive ENet: (a) every
        kernel call of a forward and of a backward, per dtype, against its
        plain version; (b) serving: launch counts, no plain version and no
        library conv, the output against ``backend="torch"``; (c) the
        recipe's steps, or the backward's gradients against the torch
        backend's; (d) times.  Returns its entries of the kernels line."""
        log(f"phase {phase}: {path.label}")
        report = self.report["models"][path.label] = {}
        calls, launches = self.path_kernels(phase, path, report)
        self.path_serve(phase, path, launches, report)
        steps = {}
        if path.recipe:
            steps = self.path_train(phase, path, launches, report)
        elif path.objective:
            self.path_grads(phase, path, report)
        return self.path_times(phase, path, calls, launches, steps, report)

    @staticmethod
    def dtype_label(cd):
        return "fp32" if cd is None else cd

    def path_kernels(self, phase, path, report):
        """Record each kernel call of the main path's runs (counts set to 0
        just before each, read just after) and hold each against its plain
        version: forward calls at TOL x max(1, max|plain|), backward calls
        (of the loss-scaled objective, as phase 6) without the floor; bf16
        per element as phase 14.  Returns the calls and launches by
        (dtype, part)."""
        torch = self.torch
        from repro_torch.optim import DynamicLossScale

        log(f"phase {phase}a: {path.label} kernel calls vs plain")
        calls, launches, caught = {}, {}, []
        scaler = DynamicLossScale()
        scale = scaler.init(self.dev)
        for cd in path.dtypes:
            runs = [("forward", 1.0)]
            if path.objective and cd in path.grad_dtypes:
                runs.append(("backward", 0.0))
            for part, floor in runs:
                key = (self.dtype_label(cd), part)
                rec, counts, taps = [], {}, []
                if part == "forward":
                    self.reset_counts()
                    with torch.no_grad(), self.recording(rec), \
                            self.watching(counts, taps):
                        path.forward(path.params, "kernels", cd)
                    torch.cuda.synchronize()
                    matmuls = path.matmuls
                else:
                    leaves = {k: p.detach().requires_grad_()
                              for k, p in path.params.items()}
                    loss = scaler.scale(scale, path.objective(
                        leaves, "kernels", cd))
                    self.reset_counts()
                    with self.recording(rec), self.watching(counts, taps):
                        torch.autograd.grad(loss, list(leaves.values()))
                    torch.cuda.synchronize()
                    del loss, leaves
                    matmuls = sum(a[2] * a[3] for a, _ in taps)
                launches[key] = self.read_counts()
                self.check_launches(path, key, launches[key], counts,
                                    matmuls, len(taps))
                seen = {}
                for i, (name, args) in enumerate(rec):
                    if cd is not None and args[0].dtype != torch.bfloat16:
                        raise RuntimeError(f"{path.label} {key} call {i} "
                                           f"took {args[0].dtype}")
                    kern, plain, _ = self.kernels[name]
                    got, ref = kern(*args), plain(*args)
                    geo = (name, self.geometry(name, args),
                           self.variant(name, args))
                    seen.setdefault(geo, []).append(self.compare(
                        f"{path.label} {key[0]} {part} call {i}",
                        self.entry_label(name, path, key), got, ref,
                        quiet=True, floor=floor))
                    caught.append(self.sensitivity(got, ref, floor, TOL))
                for (name, geo, variant), errs in seen.items():
                    log(f"  {key[0]} {part} {name} [{variant}] {geo} "
                        f"x{len(errs)}: max abs "
                        f"{max(e[0] for e in errs):.2e} tol "
                        f"{min(e[2] for e in errs):.2e}")
                calls[key] = rec
        zero, off = (min(c[i] for c in caught) for i in range(2))
        log(f"  {len(caught)} calls ok; a zeroed output would reach >= "
            f"{zero:.3g} x its bar and one 2% off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError(f"{path.label}: the check would pass a zeroed "
                               f"or a 2%-off kernel output")
        report["check"] = {"calls": {f"{k[0]} {k[1]}": len(v)
                                     for k, v in calls.items()},
                           "launches": {f"{k[0]} {k[1]}": v
                                        for k, v in launches.items()},
                           "min_zeroed_over_bar": zero,
                           "min_off_2pct_over_bar": off}
        return calls, launches

    def check_launches(self, path, key, got, counts, matmuls, taps):
        """The launches of one run of the main path are the counted ones,
        and no conv left the kernels: no library conv, no plain version,
        no ``torch.matmul`` but the model's own and the weight gradients'
        tap correlations."""
        want = dict.fromkeys(self.counters, 0)
        want.update(path.launches[key[1]])
        other = {"conv2d": 0, "conv_transpose2d": 0, "conv2d_plain": 0,
                 "tconv_plain": 0, "matmul": matmuls,
                 "tap_correlation": taps}
        seen = {k: counts.get(k, 0) for k in other}
        log(f"  {path.label} {key[0]} {key[1]}: launches {got}; other calls "
            f"{seen}")
        if got != want or seen != other:
            raise RuntimeError(f"{path.label} {key}: launches {got} != "
                               f"{want} or other calls {seen} != {other}")

    def entry_label(self, name, path, key):
        return f"{name} ({path.label} {key[0]} {key[1]})"

    def path_serve(self, phase, path, launches, report):
        """Serve one batch per dtype through the kernels (counts 0 just
        before, read just after) and hold it against the torch backend:
        fp32 at relative L2 REL_L2_TOL, bf16 within BF16_FWD_RTOL of the
        fp32 output's range."""
        torch = self.torch
        log(f"phase {phase}b: serve {path.label}, backend=kernels")
        outs, report["serve"] = {}, {}
        for cd in path.dtypes:
            key = (self.dtype_label(cd), "forward")
            counts, taps = {}, []
            self.reset_counts()
            with torch.no_grad(), self.watching(counts, taps):
                y = path.forward(path.params, "kernels", cd)
            torch.cuda.synchronize()
            got = self.read_counts()
            self.check_launches(path, key, got, counts, path.matmuls, 0)
            if got != launches[key]:
                raise RuntimeError(f"{path.label}: served launches {got} != "
                                   f"the recorded run's {launches[key]}")
            want_dtype = torch.float32 if cd is None else torch.bfloat16
            if tuple(y.shape) != path.out_shape or y.dtype != want_dtype:
                raise RuntimeError(f"{path.label} {key[0]}: output "
                                   f"{tuple(y.shape)} {y.dtype}")
            if not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"{path.label} {key[0]}: non-finite")
            with torch.no_grad():
                y_t = path.forward(path.params, "torch", cd)
            outs[key[0]] = y
            if cd is None:
                rel = ((y - y_t).norm() / y_t.norm()).item()
                ok = rel <= REL_L2_TOL
                report["serve"]["fp32_rel_l2"] = rel
                log(f"  fp32 kernels vs torch backend: rel L2 {rel:.3e} "
                    f"(tol {REL_L2_TOL}); max |y| "
                    f"{y.abs().max().item():.4f}")
            else:
                top = outs["fp32"].abs().max().item()
                bar = BF16_FWD_RTOL * top + 1e-3
                err = (y.float() - y_t.float()).abs().max().item()
                vs32 = (y.float() - outs["fp32"]).abs().max().item()
                ok = err <= bar
                report["serve"]["bf16_err_over_bar"] = err / bar
                report["serve"]["bf16_vs_fp32_over_bar"] = vs32 / bar
                log(f"  bf16 kernels vs torch backend bf16: max |err| "
                    f"{err:.4f}, {err / top:.3%} of the fp32 range (bar "
                    f"{BF16_FWD_RTOL:.0%}): {err / bar:.3f} x the bar; vs "
                    f"the fp32 kernels {vs32 / bar:.3f} x (not gated)")
            if not ok:
                raise RuntimeError(f"{path.label} {key[0]}: kernels off the "
                                   f"torch backend")
        report["serve"]["launches"] = {k: launches[(k, "forward")]
                                       for k in outs}

    def path_train(self, phase, path, launches, report):
        """``make_train_step(path.recipe)``, TRAIN_STEPS steps per dtype on
        both backends from one state: launches per step, finite losses
        that agree (fp32 at TRAIN_LOSS_RTOL, bf16 at BF16_FWD_RTOL), and a
        spoiled batch that the kernels' step skips bit for bit."""
        torch = self.torch
        from repro_torch.launch import train_recipes as ttr

        log(f"phase {phase}c: {path.label} \"{path.recipe}\" recipe, "
            f"{TRAIN_STEPS} steps per dtype and backend")
        state0 = ttr.init_state(path.params)
        steps, report["train"] = {}, {}
        for cd in path.dtypes:
            dl = self.dtype_label(cd)
            per_step = {k: launches[(dl, "forward")][k]
                        + launches[(dl, "backward")][k]
                        for k in self.counters}
            runs = {}
            for backend in ("kernels", "torch"):
                step = ttr.make_train_step(path.recipe, backend=backend,
                                           compute_dtype=cd)
                state, losses, gnorms = state0, [], []
                for i in range(TRAIN_STEPS):
                    self.reset_counts()
                    state, m = step(state, path.batches[i])
                    torch.cuda.synchronize()
                    counts = self.read_counts()
                    want = (per_step if backend == "kernels"
                            else dict.fromkeys(per_step, 0))
                    if counts != want:
                        raise RuntimeError(f"{path.label} {dl} {backend} "
                                           f"step launches {counts} != "
                                           f"{want}")
                    if m["skipped"].item():
                        raise RuntimeError(f"{path.label} {dl} {backend} "
                                           f"step skipped")
                    losses.append(m["loss"].item())
                    gnorms.append(m["grad_norm"].item())
                runs[backend] = {"step": step, "state": state,
                                 "losses": losses, "grad_norms": gnorms}
                log(f"  {dl} {backend}: losses {losses}, grad norms "
                    f"{gnorms}")
            lk, lt = runs["kernels"]["losses"], runs["torch"]["losses"]
            rtol = TRAIN_LOSS_RTOL if cd is None else BF16_FWD_RTOL
            rels = [abs(a - b) / abs(b) for a, b in zip(lk, lt)]
            masters = all(t.dtype == torch.float32 for t in self.leaves(
                (runs["kernels"]["state"].params,
                 runs["kernels"]["state"].opt)) if t.is_floating_point())
            log(f"  {dl}: kernels vs torch losses rel {max(rels):.2e} (tol "
                f"{rtol}); masters fp32 {masters}")
            if not (all(map(math.isfinite, lk + lt))
                    and all(r <= rtol for r in rels) and masters):
                raise RuntimeError(f"{path.label} {dl}: losses {lk} vs "
                                   f"torch {lt}")
            state = runs["kernels"]["state"]
            bad = {k: v.clone() for k, v in path.batches[TRAIN_STEPS].items()}
            path.spoil(bad)
            after, m = runs["kernels"]["step"](state, bad)
            same = all(torch.equal(a, b) for a, b in zip(
                self.leaves((after.params, after.opt)),
                self.leaves((state.params, state.opt))))
            halved = after.scale.scale.item() == state.scale.scale.item() / 2
            log(f"  {dl} NaN batch: skipped {m['skipped'].item()}, params "
                f"and AdamW state bit-identical {same}, scale "
                f"{state.scale.scale.item()} -> {after.scale.scale.item()}")
            if not (m["skipped"].item() == 1.0 and same and halved):
                raise RuntimeError(f"{path.label} {dl}: the NaN batch was "
                                   f"not skipped cleanly")
            steps[dl] = runs
            report["train"][dl] = {
                "launches_per_step": per_step,
                "losses": {b: r["losses"] for b, r in runs.items()},
                "grad_norms": {b: r["grad_norms"] for b, r in runs.items()},
                "loss_rel": rels}
        return steps

    def path_grads(self, phase, path, report):
        """The backward's gradients on both backends, per tensor at TOL x
        max(1, max|ref|) and GRAD_RTOL x max|ref| (phase 8's bars)."""
        torch = self.torch
        log(f"phase {phase}c: {path.label} gradients, kernels vs torch "
            f"backend (fp32)")
        grads = {}
        for backend in ("kernels", "torch"):
            leaves = {k: p.detach().requires_grad_()
                      for k, p in path.params.items()}
            loss = path.objective(leaves, backend, None)
            grads[backend] = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        label = f"gradients vs torch ({path.label})"
        ratios = []
        for name, got in grads["kernels"].items():
            want = grads["torch"][name]
            self.compare(f"{path.label} grad {name}", label, got, want,
                         quiet=True)
            self.compare(f"{path.label} grad {name}, relative", label, got,
                         want, quiet=True, floor=0.0, rtol=GRAD_RTOL)
            ratios.append((self.bar(got, want, 0.0, 1.0)[4], name))
        ratios.sort(reverse=True)
        log(f"  {len(ratios)} gradient tensors ok; largest max|err| / "
            f"max|ref|: " + ", ".join(f"{n} {r:.2e}" for r, n in ratios[:4]))
        report["grads"] = {n: r for r, n in ratios}

    def path_times(self, phase, path, calls, launches, steps, report):
        """Forward and step times on both backends (wall clock, median),
        the device's busy share of the fp32 kernels forward and step, and
        every recorded kernel call per geometry beside its bound and
        library call.  Returns the path's entries of the kernels line."""
        torch = self.torch
        log(f"phase {phase}d: {path.label} times")
        times = report["times"] = {}
        for cd in path.dtypes:
            dl = self.dtype_label(cd)
            for backend in ("kernels", "torch"):
                with torch.no_grad():
                    ms = self.wall_ms(lambda: path.forward(
                        path.params, backend, cd), reps=MODEL_REPS)
                times[f"forward_{dl}_{backend}_ms"] = ms
                log(f"  forward {dl} {backend}: {ms:.3f} ms/batch, "
                    f"{path.items / ms * 1e3:.1f} {path.unit}/s")
            for backend, run in steps.get(dl, {}).items():
                state = run["state"]

                def one():
                    nonlocal state
                    state, _ = run["step"](state, path.batches[0])

                ms = self.wall_ms(one, reps=MODEL_REPS)
                times[f"step_{dl}_{backend}_ms"] = ms
                log(f"  train step {dl} {backend}: {ms:.3f} ms, "
                    f"{path.items / ms * 1e3:.1f} {path.unit}/s")
                if backend == "kernels" and cd is None:
                    times["step_profile"] = self.profile_device(
                        one, "train step", ms)

        def forward():
            with torch.no_grad():
                path.forward(path.params, "kernels", None)

        times["forward_profile"] = self.profile_device(
            forward, "forward", times["forward_fp32_kernels_ms"])
        entries = []
        for key, rec in calls.items():
            rows, per = self.time_calls(rec, reps=MODEL_REPS)
            times[f"{key[0]}_{key[1]}_geometries"] = self.geometry_table(
                rows, f"a {key[0]} {key[1]}")
            for name, p in per.items():
                n = launches[key][name]
                if not n:
                    continue
                label = self.entry_label(name, path, key)
                log(f"  {label}: {p['ms']:.3f} ms over {n} launches; bound "
                    f"{p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f} ms; "
                    f"library {p['library_ms']:.3f} ms")
                entries.append(self.kernel_entry(name, label, n, p))
                times[f"{label}_sums"] = p
        return entries

    # ------------------------------------- phase 23: generative serving
    def run_serving(self):
        """Phase 23: ``GenServer`` on the card, the denoiser and DCGAN-64
        lanes at full width (module docstring, 23a-f).  Every gate's
        reading is printed and the phase fails at the first that misses.
        Returns its entries of the kernels line."""
        torch = self.torch
        sg = self.sg
        rep = self.report["serving"] = {}
        den, gan = self.serving_params()
        size = UNET_MID * 2 ** 3

        log(f"phase 23a: GenServer unet_dec lane, backend=kernels: batch "
            f"{SERVE_BATCH}, {SERVE_SCAN} DDIM steps a tick, "
            f"{SERVE_REQUESTS} requests (steps {SERVE_STEPS}, SLOs "
            f"{SERVE_SLOS}; request {SERVE_CANCEL[0]} cancelled in flight, "
            f"{SERVE_TIMEOUT[0]} timed out)")
        rec = []
        want = {k: SERVE_SCAN * v for k, v in SERVE_SUBSTEP.items()}
        srv, imgs = self.serve_drain(
            {"unet_dec": den}, SERVE_SCAN, "kernels",
            check=self.tick_check("unet_dec", want, rec))
        drains = {("fp32", "kernels"): srv}
        statuses = [srv.request(r).status for r in range(SERVE_REQUESTS)]
        done = sorted(imgs)
        log(f"  {srv._tick} ticks, {len(done)} done; statuses of the "
            f"cancelled and timed-out requests: "
            f"{statuses[SERVE_CANCEL[0]]}, {statuses[SERVE_TIMEOUT[0]]}")
        self.gate(statuses[SERVE_CANCEL[0]] == "cancelled"
                  and statuses[SERVE_TIMEOUT[0]] == "timeout"
                  and len(done) == SERVE_REQUESTS - 2,
                  f"drain statuses {statuses}")
        params = srv._lanes["unet_dec"].params
        refs = {r: sg.reference_sample(
            params, steps=srv.request(r).steps, seed=srv.request(r).seed,
            image_size=size) for r in done}
        self.hold_images("served vs the unbatched loop (kernels)", imgs,
                         refs, SERVE_BAR, rep)
        srv_t, imgs_t = self.serve_drain({"unet_dec": den}, SERVE_SCAN,
                                         "torch")
        drains[("fp32", "torch")] = srv_t
        self.hold_images("kernels drain vs torch-backend drain", imgs,
                         imgs_t, SERVE_BAR, rep)
        longest = max(SERVE_STEPS)
        long = next(r for r in done if srv.request(r).steps == longest)
        growth = self.serve_growth(params, srv.request(long).seed, longest,
                                   size)
        rep["growth"] = growth
        log(f"  one {longest}-step trajectory at batch 1, kernels vs torch "
            "backend, max|err| / max(1, max|x|) after step: " + ", ".join(
                f"{i + 1}: {e:.2e}" for i, e in enumerate(growth)
                if i in (0, 4, 9, 19, 29, 39, 48, 49)))

        log(f"phase 23b: the same drain at 1 DDIM step a tick, and with "
            f"autoscale=True (max batch {2 * SERVE_BATCH})")
        srv1, imgs1 = self.serve_drain({"unet_dec": den}, 1, "kernels")
        same = sorted(imgs1) == done and all(
            np.array_equal(imgs1[r], imgs[r]) for r in done)
        st, st1 = srv.stats(), srv1.stats()
        log(f"  K=1: images bitwise equal to K={SERVE_SCAN}'s {same}; "
            f"substeps {st1['substeps']} vs {st['substeps']}; dispatches "
            f"{st1['device_steps']} vs {st['device_steps']}")
        self.gate(same and st1["substeps"] == st["substeps"]
                  and st1["device_steps"] > st["device_steps"],
                  "K=1 drain differs from the K-step drain")
        srv_a, imgs_a = self.serve_drain(
            {"unet_dec": den}, SERVE_SCAN, "kernels", autoscale=True,
            max_batch=2 * SERVE_BATCH)
        batches = srv_a._lanes["unet_dec"].seen_sizes
        bitwise = sorted(imgs_a) == done and all(
            np.array_equal(imgs_a[r], imgs[r]) for r in done)
        log(f"  autoscale: lane batches {sorted(batches)}; images bitwise "
            f"equal to the fixed batch's {bitwise}")
        self.gate(max(batches) == 2 * SERVE_BATCH,
                  f"autoscale never grew the lane ({sorted(batches)})")
        self.hold_images("autoscaled drain vs fixed batch", imgs_a, imgs,
                         SERVE_BAR, rep)

        log("phase 23c: the bf16 lane (compute_dtype=\"bf16\")")
        srv_b, imgs_b = self.serve_drain(
            {"unet_dec": den}, SERVE_SCAN, "kernels", compute_dtype="bf16",
            check=self.tick_check("unet_dec", want, None,
                                  dtype=torch.bfloat16))
        drains[("bf16", "kernels")] = srv_b
        finite = sorted(imgs_b) == done and all(
            np.isfinite(imgs_b[r]).all() for r in done)
        self.gate(finite, "bf16 samples missing or non-finite")
        refs_b = {r: sg.reference_sample(
            params, steps=srv.request(r).steps, seed=srv.request(r).seed,
            image_size=size, compute_dtype="bf16") for r in done}
        worst = float(max(np.abs(imgs_b[r] - refs_b[r]).max()
                          / (BF16_FWD_RTOL * np.abs(imgs[r]).max() + 1e-3)
                          for r in done))
        rep["bf16_vs_loop_over_bar"] = worst
        log(f"  state bf16 every tick, {len(done)} samples finite; served vs "
            f"the unbatched bf16 loop: {worst:.3f} x the bar "
            f"({BF16_FWD_RTOL:.0%} of the fp32 sample's range + 1e-3)")
        self.gate(worst <= 1.0, "bf16 served off the unbatched bf16 loop")
        srv_bt, imgs_bt = self.serve_drain({"unet_dec": den}, SERVE_SCAN,
                                           "torch", compute_dtype="bf16")
        drains[("bf16", "torch")] = srv_bt
        for steps in SERVE_STEPS:
            rs = [r for r in done if srv.request(r).steps == steps]
            err = float(max(np.abs(imgs_b[r] - imgs_bt[r]).max()
                            / np.abs(imgs[r]).max() for r in rs))
            rep[f"bf16_vs_torch_{steps}_steps"] = err
            log(f"  bf16 kernels vs torch backend bf16, {steps} steps: max "
                f"|err| {err:.3%} of the fp32 range (not gated)")

        log(f"phase 23d: GenServer dcgan64 lane (nz {DCGAN_NZ}, ngf "
            f"{DCGAN_NGF}), batch {GAN_BATCH}, {GAN_REQUESTS} requests")
        rec_g = []
        srv_g, imgs_g = self.gan_drain(
            gan, "kernels", GAN_REQUESTS,
            check=self.tick_check("dcgan64", GAN_TICK, rec_g))
        self.gate(srv_g._tick == GAN_REQUESTS // GAN_BATCH
                  and sorted(imgs_g) == list(range(GAN_REQUESTS)),
                  f"dcgan64 drain took {srv_g._tick} ticks")
        model = srv_g._lanes["dcgan64"].model
        with torch.no_grad():
            refs_g = {r: model(sg.init_noise(
                srv_g.request(r).seed, (DCGAN_NZ,))[None].to(self.dev))
                [0].cpu().numpy() for r in imgs_g}
        self.hold_images("served vs batch-1 forwards (kernels)", imgs_g,
                         refs_g, SERVE_BAR, rep)
        srv_gt, imgs_gt = self.gan_drain(gan, "torch", GAN_REQUESTS)
        a = np.stack([imgs_g[r] for r in sorted(imgs_g)])
        b = np.stack([imgs_gt[r] for r in sorted(imgs_g)])
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        rep["dcgan_vs_torch_rel_l2"] = rel
        log(f"  kernels vs torch backend: rel L2 {rel:.3e} (tol "
            f"{REL_L2_TOL})")
        self.gate(rel <= REL_L2_TOL, "dcgan64 kernels off the torch backend")

        self.serve_drills(den, imgs, size, rep)
        rep["drains"] = {f"{d} {b}": s.stats() for (d, b), s in
                         drains.items()}
        return self.serve_times(den, gan, rec, rec_g, rep)

    def gate(self, ok, what):
        """Fail phase 23 at a check that missed."""
        if not ok:
            raise RuntimeError(f"phase 23: {what}")

    def serving_params(self):
        """The denoiser's and DCGAN-64's trees as numpy (the form
        ``GenServer(params=)`` takes), drawn on the CPU with GroupNorm, BN
        and PReLU redrawn as phase 21 draws them."""
        torch = self.torch
        from repro_torch.models import unet_decoder as ud
        from repro_torch.models.common import flatten_tree, unflatten_tree
        from repro_torch.models.dcgan import DCGAN

        g = torch.Generator().manual_seed(SEED + 23)
        den = self.redraw(flatten_tree(ud.init_denoiser_params(
            g, device="cpu")), g)
        m = DCGAN(64, nz=DCGAN_NZ, ngf=DCGAN_NGF, device="cpu", generator=g)
        gan = self.redraw({n: p.detach() for n, p in m.named_parameters()},
                          g)
        return tuple(unflatten_tree({k: v.numpy() for k, v in t.items()})
                     for t in (den, gan))

    def serve_requests(self, scan):
        """The denoiser drain's requests at depth ``scan``: (steps, seed,
        slo, timeout_ticks), and the (tick, rid) to cancel after."""
        reqs = []
        for i in range(SERVE_REQUESTS):
            timeout = (SERVE_TIMEOUT[1] // scan if i == SERVE_TIMEOUT[0]
                       else None)
            reqs.append((SERVE_STEPS[i % len(SERVE_STEPS)], SEED + 100 + i,
                         SERVE_SLOS[i % len(SERVE_SLOS)], timeout))
        return reqs, (SERVE_CANCEL[1] // scan - 1, SERVE_CANCEL[0])

    def serve_drain(self, params, scan, backend, *, check=None,
                    requests=None, cancel=None, drill=False, **kw):
        """Drain requests (default: :meth:`serve_requests` at ``scan``) on
        a fresh denoiser lane; ``check(tick, step)`` runs each tick.  Every
        drain but the fault drills must end with no retry and no degraded
        lane.  Returns (server, rid -> image)."""
        if requests is None:
            requests, cancel = self.serve_requests(scan)
        srv = self.sg.GenServer(batch=SERVE_BATCH, scan_steps=scan,
                                backend=backend, params=params, **kw)
        for steps, seed, slo, timeout in requests:
            srv.submit("unet_dec", steps=steps, seed=seed, slo=slo,
                       timeout_ticks=timeout)
        return srv, self.drive(srv, check, cancel, drill)

    def gan_drain(self, params, backend, n, *, check=None, **kw):
        srv = self.sg.GenServer(batch=GAN_BATCH, backend=backend,
                                params={"dcgan64": params}, **kw)
        for i in range(n):
            srv.submit("dcgan64", seed=SEED + 300 + i,
                       slo=SERVE_SLOS[i % len(SERVE_SLOS)])
        return srv, self.drive(srv, check, None, False)

    def drive(self, srv, check, cancel, drill):
        tick = 0
        while srv._pending or any(l.busy for l in srv._lanes.values()):
            if check is None:
                srv.step()
            else:
                check(tick, srv)
            if cancel is not None and tick == cancel[0]:
                self.gate(srv.request(cancel[1]).status == "active"
                          and srv.cancel(cancel[1]),
                          f"request {cancel[1]} not in flight at tick {tick}")
            tick += 1
        st = srv.stats()
        if not drill:
            self.gate(st["degraded"] == 0 and st["retries"] == 0,
                      f"a clean drain retried or degraded: {st}")
        return srv.run()

    def tick_check(self, workload, want, rec, dtype=None):
        """Per tick: counts 0 just before, read just after; the tick's
        launches are ``want``'s conv kernels, its ``torch.matmul`` calls
        ``want["matmul"]``, nothing else (no library conv, no plain
        version); ``dtype``: the lane's state stays in it.  Tick 1's
        kernel calls are recorded into ``rec``."""
        torch = self.torch
        launches = dict.fromkeys(self.counters, 0)
        launches.update({k: v for k, v in want.items() if k != "matmul"})
        other = {"conv2d": 0, "conv_transpose2d": 0, "conv2d_plain": 0,
                 "tconv_plain": 0, "matmul": want["matmul"],
                 "tap_correlation": 0}

        def check(tick, srv):
            counts, taps = {}, []
            calls = rec if rec is not None and tick == 1 else []
            self.reset_counts()
            with self.watching(counts, taps), self.recording(calls):
                srv.step()
            got = self.read_counts()
            if tick == 1:
                self.serve_launches[workload] = got
            seen = {k: counts.get(k, 0) for k in other}
            if tick == 0:
                log(f"  {workload} tick 0: launches {got}; other calls "
                    f"{seen}")
            self.gate(got == launches and seen == other,
                      f"{workload} tick {tick}: launches {got} != "
                      f"{launches} or other calls {seen} != {other}")
            if dtype is not None:
                x = srv._lanes[workload].x
                self.gate(x.dtype == dtype,
                          f"{workload} state {x.dtype} after tick {tick}")

        return check

    def hold_images(self, what, got, want, bar, rep, gate=None):
        """Every image of ``want`` present in ``got`` within ``bar`` x
        max(1, max|want|); and the bar's reach: what a zeroed sample and
        one 2% off would read.  ``gate`` fails the phase (default 23's)."""
        errs = {r: float(np.abs(got[r] - want[r]).max()
                         / max(1.0, np.abs(want[r]).max())) for r in want
                if r in got}
        worst = max(errs.values()) if errs else math.inf
        scale = [max(1.0, np.abs(w).max()) for w in want.values()]
        zero = float(min(np.abs(w).max() / s
                         for w, s in zip(want.values(), scale)))
        off = 0.02 * zero
        rep[what] = {"worst": worst, "bar": bar, "zeroed": zero,
                     "off_2pct": off}
        log(f"  {what}: {len(errs)} of {len(want)} images, worst max|err| / "
            f"max(1, max|ref|) {worst:.2e} (bar {bar:g}); a zeroed sample "
            f"would read >= {zero:.3g}, one 2% off >= {off:.3g}")
        (gate or self.gate)(len(errs) == len(want) and worst <= bar
                            and zero > bar and off > bar,
                            f"{what}: {worst:.3e}")

    def serve_growth(self, params, seed, steps, size):
        """One ``steps``-step trajectory at batch 1 on both backends in
        lockstep: max|kernels - torch| / max(1, max|torch|) after each
        step."""
        torch = self.torch
        from repro_torch.launch.steps import (ddim_timesteps,
                                              make_gen_scan_step)

        traj = ddim_timesteps(steps)
        fns = {b: make_gen_scan_step(1, backend=b) for b in
               ("kernels", "torch")}
        x0 = self.sg.init_noise(seed, (size, size, 3))[None].to(self.dev)
        xs = dict.fromkeys(fns, x0)
        errs = []
        with torch.no_grad():
            for i, t in enumerate(traj):
                nxt = int(traj[i + 1]) if i + 1 < len(traj) else -1
                batch = {"t": torch.full((1, 1), int(t), device=self.dev),
                         "t_next": torch.full((1, 1), nxt, device=self.dev),
                         "active": torch.ones((1, 1), dtype=torch.bool,
                                              device=self.dev)}
                xs = {b: fn(params, xs[b], batch) for b, fn in fns.items()}
                k, t_ = (xs[b][0].cpu().numpy() for b in fns)
                errs.append(float(np.abs(k - t_).max()
                                  / max(1.0, np.abs(t_).max())))
        return errs

    def serve_drills(self, den, imgs, size, rep):
        """23e: the fault drills on the card, on a drain of DRILL_REQUESTS
        requests: a broken kernels backend degrades the lane to torch; a
        kill at a mid tick restores from per-tick snapshots under
        chiprun_out/ bit for bit; a corrupted slot re-runs bit for bit."""
        import shutil

        from repro_torch.distributed.fault_tolerance import (
            FailureInjector, Fault, InjectedFault, failure_faults)

        log(f"phase 23e: fault drills, {DRILL_REQUESTS} requests (steps "
            f"{DRILL_STEPS})")
        reqs = [(DRILL_STEPS[i % len(DRILL_STEPS)], SEED + 200 + i,
                 SERVE_SLOS[i % len(SERVE_SLOS)], None)
                for i in range(DRILL_REQUESTS)]
        p = {"unet_dec": den}
        clean, imgs_c = self.serve_drain(p, SERVE_SCAN, "kernels",
                                         requests=reqs)
        deg, imgs_d = self.serve_drain(
            p, SERVE_SCAN, "kernels", requests=reqs, drill=True,
            max_retries=1, retry_backoff_s=1e-3,
            faults=failure_faults(backend_broken="kernels"))
        st = deg.stats()
        log(f"  kernels broken: degraded {st['degraded']:.0f}, retries "
            f"{st['retries']:.0f}, lane backend "
            f"{deg._lanes['unet_dec'].backend}")
        self.gate(st["degraded"] == 1 and deg._lanes["unet_dec"].backend
                  == "torch", "the broken kernels backend did not degrade")
        self.hold_images("degraded drain vs clean drain", imgs_d, imgs_c,
                         SERVE_BAR, rep)
        snap = os.path.join(ROOT, "chiprun_out", "serve_gen_snapshots")
        shutil.rmtree(snap, ignore_errors=True)
        kill, killed = clean._tick // 2, False
        try:
            self.serve_drain(p, SERVE_SCAN, "kernels", requests=reqs,
                             snapshot_dir=snap, snapshot_every=1,
                             faults=failure_faults(kill_at=kill))
        except InjectedFault:
            killed = True
        self.gate(killed, f"no kill at tick {kill}")
        restored = self.sg.GenServer.restore(snap)
        at = restored._tick
        imgs_r = self.drive(restored, None, None, False)
        same = sorted(imgs_r) == sorted(imgs_c) and all(
            np.array_equal(imgs_r[r], imgs_c[r]) for r in imgs_c)
        log(f"  killed at tick {kill} of {clean._tick}, restored at tick "
            f"{at}: bitwise equal to the clean drain {same}")
        self.gate(same and at == kill, "kill/restore drain differs")
        shutil.rmtree(snap, ignore_errors=True)
        inj = FailureInjector(faults=[Fault(at=1, kind="corrupt", slot=0)])
        cor, imgs_x = self.serve_drain(p, SERVE_SCAN, "kernels",
                                       requests=reqs, faults=inj)
        requeued = [r for r in imgs_c if cor.request(r).requeues]
        same = sorted(imgs_x) == sorted(imgs_c) and all(
            np.array_equal(imgs_x[r], imgs_c[r]) for r in imgs_c)
        log(f"  corrupted slot 0 at tick 1: requeued {requeued}; bitwise "
            f"equal to the clean drain {same}")
        self.gate(len(requeued) == 1 and same
                  and cor.stats()["degraded"] == 0, "corrupt drill")
        rep["drills"] = {"degraded": st, "kill_tick": kill,
                         "requeued": requeued}

    def serve_times(self, den, gan, rec, rec_g, rep):
        """23f: each lane's throughput and latency on drains of its own
        (:data:`TIMED`), both backends, fp32 and bf16; the device ms and
        busy share of one tick; every recorded kernel call of one tick
        against its plain version and per geometry beside its bound and
        library call."""
        log("phase 23f: times")
        params = {"unet_dec": den, "dcgan64": gan}
        tick_ms = {}
        for workload in ("unet_dec", "dcgan64"):
            for dl in ("fp32", "bf16"):
                for backend in ("kernels", "torch"):
                    for arrivals in ARRIVALS:
                        if arrivals == "backlog" and (dl, backend) != (
                                "fp32", "kernels"):
                            continue
                        srv = self.timed_drain(workload, params[workload],
                                               backend, dl, arrivals)
                        run = self.log_serve(workload, dl, backend,
                                             arrivals, srv, rep)
                        if (dl, backend, arrivals) == ("fp32", "kernels",
                                                       "saturated"):
                            tick_ms[workload] = run["mean_warm_tick_ms"]
        # enough work for the cold tick and the profiler's 2 to 4 ticks
        for workload, n in (("unet_dec", SERVE_BATCH),
                            ("dcgan64", 6 * GAN_BATCH)):
            srv = self.sg.GenServer(
                batch=SERVE_BATCH if workload == "unet_dec" else GAN_BATCH,
                scan_steps=SERVE_SCAN, params=params)
            for i in range(n):
                srv.submit(workload, steps=50, seed=SEED + 400 + i)
            srv.step()                                     # the cold tick
            ms = tick_ms[workload]
            rep[f"{workload}_tick_ms"] = ms
            rep[f"{workload}_tick_profile"] = self.profile_device(
                srv.step, f"{workload} tick (the saturated fp32 kernels "
                "drain's mean warm tick wall)", ms)
        entries = []
        for workload, calls in (("unet_dec", rec), ("dcgan64", rec_g)):
            label = f"GenServer {workload} tick"
            caught = []
            for i, (name, args) in enumerate(calls):
                kern, plain, _ = self.kernels[name]
                got, ref = kern(*args), plain(*args)
                self.compare(f"{label} call {i}", f"{name} ({label})", got,
                             ref, quiet=True)
                caught.append(self.sensitivity(got, ref, 1.0, TOL))
            zero, off = (min(c[j] for c in caught) for j in range(2))
            log(f"  {label}: {len(calls)} calls vs plain ok; a zeroed "
                f"output would reach >= {zero:.3g} x its bar, one 2% off "
                f">= {off:.3g} x")
            self.gate(zero > 1.0 and off > 1.0, f"{label}: weak bar")
            rows, per = self.time_calls(calls, reps=MODEL_REPS)
            rep[f"{workload}_geometries"] = self.geometry_table(
                rows, f"a {workload} tick")
            for name, p in per.items():
                n = self.serve_launches[workload][name]
                if not n:
                    continue
                full = f"{name} ({label})"
                log(f"  {full}: {p['ms']:.3f} ms over {n} launches; bound "
                    f"{p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f} ms; "
                    f"library {p['library_ms']:.3f} ms")
                entries.append(self.kernel_entry(name, full, n, p))
                rep[f"{full}_sums"] = p
        return entries

    def timed_drain(self, workload, params, backend, dl, arrivals):
        """One of 23f's timed drains (:data:`TIMED`, ``arrivals`` one of
        :data:`ARRIVALS`) on a fresh lane, with no per-tick check.  Ends
        with every request done, no retry and no degraded lane.  Returns
        the server."""
        n, pace = TIMED[workload]
        batch = SERVE_BATCH if workload == "unet_dec" else GAN_BATCH
        srv = self.sg.GenServer(
            batch=batch, scan_steps=SERVE_SCAN, backend=backend,
            params={workload: params},
            compute_dtype=None if dl == "fp32" else "bf16")
        sent = 0
        while (sent < n or srv._pending
               or any(l.busy for l in srv._lanes.values())):
            new = {"saturated": 2 * batch - len(srv._pending),
                   "paced": pace, "backlog": n}[arrivals]
            for _ in range(max(0, min(new, n - sent))):
                srv.submit(workload, seed=SEED + 1000 + sent,
                           steps=SERVE_STEPS[sent % len(SERVE_STEPS)],
                           slo=SERVE_SLOS[sent % len(SERVE_SLOS)])
                sent += 1
            srv.step()
        st = srv.stats()
        self.gate(st["requests"] == n and st["degraded"] == 0
                  and st["retries"] == 0,
                  f"{workload} {dl} {backend} {arrivals} drain: {st}")
        return srv

    def log_serve(self, workload, dl, backend, arrivals, srv, rep):
        """Print and record one timed drain: its latency (paced) or rates
        beside its request count, ticks and warm window."""
        st = srv.stats()
        warm = sum(1 for t in srv._tick_log if not t[4])
        n, pace = TIMED[workload]
        how = f"paced {pace} a tick" if arrivals == "paced" else arrivals
        run = dict(st, warm_ticks=warm, arrivals=arrivals,
                   mean_warm_tick_ms=1e3 * st["warm_wall_s"] / warm)
        rep[f"{workload} {dl} {backend} {how}"] = run
        window = (f"{n} requests, {st['ticks']} ticks ({warm} warm, "
                  f"{st['warm_wall_s']:.3f} s)")
        if arrivals == "paced":
            log(f"  {workload} {dl} {backend} {how}: {window}: latency p50 "
                f"{st['latency_p50_s'] * 1e3:.1f} / p99 "
                f"{st['latency_p99_s'] * 1e3:.1f} ms, mean wait "
                f"{st['mean_wait_ticks']:.2f} ticks")
        else:
            log(f"  {workload} {dl} {backend} {how}: {window}: warm "
                f"{st['warm_images_per_s']:.2f} images/s, "
                f"{st['warm_steps_per_s']:.1f} substeps/s, mean warm tick "
                f"{run['mean_warm_tick_ms']:.3f} ms; {st['device_steps']} "
                f"dispatches, {st['substeps']} substeps")
        return run


    # ------------------------------------------- matmul and attention
    def phase_lm_kernels(self):
        torch = self.torch
        kmm, kfa = self.kmm, self.kfa
        log(f"phase 10: matmul and flash attention vs plain on the card "
            f"(fp32: "
            f"{TOL} x max(1, max|plain|); bf16, each element: 2^-7 |plain| + "
            f"{TOL} x max(1, max|plain|))")
        g = torch.Generator().manual_seed(SEED + 3)
        f32, bf16 = torch.float32, torch.bfloat16

        def rand(shape, dtype):
            return torch.randn(shape, generator=g).to(self.dev, dtype)

        mm_cases = [(m, n, k, dt, dt) for m, n, k in
                    ((1, 128, 7), (100, 60, 36), (16, 16, 16),
                     (256, 512, 128), (4097, 33, 65)) for dt in (f32, bf16)]
        mm_cases.append((100, 60, 36, bf16, f32))
        # bf16 edges of the wgmma variant: ragged M and N tiles, M = 1,
        # K = 72 (not a multiple of the 64-deep K step), K = 8
        mm_cases += [(m, n, k, bf16, bf16) for m, n, k in
                     ((4097, 2056, 2048), (1, 128, 2048), (300, 200, 64),
                      (100, 64, 72), (130, 264, 8))]
        for m, n, k, da, db in mm_cases:
            a, b = rand((m, k), da), rand((k, n), db)
            variant = kmm.matmul_variant(a, b)
            self.compare(f"matmul ({m}, {k}) {da} @ ({k}, {n}) {db} "
                         f"[{variant}]", "matmul", kmm.matmul_cuda(a, b),
                         kmm.matmul_plain(a, b))
        fa_cases = [  # q shape, kv length, causal, dtype
            *[(qs, qs[2], c, f32) for qs in ((1, 2, 128, 64), (2, 4, 100, 32),
                                             (1, 1, 257, 64))
              for c in (True, False)],
            ((1, 2, 64, 64), 96, True, f32), ((1, 2, 96, 64), 64, True, f32),
            ((2, 2, 1, 64), 70, True, f32), ((1, 3, 77, 16), 77, True, f32),
            ((1, 2, 130, 128), 200, True, f32),
            ((1, 2, 70, 256), 130, False, f32),
            ((1, 2, 70, 256), 70, True, f32),
            ((1, 2, 64, 64), 64, True, bf16),
            ((1, 4, 300, 64), 300, True, bf16),
            # bf16 edges of the wgmma variant (dh 64 and 128, B*H > 1 so a
            # read across a head boundary would show)
            *[(qs, sk, c, bf16) for qs, sk in
              (((2, 3, 300, 64), 300), ((2, 2, 64, 128), 96),
               ((2, 2, 96, 64), 64), ((2, 2, 1, 64), 70),
               ((1, 3, 1, 128), 300), ((1, 2, 4097, 64), 4097),
               ((2, 2, 300, 128), 300), ((1, 2, 4097, 128), 200),
               ((1, 2, 200, 128), 4097))
              for c in (True, False)],
            ((1, 2, 70, 256), 130, True, bf16)]
        for qs, sk, causal, dt in fa_cases:
            ks = qs[:2] + (sk, qs[3])
            q, k, v = rand(qs, dt), rand(ks, dt), rand(ks, dt)
            variant = kfa.attention_variant(q, k, v)
            self.compare(f"attention q{qs} sk={sk} causal={causal} {dt} "
                         f"[{variant}]", "flash_attention",
                         kfa.flash_attention_cuda(q, k, v, causal),
                         kfa.attention_plain(q, k, v, causal=causal))
        torch.cuda.synchronize()
        worst = {k: float(f"{self.worst[k]:.3e}")
                 for k in ("matmul", "flash_attention")}
        log(f"  all ok; worst max abs err {json.dumps(worst)}")

    def lm_layer_params(self, cfg):
        """Seeded random weights of one layer of ``cfg`` in the port's
        layer layout (projections scaled by fan-in^-1/2, so activations
        stay O(1); RMSNorm gains drawn around 1) and a batch-1 prefill's
        input of LM_SEQ tokens."""
        torch = self.torch
        from repro_torch.kernels.util import canon_dtype

        dtype = canon_dtype(cfg.dtype)
        g = torch.Generator().manual_seed(SEED + 4)

        def rand(fan_in, *shape):
            return (torch.randn(shape, generator=g) * fan_in ** -0.5).to(
                self.dev, dtype)

        def gain():
            return (1 + 0.1 * torch.randn(cfg.d_model, generator=g)).to(
                self.dev, dtype)

        d, ff = cfg.d_model, cfg.d_ff
        qd, kvd = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        layer = {"mixer": {"wq": rand(d, d, qd), "wk": rand(d, d, kvd),
                           "wv": rand(d, d, kvd), "wo": rand(qd, qd, d)},
                 "norm1": gain(), "norm2": gain(),
                 "ffn": {"w_gate": rand(d, d, ff), "w_up": rand(d, d, ff),
                         "w_down": rand(ff, ff, d)}}
        return layer, rand(1, 1, LM_SEQ, d)

    @contextlib.contextmanager
    def recording_lm(self, calls):
        """Record every matmul and flash-attention launch as (name, args,
        output): args as the launcher takes them (flash attention's with
        its ``causal`` flag)."""
        kmm, kfa = self.kmm, self.kfa
        orig = (kmm.matmul_cuda, kfa.flash_attention_cuda)

        def rec(name, fn):
            def wrapper(*args):
                out = fn(*args)
                calls.append((name, args, out))
                return out
            return wrapper

        kmm.matmul_cuda = rec("matmul", orig[0])
        kfa.flash_attention_cuda = rec("flash_attention", orig[1])
        try:
            yield
        finally:
            kmm.matmul_cuda, kfa.flash_attention_cuda = orig

    def phase_lm_main(self):
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import transformer

        base = get_config(LM_ARCH)
        log(f"phase 11: the port's StableLM-2-1.6B layer "
            f"(transformer.apply_layer) at its published widths: d "
            f"{base.d_model}, {base.num_heads} heads x {base.head_dim}, "
            f"d_ff {base.d_ff}, batch 1, {LM_SEQ} tokens, fp32 and bf16")
        calls = []
        self.lm_launches = {"matmul": 0, "flash_attention": 0}
        positions = torch.arange(LM_SEQ, device=self.dev)[None]
        for dtype in (torch.float32, torch.bfloat16):
            cfg = base.replace(dtype=str(dtype).removeprefix("torch."))
            p, x = self.lm_layer_params(cfg)
            recorded = []
            self.reset_counts()
            with torch.no_grad(), self.recording_lm(recorded):
                transformer.apply_layer(p, x, cfg, "attn", "dense",
                                        positions)
            torch.cuda.synchronize()
            counts, variants = self.read_counts(), self.read_variants()
            log(f"  {dtype}: launches {counts}, by variant {variants}")
            if counts != LAUNCHES_PER_LM_LAYER:
                raise RuntimeError(f"launch counts {counts} != "
                                   f"{LAUNCHES_PER_LM_LAYER}")
            want = {name: {v: (LAUNCHES_PER_LM_LAYER[name]
                               if v == LM_VARIANT[str(dtype)] else 0)
                           for v in by_variant}
                    for name, by_variant in variants.items()}
            if variants != want:
                raise RuntimeError(f"{dtype} launches by variant {variants} "
                                   f"!= {want}")
            if [name for name, _, _ in recorded] != [
                    name for _, name in LM_LAYER_CALLS]:
                raise RuntimeError(f"layer calls {recorded} out of order")
            for name in self.lm_launches:
                self.lm_launches[name] += counts[name]
            for (label, _), (name, args, out) in zip(LM_LAYER_CALLS,
                                                     recorded):
                plain = self.lm_call(name, args)[1]
                self.compare(f"{label} {dtype} "
                             f"{[tuple(t.shape) for t in args[:3]]}",
                             name, out, plain())
                calls.append((label, name, dtype, args))
            del p, x, recorded
        return calls

    def phase_lm_times(self, calls):
        torch = self.torch
        log("phase 12: times of the StableLM-width calls (device ms, median "
            "of 3 rounds of 10 launches; plain 3 launches)")
        groups = {}  # (kernel, dtype, geometry) -> the timed calls
        with torch.no_grad():
            for label, name, dtype, args in calls:
                kern, plain, lib, flops, nbytes, geo, variant = self.lm_call(
                    name, args)
                peak = (PEAK_FP32_FLOPS if dtype == torch.float32
                        else PEAK_BF16_FLOPS)
                ops_ms = 1e3 * flops / peak
                bytes_ms = 1e3 * nbytes / PEAK_BYTES_S
                row = {"kernel": name, "call": label, "dtype": str(dtype),
                       "variant": variant, "geometry": geo, "flops": flops,
                       "bytes": nbytes,
                       "ms": self.device_ms(kern),
                       "plain_ms": self.device_ms(plain, reps=3),
                       "library_ms": self.device_ms(lib),
                       "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                       "bound_ms": max(ops_ms, bytes_ms),
                       "bound_by": ("operations" if ops_ms >= bytes_ms
                                    else "bytes")}
                self.report["lm_calls"].append(row)
                groups.setdefault((name, row["dtype"], geo), []).append(row)
                log(f"  {name} [{variant}] {label} {dtype} {geo}: "
                    f"{row['ms']:.3f} ms, "
                    f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
                    f"plain {row['plain_ms']:.3f} ms, library "
                    f"{row['library_ms']:.3f} ms, "
                    f"{flops / row['ms'] / 1e9:.1f} TFLOP/s")
        return self.summarise_lm_calls(groups)

    def lm_call(self, name, args):
        """(kernel, plain version, library yardstick, flops, bytes,
        geometry, variant) of one recorded call of kernel 3 (``"matmul"``;
        ``"matmul_batched"``, its batched form, beside ``torch.bmm``) or
        kernel 4 (``"flash_attention"``).  A geometry of fp32 operands ends
        in " fp32", so that calls of one shape in two dtypes group apart."""
        torch = self.torch
        kmm, kfa = self.kmm, self.kfa
        fp32 = " fp32" if args[0].dtype == torch.float32 else ""
        if name == "matmul_batched":
            a, b = args
            e, m, k = a.shape
            n = b.shape[2]
            return (lambda: kmm.matmul_batched_cuda(a, b),
                    lambda: kmm.matmul_batched_plain(a, b),
                    lambda: torch.bmm(a, b),
                    2 * e * m * n * k,
                    (a.numel() + b.numel() + e * m * n) * a.element_size(),
                    f"({e}, {m}, {k}) @ ({e}, {k}, {n})" + fp32,
                    kmm.matmul_variant(a, b))
        if name == "matmul":
            a, b = args
            m, k = a.shape
            n = b.shape[1]
            return (lambda: kmm.matmul_cuda(a, b),
                    lambda: kmm.matmul_plain(a, b),
                    lambda: torch.matmul(a, b),
                    2 * m * n * k,
                    (a.numel() + b.numel() + m * n) * a.element_size(),
                    f"({m}, {k}) @ ({k}, {n})" + fp32,
                    kmm.matmul_variant(a, b))
        q, k, v, causal, *rest = args
        window = rest[0] if rest else 0
        bsz, h, sq, dh = q.shape
        sk = k.shape[2]
        # (q, k) pairs the top-left causal mask (and a band) leaves, all of
        # them without
        rows = np.arange(sq)
        pairs = (int((np.minimum(rows + 1, sk) - (
            np.maximum(rows - window + 1, 0) if window else 0)).sum())
                 if causal else sq * sk)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window:   # the library's call with the same band, as a mask
            r = torch.arange(sq, device=q.device)[:, None]
            c = torch.arange(sk, device=q.device)[None, :]
            band = (c <= r) & (c > r - window)
            lib = lambda: sdpa(q, k, v, attn_mask=band)  # noqa: E731
        else:
            lib = lambda: sdpa(q, k, v, is_causal=causal)  # noqa: E731
        return (lambda: kfa.flash_attention_cuda(q, k, v, causal, window),
                lambda: kfa.attention_plain(q, k, v, causal=causal,
                                            window=window),
                lib, 4 * bsz * h * dh * pairs,
                2 * (q.numel() + k.numel()) * q.element_size(),
                f"q{tuple(q.shape)} k{tuple(k.shape)} "
                + ((f"window {window}" if window else "causal") if causal
                   else "non-causal"),
                kfa.attention_variant(q, k, v))

    def summarise_lm_calls(self, groups):
        """From the timed calls grouped by (kernel, dtype, geometry): the
        mean per call shape, the sum per layer and dtype, and each kernel's
        entry of the kernels line (both dtypes' layers).  Logged and kept
        in the report."""
        keys = ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms",
                "bytes_ms")
        by_shape, by_layer = [], {}
        per = {name: dict.fromkeys(keys, 0.0) for name in self.lm_launches}
        for (name, dtype, geo), rows in groups.items():
            sums = {k: sum(r[k] for r in rows) for k in keys}
            mean = {k: v / len(rows) for k, v in sums.items()}
            variant = rows[0]["variant"]
            tflops = rows[0]["flops"] / mean["ms"] / 1e9
            by_shape.append({"kernel": name, "dtype": dtype, "geometry": geo,
                             "variant": variant, "calls": len(rows),
                             "tflops": tflops, **mean})
            log(f"  mean of {len(rows)} x {name} [{variant}] {dtype} {geo}: "
                + ", ".join(f"{k} {mean[k]:.3f}" for k in keys[:4])
                + f", {tflops:.1f} TFLOP/s")
            layer = by_layer.setdefault(
                (dtype, name), {"launches": 0, **dict.fromkeys(keys, 0.0)})
            layer["launches"] += len(rows)
            for k in keys:
                layer[k] += sums[k]
                per[name][k] += sums[k]
        for (dtype, name), layer in by_layer.items():
            log(f"  layer {dtype} {name} x{layer['launches']}: "
                + ", ".join(f"{k} {layer[k]:.3f}" for k in keys[:4]))
        self.report["lm_summary"] = {
            "by_shape": by_shape,
            "by_layer": [{"kernel": n, "dtype": d, **v}
                         for (d, n), v in by_layer.items()]}
        entries = []
        for name, p in per.items():
            log(f"  {name}: {p['ms']:.3f} ms over "
                f"{self.lm_launches[name]} launches (fp32 + bf16 layer); "
                f"bound {p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f} "
                f"ms; library {p['library_ms']:.3f} ms")
            entries.append({
                "name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                "launches": self.lm_launches[name],
                "max_abs_err": self.worst[name], "ms": p["ms"],
                "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                "bound_by": ("operations" if p["ops_ms"] >= p["bytes_ms"]
                             else "bytes"),
                "library_ms": p["library_ms"]})
        return entries

    # -------------------------------------------------------------- phase 24
    def run_tuning(self):
        """Phase 24: the plan table, the calibration and the cycle model on
        the card (module docstring, 24a-d).  Returns its entries of the
        kernels line."""
        rep = self.report["tuning"] = {}
        forwards = self.tune_forwards()
        geos = self.tune_geometries(forwards)
        self.phase_policy(geos, rep)
        entries = self.phase_autotune(forwards, geos, rep)
        del forwards
        self.torch.cuda.empty_cache()
        self.phase_calibration(geos, rep)
        self.phase_fig10(rep)
        self.phase_on_miss(rep)
        return entries

    def gate24(self, ok, what):
        """Fail phase 24 at a check that missed."""
        if not ok:
            raise RuntimeError(f"phase 24: {what}")

    def tune_forwards(self):
        """24b's forwards, ``label -> fn(compute_dtype)``: ENet-512 (batch
        4), DCGAN-128 (batch 128, nz 100, ngf 64) and the GenServer
        denoiser's substep (widths 256/128/64, batch 8), seeded as phases
        4, 20 and 21 draw them."""
        torch = self.torch
        model, x = self.make_model()
        dcgan, unet = self.dcgan_path(128), self.unet_path()

        def run(fn):
            def call(cd):
                with torch.no_grad():
                    return fn(cd)
            return call

        return {
            "ENet-512": run(lambda cd: model(x, compute_dtype=cd)),
            "DCGAN-128": run(lambda cd: dcgan.forward(dcgan.params,
                                                      "kernels", cd)),
            "U-Net denoiser": run(lambda cd: unet.forward(unet.params,
                                                          "kernels", cd)),
        }

    def launch_geometry(self, name, args):
        """(kind, x shape, w shape, stride, padding, output padding,
        epilogue spec, dtype) of a recorded kernel call, as the plan table
        keys it."""
        x, w, s, spec = args[0], args[1], args[2], args[-2]
        if name == "conv2d":
            return ("dense", tuple(x.shape), tuple(w.shape), s, args[3],
                    None, spec, x.dtype)
        return ("tconv", tuple(x.shape), tuple(w.shape), s, args[3],
                args[4] - args[3], spec, x.dtype)

    def tune_geometries(self, forwards):
        """Every distinct kernel-1 and kernel-2 launch of 24b's forwards,
        fp32 and bf16, recorded from the forwards themselves (untuned):
        ``geometry -> (name, args, labels)``."""
        torch = self.torch
        geos = {}
        for label, fn in forwards.items():
            for cd in (None, "bf16"):
                rec = []
                with self.recording(rec):
                    fn(cd)
                torch.cuda.synchronize()
                for name, args in rec:
                    g = self.launch_geometry(name, args)
                    entry = geos.setdefault(g, (name, args, set()))
                    entry[2].add(label)
        log(f"phase 24: {len(geos)} distinct launch geometries "
            f"({sum(g[0] == 'dense' for g in geos)} kernel 1, "
            f"{sum(g[0] == 'tconv' for g in geos)} kernel 2) over "
            f"{', '.join(forwards)}, fp32 and bf16")
        return geos

    def phase_policy(self, geos, rep):
        """24a: for every plan of the full grid (7 tiles x resident or
        streamed) of every geometry, the policy's footprint against the
        shared memory the kernel asks for (``conv2d_smem_bytes``,
        ``tconv_smem_bytes``), byte for byte; every plan the policy admits
        (a finite score) launches and matches the plain version; every plan
        it scores inf is one the kernel refuses or the card cannot hold."""
        torch = self.torch
        at, tp = self.at, self.tp
        card = tp.card_of(self.dev)
        log(f"phase 24a: policy vs kernel; card: {card.sms} SMs, "
            f"{card.smem_optin} B a block, {card.smem_per_sm} B an SM")
        checked = admitted = launched = refused = 0
        worst = 0.0
        for (kind, xs, ws, s, pad, op, spec, dt), (name, args, _) in \
                geos.items():
            kern, plain, _ = self.kernels[name]
            ref = plain(*args)
            g = tp.geometry(kind, xs, ws, stride=s, padding=pad,
                            output_padding=op, epilogue=spec)
            for tile in range(len(self.kconv.TILES)):
                for res in (True, False):
                    plan = self.kconv.ConvPlan(self.kconv.copy_vec(
                        xs[-1], dt, args[0].data_ptr()), tile, res, dt)
                    fp = tp.footprint_bytes(kind, xs, ws, plan, stride=s,
                                            padding=pad, output_padding=op,
                                            epilogue=spec)
                    if kind == "dense":
                        kb = self.kconv.kernel_smem_bytes(
                            g.k_rows, plan, g.residual)
                    else:
                        kb = self.ktr.kernel_smem_bytes(
                            g.oh, g.ow, g.kh, s, g.pads[0], plan)
                    checked += 1
                    self.gate24((fp is None and kb == -1) or fp == kb,
                                f"{kind} {xs} {ws} tile {tile} resident "
                                f"{res}: policy {fp} B, kernel {kb} B")
                    score = tp.rank(kind, xs, ws, [plan], stride=s,
                                    padding=pad, output_padding=op,
                                    dtype=dt, epilogue=spec, card=card)[0][0]
                    if not math.isfinite(score):
                        refused += 1
                        self.gate24(kb == -1 or kb > card.smem_optin,
                                    f"{kind} {xs} {ws} tile {tile}: scored "
                                    f"inf but the kernel takes {kb} B")
                        continue
                    admitted += 1
                    got = kern(*args, plan=plan)
                    torch.cuda.synchronize()
                    launched += 1
                    err = self.compare(
                        f"24a {kind} {xs} {ws} tile {tile} res {res}",
                        f"{name} (24a plans)", got, ref, quiet=True)[0]
                    worst = max(worst, err)
            del ref
        log(f"  {checked} plans of {len(geos)} geometries: footprint == "
            f"kernel's shared memory for all; {admitted} admitted, all "
            f"launched and matched plain (max abs err {worst:.2e}); "
            f"{refused} scored inf, each refused by the kernel or over "
            f"{card.smem_optin} B")
        rep["policy"] = {"plans": checked, "admitted": admitted,
                         "launched": launched, "refused": refused,
                         "max_abs_err": worst}

    @contextlib.contextmanager
    def plan_table(self, sub=None, tune=False):
        """Launch on 24b's tuned plan table, or on the table in its
        subdirectory ``sub`` (``"empty"`` is never written: every launch on
        its shape's default plan), with tuning on a miss switched on by
        ``tune``; the table is re-read from disk either way."""
        at = self.at
        keep = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
        if sub is not None:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(keep, sub)
        if tune:
            os.environ["REPRO_TORCH_AUTOTUNE"] = "1"
        at.clear_memory_cache()
        try:
            yield
        finally:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = keep
            os.environ.pop("REPRO_TORCH_AUTOTUNE", None)
            at.clear_memory_cache()

    def phase_autotune(self, forwards, geos, rep):
        """24b: tune every geometry (the policy's top ``POLICY_TOP`` plus
        the default plan, device time), then run each forward on the tuned
        table: outputs against the untuned forward's, launches and their
        variants, per-geometry and per-forward times, and every tuned call
        against its plain version and per geometry."""
        torch = self.torch
        at = self.at
        log(f"phase 24b: autotune {len(geos)} geometries (top "
            f"{at.POLICY_TOP} plans + the default, device time, best of 3)")
        t0 = time.perf_counter()
        rows, moved = [], 0
        self.tuned = {}     # geometry -> (winner, the plans timed)
        for geo, (name, args, labels) in geos.items():
            kind, xs, ws, s, pad, op, spec, dt = geo
            times = {}
            best = at.tune(kind, xs, ws, stride=s, dtype=dt, padding=pad,
                           output_padding=op, epilogue=spec, device=self.dev,
                           timings=times)
            self.tuned[geo] = (best, set(times))
            default = at.default_plan(kind, xs, ws, stride=s, dtype=dt)
            flops, nbytes = self.work(name, args)
            peak = (PEAK_FP32_FLOPS if dt == torch.float32
                    else PEAK_BF16_FLOPS)
            bound = max(1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES_S)
            row = {"geometry": self.geometry(name, args),
                   "forwards": sorted(labels), "dtype": str(dt),
                   "default": f"{default.variant}/n{default.bn}",
                   "default_ms": 1e3 * times[default],
                   "tuned": f"{best.variant}/n{best.bn}",
                   "tuned_ms": 1e3 * times[best], "bound_ms": bound,
                   "timed": len(times)}
            moved += best != default
            rows.append(row)
        log(f"  tuned in {time.perf_counter() - t0:.1f} s; {moved} of "
            f"{len(rows)} geometries moved off the default plan")
        log(f"    {'dtype':8s} {'default ms':>10s} {'tuned ms':>9s} "
            f"{'bound':>7s} {'x bound':>7s}  default -> tuned  geometry "
            f"[forwards]")
        for r in sorted(rows, key=lambda r: r["tuned_ms"] - r["default_ms"]):
            log(f"    {r['dtype'][6:]:8s} {r['default_ms']:10.4f} "
                f"{r['tuned_ms']:9.4f} {r['bound_ms']:7.4f} "
                f"{r['tuned_ms'] / r['bound_ms']:7.1f}  {r['default']} -> "
                f"{r['tuned']}  {r['geometry']} {r['forwards']}")
        rep["geometries"] = rows
        with self.plan_table():
            self.plan_lookup_cost(geos, rep)

        entries, caught = [], []
        rep["forwards"] = {}
        for label, fn in forwards.items():
            for cd in (None, "bf16"):
                dl = self.dtype_label(cd)
                with self.plan_table("empty"):
                    self.reset_counts()
                    want = fn(cd)
                    torch.cuda.synchronize()
                    n_untuned = self.read_counts()
                    untuned_ms = self.wall_ms(lambda: fn(cd))
                rec = []
                with self.plan_table():
                    self.reset_counts()
                    with self.recording(rec):
                        got = fn(cd)
                    torch.cuda.synchronize()
                    n_tuned = self.read_counts()
                    variants = self.read_variants()["conv2d"]
                    tuned_ms = self.wall_ms(lambda: fn(cd))
                    on_table = self.plans_follow_table(rec)
                    self.gate24(n_tuned == n_untuned,
                                f"{label} {dl}: {n_tuned} launches tuned, "
                                f"{n_untuned} untuned")
                    planned = {}
                    for name, args in rec:
                        if name == "conv2d":
                            v = self.kconv.launch_plan(
                                args[0], args[1], args[2], args[3],
                                args[-2]).variant
                            planned[v] = planned.get(v, 0) + 1
                    self.gate24(all(variants[v] == planned.get(v, 0)
                                    for v in variants),
                                f"{label} {dl}: variants {variants} vs the "
                                f"table's {planned}")
                    full = f"tuned {label} {dl} forward"
                    for i, (name, args) in enumerate(rec):
                        kern, plain, _ = self.kernels[name]
                        out, ref = kern(*args), plain(*args)
                        self.compare(f"{full} call {i}", f"{name} ({full})",
                                     out, ref, quiet=True)
                        caught.append(self.sensitivity(out, ref, 1.0, TOL))
                    rows_t, per = self.time_calls(rec, reps=MODEL_REPS)
                if cd is None:
                    err, _, top, tol, over = self.bar(got, want)
                    zero, off = self.sensitivity(got, want, 1.0, TOL)
                    bar_txt = "1e-4 x max(1, max|untuned|)"
                else:
                    top = want.float().abs().max().item()
                    err = (got.float() - want.float()).abs().max().item()
                    tol = BF16_FWD_RTOL * top
                    over = err / tol
                    zero = top / tol
                    off = (0.02 * want.float()).abs().max().item() / tol
                    bar_txt = f"{BF16_FWD_RTOL:.0%} of max|untuned|"
                log(f"  {label} {dl}: tuned vs untuned max abs {err:.3e} "
                    f"= {over:.3f} x the bar ({bar_txt} = {tol:.3e}); a "
                    f"zeroed output would read {zero:.3g} x, one 2% off "
                    f"{off:.3g} x; launches {n_tuned} as untuned, all on "
                    f"the table's plans {on_table}; wall ms untuned "
                    f"{untuned_ms:.3f}, tuned {tuned_ms:.3f}")
                self.gate24(over <= 1.0 and on_table,
                            f"{label} {dl}: tuned output off the untuned")
                rep["forwards"][f"{label} {dl}"] = {
                    "max_abs_err": err, "tol": tol, "over_bar": over,
                    "untuned_ms": untuned_ms, "tuned_ms": tuned_ms,
                    "launches": n_tuned,
                    "geometries": self.geometry_table(rows_t, full)}
                for name, p in per.items():
                    if not n_tuned[name]:
                        continue
                    entry = f"{name} ({full})"
                    log(f"  {entry}: {p['ms']:.3f} ms over "
                        f"{n_tuned[name]} launches; bound "
                        f"{p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f}"
                        f" ms; library {p['library_ms']:.3f} ms")
                    entries.append(self.kernel_entry(name, entry,
                                                     n_tuned[name], p))
                del want, got, rec, rows_t
        zero, off = (min(c[i] for c in caught) for i in range(2))
        log(f"  {len(caught)} tuned calls vs plain ok; a zeroed output "
            f"would reach >= {zero:.3g} x its bar, one 2% off >= {off:.3g} x")
        self.gate24(zero > 1.0 and off > 1.0, "tuned calls: weak bar")
        return entries

    def plan_lookup_cost(self, geos, rep):
        """24b: the host's cost of a launch's plan, us a call, over every
        geometry's recorded operands on the tuned table: the shape's plan
        alone with the address's copy width (``conv_plan`` /
        ``tconv_plan``: a launch's plan before the table), a repeated
        launch's lookup (``launch_plan``), and a geometry's first lookup in
        a process (the in-process caches emptied before each call, the
        table read from disk kept)."""
        at, kconv, ktr = self.at, self.kconv, self.ktr
        calls = []
        for name, args, _ in geos.values():
            x, w, s, spec = args[0], args[1], args[2], args[-2]
            if name == "conv2d":
                def shape_only(x=x, w=w, s=s):
                    return kconv.conv_plan(
                        x.shape[-1], w.shape[-1], w.shape[0], w.shape[1], s,
                        x.dtype)._replace(vec=kconv.copy_vec(
                            x.shape[-1], x.dtype, x.data_ptr()))

                def lookup(x=x, w=w, s=s, pads=args[3], spec=spec):
                    return kconv.launch_plan(x, w, s, pads, spec)
            else:
                def shape_only(x=x, w=w):
                    return ktr.tconv_plan(
                        x.shape[-1], w.shape[-1], w.shape[0],
                        x.dtype)._replace(vec=kconv.copy_vec(
                            x.shape[-1], x.dtype, x.data_ptr()))

                def lookup(x=x, w=w, s=s, lo=args[3], hi=args[4],
                           spec=spec):
                    return ktr.launch_plan(x, w, s, lo, hi, spec)
            calls.append((shape_only, lookup))

        def us_a_call(i, first=False):
            n = 0
            t0 = time.perf_counter()
            while n < LOOKUP_CALLS:
                for pair in calls:
                    if first:
                        at._MEM.clear()
                        at._FAST.clear()
                    pair[i]()
                    n += 1
            return (time.perf_counter() - t0) / n * 1e6

        for pair in calls:
            pair[1]()
        us = {"shape_only": us_a_call(0), "lookup": us_a_call(1),
              "first_lookup": us_a_call(1, first=True)}
        log(f"  a launch's plan, host us a call over {len(calls)} "
            f"geometries: the shape's plan alone (before the table) "
            f"{us['shape_only']:.2f}; a repeated launch's lookup "
            f"{us['lookup']:.2f}; a geometry's first lookup in a process "
            f"{us['first_lookup']:.2f}")
        rep["lookup_us"] = us

    def calibrated_tune(self, geos, calib, rep):
        """24c: every 24b geometry tuned again with the fit
        (``tune(calibration=calib)``) into a table of its own: each
        geometry's per-wave weight (``tiling_policy._cell_weight``: the
        fitted dispatch overhead over the modeled compute; 1e-3 without a
        fit), and the timed sets and winners against 24b's."""
        at, tp = self.at, self.tp
        from repro_torch.core import calibrate as cal

        t0 = time.perf_counter()
        weights, changed, moved = [], 0, 0
        with self.plan_table("calibrated"):
            for geo in geos:
                kind, xs, ws, s, pad, op, spec, dt = geo
                times = {}
                best = at.tune(kind, xs, ws, stride=s, dtype=dt,
                               padding=pad, output_padding=op, epilogue=spec,
                               calibration=calib, device=self.dev,
                               timings=times)
                default = at.default_plan(kind, xs, ws, stride=s, dtype=dt)
                self.gate24(default in times and best in times,
                            f"calibrated tune of {kind} {xs} {ws}: the "
                            f"default or the winner was not timed")
                base = cal.modeled_cycles(cal.CaptureCase(kind, xs, ws,
                                                          stride=s))
                weights.append(tp._cell_weight(kind, "kernels", base, calib,
                                               dt))
                was, timed = self.tuned[geo]
                changed += set(times) != timed
                moved += best != was
        log(f"  tuned again with the fit: {len(geos)} geometries in "
            f"{time.perf_counter() - t0:.1f} s; per-wave weight "
            f"{min(weights):.3g} to {max(weights):.3g} (median "
            f"{statistics.median(weights):.3g}; 1e-3 without a fit); timed "
            f"sets differ from 24b's for {changed}, winners for {moved}")
        self.gate24(all(math.isfinite(w) and w >= 0 and w != 1e-3
                        for w in weights),
                    f"a per-wave weight not from the fit: {weights}")
        rep["calibrated_tune"] = {
            "weights": weights, "timed_sets_changed": changed,
            "winners_changed": moved}

    def phase_on_miss(self, rep):
        """24e: tuning switched on over an empty table, so each miss tunes
        inside the launch that meets it, then the table read back with
        tuning off (module docstring, 24e)."""
        torch, at = self.torch, self.at
        log("phase 24e: $REPRO_TORCH_AUTOTUNE=1 over an empty table (each "
            "miss tuned inside its launch): the denoiser's training "
            "objective forward and backward (fp32, batch 8), and an "
            f"autoscaled denoiser drain (batch up to {2 * SERVE_BATCH})")
        t0 = time.perf_counter()
        out = rep["on_miss"] = {}
        path = self.unet_path()

        def objective():
            leaves = {k: p.detach().requires_grad_()
                      for k, p in path.params.items()}
            loss = path.objective(leaves, "kernels", None)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return {"loss": loss.detach().reshape(1),
                    **dict(zip(leaves, grads))}

        with self.plan_table("empty"):
            want = objective()
        with self.plan_table("on_miss", tune=True):
            t1 = time.perf_counter()
            tuning = objective()
            torch.cuda.synchronize()
            t_tune = time.perf_counter() - t1
        rec = []
        with self.plan_table("on_miss"):
            with self.recording(rec):
                got = objective()
            torch.cuda.synchronize()
            on_table = self.plans_follow_table(rec)
            table = dict(at._load_disk(at.cache_path(self.dev)))
        keys = {}       # the objective's launch keys -> their default plan
        for g in {self.launch_geometry(n, a) for n, a in rec}:
            kind, xs, ws, st, pad, op, spec, dt = g
            keys[at.make_key(kind, xs, ws, stride=st, padding=pad,
                             output_padding=op, epilogue=spec, dtype=dt)] = \
                at.default_plan(kind, xs, ws, stride=st, dtype=dt)
        moved = sum(table.get(k) != (p.tile, p.resident)
                    for k, p in keys.items())
        worst, caught = 0.0, []
        for k, ref in want.items():
            # an all-zero gradient has no relative bar: the absolute one
            bars = (((1.0, TOL), (0.0, GRAD_RTOL)) if bool(ref.any())
                    else ((1.0, TOL),))
            for floor, rtol in bars:
                err, _, tol = self.compare(f"24e {k}", "24e tuned objective",
                                           got[k], ref, quiet=True,
                                           floor=floor, rtol=rtol)
                worst = max(worst, err / tol)
            if len(bars) == 2:
                caught.append(self.sensitivity(got[k], ref, 0.0, GRAD_RTOL))
        zero, off = (min(c[i] for c in caught) for i in range(2))
        same = all(torch.equal(tuning[k], got[k]) for k in got)
        log(f"  objective: {len(rec)} launches, {len(keys)} distinct keys, "
            f"tuned on their misses in {t_tune:.1f} s (table {len(table)} "
            f"entries, {moved} off the default plan); read "
            f"back with tuning off, every launch on its entry's plan "
            f"{on_table}; the loss and {len(got) - 1} gradients vs untuned: "
            f"worst {worst:.3f} x the bars (1e-4 x max(1, max|untuned|) and "
            f"{GRAD_RTOL:g} x max|untuned|), a zeroed tensor would read "
            f">= {zero:.3g} x the second, one 2% off >= "
            f"{off:.3g} x; bitwise equal to the tuning run's {same}")
        self.gate24(on_table and keys.keys() <= set(table) and zero > 1.0
                    and off > 1.0, "tuned objective off its table")
        out["objective"] = {
            "launches": len(rec), "keys": len(keys), "table": len(table),
            "off_default": moved, "tune_s": t_tune,
            "over_bar": worst, "bitwise_as_tuning_run": same}
        del want, tuning, got, rec, path

        den, _ = self.serving_params()
        kw = dict(autoscale=True, max_batch=2 * SERVE_BATCH)
        with self.plan_table("empty"):
            _, imgs_u = self.serve_drain({"unet_dec": den}, SERVE_SCAN,
                                         "kernels", **kw)
        with self.plan_table("on_miss", tune=True):
            before = len(at._load_disk(at.cache_path(self.dev)))
            t1 = time.perf_counter()
            srv, imgs_t = self.serve_drain({"unet_dec": den}, SERVE_SCAN,
                                           "kernels", **kw)
            t_drain = time.perf_counter() - t1
            after = len(at._load_disk(at.cache_path(self.dev)))
        sizes = sorted(srv._lanes["unet_dec"].seen_sizes)
        bitwise = sorted(imgs_t) == sorted(imgs_u) and all(
            np.array_equal(imgs_t[r], imgs_u[r]) for r in imgs_u)
        log(f"  autoscaled drain: lane batches {sizes}; {after - before} "
            f"keys tuned inside its ticks, drain {t_drain:.1f} s; samples "
            f"bitwise equal to the untuned drain's {bitwise} (not gated)")
        self.hold_images("24e tuned autoscaled drain vs untuned", imgs_t,
                         imgs_u, SERVE_BAR, out, gate=self.gate24)
        self.gate24(max(sizes) == 2 * SERVE_BATCH and after > before,
                    f"the drain never grew ({sizes}) or tuned nothing")
        out["drain"] = {"batches": sizes, "keys_tuned": after - before,
                        "drain_s": t_drain, "bitwise": bitwise}
        log(f"  24e: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    def plans_follow_table(self, rec):
        """Whether every recorded call's plan has the tile and resident
        flag its plan-table entry names."""
        at = self.at
        table = at._load_disk(at.cache_path(self.dev))
        for name, args in rec:
            kind, xs, ws, s, pad, op, spec, dt = self.launch_geometry(
                name, args)
            key = at.make_key(kind, xs, ws, stride=s, dtype=dt, padding=pad,
                              output_padding=op, epilogue=spec)
            if name == "conv2d":
                plan = self.kconv.launch_plan(args[0], args[1], s, pad, spec)
            else:
                plan = self.ktr.launch_plan(args[0], args[1], s, args[3],
                                            args[4], spec)
            if key not in table or table[key] != (plan.tile, plan.resident):
                return False
        return True

    def phase_calibration(self, geos, rep):
        """24c: capture the reference's full sweep (``default_cases(smoke=
        False)``) on both backends in fp32 and bf16, fit, print each key's
        MAPE, save the fit under ``chiprun_out/``, then serve a denoiser
        lane with it and ``scan_steps="auto"``, and tune ``geos`` again
        with it."""
        torch = self.torch
        sg = self.sg
        from repro_torch.core import calibrate as cal
        from repro_torch.core import gen_spec

        log("phase 24c: calibration capture (default_cases(smoke=False), "
            "kernels and torch, fp32 and bf16)")
        t0 = time.perf_counter()
        samples = cal.capture_samples(
            smoke=False, backends=("kernels", "torch"),
            dtypes=("float32", "bfloat16"), device=self.dev)
        calib = cal.Calibration.fit(samples)
        errors = calib.error_report(samples)
        path = cal.default_cache_path()
        calib.save(path)
        log(f"  {len(samples)} samples in {time.perf_counter() - t0:.1f} s; "
            f"fit saved to {os.path.relpath(path, ROOT)}")
        for key, e in errors.items():
            log(f"    {key}: a {e['a_us_per_cycle']:.4e} us/cycle, b "
                f"{e['b_us']:.2f} us, n {e['n']}, MAPE {e['mape_pct']:.2f}% "
                f"(max {e['max_abs_err_pct']:.2f}%)")
        self.gate24(len(errors) == 12 and all(
            e["a_us_per_cycle"] > 0 for e in errors.values()),
            "a calibration key without a positive slope")
        rep["calibration"] = {"errors": errors, "fit": calib.to_payload()}

        den, _ = self.serving_params()
        layers = gen_spec.unet_decoder_layers(hw=UNET_MID)
        srv = sg.GenServer(batch=SERVE_BATCH, backend="kernels",
                           params={"unet_dec": den}, calibration=calib,
                           scan_steps="auto")
        k = srv._lane_scan_steps("unet_dec")
        split = calib.predict_layers_split(layers, backend="kernels")
        self.gate24(split is not None, "no calibrated estimate of a pass")
        steps_list = [SERVE_STEPS[i % len(SERVE_STEPS)]
                      for i in range(CALIB_REQUESTS)]
        rids = [srv.submit("unet_dec", steps=st, seed=SEED + 400 + i,
                           slo=SERVE_SLOS[i % len(SERVE_SLOS)])
                for i, st in enumerate(steps_list)]
        est = [srv.request(r).est_us for r in rids]
        log(f"  GenServer unet_dec lane, batch {SERVE_BATCH}, calibrated: "
            f"one pass {split[0]:.1f} us compute + {split[1]:.1f} us "
            f"dispatch; scan_steps=\"auto\" picks K = {k} (of 1.."
            f"{sg.MAX_SCAN_STEPS}); est_us of request 0 ({steps_list[0]} "
            f"steps): {est[0]:.1f}")
        self.gate24(1 <= k <= sg.MAX_SCAN_STEPS and all(
            e is not None and e > 0 for e in est), f"auto K {k}, est {est}")
        imgs = srv.run()
        st = srv.stats()
        statuses = [srv.request(r).status for r in rids]
        log(f"  drained {len(imgs)} of {len(rids)} requests in "
            f"{st['ticks']} ticks, {st['device_steps']} dispatches; shed "
            f"{st['shed']:.0f}; {st['images_per_s']:.2f} images/s, p50 "
            f"{st['latency_p50_s'] * 1e3:.1f} ms, p99 "
            f"{st['latency_p99_s'] * 1e3:.1f} ms (measured)")
        self.gate24(all(s == "done" for s in statuses),
                    f"calibrated drain statuses {statuses}")
        report = sg.print_serve_report(srv, "unet_dec", steps_list,
                                       len(rids), srv._lanes[
                                           "unet_dec"].scan_steps)
        rep["serve"] = {"scan_steps": k, "est_us": est, "stats": st,
                        "serve_report": report}
        del srv
        torch.cuda.empty_cache()
        self.calibrated_tune(geos, calib, rep)

    def phase_fig10(self, rep):
        """24d: the paper's Figure 10 per layer on the card: for each
        dilated and transposed layer of ENet-512 at batch 4, the cycle
        model's decomposed-vs-naive speedup beside the measured one (kernel
        1 on the zero-laden operands over the decomposed call, device
        time)."""
        torch = self.torch
        from repro_torch.core import cycle_model as cm
        from repro_torch.core import enet_spec
        from repro_torch.core.decompose import conv2d
        from repro_torch.core.dilated import zero_insert_weight
        from repro_torch.core.transposed import zero_insert_input

        log("phase 24d: ENet-512 batch 4, decomposed vs naive per layer: "
            "the cycle model (168-MAC array, 500 MHz) beside kernel 1 on "
            "the zero-laden operands on this card")
        layers = enet_spec.enet_512_layers(CLASSES)
        g = torch.Generator().manual_seed(SEED + 24)
        done, rows = {}, []
        with torch.no_grad():
            for l in layers:
                if l.kind not in ("dilated", "transposed"):
                    continue
                geo = (l.kind, l.h_out, l.cin, l.cout, l.D)
                if geo not in done:
                    if l.kind == "dilated":
                        d = l.D + 1
                        x = self.rand(g, BATCH, l.h_out, l.w_out, l.cin)
                        w = self.rand(g, 3, 3, l.cin, l.cout)

                        def dec():
                            return conv2d(x, w, dilation=d)
                        wz = zero_insert_weight(w, d)

                        def naive():
                            return self.kconv.conv2d(x, wz)
                    else:
                        s = l.stride
                        h = l.h_out // s
                        x = self.rand(g, BATCH, h, h, l.cin)
                        w = self.rand(g, 3, 3, l.cin, l.cout)
                        p_lo, p_hi = cm.tconv_pads(l)

                        def dec():
                            return conv2d(x, w, stride=s, transposed=True,
                                          output_padding=1)
                        xz = zero_insert_input(x, s)

                        def naive():
                            return self.kconv.conv2d(
                                xz, w, padding=((p_lo, p_hi), (p_lo, p_hi)))
                    err = self.compare(f"24d {l.name} naive vs decomposed",
                                       "conv2d (24d naive)", naive(), dec(),
                                       quiet=True)[0]
                    done[geo] = (self.device_ms(naive, reps=5),
                                 self.device_ms(dec, reps=5), err)
                    del x, w
                naive_ms, dec_ms, err = done[geo]
                model = cm.cycles_our_general(l) / cm.cycles_our_decomposed(l)
                rows.append({"layer": l.name, "kind": l.kind,
                             "model_speedup": model, "naive_ms": naive_ms,
                             "decomposed_ms": dec_ms,
                             "measured_speedup": naive_ms / dec_ms,
                             "naive_vs_decomposed_err": err})
        log(f"    {'layer':24s} {'model':>7s} {'naive ms':>9s} "
            f"{'dec ms':>8s} {'measured':>8s}")
        for r in rows:
            log(f"    {r['layer']:24s} {r['model_speedup']:7.2f} "
                f"{r['naive_ms']:9.4f} {r['decomposed_ms']:8.4f} "
                f"{r['measured_speedup']:8.2f}")
        sub = [l for l in layers if l.kind in ("dilated", "transposed")]
        model_sub = (sum(cm.cycles_our_general(l) for l in sub)
                     / sum(cm.cycles_our_decomposed(l) for l in sub))
        measured = (sum(r["naive_ms"] for r in rows)
                    / sum(r["decomposed_ms"] for r in rows))
        full = cm.report(layers)["speedup_vs_naive"]
        head = cm.headline(layers)["speedup"]
        log(f"  dilated + transposed layers: model {model_sub:.2f}x, "
            f"measured {measured:.2f}x (sum of naive ms over sum of "
            f"decomposed ms); whole ENet-512 model: speedup_vs_naive "
            f"{full:.2f}x, headline {head:.2f}x")
        rep["fig10"] = {"layers": rows, "model_dilated_transposed": model_sub,
                        "measured_dilated_transposed": measured,
                        "model_speedup_vs_naive": full, "model_headline": head}

    # -------------------------------------------------------------- phase 25
    def run_lm_serving(self):
        """Phase 25: StableLM-2-1.6B served through the port's ``Server``
        at its published configuration; then the fp32 and GQA runs."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import serve
        from repro_torch.models import transformer

        full = get_config(LM_ARCH)
        cfg = full.replace(num_layers=SERVE_LM_LAYERS)
        label = (f"{LM_NAME} ({cfg.num_layers} layers) served, batch "
                 f"{SERVE_LM_BATCH}")
        log(f"phase 25: serve {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}), depth cut from "
            f"{full.num_layers} to {cfg.num_layers} layers, through "
            f"repro_torch.launch.serve."
            f"Server: batch {SERVE_LM_BATCH}, a {SERVE_LM_PROMPT}-token "
            f"prompt drawn from seed {SEED}, {SERVE_LM_GEN} generated tokens")
        rep = self.report["lm_serve"] = {}
        params = self.lm_params(cfg, SEED + 25, rep)
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (SERVE_LM_BATCH, SERVE_LM_PROMPT), dtype=np.int32)
        servers = {b: serve.Server(cfg, max_len=SERVE_LM_PROMPT
                                   + SERVE_LM_GEN, backend=b, params=params)
                   for b in ("kernels", "torch")}
        launches = self.lm_serve_main(cfg, servers["kernels"], prompts, rep)
        groups = self.lm_serve_calls("25b", servers["kernels"], prompts,
                                     label, "wgmma", rep)
        self.lm_serve_logits(cfg, params, prompts, SERVE_LM_FORCED,
                             "25c", rep)
        self.lm_prefill_paths(servers["kernels"], prompts, rep)
        entries = self.lm_serve_times(servers, prompts, groups, launches,
                                      label, rep)
        del servers, params, groups
        torch.cuda.empty_cache()
        self.lm_serve_fp32(prompts, rep)
        self.lm_serve_gqa(rep)
        return entries

    def lm_params(self, cfg, seed, rep):
        """``cfg``'s parameters drawn on the card from a seeded CUDA
        generator; logs their count, size and draw time."""
        torch = self.torch
        from repro_torch.launch.steps import _model_fns
        from repro_torch.models import transformer

        t0 = time.perf_counter()
        params = _model_fns(cfg).init_params(
            torch.Generator(self.dev).manual_seed(seed), cfg, self.dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        leaves = transformer.flatten_params(params).values()
        n = sum(t.numel() for t in leaves)
        gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
        log(f"  {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}) weights: "
            f"{n:,} parameters, {gb:.2f} GB, drawn on the card from seed "
            f"{seed} in {ms:.1f} ms")
        rep.setdefault("weights", {})[cfg.name] = {
            "parameters": n, "gb": gb, "draw_ms": ms,
            "layers": cfg.num_layers, "dtype": cfg.dtype}
        return params

    def check_lm_launches(self, what, want, variant, simt=0, *,
                          attn_variant=None, windowed=0):
        """Read the counts and variants since the last reset; raise unless
        they are ``want`` with every attention launch on ``attn_variant``
        (by default ``variant``), ``windowed`` of them with a band, and
        every matmul launch but ``simt`` of them (whisper's odd-N head) on
        ``variant``."""
        counts, variants = self.read_counts(), self.read_variants()
        banded = self.counters["flash_attention"].launches_windowed
        log(f"  {what}: launches {counts}; matmul by variant "
            f"{variants['matmul']}, flash attention "
            f"{variants['flash_attention']}, {banded} with a window")
        if counts != want:
            raise RuntimeError(f"{what}: launches {counts} != {want}")
        for name, off, v in (("matmul", simt, variant),
                             ("flash_attention", 0, attn_variant or variant)):
            if variants[name][v] != want[name] - off:
                raise RuntimeError(f"{what}: {name} launches {variants[name]}"
                                   f" are not {want[name] - off} {v!r}")
        if banded != windowed:
            raise RuntimeError(f"{what}: {banded} windowed attention "
                               f"launches, not {windowed}")
        return counts

    def lm_serve_main(self, cfg, srv, prompts, rep):
        """25a: the main path.  Counts 0 just before a prefill, a decode
        step and ``Server.generate``, read just after each."""
        torch = self.torch
        log(f"phase 25a: the main path on backend=kernels: one prefill, one "
            f"decode step, then Server.generate ({SERVE_LM_GEN} tokens); "
            f"each a serve step of {cfg.num_layers} x 7 + 1 matmul and "
            f"{cfg.num_layers} attention launches, all \"wgmma\"")
        step = lm_step_launches(cfg)
        launches = {}
        self.reset_counts()
        tok, caches, pos = srv.prefill(prompts)
        torch.cuda.synchronize()
        launches["prefill"] = self.check_lm_launches("prefill", step,
                                                     "wgmma")
        self.reset_counts()
        with torch.no_grad():
            srv.serve_step(srv.params, caches, {"token": tok,
                                                "cache_pos": pos})
        torch.cuda.synchronize()
        launches["decode step"] = self.check_lm_launches(
            f"decode step at position {pos}", step, "wgmma")
        del caches
        self.reset_counts()
        out = srv.generate(prompts, SERVE_LM_GEN)
        torch.cuda.synchronize()
        self.check_lm_launches(
            "generate", {k: v * SERVE_LM_GEN for k, v in step.items()},
            "wgmma")
        if out.shape != (SERVE_LM_BATCH, SERVE_LM_GEN) or not (
                (out >= 0) & (out < cfg.vocab)).all():
            raise RuntimeError(f"generated tokens {out.shape} out of range")
        log(f"  generated {out.shape} token ids; first request's first 8: "
            f"{out[0, :8].tolist()}")
        rep["launches"] = launches
        rep["generated"] = out.tolist()
        return launches

    def lm_serve_calls(self, phase, srv, prompts, label, variant, rep,
                       runs=None):
        """25b: every kernel call of one prefill and one decode step at a
        position > 0 (or of each of ``runs``, {what: fn}), recorded,
        against its plain version at phase 10's bars (bf16: each element
        2^-7 |plain| + 1e-4 x max(1, max|plain|)); each call on
        ``variant``, or on ``variant(name, args)`` where that is a
        function.  Returns one call's arguments and the call count per
        (what, kernel, geometry)."""
        torch = self.torch
        if runs is None:
            state = {}

            def prefill():
                state["out"] = srv.prefill(prompts)

            def decode():
                tok, caches, pos = state.pop("out")
                srv.serve_step(srv.params, caches, {"token": tok,
                                                    "cache_pos": pos})

            runs = {"prefill": prefill, "decode step": decode}
        log(f"phase {phase}: {label}: every kernel call of "
            + " and ".join(f"one {what}" for what in runs)
            + " vs its plain version")
        calls = {what: [] for what in runs}
        with torch.no_grad():
            for what, fn in runs.items():
                with self.recording_lm(calls[what]):
                    fn()
        torch.cuda.synchronize()
        expect = variant if callable(variant) else (lambda n, a: variant)
        groups, caught = {}, []
        for what, rec in calls.items():
            checks = len(self.report["checks"])
            for i, (name, args, out) in enumerate(rec):
                entry = f"{name} ({label}: {what})"
                kern_v = self.lm_call(name, args)
                if kern_v[6] != expect(name, args):
                    raise RuntimeError(f"{entry} call {i}: {kern_v[6]}")
                want = kern_v[1]()
                self.compare(f"{entry} call {i}", entry, out, want,
                             quiet=True)
                caught.append(self.sensitivity(out, want, 1.0, TOL))
                grp = groups.setdefault((what, name, kern_v[5]), [args, 0])
                grp[1] += 1
                del want
            rec.clear()
            worst = max(c["err_over_bar"]
                        for c in self.report["checks"][checks:])
            log(f"  {what}: {i + 1} calls ok, worst error {worst:.3f} x "
                f"its bar")
        zero, off = (min(c[j] for c in caught) for j in range(2))
        log(f"  a zeroed output would reach >= {zero:.3g} x its bar, one 2% "
            f"off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError(f"{label}: a bar would miss a zeroed or a "
                               f"2%-off kernel output")
        rep.setdefault("calls", {})[label] = {
            "checked": len(caught), "zeroed_over_bar": zero,
            "off2_over_bar": off}
        return groups

    def forced_run(self, cfg, params, prompts, steps, backend, feed=None):
        """Logits of a cached prefill of ``prompts`` and ``steps`` decode
        steps on ``backend``; step i is fed ``feed[i]``, by default its own
        greedy token.  Returns (logits, fed tokens)."""
        torch = self.torch
        from repro_torch.models import transformer

        x = torch.as_tensor(prompts, dtype=torch.int32, device=self.dev)
        caches = transformer.init_caches(cfg, x.shape[0], x.shape[1] + steps,
                                         self.dev)
        logits, fed, pos = [], [], 0
        with torch.no_grad():
            for i in range(steps + 1):
                out, caches = transformer.decode_step(
                    params, x, caches, pos, cfg, backend=backend)
                logits.append(out)
                pos += x.shape[1]
                x = (feed[i] if feed is not None else
                     out[:, -1].argmax(-1, keepdim=True).to(torch.int32))
                fed.append(x)
        return logits, fed

    def lm_serve_logits(self, cfg, params, prompts, steps, phase, rep,
                        run=None, names=None):
        """The kernels backend's logits against the torch backend's on the
        same tokens (teacher forcing: the torch backend's greedy tokens fed
        to both) through a prefill and ``steps`` decode steps (``run``,
        :meth:`forced_run` by default; ``names`` its steps): max |err| <=
        5% of max |torch| (DESIGN.md §12's bf16 output bar), and the greedy
        tokens equal wherever the torch top-2 margin exceeds that bar."""
        run = run or self.forced_run
        log(f"phase {phase}: {cfg.name} logits, backend=kernels vs "
            f"backend=torch, teacher-forced through the prefill and {steps} "
            f"decode steps (bar {BF16_FWD_RTOL:.0%} of max|torch|)")
        want, fed = run(cfg, params, prompts, steps, "torch")
        got, _ = run(cfg, params, prompts, steps, "kernels", feed=fed)
        rows = [self.logits_reading(
            f"{cfg.name} " + (names[i] if names else "prefill" if i == 0
                              else f"decode step {i}"),
            g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1]))
            for i, (g, w) in enumerate(zip(got, want))]
        rep.setdefault("logits", {})[cfg.name] = rows
        del got, want

    def logits_reading(self, what, got, want, swapped=None, gate=True):
        """Logits (rows, V) of the kernels backend against the torch
        backend's, ``LOGIT_CHUNK`` rows at a time in fp32 (no fp32 copy of the
        whole): max |err| <= 5% of max|torch| (DESIGN.md §12), and the
        greedy tokens equal wherever the torch top-2 margin exceeds that
        bar (a 5% bar passes a 2% error).  ``swapped`` (a MoE model's rows
        whose routes differ between the backends, ``route_agreement``)
        marks rows read apart: a swapped route sends a token to another
        expert, a jump no bar of the arithmetic covers.  ``gate=False``
        reads without raising (two MoE runs each on its own routes).
        Returns the reading."""
        torch = self.torch
        spans = [(i, i + LOGIT_CHUNK)
                 for i in range(0, want.shape[0], LOGIT_CHUNK)]
        top = max(want[a:b].float().abs().max().item() for a, b in spans)
        bar = BF16_FWD_RTOL * top
        err = gtop = err_sw = 0.0
        agree = gated = bad = past = 0
        for a, b in spans:
            g, w = got[a:b].float(), want[a:b].float()
            row_err = (g - w).abs().amax(-1)
            apart = (swapped[a:b] if swapped is not None
                     else torch.zeros_like(row_err, dtype=torch.bool))
            err = max(err, row_err[~apart].max().item() if (~apart).any()
                      else 0.0)
            if apart.any():
                err_sw = max(err_sw, row_err[apart].max().item())
                past += int((row_err[apart] > bar).sum())
            gtop = max(gtop, g.abs().max().item())
            top2 = w.topk(2, dim=-1).values
            margin = ((top2[:, 0] - top2[:, 1]) > bar) & ~apart
            same = g.argmax(-1) == w.argmax(-1)
            agree += int(same.sum())
            gated += int(margin.sum())
            bad += int((margin & ~same).sum())
            del g, w, top2, row_err
        n_apart = 0 if swapped is None else int(swapped.sum())
        row = {"what": what, "max_abs_err": err, "bar": bar,
               "err_over_bar": err / bar, "positions": want.shape[0],
               "agree": agree, "gated": gated, "gated_disagree": bad,
               "zeroed_over_bar": top / bar,
               "off2_over_bar": 0.02 * gtop / bar,
               "rows_apart": n_apart, "apart_max_abs_err": err_sw,
               "apart_past_bar": past}
        apart = (f"; {n_apart} rows of tokens with a swapped route set "
                 f"apart: max |err| {err_sw:.4f} = {err_sw / bar:.3f} x, "
                 f"{past} past the bar" if swapped is not None else "")
        log(f"  {what}: {want.shape[0] - n_apart} rows held: max |err| "
            f"{err:.4f} = {err / bar:.3f} x the bar "
            f"({bar:.4f}); greedy tokens agree at {agree} of "
            f"{want.shape[0]}, {gated} with a margin over the bar, {bad} of "
            f"those differ; a zeroed output would read {top / bar:.3g} x, "
            f"one 2% off {row['off2_over_bar']:.3g} x{apart}")
        if gate and (err > bar or bad or top / bar <= 1.0):
            raise RuntimeError(f"{what}: kernels logits off the torch "
                               f"backend's: {row}")
        return row

    def lm_prefill_paths(self, srv, prompts, rep):
        """25d: the parallel prefill (one serve step) against the
        ``slow=True`` token loop: the same next token, and caches within
        the reference test's bf16 bound, |a - b| <= 2e-2 + 2e-2 |b|."""
        torch = self.torch
        log(f"phase 25d: parallel prefill vs the slow=True token loop "
            f"({SERVE_LM_PROMPT} serve steps), backend=kernels")
        tok_p, caches_p, _ = srv.prefill(prompts)
        t0 = time.perf_counter()
        tok_s, caches_s, _ = srv.prefill(prompts, slow=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        worst = zero = 0.0
        equal = total = 0
        for a, b in zip(caches_p, caches_s):
            for k in ("k", "v"):
                af, bf = a[k].float(), b[k].float()
                bar = PREFILL_CACHE_TOL * (1 + bf.abs())
                worst = max(worst, ((af - bf).abs() / bar).max().item())
                zero = max(zero, (bf.abs() / bar).max().item())
                equal += int((a[k] == b[k]).sum())
                total += a[k].numel()
                del af, bf, bar
        same = torch.equal(tok_p, tok_s)
        log(f"  loop {secs:.1f} s; next tokens equal: {same}; caches: worst "
            f"{worst:.3f} x the bound, {equal / total:.4%} of entries "
            f"bitwise equal; a zeroed cache would read {zero:.3g} x (the "
            f"bound's relative part is 2%, so no 2%-off cache can fail it)")
        rep["prefill_paths"] = {"loop_s": secs, "same_token": same,
                                "cache_over_bound": worst,
                                "bitwise_share": equal / total,
                                "zeroed_over_bound": zero}
        if not same or worst > 1.0 or zero <= 1.0:
            raise RuntimeError(f"parallel vs sequential prefill: "
                               f"{rep['prefill_paths']}")

    def lm_serve_times(self, servers, prompts, groups, launches, label, rep):
        """25e: per backend, prefill wall ms (time to first token), decode
        ms a step and tokens/s, busy shares and the copies' device ms
        (``torch.profiler``), peak memory; per kernel, the device ms of one
        prefill and one decode step by shape beside bound and library."""
        torch = self.torch
        log(f"phase 25e: {label} times (wall: median of 5 prefills, of 3 "
            f"loops of {SERVE_LM_GEN - 1} decode steps)")
        times = rep["times"] = {}

        def share(x):
            return "not measured" if x is None else f"{x:.1%}"

        for backend, srv in servers.items():
            prefill_ms = self.wall_ms(lambda: srv.prefill(prompts), reps=5)
            tok, caches, pos = srv.prefill(prompts)

            def step(t=tok, p=pos):
                return srv.serve_step(srv.params, caches,
                                      {"token": t, "cache_pos": p})[0]

            def decode_loop():
                t = tok
                for i in range(SERVE_LM_GEN - 1):
                    t = step(t, pos + i)

            with torch.no_grad():
                loop_ms = self.wall_ms(decode_loop, reps=3)
                step_ms = loop_ms / (SERVE_LM_GEN - 1)
                prof = {"prefill": self.profile_device(
                            lambda: srv.prefill(prompts),
                            f"{backend} prefill", prefill_ms),
                        "decode step": self.profile_device(
                            step, f"{backend} decode step", step_ms)}
            del caches
            torch.cuda.reset_peak_memory_stats()
            srv.generate(prompts, SERVE_LM_GEN)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            row = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
                   "tokens_per_s": SERVE_LM_BATCH * 1e3 / step_ms,
                   "peak_gib": peak}
            for what, p in prof.items():
                key = what.replace(" ", "_")
                row[f"{key}_busy"] = p.get("busy_share")
                row[f"{key}_device_ms"] = p.get("device_ms")
                row[f"{key}_copy_ms"] = sum(
                    o["ms"] for o in p.get("top_ops", ())
                    if o["name"] == "aten::copy_")
                row[f"{key}_profile"] = p
            times[backend] = row
            log(f"  {backend}: prefill {prefill_ms:.3f} ms (time to first "
                f"token), decode {step_ms:.3f} ms a step = "
                f"{row['tokens_per_s']:.1f} tokens/s; busy: prefill "
                f"{share(row['prefill_busy'])}, decode step "
                f"{share(row['decode_step_busy'])}; aten::copy_ device ms: "
                f"prefill "
                f"{row['prefill_copy_ms']:.3f}, decode step "
                f"{row['decode_step_copy_ms']:.3f}; peak memory "
                f"{peak:.2f} GiB (weights included)")
        return self.serve_shapes(groups, launches, label, rep)

    def serve_shapes(self, groups, launches, label, rep):
        """Per kernel and shape of ``groups`` (:meth:`lm_serve_calls`), the
        device ms of one call beside its bound, library call and plain
        version, and per (what, kernel) the sums: the kernels line's
        entries, with ``launches[what]``'s counts."""
        torch = self.torch
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
                "bytes_ms", "flops")
        entries, rows = [], []
        with torch.no_grad():
            for what in dict.fromkeys(w for w, _, _ in groups):
                per = {n: dict.fromkeys(keys, 0.0) for n in dict.fromkeys(
                    n for w, n, _ in groups if w == what)}
                for (w, name, geo), (args, n) in groups.items():
                    if w != what:
                        continue
                    kern, plain, lib, flops, nbytes, _, variant = \
                        self.lm_call(name, args)
                    peak_flops = (PEAK_FP32_FLOPS
                                  if args[0].dtype == torch.float32
                                  else PEAK_BF16_FLOPS)
                    r = {"what": what, "kernel": name, "geometry": geo,
                         "variant": variant, "calls": n, "flops": flops,
                         "bytes": nbytes, "ms": self.device_ms(kern),
                         "plain_ms": self.device_ms(plain, reps=3),
                         "library_ms": self.device_ms(lib),
                         "ops_ms": 1e3 * flops / peak_flops,
                         "bytes_ms": 1e3 * nbytes / PEAK_BYTES_S}
                    r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
                    r["tflops"] = flops / r["ms"] / 1e9
                    rows.append(r)
                    for k in keys:
                        per[name][k] += n * r[k]
                    log(f"  {what} {name} [{variant}] {geo} x{n}: "
                        f"{r['ms']:.4f} ms a call, {r['tflops']:.1f} "
                        f"TFLOP/s, bound {r['bound_ms']:.4f} ("
                        + ("ops" if r["ops_ms"] >= r["bytes_ms"] else "bytes")
                        + f"), {r['ms'] / r['bound_ms']:.1f} x bound; "
                        f"library {r['library_ms']:.4f}; plain "
                        f"{r['plain_ms']:.3f}")
                for name, p in per.items():
                    entry = f"{name} ({label}: {what})"
                    log(f"  {entry}: {p['ms']:.3f} ms over "
                        f"{launches[what][name]} launches, "
                        f"{p['flops'] / p['ms'] / 1e9:.1f} TFLOP/s; bound "
                        f"{p['bound_ms']:.3f} ms; library "
                        f"{p['library_ms']:.3f} ms; plain "
                        f"{p['plain_ms']:.3f} ms")
                    entries.append(self.kernel_entry(
                        name, entry, launches[what][name], p))
        rep["shapes"] = rows
        return entries

    @contextlib.contextmanager
    def plain_launchers(self):
        """Stand each LM kernel's plain version in for its launcher: the
        plain path of the same model, on the card."""
        kmm, kfa = self.kmm, self.kfa
        orig = (kmm.matmul_cuda, kfa.flash_attention_cuda)
        kmm.matmul_cuda = kmm.matmul_plain
        kfa.flash_attention_cuda = (
            lambda q, k, v, causal, window=0: kfa.attention_plain(
                q, k, v, causal=causal, window=window))
        try:
            yield
        finally:
            kmm.matmul_cuda, kfa.flash_attention_cuda = orig

    def lm_serve_fp32(self, prompts, rep):
        """25f: the same model in fp32, depth cut to 1 layer: the
        ``"simt"`` variants, logits against the plain path at the fp32
        bar."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import serve

        cfg = get_config(LM_ARCH).replace(dtype="float32",
                                          num_layers=SERVE_LM_FP32_LAYERS)
        log(f"phase 25f: {cfg.name} in fp32, depth cut to "
            f"{cfg.num_layers} layers, batch {SERVE_LM_BATCH}, "
            f"{SERVE_LM_PROMPT}-token prompt: launches, \"simt\", logits vs "
            f"the plain path (tol {TOL} x max(1, max|plain|))")
        params = self.lm_params(cfg, SEED + 26, rep)
        srv = serve.Server(cfg, max_len=SERVE_LM_PROMPT + SERVE_LM_FORCED
                           + 1, params=params)
        step = lm_step_launches(cfg)
        self.reset_counts()
        tok, caches, pos = srv.prefill(prompts)
        torch.cuda.synchronize()
        self.check_lm_launches("fp32 prefill", step, "simt")
        self.reset_counts()
        with torch.no_grad():
            srv.serve_step(srv.params, caches, {"token": tok,
                                                "cache_pos": pos})
        torch.cuda.synchronize()
        self.check_lm_launches("fp32 decode step", step, "simt")
        del caches
        with self.plain_launchers():
            want, fed = self.forced_run(cfg, params, prompts,
                                        SERVE_LM_FORCED, "kernels")
        got, _ = self.forced_run(cfg, params, prompts, SERVE_LM_FORCED,
                                 "kernels", feed=fed)
        rows = []
        for i, (g, w) in enumerate(zip(got, want)):
            what = "prefill" if i == 0 else f"decode step {i}"
            err, _, tol = self.compare(f"fp32 {cfg.num_layers}-layer {what} "
                                       f"logits vs the plain path",
                                       "fp32 served logits", g, w)
            rows.append({"step": what, "max_abs_err": err, "tol": tol,
                         "zeroed_off2": self.sensitivity(g, w, 1.0, TOL)})
        zero, off = (min(r["zeroed_off2"][j] for r in rows) for j in (0, 1))
        log(f"  a zeroed output would reach >= {zero:.3g} x the bar, one "
            f"2% off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("fp32 served logits: a weak bar")
        rep["fp32"] = rows
        del got, want, params, srv
        torch.cuda.empty_cache()

    def lm_serve_gqa(self, rep):
        """25g: GQA (64 query heads on 8 KV heads), qk-norm and head dim
        128: Qwen3-32B at its published widths, depth cut, one prefill and
        GQA_DECODE decode steps with 25a-c's gates."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import serve

        full = get_config(GQA_ARCH)
        cfg = full.replace(num_layers=GQA_LAYERS)
        log(f"phase 25g: {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads on {cfg.kv_heads} KV "
            f"heads x {cfg.head_dim}, qk-norm, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab}, {cfg.dtype}), depth cut from {full.num_layers} "
            f"to {cfg.num_layers} layers, batch {SERVE_LM_BATCH}, "
            f"{SERVE_LM_PROMPT}-token prompt, {GQA_DECODE} decode steps")
        params = self.lm_params(cfg, SEED + 27, rep)
        prompts = np.random.default_rng(SEED + 1).integers(
            0, cfg.vocab, (SERVE_LM_BATCH, SERVE_LM_PROMPT), dtype=np.int32)
        srv = serve.Server(cfg, max_len=SERVE_LM_PROMPT + GQA_DECODE + 1,
                           params=params)
        step = lm_step_launches(cfg)
        self.reset_counts()
        tok, caches, pos = srv.prefill(prompts)
        torch.cuda.synchronize()
        self.check_lm_launches(f"{cfg.name} prefill", step, "wgmma")
        self.reset_counts()
        with torch.no_grad():
            srv.serve_step(srv.params, caches, {"token": tok,
                                                "cache_pos": pos})
        torch.cuda.synchronize()
        self.check_lm_launches(f"{cfg.name} decode step", step, "wgmma")
        del caches
        self.lm_serve_calls("25g", srv, prompts, f"{GQA_NAME}, "
                            f"{cfg.num_layers} layers", "wgmma", rep)
        self.lm_serve_logits(cfg, params, prompts, GQA_DECODE, "25g", rep)
        del params, srv
        torch.cuda.empty_cache()

    # -------------------------------------------------------------- phase 26
    def run_lm_training(self):
        """Phase 26: StableLM-2-1.6B trained on the card at its published
        configuration through ``make_train_step``; the loop drill at the
        reduced configuration."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.data import LMDataPipeline

        full = get_config(LM_ARCH)
        cfg = full.replace(num_layers=TRAIN_LM_LAYERS)
        label = f"{LM_NAME} ({cfg.num_layers} layers) train step"
        log(f"phase 26: train {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}), depth cut from "
            f"{full.num_layers} to {cfg.num_layers} layers, through "
            f"repro_torch.launch.steps."
            f"make_train_step: seq {TRAIN_LM_SEQ}, global batch "
            f"{TRAIN_LM_BATCH} in {TRAIN_LM_MICRO} microbatches, fp32 AdamW "
            f"masters and moments, per-layer remat ({cfg.remat}), "
            f"LMDataPipeline(seed={SEED}) batches, warmup "
            f"{TRAIN_LM_WARMUP} of {TRAIN_LM_TOTAL} steps")
        rep = self.report["lm_train"] = {}
        params = self.lm_params(cfg, SEED + 28, rep)
        pipe = LMDataPipeline(TRAIN_LM_BATCH, TRAIN_LM_SEQ, cfg.vocab,
                              seed=SEED)
        try:
            batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.dev) for k, v in pipe.batch_at(i).items()}
                for i in range(TRAIN_LM_STEPS)]
        finally:
            pipe.close()
        launches = lm_train_launches(cfg, TRAIN_LM_SEQ, TRAIN_LM_MICRO)
        parts = self.lm_train_main(cfg, params, batches[0], launches, label,
                                   rep)
        groups, samples = self.lm_train_calls(cfg, params, batches[0],
                                              launches, label, rep)
        self.lm_train_grads(cfg, params, batches[0], rep)
        self.lm_train_steps(cfg, params, batches, rep)
        self.lm_train_drill(rep)
        entries = self.lm_train_times(cfg, params, batches, groups, samples,
                                      parts, label, rep)
        del params, batches, groups, samples
        torch.cuda.empty_cache()
        return entries

    def train_fns(self, cfg, backend, micro=TRAIN_LM_MICRO):
        """(``make_train_step``, its optimizer state's init) on
        ``backend`` at phase 26's schedule, in ``micro`` microbatches."""
        from repro_torch.launch import steps
        from repro_torch.models import transformer
        from repro_torch.optim import adamw_init

        step = steps.make_train_step(
            cfg, warmup=TRAIN_LM_WARMUP, total_steps=TRAIN_LM_TOTAL,
            microbatches=micro, backend=backend)
        return step, lambda p: adamw_init(
            transformer.flatten_params(p), memory_mode=cfg.opt_memory_mode)

    @contextlib.contextmanager
    def counting_calls(self, counts, targets):
        """Count the calls of each ``(module, attribute)`` in ``targets``
        made inside the block, by attribute name."""
        orig = [getattr(mod, attr) for mod, attr in targets]

        def wrap(attr, fn):
            def wrapper(*args, **kw):
                counts[attr] = counts.get(attr, 0) + 1
                return fn(*args, **kw)
            return wrapper

        for (mod, attr), fn in zip(targets, orig):
            setattr(mod, attr, wrap(attr, fn))
        try:
            yield
        finally:
            for (mod, attr), fn in zip(targets, orig):
                setattr(mod, attr, fn)

    def counting_parts(self, parts, read):
        """Split the launches made inside the block by part
        (``repro_torch.launch.data_axis.count_parts``, which the ranks of
        phase 35 use too): ``forward``, ``recompute`` (a checkpointed
        forward run again in the backward pass) or ``backward``."""
        from repro_torch.launch.data_axis import count_parts

        return count_parts(parts, read)

    def lm_train_main(self, cfg, params, batch, launches, label, rep, *,
                      phase="26a", micro=TRAIN_LM_MICRO, chunks=None,
                      simt=0, attn_variant=None, windowed=0,
                      grads_only=False, routes=None, keep=None):
        """26a: the main path.  Counts 0 just before one train step on
        ``backend="kernels"`` (with ``grads_only``, its loss and gradients,
        ``make_value_and_grad``, which launch every kernel the step does),
        read just after, in all and by part (``counting_parts``): the
        launches ``lm_train_launches`` works out (tested on the CPU), every
        one ``"wgmma"`` but ``simt`` matmuls, the attentions on
        ``attn_variant`` (``"wgmma"`` by default), ``windowed`` of them with
        a band; no library conv or attention, no plain version, no
        ``torch.matmul``; the attention backward's own fp32 products
        (``attention_grads``: per query chunk one ``bmm``, two ``baddbmm``
        and two ``baddbmm_``; ``chunks`` of them, by default phase 26's)
        and the transposes counted apart.  With ``launches["matmul_batched"]``
        (a MoE config, ``lm_train_split``) kernel 3's batched launches are
        read and split apart from its 2-D ones, and with a list ``routes``
        each ``moe.route`` call's (experts, kept) is recorded in it.  A dict
        ``keep`` receives the step's new ``params``, ``opt`` state and
        ``metrics``.  Returns the measured launches by part."""
        torch = self.torch
        F = torch.nn.functional
        kmm, kfa = self.kmm, self.kfa
        want = {"conv2d": 0, "transposed_conv2d": 0,
                **{k: sum(v.values()) for k, v in launches.items()}}
        batched = want.pop("matmul_batched", None)
        if batched is not None:
            want["matmul"] += batched
        if chunks is None:
            chunks = (TRAIN_LM_SEQ // kfa.Q_CHUNK * cfg.num_layers
                      * TRAIN_LM_MICRO)
        log(f"phase {phase}: {label} on backend=kernels, counts 0 just "
            f"before and read just after one step; worked out "
            f"(lm_train_launches): matmul {launches['matmul']}, flash "
            f"attention {launches['flash_attention']}, all \"wgmma\" but "
            f"{simt} \"simt\" matmuls; the attention backward's products: "
            f"{5 * chunks} ({chunks} query chunks over {micro} "
            f"microbatches, 5 each)")
        if grads_only:
            from repro_torch.launch import steps
            vg = steps.make_value_and_grad(cfg, microbatches=micro,
                                           backend="kernels")
        else:
            step, opt_init = self.train_fns(cfg, "kernels", micro)
            opt = opt_init(params)
        other, parts = {}, {}
        targets = [(F, "conv2d"), (F, "conv_transpose2d"),
                   (F, "scaled_dot_product_attention"),
                   (kmm, "matmul_plain"), (kmm, "matmul_batched_plain"),
                   (kfa, "attention_plain"),
                   (torch, "matmul"), (torch, "bmm"), (torch, "baddbmm"),
                   (torch.Tensor, "baddbmm_")]
        transposes = kmm.MatmulFn.transposes
        mm = self.counters["matmul"]

        def read():
            got = {n: self.counters[n].launches for n in launches
                   if n != "matmul_batched"}
            if batched is not None:
                got["matmul_batched"] = mm.launches_batched
                got["matmul"] -= mm.launches_batched
            return got

        self.reset_counts()
        with self.counting_calls(other, targets), self.counting_parts(
                parts, read), self.moe_recording(
                    routes if routes is not None else []):
            if grads_only:
                loss, grads = vg(params, batch)
                m, new_o = {"loss": loss}, None
                del grads
            else:
                new_p, new_o, m = step(params, opt, batch)
            torch.cuda.synchronize()
        counts = self.check_lm_launches(
            "loss and gradients" if grads_only else "train step", want,
            "wgmma", simt, attn_variant=attn_variant, windowed=windowed)
        transposes = kmm.MatmulFn.transposes - transposes
        other = {attr: other.get(attr, 0) for _, attr in targets}
        log(f"  by part, measured: matmul {parts['matmul']}, flash "
            f"attention {parts['flash_attention']}"
            + (f", batched {parts['matmul_batched']}" if batched is not None
               else ""))
        log(f"  other calls in the step: {other}; transposes copied: "
            f"{transposes} (one a backward product)")
        if batched is not None and mm.launches_batched != batched:
            raise RuntimeError(f"{mm.launches_batched} batched launches, "
                               f"not {batched}")
        if parts != launches:
            raise RuntimeError(f"train step launches by part {parts} != "
                               f"{launches}")
        want_other = {"conv2d": 0, "conv_transpose2d": 0,
                      "scaled_dot_product_attention": 0, "matmul_plain": 0,
                      "matmul_batched_plain": 0,
                      "attention_plain": 0, "matmul": 0, "bmm": chunks,
                      "baddbmm": 2 * chunks, "baddbmm_": 2 * chunks}
        backward = sum(launches[k]["backward"] for k in launches
                       if k.startswith("matmul"))
        if other != want_other or transposes != backward:
            raise RuntimeError(f"train step calls {other} (transposes "
                               f"{transposes}) != {want_other}: a product "
                               f"or an attention left the kernels")
        loss = float(m["loss"])
        if grads_only:
            log(f"  step 0: loss {loss:.4f}")
        else:
            log(f"  step 0: loss {loss:.4f}, grad_norm "
                f"{float(m['grad_norm']):.4f}, lr {float(m['lr']):.3e}")
        if not math.isfinite(loss) or (new_o is not None
                                       and int(new_o.step) != 1):
            raise RuntimeError(f"train step: loss {loss}, step "
                               f"{None if new_o is None else int(new_o.step)}")
        rep["launches"] = {"counted": counts, "by_part": parts,
                           "worked_out": launches, "other": other,
                           "transposes": transposes}
        if keep is not None:
            keep.update(params=None if grads_only else new_p, opt=new_o,
                        metrics=m)
        return parts

    def lm_train_calls(self, cfg, params, batch, launches, label, rep, *,
                       phase="26b", micro=TRAIN_LM_MICRO, once=False,
                       run=None):
        """26b: every kernel-3 and kernel-4 call of one microbatch's
        forward and backward (the recompute included), each held against
        its plain version as it is made at phase 10's bf16 bar (a product
        of the backward, whose cotangents are small, without the max(1, .)
        floor, as phases 6 and 14), with what a zeroed output and one 2%
        off would read; the calls by part are ``launches`` (a step's, by
        part) over the microbatches.  Returns one call's arguments and the
        call count per (part, kernel, geometry), part ``forward``, ``recompute`` (a
        forward run again inside the backward pass) or ``backward`` (dA
        and dB); and one sample of the attention's inputs per attention
        geometry with its call count, and the count of every transposed
        shape.  With ``once`` only the first call of each (part, kernel,
        geometry) is held (phase 32b: a 4,096-step sLSTM loop repeats its
        shapes); ``run`` (no arguments) takes the microbatch's place (phase
        32c: one mixer's forward and backward)."""
        torch = self.torch
        from repro_torch.launch import steps

        kmm, kfa = self.kmm, self.kfa
        which = ("the first kernel call of each shape by part" if once
                 else "every kernel call")
        if run is None:
            rows = batch["tokens"].shape[0] // micro
            mb = {k: v[:rows] for k, v in batch.items()}
            vg = steps.make_value_and_grad(cfg, backend="kernels")
            what = (f"one microbatch's forward and backward ({rows} x "
                    f"{batch['tokens'].shape[1]} tokens)")
        else:
            what = "its forward and backward"
        log(f"phase {phase}: {label}: {which} of {what} vs its plain "
            f"version, checked as it is made (backward products: no max(1, "
            f".) floor)")
        groups, caught = {}, {}
        samples = {"transposes": {}, "attention": {}}
        # the innermost Function body running (forward or backward) and
        # how many torch.autograd.grad calls are open
        state = {"stack": [], "grad": 0, "n": 0, "zero": 0}
        orig = (kmm.matmul_cuda, kfa.flash_attention_cuda,
                kmm.MatmulFn.forward, kmm.MatmulFn.backward,
                kfa.FlashAttentionFn.forward, torch.autograd.grad,
                kmm._transposed, kmm.matmul_batched_cuda,
                kmm.BatchedMatmulFn.forward, kmm.BatchedMatmulFn.backward)

        def part():
            if state["stack"][-1] == "backward":
                return "backward"
            return "recompute" if state["grad"] else "forward"

        def check(name, args, out, plain):
            where = part()
            geo = self.lm_call(name, args)[5]
            if once and (where, name, geo) in groups:
                groups[where, name, geo][1] += 1
                return
            entry = (f"{name} ({label} "
                     f"{'backward' if where == 'backward' else 'forward'})"
                     if name.startswith("matmul")
                     else f"flash_attention ({label})")
            floor = 0.0 if where == "backward" else 1.0
            want = plain()
            self.compare(f"{entry} call {state['n']} ({where})", entry, out,
                         want, quiet=True, floor=floor)
            if bool(want.any()):
                caught.setdefault(where, []).append(
                    self.sensitivity(out, want, floor, TOL))
            else:   # a top-1 router's dA and dB: its gate is the constant 1
                state["zero"] += 1
            state["n"] += 1
            grp = groups.setdefault((where, name, geo), [args, 0])
            grp[1] += 1

        def mm(a, b):
            out = orig[0](a, b)
            check("matmul", (a, b), out, lambda: kmm.matmul_plain(a, b))
            return out

        def bmm(a, b):
            out = orig[7](a, b)
            check("matmul_batched", (a, b), out,
                  lambda: kmm.matmul_batched_plain(a, b))
            return out

        def fa(q, k, v, causal, window=0):
            out = orig[1](q, k, v, causal, window)
            args = (q, k, v, causal, window)
            if part() == "forward":
                geo = self.lm_call("flash_attention", args)[5]
                samples["attention"].setdefault(geo, [args, 0])
                samples["attention"][geo][1] += 1
            check("flash_attention", args, out,
                  lambda: torch.cat([kfa.attention_plain(
                      q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal,
                      window=window) for i in range(q.shape[0])]))
            return out

        def inside(what, fn):
            def wrapper(*args, **kw):
                state["stack"].append(what)
                try:
                    return fn(*args, **kw)
                finally:
                    state["stack"].pop()
            return staticmethod(wrapper)

        def grad(*args, **kw):
            state["grad"] += 1
            try:
                return orig[5](*args, **kw)
            finally:
                state["grad"] -= 1

        def transposed(t):
            key = (tuple(t.shape), str(t.dtype))
            samples["transposes"][key] = samples["transposes"].get(key, 0) + 1
            return orig[6](t)

        kmm.matmul_cuda, kfa.flash_attention_cuda = mm, fa
        kmm.matmul_batched_cuda = bmm
        kmm.MatmulFn.forward = inside("forward", orig[2])
        kmm.MatmulFn.backward = inside("backward", orig[3])
        kfa.FlashAttentionFn.forward = inside("forward", orig[4])
        kmm.BatchedMatmulFn.forward = inside("forward", orig[8])
        kmm.BatchedMatmulFn.backward = inside("backward", orig[9])
        torch.autograd.grad, kmm._transposed = grad, transposed
        try:
            if run is None:
                loss, grads = vg(params, mb)
            else:
                loss, grads = run(), None
            torch.cuda.synchronize()
        finally:
            kmm.matmul_cuda, kfa.flash_attention_cuda = orig[:2]
            kmm.MatmulFn.forward = staticmethod(orig[2])
            kmm.MatmulFn.backward = staticmethod(orig[3])
            kfa.FlashAttentionFn.forward = staticmethod(orig[4])
            torch.autograd.grad, kmm._transposed = orig[5:7]
            kmm.matmul_batched_cuda = orig[7]
            kmm.BatchedMatmulFn.forward = staticmethod(orig[8])
            kmm.BatchedMatmulFn.backward = staticmethod(orig[9])
        del grads
        per_part = {}
        for (where, name, _), (_, n) in groups.items():
            per_part[(where, name)] = per_part.get((where, name), 0) + n
        worst = {e: self.worst[e] for e in (
            f"matmul ({label} forward)", f"matmul ({label} backward)",
            f"matmul_batched ({label} forward)",
            f"matmul_batched ({label} backward)",
            f"flash_attention ({label})") if e in self.worst}
        reads = {w: [min(c[j] for c in cs) for j in range(2)]
                 for w, cs in caught.items()}
        log(f"  {state['n']} calls ok"
            + ("" if loss is None else f", loss {float(loss):.4f}")
            + "; by part: "
            + ", ".join(f"{w} {n} x {k}" for (w, k), n in per_part.items())
            + f"; worst max abs err {json.dumps(worst)}")
        for w, (zero, off) in reads.items():
            log(f"  {w}: a zeroed output would reach >= {zero:.3g} x its "
                f"bar, one 2% off >= {off:.3g} x")
        if state["zero"]:
            log(f"  {state['zero']} calls whose plain output is all zeros "
                f"(held exactly, no zeroed or 2%-off output to tell apart)")
        want = {(w, k): n // micro for k, by in launches.items()
                for w, n in by.items() if n}
        if per_part != want:
            raise RuntimeError(f"{label}: one microbatch's calls by part "
                               f"{per_part} != {want}")
        if not all(zero > 1.0 and off > 1.0 for zero, off in reads.values()):
            raise RuntimeError(f"{label}: a bar would miss a zeroed or a "
                               f"2%-off kernel output: {reads}")
        rep["calls"] = {"checked": state["n"], "zeroed_off2_over_bar": reads,
                        "all_zero_plain": state["zero"],
                        "by_part": {f"{w} {k}": n
                                    for (w, k), n in per_part.items()}}
        return groups, samples

    def lm_train_grads(self, cfg, params, batch, rep, *, phase="26c",
                       micro=TRAIN_LM_MICRO):
        """26c: step-0 loss, gradient norm and gradients, kernels against
        ``backend="torch"`` from one state and batch: loss within 5%,
        gradient norm within 10%, each gradient tensor at 10% relative L2
        (DESIGN.md §12).  A MoE config's torch run takes the kernels run's
        routes (``moe_recording(force=)``, replayed in call order over the
        forward and the recompute), after a free torch run whose routes
        are compared with the kernels' (``route_agreement``, read, not
        gated); a top-1 router's gradient must be exactly zero on both
        backends."""
        from repro_torch.launch import steps
        from repro_torch.optim import global_norm

        log(f"phase {phase}: step-0 gradients, backend=kernels vs "
            f"backend=torch "
            f"(loss {BF16_FWD_RTOL:.0%}, grad_norm {BF16_GRAD_RTOL:.0%}, "
            f"each tensor {BF16_GRAD_RTOL:.0%} relative L2)"
            + (", the torch run on the kernels run's routes" if cfg.moe
               else ""))
        out, seen = {}, {"kernels": [], "torch": []}
        runs = [("kernels", seen["kernels"], None), ("torch", [], True)]
        if cfg.moe is not None:
            runs.insert(0, ("torch free", seen["torch"], None))
        for name, record, force in runs:
            backend = name.split(" ")[0]
            vg = steps.make_value_and_grad(cfg, microbatches=micro,
                                           backend=backend)
            with self.moe_recording(record, force=[
                    r[0] for r in seen["kernels"]] if force else None):
                loss, grads = vg(params, batch)
            out[name] = (float(loss), float(global_norm(grads)),
                         None if name == "torch free" else grads)
            del grads
        if cfg.moe is not None:
            free = out.pop("torch free")
            _, rep["routes_free"] = self.route_agreement(
                f"{phase}: routes, each backend on its own (read, not "
                f"gated; the free torch run's loss {free[0]:.5f}, grad_norm "
                f"{free[1]:.5f})", seen["kernels"], seen["torch"],
                batch["tokens"].numel() // micro)
            if cfg.moe.top_k == 1:
                nonzero = {b: [k for k, g in out[b][2].items()
                               if k.endswith("ffn.router") and bool(g.any())]
                           for b in ("kernels", "torch")}
                log(f"  top-1 router gradients nonzero: {nonzero} (must be "
                    f"none: the one gate is the constant 1)")
                if any(nonzero.values()):
                    raise RuntimeError(f"top-1 router gradients {nonzero}")
        (lk, nk, gk), (lt, nt, gt) = out["kernels"], out["torch"]
        rel = {k: ((gk[k].float() - gt[k].float()).norm()
                   / gt[k].float().norm().clamp_min(1e-30)).item()
               for k in gt}
        worst = max(rel, key=rel.get)
        log(f"  loss {lk:.5f} vs {lt:.5f} ({abs(lk - lt) / abs(lt):.2e}); "
            f"grad_norm {nk:.5f} vs {nt:.5f} ({abs(nk - nt) / nt:.2e}); "
            f"{len(rel)} gradient tensors, worst {worst} at relative L2 "
            f"{rel[worst]:.3e} (median {statistics.median(rel.values()):.3e}"
            f"); a zeroed gradient would read 1.0")
        rep["grads"] = {"loss": [lk, lt], "grad_norm": [nk, nt],
                        "worst": [worst, rel[worst]], "rel_l2": rel}
        if not (abs(lk - lt) <= BF16_FWD_RTOL * abs(lt)
                and abs(nk - nt) <= BF16_GRAD_RTOL * nt
                and rel[worst] <= BF16_GRAD_RTOL):
            raise RuntimeError(f"step-0 gradients off the torch backend's: "
                               f"{rep['grads']['loss']}, "
                               f"{rep['grads']['grad_norm']}, {worst} "
                               f"{rel[worst]}")
        del out, gk, gt

    def lm_train_steps(self, cfg, params, batches, rep, *, phase="26d",
                       micro=TRAIN_LM_MICRO, rtol=BF16_FWD_RTOL,
                       backends=("kernels", "torch")):
        """26d: three steps on ``backends`` (both by default) from one state
        on successive batches: losses finite and within ``rtol`` (5%) of
        each other, masters fp32, parameters in their dtypes (bf16; a MoE
        router fp32), ``opt_state.step`` 3."""
        torch = self.torch
        from repro_torch.models import transformer

        log(f"phase {phase}: {TRAIN_LM_STEPS} make_train_step steps on "
            f"{' and '.join(backends)} from one state on successive batches")
        losses = {}
        for backend in backends:
            step, opt_init = self.train_fns(cfg, backend, micro)
            p, o = params, opt_init(params)
            losses[backend] = []
            for b in batches[:TRAIN_LM_STEPS]:
                p, o, m = step(p, o, b)
                losses[backend].append(float(m["loss"]))
            dtypes = ({str(t.dtype) for t in
                       transformer.flatten_params(p).values()},
                      {str(t.dtype) for t in o.master.values()})
            log(f"  {backend}: losses {losses[backend]}, parameters "
                f"{dtypes[0]}, masters {dtypes[1]}, step {int(o.step)}")
            if (dtypes != ({str(t.dtype) for t in transformer.
                            flatten_params(params).values()},
                           {"torch.float32"})
                    or int(o.step) != TRAIN_LM_STEPS
                    or not all(map(math.isfinite, losses[backend]))):
                raise RuntimeError(f"{backend} steps: {losses[backend]}, "
                                   f"{dtypes}, step {int(o.step)}")
            del p, o, m
            torch.cuda.empty_cache()
        if "torch" not in losses:
            rep["steps"] = {"losses": losses}
            return
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernels"],
                                                   losses["torch"])]
        log(f"  kernels vs torch losses: relative {[f'{r:.2e}' for r in rel]}"
            f" (bar {rtol:.1%})")
        rep["steps"] = {"losses": losses, "rel": rel}
        if max(rel) > rtol:
            raise RuntimeError(f"train losses differ: {losses}")

    def lm_train_drill(self, rep, arch=LM_ARCH, phase="26e"):
        """26e: ``launch.train.train`` at the reduced configuration on the
        card, a checkpoint every 2 steps: an uninterrupted run twice and a
        run with a failure injected at step 3.  One recovery, the requested
        final step, and the resumed run's last loss and final checkpoint
        equal to the uninterrupted run's bit for bit (if two uninterrupted
        runs differ, the step is not deterministic on the card: then held
        to the bf16 bar)."""
        torch = self.torch
        from repro_torch.checkpoint import (flatten_tree, latest_step,
                                            restore_checkpoint)
        from repro_torch.configs import get_reduced
        from repro_torch.distributed.fault_tolerance import FailureInjector
        from repro_torch.launch import train

        cfg = get_reduced(arch)
        root = os.path.join(ROOT, "chiprun_out", f"train_drill_{arch}")
        shutil.rmtree(root, ignore_errors=True)
        log(f"phase {phase}: the train loop at {cfg.name} on the card: "
            f"{DRILL_LM_STEPS} steps of {TRAIN_LM_BATCH} x {DRILL_LM_SEQ} "
            f"tokens in {TRAIN_LM_MICRO} microbatches, a checkpoint every "
            f"{DRILL_LM_EVERY} steps, one failure injected at step "
            f"{DRILL_LM_FAIL}")
        kw = dict(steps=DRILL_LM_STEPS, global_batch=TRAIN_LM_BATCH,
                  seq_len=DRILL_LM_SEQ, microbatches=TRAIN_LM_MICRO,
                  ckpt_every=DRILL_LM_EVERY, device=self.dev,
                  log_every=DRILL_LM_STEPS, seed=SEED)
        runs, states = {}, {}
        for name, inj in (("clean", None), ("again", None),
                          ("failed", FailureInjector({DRILL_LM_FAIL}))):
            d = os.path.join(root, name)
            runs[name] = train.train(cfg, ckpt_dir=d, injector=inj, **kw)
            states[name] = restore_checkpoint(
                d, latest_step(d), train.init_state(cfg, None, "meta"))
        shutil.rmtree(root, ignore_errors=True)

        def same(a, b):
            la, lb = (flatten_tree(states[x])[0] for x in (a, b))
            return runs[a]["loss"] == runs[b]["loss"] and all(
                torch.equal(x, y) for x, y in zip(la, lb))

        hit, clean = runs["failed"], runs["clean"]
        deterministic = same("clean", "again")
        bitwise = same("failed", "clean")
        log(f"  recoveries {hit['recoveries']}, final step "
            f"{hit['final_step']}, stragglers {hit['stragglers']}; last loss "
            f"{hit['loss']!r} resumed vs {clean['loss']!r} uninterrupted; "
            f"final state bitwise: {bitwise}; two uninterrupted runs "
            f"bitwise: {deterministic}")
        rep["drill"] = {"runs": runs, "bitwise": bitwise,
                        "deterministic": deterministic}
        if hit["recoveries"] != 1 or hit["final_step"] != DRILL_LM_STEPS \
                or clean["recoveries"] != 0:
            raise RuntimeError(f"train loop drill: {runs}")
        if not bitwise:
            if deterministic:
                raise RuntimeError("the resumed run is not the "
                                   "uninterrupted run's, and the step is "
                                   "deterministic")
            rel = abs(hit["loss"] - clean["loss"]) / abs(clean["loss"])
            log(f"  the step is not deterministic on the card; resumed vs "
                f"uninterrupted loss at {rel:.2e} (bar {BF16_FWD_RTOL:.0%})")
            if rel > BF16_FWD_RTOL:
                raise RuntimeError(f"resumed loss off: {runs}")

    def lm_train_times(self, cfg, params, batches, groups, samples,
                       parts, label, rep, *, phase="26f",
                       micro=TRAIN_LM_MICRO, timed=TRAIN_LM_TIMED,
                       grads_only=False):
        """26f: per backend, step wall ms (median of ``timed`` warm steps;
        with ``grads_only`` the step's loss and gradients alone,
        ``make_value_and_grad``, and no optimizer), tokens/s (and an
        encoder-decoder's frames/s), model FLOP/s
        (6 N D, the reference's roofline count; an encoder-decoder's
        encoder parameters times its frames, the rest times the tokens)
        against the bf16 peak, the busy share and device ms by class
        (``torch.profiler``), peak memory; for the kernels backend the
        pieces timed alone (the attention backward's recompute, the
        transposes, the optimizer); and every distinct kernel-3 and
        kernel-4 shape of the step: calls, ms, bound, plain and library.
        Each kernels-line entry's launches are ``parts``, the main path's
        counts of a step by part."""
        torch = self.torch
        from repro_torch.launch import steps
        from repro_torch.models import transformer
        from repro_torch.optim import adamw_update

        kfa = self.kfa
        what = "loss and gradients" if grads_only else "step"
        tokens = batches[0]["tokens"].numel()
        flops = 6 * cfg.param_counts()["active"] * tokens
        frames = 0
        if cfg.encoder_layers:
            frames = batches[0]["frames"].shape[0] * batches[0][
                "frames"].shape[1]
            d, hd = cfg.d_model, cfg.head_dim
            n_enc = cfg.encoder_layers * (
                2 * d * (cfg.num_heads + cfg.kv_heads) * hd
                + 3 * d * cfg.d_ff)
            flops += 6 * n_enc * (frames - tokens)
        log(f"phase {phase}: {label} times (wall: median of {timed} warm "
            f"runs of the {what}; model FLOPs 6 N D = {flops:.4g} a step)")
        classes = {"kernel 3": ("matmul_wgmma_kernel", "matmul_kernel"),
                   "kernel 4": ("flash_attention_wgmma_kernel",
                                "flash_attention_kernel"),
                   "library GEMM": ("gemm", "xmma", "nvjet", "cutlass",
                                    "Kernel2"),
                   "library attention": ("flash", "fmha", "attention")}
        if cfg.moe is not None:
            # the MoE dispatch and combine (the routing's sorts and
            # searchsorted, the gathers, index_put and their backwards) and
            # the embedding's backward, an index_put too
            classes["index ops"] = ("index", "gather", "scatter", "ort",
                                    "searchsorted")
        times = rep["times"] = {}
        for backend in ("kernels", "torch"):
            if grads_only:
                vg = steps.make_value_and_grad(cfg, microbatches=micro,
                                               backend=backend)
                state = [params, None]

                def run(b, vg=vg):
                    vg(params, b)
            else:
                step, opt_init = self.train_fns(cfg, backend, micro)
                state = [params, opt_init(params)]

                def run(b, step=step, state=state):
                    state[:] = step(*state, b)[:2]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for i in range(2 + timed):
                t0 = time.perf_counter()
                run(batches[i % len(batches)])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = statistics.median(walls[2:])
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = self.profile_device(
                lambda: run(batches[0]), f"{backend} train {what}",
                wall, classes)
            p, o = state
            row = {"wall_ms": wall, "walls_ms": walls,
                   "tokens_per_s": tokens * 1e3 / wall,
                   "frames_per_s": frames * 1e3 / wall,
                   "model_tflops": flops / wall / 1e9,
                   "mfu": flops / wall / 1e-3 / PEAK_BF16_FLOPS,
                   "peak_gib": peak, "busy": prof.get("busy_share"),
                   "device_ms": prof.get("device_ms"),
                   "classes": prof.get("classes"),
                   "copy_ms": sum(op["ms"] for op in prof.get("top_ops", ())
                                  if op["name"] == "aten::copy_"),
                   "profile": prof}
            if backend == "kernels" and not grads_only:
                grads = {k: torch.full_like(t, 1e-3, dtype=torch.float32)
                         for k, t in transformer.flatten_params(p).items()}
                opt_prof = self.profile_device(
                    lambda: adamw_update(grads, o, transformer.flatten_params(
                        p), lr=1e-4), "optimizer (AdamW)", wall)
                row["optimizer_ms"] = opt_prof.get("device_ms")
                del grads
            del p, o, state
            torch.cuda.empty_cache()
            times[backend] = row
            busy = ("not measured" if row["busy"] is None
                    else f"{row['busy']:.1%}")
            log(f"  {backend}: {what} {wall:.3f} ms (warm runs "
                f"{[round(w, 1) for w in walls[2:]]}), "
                f"{row['tokens_per_s']:.1f} tokens/s, "
                + (f"{row['frames_per_s']:.1f} frames/s, " if frames else "")
                + f"{row['model_tflops']:.1f} model TFLOP/s = "
                f"{row['mfu']:.1%} of the bf16 peak; busy {busy}; "
                f"aten::copy_ {row['copy_ms']:.3f} ms; peak memory "
                f"{peak:.2f} GiB")
        # pieces of the kernels step, each timed alone: the attention
        # backward's recompute per attention geometry x its calls a step
        recompute = {}
        for geo, ((q, k, v, causal, window), n) in samples[
                "attention"].items():
            g = torch.randn(q.shape, generator=torch.Generator(self.dev)
                            .manual_seed(SEED), device=self.dev).to(q.dtype)
            recompute[geo] = micro * n * self.device_ms(
                lambda: kfa.attention_grads(q, k, v, g, causal=causal,
                                            window=window),
                reps=2, rounds=3)
            log(f"  attention backward recompute {geo} x{micro * n}: "
                f"{recompute[geo]:.3f} ms a step")
            del g
        recompute_ms = sum(recompute.values())
        transpose_ms = 0.0
        for (shape, dtype), n in samples["transposes"].items():
            t = torch.randn(shape, device=self.dev).to(getattr(
                torch, dtype.removeprefix("torch.")))
            transpose_ms += micro * n * self.device_ms(
                lambda: t.transpose(-2, -1).contiguous())
            del t
        rows, per = self.lm_train_shapes(groups, label, micro)
        k3f, k3b = (per[f"matmul ({label} {w})"]["ms"]
                    for w in ("forward", "backward"))
        k4 = per[f"flash_attention ({label})"]["ms"]
        row = times["kernels"]
        split = {"kernel 3 forward": k3f, "kernel 3 backward": k3b,
                 "kernel 4": k4, "attention backward recompute":
                 recompute_ms, "transposes": transpose_ms}
        if cfg.moe is not None:
            # the batched form apart, and the fp32 routers' "simt" products
            # (counted in kernel 3's 2-D time) by part
            for w in ("forward", "backward"):
                split[f"kernel 3 batched {w}"] = per[
                    f"matmul_batched ({label} {w})"]["ms"]
                split[f"routers simt {w} (in kernel 3 {w})"] = sum(
                    r["calls"] * r["ms"] for r in rows
                    if r["variant"] == "simt" and r["kernel"] == "matmul"
                    and (r["part"] == "backward") == (w == "backward"))
            classes_ms = row.get("classes") or {}
            split["index ops: dispatch, combine, embedding (profiler)"] = (
                classes_ms.get("index ops"))
        if not grads_only:
            split["optimizer"] = row["optimizer_ms"]
        if row["device_ms"] is not None and None not in split.values():
            split["rest"] = row["device_ms"] - sum(
                v for k, v in split.items() if " (in " not in k)
        row["split_ms"] = split
        row["recompute_ms_by_geometry"] = recompute
        log(f"  kernels {what} device ms, each piece timed alone (kernel 3 "
            f"and 4: per shape x calls): " + ", ".join(
                f"{k} {v:.3f}" for k, v in split.items() if v is not None)
            + f" of {row['device_ms']} busy")
        rep["shapes"] = rows
        entries = []
        for entry, p in per.items():
            name = entry.split(" ")[0]
            n = (parts[name]["forward"] + parts[name]["recompute"]
                 if "backward" not in entry else parts[name]["backward"])
            log(f"  {entry}: {p['ms']:.3f} ms over {n} launches, "
                f"{p['flops'] / p['ms'] / 1e9:.1f} TFLOP/s; bound "
                f"{p['bound_ms']:.3f} ms; library {p['library_ms']:.3f} ms; "
                f"plain {p['plain_ms']:.3f} ms")
            entries.append(self.kernel_entry(name, entry, n, p))
        return entries

    def lm_train_shapes(self, groups, label, micro=TRAIN_LM_MICRO):
        """Each distinct kernel-3 and kernel-4 shape of 26b's microbatch,
        timed: kernel, plain and library device ms, bound; the sums per
        step (calls x ``micro``) per kernels-line entry."""
        torch = self.torch
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
                "bytes_ms", "flops")
        names = ["matmul"] + (["matmul_batched"] if any(
            n == "matmul_batched" for _, n, _ in groups) else [])
        per = {e: dict.fromkeys(keys, 0.0) for e in (
            *(f"{n} ({label} {w})" for n in names
              for w in ("forward", "backward")),
            f"flash_attention ({label})")}
        rows, timed = [], {}
        with torch.no_grad():
            for (part, name, geo), (args, n) in groups.items():
                kern, plain, lib, flops, nbytes, _, variant = self.lm_call(
                    name, args)
                if (name, geo) not in timed:   # a recompute's shapes are
                    timed[name, geo] = {        # its forward's
                        "ms": self.device_ms(kern),
                        "plain_ms": self.device_ms(plain, reps=3),
                        "library_ms": self.device_ms(lib)}
                calls = n * micro
                r = {"part": part, "kernel": name, "geometry": geo,
                     "variant": variant, "calls": calls, "flops": flops,
                     "bytes": nbytes, **timed[name, geo],
                     "ops_ms": 1e3 * flops / (
                         PEAK_FP32_FLOPS if args[0].dtype == torch.float32
                         else PEAK_BF16_FLOPS),
                     "bytes_ms": 1e3 * nbytes / PEAK_BYTES_S}
                r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
                r["tflops"] = flops / r["ms"] / 1e9
                rows.append(r)
                entry = (f"flash_attention ({label})"
                         if name == "flash_attention" else f"{name} ({label} "
                         f"{'backward' if part == 'backward' else 'forward'})")
                for k in keys:
                    per[entry][k] += calls * r[k]
                log(f"  {part} {name} [{variant}] {geo} x{calls}: "
                    f"{r['ms']:.4f} ms a call, {r['tflops']:.1f} TFLOP/s, "
                    f"bound {r['bound_ms']:.4f} ("
                    + ("ops" if r["ops_ms"] >= r["bytes_ms"] else "bytes")
                    + f"), {r['ms'] / r['bound_ms']:.2f} x bound; library "
                    f"{r['library_ms']:.4f}; plain {r['plain_ms']:.3f}")
        return rows, per

    # -------------------------------------------------------------- phase 27
    def run_whisper(self):
        """Phase 27: whisper-small served (its frames from the frontend on
        kernel 1) and trained on the card at its published configuration,
        the loop drill at the reduced one and an fp32 run at depth 1 + 1
        (module docstring, 27a-e).  Returns its entries of the kernels
        line."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import serve

        full = get_config(WH_ARCH)
        cfg = full.replace(num_layers=WH_LAYERS, encoder_layers=WH_LAYERS)
        log(f"phase 27: {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}, encoder_ctx {cfg.encoder_ctx}, "
            f"{cfg.dtype}), depth cut from {full.encoder_layers} + "
            f"{full.num_layers} to {cfg.encoder_layers} + {cfg.num_layers} "
            f"layers")
        rep = self.report["whisper"] = {}
        params = self.lm_params(cfg, SEED + 29, rep)
        frames, entries = self.wh_frontend(rep)
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (WH_BATCH, WH_PROMPT), dtype=np.int32)
        servers = {b: serve.Server(cfg, max_len=WH_CTX, backend=b,
                                   params=params)
                   for b in ("kernels", "torch")}
        label = (f"{cfg.name} ({cfg.encoder_layers} + {cfg.num_layers} "
                 f"layers) served, batch {WH_BATCH}")
        srv = servers["kernels"]
        launches = self.wh_serve_main(cfg, srv, prompts, frames, rep)
        with torch.no_grad():
            enc_out = srv.encode(frames)
            tok, caches, pos = srv.prefill(prompts, enc_out=enc_out)
        runs = {"encode": lambda: srv.encode(frames),
                "decode step": lambda: srv.serve_step(
                    srv.params, caches, {"token": tok, "cache_pos": pos,
                                         "enc_out": enc_out})}
        groups = self.lm_serve_calls("27b", srv, prompts, label,
                                     self.wh_variant(cfg), rep, runs=runs)
        del runs, caches, enc_out, srv
        self.wh_serve_logits(cfg, params, prompts, frames, rep)
        entries += self.wh_serve_times(cfg, servers, prompts, frames, groups,
                                       launches, label, rep)
        del servers, groups
        torch.cuda.empty_cache()
        entries += self.wh_train(cfg, params, rep)
        del params
        torch.cuda.empty_cache()
        self.lm_train_drill(rep, WH_ARCH, "27d")
        self.wh_fp32(prompts, frames, rep)
        return entries

    @staticmethod
    def wh_variant(cfg):
        """The variant of each whisper call: ``"simt"`` for the LM head's
        products (N or K is the odd vocab, which TMA cannot tile),
        ``"wgmma"`` for every other bf16 product and attention."""
        return lambda name, args: (
            "simt" if name == "matmul" and cfg.vocab in args[1].shape
            else "wgmma")

    def wh_frontend(self, rep):
        """27a-b: the frontend (kernel 1, fp32) turns batch WH_BATCH seeded
        (3000, 80) log-mels into the (WH_BATCH, 1500, 768) frames of phase
        27.  Counts 0 just before, read just after: 2 conv2d launches; each
        call against its plain version at phase 3's bar; the frames
        against ``backend="torch"`` (cuDNN, TF32 off) at 1e-4 x max(1,
        max|ref|); each call timed beside its bound and library call.
        Returns the frames and the frontend's kernels-line entry."""
        torch = self.torch
        from repro_torch.models import whisper as wh

        label = f"conv2d (Whisper frontend, batch {WH_BATCH})"
        log(f"phase 27a: the whisper-small frontend on kernel 1 (fp32): "
            f"{WH_BATCH} seeded ({wh.N_FRAMES}, {wh.N_MELS}) log-mels -> "
            f"({WH_BATCH}, {(wh.N_FRAMES + 1) // 2}, {wh.D_MODEL}) frames")
        fparams = wh.init_frontend_params(
            torch.Generator().manual_seed(SEED + 27), device=self.dev)
        mel = torch.from_numpy(np.random.default_rng(SEED + 27)
                               .standard_normal((WH_BATCH, wh.N_FRAMES,
                                                 wh.N_MELS),
                                                dtype=np.float32)).to(self.dev)
        calls = []
        self.reset_counts()
        with torch.no_grad(), self.recording(calls):
            frames = wh.frontend(fparams, mel)
        torch.cuda.synchronize()
        counts = self.read_counts()
        want = {"conv2d": 2, "transposed_conv2d": 0, "matmul": 0,
                "flash_attention": 0}
        log(f"  frontend launches {counts}")
        if counts != want or frames.shape != (
                WH_BATCH, (wh.N_FRAMES + 1) // 2, wh.D_MODEL):
            raise RuntimeError(f"frontend: launches {counts} != {want}, "
                               f"frames {tuple(frames.shape)}")
        for i, (name, args) in enumerate(calls):
            kern, plain, _ = self.kernels[name]
            self.compare(f"{label} call {i}", label, kern(*args),
                         plain(*args))
        with torch.no_grad():
            ref = wh.frontend(fparams, mel, backend="torch")
        self.compare("Whisper frontend frames vs backend=torch",
                     "Whisper frontend frames", frames, ref)
        rows, per = self.time_calls(calls)
        p = per["conv2d"]
        log(f"  {label}: {p['ms']:.3f} ms over 2 launches, "
            f"{p['flops'] / p['ms'] / 1e9:.1f} TFLOP/s; bound "
            f"{p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f} ms; library "
            f"{p['library_ms']:.3f} ms")
        rep["frontend"] = {"launches": counts, "calls": rows, "sums": p}
        del mel, ref, calls, fparams
        return frames, [self.kernel_entry("conv2d", label, 2, p)]

    def wh_serve_main(self, cfg, srv, prompts, frames, rep):
        """27a: the served path.  Counts 0 just before and read just after
        an encode, the prompt loop, one decode step and ``Server.generate``
        (``encode_launches``, ``lm_step_launches`` a step, as counted on
        the CPU): every launch ``"wgmma"`` but the LM head's ``"simt"``
        matmul a step.  Returns the encode's and a decode step's
        launches."""
        torch = self.torch
        enc, step = encode_launches(cfg), lm_step_launches(cfg)
        log(f"phase 27a: the served path on backend=kernels: an encode "
            f"({enc['matmul']} matmul, {enc['flash_attention']} attention "
            f"launches), the {WH_PROMPT}-token prompt loop and a decode step "
            f"({step['matmul']} and {step['flash_attention']} a step, the "
            f"head \"simt\"), then Server.generate ({WH_GEN} tokens)")
        launches = {}
        with torch.no_grad():
            self.reset_counts()
            enc_out = srv.encode(frames)
            torch.cuda.synchronize()
            launches["encode"] = self.check_lm_launches("encode", enc,
                                                        "wgmma")
            self.reset_counts()
            tok, caches, pos = srv.prefill(prompts, enc_out=enc_out)
            torch.cuda.synchronize()
            self.check_lm_launches(
                f"prompt loop ({WH_PROMPT} serve steps)",
                {k: v * WH_PROMPT for k, v in step.items()}, "wgmma",
                simt=WH_PROMPT)
            self.reset_counts()
            srv.serve_step(srv.params, caches, {"token": tok,
                                                "cache_pos": pos,
                                                "enc_out": enc_out})
            torch.cuda.synchronize()
            launches["decode step"] = self.check_lm_launches(
                f"decode step at position {pos}", step, "wgmma", simt=1)
        del caches, enc_out
        n = WH_PROMPT + WH_GEN - 1
        self.reset_counts()
        out = srv.generate(prompts, WH_GEN, frames=frames)
        torch.cuda.synchronize()
        self.check_lm_launches(
            f"generate (an encode and {n} serve steps)",
            {k: enc[k] + n * v for k, v in step.items()}, "wgmma", simt=n)
        if out.shape != (WH_BATCH, WH_GEN) or not (
                (out >= 0) & (out < cfg.vocab)).all():
            raise RuntimeError(f"generated tokens {out.shape} out of range")
        log(f"  generated {out.shape} token ids; first clip's first 8: "
            f"{out[0, :8].tolist()}")
        rep["launches"] = launches
        rep["generated"] = out.tolist()
        return launches

    def wh_forced_run(self, frames, cfg, params, prompts, steps, backend,
                      feed=None):
        """Logits of an encode of ``frames``, the prompt's token loop and
        ``steps`` decode steps on ``backend``; after the prompt, step i is
        fed ``feed[i]``, by default its own greedy token.  Returns
        (logits, fed tokens)."""
        torch = self.torch
        from repro_torch.models import encdec

        x = torch.as_tensor(prompts, dtype=torch.int32, device=self.dev)
        n = x.shape[1]
        logits, fed = [], []
        with torch.no_grad():
            enc = encdec.encode(params, frames, cfg, backend)
            caches = encdec.init_caches(cfg, x.shape[0], n + steps,
                                        self.dev)
            tok = x[:, :1]
            for i in range(n + steps):
                out, caches = encdec.decode_step(params, tok, enc, caches, i,
                                                 cfg, backend)
                logits.append(out)
                tok = (x[:, i + 1:i + 2] if i + 1 < n else
                       feed[i] if feed is not None else
                       out[:, -1].argmax(-1, keepdim=True).to(torch.int32))
                fed.append(tok)
        return logits, fed

    def wh_serve_logits(self, cfg, params, prompts, frames, rep):
        """27b: the encoder output, then the logits of the prompt loop and
        WH_FORCED teacher-forced decode steps, backend=kernels against
        backend=torch: max |err| <= 5% of max |torch| (DESIGN.md §12)."""
        torch = self.torch
        from repro_torch.models import encdec

        with torch.no_grad():
            got, want = (encdec.encode(params, frames, cfg, b)
                         for b in ("kernels", "torch"))
        top = want.float().abs().max().item()
        bar = BF16_FWD_RTOL * top
        err = (got.float() - want.float()).abs().max().item()
        log(f"phase 27b: encoder output, kernels vs torch: max |err| "
            f"{err:.4f} = {err / bar:.3f} x the bar ({bar:.4f}); a zeroed "
            f"output would read {top / bar:.3g} x")
        rep["enc_out"] = {"max_abs_err": err, "bar": bar}
        if err > bar:
            raise RuntimeError(f"encoder output off the torch backend's: "
                               f"{err} > {bar}")
        del got, want
        names = ([f"prompt step {i}" for i in range(WH_PROMPT)]
                 + [f"decode step {i}" for i in range(1, WH_FORCED + 1)])
        self.lm_serve_logits(cfg, params, prompts, WH_FORCED, "27b", rep,
                             run=lambda *a, **kw: self.wh_forced_run(
                                 frames, *a, **kw), names=names)

    def wh_serve_times(self, cfg, servers, prompts, frames, groups, launches,
                       label, rep):
        """27b: per backend, encode ms (median of 5), decode ms a step (a
        WH_LOOP-step loop, median of 3) and tokens/s, ``Server.generate``'s
        wall and tokens/s (its encode and prompt loop included), the busy
        share of an encode and of a decode step (``torch.profiler``), peak
        memory; per kernel and shape, the device ms of one encode and one
        decode step beside bound and library (``serve_shapes``)."""
        torch = self.torch
        log(f"phase 27b: {label} times")
        times = rep["times"] = {}
        for backend, srv in servers.items():
            with torch.no_grad():
                encode_ms = self.wall_ms(lambda: srv.encode(frames), reps=5)
                enc = srv.encode(frames)
                tok, caches, pos = srv.prefill(prompts, enc_out=enc)

                def step(t=tok, p=pos):
                    return srv.serve_step(srv.params, caches,
                                          {"token": t, "cache_pos": p,
                                           "enc_out": enc})[0]

                def decode_loop():
                    t = tok
                    for i in range(WH_LOOP):
                        t = step(t, pos + i)

                step_ms = self.wall_ms(decode_loop, reps=3) / WH_LOOP
                prof = {"encode": self.profile_device(
                            lambda: srv.encode(frames), f"{backend} encode",
                            encode_ms),
                        "decode step": self.profile_device(
                            step, f"{backend} decode step", step_ms)}
            del caches, enc
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = srv.generate(prompts, WH_GEN, frames=frames)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            row = {"encode_ms": encode_ms, "decode_step_ms": step_ms,
                   "tokens_per_s": WH_BATCH * 1e3 / step_ms,
                   "generate_s": gen_s,
                   "generate_tokens_per_s": out.size / gen_s,
                   "peak_gib": peak}
            for what, p in prof.items():
                key = what.replace(" ", "_")
                row[f"{key}_busy"] = p.get("busy_share")
                row[f"{key}_device_ms"] = p.get("device_ms")
                row[f"{key}_profile"] = p
            times[backend] = row
            busy = {w: ("not measured" if row[f"{w}_busy"] is None
                        else f"{row[f'{w}_busy']:.1%}")
                    for w in ("encode", "decode_step")}
            log(f"  {backend}: encode {encode_ms:.3f} ms, decode "
                f"{step_ms:.3f} ms a step = {row['tokens_per_s']:.1f} "
                f"tokens/s; generate {WH_GEN} tokens x {WH_BATCH} in "
                f"{gen_s:.3f} s = {row['generate_tokens_per_s']:.1f} "
                f"tokens/s (encode and prompt included); busy: encode "
                f"{busy['encode']}, decode step {busy['decode_step']}; peak "
                f"memory {peak:.2f} GiB (weights included)")
        return self.serve_shapes(groups, launches, label, rep)

    def wh_train(self, cfg, params, rep):
        """27c: ``make_train_step`` at full width (decoder sequence
        WH_TRAIN_SEQ, global batch WH_TRAIN_BATCH in WH_TRAIN_MICRO
        microbatches, seeded fp32 frames): phase 26's a-d and f, with the
        head's 3 products a microbatch on ``"simt"``, every attention one
        query chunk of the backward's recompute, and the losses of the
        three steps within WH_LOSS_RTOL.  Returns its kernels-line
        entries."""
        torch = self.torch
        from repro_torch.data import LMDataPipeline

        label = (f"{cfg.name} ({cfg.encoder_layers} + {cfg.num_layers} "
                 f"layers) train step")
        micro = WH_TRAIN_MICRO
        log(f"phase 27c: train {cfg.name} through make_train_step: decoder "
            f"seq {WH_TRAIN_SEQ}, global batch {WH_TRAIN_BATCH} in {micro} "
            f"microbatches, seeded fp32 frames ({WH_TRAIN_BATCH}, "
            f"{cfg.encoder_ctx}, {cfg.d_model}), LMDataPipeline(seed={SEED})"
            f" tokens, fp32 AdamW, remat ({cfg.remat})")
        g = torch.Generator(self.dev).manual_seed(SEED + 30)
        pipe = LMDataPipeline(WH_TRAIN_BATCH, WH_TRAIN_SEQ, cfg.vocab,
                              seed=SEED)
        try:
            batches = []
            for i in range(TRAIN_LM_STEPS):
                b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.dev)
                     for k, v in pipe.batch_at(i).items()}
                b["frames"] = torch.randn(
                    (WH_TRAIN_BATCH, cfg.encoder_ctx, cfg.d_model),
                    generator=g, device=self.dev)
                batches.append(b)
        finally:
            pipe.close()
        launches = lm_train_launches(cfg, WH_TRAIN_SEQ, micro)
        # 1500 and 448 query rows are no multiple of Q_CHUNK: one chunk an
        # attention (encoder, decoder self and cross) a microbatch
        chunks = (cfg.encoder_layers + 2 * cfg.num_layers) * micro
        kw = dict(phase="27c", micro=micro)
        parts = self.lm_train_main(cfg, params, batches[0], launches, label,
                                   rep, chunks=chunks, simt=3 * micro, **kw)
        groups, samples = self.lm_train_calls(cfg, params, batches[0],
                                              launches, label, rep, **kw)
        variant = self.wh_variant(cfg)
        wrong = [(w, n, geo) for (w, n, geo), (args, _) in groups.items()
                 if self.lm_call(n, args)[6] != variant(n, args)]
        if wrong:
            raise RuntimeError(f"{label}: calls off their variant: {wrong}")
        self.lm_train_grads(cfg, params, batches[0], rep, **kw)
        self.lm_train_steps(cfg, params, batches, rep, rtol=WH_LOSS_RTOL,
                            **kw)
        entries = self.lm_train_times(cfg, params, batches, groups, samples,
                                      parts, label, rep, **kw)
        del batches, groups, samples
        return entries

    def wh_fp32(self, prompts, frames, rep):
        """27e: whisper-small in fp32, depth cut to 1 + 1 layers: an encode
        and each serve step on the ``"simt"`` variants, and the encoder
        output and the logits of the prompt loop and WH_FP32_DECODE decode
        steps against backend=torch (TF32 off) at 1e-4 x max(1,
        max|torch|)."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import encdec

        full = get_config(WH_ARCH)
        cfg = full.replace(dtype="float32", num_layers=WH_FP32_LAYERS,
                           encoder_layers=WH_FP32_LAYERS)
        log(f"phase 27e: {cfg.name} in fp32, depth cut to "
            f"{cfg.encoder_layers} + {cfg.num_layers} of "
            f"{full.encoder_layers} + {full.num_layers} layers: launches, "
            f"\"simt\", encoder output and logits vs backend=torch (tol "
            f"{TOL} x max(1, max|torch|))")
        params = self.lm_params(cfg, SEED + 31, rep)
        with torch.no_grad():
            self.reset_counts()
            enc = encdec.encode(params, frames, cfg)
            torch.cuda.synchronize()
            self.check_lm_launches("fp32 encode", encode_launches(cfg),
                                   "simt")
            caches = encdec.init_caches(cfg, WH_BATCH, 2, self.dev)
            x = torch.as_tensor(prompts[:, :1], device=self.dev)
            self.reset_counts()
            encdec.decode_step(params, x, enc, caches, 0, cfg)
            torch.cuda.synchronize()
            self.check_lm_launches("fp32 decode step",
                                   lm_step_launches(cfg), "simt")
            ref = encdec.encode(params, frames, cfg, "torch")
        rows = [self.compare("fp32 encoder output vs backend=torch",
                             "fp32 whisper logits", enc, ref)]
        del enc, ref, caches
        want, fed = self.wh_forced_run(frames, cfg, params, prompts,
                                       WH_FP32_DECODE, "torch")
        got, _ = self.wh_forced_run(frames, cfg, params, prompts,
                                    WH_FP32_DECODE, "kernels", feed=fed)
        caught = []
        for i, (g, w) in enumerate(zip(got, want)):
            what = (f"prompt step {i}" if i < WH_PROMPT
                    else f"decode step {i - WH_PROMPT + 1}")
            rows.append(self.compare(f"fp32 {what} logits vs backend=torch",
                                     "fp32 whisper logits", g, w))
            caught.append(self.sensitivity(g, w, 1.0, TOL))
        zero, off = (min(c[j] for c in caught) for j in (0, 1))
        log(f"  a zeroed output would reach >= {zero:.3g} x the bar, one "
            f"2% off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("fp32 whisper logits: a weak bar")
        rep["fp32"] = {"checks": rows, "zeroed_over_bar": zero,
                       "off2_over_bar": off}
        del got, want, params

    # -------------------------------------------------------------- phase 28
    def run_gemma(self):
        """Phase 28: Gemma-3-12B's sliding-window attention on the card
        (module docstring, 28a-e).  Returns its entries of the kernels
        line."""
        torch = self.torch
        from repro_torch.configs import get_config

        full = get_config(GM_ARCH)
        cfg = full.replace(num_layers=GM_LAYERS)
        log(f"phase 28: {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads on {cfg.kv_heads} KV heads "
            f"x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} tied, "
            f"window {cfg.window}, pattern {'/'.join(cfg.block_pattern)}, "
            f"qk-norm, {cfg.dtype}), served at {cfg.num_layers} of its "
            f"{full.num_layers} layers")
        rep = self.report["gemma"] = {}
        self.gm_band(rep)
        params = self.lm_params(cfg, SEED + 32, rep)
        entries = self.gm_serve(cfg, params, rep)
        del params
        torch.cuda.empty_cache()
        period = cfg.replace(num_layers=len(cfg.block_pattern))
        params = self.lm_params(period, SEED + 33, rep)
        self.gm_ring(period, params, rep)
        entries += self.gm_train(period, params, rep)
        del params
        torch.cuda.empty_cache()
        return entries

    def gm_band(self, rep):
        """28a: kernel 4 with a window against its plain version at phase
        10's bf16 bar, each ``GM_BANDS`` case on the variant its head dim
        takes, one windowed launch counted for each band, with what a
        zeroed output and one 2% off would read; then each 4096-row case
        timed (kernel, plain, SDPA with the same mask) beside its bound."""
        torch = self.torch
        kfa = self.kfa
        log("phase 28a: kernel 4's band vs its plain version (bf16; each "
            "element 2^-7 |plain| + 1e-4 x max(1, max|plain|))")
        g = torch.Generator().manual_seed(SEED + 28)
        caught, rows = [], []
        for qs, window in GM_BANDS:
            q, k, v = (torch.randn(qs, generator=g).to(self.dev,
                                                        torch.bfloat16)
                       for _ in range(3))
            kern, plain, lib, flops, nbytes, geo, variant = self.lm_call(
                "flash_attention", (q, k, v, True, window))
            want_v = "wgmma" if qs[3] in kfa.WGMMA_HEAD_DIMS else "simt"
            banded = self.counters["flash_attention"].launches_windowed
            out = kern()
            torch.cuda.synchronize()
            banded = self.counters["flash_attention"].launches_windowed - banded
            if variant != want_v or banded != int(window > 0):
                raise RuntimeError(f"attention {geo}: variant {variant}, "
                                   f"{banded} windowed launches")
            want = plain()
            self.compare(f"attention {geo} [{variant}]",
                         "flash_attention (band)", out, want)
            caught.append(self.sensitivity(out, want, 1.0, TOL))
            del out, want
            if qs[2] != GM_SEQ:
                continue
            r = {"geometry": geo, "variant": variant, "window": window,
                 "dh": qs[3],
                 "flops": flops, "bytes": nbytes,
                 "ms": self.device_ms(kern),
                 "plain_ms": self.device_ms(plain, reps=3),
                 "library_ms": self.device_ms(lib),
                 "ops_ms": 1e3 * flops / PEAK_BF16_FLOPS,
                 "bytes_ms": 1e3 * nbytes / PEAK_BYTES_S}
            r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
            rows.append(r)
            log(f"    {r['ms']:.3f} ms, {flops / r['ms'] / 1e9:.1f} TFLOP/s, "
                f"bound {r['bound_ms']:.3f} ms; SDPA with the same mask "
                f"{r['library_ms']:.3f} ms; plain {r['plain_ms']:.3f} ms")
        zero, off = (min(c[j] for c in caught) for j in range(2))
        log(f"  a zeroed output would reach >= {zero:.3g} x its bar, one 2% "
            f"off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("28a: a bar would miss a zeroed or a 2%-off "
                               "kernel output")
        for dh in sorted({r["dh"] for r in rows}):
            same = [r for r in rows if r["dh"] == dh]
            causal = next(r for r in same if not r["window"])
            for r in same:
                if r["window"]:
                    log(f"  dh {dh} [{r['variant']}] window "
                        f"{r['window']} / causal: kernel "
                        f"{r['ms'] / causal['ms']:.3f}, work "
                        f"{r['flops'] / causal['flops']:.3f}, SDPA "
                        f"{r['library_ms'] / causal['library_ms']:.3f}")
        rep["band"] = {"timed": rows, "zeroed_over_bar": zero,
                       "off2_over_bar": off}

    def gm_calls(self, runs, label, rep, phase="28b", expect=None,
                 once=()):
        """Every kernel-3 and kernel-4 call of each of ``runs`` ({what:
        fn}) held against its plain version as it is made, at phase 10's
        bf16 bar, each on the variant ``expect(name, args)`` names (by
        default each matmul on ``"wgmma"`` and each attention, Gemma's dh
        256, on ``"simt"``), with what a zeroed output and one 2% off would
        read; in a run named in ``once``, only the first call of each
        geometry is held (the rest are counted).  Kernel 3's batched form is recorded as ``"matmul_batched"``.
        No call's output is kept (a 48-layer prefill's would fill the
        card).  Returns one call's arguments and the call count per (what,
        kernel, geometry), as :meth:`lm_serve_calls`."""
        torch = self.torch
        kmm, kfa = self.kmm, self.kfa
        if expect is None:
            def expect(name, args):
                return "simt" if name == "flash_attention" else "wgmma"
        log(f"phase {phase}: {label}: every kernel call of "
            + " and ".join(f"one {what}" for what in runs)
            + " vs its plain version, checked as it is made")
        orig = (kmm.matmul_cuda, kmm.matmul_batched_cuda,
                kfa.flash_attention_cuda)
        groups, caught, held = {}, [], set()
        state = {"what": None, "n": 0, "zero": 0}

        def checked(name, fn):
            def wrapper(*args):
                out = fn(*args)
                kern_v = self.lm_call(name, args)
                key = (state["what"], name, kern_v[5])
                groups.setdefault(key, [args, 0])[1] += 1
                if state["what"] in once and key in held:
                    return out
                entry = f"{name} ({label}: {state['what']})"
                want_v = expect(name, args)
                if kern_v[6] != want_v:
                    raise RuntimeError(f"{entry} call {state['n']}: "
                                       f"{kern_v[6]}, not {want_v}")
                want = kern_v[1]()
                self.compare(f"{entry} call {state['n']}", entry, out, want,
                             quiet=True)
                if bool(want.any()):
                    caught.append(self.sensitivity(out, want, 1.0, TOL))
                    held.add(key)
                else:   # e.g. a recurrent product of the zero first state
                    state["zero"] += 1
                del want
                state["n"] += 1
                return out
            return wrapper

        kmm.matmul_cuda = checked("matmul", orig[0])
        kmm.matmul_batched_cuda = checked("matmul_batched", orig[1])
        kfa.flash_attention_cuda = checked("flash_attention", orig[2])
        try:
            with torch.no_grad():
                for what, fn in runs.items():
                    state["what"], state["n"] = what, 0
                    checks = len(self.report["checks"])
                    fn()
                    torch.cuda.synchronize()
                    worst = max(c["err_over_bar"]
                                for c in self.report["checks"][checks:])
                    made = sum(n for (w, _, _), (_, n) in groups.items()
                               if w == what)
                    log(f"  {what}: {state['n']} calls ok"
                        + (f" (the first of each geometry; {made} made)"
                           if what in once else "")
                        + f", worst error {worst:.3f} x its bar")
        finally:
            (kmm.matmul_cuda, kmm.matmul_batched_cuda,
             kfa.flash_attention_cuda) = orig
        zero, off = (min(c[j] for c in caught) for j in range(2))
        log(f"  a zeroed output would reach >= {zero:.3g} x its bar, one 2% "
            f"off >= {off:.3g} x"
            + (f"; {state['zero']} calls whose plain output is all zeros "
               f"held at the bar, out of that gate" if state["zero"] else ""))
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError(f"{label}: a bar would miss a zeroed or a "
                               f"2%-off kernel output")
        rep.setdefault("calls", {})[label] = {
            "checked": len(caught), "zeroed_over_bar": zero,
            "off2_over_bar": off, "all_zero": state["zero"]}
        return groups

    def gm_serve(self, cfg, params, rep):
        """28b: the main path, counts 0 just before and read just after a
        ``make_prefill_step`` over 1 x GM_SEQ tokens (each layer's 7
        matmuls and 1 attention and the head: every matmul ``"wgmma"``,
        every attention ``"simt"``, the local layers' with the window),
        the prompt loop, a decode step and ``Server.generate`` (no window:
        the rings hold only the band); the prefill's logits against the
        torch backend's; every kernel call of the prefill and of a decode
        step against its plain version; 8 teacher-forced steps against the
        torch backend; times.  Returns the kernels line's entries."""
        torch = self.torch
        from repro_torch.launch import serve, steps

        label = f"{GM_NAME} ({cfg.num_layers} layers) served"
        step = lm_step_launches(cfg)
        banded = windowed_launches(cfg)
        log(f"phase 28b: {label}: make_prefill_step over 1 x {GM_SEQ} tokens "
            f"({step['matmul']} matmul and {step['flash_attention']} "
            f"attention launches, {banded} with the window; matmuls "
            f"\"wgmma\", attention \"simt\" at dh {cfg.head_dim}), then "
            f"Server.generate: batch {GM_BATCH}, a {GM_PROMPT}-token prompt "
            f"through the token loop, {GM_GEN} tokens")
        x = torch.as_tensor(np.random.default_rng(SEED + 28).integers(
            0, cfg.vocab, (1, GM_SEQ), dtype=np.int32), device=self.dev)
        prompts = np.random.default_rng(SEED + 29).integers(
            0, cfg.vocab, (GM_BATCH, GM_PROMPT), dtype=np.int32)
        prefill = {b: steps.make_prefill_step(cfg, b)
                   for b in ("kernels", "torch")}
        servers = {b: serve.Server(cfg, max_len=GM_PROMPT + GM_GEN,
                                   backend=b, params=params)
                   for b in ("kernels", "torch")}
        srv = servers["kernels"]
        launches = {}
        with torch.no_grad():
            self.reset_counts()
            logits = prefill["kernels"](params, {"tokens": x})
            torch.cuda.synchronize()
            launches["prefill"] = self.check_lm_launches(
                f"prefill (1 x {GM_SEQ})", step, "wgmma",
                attn_variant="simt", windowed=banded)
            ref = prefill["torch"](params, {"tokens": x})
        rep["prefill_logits"] = self.logits_reading(
            f"prefill logits (1 x {GM_SEQ} x {cfg.vocab}), kernels vs torch",
            logits[0], ref[0])
        del logits, ref
        torch.cuda.empty_cache()
        with torch.no_grad():
            self.reset_counts()
            tok, caches, pos = srv.prefill(prompts)
            torch.cuda.synchronize()
            self.check_lm_launches(
                f"prompt loop ({GM_PROMPT} serve steps)",
                {k: v * GM_PROMPT for k, v in step.items()}, "wgmma",
                attn_variant="simt")
            self.reset_counts()
            srv.serve_step(srv.params, caches, {"token": tok,
                                                "cache_pos": pos})
            torch.cuda.synchronize()
            launches["decode step"] = self.check_lm_launches(
                f"decode step at position {pos}", step, "wgmma",
                attn_variant="simt")
        n = GM_PROMPT + GM_GEN - 1
        self.reset_counts()
        out = srv.generate(prompts, GM_GEN)
        torch.cuda.synchronize()
        self.check_lm_launches(f"generate ({n} serve steps)",
                               {k: v * n for k, v in step.items()}, "wgmma",
                               attn_variant="simt")
        if out.shape != (GM_BATCH, GM_GEN) or not (
                (out >= 0) & (out < cfg.vocab)).all():
            raise RuntimeError(f"generated tokens {out.shape} out of range")
        log(f"  generated {out.shape} token ids; first request's first 8: "
            f"{out[0, :8].tolist()}")
        rep["launches"] = launches
        rep["generated"] = out.tolist()
        groups = self.gm_calls(
            {"prefill": lambda: prefill["kernels"](params, {"tokens": x}),
             "decode step": lambda: srv.serve_step(
                 srv.params, caches, {"token": tok, "cache_pos": pos})},
            label, rep)
        del caches
        self.lm_serve_logits(cfg, params, prompts, GM_FORCED, "28b", rep)
        return self.gm_serve_times(cfg, params, servers, prefill, x, prompts,
                                   groups, launches, label, rep)

    def gm_serve_times(self, cfg, params, servers, prefill, x, prompts,
                       groups, launches, label, rep, gen=GM_GEN,
                       phase="28b"):
        """28b: per backend, the prefill's wall ms (``make_prefill_step``
        over ``x``, median of 3), decode ms a step (a loop of ``gen`` - 1
        steps after the prompt's prefill, median of 3) and tokens/s, the
        busy share of each (``torch.profiler``), peak memory over
        ``Server.generate``; per kernel and shape, the device ms of one
        prefill and one decode step beside bound and library
        (``serve_shapes``: kernel 4's windowed and causal launches beside
        SDPA with the same mask)."""
        torch = self.torch
        log(f"phase {phase}: {label} times")
        times = rep["times"] = {}
        seq, batch = x.shape[1], prompts.shape[0]
        for backend, srv in servers.items():
            with torch.no_grad():
                prefill_ms = self.wall_ms(
                    lambda: prefill[backend](params, {"tokens": x}), reps=3)
                tok, caches, pos = srv.prefill(prompts)

                def step(t=tok, p=pos):
                    return srv.serve_step(srv.params, caches,
                                          {"token": t, "cache_pos": p})[0]

                def decode_loop():
                    t = tok
                    for i in range(gen - 1):
                        t = step(t, pos + i)

                step_ms = self.wall_ms(decode_loop, reps=3) / (gen - 1)
                prof = {"prefill": self.profile_device(
                            lambda: prefill[backend](params, {"tokens": x}),
                            f"{backend} prefill", prefill_ms),
                        "decode step": self.profile_device(
                            step, f"{backend} decode step", step_ms)}
            del caches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            srv.generate(prompts, gen)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            row = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
                   "prefill_tokens_per_s": seq * 1e3 / prefill_ms,
                   "tokens_per_s": batch * 1e3 / step_ms,
                   "peak_gib": peak}
            for what, p in prof.items():
                key = what.replace(" ", "_")
                row[f"{key}_busy"] = p.get("busy_share")
                row[f"{key}_device_ms"] = p.get("device_ms")
                row[f"{key}_profile"] = p
            times[backend] = row
            busy = {w: ("not measured" if row[f"{w}_busy"] is None
                        else f"{row[f'{w}_busy']:.1%}")
                    for w in ("prefill", "decode_step")}
            log(f"  {backend}: prefill {prefill_ms:.3f} ms "
                f"({row['prefill_tokens_per_s']:.1f} tokens/s), decode "
                f"{step_ms:.3f} ms a step = {row['tokens_per_s']:.1f} "
                f"tokens/s at batch {batch}; busy: prefill "
                f"{busy['prefill']}, decode step {busy['decode_step']}; "
                f"peak memory {peak:.2f} GiB (weights included)")
        return self.serve_shapes(groups, launches, label, rep)

    def gm_ring(self, cfg, params, rep):
        """28c: the rings past their wrap at one pattern period: the prompt
        through ``Server``'s token loop (counts 0 just before, read just
        after: every launch on its variant, none windowed), then
        GM_RING_FORCED teacher-forced decode steps, each one's logits
        against the torch backend's cache-free forward of the same tokens
        (SDPA with the band) at 28b's bar."""
        torch = self.torch
        from repro_torch.launch import serve, steps
        from repro_torch.models import transformer

        n = GM_RING_PROMPT + GM_RING_FORCED
        size = min(n, cfg.window)
        log(f"phase 28c: the rings past their wrap at one pattern period "
            f"({cfg.num_layers} layers, full widths): batch "
            f"{GM_RING_BATCH}, a {GM_RING_PROMPT}-token prompt through the "
            f"token loop, then {GM_RING_FORCED} teacher-forced steps "
            f"(positions up to {n - 1}: rings of {size} slots, wrapped by "
            f"{n - size}); decode logits vs backend=torch's cache-free "
            f"forward (SDPA with the band)")
        drawn = np.random.default_rng(SEED + 30).integers(
            0, cfg.vocab, (GM_RING_BATCH, n), dtype=np.int32)
        toks = torch.as_tensor(drawn, device=self.dev)
        srv = serve.Server(cfg, max_len=n, params=params)
        step = lm_step_launches(cfg)
        self.reset_counts()
        t0 = time.perf_counter()
        _, caches, pos = srv.prefill(drawn[:, :GM_RING_PROMPT])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        self.check_lm_launches(
            f"prompt loop ({GM_RING_PROMPT} serve steps, {secs:.1f} s)",
            {k: v * GM_RING_PROMPT for k, v in step.items()}, "wgmma",
            attn_variant="simt")
        rings = {tuple(c["k"].shape) for c, kind in zip(
            caches, cfg.block_pattern) if kind == "attn_local"}
        if rings != {(cfg.repeat, GM_RING_BATCH, size, cfg.kv_heads,
                      cfg.head_dim)}:
            raise RuntimeError(f"ring caches {rings}, not of {size} slots")
        got = []
        with torch.no_grad():
            for p in range(pos, n):
                lg, caches = transformer.decode_step(
                    params, toks[:, p:p + 1], caches, p, cfg)
                got.append(lg[:, 0])
            want = steps.make_prefill_step(cfg, "torch")(params,
                                                         {"tokens": toks})
        rows = [self.logits_reading(f"position {p} (slot {p % size})", g,
                               want[:, p])
                for p, g in zip(range(pos, n), got)]
        rep["ring"] = {"prompt_loop_s": secs, "positions": rows}
        del got, want, caches, srv

    def gm_train(self, cfg, params, rep):
        """28d: training at one pattern period (module docstring).
        Returns the kernels line's entries."""
        torch = self.torch
        from repro_torch.data import LMDataPipeline
        from repro_torch.models import transformer

        label = f"{GM_NAME} ({cfg.num_layers} layers) train step"
        micro = GM_TRAIN_MICRO
        n_par = sum(t.numel() for t in
                    transformer.flatten_params(params).values())
        embed = params["embed"].numel()
        # the full step's peak as reckoned before any run: bf16 parameters
        # (2 N bytes), fp32 masters and moments (12 N), the fp32 gradient
        # accumulator (4 N), the functional AdamW's new state (12 N) and
        # parameters (2 N) live at once, and its fp32 temporaries over the
        # largest leaf, the embedding (the gradient, both moments and their
        # bias-corrected copies: 5 x 4 bytes an entry)
        reckon = 32 * n_par + 20 * embed
        total = torch.cuda.get_device_properties(self.dev).total_memory
        fits = reckon < total
        log(f"phase 28d: train {cfg.name} through make_train_step at "
            f"{cfg.num_layers} layers (one pattern period, full widths): "
            f"seq {GM_SEQ}, global batch {GM_TRAIN_BATCH} in {micro} "
            f"microbatches, fp32 AdamW, remat ({cfg.remat}); {n_par:,} "
            f"parameters: a full step's reckoned peak {reckon / 2 ** 30:.1f} "
            f"GiB (32 bytes a parameter, the update's temporaries over the "
            f"{embed:,}-entry embedding 20 bytes an entry) against the "
            f"card's {total / 2 ** 30:.1f} GiB: "
            + ("the step is run" if fits else "the step's loss and "
               "gradients are run and held, its AdamW update is not (the "
               "functional update's second state)"))
        rep["reckoned_peak_gib"] = reckon / 2 ** 30
        rep["full_step_run"] = fits
        pipe = LMDataPipeline(GM_TRAIN_BATCH, GM_SEQ, cfg.vocab, seed=SEED)
        try:
            batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.dev) for k, v in pipe.batch_at(i).items()}
                for i in range(TRAIN_LM_STEPS)]
        finally:
            pipe.close()
        launches = lm_train_launches(cfg, GM_SEQ, micro)
        banded = windowed_launches(cfg) * micro * (2 if cfg.remat else 1)
        kw = dict(phase="28d", micro=micro)
        parts = self.lm_train_main(
            cfg, params, batches[0], launches, label, rep,
            chunks=GM_SEQ // self.kfa.Q_CHUNK * cfg.num_layers * micro,
            attn_variant="simt", windowed=banded, grads_only=not fits, **kw)
        groups, samples = self.lm_train_calls(cfg, params, batches[0],
                                              launches, label, rep, **kw)
        wrong = [(w, n, geo) for (w, n, geo), (args, _) in groups.items()
                 if self.lm_call(n, args)[6] != (
                     "wgmma" if n == "matmul" else "simt")]
        if wrong:
            raise RuntimeError(f"{label}: calls off their variant: {wrong}")
        self.lm_train_grads(cfg, params, batches[0], rep, **kw)
        if fits:
            self.lm_train_steps(cfg, params, batches, rep, **kw)
        else:
            self.gm_attention_fn(cfg, rep)
        torch.cuda.empty_cache()
        entries = self.lm_train_times(cfg, params, batches, groups, samples,
                                      parts, label, rep,
                                      timed=GM_TRAIN_TIMED,
                                      grads_only=not fits, **kw)
        del batches, groups, samples
        return entries

    def gm_attention_fn(self, cfg, rep):
        """28d, in the full step's place: ``FlashAttentionFn`` (kernel 4's
        band forward, ``attention_grads`` backward) at Gemma's attention
        shape (batch 1, GM_SEQ, window) against SDPA's autograd with the
        same band: the output within 5% of max|SDPA|, each gradient at 10%
        relative L2; both timed forward and backward."""
        torch = self.torch
        kfa = self.kfa
        F = torch.nn.functional
        shape = (1, cfg.num_heads, GM_SEQ, cfg.head_dim)
        log(f"phase 28d: FlashAttentionFn at {shape}, window {cfg.window}, "
            f"forward and backward, vs SDPA's autograd with the band")
        g = torch.Generator(self.dev).manual_seed(SEED + 34)
        q, k, v, cot = (torch.randn(shape, generator=g, device=self.dev).to(
            torch.bfloat16) for _ in range(4))
        r = torch.arange(GM_SEQ, device=self.dev)[:, None]
        c = torch.arange(GM_SEQ, device=self.dev)[None, :]
        band = (c <= r) & (c > r - cfg.window)

        def run(fn):
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fn(*ins)
            return (out.detach(), *torch.autograd.grad(out, ins, cot))

        def ours():
            return run(lambda a, b, d: kfa.FlashAttentionFn.apply(
                a, b, d, True, cfg.window))

        def lib():
            return run(lambda a, b, d: F.scaled_dot_product_attention(
                a, b, d, attn_mask=band))

        got, want = ours(), lib()
        top = want[0].float().abs().max().item()
        err = (got[0].float() - want[0].float()).abs().max().item()
        rel = [((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()
               for a, b in zip(got[1:], want[1:])]
        row = {"out_err_over_bar": err / (BF16_FWD_RTOL * top),
               "grad_rel_l2": rel, "ms": self.device_ms(ours, reps=3),
               "library_ms": self.device_ms(lib, reps=3)}
        log(f"  output {row['out_err_over_bar']:.3f} x its bar; dq, dk, dv "
            f"relative L2 {[f'{x:.3e}' for x in rel]} (bar "
            f"{BF16_GRAD_RTOL:.0%}); forward and backward {row['ms']:.3f} "
            f"ms, SDPA's {row['library_ms']:.3f} ms")
        rep["attention_fn"] = row
        if row["out_err_over_bar"] > 1.0 or max(rel) > BF16_GRAD_RTOL:
            raise RuntimeError(f"FlashAttentionFn vs SDPA: {row}")
        del got, want

    # -------------------------------------------------------------- phase 29
    def run_moe(self):
        """Phase 29: the MoE FFN on the card (module docstring, 29a-d).
        Returns its entries of the kernels line."""
        torch = self.torch
        from repro_torch.configs import get_config

        rep = self.report["moe"] = {}
        self.moe_batched(rep)
        full = get_config(MOE_ARCH)
        cfg = full.replace(num_layers=MOE_LAYERS)
        m = cfg.moe
        log(f"phase 29b: {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads on {cfg.kv_heads} KV heads "
            f"x {cfg.head_dim}, {m.num_experts} experts top-{m.top_k} of "
            f"{m.d_ff_expert}, vocab {cfg.vocab}, {cfg.dtype}), depth cut "
            f"from {full.num_layers} to {cfg.num_layers} layers")
        params = self.lm_params(cfg, SEED + 40, rep)
        entries = self.moe_serve(cfg, params,
                                 f"{MOE_NAME} ({cfg.num_layers} layers)",
                                 "29b", rep.setdefault(MOE_NAME, {}),
                                 batch=MOE_BATCH, prompt=MOE_PROMPT)
        del params
        torch.cuda.empty_cache()
        full = get_config(SCOUT_ARCH)
        cfg = full.replace(num_layers=SCOUT_LAYERS)
        m = cfg.moe
        log(f"phase 29c: {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads on {cfg.kv_heads} KV heads "
            f"x {cfg.head_dim}, {m.num_experts} experts top-{m.top_k} of "
            f"{m.d_ff_expert} and a shared expert of {m.shared_expert_ff}, "
            f"vocab {cfg.vocab}, {cfg.dtype}), depth cut from "
            f"{full.num_layers} to {cfg.num_layers} layers")
        params = self.lm_params(cfg, SEED + 41, rep)
        entries += self.moe_serve(
            cfg, params, f"{SCOUT_NAME} ({cfg.num_layers} layers)", "29c",
            rep.setdefault(SCOUT_NAME, {}), batch=1, prompt=MOE_SEQ)
        del params
        torch.cuda.empty_cache()
        return entries

    def moe_batched(self, rep):
        """29a: kernel 3's batched form against its plain version at each
        ``MOE_BATCHED`` shape in bf16 (``"wgmma"``) and fp32 (``"simt"``),
        and ``MOE_UNALIGNED`` in bf16 (``"simt"``: K = 36), one batched
        launch counted for each; a zeroed output and one 2% off shown to
        fail the bar; each timed beside its bound and ``torch.bmm``."""
        torch = self.torch
        counter = self.counters["matmul"]
        log("phase 29a: kernel 3's batched form vs its plain version (fp32: "
            f"{TOL} x max(1, max|plain|); bf16, each element 2^-7 |plain| + "
            f"{TOL} x max(1, max|plain|)), timed beside its bound and "
            f"torch.bmm")
        # drawn on the card: the CPU's draws of these operands took ~20 s
        g = torch.Generator(self.dev).manual_seed(SEED + 29)
        cases = [(s, dt) for s in MOE_BATCHED
                 for dt in (torch.bfloat16, torch.float32)]
        cases.append((MOE_UNALIGNED, torch.bfloat16))
        caught, rows = [], []
        for (e, m, k, n), dt in cases:
            a = torch.randn((e, m, k), generator=g, device=self.dev).to(dt)
            b = (torch.randn((e, k, n), generator=g, device=self.dev)
                 * k ** -0.5).to(dt)
            kern, plain, lib, flops, nbytes, geo, variant = self.lm_call(
                "matmul_batched", (a, b))
            want_v = ("wgmma" if dt == torch.bfloat16 and k % 8 == 0
                      and n % 8 == 0 else "simt")
            before = counter.launches_batched
            out = kern()
            torch.cuda.synchronize()
            if variant != want_v or counter.launches_batched != before + 1:
                raise RuntimeError(f"batched {geo} {dt}: variant {variant}, "
                                   f"{counter.launches_batched - before} "
                                   f"batched launches")
            want = plain()
            self.compare(f"batched {geo} {dt} [{variant}]", "matmul_batched",
                         out, want)
            caught.append(self.sensitivity(out, want, 1.0, TOL))
            del out, want
            peak = (PEAK_FP32_FLOPS if dt == torch.float32
                    else PEAK_BF16_FLOPS)
            r = {"geometry": geo, "dtype": str(dt), "variant": variant,
                 "flops": flops, "bytes": nbytes, "ms": self.device_ms(kern),
                 "plain_ms": self.device_ms(plain, reps=3),
                 "library_ms": self.device_ms(lib),
                 "ops_ms": 1e3 * flops / peak,
                 "bytes_ms": 1e3 * nbytes / PEAK_BYTES_S}
            r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
            rows.append(r)
            log(f"    {r['ms']:.4f} ms, {flops / r['ms'] / 1e9:.1f} TFLOP/s, "
                f"bound {r['bound_ms']:.4f} ms ("
                + ("ops" if r["ops_ms"] >= r["bytes_ms"] else "bytes")
                + f"), {r['ms'] / r['bound_ms']:.1f} x bound; torch.bmm "
                f"{r['library_ms']:.4f} ms; plain {r['plain_ms']:.3f} ms")
            del a, b
        zero, off = (min(c[j] for c in caught) for j in range(2))
        log(f"  a zeroed output would reach >= {zero:.3g} x its bar, one 2% "
            f"off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("29a: a bar would miss a zeroed or a 2%-off "
                               "kernel output")
        rep["batched"] = {"timed": rows, "zeroed_over_bar": zero,
                          "off2_over_bar": off}

    def check_moe_launches(self, what, cfg, times=1):
        """``check_lm_launches`` for ``times`` serve steps (or forwards) of
        a MoE config: every matmul ``"wgmma"`` but the fp32 routers'
        ``"simt"``, every attention ``"wgmma"``, and kernel 3's batched
        launches ``batched_launches`` apart.  Returns {kernel: launches},
        the batched ones as ``matmul_batched`` and not in ``matmul``."""
        step = {k: v * times for k, v in lm_step_launches(cfg).items()}
        routers = moe_layers(cfg) * times
        counts = self.check_lm_launches(what, step, "wgmma", simt=routers)
        batched = self.counters["matmul"].launches_batched
        log(f"  {what}: {batched} of the matmul launches batched, "
            f"{routers} routers on \"simt\"")
        if batched != batched_launches(cfg) * times:
            raise RuntimeError(f"{what}: {batched} batched launches, not "
                               f"{batched_launches(cfg) * times}")
        return {"matmul": counts["matmul"] - batched,
                "matmul_batched": batched,
                "flash_attention": counts["flash_attention"]}

    def moe_serve(self, cfg, params, name, phase, rep, *, batch, prompt):
        """29b-c: the main path, counts 0 just before and read just after a
        ``make_prefill_step`` over 1 x MOE_SEQ tokens, a ``Server``
        prefill of ``batch`` x ``prompt`` tokens in one call, a decode step
        and ``Server.generate`` (MOE_GEN tokens); the routes of both
        backends (``moe_routes``); the prefill's logits against the torch
        backend's; every kernel call of the prefill and of a decode step
        against its plain version; MOE_FORCED teacher-forced steps against
        the torch backend; times.  Returns the kernels line's entries."""
        torch = self.torch
        from repro_torch.launch import serve, steps

        label = f"{name} served"
        step = lm_step_launches(cfg)
        log(f"phase {phase}: {label}: make_prefill_step over 1 x {MOE_SEQ} "
            f"tokens ({step['matmul']} matmul launches, "
            f"{batched_launches(cfg)} of them batched and {moe_layers(cfg)} "
            f"routers, and {step['flash_attention']} attentions), then "
            f"Server: batch {batch}, a {prompt}-token prompt in one "
            f"parallel prefill, {MOE_GEN} tokens")
        x = torch.as_tensor(np.random.default_rng(SEED + 40).integers(
            0, cfg.vocab, (1, MOE_SEQ), dtype=np.int32), device=self.dev)
        prompts = np.random.default_rng(SEED + 41).integers(
            0, cfg.vocab, (batch, prompt), dtype=np.int32)
        prefill = {b: steps.make_prefill_step(cfg, b)
                   for b in ("kernels", "torch")}
        servers = {b: serve.Server(cfg, max_len=prompt + MOE_GEN,
                                   backend=b, params=params)
                   for b in ("kernels", "torch")}
        srv = servers["kernels"]
        launches, seen = {}, {"kernels": [], "torch": []}
        with torch.no_grad():
            self.reset_counts()
            with self.moe_recording(seen["kernels"]):
                logits = prefill["kernels"](params, {"tokens": x})
            torch.cuda.synchronize()
            launches["prefill"] = self.check_moe_launches(
                f"prefill (1 x {MOE_SEQ})", cfg)
            control = []
            with self.moe_recording(seen["torch"], control):
                ref = prefill["torch"](params, {"tokens": x})
            hit, rep["routes"] = self.route_agreement(
                f"{phase}: prefill routes", seen["kernels"], seen["torch"],
                MOE_SEQ, control)
            rep["prefill_logits_free"] = self.logits_reading(
                f"prefill logits, each backend on its own routes (read, not "
                f"gated)", logits[0], ref[0], hit, gate=False)
            del ref
            with self.moe_recording([], force=[r[0] for r in seen["kernels"]]):
                ref = prefill["torch"](params, {"tokens": x})
            rep["prefill_logits"] = self.logits_reading(
                f"prefill logits (1 x {MOE_SEQ} x {cfg.vocab}), kernels vs "
                f"torch on the kernels' routes", logits[0], ref[0])
            del logits, ref, seen, control
            torch.cuda.empty_cache()
            self.reset_counts()
            tok, caches, pos = srv.prefill(prompts)
            torch.cuda.synchronize()
            self.check_moe_launches(f"Server prefill ({batch} x {prompt})",
                                    cfg)
            self.reset_counts()
            srv.serve_step(srv.params, caches, {"token": tok,
                                                "cache_pos": pos})
            torch.cuda.synchronize()
            launches["decode step"] = self.check_moe_launches(
                f"decode step at position {pos}", cfg)
        self.reset_counts()
        out = srv.generate(prompts, MOE_GEN)
        torch.cuda.synchronize()
        self.check_moe_launches(f"generate ({MOE_GEN} serve steps)", cfg,
                                MOE_GEN)
        if out.shape != (batch, MOE_GEN) or not (
                (out >= 0) & (out < cfg.vocab)).all():
            raise RuntimeError(f"generated tokens {out.shape} out of range")
        log(f"  generated {out.shape} token ids; first request's first 8: "
            f"{out[0, :8].tolist()}")
        rep["launches"] = launches
        rep["generated"] = out.tolist()

        def expect(kind, args):
            if kind == "matmul" and args[0].dtype == torch.float32:
                return "simt"          # the fp32 router
            return "wgmma"

        groups = self.gm_calls(
            {"prefill": lambda: prefill["kernels"](params, {"tokens": x}),
             "decode step": lambda: srv.serve_step(
                 srv.params, caches, {"token": tok, "cache_pos": pos})},
            label, rep, phase=phase, expect=expect)
        del caches
        self.moe_forced(cfg, params, prompts, phase, rep)
        return self.gm_serve_times(cfg, params, servers, prefill, x, prompts,
                                   groups, launches, label, rep, gen=MOE_GEN,
                                   phase=phase)

    @contextlib.contextmanager
    def moe_recording(self, seen, control=None, force=None):
        """Record each ``moe.route`` call's (experts, kept mask) in
        ``seen``, one entry a MoE layer; with ``control``, also the routes
        of kernel 3's router (``"kernels"``) on the same router input,
        whatever backend the call took; with ``force`` (a list of experts,
        one entry a MoE layer in call order), each call takes its entry's
        experts (``route(experts=)``: a teacher-forced route)."""
        from repro_torch.models import moe

        orig = moe.route
        calls = iter(force or ())

        def rec(router, xt, c, backend="kernels"):
            out = orig(router, xt, c, backend,
                       experts=next(calls) if force else None)
            seen.append((out[0], out[3]))
            if control is not None:
                control.append(orig(router, xt, c, "kernels")[0])
            return out

        moe.route = rec
        try:
            yield
        finally:
            moe.route = orig

    def route_agreement(self, what, routes_k, routes_t, rows, control=()):
        """Routes of the kernels backend against the torch backend's, each
        layer's taken on that backend's own residual stream: the (token,
        layer, slot) routes whose expert differs, the kept masks that
        differ, and (``control``: the kernels router on the torch stream's
        router input) how many differ on the same input.  Returns (a mask
        of the call's ``rows`` tokens with any differing route or kept
        mask, the reading)."""
        torch = self.torch
        hit = torch.zeros(rows, dtype=torch.bool, device=self.dev)
        per_layer = []
        for i, ((ik, kk), (it, kt)) in enumerate(zip(routes_k, routes_t)):
            d = (ik != it) | (kk != kt)
            hit |= d.reshape(rows, -1).any(-1)
            per_layer.append((int((ik != it).sum()), int((kk != kt).sum()),
                              int((control[i] != it).sum()) if control
                              else None))
        if len(routes_k) != len(routes_t) or not routes_t:
            raise RuntimeError(f"{what}: {len(routes_k)} and "
                               f"{len(routes_t)} MoE layers recorded")
        total = routes_t[0][0].numel() * len(per_layer)
        swapped = sum(r[0] for r in per_layer)
        first = next((i for i, r in enumerate(per_layer) if r[0]), None)
        row = {"routes": total, "swapped": swapped,
               "swapped_share": swapped / total,
               "kept_differ": sum(r[1] for r in per_layer),
               "tokens_hit": int(hit.sum()), "tokens": rows,
               "first_layer": first, "per_layer": per_layer}
        same = (f"; on the same router input {sum(r[2] for r in per_layer)} "
                f"differ" if control else "")
        log(f"  {what}: {swapped} of {total} (token, layer, slot) routes "
            f"differ between the backends ({swapped / total:.3%}; the first "
            f"in MoE layer {first}), {row['kept_differ']} kept masks differ, "
            f"{row['tokens_hit']} of {rows} tokens hit{same}")
        return hit, row

    def moe_forced(self, cfg, params, prompts, phase, rep):
        """The kernels backend's logits against the torch backend's through
        a cached prefill of ``prompts`` and MOE_FORCED teacher-forced steps
        (``forced_run``: the torch run's greedy tokens fed to both).  The
        routes of the two runs are compared (``route_agreement``); then the
        torch backend runs again on the kernels run's routes, and each
        step's logits are held to that run's at ``logits_reading``'s bar."""
        log(f"phase {phase}: {cfg.name} logits, backend=kernels vs "
            f"backend=torch, teacher-forced through the prefill and "
            f"{MOE_FORCED} decode steps (bar {BF16_FWD_RTOL:.0%} of "
            f"max|torch|), on the kernels run's routes")
        seen = {"kernels": [], "torch": []}
        with self.moe_recording(seen["torch"]):
            want, fed = self.forced_run(cfg, params, prompts, MOE_FORCED,
                                        "torch")
        with self.moe_recording(seen["kernels"]):
            got, _ = self.forced_run(cfg, params, prompts, MOE_FORCED,
                                     "kernels", feed=fed)
        del want
        with self.moe_recording([], force=[r[0] for r in seen["kernels"]]):
            want, _ = self.forced_run(cfg, params, prompts, MOE_FORCED,
                                      "torch", feed=fed)
        n, rows = moe_layers(cfg), []
        for i, (g, w) in enumerate(zip(got, want)):
            name = "prefill" if i == 0 else f"decode step {i}"
            _, routes = self.route_agreement(
                f"{name} routes", seen["kernels"][i * n:(i + 1) * n],
                seen["torch"][i * n:(i + 1) * n], g.shape[0] * g.shape[1])
            row = self.logits_reading(
                f"{cfg.name} {name}", g.reshape(-1, g.shape[-1]),
                w.reshape(-1, w.shape[-1]))
            rows.append({**row, "routes": routes})
        rep.setdefault("logits", {})[cfg.name] = rows
        del got, want, seen

    # -------------------------------------------------------------- phase 30
    def run_moe_training(self):
        """Phase 30: MoE training on the card (module docstring, 30a-d).
        Returns its entries of the kernels line."""
        torch = self.torch
        from repro_torch.configs import get_config

        rep = self.report["moe_train"] = {}
        self.moe_train_batched(rep)
        entries = self.moe_train(get_config(MOE_ARCH), MOE_NAME,
                                 MOE_TRAIN_LAYERS, "30b",
                                 rep.setdefault(MOE_NAME, {}))
        torch.cuda.empty_cache()
        entries += self.moe_train(get_config(SCOUT_ARCH), SCOUT_NAME,
                                  SCOUT_TRAIN_LAYERS, "30c",
                                  rep.setdefault(SCOUT_NAME, {}))
        torch.cuda.empty_cache()
        return entries

    def moe_train_batched(self, rep):
        """30a: ``BatchedMatmulFn`` (forward, then dA and dB, one batched
        launch each) at each ``MOE_TRAIN_BATCHED`` shape in bf16 and fp32
        and each ``MOE_TRAIN_EDGES`` shape in bf16: each gradient against
        its plain version (fp32 ``torch.bmm`` of the same operands: the
        cotangent and B^T, A^T and the cotangent) at phase 10's bars, on
        the variant the rule gives its operands; a zeroed output and one 2%
        off shown to fail; each timed beside its bound and ``torch.bmm``."""
        torch = self.torch
        kmm = self.kmm
        counter = self.counters["matmul"]
        name = "matmul_batched (30a backward)"
        log("phase 30a: kernel 3's batched backward (BatchedMatmulFn: dA = "
            "dC @ B^T, dB = A^T @ dC, one launch each over every expert) vs "
            f"its plain version (fp32: {TOL} x max(1, max|plain|); bf16, "
            f"each element 2^-7 |plain| + {TOL} x max(1, max|plain|)), "
            f"timed beside its bound and torch.bmm")
        # drawn on the card: the CPU's draws of these operands took ~25 s
        g = torch.Generator(self.dev).manual_seed(SEED + 30)
        cases = [(sh, dt) for sh in MOE_TRAIN_BATCHED
                 for dt in (torch.bfloat16, torch.float32)]
        cases += [(sh, torch.bfloat16) for sh in MOE_TRAIN_EDGES]
        caught, rows = [], []
        for (e, r, k, n), dt in cases:
            a = torch.randn((e, r, k), generator=g, device=self.dev).to(dt)
            b = (torch.randn((e, k, n), generator=g, device=self.dev)
                 * k ** -0.5).to(dt)
            cot = torch.randn((e, r, n), generator=g, device=self.dev).to(dt)
            ta, tb = (t.detach().requires_grad_() for t in (a, b))
            before = counter.launches_batched
            da, db = torch.autograd.grad(kmm.BatchedMatmulFn.apply(ta, tb),
                                         (ta, tb), cot)
            torch.cuda.synchronize()
            if counter.launches_batched != before + 3:
                raise RuntimeError(f"30a ({e}, {r}, {k}, {n}) {dt}: "
                                   f"{counter.launches_batched - before} "
                                   f"batched launches, not 3")
            bt, at = (t.transpose(1, 2).contiguous() for t in (b, a))
            for what, got, args in (("dA", da, (cot, bt)),
                                    ("dB", db, (at, cot))):
                kern, plain, lib, flops, nbytes, geo, variant = self.lm_call(
                    "matmul_batched", args)
                kk, nn = args[1].shape[1:]
                want_v = ("wgmma" if dt == torch.bfloat16 and kk % 8 == 0
                          and nn % 8 == 0 else "simt")
                if variant != want_v or got.dtype != dt:
                    raise RuntimeError(f"30a {what} {geo} {dt}: variant "
                                       f"{variant} (not {want_v}), "
                                       f"{got.dtype}")
                want = plain()
                self.compare(f"30a {what} of ({e}, {r}, {k}, {n}): {geo} "
                             f"{dt} [{variant}], last K tile "
                             f"{kk - (kk - 1) // 64 * 64} of 64", name,
                             got, want)
                caught.append(self.sensitivity(got, want, 1.0, TOL))
                del want
                peak = (PEAK_FP32_FLOPS if dt == torch.float32
                        else PEAK_BF16_FLOPS)
                row = {"gradient": what, "forward": [e, r, k, n],
                       "geometry": geo, "dtype": str(dt),
                       "variant": variant, "flops": flops, "bytes": nbytes,
                       "ms": self.device_ms(kern),
                       "plain_ms": self.device_ms(plain, reps=3),
                       "library_ms": self.device_ms(lib),
                       "transpose_ms": self.device_ms(
                           lambda t=args[1 if what == "dA" else 0]:
                           t.transpose(1, 2).contiguous()),
                       "ops_ms": 1e3 * flops / peak,
                       "bytes_ms": 1e3 * nbytes / PEAK_BYTES_S}
                row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
                rows.append(row)
                log(f"    {row['ms']:.4f} ms, {flops / row['ms'] / 1e9:.1f} "
                    f"TFLOP/s, bound {row['bound_ms']:.4f} ms ("
                    + ("ops" if row["ops_ms"] >= row["bytes_ms"] else "bytes")
                    + f"), {row['ms'] / row['bound_ms']:.1f} x bound; "
                    f"torch.bmm {row['library_ms']:.4f} ms; plain "
                    f"{row['plain_ms']:.3f} ms; its operand's transpose "
                    f"{row['transpose_ms']:.4f} ms")
            del a, b, cot, ta, tb, da, db, at, bt
        zero, off = (min(c[j] for c in caught) for j in range(2))
        log(f"  a zeroed output would reach >= {zero:.3g} x its bar, one 2% "
            f"off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("30a: a bar would miss a zeroed or a 2%-off "
                               "kernel output")
        rep["batched_backward"] = {"timed": rows, "zeroed_over_bar": zero,
                                   "off2_over_bar": off}

    def moe_train(self, full, name, layers, phase, rep):
        """30b (Qwen3-MoE, ``make_train_step``) and 30c (Llama-4-Scout,
        ``make_value_and_grad``): ``full`` at its published widths cut to
        ``layers`` layers.  The full step's peak is reckoned first (32
        bytes a parameter, the update's temporaries over the largest leaf
        20 bytes an entry); Qwen3-MoE takes one layer less while it does
        not fit, Llama-4-Scout runs its loss and gradients.  Then 26a's
        gates by part with the batched launches apart (the fp32 routers'
        products ``"simt"``) and the routes of the forward and of the remat
        recompute equal bit for bit; 26b's calls; 26c's gradients against
        the torch backend on the kernels run's routes; 26d's steps on the
        kernels backend (30b); 26f's times.  Returns the kernels line's
        entries."""
        torch = self.torch
        from repro_torch.data import LMDataPipeline
        from repro_torch.models import transformer

        qwen = phase == "30b"
        micro, rows_b = ((MOE_TRAIN_MICRO, MOE_TRAIN_BATCH) if qwen
                         else (1, 1))
        total = torch.cuda.get_device_properties(self.dev).total_memory
        while True:
            cfg = full.replace(num_layers=layers)
            flat = transformer.flatten_params(
                transformer.init_params(None, cfg, device="meta"))
            n_par = sum(t.numel() for t in flat.values())
            largest = max(flat, key=lambda k: flat[k].numel())
            reckon = 32 * n_par + 20 * flat[largest].numel()
            fits = reckon < total
            if fits or not qwen or layers == 1:
                break
            log(f"  {cfg.name} at {layers} layers reckons "
                f"{reckon / 2 ** 30:.1f} GiB: one layer less")
            layers -= 1
        if qwen and not fits:
            raise RuntimeError(f"{cfg.name}: a full step at 1 layer reckons "
                               f"{reckon / 2 ** 30:.1f} GiB")
        grads_only = not qwen
        m = cfg.moe
        what = "loss and gradients" if grads_only else "train step"
        label = f"{name} ({cfg.num_layers} layers) {what}"
        log(f"phase {phase}: train {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads on {cfg.kv_heads} KV heads "
            f"x {cfg.head_dim}, {m.num_experts} experts top-{m.top_k} of "
            f"{m.d_ff_expert}"
            + (f" and a shared expert of {m.shared_expert_ff}"
               if m.shared_expert_ff else "")
            + f", vocab {cfg.vocab}, {cfg.dtype}), depth cut from "
            f"{full.num_layers} to {cfg.num_layers} layers: seq {MOE_SEQ}, "
            f"global batch {rows_b} in {micro} microbatches, "
            + ("make_train_step with fp32 AdamW" if qwen else
               "make_value_and_grad")
            + f", remat ({cfg.remat}); {n_par:,} parameters: a full step's "
            f"reckoned peak {reckon / 2 ** 30:.1f} GiB (32 bytes a "
            f"parameter, the update's temporaries over the largest leaf, "
            f"{largest} of {flat[largest].numel():,} entries, 20 bytes an "
            f"entry) against the card's {total / 2 ** 30:.1f} GiB")
        rep.update({"reckoned_peak_gib": reckon / 2 ** 30, "layers": layers,
                    "largest_leaf": [largest, flat[largest].numel()],
                    "full_step_run": not grads_only})
        del flat
        params = self.lm_params(cfg, SEED + (42 if qwen else 43), rep)
        pipe = LMDataPipeline(rows_b, MOE_SEQ, cfg.vocab, seed=SEED)
        try:
            batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.dev) for k, v in pipe.batch_at(i).items()}
                for i in range(TRAIN_LM_STEPS)]
        finally:
            pipe.close()
        launches = lm_train_split(cfg, MOE_SEQ, micro)
        kw = dict(phase=phase, micro=micro)
        routes = []
        parts = self.lm_train_main(
            cfg, params, batches[0], launches, label, rep,
            chunks=MOE_SEQ // self.kfa.Q_CHUNK * cfg.num_layers * micro,
            simt=router_train_launches(cfg, micro), grads_only=grads_only,
            routes=routes, **kw)
        self.remat_routes(cfg, routes, micro, phase, rep)
        del routes
        groups, samples = self.lm_train_calls(cfg, params, batches[0],
                                              launches, label, rep, **kw)
        wrong = [(w, n, geo) for (w, n, geo), (args, _) in groups.items()
                 if self.lm_call(n, args)[6] != (
                     "simt" if args[0].dtype == torch.float32
                     else "wgmma")]
        if wrong:
            raise RuntimeError(f"{label}: calls off their variant: {wrong}")
        self.lm_train_grads(cfg, params, batches[0], rep, **kw)
        if not grads_only:
            self.lm_train_steps(cfg, params, batches, rep,
                                backends=("kernels",), **kw)
        torch.cuda.empty_cache()
        entries = self.lm_train_times(cfg, params, batches, groups, samples,
                                      parts, label, rep,
                                      timed=MOE_TRAIN_TIMED,
                                      grads_only=grads_only, **kw)
        del params, batches, groups, samples
        return entries

    def remat_routes(self, cfg, routes, micro, phase, rep):
        """The routes recorded over a step (``lm_train_main``): each
        microbatch's MoE layers in the forward, then again in the remat
        recompute, in reverse layer order.  Each recompute's experts and
        kept mask must be its forward's bit for bit, or the gradient would
        be another function's than the loss."""
        n = moe_layers(cfg)
        per = n * (2 if cfg.remat else 1)
        if len(routes) != per * micro:
            raise RuntimeError(f"{phase}: {len(routes)} routes recorded over "
                               f"the step, not {per * micro}")
        compared = differ = 0
        if cfg.remat:
            for i in range(micro):
                fwd = routes[i * per:i * per + n]
                again = routes[i * per + n:(i + 1) * per][::-1]
                for (fi, fk), (ri, rk) in zip(fwd, again):
                    compared += fi.numel()
                    differ += int((fi != ri).sum()) + int((fk != rk).sum())
        log(f"  routes of the forward vs the remat recompute: {compared:,} "
            f"(token, layer, slot) routes over {micro} microbatches x {n} "
            f"MoE layers, {differ} experts or kept masks differ (must be 0)")
        rep["remat_routes"] = {"compared": compared, "differ": differ}
        if not cfg.remat or differ:
            raise RuntimeError(f"{phase}: remat {cfg.remat}; the recompute "
                               f"routed {differ} slots otherwise")

    # --------------------------------------------------- per-call helpers
    # ------------------------------------------- the recurrent mixers
    def run_recurrent(self):
        """Phase 31: the recurrent mixers (module docstring, 31a-c).
        Returns its entries of the kernels line."""
        torch = self.torch
        rep = self.report["recurrent"] = {}
        self.rec_kernels(rep)
        entries = self.xl_serve(rep)
        torch.cuda.empty_cache()
        entries += self.jm_mixer(rep)
        torch.cuda.empty_cache()
        return entries

    @staticmethod
    def rec_variant(name, args):
        """The variant kernel 3 takes for ``matmul(a, b)`` by its rule
        (``kernel3_variant``)."""
        a, b = args[0], args[1]
        dts = {str(a.dtype), str(b.dtype)}
        return kernel3_variant(*b.shape[-2:], "bf16" if dts == {
            "torch.bfloat16"} else "fp32")

    def rec_kernels(self, rep):
        """31a: kernel 3 at each ``REC_CALLS`` shape, seeded operands on the
        card (B scaled by K^-1/2, as the models' weights), one launch on
        the variant its rule names, against its plain version at phase
        10's bars; a zeroed output and one 2% off shown to fail."""
        torch = self.torch
        kmm = self.kmm
        log("phase 31a: kernel 3 at the recurrent mixers' shapes vs its "
            "plain version (fp32: 1e-4 x max(1, max|plain|); bf16: each "
            "element 2^-7 |plain| + that bar)")
        g = torch.Generator(self.dev).manual_seed(SEED + 31)
        caught, rows = [], []
        for what, m, k, n, dt in REC_CALLS:
            dtype = torch.bfloat16 if dt == "bf16" else torch.float32
            a = torch.randn((m, k), generator=g, device=self.dev).to(dtype)
            b = (torch.randn((k, n), generator=g, device=self.dev)
                 * k ** -0.5).to(dtype)
            want_v = self.rec_variant("matmul", (a, b))
            self.reset_counts()
            out = kmm.matmul(a, b)
            torch.cuda.synchronize()
            got_v = self.read_variants()["matmul"]
            if got_v[want_v] != 1 or sum(got_v.values()) != 1:
                raise RuntimeError(f"31a {what}: launches {got_v}, not one "
                                   f"{want_v!r}")
            want = kmm.matmul_plain(a, b)
            err, rel, _ = self.compare(
                f"{what} ({m}, {k}) @ ({k}, {n}) {dt} [{want_v}]",
                "matmul (31a)", out, want)
            caught.append(self.sensitivity(out, want, 1.0, TOL))
            rows.append({"what": what, "shape": [m, k, n], "dtype": dt,
                         "variant": want_v, "max_abs_err": err,
                         "max_rel_err": rel})
            del a, b, out, want
        zero, off = (min(c[j] for c in caught) for j in range(2))
        log(f"  a zeroed output would reach >= {zero:.3g} x its bar, one 2% "
            f"off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("31a: a bar would miss a zeroed or a 2%-off "
                               "kernel output")
        rep["kernels"] = {"calls": rows, "zeroed_over_bar": zero,
                          "off2_over_bar": off}

    def held(self, what, got, want):
        """A bf16 output (rows, D) against another within 5% of
        max|want| (DESIGN.md §12's bf16 output bar), read ``LOGIT_CHUNK``
        rows at a time in fp32, with what a zeroed output and one 2% off
        would read; raises on a miss.  Returns the reading."""
        spans = [(i, i + LOGIT_CHUNK)
                 for i in range(0, want.shape[0], LOGIT_CHUNK)]
        top = max(want[i:j].float().abs().max().item() for i, j in spans)
        gtop = max(got[i:j].float().abs().max().item() for i, j in spans)
        err = max((got[i:j].float() - want[i:j].float()).abs().max().item()
                  for i, j in spans)
        bar = BF16_FWD_RTOL * top
        row = {"what": what, "max_abs_err": err, "bar": bar,
               "err_over_bar": err / bar, "zeroed_over_bar": top / bar,
               "off2_over_bar": 0.02 * gtop / bar}
        log(f"  {what}: max |err| {err:.4g} = {err / bar:.3f} x the bar "
            f"({bar:.4g}); a zeroed output would read {top / bar:.3g} x, "
            f"one 2% off {row['off2_over_bar']:.3g} x")
        if err > bar or top / bar <= 1.0 or not bool(
                self.torch.isfinite(got).all()):
            raise RuntimeError(f"{what}: {row}")
        return row

    def xl_serve(self, rep):
        """31b: xLSTM-1.3B at 48 layers.  Counts 0 just before and read just
        after a ``make_prefill_step`` over 1 x XL_SEQ tokens, the prompt
        loop, a decode step and ``Server.generate``; the kernels backend
        held to the torch backend layer by layer (``replay_layers``) over
        the forward and over the prompt loop and decode steps, the head on
        the torch run's last hidden states; the decode forms held to the
        parallel ones layer by layer on the kernels backend; the forward's
        end-to-end logits read (not gated: bf16 roundings grow over 48
        layers and 1,024 steps, PERF.md); every kernel call of a decode
        step, and the first of each geometry in the forward's replay,
        against its plain version; times.  Returns the kernels line's
        entries."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import serve, steps
        from repro_torch.models import transformer, xlstm

        cfg = get_config(XL_ARCH)
        _, d_in, hd = xlstm._dims(cfg)
        label = f"{XL_NAME} ({cfg.num_layers} layers)"
        fwd, step = lm_step_launches(cfg, XL_SEQ), lm_step_launches(cfg)
        fwd_simt, step_simt = recurrent_simt(cfg, XL_SEQ), recurrent_simt(cfg)
        log(f"phase 31b: {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads, mLSTM d_inner {d_in} and "
            f"head width {hd}, sLSTM FFN "
            f"{int(cfg.xlstm.s_ff_factor * cfg.d_model)}, vocab {cfg.vocab}, "
            f"{cfg.dtype}) at all {cfg.num_layers} layers: make_prefill_step "
            f"over 1 x {XL_SEQ} tokens ({fwd['matmul']} matmul launches, "
            f"{fwd_simt} \"simt\"), then Server at batch {XL_BATCH}: a "
            f"{XL_PROMPT}-token prompt through the token loop, {XL_GEN} "
            f"tokens ({step['matmul']} launches a serve step, {step_simt} "
            f"\"simt\")")
        params = self.lm_params(cfg, SEED + 31, rep)
        x = torch.as_tensor(np.random.default_rng(SEED + 31).integers(
            0, cfg.vocab, (1, XL_SEQ), dtype=np.int32), device=self.dev)
        prompts = np.random.default_rng(SEED + 32).integers(
            0, cfg.vocab, (XL_BATCH, XL_PROMPT), dtype=np.int32)
        prefill = {b: steps.make_prefill_step(cfg, b)
                   for b in ("kernels", "torch")}
        servers = {b: serve.Server(cfg, max_len=XL_PROMPT + XL_GEN,
                                   backend=b, params=params)
                   for b in ("kernels", "torch")}
        srv = servers["kernels"]
        launches, fwd_ms = {}, {}
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.reset_counts()
            t0 = time.perf_counter()
            logits, mine = self.record_layers(
                lambda: prefill["kernels"](params, {"tokens": x}))
            torch.cuda.synchronize()
            fwd_ms["kernels"] = (time.perf_counter() - t0) * 1e3
            rep["forward_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
            launches["forward"] = self.check_lm_launches(
                f"forward (1 x {XL_SEQ})", fwd, "wgmma", simt=fwd_simt)
            t0 = time.perf_counter()
            ref, calls = self.record_layers(
                lambda: prefill["torch"](params, {"tokens": x}))
            torch.cuda.synchronize()
            fwd_ms["torch"] = (time.perf_counter() - t0) * 1e3
        rep["forward_logits"] = self.logits_reading(
            f"forward logits (1 x {XL_SEQ} x {cfg.vocab}), kernels vs torch "
            f"end to end (read, not gated)", logits[0], ref[0], gate=False)
        drift = rep["forward_drift"] = {
            i: ((mine[i][2].float() - calls[i][2].float()).abs().max()
                / calls[i][2].float().abs().max()).item()
            for i in sorted({0, 1, 3, 7, 15, 31, len(calls) - 1})
            if i < len(calls)}
        log("  the two backends' hidden states after layer i, end to end, "
            "max |kernels - torch| / max |torch| (read): " + ", ".join(
                f"{i} {d:.2%}" for i, d in drift.items()))
        del logits, mine
        served, out, (tok, caches, pos) = self.xl_served(
            srv, prompts, step, step_simt, launches)
        if out.shape != (XL_BATCH, XL_GEN) or not (
                (out >= 0) & (out < cfg.vocab)).all():
            raise RuntimeError(f"generated tokens {out.shape} out of range")
        log(f"  generated {out.shape} token ids; first request's first 8: "
            f"{out[0, :8].tolist()}")
        rep["launches"] = launches
        rep["generated"] = out.tolist()

        def replay_forward():
            rep["forward_layers"] = self.replay_layers(
                f"forward (1 x {XL_SEQ}), kernels vs torch", cfg, params,
                calls)
            rep["forward_head"] = self.logits_reading(
                "forward's head on the torch run's last hidden states, "
                "kernels vs torch", transformer.linear(
                    transformer.rmsnorm(params["final_norm"], calls[-1][2],
                                        cfg.norm_eps),
                    transformer.lm_head(params, cfg))[0], ref[0])

        log(f"phase 31b: the forward replayed layer by layer on the kernels "
            f"backend from the torch run's inputs, and a decode step")
        groups = self.gm_calls(
            {"forward": replay_forward,
             "decode step": lambda: srv.serve_step(
                 srv.params, caches, {"token": tok, "cache_pos": pos})},
            label, rep, phase="31b", expect=self.rec_variant,
            once=("forward",))
        del caches, calls, ref
        torch.cuda.empty_cache()
        self.xl_decode_held(cfg, params, prefill["kernels"],
                            servers["torch"], prompts, rep)
        return self.xl_times(cfg, params, servers, x, prompts, fwd_ms,
                             served, groups, launches, label, rep)

    def record_layers(self, fn):
        """``fn()`` with each ``transformer.apply_layer`` call's input,
        ``cache_pos`` and output recorded in call order: (``fn()``'s
        result, [(x, cache_pos, y), ...])."""
        from repro_torch.models import transformer

        calls, orig = [], transformer.apply_layer

        def rec(p, x, cfg, kind, fk, positions, cache=None, cache_pos=None,
                backend="kernels"):
            y, c = orig(p, x, cfg, kind, fk, positions, cache=cache,
                        cache_pos=cache_pos, backend=backend)
            calls.append((x, cache_pos, y))
            return y, c

        transformer.apply_layer = rec
        try:
            out = fn()
        finally:
            transformer.apply_layer = orig
        return out, calls

    def replay_layers(self, what, cfg, params, calls, caches=None,
                      as_decode=False):
        """Each recorded layer call (``record_layers``, the stack's layers
        in order, again and again) run once more on the kernels backend
        from the recorded input x: a layer held alone, so that no earlier
        layer's or step's rounding compounds into it.  Its change got - x
        is held to the recorded y - x, each element within 5% of max|y - x|
        (the bf16 output bar, DESIGN.md §12) plus one bf16 step of y,
        2^-7 |y| (the residual add's rounding, as 31a's bf16 bar): the bar
        scales with what the layer adds, not with the residual stream it
        adds it to.  A layer that added nothing (got = x) must read over
        that bar at every call.  ``caches`` (``init_caches``) are the
        replay's own, written from the recorded inputs; ``as_decode`` runs
        each recorded cache-free call of S tokens as S decode steps (the
        recurrent decode forms held to the parallel ones).  Returns the
        worst readings by mixer kind; raises on a miss."""
        torch = self.torch
        from repro_torch.models import transformer

        order = list(transformer.layer_params(params, cfg))
        worst = {}
        with torch.no_grad():
            for i, (x, pos, y) in enumerate(calls):
                pi, r, kind, fk, p = order[i % len(order)]
                cache = (None if caches is None
                         else {k: c[r] for k, c in caches[pi].items()})
                if as_decode:
                    got = torch.cat([transformer.apply_layer(
                        p, x[:, t:t + 1], cfg, kind, fk, None, cache=cache,
                        cache_pos=t)[0] for t in range(x.shape[1])], dim=1)
                else:
                    positions = (torch.arange(x.shape[1], device=x.device)
                                 .expand(x.shape[0], -1)
                                 if pos is None else None)
                    got = transformer.apply_layer(
                        p, x, cfg, kind, fk, positions, cache=cache,
                        cache_pos=pos)[0]
                yf, xf = y.float(), x.float()
                change = (yf - xf).abs()
                bar = BF16_FWD_RTOL * change.max() + 2.0 ** -7 * yf.abs()
                ratio = ((got.float() - yf).abs() / bar).max().item()
                zeroed = (change / bar).max().item()
                del yf, xf, change, bar
                if not (ratio <= 1.0 < zeroed
                        and bool(torch.isfinite(got).all())):
                    raise RuntimeError(
                        f"{what}: call {i} ({kind}, layer {r} of position "
                        f"{pi}) reads {ratio:.3f} x its bar, a layer that "
                        f"added nothing {zeroed:.3f} x")
                w = worst.setdefault(kind, {"calls": 0, "err_over_bar": 0.0,
                                            "zeroed_over_bar": math.inf})
                w["calls"] += 1
                if ratio >= w["err_over_bar"]:
                    w.update(err_over_bar=ratio, call=i)
                if zeroed < w["zeroed_over_bar"]:
                    w.update(zeroed_over_bar=zeroed, zeroed_call=i)
        log(f"  {what}, layer by layer (each from the recorded input, its "
            f"change within 5% of max|recorded change| + 2^-7 |recorded|): "
            + "; ".join(
                f"{k}: {w['calls']} calls, worst {w['err_over_bar']:.3f} x "
                f"(call {w['call']}), a layer that added nothing >= "
                f"{w['zeroed_over_bar']:.3g} x (call {w['zeroed_call']})"
                for k, w in worst.items()))
        return worst

    def xl_decode_held(self, cfg, params, prefill, srv, prompts, rep):
        """31b's serving held layer by layer: the torch backend's
        ``Server.generate`` (``srv``: the prompt loop and XL_GEN - 1 greedy
        decode steps) recorded and replayed on the kernels backend with its
        own caches; and the kernels forward over the prompts recorded and
        replayed as decode steps (the recurrent decode forms against the
        parallel ones)."""
        torch = self.torch
        from repro_torch.models import transformer

        b, p = prompts.shape
        with torch.no_grad():
            _, calls = self.record_layers(
                lambda: srv.generate(prompts, XL_GEN))
        rep["decode_layers"] = self.replay_layers(
            f"prompt loop and {XL_GEN - 1} decode steps at batch {b}, kernels "
            f"vs torch", cfg, srv.params, calls,
            caches=transformer.init_caches(cfg, b, p + XL_GEN, self.dev))
        del calls
        x = torch.as_tensor(prompts, device=self.dev)
        with torch.no_grad():
            _, calls = self.record_layers(
                lambda: prefill(params, {"tokens": x}))
        rep["decode_forms"] = self.replay_layers(
            f"the prompts ({b} x {p}) as decode steps vs the forward, kernels",
            cfg, params, calls, caches=transformer.init_caches(cfg, b, p,
                                                               self.dev),
            as_decode=True)
        del calls
        torch.cuda.empty_cache()

    def xl_served(self, srv, prompts, step=None, step_simt=0,
                  launches=None):
        """31b's serving through ``srv``'s entry points: ``Server.prefill``
        over the prompts (the token loop; its wall ms is the time to first
        token), one serve step from its caches, and ``Server.generate``
        (decode ms a step: its wall less the prefill's, over its XL_GEN - 1
        decode steps); the serving peak memory over the prefill and the
        serve step (weights and one set of caches: ``generate`` draws its
        own beside the prefill's, which are kept).  With ``step`` (a
        serve step's launches, ``simt`` of them ``step_simt``) the counts
        are 0 just before and read just after each call, the serve step's
        into ``launches``.  Returns (times, the generated tokens, the
        prefill's (token, caches, position))."""
        torch = self.torch

        def check(what, n):
            if step is None:
                return None
            return self.check_lm_launches(
                what, {k: v * n for k, v in step.items()}, "wgmma",
                simt=step_simt * n)

        served = {}
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.reset_counts()
            t0 = time.perf_counter()
            tok, caches, pos = srv.prefill(prompts)
            torch.cuda.synchronize()
            served["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            check(f"prompt loop ({XL_PROMPT} serve steps)", XL_PROMPT)
            self.reset_counts()
            srv.serve_step(srv.params, caches, {"token": tok,
                                                "cache_pos": pos})
            torch.cuda.synchronize()
            served["serve_peak_gib"] = (torch.cuda.max_memory_allocated()
                                        / 2 ** 30)
            one = check(f"decode step at position {pos}", 1)
            if launches is not None:
                launches["decode step"] = one
        n = XL_PROMPT + XL_GEN - 1
        self.reset_counts()
        t0 = time.perf_counter()
        out = srv.generate(prompts, XL_GEN)
        torch.cuda.synchronize()
        served["decode_step_ms"] = ((time.perf_counter() - t0) * 1e3
                                    - served["prefill_ms"]) / (XL_GEN - 1)
        check(f"generate ({n} serve steps)", n)
        return served, out, (tok, caches, pos)

    def xl_times(self, cfg, params, servers, x, prompts, fwd_ms, served,
                 groups, launches, label, rep):
        """31b's times, per backend: the forward's wall ms (``fwd_ms``, its
        first run, on the main path) and the busy share of a forward at one
        pattern period (an mLSTM and an sLSTM layer) over the first
        XL_PROFILE_SEQ tokens (the profiler over all 48 layers' and 1,024
        steps' ~500,000 events takes minutes);
        the prompt loop's wall ms (``Server.prefill``, time to first
        token), decode ms a step (``Server.generate``'s wall less that
        loop's, over its XL_GEN - 1 decode steps) and tokens/s, and serving
        peak memory, for the kernels backend from its main-path runs
        (``served``), for the torch backend from the same two calls; a
        decode step's busy share, from a fresh cache (a recurrent step
        costs the same at any state); per kernel and shape the device ms of
        the forward and of a decode step beside bound and library
        (``serve_shapes``)."""
        torch = self.torch
        from repro_torch.launch import steps
        from repro_torch.models import transformer

        def srv_tokens(a):
            return torch.as_tensor(a, dtype=torch.int32, device=self.dev)

        log(f"phase 31b: {label} times")
        period = cfg.replace(num_layers=len(cfg.block_pattern))

        def first(tree):
            return {k: first(v) if isinstance(v, dict) else v[:1]
                    for k, v in tree.items()}

        p1 = {**params, "blocks": [first(b) for b in params["blocks"]]}
        times = rep["times"] = {}
        for backend, srv in servers.items():
            with torch.no_grad():
                prefill = steps.make_prefill_step(period, backend)

                def forward():
                    return prefill(p1, {"tokens": x[:, :XL_PROFILE_SEQ]})

                period_ms = self.wall_ms(forward, reps=1, warmup=1)
                prof_fwd = self.profile_device(
                    forward, f"{backend} forward at one pattern period over "
                    f"1 x {XL_PROFILE_SEQ}", period_ms, warmup=False)
                row = dict(served) if backend == "kernels" else (
                    self.xl_served(srv, prompts)[0])
                caches = transformer.init_caches(
                    cfg, XL_BATCH, XL_PROMPT + XL_GEN, self.dev)
                tok = srv_tokens(prompts[:, :1])

                def step():
                    return srv.serve_step(srv.params, caches,
                                          {"token": tok,
                                           "cache_pos": XL_PROMPT})[0]

                step_ms = row["decode_step_ms"]
                prof_step = self.profile_device(step,
                                                f"{backend} decode step",
                                                step_ms)
            del caches
            row.update(forward_ms=fwd_ms[backend],
                       forward_tokens_per_s=XL_SEQ * 1e3 / fwd_ms[backend],
                       period_forward_ms=period_ms,
                       tokens_per_s=XL_BATCH * 1e3 / step_ms)
            prefill_ms, serve_peak = row["prefill_ms"], row["serve_peak_gib"]
            for what, prof in (("period_forward", prof_fwd),
                               ("decode_step", prof_step)):
                row[f"{what}_busy"] = prof.get("busy_share")
                row[f"{what}_device_ms"] = prof.get("device_ms")
                row[f"{what}_profile"] = prof
            times[backend] = row
            busy = {w: ("not measured" if row[f"{w}_busy"] is None
                        else f"{row[f'{w}_busy']:.1%}")
                    for w in ("period_forward", "decode_step")}
            log(f"  {backend}: forward (1 x {XL_SEQ}, {cfg.num_layers} layers) "
                f"{fwd_ms[backend]:.3f} ms ({row['forward_tokens_per_s']:.1f}"
                f" tokens/s); at one pattern period over 1 x "
                f"{XL_PROFILE_SEQ} {period_ms:.3f} ms, busy "
                f"{busy['period_forward']}; prefill ({XL_PROMPT}-token loop, "
                f"batch {XL_BATCH}) {prefill_ms:.3f} ms; decode "
                f"{step_ms:.3f} ms a step = {row['tokens_per_s']:.1f} "
                f"tokens/s, busy {busy['decode_step']}; serving peak "
                f"{serve_peak:.2f} GiB (weights included)")
        log(f"  forward peak (kernels, {cfg.num_layers} layers): "
            f"{rep['forward_peak_gib']:.2f} GiB (weights included)")
        return self.serve_shapes(groups, launches, label, rep)

    def jm_mixer(self, rep):
        """31c: one Jamba-1.5-Large Mamba mixer alone at full width.  Counts
        0 just before and read just after ``mamba_block`` over 1 x JM_SEQ
        rows (8 scan chunks) and one decode step; the forward's output
        against the torch backend's; JM_DECODE decode steps at batch
        JM_BATCH from a zero cache against one scan over the same tokens,
        on each backend, and the kernels backend's against the torch
        backend's; every kernel call of the forward and of a decode step
        against its plain version; times.  Returns the kernels line's
        entries."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import mamba

        cfg = get_config(JM_ARCH)
        m, d_in, dt_rank = mamba._cfg(cfg)
        label = JM_NAME
        fwd = mixer_products(cfg, "mamba", JM_SEQ)
        step = mixer_products(cfg, "mamba")
        log(f"phase 31c: {label} alone at full width (d_model "
            f"{cfg.d_model}, d_inner {d_in}, d_state {m.d_state}, dt_rank "
            f"{dt_rank}, d_conv {m.d_conv}, bf16): mamba_block over 1 x "
            f"{JM_SEQ} ({mamba.SCAN_CHUNK}-token scan chunks; {fwd} kernel-3 "
            f"launches), {JM_DECODE} decode steps at batch {JM_BATCH} ({step} "
            f"a step)")
        g = torch.Generator(self.dev).manual_seed(SEED + 34)
        t0 = time.perf_counter()
        p = mamba.mamba_init(g, cfg, torch.bfloat16, self.dev)
        torch.cuda.synchronize()
        leaves = list(p.values())
        n_par = sum(t.numel() for t in leaves)
        gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
        log(f"  weights: {n_par:,} parameters, {gb:.2f} GB, drawn on the "
            f"card in {(time.perf_counter() - t0) * 1e3:.1f} ms")
        rep["jamba_weights"] = {"parameters": n_par, "gb": gb}
        x = torch.randn((1, JM_SEQ, cfg.d_model), generator=g,
                        device=self.dev).to(torch.bfloat16)
        xd = torch.randn((JM_BATCH, JM_DECODE, cfg.d_model), generator=g,
                         device=self.dev).to(torch.bfloat16)

        def want(counts):
            return {"conv2d": 0, "transposed_conv2d": 0,
                    "matmul": sum(counts.values()), "flash_attention": 0}

        def decode(backend, cache):
            return torch.cat([mamba.mamba_block(
                p, xd[:, t:t + 1], cfg, cache=cache, backend=backend)[0]
                for t in range(JM_DECODE)], dim=1)

        launches, out, par, dec = {}, {}, {}, {}
        with torch.no_grad():
            self.reset_counts()
            out["kernels"] = mamba.mamba_block(p, x, cfg)[0]
            torch.cuda.synchronize()
            launches["forward"] = self.check_lm_launches(
                f"forward (1 x {JM_SEQ})", want(fwd), "wgmma",
                simt=fwd["simt"])
            out["torch"] = mamba.mamba_block(p, x, cfg, backend="torch")[0]
            for backend in ("kernels", "torch"):
                par[backend] = mamba.mamba_block(p, xd, cfg,
                                                 backend=backend)[0]
                cache = mamba.init_mamba_cache(cfg, JM_BATCH, torch.bfloat16,
                                               self.dev)
                if backend == "kernels":
                    self.reset_counts()
                    mamba.mamba_block(p, xd[:, :1], cfg, cache=cache)
                    torch.cuda.synchronize()
                    launches["decode step"] = self.check_lm_launches(
                        "decode step", want(step), "wgmma",
                        simt=step["simt"])
                    cache = mamba.init_mamba_cache(
                        cfg, JM_BATCH, torch.bfloat16, self.dev)
                dec[backend] = decode(backend, cache)
        readings = [self.held(
            f"forward (1 x {JM_SEQ} x {cfg.d_model}), kernels vs torch",
            out["kernels"][0], out["torch"][0])]
        for backend in ("kernels", "torch"):
            readings.append(self.held(
                f"{JM_DECODE} decode steps vs one scan over them, {backend}",
                dec[backend].reshape(-1, cfg.d_model),
                par[backend].reshape(-1, cfg.d_model)))
        readings.append(self.held(
            f"{JM_DECODE} decode steps, kernels vs torch",
            dec["kernels"].reshape(-1, cfg.d_model),
            dec["torch"].reshape(-1, cfg.d_model)))
        rep["jamba_outputs"] = readings
        del out, par, dec
        torch.cuda.empty_cache()
        cache = mamba.init_mamba_cache(cfg, JM_BATCH, torch.bfloat16,
                                       self.dev)
        groups = self.gm_calls(
            {"forward": lambda: mamba.mamba_block(p, x, cfg),
             "decode step": lambda: mamba.mamba_block(
                 p, xd[:, :1], cfg, cache=cache)},
            label, rep, phase="31c", expect=self.rec_variant)
        log(f"phase 31c: {label} times")
        times = rep["jamba_times"] = {}
        for backend in ("kernels", "torch"):
            with torch.no_grad():
                def forward(b=backend):
                    return mamba.mamba_block(p, x, cfg, backend=b)

                def step(b=backend):
                    return mamba.mamba_block(p, xd[:, :1], cfg, cache=cache,
                                             backend=b)

                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fwd_ms = self.wall_ms(forward, reps=3)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                step_ms = self.wall_ms(step, reps=JM_DECODE)
                prof = {"forward": self.profile_device(
                            forward, f"{backend} mixer forward", fwd_ms),
                        "decode_step": self.profile_device(
                            step, f"{backend} mixer decode step", step_ms)}
            row = {"forward_ms": fwd_ms, "decode_step_ms": step_ms,
                   "forward_tokens_per_s": JM_SEQ * 1e3 / fwd_ms,
                   "peak_gib": peak}
            for what, pr in prof.items():
                row[f"{what}_busy"] = pr.get("busy_share")
                row[f"{what}_device_ms"] = pr.get("device_ms")
                row[f"{what}_profile"] = pr
            times[backend] = row
            busy = {w: ("not measured" if row[f"{w}_busy"] is None
                        else f"{row[f'{w}_busy']:.1%}")
                    for w in ("forward", "decode_step")}
            log(f"  {backend}: forward {fwd_ms:.3f} ms "
                f"({row['forward_tokens_per_s']:.1f} tokens/s), busy "
                f"{busy['forward']}; decode step (batch {JM_BATCH}) "
                f"{step_ms:.3f} ms, busy {busy['decode_step']}; peak "
                f"{peak:.2f} GiB (weights included)")
        entries = self.serve_shapes(groups, launches, label, rep)
        del p, x, xd, cache
        return entries

    # ------------------------------------------ the recurrent mixers trained
    def run_rec_training(self):
        """Phase 32: the recurrent mixers trained (module docstring,
        32a-d).  Returns its entries of the kernels line."""
        torch = self.torch
        rep = self.report["rec_train"] = {}
        self.rec_train_kernels(rep)
        entries = self.xl_train(rep.setdefault(XL_NAME, {}))
        torch.cuda.empty_cache()
        entries += self.jm_train(rep.setdefault(JM_NAME, {}))
        torch.cuda.empty_cache()
        return entries

    def rec_train_kernels(self, rep):
        """32a: ``MatmulFn`` (forward, then dA and dB, a launch each) at each
        ``REC_TRAIN_CALLS`` shape: each gradient against its plain version
        (fp32 ``torch.matmul`` of the cotangent and B^T, of A^T and the
        cotangent) at phase 10's bars, on the variant the rule gives its
        operands; a zeroed output and one 2% off shown to fail; each timed
        beside its bound, ``torch.matmul`` and its operand's transpose."""
        torch = self.torch
        kmm = self.kmm
        counter = self.counters["matmul"]
        name = "matmul (32a backward)"
        log("phase 32a: kernel 3's backward at the recurrent training "
            "path's shapes (MatmulFn: dA = dC @ B^T, dB = A^T @ dC) vs its "
            f"plain version (fp32: {TOL} x max(1, max|plain|); bf16, each "
            f"element 2^-7 |plain| + that bar), timed beside its bound and "
            f"torch.matmul")
        g = torch.Generator(self.dev).manual_seed(SEED + 35)
        caught, rows = [], []
        for what, m, k, n, dt in REC_TRAIN_CALLS:
            dtype = torch.bfloat16 if dt == "bf16" else torch.float32
            a = torch.randn((m, k), generator=g, device=self.dev).to(dtype)
            b = (torch.randn((k, n), generator=g, device=self.dev)
                 * k ** -0.5).to(dtype)
            cot = torch.randn((m, n), generator=g, device=self.dev).to(dtype)
            ta, tb = (t.detach().requires_grad_() for t in (a, b))
            before = counter.launches
            da, db = torch.autograd.grad(kmm.MatmulFn.apply(ta, tb),
                                         (ta, tb), cot)
            torch.cuda.synchronize()
            if counter.launches != before + 3:
                raise RuntimeError(f"32a {what}: {counter.launches - before}"
                                   f" launches, not 3")
            bt, at = b.T.contiguous(), a.T.contiguous()
            for grad, got, args in (("dA", da, (cot, bt)),
                                    ("dB", db, (at, cot))):
                kern, plain, lib, flops, nbytes, geo, variant = self.lm_call(
                    "matmul", args)
                want_v = self.rec_variant("matmul", args)
                if variant != want_v or got.dtype != dtype:
                    raise RuntimeError(f"32a {what} {grad} {geo}: variant "
                                       f"{variant} (not {want_v}), "
                                       f"{got.dtype}")
                want = plain()
                err, rel, _ = self.compare(
                    f"32a {what} ({m}, {k}) @ ({k}, {n}) {dt}: {grad} {geo} "
                    f"[{variant}]", name, got, want)
                caught.append(self.sensitivity(got, want, 1.0, TOL))
                del want
                peak = PEAK_FP32_FLOPS if dt == "fp32" else PEAK_BF16_FLOPS
                row = {"what": what, "gradient": grad, "forward": [m, k, n],
                       "geometry": geo, "dtype": dt, "variant": variant,
                       "max_abs_err": err, "max_rel_err": rel,
                       "flops": flops, "bytes": nbytes,
                       "ms": self.device_ms(kern),
                       "plain_ms": self.device_ms(plain, reps=3),
                       "library_ms": self.device_ms(lib),
                       "transpose_ms": self.device_ms(
                           lambda t=args[1 if grad == "dA" else 0]:
                           t.T.contiguous()),
                       "ops_ms": 1e3 * flops / peak,
                       "bytes_ms": 1e3 * nbytes / PEAK_BYTES_S}
                row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
                rows.append(row)
                log(f"    {row['ms']:.4f} ms, {flops / row['ms'] / 1e9:.2f} "
                    f"TFLOP/s, bound {row['bound_ms']:.4f} ms ("
                    + ("ops" if row["ops_ms"] >= row["bytes_ms"] else "bytes")
                    + f"), {row['ms'] / row['bound_ms']:.1f} x bound; "
                    f"torch.matmul {row['library_ms']:.4f} ms; plain "
                    f"{row['plain_ms']:.3f} ms; its operand's transpose "
                    f"{row['transpose_ms']:.4f} ms")
            del a, b, cot, ta, tb, da, db, at, bt
        zero, off = (min(c[j] for c in caught) for j in range(2))
        log(f"  a zeroed output would reach >= {zero:.3g} x its bar, one 2% "
            f"off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("32a: a bar would miss a zeroed or a 2%-off "
                               "kernel output")
        rep["backward"] = {"timed": rows, "zeroed_over_bar": zero,
                           "off2_over_bar": off}

    def lm_batches(self, cfg, rows, seq, n):
        """``LMDataPipeline(rows, seq, seed=SEED)``'s first ``n`` batches on
        the card."""
        torch = self.torch
        from repro_torch.data import LMDataPipeline

        pipe = LMDataPipeline(rows, seq, cfg.vocab, seed=SEED)
        try:
            return [{k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.dev) for k, v in pipe.batch_at(i).items()}
                for i in range(n)]
        finally:
            pipe.close()

    def xl_train(self, rep):
        """32b: xLSTM-1.3B at one pattern period trained (module docstring).
        Returns the kernels line's entries."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import xlstm

        full = get_config(XL_ARCH)
        cfg = full.replace(num_layers=XL_TRAIN_LAYERS)
        _, d_in, _ = xlstm._dims(cfg)
        label = f"{XL_NAME} ({cfg.num_layers} layers) train step"
        launches = lm_train_launches(cfg, XL_TRAIN_SEQ, 1)
        per_launch = recurrent_train_launches(cfg, XL_TRAIN_SEQ,
                                              XL_TRAIN_BATCH)
        variants = train_variants(per_launch)
        simt = sum(v["simt"] for v in variants.values())
        log(f"phase 32b: train {cfg.name} at its published widths (d "
            f"{cfg.d_model}, {cfg.num_heads} heads, mLSTM d_inner {d_in}, "
            f"sLSTM FFN {int(cfg.xlstm.s_ff_factor * cfg.d_model)}, vocab "
            f"{cfg.vocab}, {cfg.dtype}), depth cut from {full.num_layers} to "
            f"{cfg.num_layers} layers (one pattern period): make_train_step "
            f"over {XL_TRAIN_BATCH} x {XL_TRAIN_SEQ} tokens, fp32 AdamW, "
            f"remat ({cfg.remat}); kernel-3 launches by part and variant "
            f"(recurrent_train_launches): {variants}")
        params = self.lm_params(cfg, SEED + 32, rep)
        batches = self.lm_batches(cfg, XL_TRAIN_BATCH, XL_TRAIN_SEQ,
                                  TRAIN_LM_STEPS)
        layers = []
        parts = self.xl_train_steps(cfg, params, batches, launches, simt,
                                    label, rep, layers)
        self.xl_layer_vjps(cfg, params, layers, rep)
        del layers
        self.xl_witness(cfg, params, rep)
        groups = self.rec_train_groups(per_launch, label)
        return self.xl_train_times(cfg, params, groups, parts, label, rep)

    def first_grads(self, store):
        """Keep in ``store`` the gradients that the first ``make_train_step``
        call made inside the block hands AdamW
        (``repro_torch.launch.data_axis.first_grads``, which phase 35's
        ranks use too)."""
        from repro_torch.launch.data_axis import first_grads

        return first_grads(store)

    @contextlib.contextmanager
    def layer_cotangents(self, rec):
        """Append to ``rec`` each ``transformer.apply_layer`` call's input x
        made inside the block, with the cotangent the backward then hands
        its output (a hook on it): ``[x, cotangent]`` in call order.  A
        remat recompute's calls get none: their outputs are not the
        graph's."""
        from repro_torch.models import transformer

        orig = transformer.apply_layer

        def record(*args, **kw):
            y, cache = orig(*args, **kw)
            entry = [args[1].detach(), None]
            rec.append(entry)
            y.register_hook(lambda g: entry.__setitem__(1, g))
            return y, cache

        transformer.apply_layer = record
        try:
            yield
        finally:
            transformer.apply_layer = orig

    def xl_train_steps(self, cfg, params, batches, launches, simt, label,
                       rep, layers):
        """32b's steps: on each backend TRAIN_LM_STEPS ``make_train_step``
        steps from one state on successive batches, timed, the kernels
        backend's first one the main path (``lm_train_main``: counts 0 just
        before it and read just after, by part and variant), each backend's
        step-0 gradients kept (``first_grads``), the torch backend's first
        step's layer inputs and output cotangents recorded into ``layers``
        (``layer_cotangents``).  Gates: the losses within 5%
        step by step, the step-0 loss within 5%, finite; the step-0
        gradient norm and each gradient's relative L2 end to end are read,
        not gated (the sLSTM's backward parts chaotically over 4,096 steps:
        ``XL_REPLAY_SEQ``; ``xl_layer_vjps`` holds each layer).  Returns
        the main path's launches by part."""
        torch = self.torch
        from repro_torch.optim import global_norm

        log(f"phase 32b: {TRAIN_LM_STEPS} make_train_step steps on kernels "
            f"and torch from one state on successive batches, the kernels "
            f"backend's first the main path")
        losses, walls, peaks, first = {}, {}, {}, {}
        parts = None
        for backend in ("kernels", "torch"):
            step, opt_init = self.train_fns(cfg, backend, 1)
            p, o = params, opt_init(params)
            losses[backend], walls[backend] = [], []
            grads = first[backend] = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for i, b in enumerate(batches[:TRAIN_LM_STEPS]):
                t0 = time.perf_counter()
                with self.first_grads(grads), (
                        self.layer_cotangents(layers)
                        if backend == "torch" and i == 0
                        else contextlib.nullcontext()):
                    if backend == "kernels" and i == 0:
                        keep = {}
                        parts = self.lm_train_main(
                            cfg, p, b, launches, label, rep, phase="32b",
                            micro=1, chunks=0, simt=simt, keep=keep)
                        p, o, m = keep["params"], keep["opt"], keep["metrics"]
                    else:
                        p, o, m = step(p, o, b)
                    loss = float(m["loss"])
                walls[backend].append((time.perf_counter() - t0) * 1e3)
                losses[backend].append(loss)
            peaks[backend] = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  {backend}: losses {losses[backend]}, step {int(o.step)}; "
                f"wall ms {[round(w, 1) for w in walls[backend]]}, peak "
                f"{peaks[backend]:.2f} GiB")
            if int(o.step) != TRAIN_LM_STEPS or not all(
                    map(math.isfinite, losses[backend])):
                raise RuntimeError(f"{backend} steps: {losses[backend]}")
            del p, o, m
            torch.cuda.empty_cache()
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernels"],
                                                   losses["torch"])]
        gk, gt = first["kernels"], first["torch"]
        nk, nt = float(global_norm(gk)), float(global_norm(gt))
        grad_rel = {k: ((gk[k].float() - gt[k].float()).norm()
                        / gt[k].float().norm().clamp_min(1e-30)).item()
                    for k in gt}
        worst = max(grad_rel, key=grad_rel.get)
        log(f"  kernels vs torch losses: relative {[f'{r:.2e}' for r in rel]}"
            f" (bar {BF16_FWD_RTOL:.0%}); step 0 end to end (read, not "
            f"gated): grad_norm {nk:.4f} vs {nt:.4f} ({abs(nk - nt) / nt:.2e}"
            f"), worst gradient {worst} at relative L2 {grad_rel[worst]:.3e} "
            f"(median {statistics.median(grad_rel.values()):.3e})")
        rep["steps"] = {"losses": losses, "rel": rel, "walls_ms": walls,
                        "peak_gib": peaks}
        rep["grads_end_to_end"] = {"grad_norm": [nk, nt],
                                   "worst": [worst, grad_rel[worst]],
                                   "rel_l2": grad_rel}
        del first, gk, gt
        torch.cuda.empty_cache()
        if max(rel) > BF16_FWD_RTOL:
            raise RuntimeError(f"train losses differ: {losses}")
        return parts

    def xl_layer_vjps(self, cfg, params, layers, rep):
        """32b's bf16 gradient gate, layer by layer: each layer's VJP from
        the torch backend's first step's recorded input x and output
        cotangent (``layer_cotangents``) on both backends, each gradient
        (x's and every leaf's) kernels against torch at 10% relative L2 (a
        zeroed gradient reads 1.0).  The mLSTM layer over the whole
        sequence (its chunkwise form); the sLSTM layer over its first
        XL_REPLAY_SEQ tokens, where its backward has not yet grown chaotic
        (the whole layer's reading is the end to end one)."""
        torch = self.torch
        from repro_torch.models import transformer

        log(f"phase 32b: each layer's bf16 VJP from the torch run's recorded "
            f"input and output cotangent, kernels vs torch (each gradient "
            f"{BF16_GRAD_RTOL:.0%} relative L2): the mLSTM over "
            f"{XL_TRAIN_SEQ} tokens, the sLSTM over its first "
            f"{XL_REPLAY_SEQ}")
        rec = [r for r in layers if r[1] is not None]
        order = list(transformer.layer_params(params, cfg))
        readings = {}
        for (pi, r, kind, fk, p), (x, cot) in zip(order, rec):
            if kind == "slstm":
                x, cot = x[:, :XL_REPLAY_SEQ], cot[:, :XL_REPLAY_SEQ]
            flat = transformer.flatten_params(p)
            names = ["x", *flat]
            got = {}
            for backend in ("kernels", "torch"):
                leaves = {k: v.detach().requires_grad_()
                          for k, v in flat.items()}
                tx = x.detach().requires_grad_()
                y = transformer.apply_layer(
                    transformer.unflatten_params(leaves, p), tx, cfg, kind,
                    fk, None, backend=backend)[0]
                got[backend] = dict(zip(names, torch.autograd.grad(
                    y, [tx, *leaves.values()], cot, materialize_grads=True)))
            rel = {k: ((got["kernels"][k].float() - got["torch"][k].float())
                       .norm() / got["torch"][k].float().norm()
                       .clamp_min(1e-30)).item()
                   for k in names if bool(got["torch"][k].any())}
            worst = max(rel, key=rel.get)
            readings[f"{kind} (layer {r} of position {pi}, {x.shape[1]} "
                     f"tokens)"] = rel
            log(f"  {kind}, {x.shape[1]} tokens: worst {worst} at "
                f"{rel[worst]:.3e} (median "
                f"{statistics.median(rel.values()):.3e}); "
                + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
            if rel[worst] > BF16_GRAD_RTOL or not all(
                    bool(torch.isfinite(g).all())
                    for g in got["kernels"].values()):
                raise RuntimeError(f"32b {kind} VJP: {worst} {rel[worst]}")
            del got
        if len(readings) != cfg.num_layers:
            raise RuntimeError(f"32b: {len(readings)} layers replayed, not "
                               f"{cfg.num_layers}")
        rep["layer_vjps"] = readings
        del rec
        torch.cuda.empty_cache()

    def xl_witness(self, cfg, params, rep):
        """32b's arithmetic witness: the loss and gradients of the same
        weights in fp32, kernels (every product ``"simt"``) against torch
        (TF32 off), the loss at 1e-4 relative, each gradient held twice
        with what a zeroed gradient would read: at 1 x XL_WITNESS_SHORT,
        where the sLSTM's backward has grown ~1.3x, its largest error
        within 1e-4 of its largest entry; at 1 x XL_WITNESS_SEQ, where it
        has grown ~2.9x, at 1e-4 relative L2, the largest error read
        beside."""
        torch = self.torch
        from repro_torch.launch import steps
        from repro_torch.models import transformer

        c32 = cfg.replace(dtype="float32")
        p32 = transformer.unflatten_params(
            {k: v.float() for k, v in
             transformer.flatten_params(params).items()}, params)
        rep["fp32_witness"] = {}
        for seq, gate in ((XL_WITNESS_SHORT, "max |err|"),
                          (XL_WITNESS_SEQ, "relative L2")):
            batch = self.lm_batches(cfg, XL_TRAIN_BATCH, seq, 1)[0]
            log(f"phase 32b: the fp32 witness: loss and gradients of the "
                f"same weights in fp32 over {XL_TRAIN_BATCH} x {seq}, "
                f"kernels vs torch, each gradient's {gate} within {TOL} of "
                f"the torch gradient's")
            out = {}
            for backend in ("kernels", "torch"):
                vg = steps.make_value_and_grad(c32, backend=backend)
                t0 = time.perf_counter()
                loss, grads = vg(p32, batch)
                torch.cuda.synchronize()
                out[backend] = (float(loss), grads,
                                (time.perf_counter() - t0) * 1e3)
            (lk, gk, msk), (lt, gt, mst) = out["kernels"], out["torch"]
            nonzero = [k for k in gt if bool(gt[k].any())]
            l2 = {k: ((gk[k] - gt[k]).norm() / (TOL * gt[k].norm())).item()
                  for k in nonzero}
            peak = {k: ((gk[k] - gt[k]).abs().max()
                        / (TOL * gt[k].abs().max())).item() for k in nonzero}
            ratio, read = (peak, l2) if gate == "max |err|" else (l2, peak)
            worst = max(ratio, key=ratio.get)
            loss_rel = abs(lk - lt) / abs(lt)
            log(f"  loss {lk:.6f} vs {lt:.6f} ({loss_rel:.2e}); "
                f"{len(ratio)} gradients, {gate} over its bar: worst {worst} "
                f"at {ratio[worst]:.3f} x (median "
                f"{statistics.median(ratio.values()):.3f}); the other form "
                f"(read): worst {max(read.values()):.3f}, median "
                f"{statistics.median(read.values()):.3f}; a zeroed gradient "
                f"would read {1 / TOL:.0f} x; {msk:.1f} / {mst:.1f} ms")
            rep["fp32_witness"][seq] = {
                "gate": gate, "loss": [lk, lt], "loss_rel": loss_rel,
                "worst": [worst, ratio[worst]], "rel_l2_over_bar": l2,
                "max_err_over_bar": peak, "ms": [msk, mst]}
            del out, gk, gt
            if loss_rel > TOL or ratio[worst] > 1.0:
                raise RuntimeError(f"fp32 witness at {seq} tokens: loss {lk} "
                                   f"vs {lt}, {worst} {ratio[worst]:.3f} x "
                                   f"its bar ({gate})")
        del p32
        torch.cuda.empty_cache()

    def rec_train_groups(self, launches, label):
        """Seeded operands on the card for each distinct kernel-3 shape of
        a step by part (``launches``: ``recurrent_train_launches``), each
        launched once and held against its plain version at phase 10's
        bars (backward products without the max(1, .) floor, as 26b), with
        what a zeroed output and one 2% off would read: ``{(part,
        "matmul", geometry): [operands, calls a step]}`` for
        ``lm_train_shapes``."""
        torch = self.torch
        kmm = self.kmm
        log(f"phase 32b: {label}: each distinct kernel-3 shape of the step, "
            f"on seeded operands, vs its plain version")
        counts = collections.Counter(launches)
        g = torch.Generator(self.dev).manual_seed(SEED + 37)
        groups, caught = {}, []
        for (part, m, k, n, dt), calls in counts.items():
            dtype = torch.bfloat16 if dt == "bf16" else torch.float32
            a = torch.randn((m, k), generator=g, device=self.dev).to(dtype)
            b = (torch.randn((k, n), generator=g, device=self.dev)
                 * k ** -0.5).to(dtype)
            entry = (f"matmul ({label} "
                     f"{'backward' if part == 'backward' else 'forward'})")
            floor = 0.0 if part == "backward" else 1.0
            out, want = kmm.matmul(a, b), kmm.matmul_plain(a, b)
            geo = self.lm_call("matmul", (a, b))[5]
            self.compare(f"{entry} {geo} ({part}, x{calls})", entry, out,
                         want, quiet=True, floor=floor)
            caught.append(self.sensitivity(out, want, floor, TOL))
            groups[part, "matmul", geo] = [(a, b), calls]
            del out, want
        zero, off = (min(c[j] for c in caught) for j in range(2))
        log(f"  {len(groups)} shapes ok; a zeroed output would reach >= "
            f"{zero:.3g} x its bar, one 2% off >= {off:.3g} x")
        if not (zero > 1.0 and off > 1.0):
            raise RuntimeError("32b: a bar would miss a zeroed or a 2%-off "
                               "kernel output")
        return groups

    def xl_train_times(self, cfg, params, groups, parts, label, rep):
        """32b's times: per backend the step wall ms (the median of the
        warm steps, ``xl_train_steps``), tokens/s, peak memory; the busy
        share and device ms by class of a step over 1 x
        XL_TRAIN_PROFILE_SEQ; each distinct shape's kernel, plain and
        library ms (``lm_train_shapes``).  Returns the kernels line's
        entries."""
        torch = self.torch

        log(f"phase 32b: {label} times")
        tokens = XL_TRAIN_BATCH * XL_TRAIN_SEQ
        short = self.lm_batches(cfg, XL_TRAIN_BATCH, XL_TRAIN_PROFILE_SEQ,
                                1)[0]
        classes = {"kernel 3": ("matmul_wgmma_kernel", "matmul_kernel"),
                   "library GEMM": ("gemm", "xmma", "nvjet", "cutlass",
                                    "Kernel2"),
                   "copies (transposes, casts)": ("copy",)}
        times = rep["times"] = {}
        for backend in ("kernels", "torch"):
            walls = rep["steps"]["walls_ms"][backend]
            wall = statistics.median(walls[1:])
            step, opt_init = self.train_fns(cfg, backend, 1)
            state = [params, opt_init(params)]

            def run(step=step, state=state):
                state[:] = step(*state, short)[:2]

            short_ms = self.wall_ms(run, reps=1, warmup=1)
            prof = self.profile_device(
                run, f"{backend} train step over 1 x {XL_TRAIN_PROFILE_SEQ}",
                short_ms, classes, warmup=False)
            del state
            torch.cuda.empty_cache()
            row = times[backend] = {
                "wall_ms": wall, "walls_ms": walls,
                "tokens_per_s": tokens * 1e3 / wall,
                "peak_gib": rep["steps"]["peak_gib"][backend],
                "short_wall_ms": short_ms, "busy": prof.get("busy_share"),
                "device_ms": prof.get("device_ms"),
                "classes": prof.get("classes"), "profile": prof}
            busy = ("not measured" if row["busy"] is None
                    else f"{row['busy']:.1%}")
            log(f"  {backend}: step {wall:.3f} ms (warm steps "
                f"{[round(w, 1) for w in walls[1:]]}, the first "
                f"{walls[0]:.1f}), {row['tokens_per_s']:.1f} tokens/s, peak "
                f"{row['peak_gib']:.2f} GiB; over 1 x {XL_TRAIN_PROFILE_SEQ}: "
                f"{short_ms:.3f} ms, busy {busy}")
        return self.rec_train_entries(groups, parts, label, rep)

    def rec_train_entries(self, groups, parts, label, rep):
        """Each distinct shape of a recorded forward and backward timed
        (``lm_train_shapes``), and the kernels line's entries: kernel 3
        forward (with the recomputes) and backward, each with the main
        path's launches ``parts``."""
        rows, per = self.lm_train_shapes(groups, label, 1)
        rep["shapes"] = rows
        entries = []
        for entry, p in per.items():
            name = entry.split(" ")[0]
            n = (parts[name]["forward"] + parts[name]["recompute"]
                 if "backward" not in entry else parts[name]["backward"])
            if not n:
                continue
            log(f"  {entry}: {p['ms']:.3f} ms over {n} launches, "
                f"{p['flops'] / p['ms'] / 1e9:.2f} TFLOP/s; bound "
                f"{p['bound_ms']:.3f} ms; library {p['library_ms']:.3f} ms; "
                f"plain {p['plain_ms']:.3f} ms")
            entries.append(self.kernel_entry(name, entry, n, p))
        return entries

    def jm_train(self, rep):
        """32c: one Jamba-1.5-Large Mamba mixer at full width, forward and
        backward over 1 x JM_SEQ (module docstring).  Returns the kernels
        line's entries."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import mamba

        cfg = get_config(JM_ARCH)
        m, d_in, dt_rank = mamba._cfg(cfg)
        label = f"{JM_NAME} trained"
        split = mixer_train_split(cfg, JM_SEQ)
        launches = {"matmul": {p: sum(v.values()) for p, v in split.items()},
                    "flash_attention": dict.fromkeys(split, 0)}
        simt = sum(v["simt"] for v in split.values())
        log(f"phase 32c: {JM_NAME} at full width (d_model {cfg.d_model}, "
            f"d_inner {d_in}, d_state {m.d_state}, dt_rank {dt_rank}, bf16): "
            f"mamba_block over 1 x {JM_SEQ} ({JM_SEQ // mamba.SCAN_CHUNK} "
            f"scan chunks, each checkpointed), its output's gradient taken "
            f"for x and every leaf; kernel-3 launches by part and variant "
            f"(mixer_train_split): {split}")
        g = torch.Generator(self.dev).manual_seed(SEED + 36)
        p = mamba.mamba_init(g, cfg, torch.bfloat16, self.dev)
        x = torch.randn((1, JM_SEQ, cfg.d_model), generator=g,
                        device=self.dev).to(torch.bfloat16)
        cot = torch.randn((1, JM_SEQ, cfg.d_model), generator=g,
                          device=self.dev).to(torch.bfloat16)
        names = ["x", *p]

        def run(backend="kernels"):
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            tx = x.detach().requires_grad_()
            y = mamba.mamba_block(leaves, tx, cfg, backend=backend)[0]
            return dict(zip(names, torch.autograd.grad(
                y, [tx, *leaves.values()], cot)))

        parts = {}

        def read():
            return {"matmul": self.counters["matmul"].launches,
                    "flash_attention": 0}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.reset_counts()
        t0 = time.perf_counter()
        with self.counting_parts(parts, read):
            got = run()
            torch.cuda.synchronize()
        main_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        total = sum(launches["matmul"].values())
        self.check_lm_launches(
            "forward and backward", {"conv2d": 0, "transposed_conv2d": 0,
                                     "matmul": total, "flash_attention": 0},
            "wgmma", simt=simt)
        log(f"  by part: {parts['matmul']}; peak {peak:.2f} GiB (bar "
            f"{JM_TRAIN_PEAK_GIB} GiB, weights included); {main_ms:.1f} ms "
            f"cold")
        if parts["matmul"] != launches["matmul"]:
            raise RuntimeError(f"32c launches by part {parts} != {launches}")
        if peak >= JM_TRAIN_PEAK_GIB:
            raise RuntimeError(f"32c peaks at {peak:.2f} GiB")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = run("torch")
        peak_t = torch.cuda.max_memory_allocated() / 2 ** 30
        rel = {k: ((got[k].float() - want[k].float()).norm()
                   / want[k].float().norm().clamp_min(1e-30)).item()
               for k in names}
        worst = max(rel, key=rel.get)
        log(f"  gradients, kernels vs torch, relative L2 (bar "
            f"{BF16_GRAD_RTOL:.0%}; a zeroed gradient reads 1.0): "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        rep["grads_rel_l2"] = rel
        rep["launches"] = {"by_part": parts, "worked_out": split}
        rep["peak_gib"] = {"kernels": peak, "torch": peak_t}
        if rel[worst] > BF16_GRAD_RTOL or not all(
                bool(torch.isfinite(t).all()) for t in got.values()):
            raise RuntimeError(f"32c: {worst} at {rel[worst]:.3e}")
        del got, want
        torch.cuda.empty_cache()
        def grads_only():
            run()

        groups, _ = self.lm_train_calls(cfg, p, None, launches, label, rep,
                                        phase="32c", micro=1, once=True,
                                        run=grads_only)
        times = rep["times"] = {}
        for backend in ("kernels", "torch"):
            wall = self.wall_ms(lambda b=backend: run(b), reps=1, warmup=1)
            prof = self.profile_device(lambda b=backend: run(b),
                                       f"{backend} mixer forward and "
                                       f"backward", wall, warmup=False)
            times[backend] = {"wall_ms": wall,
                              "peak_gib": rep["peak_gib"][backend],
                              "tokens_per_s": JM_SEQ * 1e3 / wall,
                              "busy": prof.get("busy_share"),
                              "device_ms": prof.get("device_ms"),
                              "profile": prof}
            busy = ("not measured" if prof.get("busy_share") is None
                    else f"{prof['busy_share']:.1%}")
            log(f"  {backend}: forward and backward {wall:.3f} ms "
                f"({JM_SEQ * 1e3 / wall:.1f} tokens/s), busy {busy}, peak "
                f"{rep['peak_gib'][backend]:.2f} GiB (its first run)")
        entries = self.rec_train_entries(groups, parts, label, rep)
        del p, x, cot
        return entries

    # ------------------------------------------------ phase 33: data axis
    def gate33(self, ok, what):
        """Fail phase 33 at a check that missed."""
        if not ok:
            raise RuntimeError(f"phase 33: {what}")

    def run_data_axis(self):
        """Phase 33: the data axis on 1, 4 and 2 ranks sharing the card
        (the module docstring), then the failover pool in this process
        and the kernels line's entries, on the plan table of
        :meth:`da_plan_table`."""
        log("phase 33: the data axis on N ranks sharing one card (gloo "
            "over CUDA tensors; spawned ranks, one thread each); phase 34's "
            "worlds run in the same spawn")
        rep = self.report["data_axis"] = {}
        den, gan = self.serving_params()
        with self.plan_table("phase33"):
            return self.da_ranks(den, gan, rep)

    def da_ranks(self, den, gan, rep):
        """Phase 33 on its plan table: the ranks' jobs, their gates, the
        failover pool and the kernels line's entries."""
        from repro_torch.data import SegDataPipeline
        from repro_torch.launch import data_axis
        from repro_torch.launch.mesh import launch

        rep["plan_table"] = self.da_plan_table(den, gan)
        model, _ = self.make_model()
        params = {n: p.detach().cpu().numpy()
                  for n, p in model.named_parameters()}
        del model
        batch = SegDataPipeline(DA_TRAIN_BATCH, hw=HW, classes=CLASSES,
                                seed=SEED).batch_at(0)
        server_kw = dict(DA_SERVE_KW, params={"unet_dec": den,
                                              "dcgan64": gan})
        requests = ([("unet_dec", s, SEED + 400 + i)
                     for i, s in enumerate(DA_SERVE_STEPS)]
                    + [("dcgan64", 1, SEED + 500 + i)
                       for i in range(DA_GAN_REQUESTS)])
        snap = os.path.join(ROOT, "chiprun_out", "data_axis_snapshot")
        shutil.rmtree(snap, ignore_errors=True)
        jobs = {}
        for n in DA_WORLDS:
            runs = ((("kernels", "dense"), ("torch", "dense")) if n == 1
                    else (("kernels", "dense"), ("kernels", "bf16"))
                    if n == 2 else (("kernels", "dense"),))
            serve = {"server_kw": server_kw, "requests": requests}
            if n == 4:
                serve["snapshot"] = (DA_SNAP_TICK, snap)
            jobs[n] = [("conv", {"cases": DA_CASES, "seed": SEED,
                                 "tensors": False}),
                       ("train", {"params": params, "batch": batch,
                                  "runs": runs,
                                  "virtual_shards": DA_SHARDS}),
                       ("serve", serve)]
        jobs[2].append(("serve", {"restore": snap}))
        # one spawn of 4 ranks: the 4-rank world, then the 1-rank world
        # on rank 0 beside the 2-rank world on ranks 2-3; then phase 34's
        # (data, model) worlds
        worlds = [(DA_RANKS[n], jobs[n]) for n in DA_WORLDS]
        ma_worlds, ma_setup = self.ma_worlds(den)
        ta_worlds, ta_dir = self.ta_worlds()
        t0 = time.perf_counter()
        spawned = launch(data_axis.run_worlds, 4, device=self.dev,
                         args=(worlds + ma_worlds + ta_worlds,), join=False)
        ma_ref = self.ma_references(ma_setup)
        try:
            ranks = spawned.result()
        finally:
            shutil.rmtree(ta_dir, ignore_errors=True)
        secs = time.perf_counter() - t0
        out = {n: [ranks[r][i] for r in DA_RANKS[n]]
               for i, n in enumerate(DA_WORLDS)}
        log(f"  4 ranks spawned once: {secs:.1f} s (spawn, library "
            f"load and every world's jobs); by rank, setup (from the "
            f"rank's first line: device, process group) and jobs: "
            + "; ".join(f"{s['init']:.1f} + {s['fn']:.1f}"
                        for s in spawned.seconds) + " s")
        rep["world_seconds"] = {"all": secs, "ranks": spawned.seconds}
        for n in DA_WORLDS:
            log(f"  {DA_LABEL[n]}: rank 0's jobs " + ", ".join(
                f"{k} {v:.1f}" for k, v in out[n][0]["seconds"].items())
                + " s")
        self.da_convs(out, rep)
        self.da_train(out, rep)
        self.da_serve(out, rep)
        self.da_failover(den, gan, rep)
        entries = self.da_entries(rep)
        entries += self.run_model_axis(ranks, len(worlds), spawned, ma_ref)
        return entries + self.run_train_axis(
            ranks, len(worlds) + len(ma_worlds))

    def da_plan_table(self, den, gan):
        """Phase 33's plan table, written to the table directory in force,
        and its gates.  A launch plan can change a row's bits; a rank's
        share of a batch is another shape, which a table may give another
        plan; so a share's launches take the whole batch's plan
        (``autotune.whole_batch_plans``).  Each kernel launch geometry of
        33a's unsharded forwards (batch 5) and of a drain of both lanes at
        33c's batch (``den``, ``gan`` their trees) runs at every plan its
        kernel builds (``autotune.candidates``), on the whole batch and on
        its first and last rows alone: the rows' bits must not depend on
        the batch.  The table then gives the whole batch its default plan
        and each share of 2 and 4 ranks a plan whose bits differ from it,
        where the kernel builds one: only the pin keeps the ranks' bits
        the unsharded call's."""
        torch = self.torch
        from repro_torch.core.decompose import conv2d

        at = self.at
        calls = []
        with torch.no_grad(), self.recording(calls):
            for i, (label, xs, ws, kw) in enumerate(DA_CASES):
                rng = np.random.default_rng(SEED + i)
                x, w = (torch.from_numpy(rng.standard_normal(
                    sh, dtype=np.float32)).to(self.dev) for sh in (xs, ws))
                conv2d(x, w, **kw)
            srv = self.sg.GenServer(**DA_SERVE_KW, device=self.dev,
                                    params={"unet_dec": den,
                                            "dcgan64": gan})
            for i in range(DA_SERVE_KW["batch"]):
                srv.submit("unet_dec", steps=1, seed=SEED + 800 + i)
                srv.submit("dcgan64", steps=1, seed=SEED + 900 + i)
            srv.run()
        seen = {}
        for name, args in calls:
            seen.setdefault(self.geometry(name, args), (name, args))
        launch = {"conv2d": self.kconv.conv2d_cuda,
                  "transposed_conv2d": self.ktr.tconv_cuda}
        runs, moving, wholes, shares, pins = 0, 0, {}, {}, []
        for geo, (name, args) in seen.items():
            x, w = args[0], args[1]
            kind = "dense" if name == "conv2d" else "tconv"
            n = x.shape[0]

            def rows(sl, a=args):
                eps = tuple(e[sl] if e.dim() == 4 else e for e in a[-1])
                return (a[0][sl], *a[1:-1], eps)

            def run(sl, plan, name=name, rows=rows):
                # the copy width follows the address, as launch_plan's
                a = rows(sl)
                vec = self.kconv.copy_vec(a[0].shape[-1], a[0].dtype,
                                          a[0].data_ptr())
                return launch[name](*a, plan=plan._replace(vec=vec))

            def key(m, name=name, args=args):
                shape = (m, *args[0].shape[1:])
                if name == "conv2d":
                    return at.make_key("dense", shape, tuple(args[1].shape),
                                       stride=args[2], dtype=args[0].dtype,
                                       padding=args[3], epilogue=args[4])
                return at.make_key("tconv", shape, tuple(args[1].shape),
                                   stride=args[2], dtype=args[0].dtype,
                                   padding=args[3],
                                   output_padding=args[4] - args[3],
                                   epilogue=args[5])

            default = at.default_plan(kind, tuple(x.shape), tuple(w.shape),
                                      stride=args[2], dtype=x.dtype)
            want = run(slice(None), default)
            other = None
            for plan in at.candidates(kind, tuple(x.shape), tuple(w.shape),
                                      dtype=x.dtype):
                whole = run(slice(None), plan)
                for sl in (slice(0, 1), slice(n - 1, n)):
                    runs += 1
                    self.gate33(torch.equal(run(sl, plan), whole[sl]),
                                f"{geo}: plan {plan} gives rows {sl} other "
                                f"bits alone than in the whole batch")
                if other is None and not torch.equal(whole, want):
                    other = plan
            moving += other is not None
            moves = other is not None
            if other is None:
                other = next((c for c in at.candidates(
                    kind, tuple(x.shape), tuple(w.shape), dtype=x.dtype)
                    if c[1:] != default[1:]), default)
            wholes[key(n)] = default
            for ranks in (2, 4):
                share = -(-n // ranks)
                shares.setdefault(key(share), other)
                pins.append((name, args, rows, share, moves))
        entries = {**shares, **wholes}      # a whole batch's key wins
        for k, plan in entries.items():
            at._persist(k, plan, self.dev)
        at.clear_memory_cache()
        for name, args, rows, share, moves in pins:
            # rows(slice(0, share)) is a share's launch of the same geometry
            a = rows(slice(0, share))
            whole = self.plan_of(name, args)
            own = self.plan_of(name, a)
            with at.whole_batch_plans(share, args[0].shape[0]):
                pinned = self.plan_of(name, a)
            self.gate33(pinned == whole and (own != whole or not moves),
                        f"{self.geometry(name, a)}: a share's plan {own}, "
                        f"{pinned} under the pin; the whole batch's {whole}")
        log(f"  {len(seen)} launch geometries (33a's forwards, the "
            f"denoiser's and DCGAN-64's ticks at batch "
            f"{DA_SERVE_KW['batch']}), each at every plan its kernel "
            f"builds: {runs} runs of one row alone, each bitwise its rows "
            f"in the whole batch; {moving} geometries have a plan that "
            f"gives other bits than the default; the ranks run on a table "
            f"giving each whole batch its default plan and each share of 2 "
            f"and 4 ranks such a plan ({len(entries)} entries): only the "
            f"pin (the whole batch's plan for a share) holds their bits")
        return {"geometries": len(seen), "runs": runs,
                "bit_moving_geometries": moving, "entries": len(entries)}

    def da_convs(self, out, rep):
        """33a's gates: bitwise forwards, gradient bars, launches."""
        log("phase 33a: shard_conv2d at ENet-512's layer shapes, batch 5")
        first = out[1][0]["conv"]
        rows = {}
        for label, xs, ws, kw in DA_CASES:
            kind = ("transposed_conv2d" if kw.get("transposed")
                    else "conv2d")
            worst = {"dx": 0.0, "dw": 0.0}
            for n in DA_WORLDS:
                # rank 0 holds the comparisons with the unsharded call; the
                # other ranks' digests carry them
                lead = out[n][0]["conv"][label]
                self.gate33(lead["equal"], f"{label}: {n} ranks: forward "
                            f"!= the unsharded call")
                for g in ("dx", "dw"):
                    rel = lead[f"{g}_err"] / max(1.0, lead[f"{g}_scale"])
                    worst[g] = max(worst[g], rel)
                    self.gate33(rel <= DA_GRAD_TOL, f"{label}: {n} ranks: "
                                f"{g} at {rel:.3e} x max(1, max|ref|)")
                for r, res in enumerate(out[n]):
                    got = res["conv"][label]
                    self.gate33(got["digest"] == first[label]["digest"],
                                f"{label}: {n} ranks, rank {r}: forward "
                                f"bits differ from 1 rank's")
                    self.gate33(got["grad_digests"] == lead["grad_digests"],
                                f"{label}: {n} ranks, rank {r}: gradients "
                                f"differ from rank 0's")
                    want = {"conv2d": 0, "transposed_conv2d": 0, kind: 1}
                    self.gate33(got["launches"] == want,
                                f"{label}: {n} ranks, rank {r}: launches "
                                f"{got['launches']} != {want}")
            rows[label] = worst
            log(f"  {label}: forward bitwise on every rank of worlds "
                f"{DA_WORLDS} and the unsharded call; dx {worst['dx']:.2e}, "
                f"dw {worst['dw']:.2e} x max(1, max|ref|) (bar "
                f"{DA_GRAD_TOL}); {kind} launched on every rank")
        rep["convs"] = rows
        rep["launches_1_rank"] = {
            k: sum(out[1][0]["conv"][label]["launches"][k]
                   for label, *_ in DA_CASES)
            for k in ("conv2d", "transposed_conv2d")}

    def da_train(self, out, rep):
        """33b's gates: the dense step bitwise across worlds and ranks,
        bf16 within its bar, kernels vs torch at phase 8's bars."""
        torch = self.torch
        log(f"phase 33b: ENet-512 sharded train step, batch "
            f"{DA_TRAIN_BATCH} in {DA_SHARDS} virtual shards, "
            f"{len(out[1][0]['train'][('kernels', 'dense')]['ms'])} steps")
        one = out[1][0]["train"][("kernels", "dense")]

        def flat(state):
            f = {f"params.{k}": v for k, v in state.params.items()}
            f.update({f"mu.{k}": v for k, v in state.opt.mu.items()})
            f.update({f"nu.{k}": v for k, v in state.opt.nu.items()})
            f.update(step=state.opt.step, scale=state.scale.scale,
                     good=state.scale.good_steps)
            return f

        want = flat(one["state"])
        per_step = {}
        for n in DA_WORLDS:
            for r, res in enumerate(out[n]):
                got = res["train"][("kernels", "dense")]
                for i, (m1, m) in enumerate(zip(one["metrics"],
                                                got["metrics"])):
                    self.gate33(torch.equal(m["losses"], m1["losses"]),
                                f"{n} ranks, rank {r}: step {i} losses")
                    self.gate33(m["skipped"].item() == 0.0,
                                f"{n} ranks: step {i} skipped")
                f = flat(got["state"])
                bad = [k for k, v in want.items()
                       if not torch.equal(f[k], v)]
                self.gate33(not bad, f"{n} ranks, rank {r}: {len(bad)} "
                            f"state tensors differ (e.g. {bad[:3]})")
                local = DA_SHARDS // n
                steps = LAUNCHES_PER_STEP
                want_l = {k: local * (steps["forward"][k]
                                      + steps["backward"][k])
                          for k in ("conv2d", "transposed_conv2d")}
                self.gate33(got["launches"] == want_l,
                            f"{n} ranks, rank {r}: a step's launches "
                            f"{got['launches']} != {want_l}")
            ms = [statistics.median(res["train"][("kernels",
                                                  "dense")]["ms"][1:])
                  for res in out[n]]
            per_step[n] = {"ms": ms,
                           "launches": out[n][0]["train"][
                               ("kernels", "dense")]["launches"]}
            log(f"  {DA_LABEL[n]}: dense steps bitwise the "
                f"1-rank run on every rank (params, AdamW state, losses); "
                f"{DA_SHARDS // n} chunk(s) a rank, launches a rank a step "
                f"{per_step[n]['launches']}; warm step "
                + ", ".join(f"{v:.1f}" for v in ms) + " ms by rank")
        losses = [m["loss"].item() for m in one["metrics"]]
        wire = out[2][0]["train"][("kernels", "bf16")]
        bf16 = [m["loss"].item() for m in wire["metrics"]]
        gap = max(abs(a - b) / max(1.0, abs(a))
                  for a, b in zip(losses, bf16))
        # step 0 starts both runs from one state: only the wire differs
        gn = one["metrics"][0]["grad_norm"].item()
        gn_gap = abs(wire["metrics"][0]["grad_norm"].item() - gn) / gn
        moved = [k for k, v in flat(wire["state"]).items()
                 if k.startswith("params.") and not torch.equal(v, want[k])]
        log(f"  bf16 transport (2 ranks): losses {bf16} against dense "
            f"{losses}: {gap:.2e} (bar {DA_BF16_TOL}); step 0's grad norm "
            f"{gn_gap:.2e} from dense (bar (0, {DA_BF16_GRAD_NORM}]); "
            f"{len(moved)} of {len(one['state'].params)} parameters differ "
            f"from the dense run's after {len(bf16)} steps")
        self.gate33(gap <= DA_BF16_TOL, f"bf16 transport at {gap:.3e}")
        self.gate33(0.0 < gn_gap <= DA_BF16_GRAD_NORM and moved,
                    f"bf16 transport: step 0's grad norm {gn_gap:.3e} from "
                    f"dense, {len(moved)} parameters moved")
        tm = out[1][0]["train"][("torch", "dense")]["metrics"]
        for i, (m, t) in enumerate(zip(one["metrics"], tm)):
            dl = abs(m["loss"].item() - t["loss"].item()) / t["loss"].item()
            dg = (abs(m["grad_norm"].item() - t["grad_norm"].item())
                  / t["grad_norm"].item())
            log(f"  step {i}: kernels vs torch backend (1 rank): loss "
                f"{dl:.2e} (bar {TRAIN_LOSS_RTOL}), grad norm {dg:.2e} "
                f"(bar 1e-3)")
            self.gate33(dl <= TRAIN_LOSS_RTOL and dg <= 1e-3,
                        f"step {i}: kernels vs torch {dl:.3e} {dg:.3e}")
        rep["train"] = {"losses": losses, "bf16_losses": bf16,
                        "bf16_gap": gap, "bf16_grad_norm_gap": gn_gap,
                        "bf16_params_moved": len(moved),
                        "per_world": per_step}

    def da_serve(self, out, rep):
        """33c's gates: every world's drain and the restored drain bitwise
        the 1-rank drain."""
        log("phase 33c: GenServer(mesh=), denoiser and DCGAN-64 lanes at "
            f"batch {DA_SERVE_KW['batch']}")
        want = out[1][0]["serve"]["images"]
        walls = {}
        for n in DA_WORLDS:
            keys = ["serve"] + (["serve#3"] if n == 2 else [])
            for r, res in enumerate(out[n]):
                for key in keys:
                    got = res[key]["images"]
                    self.gate33(sorted(got) == sorted(want),
                                f"{n} ranks {key}: requests {sorted(got)}")
                    bad = [rid for rid in want
                           if not np.array_equal(got[rid], want[rid])]
                    self.gate33(not bad, f"{n} ranks, rank {r}, {key}: "
                                f"images {bad} differ from 1 rank's")
            walls[n] = [res["serve"]["wall_s"] for res in out[n]]
            log(f"  {DA_LABEL[n]}: {len(want)} images "
                f"bitwise the 1-rank drain on every rank; drain "
                + ", ".join(f"{w:.2f}" for w in walls[n]) + " s by rank"
                + ("; the snapshot taken at 4 ranks, tick "
                   f"{DA_SNAP_TICK}, restored here finishes bitwise"
                   if n == 2 else ""))
        rep["serve"] = {"wall_s": walls, "images": len(want)}

    def da_failover(self, den, gan, rep):
        """33d: three in-process hosts on the card, one killed."""
        from repro_torch.launch.failover import FailoverPool

        log(f"phase 33d: FailoverPool, {DA_HOSTS} hosts, host {DA_VICTIM} "
            f"killed")
        kw = dict(DA_SERVE_KW, params={"unet_dec": den, "dcgan64": gan},
                  device=self.dev)
        mix = [("unet_dec", s, SEED + 600 + i)
               for i, s in enumerate(DA_SERVE_STEPS)] + [
            ("dcgan64", 1, SEED + 700)]
        ref = self.sg.GenServer(**kw)
        rids = [ref.submit(wl, steps=s, seed=seed) for wl, s, seed in mix]
        want = ref.run()
        hb = os.path.join(ROOT, "chiprun_out", "data_axis_heartbeats")
        shutil.rmtree(hb, ignore_errors=True)
        pool = FailoverPool(hb, hosts=DA_HOSTS, timeout_s=DA_HB_TIMEOUT,
                            server_kw=kw)
        toks = [pool.submit(wl, steps=s, seed=seed) for wl, s, seed in mix]
        owned = {t for t, (h, _) in pool._where.items() if h == DA_VICTIM}
        pool.kill_host(DA_VICTIM)
        time.sleep(DA_HB_TIMEOUT * 1.05)
        t0 = time.perf_counter()
        got = pool.drain()
        secs = time.perf_counter() - t0
        st = pool.stats()
        moved = {t for t, _, _ in pool.failovers}
        self.gate33(st["dead_hosts"] == 1 and moved == owned and owned,
                    f"failover moved {sorted(moved)}, owned "
                    f"{sorted(owned)}, stats {st}")
        bad = [i for i, t in enumerate(toks)
               if not np.array_equal(got[t], want[rids[i]])]
        self.gate33(not bad, f"failover drain: requests {bad} differ")
        log(f"  {len(owned)} request(s) of the dead host reassigned; "
            f"{len(toks)} images bitwise the no-fault drain; drain "
            f"{secs:.2f} s")
        rep["failover"] = {"stats": st, "drain_s": secs}

    def da_entries(self, rep):
        """The kernels line's entries of phase 33: 33a's forwards as the
        1-rank world launches them (the unsharded calls), each against its
        plain version, timed beside its bound and library call."""
        torch = self.torch
        from repro_torch.core.decompose import conv2d

        calls = []
        for i, (label, xs, ws, kw) in enumerate(DA_CASES):
            rng = np.random.default_rng(SEED + i)
            x = torch.from_numpy(rng.standard_normal(
                xs, dtype=np.float32)).to(self.dev)
            w = torch.from_numpy(rng.standard_normal(
                ws, dtype=np.float32)).to(self.dev)
            with torch.no_grad(), self.recording(calls):
                conv2d(x, w, **kw)
        for i, (name, args) in enumerate(calls):
            kern, plain, _ = self.kernels[name]
            self.compare(f"phase 33 call {i}", f"{name} (phase 33)",
                         kern(*args), plain(*args), quiet=True)
        rows, per = self.time_calls(calls, reps=MODEL_REPS)
        rep["geometries"] = self.geometry_table(rows, "33a's forwards")
        entries = []
        for name, p in per.items():
            n = rep["launches_1_rank"][name]
            full = f"{name} (phase 33)"
            log(f"  {full}: {p['ms']:.3f} ms over {n} launches; bound "
                f"{p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f} ms; "
                f"library {p['library_ms']:.3f} ms")
            entries.append(self.kernel_entry(name, full, n, p))
        return entries

    # ------------------------------------------------ phase 34: model axis
    def gate34(self, ok, what):
        """Fail phase 34 at a check that missed."""
        if not ok:
            raise RuntimeError(f"phase 34: {what}")

    def ma_worlds(self, den):
        """Phase 34's worlds for phase 33's spawn: ``[(ranks, jobs, mesh
        shape)]`` in :data:`MA_MESHES` order."""
        snap = os.path.join(ROOT, "chiprun_out", "model_axis_snapshot")
        shutil.rmtree(snap, ignore_errors=True)
        from repro_torch import configs

        vocab = (configs.get_reduced if MA_LM_REDUCED
                 else configs.get_config)(MA_LM_ARCH).vocab
        rng = np.random.default_rng(SEED + 34)
        prompts = rng.integers(0, vocab, (MA_LM_BATCH, MA_LM_PROMPT),
                               dtype=np.int32)
        forced = rng.integers(0, vocab, (MA_LM_DECODE, MA_LM_BATCH, 1),
                              dtype=np.int32)
        lm = {"arch": MA_LM_ARCH, "reduced": MA_LM_REDUCED,
              "dtype": "bfloat16",
              "layers": MA_LM_LAYERS, "seed": SEED + 34, "prompts": prompts,
              "decode": MA_LM_DECODE, "gen": MA_LM_DECODE,
              "full_logits": False, "forced": forced}
        serve_kw = dict(MA_SERVE_KW, params={"unet_dec": den})
        requests = ([("unet_dec", s, SEED + 340 + i)
                     for i, s in enumerate(MA_SERVE_STEPS)]
                    + [("dcgan64", 1, SEED + 349)])
        worlds = []
        for mesh, ranks in MA_MESHES.items():
            serve = {"server_kw": serve_kw, "requests": requests}
            jobs = []
            if mesh in MA_CONV_MESHES:
                jobs.append(("conv", {"cases": MA_CASES, "seed": SEED,
                                      "tensors": False}))
            if mesh == (2, 2):
                serve["snapshot"] = (MA_SNAP_TICK, snap)
            jobs.append(("serve", serve))
            if mesh == (1, 2):
                jobs.append(("serve", {"restore": snap}))
            jobs.append(("lm", lm))
            worlds.append((ranks, jobs, mesh))
        return worlds, {"lm": lm, "serve_kw": serve_kw,
                        "requests": requests}

    def ma_references(self, setup):
        """While the ranks run: the unmeshed drain of 34b and the 1-rank
        server of 34c (this process, on the same plan table)."""
        from repro_torch.launch import data_axis

        t0 = time.perf_counter()
        kw = {k: v for k, v in setup["serve_kw"].items() if k != "spatial"}
        srv = self.sg.GenServer(device=self.dev, **kw)
        for wl, steps, seed in setup["requests"]:
            srv.submit(wl, steps=steps, seed=seed)
        drain = srv.run()
        del srv
        lm = data_axis.lm_job(None, device=self.dev, **setup["lm"])
        self.torch.cuda.empty_cache()
        return {"drain": drain, "lm": lm,
                "seconds": time.perf_counter() - t0}

    def run_model_axis(self, ranks, first, spawned, ref):
        """Phase 34's gates and the kernels line's entries, from the ranks'
        results of the worlds from index ``first`` on."""
        t0 = time.perf_counter()
        rep = self.report["model_axis"] = {}
        out = {m: [ranks[r][first + i] for r in MA_MESHES[m]]
               for i, m in enumerate(MA_MESHES)}
        jobs = [sum(v for w, res in r.items()
                    if first <= w < first + len(MA_MESHES)
                    for k, v in res["seconds"].items()) for r in ranks]
        rep["rank_job_seconds"] = jobs
        log(f"phase 34: the model axis on N ranks sharing one card, in "
            f"phase 33's spawn: its jobs took {max(jobs):.1f} s on the "
            f"busiest rank (by rank " + ", ".join(f"{j:.1f}" for j in jobs)
            + f" s); the unmeshed and 1-rank references "
            f"{ref['seconds']:.1f} s in this process beside them")
        for m in MA_MESHES:
            log(f"  {m} (data, model), {len(MA_MESHES[m])} ranks sharing "
                f"one card: rank 0's jobs " + ", ".join(
                    f"{k} {v:.1f}" for k, v in out[m][0]["seconds"].items())
                + " s")
        launches = {"conv2d": 0, "transposed_conv2d": 0}
        self.ma_convs(out, rep, launches)
        self.ma_serve(out, ref, rep, launches)
        lm_launches = self.ma_lm(out, ref, rep)
        entries = self.ma_conv_entries(launches)
        entries += self.ma_lm_entries(out[(1, 4)][0]["lm"]["calls"],
                                      lm_launches)
        secs = max(jobs) + time.perf_counter() - t0
        self.report["phase_seconds"]["34 (in 33's spawn)"] = secs
        log(f"phase 34: {secs:.1f} s (its jobs on the busiest rank, then "
            f"its gates and entries here)")
        return entries

    def ma_convs(self, out, rep, launches):
        """34a's gates: bitwise forwards, gradient bars, band launches."""
        log("phase 34a: shard_conv2d(spatial=True) at ENet-512's layer "
            "shapes, batch 2: rows in bands over the model axis")
        rows = {}
        for label, xs, ws, kw in MA_CASES:
            kind = ("transposed_conv2d" if kw.get("transposed")
                    else "conv2d")
            for mesh in MA_CONV_MESHES:
                lead = out[mesh][0]["conv"][label]
                self.gate34(lead["equal"], f"{label} on {mesh}: forward != "
                            f"the unsharded call")
                errs = {}
                for g in ("dx", "dw"):
                    errs[g] = lead[f"{g}_err"] / max(1.0, lead[f"{g}_scale"])
                    self.gate34(errs[g] <= DA_GRAD_TOL, f"{label} on {mesh}: "
                                f"{g} at {errs[g]:.3e} x max(1, max|ref|)")
                halos = []
                for r, res in enumerate(out[mesh]):
                    got = res["conv"][label]
                    self.gate34(got["digest"] == lead["digest"]
                                and got["grad_digests"] == lead[
                                    "grad_digests"],
                                f"{label} on {mesh}, rank {r}: bits differ "
                                f"from rank 0's")
                    want = {"conv2d": 0, "transposed_conv2d": 0, kind: 1}
                    self.gate34(got["launches"] == want,
                                f"{label} on {mesh}, rank {r}: launches "
                                f"{got['launches']} != {want}")
                    heights = [shp[1] for _, shp in got["launch_rows"]]
                    whole = xs[1] // kw.get("dilation", 1)
                    self.gate34(heights and max(heights) < whole,
                                f"{label} on {mesh}, rank {r}: launch rows "
                                f"{heights} are not a band of {whole}")
                    self.gate34(got["halos"]["exchanges"] == 1,
                                f"{label} on {mesh}, rank {r}: "
                                f"{got['halos']['exchanges']} exchanges")
                    launches[kind] += got["launches"][kind]
                    halos.append(got["halos"])
                rows[f"{label} {mesh}"] = {"dx": errs["dx"],
                                           "dw": errs["dw"], "halos": halos}
                log(f"  {label} on {mesh}: bitwise on every rank; dx "
                    f"{errs['dx']:.2e}, dw {errs['dw']:.2e} x max(1, "
                    f"max|ref|); launch rows by rank "
                    + ", ".join(str(sorted({shp[1] for _, shp in res["conv"][
                        label]["launch_rows"]})) for res in out[mesh])
                    + "; halo rows / bytes received by rank "
                    + ", ".join(f"{h['rows']} / {h['bytes']}" for h in halos))
        rep["convs"] = rows

    def ma_serve(self, out, ref, rep, launches):
        """34b's gates: each drain and the restored one bitwise the
        unmeshed drain."""
        log("phase 34b: GenServer(spatial=True), the denoiser lane at full "
            f"widths (64x64), batch {MA_SERVE_KW['batch']}, "
            f"{MA_SERVE_KW['scan_steps']} DDIM steps a tick")
        want = ref["drain"]
        walls = {}
        for mesh in MA_MESHES:
            keys = ["serve"] + (["serve#1"] if mesh == (1, 2) else [])
            for r, res in enumerate(out[mesh]):
                for key in keys:
                    got = res[key]
                    bad = [rid for rid in want if rid not in got["images"]
                           or not np.array_equal(got["images"][rid],
                                                 want[rid])]
                    self.gate34(not bad, f"{mesh}, rank {r}, {key}: images "
                                f"{bad} differ from the unmeshed drain")
                    self.gate34(got["halos"]["exchanges"] > 0,
                                f"{mesh}, rank {r}: no halo exchanged")
                for k in launches:
                    launches[k] += res["serve"]["launches"][k]
                # the denoiser's convs (DCGAN's lane launches kernel 2 only)
                shapes = [shp for kind, shp in res["serve"]["launch_rows"]
                          if kind == "conv2d"]
                size = max(shp[2] for shp in shapes)
                bands = {shp[1] for shp in shapes if shp[2] == size}
                self.gate34(bands and max(bands) < size,
                            f"{mesh}, rank {r}: the {size}-wide convs ran "
                            f"on rows {sorted(bands)}")
            walls[str(mesh)] = [res["serve"]["wall_s"] for res in out[mesh]]
            log(f"  {mesh}, {len(MA_MESHES[mesh])} ranks sharing one card: "
                f"{len(want)} images bitwise the unmeshed drain on every "
                f"rank; drain " + ", ".join(f"{w:.2f}"
                                            for w in walls[str(mesh)])
                + " s by rank"
                + (f"; the (2, 2) snapshot of tick {MA_SNAP_TICK} restored "
                   f"here finishes bitwise" if mesh == (1, 2) else ""))
        rep["serve"] = {"wall_s": walls, "images": len(want)}

    def ma_lm(self, out, ref, rep):
        """34c's gates: logits and layers within the bf16 bar of the 1-rank
        server, greedy tokens, parameter blocks, launches."""
        torch = self.torch
        log(f"phase 34c: {MA_LM_ARCH} at full width, bf16, "
            f"{MA_LM_LAYERS} of 24 layers, tensor parallel over model and "
            f"FSDP over data: a {MA_LM_BATCH} x {MA_LM_PROMPT} prefill and "
            f"{MA_LM_DECODE} decode steps")
        one = ref["lm"]
        rows = {}
        launches = {"matmul": 0, "flash_attention": 0}

        def rel(got, want):
            return ((got.float() - want.float()).abs().max().item()
                    / max(want.float().abs().max().item(), 1e-30))

        for mesh in MA_MESHES:
            dp, m = mesh
            lead = out[mesh][0]["lm"]
            errs = {"prefill": rel(lead["prefill"], one["prefill"])}
            for i, (got, want) in enumerate(zip(lead["layers"],
                                                one["layers"])):
                errs[f"layer {i}"] = rel(got, want)
            errs["decode"] = max(rel(g, w) for g, w in zip(lead["decode"],
                                                           one["decode"]))
            for what, e in errs.items():
                self.gate34(e <= MA_LM_BAR, f"{mesh}: {what} at {e:.3e} x "
                            f"max|ref| of the 1-rank server")
            agree = float(np.mean(lead["tokens"] == one["tokens"]))
            for r, res in enumerate(out[mesh]):
                got = res["lm"]
                for k in launches:
                    self.gate34(got["launches"][k] > 0,
                                f"{mesh}, rank {r}: {k} never launched")
                    launches[k] += got["launches"][k]
                self.gate34(np.array_equal(got["tokens"], lead["tokens"]),
                            f"{mesh}, rank {r}: tokens differ from rank 0's")
                for name, (held, whole, spec) in got["leaves"].items():
                    axes = {a for e in spec if e for a in
                            (e if isinstance(e, tuple) else (e,))}
                    if {"data", "model"} <= axes and dp > 1:
                        self.gate34(held * dp * m == whole,
                                    f"{mesh}, rank {r}: {name} holds "
                                    f"{held} of {whole}")
            held, whole = lead["param_bytes"]
            self.gate34(held < whole, f"{mesh}: rank 0 holds {held} of "
                        f"{whole} bytes")
            ms = [res["lm"]["prefill_ms"] for res in out[mesh]]
            dec = [statistics.median(res["lm"]["decode_ms"])
                   for res in out[mesh]]
            rows[str(mesh)] = {**errs, "token_agreement": agree,
                               "param_bytes": [held, whole],
                               "prefill_ms": ms, "decode_ms_median": dec}
            log(f"  {mesh} (data, model), {len(MA_MESHES[mesh])} ranks "
                f"sharing one card: last logits {errs['prefill']:.2e}, "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()
                            if k.startswith("layer"))
                + f", decode logits (worst of {MA_LM_DECODE}) "
                f"{errs['decode']:.2e} x max|ref| (bar {MA_LM_BAR}); greedy "
                f"tokens agree with the 1-rank server's at {agree:.3f}; "
                f"rank 0 holds {held / 2 ** 20:.1f} of {whole / 2 ** 20:.1f}"
                f" MiB of parameters; prefill " + ", ".join(
                    f"{t:.1f}" for t in ms) + " ms, decode step (median) "
                + ", ".join(f"{t:.1f}" for t in dec) + " ms by rank")
        rep["lm"] = rows
        rep["lm_1_rank"] = {"prefill_ms": one["prefill_ms"],
                            "decode_ms_median": statistics.median(
                                one["decode_ms"])}
        log(f"  1-rank server (this process): prefill "
            f"{one['prefill_ms']:.1f} ms, decode step (median) "
            f"{statistics.median(one['decode_ms']):.1f} ms")
        del torch
        return launches

    # ------------------------------------------------------------- phase 35
    def gate35(self, ok, what):
        """Fail phase 35 at a check that missed."""
        if not ok:
            raise RuntimeError(f"phase 35: {what}")

    def ta_config(self, **kw):
        from repro_torch import configs

        return (configs.get_reduced if TA_REDUCED else configs.get_config)(
            TA_ARCH).replace(**kw)

    def ta_worlds(self):
        """Phase 35's worlds for phase 33's spawn: the 1-rank reference,
        unmeshed, on each of the 4 ranks (each keeps its first step's
        gradients, so a mesh's rank holds its own blocks to them with no
        gather; rank 0 runs every step), then each of :data:`TA_MESHES`;
        returns ``(worlds, checkpoint dir)``."""
        import tempfile

        ckpt = tempfile.mkdtemp(prefix="phase35_ckpt_")
        vocab = self.ta_config().vocab

        def batches(seq, n, seed):
            rng = np.random.default_rng(seed)
            out = []
            for _ in range(n):
                toks = rng.integers(0, vocab, (TA_BATCH, seq + 1),
                                    dtype=np.int32)
                mask = np.ones((TA_BATCH, seq), np.float32)
                # the microbatches' normalisers differ
                mask[0, :seq // 8] = 0.0
                mask[TA_BATCH - 1, seq // 2:] = 0.0
                out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                            "mask": mask})
            return out

        run = {"arch": TA_ARCH, "reduced": TA_REDUCED, "seed": SEED + 35,
               "microbatches": TA_MICRO, "warmup": 2, "total_steps": 100,
               "overrides": {"num_layers": TA_LAYERS},
               "batches": batches(TA_SEQ, TA_STEPS, SEED + 351)}
        witness = dict(run, overrides={"num_layers": TA_WITNESS_LAYERS,
                                       "dtype": "float32"},
                       batches=batches(TA_WITNESS_SEQ, 1, SEED + 352))
        # rank 0 runs the whole reference (its metrics of every step);
        # ranks 1-3 at the same time its first loss and gradients alone
        # (no AdamW state: four whole states would not fit the card)
        refs = [("train_lm", dict(run, unmeshed=True, keep="ta_ref")),
                ("train_lm", dict(witness, unmeshed=True,
                                  keep="ta_witness"))]
        worlds = [((0,), refs, (1, 1)),
                  ((1, 2, 3), [(n, dict(kw, grads_only=True))
                               for n, kw in refs], (1, 3))]
        for mesh, ranks in TA_MESHES.items():
            jobs = [("train_lm", dict(
                run, hold="ta_ref",
                **({"save": ckpt, "expect": [TA_CKPT[1]]}
                   if mesh == TA_CKPT[0] else {})))]
            if mesh == TA_WITNESS_MESH:
                jobs.append(("train_lm", dict(witness, hold="ta_witness")))
            if mesh == TA_CKPT[1]:
                jobs.append(("train_lm", dict(run, batches=(),
                                              restore=ckpt)))
            worlds.append((ranks, jobs, mesh))
        return worlds, ckpt

    def train_axis_alone(self) -> int:
        """Phase 35 alone (``--phase35``): its worlds in one spawn of 4
        ranks sharing the card, then its gates and kernels-line entries,
        printed as one JSON line; phases 1-34 do not run."""
        from repro_torch.launch import data_axis
        from repro_torch.launch.mesh import launch

        log(card_line())
        self.report["phase_seconds"] = {}
        worlds, ckpt = self.ta_worlds()
        t0 = time.perf_counter()
        try:
            ranks = launch(data_axis.run_worlds, 4, device=self.dev,
                           args=(worlds,))
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        log(f"phase 35 alone: the spawn and its worlds "
            f"{time.perf_counter() - t0:.1f} s")
        print(json.dumps({"kernels": self.run_train_axis(ranks, 0)}))
        return 0

    def run_train_axis(self, ranks, first):
        """Phase 35's gates and the kernels line's entries, from the ranks'
        results of the worlds from index ``first`` on."""
        t0 = time.perf_counter()
        rep = self.report["train_axis"] = {}
        ref = [ranks[0][first]] + [r[first + 1] for r in ranks[1:]]
        for r in ref[1:]:
            self.gate35(r["train_lm"]["metrics"][0]["loss"] == ref[0][
                "train_lm"]["metrics"][0]["loss"],
                "the 1-rank runs of the ranks differ")
        out = {m: [ranks[r][first + 2 + i] for r in TA_MESHES[m]]
               for i, m in enumerate(TA_MESHES)}
        jobs = [sum(v for w, res in r.items() if w >= first
                    for v in res["seconds"].values()) for r in ranks]
        rep["rank_job_seconds"] = jobs
        cfg = self.ta_config(num_layers=TA_LAYERS)
        log(f"phase 35: {TA_ARCH} at full width, bf16 with fp32 AdamW, "
            f"{TA_LAYERS} of 24 layers, trained over (data, model) meshes "
            f"of ranks sharing one card (FSDP over data, heads, FFN and "
            f"vocab over model), in phase 33's spawn: {TA_STEPS} steps of a "
            f"{TA_BATCH} x {TA_SEQ} batch in {TA_MICRO} microbatches a "
            f"mesh; its jobs took {max(jobs):.1f} s on the busiest rank "
            f"(by rank " + ", ".join(f"{j:.1f}" for j in jobs) + " s)")
        one = ref[0]["train_lm"]
        log(f"  1 rank (rank 0, unmeshed): losses " + ", ".join(
            f"{m['loss']:.4f}" for m in one["metrics"]) + ", step ms "
            + ", ".join(f"{t:.0f}" for t in one["ms"]))
        rep["1_rank"] = {"metrics": one["metrics"], "ms": one["ms"]}
        want = lm_train_launches(cfg, TA_SEQ, TA_MICRO)
        launches = {"matmul": 0, "flash_attention": 0}
        calls = []
        for mesh, res in out.items():
            launches, calls = self.ta_mesh(mesh, res, one, want, launches,
                                           calls, rep)
        self.ta_witness([r["train_lm#1"] for r in out[TA_WITNESS_MESH]],
                        ref, rep)
        key = "train_lm#1" if TA_CKPT[1] != TA_WITNESS_MESH else "train_lm#2"
        restored = [r[key] for r in out[TA_CKPT[1]]]
        expected = restored[0].get("expected") or []
        self.gate35(len(expected) == len(restored),
                    f"no digests of {TA_CKPT[1]}'s blocks from the writer")
        for r, (got, want) in enumerate(zip(restored, expected)):
            self.gate35(got["restored_step"] == TA_STEPS,
                        f"restored step {got['restored_step']}")
            self.gate35(got["digests"] == want, f"{TA_CKPT[1]}, rank {r}: "
                        f"restored blocks not the saved state's, bit for "
                        f"bit")
        rep["checkpoint"] = {"from": str(TA_CKPT[0]), "to": str(TA_CKPT[1]),
                             "leaves": len(expected[0]), "bitwise": True}
        log(f"  the {TA_CKPT[0]} state after {TA_STEPS} steps, gathered "
            f"whole onto rank 0 and written; restored into {TA_CKPT[1]}'s "
            f"blocks: every rank's {len(expected[0])} leaves bitwise the "
            f"writer's cut of them (sha256)")
        entries = self.rank_lm_entries(
            calls, launches,
            {"matmul": "matmul (phase 35, every rank's blocks)",
             "flash_attention": "flash_attention (phase 35, every rank's "
                                "heads)"},
            "the first step of rank 0 of each mesh", SEED + 353)
        secs = max(jobs) + time.perf_counter() - t0
        self.report["phase_seconds"]["35 (in 33's spawn)"] = secs
        log(f"phase 35: {secs:.1f} s (its jobs on the busiest rank, then "
            f"its gates and entries here)")
        return entries

    def ta_mesh(self, mesh, res, one, want, launches, calls, rep):
        """One mesh's gates: the metrics of every step against the 1-rank
        run's, the gathered first-step gradients, the launches by part on
        every rank, the blocks each rank holds."""
        dp, m = mesh
        lead = res[0]["train_lm"]
        for i, (got, ref) in enumerate(zip(lead["metrics"], one["metrics"])):
            rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
            self.gate35(rel <= TA_LOSS_RTOL, f"{mesh}: step {i} loss "
                        f"{got['loss']} vs {ref['loss']} on one rank")
        gn = (abs(lead["metrics"][0]["grad_norm"]
                  - one["metrics"][0]["grad_norm"])
              / one["metrics"][0]["grad_norm"])
        self.gate35(gn <= TA_GNORM_RTOL, f"{mesh}: step-0 grad norm {gn:.3e}"
                    f" off the 1-rank run's")
        from repro_torch.launch.data_axis import held

        worst = max(held([r["train_lm"]["held"] for r in res]).items(),
                    key=lambda kv: kv[1][0])
        self.gate35(worst[1][0] <= TA_GRAD_RL2, f"{mesh}: gradient of "
                    f"{worst[0]} at relative L2 {worst[1][0]:.3e}")
        for r, rank in enumerate(res):
            got = rank["train_lm"]
            self.gate35(got["metrics"] == lead["metrics"],
                        f"{mesh}, rank {r}: metrics differ from rank 0's")
            self.gate35(got["parts"] == want, f"{mesh}, rank {r}: launches "
                        f"by part {got['parts']} != {want}")
            for k in launches:
                n = sum(want[k].values())
                self.gate35(got["launches"][k] == n, f"{mesh}, rank {r}: "
                            f"{got['launches'][k]} {k} launches, not {n}")
                launches[k] += got["launches"][k]
            for name, (held, whole, spec) in got["leaves"].items():
                axes = {a for e in spec if e for a in
                        (e if isinstance(e, tuple) else (e,))}
                if {"data", "model"} <= axes:
                    self.gate35(held * dp * m == whole, f"{mesh}, rank "
                                f"{r}: {name} holds {held} of {whole}")
            held, whole = got["state_bytes"]
            self.gate35(held * dp * m <= 1.01 * whole, f"{mesh}, rank {r}: "
                        f"{held} of {whole} bytes of parameters and AdamW "
                        f"state")
        calls = calls + lead["calls"]
        ms = [statistics.median(rank["train_lm"]["ms"][1:] or
                                rank["train_lm"]["ms"]) for rank in res]
        coll = [sum(c["seconds"] for c in rank["train_lm"]["collectives"][1:])
                for rank in res]
        wait = [sum(c["wait_seconds"]
                    for c in rank["train_lm"]["collectives"][1:])
                for rank in res]
        wall = [sum(rank["train_lm"]["ms"][1:]) / 1e3 for rank in res]
        moved = lead["collectives"][-1]
        share = [c / w if w else 0.0 for c, w in zip(coll, wall)]
        held, whole = lead["state_bytes"]
        rep[str(mesh)] = {
            "metrics": lead["metrics"], "step_ms": [r["train_lm"]["ms"]
                                                    for r in res],
            "grad_rel_l2_worst": worst, "grad_norm_rel": gn,
            "state_bytes": [held, whole], "collective_seconds": coll,
            "collective_wait_seconds": wait, "collective_share": share,
            "collective_calls": moved["calls"],
            "collective_bytes": moved["bytes"], "parts": want}
        log(f"  {mesh} (data, model), {len(res)} ranks sharing one card: "
            f"losses " + ", ".join(f"{x['loss']:.4f}" for x in
                                   lead["metrics"])
            + f" (bar {TA_LOSS_RTOL:.0%} of one rank's); step-0 grad norm "
            f"{gn:.2e} off; worst gradient {worst[0]} at relative L2 "
            f"{worst[1][0]:.2e} (bar {TA_GRAD_RL2}); rank 0 holds "
            f"{held / 2 ** 30:.2f} of {whole / 2 ** 30:.2f} GiB of parameters"
            f" and AdamW state; step (median of the warm steps) " + ", ".join(
                f"{t:.0f}" for t in ms) + " ms by rank; all_gather calls "
            + ", ".join(f"{c:.2f}" for c in coll) + " s of the warm steps' "
            + ", ".join(f"{w:.2f}" for w in wall) + " s by rank (share "
            + ", ".join(f"{x:.2f}" for x in share) + "; device waits "
            "before them " + ", ".join(f"{x:.2f}" for x in wait) + " s); "
            f"a step's {moved['calls']} gathers brought rank 0 "
            f"{moved['bytes'] / 2 ** 20:.0f} MiB")
        return launches, calls

    def ta_witness(self, res, ref, rep):
        """The fp32 witness on :data:`TA_WITNESS_MESH` against the 1-rank
        run: loss at 1e-5 relative, every gradient at 1e-4 x max(1,
        max|ref|)."""
        want = ref[0]["train_lm#1"]["metrics"][0]
        loss = res[0]["metrics"][0]["loss"]
        rel = abs(loss - want["loss"]) / abs(want["loss"])
        self.gate35(rel <= TA_FP32_LOSS, f"fp32 witness loss {loss} vs "
                    f"{want['loss']} ({rel:.2e})")
        from repro_torch.launch.data_axis import held

        worst = max(held([r["held"] for r in res]).items(),
                    key=lambda kv: kv[1][1])
        self.gate35(worst[1][1] <= TA_FP32_GRAD, f"fp32 witness: gradient "
                    f"of {worst[0]} at {worst[1][1]:.2e} x max(1, max|ref|)")
        rep["fp32_witness"] = {"loss_rel": rel, "worst_grad": worst}
        log(f"  fp32 witness on {TA_WITNESS_MESH}, {TA_WITNESS_LAYERS} layer"
            f" at {TA_BATCH} x {TA_WITNESS_SEQ}: loss {rel:.2e} relative "
            f"(bar {TA_FP32_LOSS}); worst gradient {worst[0]} at "
            f"{worst[1][1]:.2e} x max(1, max|ref|) (bar {TA_FP32_GRAD})")

    def ma_conv_entries(self, launches):
        """The band launches of 34a's cases for the middle band 1 of 4,
        recorded here (``decompose._band_form`` at that band's rows),
        against their plain versions and timed beside bound and library
        call."""
        torch = self.torch
        from repro_torch.core import decompose

        calls, pairs = [], []
        for i, (label, xs, ws, kw) in enumerate(MA_CASES):
            rng = np.random.default_rng(SEED + i)
            x, w = (torch.from_numpy(rng.standard_normal(
                sh, dtype=np.float32)).to(self.dev) for sh in (xs, ws))
            kw = {k: v for k, v in kw.items() if k != "spatial"}
            full = {**dict(stride=1, dilation=1, transposed=False,
                           padding=None, output_padding=0, decomposed=True,
                           strategy="batched", backend="kernels"), **kw}
            bands = decompose.band_split(xs, ws, 4, **full)
            i0, i1 = bands.in_rows[1]
            ep = dict(epilogue=None, scale=None, shift=None, alpha=None,
                      residual=None)
            whole = []
            with torch.no_grad(), self.recording(whole):
                decompose.conv2d(x, w, **kw)
            with torch.no_grad(), self.recording(calls):
                decompose._band_form(x[:, i0:i1], w, bands, 1, None, full,
                                     ep)
            pairs.append((label, whole[0], calls[-1], bands, i0,
                          kw.get("dilation", 1)))
        self.ma_band_rows(pairs)
        entries = []
        for i, (name, args) in enumerate(calls):
            kern, plain, _ = self.kernels[name]
            self.compare(f"phase 34 band call {i}",
                         f"{name} (phase 34, every rank's row band)",
                         kern(*args), plain(*args), quiet=True)
        rows, per = self.time_calls(calls, reps=MODEL_REPS)
        self.report["model_axis"]["geometries"] = self.geometry_table(
            rows, "34a's middle bands")
        for name, p in per.items():
            full = f"{name} (phase 34, every rank's row band)"
            n = sum(1 for c in calls if c[0] == name)
            log(f"  {full}: {p['ms']:.3f} ms over the {n} "
                f"band launches of one rank; bound {p['bound_ms']:.3f} ms; "
                f"plain {p['plain_ms']:.3f} ms; library "
                f"{p['library_ms']:.3f} ms; {launches[name]} launches on "
                f"the ranks (34a's forwards and 34b's drains)")
            entries.append(self.kernel_entry(name, full, launches[name], p))
        return entries

    def ma_band_rows(self, pairs):
        """Whether kernels 1 and 2 compute an image row the same in a band
        as in the whole image at one plan: each 34a case's whole launch and
        its middle band's launch at every plan the kernel builds, the
        band's output rows bitwise the whole output's."""
        at = self.at
        launch = {"conv2d": self.kconv.conv2d_cuda,
                  "transposed_conv2d": self.ktr.tconv_cuda}
        runs = 0
        for label, (name, whole), (_, band), bands, i0, d in pairs:
            kind = "dense" if name == "conv2d" else "tconv"
            o0, o1 = bands.out_rows[1]
            if bands.form == "tconv":
                s = whole[2]
                pick = slice(o0 - s * i0, o1 - s * i0)
            else:
                pick = slice(None)
            rows = slice(o0 // d, o1 // d)
            for plan in at.candidates(kind, tuple(whole[0].shape),
                                      tuple(whole[1].shape),
                                      dtype=whole[0].dtype):
                out = []
                for args in (whole, band):
                    vec = self.kconv.copy_vec(args[0].shape[-1],
                                              args[0].dtype,
                                              args[0].data_ptr())
                    out.append(launch[name](*args,
                                            plan=plan._replace(vec=vec)))
                runs += 1
                self.gate34(self.torch.equal(out[1][:, pick],
                                             out[0][:, rows]),
                            f"{label}: plan {plan} gives the middle band's "
                            f"rows other bits than the whole image's")
        self.report["model_axis"]["band_rows_runs"] = runs
        log(f"  {len(pairs)} band geometries of 34a (the middle band 1 of "
            f"4) at every plan their kernel builds: {runs} runs, each "
            f"band's rows bitwise the whole image's rows at the same plan")

    def ma_lm_entries(self, calls, launches):
        """A ``(1, 4)`` rank's prefill and first decode step of 34c, each
        distinct launch replayed here on seeded operands against its plain
        version and timed; the sums per kernel are its entries."""
        return self.rank_lm_entries(
            [c for step in calls for c in step], launches,
            {"matmul": "matmul (phase 34c, every rank's heads)",
             "flash_attention": "flash_attention (phase 34c, every rank's "
                                "heads)"},
            "a (1, 4) rank's prefill and first decode step", SEED + 341)

    def rank_lm_entries(self, calls, launches, labels, what, seed):
        """Kernels 3 and 4's launches ``calls`` (``(name, shapes, dtype,
        causal, window)``, repeated as launched) replayed here once per
        distinct launch on seeded operands, each held against its plain
        version and timed (x its count); the sums per kernel are its
        entries, named by ``labels``."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        seen = {}
        for name, shapes, dtype, causal, window, *part in calls:
            key = (name, tuple(map(tuple, shapes)), dtype, causal, window,
                   part[0] if part else "forward")
            seen[key] = seen.get(key, 0) + 1
        groups, by_part = {}, {}
        for (name, shapes, dtype, causal, window, part), n in seen.items():
            dt = getattr(torch, dtype.removeprefix("torch."))
            ops = [torch.randn(sh, generator=g, device=self.dev).to(dt)
                   for sh in shapes]
            if name == "matmul":
                args = tuple(ops)
            else:
                q, k = ops
                args = (q, k, torch.randn(k.shape, generator=g,
                                          device=self.dev).to(dt),
                        causal, window)
            kern, plain, lib, flops, nbytes, geo, variant = self.lm_call(
                name, args)
            label = labels[name]
            self.compare(f"{label}: {geo}", label, kern(), plain(),
                         quiet=True)
            peak = (PEAK_FP32_FLOPS if dt == torch.float32
                    else PEAK_BF16_FLOPS)
            ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES_S
            row = {"ms": self.device_ms(kern) * n,
                   "plain_ms": self.device_ms(plain, reps=3) * n,
                   "library_ms": self.device_ms(lib) * n,
                   "ops_ms": ops_ms * n, "bytes_ms": bytes_ms * n}
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            log(f"  {name} [{variant}] x{n} {geo}, {part}: "
                f"{row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms, plain "
                f"{row['plain_ms']:.3f} ms, library "
                f"{row['library_ms']:.3f} ms")
            for sums in (groups.setdefault(name, dict.fromkeys(row, 0.0)),
                         by_part.setdefault(f"{name} {part}", dict.fromkeys(
                             list(row) + ["launches", "flops"], 0.0))):
                for k, v in row.items():
                    sums[k] += v
            by_part[f"{name} {part}"]["launches"] += n
            by_part[f"{name} {part}"]["flops"] += flops * n
        for key, p in by_part.items():
            log(f"  {key}: {p['launches']:.0f} launches, {p['ms']:.3f} ms "
                f"({p['flops'] / max(p['ms'], 1e-9) / 1e9:.1f} TFLOP/s), "
                f"bound {p['bound_ms']:.3f} ms, plain {p['plain_ms']:.3f} "
                f"ms, library {p['library_ms']:.3f} ms")
        self.report.setdefault("rank_parts", {})[what] = by_part
        entries = []
        for name, p in groups.items():
            full = labels[name]
            log(f"  {full}: {p['ms']:.3f} ms over {what}; bound "
                f"{p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f} ms; "
                f"library {p['library_ms']:.3f} ms; {launches[name]} "
                f"launches on the ranks")
            entries.append(self.kernel_entry(name, full, launches[name], p))
        return entries

    def geometry(self, name, args):
        x, w = args[0], args[1]
        spec = args[-2]
        if name == "conv2d":
            return (f"x{tuple(x.shape)} w{tuple(w.shape)} s{args[2]} "
                    f"pads{args[3]} ep({int(spec.bn)}{int(spec.prelu)}"
                    f"{spec.residual})")
        return (f"x{tuple(x.shape)} w{tuple(w.shape)} s{args[2]} "
                f"p({args[3]},{args[4]}) ep({int(spec.bn)}{int(spec.prelu)}"
                f"{spec.residual})")

    def plan_of(self, name, args):
        """The launch plan of a recorded call, as the wrappers decide it
        (``launch_plan``: a narrower copy for an input that is not aligned
        to the plan's)."""
        x, w, spec = args[0], args[1], args[-2]
        if name == "conv2d":
            return self.kconv.launch_plan(x, w, args[2], args[3], spec)
        return self.ktr.launch_plan(x, w, args[2], args[3], args[4], spec)

    def variant(self, name, args):
        """A recorded call's launch variant and tile width."""
        plan = self.plan_of(name, args)
        return f"{plan.variant}/n{plan.bn}"

    def work(self, name, args):
        """(flops of the nonzero MACs, bytes each operand moves once: x, w,
        the output and a residual at their element size, the fp32 channel
        operands at 4 bytes)."""
        x, w, spec, eps = args[0], args[1], args[-2], args[-1]
        n, h, w_in, cin = x.shape
        cout = w.shape[-1]
        if name == "conv2d":
            s, ((pt, pb), (pl, pr)) = args[2], args[3]

            def live(size, k, lo, hi):
                out = (size + lo + hi - k) // s + 1
                return sum(1 for o in range(out) for t in range(k)
                           if 0 <= o * s - lo + t < size), out

            ly, oh = live(h, w.shape[0], pt, pb)
            lx, ow = live(w_in, w.shape[1], pl, pr)
        else:
            s, p_lo, p_hi = args[2], args[3], args[4]
            k = w.shape[0]
            sched = self.ktr.parity_schedule(k, s, p_lo)

            def live(size):
                out = (size - 1) * s + p_lo + p_hi - k + 2
                return sum(1 for o in range(out) for _, off in sched[o % s]
                           if 0 <= o // s + off < size), out

            ly, oh = live(h)
            lx, ow = live(w_in)
        macs = n * ly * lx * cin * cout
        out_numel = n * oh * ow * cout
        res_numel = out_numel if "residual" in spec.slots else 0
        chan_numel = cout * sum(s_ != "residual" for s_ in spec.slots)
        nbytes = (x.element_size() * (x.numel() + w.numel() + out_numel
                                      + res_numel) + 4 * chan_numel)
        return 2 * macs, nbytes

    def library_call(self, name, args):
        """One PyTorch call computing the same conv (without the fused
        epilogue): ``F.conv2d`` / ``F.conv_transpose2d`` on channels-last
        tensors, TF32 off.  Timed here only; the port never calls it."""
        torch = self.torch
        F = torch.nn.functional
        x, w = args[0], args[1]
        xc = x.permute(0, 3, 1, 2)                       # channels-last view
        if name == "conv2d":
            s, ((pt, pb), (pl, pr)) = args[2], args[3]
            if (pt, pl) != (pb, pr):
                xc = F.pad(xc, (pl, pr, pt, pb)).contiguous(
                    memory_format=torch.channels_last)
                pt = pl = 0
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            return lambda: F.conv2d(xc, wc, stride=s, padding=(pt, pl))
        s, p_lo, p_hi = args[2], args[3], args[4]
        k = w.shape[0]
        wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv_transpose2d(xc, wt, stride=s,
                                          padding=k - 1 - p_lo,
                                          output_padding=p_hi - p_lo)


if __name__ == "__main__":
    sys.exit(main())
